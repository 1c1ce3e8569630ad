"""render_walls of the port against the JAX package on the synthetic maps
that take the paint path's other branches:

- deep: a BSP deeper than 31 levels (the two-word traversal rank);
- doom1_scale: doom1 asset scale (958 segs, 48 flats with animated
  cycles, TEXTURE2), wall textures wider than 128 (the 256-texel column
  clamp) and sky-hack segs (no drawn ceiling).

At 160x96 with pools deep enough that neither side drops a record (the
config asks for the paint path, which the port takes; the JAX side on
the CPU runs its XLA span-pool scan, whose default capacity overflows on
both maps).  Tolerance: exact equality of idx and rgb, and
every capacity counter 0 on both sides.
"""

from dataclasses import fields

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from doomtpu.config import RenderConfig  # noqa: E402
from doomtpu.engine import DoomEngine as JaxEngine  # noqa: E402
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu.wad import synth  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.render import frame as tframe  # noqa: E402
from doomtpu_torch.sim.state import state_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# pools above both maps' uncapped peaks at these poses (span 65, mid 11,
# clip 57 on the deep map), no deeper: the JAX side's compile time grows
# with span_capacity
CFG = RenderConfig(width=160, height=96, span_capacity=72,
                   mid_capacity=32, clip_capacity=96, use_pallas_paint=True)


def _poses(t, n, seed):
    rng = np.random.default_rng(seed)
    poses = []
    left, right, top, bottom = [float(v) for v in t.bbox]
    while len(poses) < n:
        x, y = rng.uniform(left, right), rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            poses.append((x, y, rng.uniform(0, 2 * np.pi)))
    return (np.asarray([p[:2] for p in poses], np.float32),
            np.asarray([p[2] for p in poses], np.float32))


@pytest.mark.parametrize("wad_fn", ["deep_wad", "doom1_scale_wad"])
def test_render_walls_equals_jax(wad_fn):
    wad = getattr(synth, wad_fn)()
    je = JaxEngine.from_wad_bytes(wad, "e1m1", config=CFG)
    te = DoomEngine.from_wad_bytes(wad, "e1m1", config=CFG, device="cpu")
    lv = te.level
    assert tframe.paint_available(lv, CFG, 4)
    if wad_fn == "deep_wad":
        assert lv.sub_path_nodes.shape[1] > 31
    else:
        assert lv.texq_wide and bool(lv.seg_sky_hack.any())
        assert int((lv.flat_anim_len > 1).sum()) > 8
    pos, ang = _poses(te.tables, 4, seed=1)
    # the port's new_game (tests/test_torch_camera.py holds it equal to
    # the JAX one), moved to both sides
    st = te.new_game(4, pos=pos, angle=ang,
                     generator=torch.Generator().manual_seed(0))
    arrays = {f.name: getattr(st, f.name).numpy() for f in fields(JaxState)}
    # later ticks, so the animated flats step through their cycles
    arrays["tick"] = np.asarray([0, 37, 70, 141], np.int32)
    js = JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ts = state_from_numpy(arrays, "cpu")
    jidx, jrgb = je.render_walls(js)
    idx, rgb = te.render_walls(ts)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    assert (idx >= 0).any()
    zero = {"overflow": 0, "live_dropped": 0}
    assert je.render_walls_counters(js) == zero
    assert te.render_walls_counters(ts) == zero
