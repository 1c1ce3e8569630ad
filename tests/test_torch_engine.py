"""The port end to end: doomtpu_torch DoomEngine.render and
render_walls on the paint path (`use_pallas_paint=True`) against the JAX
DoomEngine on the CPU (the JAX engine's XLA path there: wall_scan +
resolve + the deferred pass + shade; below row 255 the two pipelines
draw the same frames, tests/test_torch_faults.py).

- demo: B=16 spread poses, so the camera sort (B > 8) runs on both
  sides; the port's new_game state is moved across to a JAX GameState
  (tests/test_torch_camera.py holds the two new_games equal), and the
  JAX engine's four jitted renders are compiled together, once;
- e1m1-scale and doom1-asset-scale: B=4 at 160x96, pools deep enough
  that neither side drops a record;
- the golden frames (tests/golden/frames.npz, demo and e1m1_scale): the
  port's render_frame on the paint path at the pinned poses (padded to a
  batch of 4 with copies of the last) equals the committed idx and its
  rgb the committed hash.

Tolerance: exact equality of idx and rgb, and every capacity counter
equal on both sides (0 here).
"""

import dataclasses
import hashlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from doomtpu.config import RenderConfig  # noqa: E402
from doomtpu.engine import DoomEngine as JaxEngine  # noqa: E402
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu.wad import synth  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.render.device import DeviceLevel  # noqa: E402
from doomtpu_torch.ops import items as ti  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.render.frame import render_frame  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 16


def _spread_poses(t, n, seed=0):
    rng = np.random.default_rng(seed)
    poses = []
    left, right, top, bottom = [float(v) for v in t.bbox]
    while len(poses) < n:
        x, y = rng.uniform(left, right), rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            poses.append((x, y, rng.uniform(0, 2 * math.pi)))
    return (np.asarray([p[:2] for p in poses], np.float32),
            np.asarray([p[2] for p in poses], np.float32))


@pytest.fixture(scope="module")
def engines():
    wad = synth.demo_wad()
    return (JaxEngine.from_wad_bytes(wad, "e1m1"),
            DoomEngine.from_wad_bytes(
                wad, "e1m1", config=RenderConfig(use_pallas_paint=True),
                device="cpu"))


def _states(te, n, seed=0):
    """(JAX, port) GameStates of the same n spread poses."""
    pos, ang = _spread_poses(te.tables, n, seed)
    ts = te.new_game(n, pos=pos, angle=ang,
                     generator=torch.Generator().manual_seed(0))
    return JaxState(**{f.name: jnp.asarray(getattr(ts, f.name).numpy())
                       for f in dataclasses.fields(JaxState)}), ts


@pytest.fixture(scope="module")
def states(engines):
    return _states(engines[1], B)


@pytest.fixture(scope="module")
def jax_out(engines, states):
    """The JAX engine's render_walls, render_walls_counters, render and
    render_counters of the demo states: the engine's own jitted
    functions (camera sort included), traced and compiled as one."""
    from doomtpu.engine import (
        _render_counters_jit, _render_jit, _render_walls_counters_jit,
        _render_walls_jit,
    )

    je, _ = engines
    js, _ = states
    cfg = je.config
    fns = {"render_walls": _render_walls_jit,
           "render_walls_counters": _render_walls_counters_jit,
           "render": _render_jit, "render_counters": _render_counters_jit}
    out = jax.jit(lambda level, st: {k: f(level, st, cfg, 1)
                                     for k, f in fns.items()})(je.level, js)
    for k in ("render_walls_counters", "render_counters"):
        out[k] = {c: int(v) for c, v in out[k].items()}
    return out


def test_render_walls_equals_jax(engines, states, jax_out):
    _, te = engines
    _, ts = states
    assert te.config.camera_sort and ts.batch > 8
    jidx, jrgb = jax_out["render_walls"]
    before = tp.paint.launches
    idx, rgb = te.render_walls(ts)
    assert tp.paint.launches == before          # CPU: the plain version
    assert idx.dtype == torch.int32 and rgb.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    # some spread poses fall in the void outside the demo rooms and see
    # nothing, on both sides; most cameras still fill their whole frame
    full = (idx >= 0).float().mean(dim=(1, 2)) > 0.99
    assert int(full.sum()) >= B // 2


def test_render_walls_counters_are_zero(engines, states, jax_out):
    _, te = engines
    _, ts = states
    assert te.render_walls_counters(ts) == {"overflow": 0, "live_dropped": 0}
    assert jax_out["render_walls_counters"] == {"overflow": 0,
                                                "live_dropped": 0}


def test_render_equals_jax(engines, states, jax_out):
    _, te = engines
    _, ts = states
    jidx, jrgb = jax_out["render"]
    before = (tp.paint.launches, ti.composite_items.launches)
    idx, rgb = te.render(ts)
    # CPU: the plain versions
    assert (tp.paint.launches, ti.composite_items.launches) == before
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    # the items drew over the walls and planes
    walls_idx, _ = te.render_walls(ts)
    assert int((walls_idx != idx).sum()) > 1000
    counters = te.render_counters(ts)
    assert counters == jax_out["render_counters"]
    assert set(counters.values()) == {0}


# pools above the fixtures' uncapped peaks at these poses (span 42,
# mid 7, clip 36, item 9 on doom1-asset-scale), no deeper: the JAX
# side's compile time grows with span_capacity
MAP_CFG = RenderConfig(width=160, height=96, span_capacity=48,
                       mid_capacity=40, clip_capacity=96, item_capacity=24,
                       use_pallas_paint=True)


COUNTERS = ("overflow", "live_dropped", "items_dropped", "item_overflow",
            "item_block_dropped", "live_stale")


@pytest.mark.parametrize("wad_fn", ["e1m1_scale_wad", "doom1_scale_wad"])
def test_render_equals_jax_on_maps(wad_fn):
    """B=4 needs no camera sort, so one jitted JAX render_frame gives
    the frame and its counters."""
    from doomtpu.render.frame import render_frame as jax_render_frame

    wad = getattr(synth, wad_fn)()
    je = JaxEngine.from_wad_bytes(wad, "e1m1", config=MAP_CFG)
    te = DoomEngine.from_wad_bytes(wad, "e1m1", config=MAP_CFG, device="cpu")
    js, ts = _states(te, 4, seed=2)

    def one(level, st):
        idx, rgb, aux = jax_render_frame(
            level, MAP_CFG, st.pos[:, 0], st.pos[:, 1], st.angle,
            st.floor_height, st.sector_light, st.mobj_state, st.timestamp)
        zero = jax.numpy.zeros((), jax.numpy.int32)
        return idx, rgb, {k: aux.get(k, zero).sum() for k in COUNTERS}

    jidx, jrgb, jcount = jax.jit(one)(je.level, js)
    idx, rgb = te.render(ts)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    walls_idx, _ = te.render_walls(ts)
    assert int((walls_idx != idx).sum()) > 1000
    counters = te.render_counters(ts)
    assert counters == {k: int(v) for k, v in jcount.items()}
    assert set(counters.values()) == {0}


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "frames.npz")


@pytest.mark.parametrize("name", ["demo", "e1m1_scale"])
def test_render_equals_golden(name, info):
    """The poses, timestamps and spawn states of tests/test_golden.py,
    through the port's render_frame (pools deep enough to drop
    nothing)."""
    from scripts.gen_golden import build_fixture, spawn_mobjs

    golden = np.load(GOLDEN)
    mt, assets = build_fixture(name, info)
    _, _, ms = spawn_mobjs(mt, info)
    level = DeviceLevel.build(mt, assets, info, "cpu")
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=96, item_capacity=24,
                       use_pallas_paint=True)
    n = int(golden[f"{name}_n_views"])
    views = np.stack([golden[f"{name}_{vi}_view"]
                      for vi in list(range(n)) + [n - 1] * (-n % 4)])
    n_b = len(views)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    fh = [float(mt.sector_floor_h[mt.sector_at(v[0], v[1])]) for v in views]
    idx, rgb, aux = render_frame(
        level, cfg, f(views[:, 0]), f(views[:, 1]), f(views[:, 2]), f(fh),
        torch.as_tensor(np.repeat(np.asarray(mt.sector_light, np.int32)[None],
                                  n_b, 0)),
        torch.as_tensor(np.repeat(np.asarray(ms, np.int32)[None], n_b, 0)),
        f(views[:, 3]),
    )
    assert "midpool" in aux                         # the paint path ran
    for k in ("overflow", "items_dropped", "item_overflow"):
        assert int(aux[k].sum()) == 0, k
    for vi in range(n):
        np.testing.assert_array_equal(idx[vi].numpy().astype(np.int16),
                                      golden[f"{name}_{vi}_idx"])
        r = rgb[vi].numpy().astype(np.int64)
        rgb8 = np.stack([(r >> s) & 0xFF for s in (16, 8, 0)], -1).astype(
            np.uint8)
        assert hashlib.sha256(rgb8.tobytes()).digest() == bytes(
            golden[f"{name}_{vi}_rgb_sha256"])


def test_unported_entry_points_raise(engines, states):
    """No entry point raises any more: calibrate, the last one ported,
    returns a new engine whose config differs from the old one only in
    the capacities it measures (tests/test_torch_calibrate.py holds their
    values to JAX's)."""
    from doomtpu_torch.calibrate import _OUT_FIELDS

    _, te = engines
    _, ts = states
    cal = te.calibrate([ts])
    assert cal is not te and cal.level is te.level
    old, new = dataclasses.asdict(te.config), dataclasses.asdict(cal.config)
    changed = {k for k in old if old[k] != new[k]}
    assert changed and changed <= set(_OUT_FIELDS), changed
