"""The scan + resolve pipeline end to end: the port's DoomEngine.render,
render_walls and both counter dicts on levels and screens the paint
kernel does not take, against the JAX package on the CPU, and the same
pipeline forced on a paint-eligible level against the paint path and
the golden frames.

- single room with GRATE (transparent texels) on its solid walls, B=8;
- e1m1-scale-masked (e1m1-scale with GRATE among its one-sided wall
  textures), B=4 at 160x96;
- the demo at 1152x64, B=2: not a multiple of 4.

Their configs ask for the paint path (`use_pallas_paint`), so what keeps
each off it is the level or the batch.

B <= 8 runs no camera sort, so one jitted JAX render_frame and
render_walls_planes (the JAX engine's path on the CPU) give the frames
and counters.  Tolerance: exact equality of idx and rgb and of every
counter (0 here).
"""

import dataclasses
import hashlib
import math
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from doomtpu.config import RenderConfig  # noqa: E402
from doomtpu.engine import DoomEngine as JaxEngine  # noqa: E402
from doomtpu.render.frame import render_frame as jax_render_frame  # noqa: E402
from doomtpu.render.frame import (  # noqa: E402
    render_walls_planes as jax_render_walls,
)
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.render import frame as tframe  # noqa: E402
from doomtpu_torch.render.device import DeviceLevel  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COUNTERS = ("overflow", "live_dropped", "items_dropped", "item_overflow",
            "item_block_dropped", "live_stale")
WALL_COUNTERS = ("overflow", "live_dropped")


def grate_room_wad() -> bytes:
    rooms, things = synth.single_room_level()
    for r in rooms:
        r.wall_tex = "GRATE"
    return synth.build_wad(rooms, things)


def _spread_poses(t, n, seed):
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


# span pools above each case's uncapped peak (6, 30, 3), no deeper: the
# JAX side's compile time grows with span_capacity
CASES = {
    # name: (wad, config, batch)
    "grate-room": (grate_room_wad, RenderConfig(
        width=160, height=100, span_capacity=8, item_capacity=16,
        use_pallas_paint=True), 8),
    "e1m1-scale-masked": (synth.e1m1_scale_masked_wad, RenderConfig(
        width=160, height=96, span_capacity=40, mid_capacity=40,
        clip_capacity=64, item_capacity=16, use_pallas_paint=True), 4),
    "demo-1152": (synth.demo_wad, RenderConfig(
        width=1152, height=64, span_capacity=8, item_capacity=16,
        use_pallas_paint=True), 2),
}


def _engines(wad, cfg):
    with warnings.catch_warnings():
        # GRATE on solid walls warns at build (tests/test_torch_scan.py
        # holds the port's warning to the JAX one)
        warnings.simplefilter("ignore", UserWarning)
        return (JaxEngine.from_wad_bytes(wad, "e1m1", config=cfg),
                DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg,
                                          device="cpu"))


@pytest.mark.parametrize("case", list(CASES))
def test_render_equals_jax_where_paint_is_unavailable(case):
    wad_fn, cfg, B = CASES[case]
    je, te = _engines(wad_fn(), cfg)
    assert not tframe.paint_available(te.level, cfg, B)
    pos, ang = _spread_poses(te.tables, B, seed=2)
    # the port's new_game, moved to JAX (tests/test_torch_camera.py holds
    # the two new_games equal)
    ts = te.new_game(B, pos=pos, angle=ang,
                     generator=torch.Generator().manual_seed(0))
    js = JaxState(**{f.name: jax.numpy.asarray(getattr(ts, f.name).numpy())
                     for f in dataclasses.fields(JaxState)})

    def both(level, st):
        args = (st.pos[:, 0], st.pos[:, 1], st.angle, st.floor_height,
                st.sector_light)
        zero = jax.numpy.zeros((), jax.numpy.int32)
        idx, rgb, aux = jax_render_frame(level, cfg, *args, st.mobj_state,
                                         st.timestamp)
        widx, wrgb, waux = jax_render_walls(level, cfg, *args, st.timestamp)
        count = lambda a, keys: {k: a.get(k, zero).sum() for k in keys}
        return (idx, rgb, count(aux, COUNTERS),
                widx, wrgb, count(waux, WALL_COUNTERS))

    jidx, jrgb, jcount, jwidx, jwrgb, jwcount = jax.jit(both)(je.level, js)
    before = tp.paint.launches
    idx, rgb = te.render(ts)
    widx, wrgb = te.render_walls(ts)
    assert tp.paint.launches == before
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    np.testing.assert_array_equal(widx.numpy(), np.asarray(jwidx))
    np.testing.assert_array_equal(wrgb.numpy(), np.asarray(jwrgb))
    counters = te.render_counters(ts)
    assert counters == {k: int(v) for k, v in jcount.items()}
    assert set(counters.values()) == {0}
    wcounters = te.render_walls_counters(ts)
    assert wcounters == {k: int(v) for k, v in jwcount.items()}
    assert set(wcounters.values()) == {0}
    assert float((widx >= 0).float().mean()) > 0.5
    if case != "grate-room":                     # the room has no sprite
        assert int((widx != idx).sum()) > 50     # in view of every pose


@pytest.fixture
def forced_scan(monkeypatch):
    """The scan + resolve pipeline on every level."""
    monkeypatch.setattr(tframe, "paint_available",
                        lambda level, cfg, B: False)


def test_forced_scan_equals_paint_path(demo_level, monkeypatch):
    # a height the paint path takes (a multiple of 8)
    cfg = RenderConfig(width=160, height=96, span_capacity=64,
                       mid_capacity=40, clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True)
    te = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=cfg,
                                   device="cpu")
    assert tframe.paint_available(te.level, cfg, 16)
    pos, ang = _spread_poses(demo_level.tables, 16, seed=3)
    st = te.new_game(16, pos=pos, angle=ang,
                     generator=torch.Generator().manual_seed(0))
    painted = te.render(st), te.render_walls(st)
    assert set(te.render_counters(st).values()) == {0}
    monkeypatch.setattr(tframe, "paint_available",
                        lambda level, cfg, B: False)
    before = tp.paint.launches
    scanned = te.render(st), te.render_walls(st)
    assert set(te.render_counters(st).values()) == {0}
    _, aux = te._render(st, items=True)
    assert "pool" in aux and "midpool" not in aux     # the scan path ran
    assert tp.paint.launches == before
    for p, s in zip(painted, scanned):
        assert torch.equal(p[0], s[0]) and torch.equal(p[1], s[1])


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "frames.npz")


@pytest.mark.parametrize("name", ["demo", "e1m1_scale"])
def test_forced_scan_equals_golden(name, info, forced_scan):
    """tests/test_torch_engine.py::test_render_equals_golden through the
    scan + resolve pipeline."""
    from scripts.gen_golden import build_fixture, spawn_mobjs

    golden = np.load(GOLDEN)
    mt, assets = build_fixture(name, info)
    _, _, ms = spawn_mobjs(mt, info)
    level = DeviceLevel.build(mt, assets, info, "cpu")
    cfg = RenderConfig(width=320, height=200, span_capacity=160,
                       mid_capacity=40, clip_capacity=96, item_capacity=24)
    n = int(golden[f"{name}_n_views"])
    views = np.stack([golden[f"{name}_{vi}_view"] for vi in range(n)])
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    fh = [float(mt.sector_floor_h[mt.sector_at(v[0], v[1])]) for v in views]
    idx, rgb, aux = tframe.render_frame(
        level, cfg, f(views[:, 0]), f(views[:, 1]), f(views[:, 2]), f(fh),
        torch.as_tensor(np.repeat(np.asarray(mt.sector_light, np.int32)[None],
                                  n, 0)),
        torch.as_tensor(np.repeat(np.asarray(ms, np.int32)[None], n, 0)),
        f(views[:, 3]),
    )
    assert "pool" in aux
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
