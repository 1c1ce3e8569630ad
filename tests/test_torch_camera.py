"""Camera stage, BSP order, camera sort and point location: the port
against the JAX package on the demo fixture at the poses of
tests/test_paint.py.

Tolerance: exact equality, bit for bit on floats (a NaN only has to be
a NaN), on every key of the seg frame.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from doomtpu.render import camera as jcam  # noqa: E402
from doomtpu.render import camsort as jsort  # noqa: E402
from doomtpu.render.device import DeviceLevel as JaxLevel  # noqa: E402
from doomtpu.sim import sector_lookup as jlookup  # noqa: E402
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu.sim.thinkers import ThinkerTables as JaxThinkers  # noqa: E402
from doomtpu_torch.render import camera as tcam  # noqa: E402
from doomtpu_torch.render import camsort as tsort  # noqa: E402
from doomtpu_torch.render.device import DeviceLevel  # noqa: E402
from doomtpu_torch.sim import sector_lookup as tlookup  # noqa: E402
from doomtpu_torch.sim.state import GameState, state_from_numpy  # noqa: E402
from doomtpu_torch.sim.thinkers import ThinkerTables  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VIEWS = [
    (384.0, 256.0, 0.0),
    (900.0, 256.0, 2.5),
    (300.0, 700.0, 4.6),
    (384.0, 256.0, 3.1),
]


def _same(a, b, what="", dtype=True):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert not dtype or a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), what)
        keep = ~np.isnan(a)
        a, b = a[keep].view(np.int32), b[keep].view(np.int32)
    np.testing.assert_array_equal(a, b, what)


@pytest.fixture(scope="module")
def setup(demo_level):
    t, a, info = demo_level.tables, demo_level.assets, demo_level.info
    jl, tl = JaxLevel.build(t, a, info), DeviceLevel.build(t, a, info, "cpu")
    B = len(VIEWS)
    px = np.asarray([v[0] for v in VIEWS], np.float32)
    py = np.asarray([v[1] for v in VIEWS], np.float32)
    pa = np.asarray([v[2] for v in VIEWS], np.float32)
    fh = np.asarray(
        [float(t.sector_floor_h[t.sector_at(v[0], v[1])]) for v in VIEWS],
        np.float32,
    )
    sl = np.repeat(np.asarray(t.sector_light, np.int32)[None], B, 0)
    ts = np.full(B, 0.4, np.float32)
    return jl, tl, (px, py, pa, fh, sl, ts)


def test_seg_frame_every_key(setup, config):
    jl, tl, poses = setup
    jf = jcam.build_seg_frame(jl, config, *map(jnp.asarray, poses))
    tf = tcam.build_seg_frame(tl, config, *map(torch.from_numpy, poses))
    assert set(jf) == set(tf)
    for k in jf:
        _same(jf[k], tf[k].numpy(), k)


def test_traversal_rank_and_order(setup):
    jl, tl, (px, py, *_) = setup
    jr = jcam.traversal_rank(jl, jnp.asarray(px), jnp.asarray(py))
    tr = tcam.traversal_rank(tl, torch.from_numpy(px), torch.from_numpy(py))
    _same(jcam.node_side_is_left(jl, jnp.asarray(px), jnp.asarray(py)),
          tcam.node_side_is_left(tl, torch.from_numpy(px),
                                 torch.from_numpy(py)).numpy())
    # the JAX rank sum widens to i64 under the tests' x64 mode; the
    # port keeps i32 (ranks are < 2^31 for depth <= 31)
    _same(jr, tr.numpy(), "rank", dtype=False)
    _same(jcam.seg_order(jl, jr), tcam.seg_order(tl, tr).numpy(), "order")


def test_two_word_rank_order(setup):
    """The lexicographic (hi, lo) rank of BSP trees deeper than 31."""
    jl, tl, _ = setup
    rng = np.random.default_rng(0)
    SS = tl.sub_depth.shape[0]
    hi = rng.integers(0, 4, (3, SS)).astype(np.int32)
    lo = rng.integers(0, 4, (3, SS)).astype(np.int32)
    _same(jcam.seg_order(jl, (jnp.asarray(hi), jnp.asarray(lo))),
          tcam.seg_order(tl, (torch.from_numpy(hi),
                              torch.from_numpy(lo))).numpy())


def test_camera_sort_key_and_permutation():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-3000, 3000, (64, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, 64).astype(np.float32)
    pos[:8] = pos[8:16]               # ties keep the original order
    ang[:8] = ang[8:16]
    _same(jsort.camera_sort_key(jnp.asarray(pos), jnp.asarray(ang)),
          tsort.camera_sort_key(torch.from_numpy(pos),
                                torch.from_numpy(ang)).numpy())
    state = GameState(
        pos=torch.from_numpy(pos), angle=torch.from_numpy(ang),
        **{k: torch.zeros(64, dtype=torch.int32) for k in (
            "floor_height", "sector_light", "light_count", "light_up",
            "mobj_state", "mobj_tics", "tick")},
    )
    _, loc = jsort.sort_state(
        JaxState(pos=jnp.asarray(pos), angle=jnp.asarray(ang),
                 **{k: jnp.zeros(64) for k in (
                     "floor_height", "sector_light", "light_count",
                     "light_up", "mobj_state", "mobj_tics", "tick")}),
        64, 1,
    )
    sorted_state, perm = tsort.sort_state(state)
    _same(np.asarray(loc)[0], perm.numpy())
    out = (sorted_state.pos, sorted_state.angle)
    back = tsort.unsort_out(out, perm)
    assert torch.equal(back[0], state.pos) and torch.equal(back[1], state.angle)


def test_point_location_and_initial_state(setup, demo_level):
    jl, tl, _ = setup
    t, info = demo_level.tables, demo_level.info
    rng = np.random.default_rng(2)
    left, right, top, bottom = [float(v) for v in t.bbox]
    pts = np.stack([rng.uniform(left, right, 64),
                    rng.uniform(top, bottom, 64)], -1).astype(np.float32)
    j = jlookup.sector_at(jl, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
    tt = tlookup.sector_at(tl, torch.from_numpy(pts[:, 0]),
                           torch.from_numpy(pts[:, 1]))
    _same(j, tt.numpy())

    import jax

    jth, tth = JaxThinkers.build(t, info), ThinkerTables.build(t, info, "cpu")
    ang = rng.uniform(0, 6, 64).astype(np.float32)
    js = JaxState.initial(jl, jth, 64, pos=pts, angle=ang,
                          key=jax.random.PRNGKey(0))
    ts = GameState.initial(tl, tth, 64, pos=pts, angle=ang,
                           generator=torch.Generator().manual_seed(0))
    for k in ("pos", "angle", "floor_height", "sector_light", "light_up",
              "mobj_state", "mobj_tics", "tick"):
        _same(getattr(js, k), getattr(ts, k).numpy(), k)
    _same(js.timestamp, ts.timestamp.numpy(), "timestamp")
    # countdowns come from the generator: not the same draws, but zero
    # exactly where the sector has no countdown
    assert ts.light_count.shape == js.light_count.shape
    np.testing.assert_array_equal(ts.light_count.numpy() == 0,
                                  np.asarray(js.light_count) == 0)
    moved = state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in (
            "pos", "angle", "floor_height", "sector_light", "light_count",
            "light_up", "mobj_state", "mobj_tics", "tick")},
        "cpu",
    )
    _same(js.light_count, moved.light_count.numpy(), "light_count")
