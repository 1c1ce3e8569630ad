"""The slice end to end: doomtpu_torch DoomEngine.render_walls against
the JAX DoomEngine.render_walls on the CPU (the JAX engine's XLA path:
wall_scan + resolve + shade).  B=16 spread poses on the demo fixture,
so the camera sort (B > 8) runs on both sides; the JAX GameState is
moved across with state_from_numpy.  Tolerance: exact equality of idx
and rgb, and every capacity counter 0 on both sides.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from doomtpu.engine import DoomEngine as JaxEngine  # noqa: E402
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu.wad import synth  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.sim.state import state_from_numpy  # noqa: E402


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
            DoomEngine.from_wad_bytes(wad, "e1m1", device="cpu"))


@pytest.fixture(scope="module")
def states(engines):
    je, _ = engines
    pos, ang = _spread_poses(je.tables, B)
    js = je.new_game(B, key=jax.random.PRNGKey(0), pos=pos, angle=ang)
    from dataclasses import fields

    return js, state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in fields(JaxState)},
        "cpu",
    )


def test_render_walls_equals_jax(engines, states):
    je, te = engines
    js, ts = states
    assert te.config.camera_sort and ts.batch > 8
    jidx, jrgb = je.render_walls(js)
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


def test_render_walls_counters_are_zero(engines, states):
    je, te = engines
    js, ts = states
    assert te.render_walls_counters(ts) == {"overflow": 0, "live_dropped": 0}
    assert je.render_walls_counters(js) == {"overflow": 0, "live_dropped": 0}


def test_unported_entry_points_raise(engines, states):
    _, te = engines
    _, ts = states
    for call in (lambda: te.render(ts), lambda: te.render_counters(ts),
                 lambda: te.tick(ts, None), lambda: te.rollout(ts, None),
                 lambda: te.calibrate([ts])):
        with pytest.raises(NotImplementedError):
            call()
