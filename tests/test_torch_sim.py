"""The port's simulation against the JAX package on the CPU: movement,
the light and map-object thinkers, `tick`, `engine.rollout`, the reused
traversal order's check, the paint stage's cross-tick live-list reuse
the state API, and the trig table a rollout reads once (the host's
replay of the turns, held to the ticks bit for bit, port only).

Fixtures: the demo and e1m1-scale (all eight light specials), B=8
spread poses each, at 64x48, the port's `new_game` moved to JAX.  The
port cannot reproduce JAX's threefry draws, so each port call is fed
the two [B, SEC] draws JAX's `step_lights` makes from its key
(thinkers.py:145-147), for JAX's own per-tick keys.

JAX's references are few: one jit of `engine.rollout` (module-scoped),
one interpret-mode call of the paint kernel (unroll=1 / gsub=2, as
tests/test_paint.py runs it), jits of the small sim functions.  On the
CPU JAX's `paint_available` is False, so its rollout scans; the port's
rollout is held to it on its scan path and on its paint path (at 48
rows the two pipelines draw the same frames).  Tolerance: exact
equality of every field, frame, pool and counter.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from doomtpu.config import RenderConfig as JaxConfig  # noqa: E402
from doomtpu.engine import DoomEngine as JaxEngine  # noqa: E402
from doomtpu.render import camera as jcam  # noqa: E402
from doomtpu.render import frame as jframe  # noqa: E402
from doomtpu.sim import player as jplayer  # noqa: E402
from doomtpu.sim import thinkers as jtk  # noqa: E402
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu_torch.config import RenderConfig  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.render import camera as tcam  # noqa: E402
from doomtpu_torch.render import jmath  # noqa: E402
from doomtpu_torch.sim import player as tplayer  # noqa: E402
from doomtpu_torch.sim import step as tstep  # noqa: E402
from doomtpu_torch.sim import thinkers as ttk  # noqa: E402
from doomtpu_torch.sim.state import GameState  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# pools above the fixtures' peaks at these poses over the rollouts, no
# deeper (JAX's compile time grows with them): e1m1-scale span 51, mid
# 10, clip 43, item 11; the demo span 12, mid 1, clip 10, item 2
CFG = RenderConfig(width=64, height=48, span_capacity=56, mid_capacity=16,
                   clip_capacity=48, item_capacity=16)
DEMO = RenderConfig(width=64, height=48, span_capacity=16, mid_capacity=4,
                    clip_capacity=16, item_capacity=4)
PAINT = dataclasses.replace(DEMO, use_pallas_paint=True,
                            paint_percam_compact=True)
B = 8
T = 4
# every key bit over the batch, so each camera walks, turns, strafes or
# runs
MOVES = np.array([[1, 1 | 4, 1 | 8, 2, 16 | 4, 1 | 32, 4, 16 | 8 | 32]],
                 np.int32)


def _pair(cfg: RenderConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def _spread(t, n, seed):
    rng = np.random.default_rng(seed)
    left, right, top, bottom = [float(v) for v in t.bbox]
    out = []
    while len(out) < n:
        x, y = rng.uniform(left, right), rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            out.append((x, y, rng.uniform(0, 2 * math.pi)))
    return (np.asarray([p[:2] for p in out], np.float32),
            np.asarray([p[2] for p in out], np.float32))


def _to_jax(ts: GameState) -> JaxState:
    return JaxState(**{f.name: jnp.asarray(getattr(ts, f.name).numpy())
                       for f in dataclasses.fields(JaxState)})


def _assert_state_equal(ts: GameState, js: JaxState):
    for f in dataclasses.fields(JaxState):
        got, want = getattr(ts, f.name).numpy(), np.asarray(getattr(js,
                                                                    f.name))
        assert got.shape == want.shape, f.name
        np.testing.assert_array_equal(got, want, f.name)


def jax_draws(key, batch, sectors) -> np.ndarray:
    """[2, B, SEC] i32: the draws JAX's step_lights makes from `key`."""
    return np.stack([
        np.asarray(jax.random.randint(k, (batch, sectors), 0, 1 << 30,
                                      dtype=jnp.int32))
        for k in jax.random.split(key)])


@pytest.fixture(scope="module")
def demo():
    """Both engines on the demo and B=8 spread poses (JAX, port)."""
    wad = synth.demo_wad()
    je = JaxEngine.from_wad_bytes(wad, "e1m1", config=_pair(DEMO))
    te = DoomEngine.from_wad_bytes(wad, "e1m1", config=DEMO, device="cpu")
    pos, ang = _spread(te.tables, B, seed=0)
    ts = te.new_game(B, pos=pos, angle=ang,
                     generator=torch.Generator().manual_seed(0))
    return je, te, _to_jax(ts), ts


@pytest.fixture(scope="module")
def e1():
    """Both engines on e1m1-scale and B=8 spread poses (JAX, port)."""
    wad = synth.e1m1_scale_wad()
    je = JaxEngine.from_wad_bytes(wad, "e1m1", config=_pair(CFG))
    te = DoomEngine.from_wad_bytes(wad, "e1m1", config=CFG, device="cpu")
    pos, ang = _spread(te.tables, B, seed=1)
    ts = te.new_game(B, pos=pos, angle=ang,
                     generator=torch.Generator().manual_seed(0))
    return je, te, _to_jax(ts), ts


# ---------------------------------------------------------------------------
# (a) movement
# ---------------------------------------------------------------------------

def test_move_player_equals_jax(demo):
    """All 64 control masks at 3 poses, turbo 1 and 2.5: position,
    angle and floor height."""
    je, te, *_ = demo
    poses = [(384.0, 256.0, 0.0), (900.0, 256.0, 2.5), (300.0, 700.0, 4.6)]
    ctl = np.tile(np.arange(64, dtype=np.int32), len(poses))
    pos = np.repeat(np.asarray([p[:2] for p in poses], np.float32), 64, 0)
    ang = np.repeat(np.asarray([p[2] for p in poses], np.float32), 64)
    move = jax.jit(lambda lvl, p, a, c, t: jplayer.move_player(lvl, p, a, c,
                                                               t))
    for turbo in (1.0, 2.5):
        want = move(je.level, pos, ang, ctl, jnp.float32(turbo))
        got = tplayer.move_player(te.level, torch.from_numpy(pos),
                                  torch.from_numpy(ang),
                                  torch.from_numpy(ctl), turbo)
        for g, w, name in zip(got, want, ("pos", "angle", "floor_height")):
            assert g.dtype == torch.float32, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
        # every key moved some camera
        assert len(np.unique(got[0].numpy(), axis=0)) > 20
        assert len(np.unique(got[1].numpy())) == 5 * len(poses)


# ---------------------------------------------------------------------------
# (b) the thinkers
# ---------------------------------------------------------------------------

def test_step_lights_equals_jax(e1):
    """40 ticks of every light special on e1m1-scale, each fed JAX's
    draws."""
    je, te, js, ts = e1
    specials = set(np.asarray(te.tables.sector_special).tolist())
    assert {1, 2, 3, 4, 8, 12, 13, 17} <= specials
    step = jax.jit(jtk.step_lights)
    jl, jc, ju = js.sector_light, js.light_count, js.light_up
    tl, tc, tu = ts.sector_light, ts.light_count, ts.light_up
    changed = np.zeros(tl.shape[1], bool)
    for i in range(40):
        key = jax.random.PRNGKey(100 + i)
        jl, jc, ju = step(je.thinkers, jl, jc, ju, key)
        tl, tc, tu = ttk.step_lights(
            te.thinkers, tl, tc, tu,
            torch.from_numpy(jax_draws(key, B, tl.shape[1])))
        for g, w, name in ((tl, jl, "light"), (tc, jc, "count"),
                           (tu, ju, "going_up")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          f"{name} at tick {i}")
        changed |= (tl != ts.sector_light).any(0).numpy()
    # every kind of special moved its light
    kind = te.thinkers.kind.numpy()
    for k in (ttk.K_FLASH, ttk.K_STROBE, ttk.K_GLOW, ttk.K_FIRE):
        assert changed[kind == k].any(), k


def test_mobjs_equal_jax(e1):
    """The map-object state machine over 40 ticks, then kill, explode
    and respawn."""
    je, te, js, ts = e1
    step = jax.jit(jtk.step_mobjs)
    jst, jti = js.mobj_state, js.mobj_tics
    tst, tti = ts.mobj_state, ts.mobj_tics
    moved = 0
    for i in range(40):
        jst, jti = step(je.level, jst, jti)
        tst, tti = ttk.step_mobjs(te.level, tst, tti)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        np.testing.assert_array_equal(tti.numpy(), np.asarray(jti))
        moved += int((tst != ts.mobj_state).any())
    assert moved > 0
    # kill, explode, then respawn the killed ones
    for fn in ("kill_mobjs", "explode_mobjs", "respawn_mobjs"):
        ws, wt = getattr(jtk, fn)(je.level, jst, jti)
        gs, gt = getattr(ttk, fn)(te.level, tst, tti)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws), fn)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(wt), fn)
        assert (gs != tst).any(), fn
        if fn == "explode_mobjs":
            jst, jti, tst, tti = ws, wt, gs, gt


# ---------------------------------------------------------------------------
# (c) tick and (d) the rollout
# ---------------------------------------------------------------------------

def test_tick_equals_jax(e1):
    """Three ticks of moving controls through both engines' tick, field
    by field, and the engine's *_everything calls."""
    je, te, js, ts = e1
    for i in range(3):
        key = jax.random.PRNGKey(7 + i)
        js = je.tick(js, jnp.asarray(MOVES[0]), key)
        ts = te.tick(ts, MOVES[0],
                     draws=torch.from_numpy(jax_draws(key, B,
                                                      te.level.num_sectors)))
        _assert_state_equal(ts, js)
    assert int(ts.tick[0]) == 3
    for fn in ("kill_everything", "explode_everything", "respawn_everything"):
        _assert_state_equal(getattr(te, fn)(ts), getattr(je, fn)(js))


@pytest.fixture(scope="module")
def jax_rollout(demo):
    """JAX's engine.rollout on the demo, T=4 moving ticks in one
    unchained scan, and the per-tick draws its keys make."""
    je, te, js, _ = demo
    key = jax.random.PRNGKey(3)
    controls = np.repeat(MOVES, T, 0)
    final, frames = je.rollout(js, jnp.asarray(controls), key,
                               return_frames=True, max_ticks_per_jit=0)
    draws = np.stack([jax_draws(k, B, te.level.num_sectors)
                      for k in jax.random.split(key, T)])
    return controls, draws, final, np.asarray(frames)


@pytest.mark.parametrize("cfg", [DEMO, PAINT], ids=["scan", "paint"])
def test_rollout_equals_jax(demo, jax_rollout, cfg):
    je, te, _, ts = demo
    controls, draws, jfinal, jframes = jax_rollout
    assert not jframe.paint_available(je.level, _pair(cfg), B)  # JAX scans
    eng = dataclasses.replace(te, config=cfg)
    final, frames = eng.rollout(ts, controls, draws=draws)
    _assert_state_equal(final, jfinal)
    assert frames.dtype == torch.int32 and frames.shape == (T, B, 48, 64)
    np.testing.assert_array_equal(frames.numpy(), jframes)
    final, sums = eng.rollout(ts, controls, draws=draws, return_frames=False)
    _assert_state_equal(final, jfinal)
    assert sums.shape == (T, B)
    np.testing.assert_array_equal(sums.numpy(), jframes.sum(axis=(2, 3)))
    # the cameras moved, so the frames did
    assert (jframes[0] != jframes[-1]).any(axis=(1, 2)).sum() >= B // 2


# ---------------------------------------------------------------------------
# (e) the reused order's check
# ---------------------------------------------------------------------------

def test_order_matches_rank_equals_jax(demo):
    """A reused traversal order against the rank of moved poses: the
    cameras that stayed, or moved within their BSP leaves, keep it; the
    ones that crossed a partition do not.  The rank as one word and as
    a (hi, lo) pair."""
    je, te, *_ = demo
    a = np.asarray([(384.0, 256.0), (384.0, 256.0), (900.0, 256.0),
                    (300.0, 700.0)], np.float32)
    b = np.asarray([(384.0, 256.0), (1000.0, 600.0), (901.0, 256.0),
                    (300.0, 200.0)], np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    order = tcam.seg_order(te.level, tcam.traversal_rank(te.level, ta[:, 0],
                                                         ta[:, 1]))
    rank = tcam.traversal_rank(te.level, tb[:, 0], tb[:, 1])
    jrank = jcam.traversal_rank(je.level, jnp.asarray(b[:, 0]),
                                jnp.asarray(b[:, 1]))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    jorder = jnp.asarray(order.numpy())
    got = tcam.order_matches_rank(te.level, rank, order)
    want = np.asarray(jcam.order_matches_rank(je.level, jrank, jorder))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] and not want[1] and not want.all()
    # the same ranks split in two words, compared lexicographically
    got2 = tcam.order_matches_rank(te.level, (rank >> 3, rank & 7), order)
    want2 = jcam.order_matches_rank(je.level, (jrank >> 3, jrank & 7), jorder)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    np.testing.assert_array_equal(got2.numpy(), want)
    # a fresh order always matches its own rank
    assert tcam.order_matches_rank(te.level, rank, tcam.seg_order(
        te.level, rank)).all()


# ---------------------------------------------------------------------------
# (f) the paint stage's live-list reuse
# ---------------------------------------------------------------------------

# per-camera lists under a cap below the live peak (246 at pose A), a
# multiple of 32; pools below the poses' peaks (mid 10, clip 43), so
# both sides overflow the same records (the interpret-mode kernel's
# compile time grows with the pools)
REUSE = RenderConfig(width=64, height=48, mid_capacity=4, clip_capacity=8,
                     use_pallas_paint=True, paint_percam_compact=True,
                     paint_live_capacity=64)


def _args(st):
    return (st.pos[:, 0], st.pos[:, 1], st.angle, st.floor_height,
            st.sector_light, st.timestamp)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _paint_outputs(out) -> dict:
    named = {k: _np(out[k]) for k in (
        "idx", "ld", "rgb", "cnt_mid", "cnt_clip", "overflow",
        "live_dropped", "live_stale")}
    for name in ("midpool", "clippool"):
        for i, p in enumerate(out[name]):
            named[f"{name}{i}"] = _np(p)
    return named


def test_paint_reuse_equals_jax(e1):
    """A want_reuse call at pose A under a dropping cap, then a reuse
    call at pose B (each camera 24 units on and turned 0.15 rad) in A's
    order, B=4: the kept set's live_dropped at A, and every output at B
    against JAX's render_paint, live_stale > 0.  Both sides paint the
    port's camera stage and order (tests/test_torch_camera.py holds them
    to JAX's); JAX's render_paint is jitted, the refresh call for its
    reuse metadata alone, so XLA drops that kernel (the capped frame at
    a fresh pose is tests/test_torch_faults.py's)."""
    from doomtpu.ops.pallas_paint import render_paint

    je, te, _, ts = e1
    ts = ts.map(lambda x: x[:4])
    jcfg = _pair(REUSE)
    c = ts.angle.numpy()
    moved = dataclasses.replace(
        ts, pos=ts.pos + torch.from_numpy(
            24.0 * np.stack([np.cos(c), np.sin(c)], -1).astype(np.float32)),
        angle=ts.angle + 0.15)

    @jax.jit
    def refresh(level, frame, order, pa, px, py, fh):
        return render_paint(level, jcfg, frame, order, pa, px, py, fh,
                            interpret=True, unroll=1, gsub=2,
                            want_reuse=True)["reuse"]

    @jax.jit
    def reuse(level, frame, order, pa, px, py, fh, meta):
        return render_paint(level, jcfg, frame, order, pa, px, py, fh,
                            interpret=True, unroll=1, gsub=2, reuse=meta)

    def paint(st, order=None, kept=None, meta=None):
        """(port, JAX) render_paint at st's poses, in `order` (else this
        pose's own)."""
        px, py, pa, fh, sl, tsm = _args(st)
        frame = tcam.build_seg_frame(te.level, REUSE, px, py, pa, fh, sl, tsm)
        if order is None:
            order = tcam.seg_order(te.level, tcam.traversal_rank(
                te.level, px, py))
        got = tp.render_paint(te.level, REUSE, frame, order, pa, px, py, fh,
                              reuse=kept, want_reuse=kept is None)
        j = [{k: jnp.asarray(v.numpy()) for k, v in frame.items()}] + [
            jnp.asarray(x.numpy()) for x in (order, pa, px, py, fh)]
        want = (refresh(je.level, *j) if meta is None
                else reuse(je.level, *j, meta))
        return order, got, want

    order, got_a, meta = paint(ts)
    assert int(got_a["live_dropped"]) == int(meta["live_dropped"]) > 0
    assert int(got_a["reuse"]["live_dropped"]) == int(meta["live_dropped"])
    _, got, want = paint(moved, order, got_a["reuse"], meta)
    g, w = _paint_outputs(got), _paint_outputs(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], k)
    assert w["live_stale"] > 0 and w["overflow"].sum() > 0
    assert w["live_dropped"] == int(meta["live_dropped"])


# ---------------------------------------------------------------------------
# (g) the port's reuse rollout
# ---------------------------------------------------------------------------

def test_reuse_rollout_still_is_exact(demo):
    """Zero controls: live_stale 0 and the frames of the rollout without
    reuse.  Moving controls in segments of 2 ticks (T=5): the summed
    live_stale is the sum of the segments' own, and the refresh points
    change it."""
    _, te, _, ts = demo
    eng = dataclasses.replace(te, config=PAINT)
    draws = np.stack([jax_draws(jax.random.PRNGKey(50 + t), B,
                                te.level.num_sectors) for t in range(5)])
    still = np.zeros((3, B), np.int32)
    f0, frames0 = eng.rollout(ts, still, draws=draws[:3])
    f1, frames1, stale = eng.rollout(ts, still, draws=draws[:3],
                                     live_reuse=True)
    assert int(stale) == 0
    np.testing.assert_array_equal(frames1.numpy(), frames0.numpy())
    _assert_state_equal(f1, _to_jax(f0))

    moving = np.repeat(MOVES, 5, 0)
    final, sums, stale = eng.rollout(ts, moving, draws=draws,
                                     return_frames=False, live_reuse=True,
                                     max_ticks_per_jit=2)
    st, total, parts = ts, 0, []
    for s0 in (0, 2, 4):
        st, part, s = eng.rollout(st, moving[s0:s0 + 2],
                                  draws=draws[s0:s0 + 2],
                                  return_frames=False, live_reuse=True,
                                  max_ticks_per_jit=0)
        total += int(s)
        parts.append(part)
    assert int(stale) == total > 0
    np.testing.assert_array_equal(sums.numpy(), torch.cat(parts).numpy())
    _assert_state_equal(final, _to_jax(st))
    _, _, one_window = eng.rollout(ts, moving, draws=draws,
                                   return_frames=False, live_reuse=True,
                                   max_ticks_per_jit=0)
    assert int(one_window) > int(stale)
    with pytest.raises(ValueError):              # reuse needs percam lists
        dataclasses.replace(te, config=dataclasses.replace(
            PAINT, paint_percam_compact=False)).rollout(
                ts, still, draws=draws[:3], live_reuse=True)
    with pytest.raises(ValueError):              # ... and the paint path
        te.rollout(ts, still, draws=draws[:3], live_reuse=True)


# ---------------------------------------------------------------------------
# (h) the state API
# ---------------------------------------------------------------------------

def test_state_api_equals_jax(demo, tmp_path):
    """save_state / load_state across the packages both ways,
    player_position_json string for string, map_2d array for array."""
    je, te, *_ = demo
    ts = te.new_game(4, pos=np.asarray([(384.0, 256.0), (900.0, 256.0),
                                        (300.0, 700.0), (130.5, 77.25)],
                                       np.float32),
                     angle=np.asarray([0.0, 2.5, 4.6, 1.1], np.float32),
                     generator=torch.Generator().manual_seed(3))
    ts = te.tick(ts, [1, 4, 8 | 16, 32 | 1])
    js = _to_jax(ts)
    te.save_state(ts, str(tmp_path / "port.npz"))
    _assert_state_equal(ts, je.load_state(str(tmp_path / "port.npz")))
    je.save_state(js, str(tmp_path / "jax.npz"))
    back = te.load_state(str(tmp_path / "jax.npz"))
    _assert_state_equal(back, js)
    for f in dataclasses.fields(GameState):
        assert getattr(back, f.name).dtype == getattr(ts, f.name).dtype
    for env in range(4):
        got = te.player_position_json(ts, env)
        assert got == je.player_position_json(js, env)
        assert json.loads(got)["angle"] == float(ts.angle[env])
        m = te.map_2d(ts, env)
        assert m.dtype == np.uint8 and m.shape == (48, 64, 3)
        np.testing.assert_array_equal(m, je.map_2d(js, env))


# ---------------------------------------------------------------------------
# (i) the trig table: one host round trip a rollout (port only, no JAX)
# ---------------------------------------------------------------------------

def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _all_masks(ticks, n, seed) -> np.ndarray:
    """[ticks, n] i32: each of the 64 control masks equally often, in a
    random order."""
    rng = np.random.default_rng(seed)
    return rng.permutation(np.resize(np.arange(64, dtype=np.int32),
                                     ticks * n)).reshape(ticks, n)


@pytest.mark.parametrize("turbo", [1.0, 2.0])
def test_host_turns_and_trig_equal_the_ticks(demo, turbo):
    """Over 32 ticks of every control mask at B=16: the host's replay of
    the turns (player.turns) gives the angles `tick` computes, bit for
    bit, and the rollout's table (player.tick_trig) holds cos_sin of the
    tick's own a_t, -a_t and a_t + pi/2, bit for bit."""
    _, te, _, _ = demo
    eng = dataclasses.replace(te, turbo=turbo)
    n, ticks = 16, 32
    pos, ang = _spread(te.tables, n, seed=5)
    st = eng.new_game(n, pos=pos, angle=ang,
                      generator=torch.Generator().manual_seed(0))
    controls = _all_masks(ticks, n, seed=7)
    draws = eng.light_draws(n, torch.Generator().manual_seed(1), ticks=ticks)
    table = tplayer.tick_trig(st.angle, torch.from_numpy(controls), turbo)
    assert table.shape == (ticks, 6, n) and table.dtype == torch.float32
    turned = tplayer.turns(st.angle.numpy(), controls, turbo)
    for t in range(ticks):
        st = eng.tick(st, controls[t], draws=draws[t])
        np.testing.assert_array_equal(_bits(turned[t]),
                                      _bits(st.angle.numpy()))
        for row, x in ((jmath.COS, st.angle), (jmath.NCOS, -st.angle),
                       (jmath.SCOS, st.angle + float(jmath.HALF_PI))):
            c, s = jmath.cos_sin(x)
            np.testing.assert_array_equal(_bits(table[t, row]), _bits(c))
            np.testing.assert_array_equal(_bits(table[t, row + 1]), _bits(s))
    assert (st.angle != torch.from_numpy(ang)).any()


@pytest.mark.parametrize("cfg,live_reuse", [(DEMO, False), (PAINT, False),
                                            (PAINT, True)],
                         ids=["scan", "paint", "paint-reuse"])
def test_rollout_table_equals_tick_by_tick(demo, cfg, live_reuse):
    """A rollout's frames, final state (and live_stale) with its one
    trig table equal a loop of `engine.tick` and a render that take
    their trig from the device's own angles, call by call: 16 sorted
    cameras, 4 ticks of every control mask.  With live_reuse the loop
    renders as the rollout does (sim/step._render, the first tick's
    order, permutation and kept set reused)."""
    _, te, _, _ = demo
    eng = dataclasses.replace(te, config=cfg)
    n, ticks = 16, 4
    pos, ang = _spread(te.tables, n, seed=6)
    st0 = eng.new_game(n, pos=pos, angle=ang,
                       generator=torch.Generator().manual_seed(0))
    controls = _all_masks(ticks, n, seed=8)
    draws = eng.light_draws(n, torch.Generator().manual_seed(2), ticks=ticks)
    final, frames, *stale = eng.rollout(st0, controls, draws=draws,
                                        live_reuse=live_reuse)
    st, outs, reuse, want_stale = st0, [], None, 0
    for t in range(ticks):
        st = eng.tick(st, controls[t], draws=draws[t])
        if live_reuse:
            out, s, meta = tstep._render(
                eng.level, cfg, st, True, jmath.camera_trig(st.angle),
                reuse=reuse, want_reuse=t == 0)
            reuse, want_stale = meta or reuse, want_stale + int(s)
        else:
            out = eng.render(st)[0]
        outs.append(out)
    assert torch.equal(frames, torch.stack(outs))
    for f in dataclasses.fields(GameState):
        assert torch.equal(getattr(final, f.name), getattr(st, f.name)), \
            f.name
    if live_reuse:
        assert int(stale[0]) == want_stale
