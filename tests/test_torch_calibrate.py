"""Calibration in the port (doomtpu_torch/calibrate.py,
render/things.py::item_census, engine.calibrate) against the JAX
package on the CPU.

- item_census equals JAX's things.item_census element by element on
  e1m1-scale (B=8, each side's own uncapped wall scan);
- calibrated_config equals JAX's field by field in three cases, each a
  3-state tick chain the port makes and moves to JAX: demo (160x96,
  B=16, so the Morton sort runs; walking, so the geometry census reruns
  every state), e1m1-scale (320x200, B=8, zero controls) in
  render_chunk=4 pieces (the chunked tile rule, geometry censused once a
  piece), and the same with paint_percam_compact=True; the
  grow-and-rerun loop runs from a lowered start;
- after engine.calibrate every counter is 0 on every censused state, on
  the paint and the scan path;
- the disk cache: hit, key, off, and JAX's entry never read.

The JAX side costs one census jit a case (three calls in all, module
scope) and one item-census jit.  Tolerance: exact equality.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_fixtures import spread_poses  # noqa: E402
from doomtpu import calibrate as jcal  # noqa: E402
from doomtpu.config import RenderConfig as JaxConfig  # noqa: E402
from doomtpu.engine import DoomEngine as JaxEngine  # noqa: E402
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu_torch import calibrate as tcal  # noqa: E402
from doomtpu_torch.config import RenderConfig  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (WAD, B, controls of the chain's ticks, config fields)
CASES = {
    "demo": ("demo_wad", 16, KEY_UP | KEY_LEFT,
             dict(width=160, height=96, span_capacity=8,
                  use_pallas_paint=True)),
    "e1m1-chunked": ("e1m1_scale_wad", 8, 0, dict(render_chunk=4)),
    "e1m1-percam": ("e1m1_scale_wad", 8, 0,
                    dict(render_chunk=4, paint_percam_compact=True)),
}


def _to_jax(ts) -> JaxState:
    return JaxState(**{f.name: jnp.asarray(getattr(ts, f.name).numpy())
                       for f in dataclasses.fields(JaxState)})


def _chain(te, B, controls, n=3):
    pos, ang = spread_poses(te.tables, B)
    gen = torch.Generator().manual_seed(0)
    states = [te.new_game(B, pos=pos, angle=ang, generator=gen)]
    ctl = torch.full((B,), controls, dtype=torch.int32)
    for _ in range(n - 1):
        states.append(te.tick(states[-1], ctl, gen))
    return states


def _jax_config(je, jstates, cache_dir="0"):
    """JAX's calibrated_config with its disk cache at `cache_dir`."""
    old = os.environ["DOOMTPU_CALIB_CACHE"]
    os.environ["DOOMTPU_CALIB_CACHE"] = str(cache_dir)
    try:
        return jcal.calibrated_config(je, jstates)
    finally:
        os.environ["DOOMTPU_CALIB_CACHE"] = old


@pytest.fixture(scope="module")
def census(tmp_path_factory):
    """case name -> dict(te, je, states, jstates, jax_cfg, jax_dir): each
    case's JAX calibrated_config, computed on first use.  The demo case
    writes JAX's cache entry into jax_dir."""
    memo = {}
    jax_dir = tmp_path_factory.mktemp("jax_calib")

    def get(name):
        if name not in memo:
            wad_fn, B, controls, kw = CASES[name]
            wad = getattr(synth, wad_fn)()
            te = DoomEngine.from_wad_bytes(wad, "e1m1", device="cpu",
                                           config=RenderConfig(**kw))
            je = JaxEngine.from_wad_bytes(wad, "e1m1", config=JaxConfig(**kw))
            states = _chain(te, B, controls)
            jstates = [_to_jax(s) for s in states]
            jc = _jax_config(je, jstates,
                             jax_dir if name == "demo" else "0")
            memo[name] = dict(te=te, je=je, states=states, jstates=jstates,
                              jax_cfg=jc, jax_dir=jax_dir)
        return memo[name]

    return get


def _assert_same_config(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_item_census_equals_jax(census):
    """e1m1-scale, B=8, tile 8: n_valid, presence and presence_block of
    the port's item_census on its own wall scan's mid pool against JAX's
    on its own."""
    from doomtpu.render import camera as jcam
    from doomtpu.render import things as jthings
    from doomtpu.render import walls as jwalls
    from doomtpu_torch.render import camera as cam
    from doomtpu_torch.render import things, walls

    c = census("e1m1-chunked")
    te, je = c["te"], c["je"]
    st, js = c["states"][1], c["jstates"][1]
    cfg = dataclasses.replace(te.config, span_capacity=64)
    jcfg = dataclasses.replace(je.config, span_capacity=64)

    @jax.jit
    def jax_census(level, s):
        px, py = s.pos[:, 0], s.pos[:, 1]
        frame = jcam.build_seg_frame(level, jcfg, px, py, s.angle,
                                     s.floor_height, s.sector_light,
                                     s.timestamp)
        order = jcam.seg_order(level, jcam.traversal_rank(level, px, py))
        pool, cnt, ovf = jwalls.wall_scan(level, jcfg, frame, order)
        out = jthings.item_census(
            level, jcfg, frame, jthings.pools_from_unified(pool, cnt), px,
            py, s.angle, s.floor_height, s.sector_light, s.mobj_state,
            tile=8)
        return out, ovf.sum()

    want, jovf = jax_census(je.level, js)
    lvl = te.level
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(lvl, cfg, px, py, st.angle, st.floor_height,
                                st.sector_light, st.timestamp)
    order = cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))
    pool, cnt, ovf = walls.wall_scan(lvl, cfg, frame, order)
    got = things.item_census(
        lvl, cfg, frame, things.pools_from_unified(pool, cnt, frame), px, py,
        st.angle, st.floor_height, st.sector_light, st.mobj_state, tile=8)
    assert int(ovf.sum()) == int(jovf) == 0
    for k in ("n_valid", "presence", "presence_block"):
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["presence"].max()) > 0 and int(got["presence_block"]) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_calibrated_config_equals_jax(census, case):
    c = census(case)
    got = tcal.calibrated_config(c["te"], c["states"], cache=False)
    _assert_same_config(got, c["jax_cfg"])
    # the census measured something: the pools left their start values
    assert got.span_capacity != c["te"].config.span_capacity


def test_grow_and_rerun(census, monkeypatch):
    """From a census pool of 8 (the demo's span peak is above it) the
    census overflows, doubles the pool, resets every peak and reruns
    until its overflow is 0: the result is JAX's (which starts at 64)."""
    c = census("demo")
    rounds = []
    geom = tcal._geom_census

    def counted(cfg, *a):
        out = geom(cfg, *a)
        rounds.append((cfg.span_capacity, out["overflow"]))
        return out

    monkeypatch.setattr(tcal, "_MIN_SPAN", 8)
    monkeypatch.setattr(tcal, "_geom_census", counted)
    got = tcal.calibrated_config(c["te"], c["states"], cache=False)
    _assert_same_config(got, c["jax_cfg"])
    caps = sorted({k for k, _ in rounds})
    assert caps[0] == 8 and len(caps) >= 2, rounds
    assert any(o > 0 for k, o in rounds if k == 8)
    assert all(o == 0 for k, o in rounds if k == caps[-1])
    # walking: every state's pose differs, so each round censuses each
    assert len(rounds) == 3 * len(caps)


def test_calibrated_render_is_drop_free(census):
    """The counterpart of tests/test_calibrate.py: capacities at their
    quanta, and every counter 0 on every censused state, on the paint
    path and on the scan path."""
    c = census("demo")
    cal = c["te"].calibrate(c["states"])
    cfg = cal.config
    _assert_same_config(cfg, c["jax_cfg"])
    for f, q in (("span_capacity", 8), ("clip_capacity", 8),
                 ("mid_capacity", 8), ("item_capacity", 8),
                 ("max_visible_mobjs", 32), ("paint_live_capacity", 32)):
        assert getattr(cfg, f) % q == 0 and getattr(cfg, f) > 0, f
    scan = dataclasses.replace(
        cal, config=dataclasses.replace(cfg, use_pallas_paint=False))
    for eng in (cal, scan):
        for st in c["states"]:
            counters = eng.render_counters(st)
            assert set(counters.values()) == {0}, counters


def _entries(d) -> set:
    return {p for p in os.listdir(d) if p.endswith(".json")}


def test_cache_hit_and_off(census, tmp_path, monkeypatch):
    """A second call reads the entry the first wrote (the census does not
    run again); DOOMTPU_CALIB_CACHE=0 writes nothing and censuses."""
    c = census("demo")
    calls = []
    geom = tcal._geom_census
    monkeypatch.setattr(tcal, "_geom_census",
                        lambda *a: calls.append(1) or geom(*a))
    monkeypatch.setenv("DOOMTPU_CALIB_CACHE", str(tmp_path))
    first = tcal.calibrated_config(c["te"], c["states"])
    n = len(calls)
    assert n > 0 and len(_entries(tmp_path)) == 1
    entry = json.loads((tmp_path / _entries(tmp_path).pop()).read_text())
    assert entry["span_capacity"] == first.span_capacity
    assert "peaks" in entry
    again = tcal.calibrated_config(c["te"], c["states"])
    assert len(calls) == n
    _assert_same_config(again, first)

    written = sorted(tmp_path.rglob("*"))
    monkeypatch.setenv("DOOMTPU_CALIB_CACHE", "0")
    monkeypatch.chdir(tmp_path)
    tcal.calibrated_config(c["te"], c["states"])
    assert len(calls) == 2 * n
    assert not (tmp_path / "0").exists()
    assert sorted(tmp_path.rglob("*")) == written


def test_cache_key_follows_the_states(census):
    c = census("demo")
    te, states = c["te"], c["states"]
    key = tcal._cache_key(te, states, (8, 32))
    assert key == tcal._cache_key(te, list(states), (8, 32))
    moved = states[2].map(lambda x: x.clone())
    moved.mobj_state[3, 0] += 1
    assert tcal._cache_key(te, states[:2] + [moved], (8, 32)) != key
    assert tcal._cache_key(te, states, (8, 16)) != key
    other = dataclasses.replace(
        te, config=dataclasses.replace(te.config, render_chunk=8))
    assert tcal._cache_key(other, states, (8, 32)) != key


def test_jax_cache_entry_is_not_read(census, monkeypatch):
    """JAX's calibrated_config wrote its entry for the demo case into
    jax_dir; pointed at that directory, the port reads none of it (a
    poisoned copy of the entry changes nothing) and writes its own."""
    c = census("demo")
    d = c["jax_dir"]
    (jax_entry,) = _entries(d)
    poisoned = json.loads((d / jax_entry).read_text())
    poisoned.update(span_capacity=999, item_capacity=999)
    (d / jax_entry).write_text(json.dumps(poisoned))
    monkeypatch.setenv("DOOMTPU_CALIB_CACHE", str(d))
    got = tcal.calibrated_config(c["te"], c["states"])
    _assert_same_config(got, c["jax_cfg"])
    assert len(_entries(d)) == 2
    assert tcal._cache_key(c["te"], c["states"], (8, 32)) + ".json" \
        != jax_entry
