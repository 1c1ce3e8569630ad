"""Three faults of the port, mended and held to the JAX package on the
CPU:

- the pipeline choice: `frame.paint_available` is the JAX rule (less its
  backend test), so one config takes the same pipeline in both packages.
  At 64x264 (B=4, the demo) the default config takes scan + resolve in
  both, whose 8-bit span rows leave walls past row 254 undrawn, and
  `use_pallas_paint=True` takes the paint path in both, which draws
  them; each equals its JAX counterpart frame for frame and counter for
  counter;
- the live-seg cap: under `paint_live_capacity` the port drops the segs
  JAX's render_paint drops and counts the same `live_dropped`, per
  camera and per tile of cameras (e1m1-scale, 256x96, B=4, a cap of 32
  below the live peak); at a cap at or above the peak it drops nothing
  and the frame is the uncapped one;
- two cases never compared before: (a) the paint stage and the item
  composite on that tall screen, at poses whose sprites and walls reach
  rows 255 and more, against JAX render_paint and composite_items in
  interpret mode; (b) a masked mid 256 rows tall (atlas_rows > 128,
  where JAX composites in XLA), its WAD built here by both packages'
  builders, through both engines' render.

The JAX Pallas kernels run in interpret mode at unroll=1 / gsub=2, as
tests/test_paint.py runs them, once each per module.  Their round-up of
the live cap (a multiple of unroll x gsub = 2) leaves the test's caps,
multiples of 32, as they are; the port rounds as the JAX kernel does at
its production unroll and gsub (4 x 8).  Pools sit just above the
fixtures' peaks (the interpret-mode kernels unroll them).  Tolerance:
exact equality of every output and counter.
"""

import dataclasses
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
from doomtpu.render import things as jthings  # noqa: E402
from doomtpu.sim.state import GameState as JaxState  # noqa: E402
from doomtpu.wad import builder as jbuilder  # noqa: E402
from doomtpu.wad import synth as jsynth  # noqa: E402
from torch_fixtures import tall_mid_wad  # noqa: E402
from doomtpu_torch.config import RenderConfig  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.render import camera as tcam  # noqa: E402
from doomtpu_torch.render import frame as tframe  # noqa: E402
from doomtpu_torch.wad import builder as tbuilder  # noqa: E402
from doomtpu_torch.wad import synth as tsynth  # noqa: E402


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


def _pair(cfg: RenderConfig) -> JaxConfig:
    """The JAX package's RenderConfig with the same fields."""
    return JaxConfig(**dataclasses.asdict(cfg))


def _states(te, views):
    """(JAX, port) GameStates at `views` (x, y, angle): the port's
    new_game moved to JAX (tests/test_torch_camera.py holds the two
    new_games equal)."""
    ts = te.new_game(len(views),
                     pos=np.asarray([v[:2] for v in views], np.float32),
                     angle=np.asarray([v[2] for v in views], np.float32),
                     generator=torch.Generator().manual_seed(0))
    js = JaxState(**{f.name: jnp.asarray(getattr(ts, f.name).numpy())
                     for f in dataclasses.fields(JaxState)})
    return js, ts


def _args(st):
    return (st.pos[:, 0], st.pos[:, 1], st.angle, st.floor_height,
            st.sector_light, st.mobj_state, st.timestamp)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _paint_outputs(out) -> dict:
    """Every paint-stage output as numpy, by name (pools plane by plane)."""
    named = {k: _np(out[k]) for k in (
        "idx", "ld", "rgb", "cnt_mid", "cnt_clip", "overflow",
        "live_dropped")}
    for name in ("midpool", "clippool"):
        for i, p in enumerate(out[name]):
            named[f"{name}{i}"] = _np(p)
    return named


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, k)


# ---------------------------------------------------------------------------
# the tall screen: 64x264, B=4 on the demo
# ---------------------------------------------------------------------------

# a barrel 5 units ahead (seen from both sides: its sprite covers rows
# 255-263), the west wall 8 units ahead (a wall past row 254), and the
# candle in the nukage pit (a masked mid in the clip pool)
TALL_VIEWS = [(955.0, 256.0, 0.0), (963.5355, 259.5355, 3.927),
              (8.0, 256.0, 3.1416), (300.0, 700.0, 4.6)]
# pools just above the views' peaks (span 9, mid 1, clip 7, item 2)
TALL = RenderConfig(width=64, height=264, span_capacity=12, mid_capacity=4,
                    clip_capacity=8, item_capacity=4)
TALL_PAINT = dataclasses.replace(TALL, use_pallas_paint=True)


@pytest.fixture(scope="module")
def tall():
    wad = tsynth.demo_wad()
    te = DoomEngine.from_wad_bytes(wad, "e1m1", config=TALL, device="cpu")
    je = JaxEngine.from_wad_bytes(wad, "e1m1", config=_pair(TALL))
    js, ts = _states(te, TALL_VIEWS)
    return je, te, js, ts


def _jax_render(je, js):
    """The JAX engine's render and render_counters of a batch of at most 8
    cameras (no camera sort): render_frame on its CPU path (XLA scan +
    resolve), jitted once for both."""
    cfg = je.config

    def run(level, st):
        idx, rgb, aux = jframe.render_frame(level, cfg, *_args(st))
        zero = jnp.zeros((), jnp.int32)
        return idx, rgb, {k: aux.get(k, zero).sum() for k in COUNTERS}

    idx, rgb, count = jax.jit(run)(je.level, js)
    return {"idx": np.asarray(idx), "rgb": np.asarray(rgb),
            "counters": {k: int(v) for k, v in count.items()}}


@pytest.fixture(scope="module")
def jax_tall_scan(tall):
    """JAX under the default config: the scan + resolve pipeline."""
    je, _, js, _ = tall
    return _jax_render(je, js)


@pytest.fixture(scope="module")
def jax_tall_paint(tall):
    """JAX's paint path (render_frame's paint branch, frame.py:63-118 and
    245-259) in interpret mode: render_paint, then the deferred pass
    with the item kernel composite_items."""
    from doomtpu.ops.pallas_paint import LD_SKY, render_paint

    je, _, js, _ = tall
    cfg = _pair(TALL_PAINT)
    level = je.level
    px, py, pa, fh, sl, ms, tsm = _args(js)
    frame = jcam.build_seg_frame(level, cfg, px, py, pa, fh, sl, tsm)
    order = jcam.seg_order(level, jcam.traversal_rank(level, px, py))
    out = render_paint(level, cfg, frame, order, pa, px, py, fh,
                       interpret=True, unroll=1, gsub=2)
    ld = out["ld"]
    light, dist = (ld >> 16) & 0xFF, ((ld & 0xFFFF) << 16) >> 16
    is_sky = (ld & LD_SKY) != 0
    assert level.items_ok
    idx, light, dist, is_sky, daux = jthings.deferred_pass(
        level, cfg, frame, jthings.pools_from_paint(out), order, px, py, pa,
        fh, sl, ms, out["idx"], light, dist, is_sky, rgb=out["rgb"],
        item_kernel=True, interpret=True)
    counters = {"overflow": int(out["overflow"].sum()),
                "live_dropped": int(out["live_dropped"]),
                "items_dropped": int(daux["items_dropped"].sum()),
                "item_overflow": int(daux["item_overflow"].sum())}
    return {"paint": _paint_outputs(out), "idx": np.asarray(idx),
            "light": np.asarray(light), "dist": np.asarray(dist),
            "is_sky": np.asarray(is_sky), "rgb": np.asarray(daux["rgb"]),
            "counters": counters}


def test_pipeline_choice_agrees_with_jax(tall, monkeypatch):
    """frame.paint_available against JAX's, whose backend test is made to
    see an accelerator: the use_pallas_paint switch, the batch, the
    height, the seg budget and its live-cap escape, and a level the
    paint kernel does not take."""
    import warnings

    je, te, *_ = tall
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # GRATE on solid walls
        wad = tsynth.e1m1_scale_masked_wad()
        masked = (DoomEngine.from_wad_bytes(wad, "e1m1", device="cpu").level,
                  JaxEngine.from_wad_bytes(wad, "e1m1").level)
    demo = (te.level, je.level)
    few = dataclasses.replace(TALL_PAINT, paint_max_segs=8)
    cases = [
        ("default config", demo, TALL, 4, False),
        ("use_pallas_paint", demo, TALL_PAINT, 4, True),
        ("B=6", demo, TALL_PAINT, 6, False),
        ("B=8", demo, TALL_PAINT, 8, True),
        ("height 260", demo, dataclasses.replace(TALL_PAINT, height=260), 4,
         False),
        ("1152 wide", demo, dataclasses.replace(TALL_PAINT, width=1152), 4,
         True),
        ("segs over paint_max_segs", demo, few, 4, False),
        ("... with a live cap", demo,
         dataclasses.replace(few, paint_live_capacity=64), 4, True),
        ("masked level", masked, TALL_PAINT, 4, False),
    ]
    for name, (tl, jl), cfg, B, want in cases:
        assert jframe.paint_available(jl, _pair(cfg), B) == want, name
        assert tframe.paint_available(tl, cfg, B) == want, name


def test_default_config_takes_scan_in_both(tall, jax_tall_scan,
                                           jax_tall_paint):
    _, te, _, ts = tall
    idx, rgb, aux = tframe.render_frame(te.level, TALL, *_args(ts))
    assert "pool" in aux and "midpool" not in aux     # scan + resolve
    np.testing.assert_array_equal(idx.numpy(), jax_tall_scan["idx"])
    np.testing.assert_array_equal(rgb.numpy(), jax_tall_scan["rgb"])
    assert te.render_counters(ts) == jax_tall_scan["counters"]
    assert set(jax_tall_scan["counters"].values()) == {0}
    # the two pipelines differ, and only past row 254: the scan path's
    # spans carry 8-bit rows
    rows = np.nonzero(jax_tall_scan["idx"] != jax_tall_paint["idx"])[1]
    assert rows.size > 100 and rows.min() >= 255


def test_paint_config_takes_paint_in_both(tall, jax_tall_paint):
    _, te, _, ts = tall
    idx, rgb, aux = tframe.render_frame(te.level, TALL_PAINT, *_args(ts))
    assert "midpool" in aux and "pool" not in aux     # the paint path
    np.testing.assert_array_equal(idx.numpy(), jax_tall_paint["idx"])
    np.testing.assert_array_equal(rgb.numpy(), jax_tall_paint["rgb"])
    for k in ("light", "dist", "is_sky"):
        np.testing.assert_array_equal(aux[k].numpy(), jax_tall_paint[k], k)
    eng = dataclasses.replace(te, config=TALL_PAINT)
    counters = eng.render_counters(ts)
    for k, v in jax_tall_paint["counters"].items():
        assert counters[k] == v, k
    assert set(counters.values()) == {0}


def test_tall_paint_stage_equals_jax(tall, jax_tall_paint):
    """C3 (a): every output of the paint stage at 264 rows (frames, both
    pools, counts, overflow) against the JAX paint kernel, and the items
    drew past row 254 (the item composite's frames are held equal in
    test_paint_config_takes_paint_in_both)."""
    _, te, _, ts = tall
    px, py, pa, fh, sl, *_, tsm = _args(ts)
    frame = tcam.build_seg_frame(te.level, TALL_PAINT, px, py, pa, fh, sl,
                                 tsm)
    order = tcam.seg_order(te.level, tcam.traversal_rank(te.level, px, py))
    out = tp.render_paint(te.level, TALL_PAINT, frame, order, pa, px, py, fh)
    want = jax_tall_paint["paint"]
    _assert_equal(_paint_outputs(out), want)
    assert want["cnt_clip"].max() > 0 and want["cnt_mid"].max() > 0
    drawn = np.nonzero(jax_tall_paint["idx"] != want["idx"])[1]
    assert (drawn >= 255).sum() > 500
    assert (want["idx"][:, 255:] >= 0).sum() > 500    # walls past row 254


# ---------------------------------------------------------------------------
# the live-seg cap: e1m1-scale, 256x96, B=4
# ---------------------------------------------------------------------------

CAP = RenderConfig(width=256, height=96, mid_capacity=8, clip_capacity=24,
                   use_pallas_paint=True)
CAP_AT = 32          # below both fixtures' live peaks, a multiple of 32


def _spread(t, n, seed):
    rng = np.random.default_rng(seed)
    left, right, top, bottom = [float(v) for v in t.bbox]
    out = []
    while len(out) < n:
        x, y = rng.uniform(left, right), rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            out.append((x, y, rng.uniform(0, 2 * math.pi)))
    return out


@pytest.fixture(scope="module")
def capped():
    """Both engines on e1m1-scale, 4 spread poses, and the port's camera
    stage and traversal order of them."""
    wad = tsynth.e1m1_scale_wad()
    te = DoomEngine.from_wad_bytes(wad, "e1m1", config=CAP, device="cpu")
    je = JaxEngine.from_wad_bytes(wad, "e1m1", config=_pair(CAP))
    js, ts = _states(te, _spread(te.tables, 4, seed=0))
    px, py, pa, fh, sl, _, tsm = _args(ts)
    frame = tcam.build_seg_frame(te.level, CAP, px, py, pa, fh, sl, tsm)
    order = tcam.seg_order(te.level, tcam.traversal_rank(te.level, px, py))
    return je, te, js, ts, frame, order


def _port_paint(capped, cfg):
    _, te, _, ts, frame, order = capped
    px, py, pa, fh, *_ = _args(ts)
    return tp.render_paint(te.level, cfg, frame, order, pa, px, py, fh)


def _live_peaks(capped) -> tuple[int, int]:
    """(per-camera, per-tile) peak live count of a 128-column block."""
    _, te, _, ts, frame, order = capped
    rows, scnt = tp.build_rows(te.level, frame, order)
    G = rows.shape[1]
    x0, x1 = rows[..., tp.R_X0], rows[..., tp.R_X1]
    act = torch.arange(G)[None] < scnt[:, None]
    wlo = torch.arange(-(-CAP.width // 128)) * 128
    live = (act[..., None] & (x0[..., None] < wlo + 128)
            & (x1[..., None] >= wlo))
    # per tile: by traversal position (the rows of a camera are its
    # active segs in traversal order; inactive rows are never live)
    at = torch.gather(torch.argsort(order.long(), 1), 1,
                      rows[..., tp.R_G].long())
    live_p = torch.zeros_like(live).scatter_(
        1, at[..., None].expand_as(live), live)
    return int(live.sum(1).max()), int(live_p.any(0).sum(0).max())


@pytest.mark.parametrize("percam", [True, False], ids=["percam", "union"])
def test_live_cap_drops_as_jax(capped, percam):
    """C2: at a cap below the peak the port drops the segs JAX drops:
    live_dropped and every paint output equal."""
    from doomtpu.ops.pallas_paint import render_paint

    je, te, js, ts, *_ = capped
    cfg = dataclasses.replace(CAP, paint_live_capacity=CAP_AT,
                              paint_percam_compact=percam)
    assert CAP_AT < _live_peaks(capped)[0 if percam else 1]
    level = je.level
    jcfg = _pair(cfg)
    px, py, pa, fh, sl, _, tsm = _args(js)
    jf = jcam.build_seg_frame(level, jcfg, px, py, pa, fh, sl, tsm)
    jo = jcam.seg_order(level, jcam.traversal_rank(level, px, py))
    want = _paint_outputs(render_paint(level, jcfg, jf, jo, pa, px, py, fh,
                                       interpret=True, unroll=1, gsub=2))
    assert want["live_dropped"] > 0
    got = _paint_outputs(_port_paint(capped, cfg))
    _assert_equal(got, want)
    # the drop changed the frame (it is not a no-op)
    uncapped = _paint_outputs(_port_paint(capped, CAP))
    assert (uncapped["idx"] != got["idx"]).sum() > 0


@pytest.mark.parametrize("percam", [True, False], ids=["percam", "union"])
def test_live_cap_at_peak_keeps_every_seg(capped, percam):
    """C2: a cap at or above the live peak drops nothing, and every
    output is the uncapped one."""
    _, te, _, ts, *_ = capped
    peak = _live_peaks(capped)[0 if percam else 1]
    want = _paint_outputs(_port_paint(capped, CAP))
    assert want["live_dropped"] == 0
    for cap in (peak, -(-peak // 32) * 32, 10 ** 4):
        cfg = dataclasses.replace(CAP, paint_live_capacity=cap,
                                  paint_percam_compact=percam)
        _assert_equal(_paint_outputs(_port_paint(capped, cfg)), want)
        eng = dataclasses.replace(te, config=cfg)
        assert eng.render_counters(ts)["live_dropped"] == 0
    # one below the rounded peak drops (the cap is not a no-op here)
    cfg = dataclasses.replace(CAP, paint_live_capacity=peak - 32,
                              paint_percam_compact=percam)
    assert int(_port_paint(capped, cfg)["live_dropped"]) > 0


# ---------------------------------------------------------------------------
# a masked mid 256 rows tall
# ---------------------------------------------------------------------------

TALL_MID_VIEWS = [(96.0, 256.0, 0.0), (300.0, 150.0, 0.3),
                  (900.0, 300.0, 3.1), (520.0, 256.0, 3.1416)]
MID_CFG = RenderConfig(width=160, height=120, span_capacity=24,
                       mid_capacity=8, clip_capacity=24, item_capacity=8)


def test_tall_mid_equals_jax():
    """C3 (b): a masked mid 256 rows tall, so the atlas holds 256 rows a
    column and the JAX package composites in XLA (items_ok is False):
    the port's render and counters against the JAX engine's."""
    wad = tall_mid_wad(tsynth, tbuilder)
    assert wad == tall_mid_wad(jsynth, jbuilder)
    te = DoomEngine.from_wad_bytes(wad, "e1m1", config=MID_CFG, device="cpu")
    je = JaxEngine.from_wad_bytes(wad, "e1m1", config=_pair(MID_CFG))
    assert te.level.atlas_rows == 256 and not je.level.items_ok
    # the texture table's 256 rows pad the 128-row sky's opacity mask, so
    # the level leaves the paint path in both packages
    assert not te.level.paint_ok and not je.level.paint_ok
    js, ts = _states(te, TALL_MID_VIEWS)
    want = _jax_render(je, js)
    idx, rgb = te.render(ts)
    np.testing.assert_array_equal(idx.numpy(), want["idx"])
    np.testing.assert_array_equal(rgb.numpy(), want["rgb"])
    assert te.render_counters(ts) == want["counters"]
    assert set(want["counters"].values()) == {0}
    # the mid draws, and from its rows 128-255: other texels there change
    # the frame
    walls_idx, _ = te.render_walls(ts)
    assert int((walls_idx != idx).sum()) > 1000
    other = DoomEngine.from_wad_bytes(tall_mid_wad(tsynth, tbuilder, 4),
                                      "e1m1", config=MID_CFG, device="cpu")
    assert int((other.render(ts)[0] != idx).sum()) > 100


@pytest.mark.parametrize("percam", [True, False], ids=["percam", "union"])
def test_live_drop_matches_a_direct_count(percam):
    """live_drop on random rows at 4096 columns (32 blocks, so the drop
    word's sign bit is in use), B=8, against the lists counted one seg
    at a time in traversal order, as pallas_paint.py:1605-1745 defines
    them."""
    rng = np.random.default_rng(5)
    B, G, W, cap = 8, 96, 4096, 32
    cfg = RenderConfig(width=W, paint_live_capacity=cap,
                       paint_percam_compact=percam)
    order = np.stack([rng.permutation(G) for _ in range(B)]).astype(np.int32)
    scnt = rng.integers(G // 2, G + 1, B).astype(np.int32)
    x0 = rng.integers(-64, W, (B, G))
    x1 = x0 + rng.integers(0, 4096, (B, G))
    rows = np.zeros((B, G, tp.NR), np.int32)
    rows[..., tp.R_X0], rows[..., tp.R_X1] = x0, x1
    # row k of camera b: the seg at traversal position k (a camera's
    # rows are its segs in traversal order)
    rows[..., tp.R_G] = order
    drop, dropped = tp.live_drop(cfg, torch.from_numpy(rows),
                                 torch.from_numpy(scnt),
                                 torch.from_numpy(order))
    assert tp.live_capacity(cfg, G) == cap
    want = np.zeros((B, G), np.int64)
    want_dropped = 0
    tb = 8
    for w in range(W // 128):
        lo, hi = w * 128, w * 128 + 127
        live = (np.arange(G)[None] < scnt[:, None]) & (x0 <= hi) & (x1 >= lo)
        groups = [[b] for b in range(B)] if percam else [list(range(tb))]
        for cams in groups:
            kept = 0
            for k in range(G):                 # traversal position k
                if not live[cams, k].any():
                    continue
                kept += 1
                if kept > cap:
                    want[cams, k] |= live[cams, k].astype(np.int64) << w
            want_dropped += max(sum(int(live[b].sum()) for b in cams) - cap
                                if percam else kept - cap, 0)
    want = np.where(want >= 2 ** 31, want - 2 ** 32, want).astype(np.int32)
    np.testing.assert_array_equal(drop.numpy(), want)
    assert int(dropped) == want_dropped > 0
    assert (drop.numpy() < 0).any()            # block 31 drops segs
