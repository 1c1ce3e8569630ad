"""Tests that need a CUDA card: the seg-row, live-drop, paint, item,
item-pass, emission, wall-scan and resolve kernels against their plain
PyTorch versions (on tall and wide screens too, the seg rows on
doom1-asset-scale and with a camera that sees no seg, the live drop and
the paint kernel under a live-seg cap that drops segs, the
resolve under a sky with transparent texels and on hand-made pools), the
Hopper probes P1-P4 against theirs (every construct at both launch
shapes, small N and S), and the engine on the card: render /
render_walls against the same calls on the CPU, on the paint path
(`use_pallas_paint=True`), on the scan + resolve pipeline and on a
256-row atlas, each pipeline's kernel launches, moving and reuse
rollouts, calibration, the split over [cuda:0, cuda:0], the shell and
the census of synchronizing calls (one host round trip a tick, a render
and a rollout).

This file imports no JAX, so it also runs where there is a card and no
JAX; the repo's conftest imports JAX, so leave it out there:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test skips.  Tolerance: exact equality on every
output (for the pools of the paint kernel and the wall scan: every slot
below a column's count; the kernels do not write the slots past it,
which nothing reads, tests/test_torch_pools.py).
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_fixtures import (  # noqa: E402
    launches, moving_controls, moving_rollout, sky_masked, spread_poses,
    sync_census, tall_atlas, tall_mid_wad,
)
from doomtpu_torch.wad import builder, synth  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.config import RenderConfig  # noqa: E402
from doomtpu_torch.ops import emit as kem  # noqa: E402
from doomtpu_torch.ops import itempass as tip  # noqa: E402
from doomtpu_torch.ops import items as ti  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.ops import probe_visit as pv  # noqa: E402
from doomtpu_torch.ops import probe_ybounds as pyb  # noqa: E402
from doomtpu_torch.ops import resolve as kres  # noqa: E402
from doomtpu_torch.ops import scan as ts  # noqa: E402
from doomtpu_torch.ops.layout import LD_SKY  # noqa: E402
from doomtpu_torch.render import camera as cam  # noqa: E402
from doomtpu_torch.render import resolve as res  # noqa: E402
from doomtpu_torch.render import things, walls  # noqa: E402

pytestmark = pytest.mark.cuda

# the demo views of tests/test_paint.py
VIEWS = [
    (384.0, 256.0, 0.0),
    (900.0, 256.0, 2.5),
    (300.0, 700.0, 4.6),
    (384.0, 256.0, 3.1),
]
# the kernel launches of one call, by kernel, none but those named
NO_LAUNCH = {"paint": 0, "items": 0, "scan": 0, "itempass": 0,
             "resolve": 0, "emit": 0, "rows": 0, "live_drop": 0}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def engines(cuda):
    wad = synth.demo_wad()
    cfg = RenderConfig(use_pallas_paint=True)
    return (DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=cuda),
            DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device="cpu"))


def _state(eng, pos, ang):
    return eng.new_game(len(ang), pos=pos, angle=ang,
                        generator=torch.Generator(eng.device).manual_seed(0))


def _demo_state(eng):
    """The demo views, twice: B=8."""
    views = VIEWS * 2
    return _state(eng, np.asarray([v[:2] for v in views], np.float32),
                  np.asarray([v[2] for v in views], np.float32))


def _frame_order(eng, cfg, st):
    """The camera stage's seg frame and the traversal order of `st`."""
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(eng.level, cfg, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.timestamp)
    return frame, cam.seg_order(eng.level, cam.traversal_rank(eng.level,
                                                              px, py))


def _pack(eng, cfg, st, frame, order):
    return things.item_pack(eng.level, cfg, frame, order, st.pos[:, 0],
                            st.pos[:, 1], st.angle, st.floor_height,
                            st.sector_light, st.mobj_state)[0]


def _outputs(out) -> dict:
    named = {k: out[k] for k in (
        "idx", "ld", "rgb", "cnt_mid", "cnt_clip", "overflow")}
    for name in ("midpool", "clippool"):
        for i, p in enumerate(out[name]):
            named[f"{name}{i}"] = p
    return named


def _below_count(out) -> dict:
    """_outputs with every pool slot at or past its column's count
    zeroed (the paint kernel does not write those)."""
    named = _outputs(out)
    for pool, cnt in (("midpool", "cnt_mid"), ("clippool", "cnt_clip")):
        K = out[pool][0].shape[2]
        past = (torch.arange(K, device=out[cnt].device)
                >= out[cnt][..., None])
        for i in range(len(out[pool])):
            named[f"{pool}{i}"] = torch.where(past, 0, named[f"{pool}{i}"])
    return named


def _demo_paint(eng, cfg):
    """Paint inputs of the demo views at B=8."""
    st = _demo_state(eng)
    frame, order = _frame_order(eng, cfg, st)
    args = tp.build_inputs(eng.level, cfg, frame, order, st.angle,
                           st.pos[:, 0], st.pos[:, 1], st.floor_height)
    return st, frame, order, args


def test_paint_kernel_equals_plain_version(engines):
    eng, _ = engines
    _, _, _, args = _demo_paint(eng, eng.config)
    before = tp.paint.launches
    got = _below_count(tp.paint(eng.level, eng.config, *args))
    torch.cuda.synchronize()
    assert tp.paint.launches == before + 1
    want = _below_count(tp.paint_reference(eng.level, eng.config, *args))
    for k, v in got.items():
        assert v.is_cuda, k
        assert torch.equal(v, want[k]), k


SCREENS = [(320, 768), (1024, 200)]


@pytest.fixture(scope="module", params=SCREENS, ids=lambda s: "%dx%d" % s)
def screen(cuda, request):
    """The demo map on a tall screen and on the widest the paint path
    takes, its views at B=8 painted by the kernel."""
    w, h = request.param
    cfg = RenderConfig(width=w, height=h, item_capacity=24)
    eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=cfg,
                                    device=cuda)
    st, frame, order, args = _demo_paint(eng, cfg)
    return eng, cfg, st, frame, order, args


def test_paint_kernel_on_tall_and_wide_screens(screen):
    eng, cfg, *_, args = screen
    got = _below_count(tp.paint(eng.level, cfg, *args))
    want = _below_count(tp.paint_reference(eng.level, cfg, *args))
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    assert int(want["cnt_clip"].max()) > 0


def test_scan_kernel_on_tall_and_wide_screens(screen):
    eng, cfg, st, frame, order, _ = screen
    cfg = dataclasses.replace(cfg, span_capacity=32)
    rows, scnt = tp.build_rows(eng.level, frame, order)
    got = ts.scan(eng.level, cfg, rows, scnt)
    want = ts.scan_reference(eng.level, cfg, rows, scnt)
    _assert_scan_equal(got, want, cfg.span_capacity)
    assert int(want["cnt"].max()) > 0


def _assert_item_pass_equal(eng, cfg, pack, out):
    """K3 against its plain version over the paint result `out`, each on
    its own copy of the frame; some item drew."""
    fresh = lambda: dict(out, **{k: out[k].clone()
                                 for k in ("idx", "ld", "rgb")})
    before = tip.item_pass.launches
    got = tip.item_pass(eng.level, cfg, pack, fresh())
    torch.cuda.synchronize()
    assert tip.item_pass.launches == before + 1
    want = tip.item_pass_reference(eng.level, cfg, pack, fresh())
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    return int((got[0] != out["idx"]).sum())


def test_itempass_kernel_on_tall_and_wide_screens(screen):
    eng, cfg, st, frame, order, args = screen
    out = tp.paint(eng.level, cfg, *args)
    pack = _pack(eng, cfg, st, frame, order)
    assert _assert_item_pass_equal(eng, cfg, pack, out) > 0   # some drew


@pytest.mark.parametrize("percam", [True, False], ids=["percam", "union"])
def test_paint_kernel_under_a_dropping_cap(cuda, percam):
    """e1m1-scale, B=32 spread poses, paint_live_capacity 32: the paint
    kernel skips the segs the drop mask names as its plain version
    does."""
    cfg = RenderConfig(mid_capacity=40, clip_capacity=64,
                       paint_live_capacity=32, paint_percam_compact=percam)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=cuda)
    st = _state(eng, *spread_poses(eng.tables, 32))
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame, order = _frame_order(eng, cfg, st)
    args = tp.build_inputs(eng.level, cfg, frame, order, st.angle, px, py,
                           st.floor_height)
    drop, dropped = tp.live_drop(cfg, args[0], args[1], order)
    assert int(dropped) > 0
    got = _below_count(tp.paint(eng.level, cfg, *args, drop))
    want = _below_count(tp.paint_reference(eng.level, cfg, *args, drop))
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    uncapped = tp.paint(eng.level, cfg, *args)
    assert not torch.equal(got["idx"], uncapped["idx"])


def _assert_rows_equal(level, frame, order, cfg=None):
    """The rows kernel against build_rows_reference: every row of every
    camera (the inactive ones past scnt too) and scnt; under `cfg`, the
    live drop against live_drop_reference: drop and live_dropped (the
    drop kernel launches under a cap, per camera or per tile).
    Returns (scnt, live_dropped)."""
    before = tp.build_rows.launches
    rows, scnt = tp.build_rows(level, frame, order)
    torch.cuda.synchronize()
    assert tp.build_rows.launches == before + 1
    want_rows, want_scnt = tp.build_rows_reference(level, frame, order)
    assert rows.is_cuda and scnt.is_cuda
    assert torch.equal(rows, want_rows)
    assert torch.equal(scnt, want_scnt)
    if cfg is None:
        return scnt, None
    kernel = tp.live_capacity(cfg, order.shape[1]) is not None
    before = tp.live_drop.launches
    drop, dropped = tp.live_drop(cfg, rows, scnt, order)
    torch.cuda.synchronize()
    assert tp.live_drop.launches == before + int(kernel)
    want_drop, want_dropped = tp.live_drop_reference(cfg, rows, scnt, order)
    assert torch.equal(drop, want_drop)
    assert int(dropped) == int(want_dropped)
    return scnt, int(dropped)


@pytest.mark.parametrize("percam", [True, False], ids=["percam", "union"])
def test_rows_kernel_on_tall_and_wide_screens(screen, percam):
    """The demo map at B=8 on a tall screen and on a 1024-column one
    (8 live-list blocks), under a cap of 32 per camera and per tile."""
    eng, cfg, st, frame, order, _ = screen
    cfg = dataclasses.replace(cfg, paint_live_capacity=32,
                              paint_percam_compact=percam)
    assert tp.live_capacity(cfg, order.shape[1]) is not None
    scnt, _ = _assert_rows_equal(eng.level, frame, order, cfg)
    assert int(scnt.min()) > 0


@pytest.mark.parametrize("percam,n", [(True, 32), (False, 32), (False, 12)],
                         ids=["percam", "union", "union4"])
def test_rows_kernels_under_a_dropping_cap(cuda, percam, n):
    """e1m1-scale, n spread poses, paint_live_capacity 32: the rows and
    the drop bits equal their plain versions' per camera and per tile
    (8-camera tiles at B=32, 4-camera ones at B=12), and the cap drops
    segs."""
    cfg = RenderConfig(paint_live_capacity=32, paint_percam_compact=percam)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=cuda)
    st = _state(eng, *spread_poses(eng.tables, n))
    frame, order = _frame_order(eng, cfg, st)
    _, dropped = _assert_rows_equal(eng.level, frame, order, cfg)
    assert dropped > 0


def test_rows_kernel_with_a_camera_that_sees_no_seg(cuda):
    """e1m1-scale, B=8 spread poses, camera 2's segs all made inactive:
    its scnt is 0, its rows are every seg in traversal order, and it
    drops nothing under a per-camera cap."""
    cfg = RenderConfig(paint_live_capacity=32, paint_percam_compact=True)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=cuda)
    st = _state(eng, *spread_poses(eng.tables, 8, seed=1))
    frame, order = _frame_order(eng, cfg, st)
    frame = dict(frame, active=frame["active"].clone())
    frame["active"][2] = False
    scnt, _ = _assert_rows_equal(eng.level, frame, order, cfg)
    assert int(scnt[2]) == 0 and int(scnt.max()) > 0


def test_rows_kernel_on_doom1_asset_scale(cuda):
    """The doom1-asset-scale level (its own seg count), B=16 spread
    poses, per-camera lists under a cap of 32."""
    cfg = RenderConfig(paint_live_capacity=32, paint_percam_compact=True)
    eng = DoomEngine.from_wad_bytes(synth.doom1_scale_wad(), "e1m1",
                                    config=cfg, device=cuda)
    assert eng.level.num_segs != 736
    st = _state(eng, *spread_poses(eng.tables, 16))
    frame, order = _frame_order(eng, cfg, st)
    _assert_rows_equal(eng.level, frame, order, cfg)


def _assert_items_equal(level, cfg, ipool, icnt, out, clip, drawn=0):
    """K2 against its plain version over the paint result `out`, each on
    its own copy of the frame; more than `drawn` pixels changed."""
    bg = lambda: [out[k].clone() for k in ("idx", "ld", "rgb")]
    before = ti.composite_items.launches
    got = ti.composite_items(level, cfg, ipool, icnt, *bg(), clip=clip)
    torch.cuda.synchronize()
    assert ti.composite_items.launches == before + 1
    want = ti.composite_items_reference(level, cfg, ipool, icnt, *bg(),
                                        clip=clip)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert int((got[0] != out["idx"]).sum()) > drawn     # some item drew


def _item_variant(level, cfg, ipool, clip, case):
    """(level, ipool, clip) of K2's case: with the clip pool ("clip"),
    without one (the words clipped beforehand, as the JAX _kernel_kouter
    takes them) or on an atlas of 256 rows a column."""
    if case == "clip=None":
        ipool = ipool.clone()
        ipool[0] = ti.clipped_words(ipool, clip, cfg.height)
        clip = None
    elif case == "atlas_rows=256":
        level, ipool = tall_atlas(level, ipool)
    return level, ipool, clip


@pytest.mark.parametrize("case", ["clip", "clip=None", "atlas_rows=256"])
def test_item_kernel_on_tall_and_wide_screens(screen, case):
    """K2 with the clip pool, without one and on an atlas of 256 rows a
    column."""
    eng, cfg, st, frame, order, args = screen
    out = tp.paint(eng.level, cfg, *args)
    pools = things.pools_from_paint(out)
    ipool, icnt, _ = things.item_pool(
        eng.level, cfg, frame, pools, order, st.pos[:, 0], st.pos[:, 1],
        st.angle, st.floor_height, st.sector_light, st.mobj_state)
    level, ipool, clip = _item_variant(eng.level, cfg, ipool, pools[0], case)
    _assert_items_equal(level, cfg, ipool, icnt, out, clip)


@pytest.mark.parametrize("ki", ["8", "24", "24-clip=None",
                                "24-atlas_rows=256"])
def test_item_kernel_equals_plain_version(engines, ki):
    """The deferred pass's item pool on 8 views of the demo map, through
    the kernel and through its plain version, clip pool included; at
    item capacity 24 also without the clip pool and on a 256-row
    atlas."""
    eng, _ = engines
    ki, case = (ki.split("-") + ["clip"])[:2]
    cfg = RenderConfig(item_capacity=int(ki))
    st = _demo_state(eng)
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame, order = _frame_order(eng, cfg, st)
    out = tp.render_paint(eng.level, cfg, frame, order, st.angle, px, py,
                          st.floor_height)
    pools = things.pools_from_paint(out)
    ipool, icnt, _ = things.item_pool(
        eng.level, cfg, frame, pools, order, px, py, st.angle,
        st.floor_height, st.sector_light, st.mobj_state)
    level, ipool, clip = _item_variant(eng.level, cfg, ipool, pools[0], case)
    _assert_items_equal(level, cfg, ipool, icnt, out, clip, drawn=100)


@pytest.mark.parametrize("wad", ["demo", "doom1-scale"])
def test_itempass_kernel_equals_plain_version(engines, wad):
    """Every selected item through the item-pass kernel and through its
    plain version: 8 views of the demo map, and 16 spread views of
    doom1-asset-scale (textures wider than 128 texels, ~48 flats, 256
    visible map objects)."""
    if wad == "demo":
        eng, cfg = engines[0], RenderConfig(use_item_pass_kernel=True)
        st = _demo_state(eng)
    else:
        cfg = RenderConfig(mid_capacity=40, clip_capacity=64,
                           max_visible_mobjs=256, use_item_pass_kernel=True)
        eng = DoomEngine.from_wad_bytes(synth.doom1_scale_wad(), "e1m1",
                                        config=cfg, device=engines[0].device)
        assert eng.level.itempaint_ok and eng.level.texq_wide
        st = _state(eng, *spread_poses(eng.tables, 16))
    frame, order = _frame_order(eng, cfg, st)
    out = tp.render_paint(eng.level, cfg, frame, order, st.angle,
                          st.pos[:, 0], st.pos[:, 1], st.floor_height)
    pack = _pack(eng, cfg, st, frame, order)
    assert _assert_item_pass_equal(eng, cfg, pack, out) > 100


EMIT_CASES = ["demo-KI1", "demo-KI8", "demo-KI24", "demo-320x768",
              "demo-1024x200", "e1m1-paint", "e1m1-paint-bwk", "e1m1-scan",
              "e1m1-paint-t64", "e1m1-paint-notable"]


@pytest.mark.parametrize("case", EMIT_CASES)
def test_emit_kernel_equals_plain_version(cuda, case, monkeypatch):
    """The deferred pass's emission (ops/emit.py) through the kernel and
    through its plain version, every plane of the pool, icnt,
    item_overflow and item_peak: the demo map at B=8 on the paint
    path's mid pool at item capacity 1 (overflowing), 8 and 24, and at
    24 on a tall and a wide screen; e1m1-scale at B=32 on the paint
    path's mid pool, on the same pool laid out as the JAX package's
    [B, W, K] store and read through its strides ("-bwk"), on the scan
    path's unified pool, and in blocks that emit_block picks only
    elsewhere: 64 threads (the columns in five passes) and no seg ->
    item table (each seg looked up by a walk of the pack, the fallback
    for levels whose table does not fit)."""
    block = {"t64": (64, True), "notable": (320, False)}.get(
        case.rsplit("-", 1)[1])
    if block is not None:
        monkeypatch.setattr(kem, "emit_block", lambda *a: block)
    if case.startswith("demo"):
        spec = case.split("-")[1]
        if "x" in spec:
            w, h = map(int, spec.split("x"))
            cfg = RenderConfig(width=w, height=h, item_capacity=24,
                               use_pallas_paint=True)
        else:
            cfg = RenderConfig(item_capacity=int(spec[2:]),
                               use_pallas_paint=True)
        eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=cfg,
                                        device=cuda)
        st = _demo_state(eng)
    else:
        cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                           clip_capacity=64, item_capacity=24,
                           span_capacity=96, use_pallas_paint=True)
        eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device=cuda)
        st = _state(eng, *spread_poses(eng.tables, 32))
    lvl = eng.level
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame, order = _frame_order(eng, cfg, st)
    if case.endswith("scan"):
        pool, cnt, _ = walls.wall_scan(lvl, cfg, frame, order)
        mid = things.pools_from_unified(pool, cnt, frame)[1]
    else:
        out = tp.render_paint(lvl, cfg, frame, order, st.angle, px, py,
                              st.floor_height)
        mid = things.pools_from_paint(out)[1]
    if case.endswith("bwk"):
        bwk = lambda p: p.transpose(1, 2).contiguous().transpose(1, 2)
        mid = {k: v if k == "cnt" else bwk(v) for k, v in mid.items()}
        assert not mid["span"].is_contiguous()
    pack = _pack(eng, cfg, st, frame, order)
    before = kem.emit.launches
    got = kem.emit(lvl, cfg, pack, mid)
    torch.cuda.synchronize()
    assert kem.emit.launches == before + 1
    want = kem.emit_reference(lvl, cfg, pack, mid)
    names = [f"plane{i}" for i in range(ti.ITEM_PLANES)]
    for name, g, w in zip(names + ["icnt", "item_overflow", "item_peak"],
                          [*got[0], *got[1:]], [*want[0], *want[1:]]):
        assert g.is_cuda and g.dtype == w.dtype, name
        assert torch.equal(g, w), (name, int((g != w).sum()))
    ipool, icnt, overflow, peak = got
    assert int(icnt.max()) > 0
    assert bool(((ipool[0] & ti.SPR_MARK) != 0).any())      # sprite slots
    assert bool(((ipool[0] != 0) & ((ipool[0] & ti.SPR_MARK) == 0)).any()) \
        or case.startswith("demo")                          # mid slots
    assert (int(overflow.sum()) > 0) == (int(peak.max()) > cfg.item_capacity)
    if case == "demo-KI1":
        assert int(overflow.sum()) > 0


def test_emit_launches_once_a_deferred_pass(engines):
    """A render's kernel launches on each pipeline: on the paint path
    the rows, K1, the emission kernel and K2 once each; on the scan path
    (forced) the rows, K4, the resolve, the emission kernel and K2; with
    the item pass the rows, K1 and K3, no emission and no K2.  No live
    drop: no cap."""
    eng, _ = engines
    for cfg, want in (
            (eng.config, {"rows": 1, "paint": 1, "emit": 1, "items": 1}),
            (dataclasses.replace(eng.config, use_pallas_paint=False),
             {"rows": 1, "scan": 1, "resolve": 1, "emit": 1, "items": 1}),
            (dataclasses.replace(eng.config, use_item_pass_kernel=True),
             {"rows": 1, "paint": 1, "itempass": 1})):
        e = dataclasses.replace(eng, config=cfg)
        st = _demo_state(e)
        got, _ = launches(lambda: e.render(st))
        assert got == dict(NO_LAUNCH, **want), cfg


def test_render_walls_on_card_equals_cpu(engines):
    """B=16 spread poses, so the camera sort runs."""
    gpu, cpu = engines
    pos, ang = spread_poses(cpu.tables, 16)
    got, (idx, rgb) = launches(lambda: gpu.render_walls(_state(gpu, pos,
                                                                ang)))
    assert got == dict(NO_LAUNCH, rows=1, paint=1)
    assert idx.is_cuda and rgb.is_cuda
    idx_c, rgb_c = cpu.render_walls(_state(cpu, pos, ang))
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(rgb.cpu(), rgb_c)
    assert gpu.render_walls_counters(_state(gpu, pos, ang)) == {
        "overflow": 0, "live_dropped": 0}


def _wad(name):
    if name == "tall_mid_wad":    # a 256-row masked mid: the scan path
        return tall_mid_wad(synth, builder)
    return getattr(synth, name)()


@pytest.mark.parametrize("wad_fn", ["demo_wad", "e1m1_scale_wad",
                                    "doom1_scale_wad", "tall_mid_wad"])
def test_render_on_card_equals_cpu(cuda, wad_fn):
    """Full frames, B=16 spread poses (the camera sort runs), pools deep
    enough to drop nothing: the paint path on the demo map, e1m1-scale
    and doom1-asset-scale (textures wider than 128 texels, ~48 flats);
    the scan path on a WAD whose masked mid is 256 rows tall (its column
    atlas holds 256 rows, which the paint path does not take).  One
    launch of the rows, the walls kernel, the emission kernel and K2
    each."""
    cfg = RenderConfig(span_capacity=64, mid_capacity=40, clip_capacity=64,
                       item_capacity=24, use_pallas_paint=True)
    wad = _wad(wad_fn)
    gpu = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=cuda)
    cpu = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device="cpu")
    scan_path = wad_fn == "tall_mid_wad"
    assert gpu.level.atlas_rows == (256 if scan_path else 128)
    pos, ang = spread_poses(cpu.tables, 16)
    got, (idx, rgb) = launches(lambda: gpu.render(_state(gpu, pos, ang)))
    walls_kernels = {"scan": 1, "resolve": 1} if scan_path else {"paint": 1}
    assert got == dict(NO_LAUNCH, rows=1, emit=1, items=1, **walls_kernels)
    idx_c, rgb_c = cpu.render(_state(cpu, pos, ang))
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(rgb.cpu(), rgb_c)
    counters = gpu.render_counters(_state(gpu, pos, ang))
    assert set(counters.values()) == {0}, counters
    # some item drew
    assert bool((gpu.render_walls(_state(gpu, pos, ang))[0] != idx).any())


def _masked_engine(device, cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # GRATE on solid walls
        return DoomEngine.from_wad_bytes(synth.e1m1_scale_masked_wad(), "e1m1",
                                         config=cfg, device=device)


@pytest.mark.parametrize("case", ["demo-K16", "demo-K4", "masked-K64",
                                  "e1m1-K96"])
def test_scan_kernel_equals_plain_version(cuda, case):
    """Demo views at B=8 (K=4 overflows), e1m1-scale-masked at B=32 and
    the paint-eligible e1m1-scale at B=32 (the pipeline forced)."""
    K = int(case.split("K")[1])
    cfg = RenderConfig(width=320, height=200, span_capacity=K)
    if case.startswith("demo"):
        eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=cfg,
                                        device=cuda)
        st = _demo_state(eng)
    else:
        eng = (_masked_engine(cuda, cfg) if case.startswith("masked") else
               DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                         config=cfg, device=cuda))
        st = _state(eng, *spread_poses(eng.tables, 32))
    frame, order = _frame_order(eng, cfg, st)
    rows, scnt = tp.build_rows(eng.level, frame, order)
    before = ts.scan.launches
    got = ts.scan(eng.level, cfg, rows, scnt)
    torch.cuda.synchronize()
    assert ts.scan.launches == before + 1
    want = ts.scan_reference(eng.level, cfg, rows, scnt)
    _assert_scan_equal(got, want, K)
    assert (int(got["overflow"].sum()) > 0) == (K == 4)


def _assert_scan_equal(got, want, K):
    """cnt, overflow, and every pool plane below each column's count."""
    assert torch.equal(got["cnt"], want["cnt"])
    assert torch.equal(got["overflow"], want["overflow"])
    below = (torch.arange(K, device=got["cnt"].device)[None, :, None]
             < got["cnt"][:, None, :])
    for p in range(ts.POOL_PLANES):
        assert torch.equal(torch.where(below, got["pool"][p], 0),
                           torch.where(below, want["pool"][p], 0)), p


RESOLVE_CASES = ["e1m1-scale-B64", "e1m1-scale-masked", "sky-masked",
                 "640x255", "320x768", "1024x200", "hand-made"]


def _hand_made(pool, cnt):
    """A pool built by hand from a real one: columns with no record and
    columns full to K (their slots past the count filled with copies of
    their own records), texture-less walls (SPAN_NODRAW) and spans
    clipped above row 0 and below the screen's last row."""
    spans, planes = pool
    B, W, K = spans.shape
    store = torch.stack([p.transpose(1, 2) for p in [spans, *planes]])
    k = torch.arange(K, device=cnt.device)[None, :, None]
    src = (k % cnt[:, None, :].clamp(min=1)).expand(B, K, W)
    store = torch.gather(store, 2, src[None].expand_as(store))
    s = store[0]
    s = torch.where(((s >> 29) & 3 == 0) & (k % 3 == 1), s | ts.SPAN_NODRAW,
                    s)
    s = torch.where(k % 4 == 2, s & ~(255 << 8), s)      # y0 = -1
    s = torch.where(k % 4 == 3, s | 255, s)              # y1 = 254
    store[0] = s
    x = torch.arange(W, device=cnt.device)[None]
    cnt = torch.where((x % 5 == 1) & (cnt > 0), K, cnt)
    cnt = torch.where(x % 5 == 2, 0, cnt).to(torch.int32).contiguous()
    return (store[0].transpose(1, 2),
            [p.transpose(1, 2) for p in store[1:]]), cnt


@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_resolve_kernel_equals_plain_version(cuda, case):
    """The resolve kernel against resolve_reference on the wall scan's
    pool, bit for bit in idx, ld and rgb: e1m1-scale spread poses at
    B=64, the GRATE level of test_render_masked_on_card_equals_cpu,
    e1m1-scale's sky with transparent texels, a wide screen of 255 rows,
    a tall one of 768 (rows past 254 take no span), the widest of the
    paint path, and hand-made pools."""
    W, H, K = 320, 200, 96
    if case[0].isdigit():
        W, H = map(int, case.split("x"))
    cfg = RenderConfig(width=W, height=H, span_capacity=K)
    if case == "e1m1-scale-masked":
        eng = _masked_engine(cuda, cfg)
        st = _state(eng, *spread_poses(eng.tables, 32))
    elif case in ("e1m1-scale-B64", "sky-masked"):
        eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device=cuda)
        st = _state(eng, *spread_poses(eng.tables,
                                       64 if "B64" in case else 32))
    else:
        eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=cfg,
                                        device=cuda)
        st = _demo_state(eng)
    px, py = st.pos[:, 0], st.pos[:, 1]
    poses = (px, py, st.angle, st.floor_height)
    frame, order = _frame_order(eng, cfg, st)
    pool, cnt, ovf = walls.wall_scan(eng.level, cfg, frame, order)
    assert int(ovf.sum()) == 0
    level = eng.level
    if case == "sky-masked":
        level = sky_masked(level)
    elif case == "hand-made":
        pool, cnt = _hand_made(pool, cnt)
        assert bool((cnt == K).any()) and bool((cnt == 0).any())
    before = kres.resolve.launches
    got = res.resolve_frame(level, cfg, frame, pool, cnt, *poses)
    torch.cuda.synchronize()
    assert kres.resolve.launches == before + 1
    want = res.resolve_reference(level, cfg, frame, pool, cnt, *poses)
    for name, g, w in zip(("idx", "ld", "rgb"), got, want):
        assert g.is_cuda and g.dtype == torch.int32, name
        assert torch.equal(g, w), (name, int((g != w).sum()))
    idx, ld = got[:2]
    assert float((idx[:, :255] >= 0).float().mean()) > 0.3
    if case == "sky-masked":
        assert bool(((ld & LD_SKY) != 0).any())
        opaque = res.resolve_frame(eng.level, cfg, frame, pool, cnt, *poses)
        assert int((opaque[0] != idx).sum()) > 0
    if H > 255:
        assert bool((idx[:, 255:] == -1).all())


def test_render_masked_on_card_equals_cpu(cuda):
    """The scan + resolve pipeline end to end, B=8 spread poses: K4, the
    resolve, the emission kernel and K2 once each, no K1."""
    cfg = RenderConfig(span_capacity=64, mid_capacity=40, clip_capacity=64,
                       item_capacity=24, use_pallas_paint=True)
    gpu, cpu = _masked_engine(cuda, cfg), _masked_engine("cpu", cfg)
    assert not gpu.level.paint_ok
    pos, ang = spread_poses(cpu.tables, 8)
    got, (idx, rgb) = launches(lambda: gpu.render(_state(gpu, pos, ang)))
    assert got == dict(NO_LAUNCH, rows=1, scan=1, resolve=1, emit=1,
                       items=1)
    idx_c, rgb_c = cpu.render(_state(cpu, pos, ang))
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(rgb.cpu(), rgb_c)
    widx, wrgb = gpu.render_walls(_state(gpu, pos, ang))
    widx_c, wrgb_c = cpu.render_walls(_state(cpu, pos, ang))
    assert torch.equal(widx.cpu(), widx_c) and torch.equal(wrgb.cpu(), wrgb_c)
    counters = gpu.render_counters(_state(gpu, pos, ang))
    assert set(counters.values()) == {0}, counters


# the paint path of the rollouts: per-camera live lists under a cap
ROLLOUT_CFG = RenderConfig(width=320, height=200, mid_capacity=40,
                           clip_capacity=64, item_capacity=24,
                           use_pallas_paint=True, paint_percam_compact=True,
                           paint_live_capacity=256)


@pytest.mark.parametrize("pipeline", ["paint-reuse", "scan"])
def test_moving_rollout_on_card_equals_cpu(cuda, pipeline):
    """16 cameras, 4 ticks of moving controls on e1m1-scale at 320x200:
    a live-reuse rollout on the paint path (live_stale > 0, so the paint
    kernel reads drop bits set by the reuse) and a rollout on the scan +
    resolve path, the final state, the frames and live_stale equal to the
    CPU port's (torch_fixtures.moving_rollout)."""
    cfg = ROLLOUT_CFG
    reuse = pipeline == "paint-reuse"
    if not reuse:
        cfg = dataclasses.replace(cfg, use_pallas_paint=False,
                                  span_capacity=96)
    diffs, stale, stale_cpu, got = moving_rollout(cuda, cfg, reuse)
    assert set(diffs.values()) == {0}, diffs
    assert stale == stale_cpu
    # the live drop on the refresh tick only (the reuse's drop bits later)
    walls_kernels = ({"paint": 4, "live_drop": 1} if reuse
                     else {"scan": 4, "resolve": 4})
    assert got == dict(NO_LAUNCH, rows=4, items=4, emit=4, **walls_kernels)
    if reuse:
        assert stale > 16 * 3


def test_reuse_rollout_equals_fresh(cuda):
    """64 cameras, 8 ticks of zero controls on e1m1-scale, per-camera live
    lists under a cap set from the measured live peak (as JAX's
    calibrate rounds it): the live-reuse rollout's checksums equal the
    fresh rollout's, live_stale 0, the rows, K1, the emission kernel and
    K2 once a tick in both (the live drop once a tick fresh, on the
    refresh tick only with reuse), and every counter of the final state
    0."""
    n, T = 64, 8
    cfg = dataclasses.replace(ROLLOUT_CFG, paint_live_capacity=0)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=cuda)
    st = _state(eng, *spread_poses(eng.tables, n))
    frame, order = _frame_order(eng, cfg, st)
    rows, scnt = tp.build_rows(eng.level, frame, order)
    peak = int(tp.live_lists(cfg, rows, scnt, order)[2].max())
    cfg = dataclasses.replace(cfg, paint_live_capacity=-(-(peak + 1) // 32)
                              * 32)
    eng = dataclasses.replace(eng, config=cfg)
    controls = torch.zeros((T, n), dtype=torch.int32, device=cuda)
    draws = eng.light_draws(n, torch.Generator(cuda).manual_seed(0), ticks=T)
    sums = {}
    for reuse in (True, False):
        got, out = launches(lambda: eng.rollout(
            st, controls, draws=draws, return_frames=False,
            live_reuse=reuse))
        assert got == dict(NO_LAUNCH, rows=T, paint=T, emit=T, items=T,
                           live_drop=1 if reuse else T), reuse
        final, sums[reuse] = out[0], out[1]
        assert tuple(sums[reuse].shape) == (T, n) and int(final.tick[0]) == T
        if reuse:
            assert int(out[2]) == 0
        assert set(eng.render_counters(final).values()) == {0}
    assert torch.equal(sums[True], sums[False])


def test_split_on_card_equals_unsplit(cuda):
    """The batch split (doomtpu_torch/parallel): 64 cameras in two shards
    on [cuda, cuda:0], driven by a SplitEngine over an engine whose home
    is the CPU (each shard runs against the copy of the level on the
    card; `cuda` and `cuda:0` name one card, one copy), against the
    unsplit card engine: render, both counter calls (the per-shard
    sums) and a 4-tick live-reuse rollout of moving controls."""
    from doomtpu_torch.parallel import SplitEngine

    n, T = 64, 4
    wad = synth.e1m1_scale_wad()
    card = DoomEngine.from_wad_bytes(wad, "e1m1", config=ROLLOUT_CFG,
                                     device=cuda)
    home = DoomEngine.from_wad_bytes(wad, "e1m1", config=ROLLOUT_CFG,
                                     device="cpu")
    state = _state(card, *spread_poses(card.tables, n))
    split_engine = SplitEngine(home, ["cuda", "cuda:0"])
    split = split_engine.shard(state)
    assert [sh.device for sh in split.shards] == [state.device] * 2
    assert list(split_engine.engines) == [state.device]
    assert SplitEngine(card, ["cuda"]).engines[state.device] is card
    got, frames = launches(lambda: split_engine.render(split))
    assert got == dict(NO_LAUNCH, rows=2, live_drop=2, paint=2, emit=2,
                       items=2)
    assert frames[0].is_cuda
    for a, b in zip(frames, card.render(state)):
        assert torch.equal(a, b)
    for call in ("render_counters", "render_walls_counters"):
        c_split = getattr(split_engine, call)(split)
        per = [getattr(card, call)(sh) for sh in split.shards]
        assert c_split == {k: sum(p[k] for p in per) for k in c_split}
        assert c_split == getattr(card, call)(state)
    controls = moving_controls(T, n)
    draws = torch.randint(0, 1 << 30, (T, 2, n, card.level.num_sectors),
                          generator=torch.Generator().manual_seed(2),
                          dtype=torch.int32)
    got, (fs, frames_s, stale_s) = launches(lambda: split_engine.rollout(
        split, controls, draws=draws, live_reuse=True))
    assert got == dict(NO_LAUNCH, rows=2 * T, live_drop=2, paint=2 * T,
                       emit=2 * T, items=2 * T)
    fu, frames_u, stale_u = card.rollout(state, controls, draws=draws,
                                         live_reuse=True)
    assert torch.equal(frames_s, frames_u)
    assert int(stale_s) == int(stale_u)
    for f in dataclasses.fields(fu):
        assert torch.equal(getattr(fs.gather(), f.name),
                           getattr(fu, f.name)), f.name


def test_cli_on_card_equals_engine(cuda, tmp_path):
    """The shell on the card: `--synth demo --walk --steps 35 --out
    <tmp>.npy --device cuda`; its dump equals the card engine's frame
    after the same ticks (render, then tick, each step: the last frame
    follows 34 ticks)."""
    from doomtpu_torch.cli import main
    from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP

    out = tmp_path / "frame.npy"
    assert main(["--synth", "demo", "--walk", "--steps", "35", "--out",
                 str(out), "--device", "cuda"]) == 0
    dump = np.load(out)
    eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", device=cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    state = eng.new_game(1, generator=gen)
    walk = torch.full((1,), KEY_UP | KEY_LEFT, dtype=torch.int32)
    for _ in range(34):
        state = eng.tick(state, walk, gen)
    want = eng.render(state)[1].cpu().numpy()
    np.testing.assert_array_equal(dump, want)
    assert (want != 0).any()


@pytest.mark.parametrize("pipeline", ["paint", "scan", "itempass"])
def test_every_sync_is_in_a_sync_range(cuda, pipeline):
    """torch.cuda's sync debug mode over a tick, a render and a 2-tick
    rollout of moving controls of 64 cameras on e1m1-scale at 320x200,
    pools calibrated on the state, on each pipeline: every synchronizing
    call lies inside a doom.sync range, no range inside another, and
    the ranges number what the CPU tests hold the port to
    (tests/test_torch_trace.py: one a call).  The rollout's frames and
    final state equal the CPU port's."""
    from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP
    from test_torch_trace import SYNCS_RENDER, SYNCS_ROLLOUT, SYNCS_TICK

    cfg = RenderConfig(width=320, height=200,
                       use_pallas_paint=pipeline != "scan",
                       use_item_pass_kernel=pipeline == "itempass",
                       paint_percam_compact=True)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=cuda)
    st = _state(eng, *spread_poses(eng.tables, 64))
    ctl = torch.full((64,), KEY_UP | KEY_LEFT, dtype=torch.int32,
                     device=cuda)
    st1 = eng.tick(st, ctl)
    eng = eng.calibrate([st1])
    eng.render(st1)
    moves = moving_controls(2, 64)
    draws = torch.randint(0, 1 << 30, (2, 2, 64, eng.level.num_sectors),
                          generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32)
    moves_c, draws_c = moves.to(cuda), draws.to(cuda)
    for call, syncs in (
            (lambda: eng.tick(st, ctl), SYNCS_TICK),
            (lambda: eng.render(st1), SYNCS_RENDER[pipeline]),
            (lambda: eng.rollout(st, moves_c, draws=draws_c), SYNCS_ROLLOUT)):
        c = sync_census(call)
        assert c["inside"] and all(c["inside"]), (c["inside"], c["sites"])
        assert (c["syncs"], c["nested"]) == (syncs, 0), c
    final, frames = c["out"]
    cpu = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=eng.config, device="cpu")
    want_final, want = cpu.rollout(st.map(lambda x: x.cpu()), moves,
                                   draws=draws)
    assert (frames.cpu() != want).sum().item() == 0
    for f in dataclasses.fields(final):
        assert torch.equal(getattr(final, f.name).cpu(),
                           getattr(want_final, f.name)), f.name


def test_calibrate_on_card_equals_cpu(engines):
    """The census on a CUDA engine (its wall scan launches the rows and
    wall-scan kernels, no render kernel) returns the CPU port's config on demo,
    B=8, a 3-tick chain of walking cameras (draws from the CPU, so both
    chains are the same); under it every counter of every chain state is
    0 on the card, on the paint and on the scan path."""
    from doomtpu_torch.calibrate import calibrated_config
    from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP
    from doomtpu_torch.sim.thinkers import draw_lights

    card, cpu = engines
    st_cpu = _demo_state(cpu)
    st_card = st_cpu.map(lambda x: x.to(card.device))
    gen = torch.Generator().manual_seed(1)
    ctl = torch.full((8,), KEY_UP | KEY_LEFT, dtype=torch.int32)
    chain_cpu, chain_card = [st_cpu], [st_card]
    for _ in range(2):
        draws = draw_lights(gen, 8, cpu.level.num_sectors)
        chain_cpu.append(cpu.tick(chain_cpu[-1], ctl, draws=draws))
        chain_card.append(card.tick(chain_card[-1], ctl, draws=draws))
    n, got = launches(lambda: calibrated_config(card, chain_card,
                                                cache=False))
    assert n["scan"] >= 3                 # one per state's geometry census
    assert n == dict(NO_LAUNCH, scan=n["scan"], rows=n["scan"])
    assert got == calibrated_config(cpu, chain_cpu, cache=False)
    for paint in (True, False):
        e = dataclasses.replace(card, config=dataclasses.replace(
            got, use_pallas_paint=paint))
        for st in chain_card:
            assert set(e.render_counters(st).values()) == {0}, paint


@pytest.mark.parametrize("name", pv.CONSTRUCTS)
def test_probe_construct_equals_plain_version(cuda, name):
    """P1: each construct at N = 64, on its two launch shapes (one block,
    and K1's occupancy: for the tensor-core constructs one block of 256
    threads on every SM, a 32-lane group of 8 copies each, its selectors
    staged in shared memory), against its plain version on the card;
    mxu13diff and mxu13hi also with w's fragments read from shared
    memory, and on grids that are not 2 copies an SM."""
    x, t, arg = pv.device_inputs(cuda)[name]
    shapes = list(pv.configs(cuda, name).values())
    if name in pv.MMA:
        shapes += [(4, 128), (3, 256), (2, 64)]
    if name in pv.W_FROM_SMEM:
        shapes += [(*shapes[1], True), (4, 128, True)]
    for shape in shapes:
        copies = pv.copies_of(name, *shape[:2])
        want = pv.construct_reference(name, x, t, pv.CHECK_N, arg, copies)
        before = pv.construct.launches
        got = pv.construct(name, x, t, pv.CHECK_N, arg, *shape)
        torch.cuda.synchronize()
        assert pv.construct.launches == before + 1
        assert got.shape[0] == copies
        assert torch.equal(got, want), (name, shape)
    if name in pv.MMA:
        with pytest.raises(ValueError):   # blocks of at most 256 threads
            pv.construct(name, x, t, pv.CHECK_N, arg, 1, 512)
        with pytest.raises(ValueError):
            pv.construct(name, x, t, pv.CHECK_N, arg, 3, 256,
                         w_from_smem=True)


def test_probe_branchy_vote_group(cuda):
    """branchy_mxu's warp votes over its 32-lane group of all 8 rows, as
    its plain version does: on pv.vote_inputs one element's test takes
    the branch for lanes 32-63 alone, at both launch shapes."""
    x, t = (torch.from_numpy(v).to(cuda) for v in pv.vote_inputs(40))
    for blocks, threads in pv.configs(cuda, "branchy_mxu").values():
        got = pv.construct("branchy_mxu", x, t, 1, 0, blocks, threads)
        want = pv.construct_reference("branchy_mxu", x, t, 1, 0,
                                      got.shape[0])
        assert torch.equal(got, want), blocks
        assert (got[:, :, 32:64] != 0).all() and not got[:, :, :32].any()


def test_probe_exactness_kernels(cuda):
    """P2 equals its plain version (TF32 operands) on every input; on the
    control input (exact in TF32) P2 and P3 equal the exact broadcast;
    both at one copy and at the full-card shape (every copy written, and
    one slice of it written); each call one launch."""
    s = torch.from_numpy(pv.exact_selectors()).to(cuda)
    n = pv.OCCUPANCY_COPIES
    for copies, stored in ((1, 1), (n, n), (n, 1)):
        for name, w_np in pv.exact_inputs().items():
            w = torch.from_numpy(w_np).to(cuda)
            before = pv.exact1.launches
            got = pv.exact1(w, s, copies, stored)
            assert pv.exact1.launches == before + 1
            assert torch.equal(
                got, pv.exact1_reference(w, s, copies, stored)), (
                name, copies, stored)
            if name == "control":
                exact = pv.broadcast(w)
                if copies > 1:
                    exact = exact.expand(stored, *exact.shape)
                assert torch.equal(got, exact), (copies, stored)
                before = pv.exact3.launches
                assert torch.equal(pv.exact3(w, s, copies, stored),
                                   exact), (copies, stored)
                assert pv.exact3.launches == before + 1
            del got
            torch.cuda.empty_cache()
    with pytest.raises(ValueError):
        pv.exact1(w, s, 0)
    with pytest.raises(ValueError):
        pv.exact1(w, s, 2, 3)
    # contiguous but not 16-byte aligned: the kernel reads 16 bytes at a
    # time
    shifted = torch.zeros(8 * 128 + 1, device=cuda)[1:].view(8, 128)
    with pytest.raises(ValueError):
        pv.exact3(shifted, s)


@pytest.mark.parametrize("s", [pyb.CHECK_S, pyb.S])
def test_probe_ybounds_equals_plain_version(cuda, s):
    """P4: every mode against its plain version, at 64 emissions and at
    the probe's 4096, serial (one chunk), at the full-card chunking, in a
    chunk count that divides neither, and in more chunks than
    emissions."""
    lo, hi = (torch.from_numpy(v).to(cuda) for v in pyb.ybounds_inputs(s))
    for mode in pyb.MODES:
        want = pyb.ybounds_reference(lo, hi, mode)
        for chunks in (1, None, 7, s + 3):
            before = pyb.ybounds.launches
            got = pyb.ybounds(lo, hi, mode, chunks)
            assert pyb.ybounds.launches == before + 1
            assert torch.equal(got, want), (mode, chunks)
    assert pyb.full_chunks("union") >= 32
