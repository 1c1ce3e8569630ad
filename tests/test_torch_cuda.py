"""Tests that need a CUDA card: the paint, item, item-pass, emission,
wall-scan and resolve kernels against their plain PyTorch versions (on tall and wide
screens too, the paint kernel under a live-seg cap that drops segs, the
resolve under a sky with transparent texels and on hand-made pools), the
Hopper probes P1-P4 against theirs (every construct at both launch
shapes, small N and S), and
render / render_walls on the card against the same calls on the CPU, on
the paint path (`use_pallas_paint=True`) and on the scan + resolve
pipeline.

This file imports no JAX, so it also runs where there is a card and no
JAX; the repo's conftest imports JAX, so leave it out there:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test skips.  Tolerance: exact equality on every
output (for the pools of the paint kernel and the wall scan: every slot
below a column's count; the kernels do not write the slots past it,
which nothing reads, tests/test_torch_pools.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import sky_masked, tall_atlas  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402
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
    views = VIEWS * 2
    st = _state(eng, np.asarray([v[:2] for v in views], np.float32),
                np.asarray([v[2] for v in views], np.float32))
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(eng.level, cfg, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.timestamp)
    order = cam.seg_order(eng.level, cam.traversal_rank(eng.level, px, py))
    args = tp.build_inputs(eng.level, cfg, frame, order, st.angle,
                           px, py, st.floor_height)
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


def test_itempass_kernel_on_tall_and_wide_screens(screen):
    eng, cfg, st, frame, order, args = screen
    out = tp.paint(eng.level, cfg, *args)
    pack, _ = things.item_pack(eng.level, cfg, frame, order, st.pos[:, 0],
                               st.pos[:, 1], st.angle, st.floor_height,
                               st.sector_light, st.mobj_state)
    fresh = lambda: dict(out, **{k: out[k].clone()
                                 for k in ("idx", "ld", "rgb")})
    got = tip.item_pass(eng.level, cfg, pack, fresh())
    want = tip.item_pass_reference(eng.level, cfg, pack, fresh())
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] != out["idx"]).sum()) > 0     # some item drew


@pytest.mark.parametrize("percam", [True, False], ids=["percam", "union"])
def test_paint_kernel_under_a_dropping_cap(cuda, percam):
    """e1m1-scale, B=32 spread poses, paint_live_capacity 32: the paint
    kernel skips the segs the drop mask names as its plain version
    does."""
    cfg = RenderConfig(mid_capacity=40, clip_capacity=64,
                       paint_live_capacity=32, paint_percam_compact=percam)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=cuda)
    st = _state(eng, *_spread(eng.tables, 32))
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(eng.level, cfg, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.timestamp)
    order = cam.seg_order(eng.level, cam.traversal_rank(eng.level, px, py))
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


@pytest.mark.parametrize("case", ["clip", "clip=None", "atlas_rows=256"])
def test_item_kernel_on_tall_and_wide_screens(screen, case):
    """K2 with the clip pool, without one (the words clipped beforehand,
    as the JAX _kernel_kouter takes them) and on an atlas of 256 rows a
    column."""
    eng, cfg, st, frame, order, args = screen
    out = tp.paint(eng.level, cfg, *args)
    pools = things.pools_from_paint(out)
    ipool, icnt, _ = things.item_pool(
        eng.level, cfg, frame, pools, order, st.pos[:, 0], st.pos[:, 1],
        st.angle, st.floor_height, st.sector_light, st.mobj_state)
    level, clip = eng.level, pools[0]
    if case == "clip=None":
        ipool = ipool.clone()
        ipool[0] = ti.clipped_words(ipool, clip, cfg.height)
        clip = None
    elif case == "atlas_rows=256":
        level, ipool = tall_atlas(level, ipool)
    bg = lambda: [out[k].clone() for k in ("idx", "ld", "rgb")]
    got = ti.composite_items(level, cfg, ipool, icnt, *bg(), clip=clip)
    want = ti.composite_items_reference(level, cfg, ipool, icnt, *bg(),
                                        clip=clip)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] != out["idx"]).sum()) > 0     # some item drew


def _spread(t, n, seed=0):
    rng = np.random.default_rng(seed)
    left, right, top, bottom = [float(v) for v in t.bbox]
    poses = []
    while len(poses) < n:
        x, y = rng.uniform(left, right), rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            poses.append((x, y, rng.uniform(0, 2 * np.pi)))
    return (np.asarray([p[:2] for p in poses], np.float32),
            np.asarray([p[2] for p in poses], np.float32))


@pytest.mark.parametrize("ki", [8, 24])
def test_item_kernel_equals_plain_version(engines, ki):
    """The deferred pass's item pool on 8 views of the demo map, through
    the kernel and through its plain version, clip pool included."""
    eng, _ = engines
    cfg = RenderConfig(item_capacity=ki)
    views = VIEWS * 2
    st = _state(eng, np.asarray([v[:2] for v in views], np.float32),
                np.asarray([v[2] for v in views], np.float32))
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(eng.level, cfg, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.timestamp)
    order = cam.seg_order(eng.level, cam.traversal_rank(eng.level, px, py))
    out = tp.render_paint(eng.level, cfg, frame, order, st.angle, px, py,
                          st.floor_height)
    pools = things.pools_from_paint(out)
    ipool, icnt, _ = things.item_pool(
        eng.level, cfg, frame, pools, order, px, py, st.angle,
        st.floor_height, st.sector_light, st.mobj_state)
    bg = lambda: [out[k].clone() for k in ("idx", "ld", "rgb")]
    before = ti.composite_items.launches
    got = ti.composite_items(eng.level, cfg, ipool, icnt, *bg(),
                             clip=pools[0])
    torch.cuda.synchronize()
    assert ti.composite_items.launches == before + 1
    want = ti.composite_items_reference(eng.level, cfg, ipool, icnt, *bg(),
                                        clip=pools[0])
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert int((got[0] != out["idx"]).sum()) > 100


def test_itempass_kernel_equals_plain_version(engines):
    """Every selected item of 8 views of the demo map, through the
    item-pass kernel and through its plain version."""
    eng, _ = engines
    cfg = RenderConfig(use_item_pass_kernel=True)
    views = VIEWS * 2
    st = _state(eng, np.asarray([v[:2] for v in views], np.float32),
                np.asarray([v[2] for v in views], np.float32))
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(eng.level, cfg, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.timestamp)
    order = cam.seg_order(eng.level, cam.traversal_rank(eng.level, px, py))
    out = tp.render_paint(eng.level, cfg, frame, order, st.angle, px, py,
                          st.floor_height)
    pack, _ = things.item_pack(eng.level, cfg, frame, order, px, py,
                               st.angle, st.floor_height, st.sector_light,
                               st.mobj_state)
    fresh = lambda: dict(out, **{k: out[k].clone()
                                 for k in ("idx", "ld", "rgb")})
    before = tip.item_pass.launches
    got = tip.item_pass(eng.level, cfg, pack, fresh())
    torch.cuda.synchronize()
    assert tip.item_pass.launches == before + 1
    want = tip.item_pass_reference(eng.level, cfg, pack, fresh())
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
    assert int((got[0] != out["idx"]).sum()) > 100


EMIT_CASES = ["demo-KI1", "demo-KI8", "demo-KI24", "e1m1-paint",
              "e1m1-paint-bwk", "e1m1-scan", "e1m1-paint-t64",
              "e1m1-paint-notable"]


@pytest.mark.parametrize("case", EMIT_CASES)
def test_emit_kernel_equals_plain_version(cuda, case, monkeypatch):
    """The deferred pass's emission (ops/emit.py) through the kernel and
    through its plain version, every plane of the pool, icnt,
    item_overflow and item_peak: the demo map at B=8 on the paint
    path's mid pool at item capacity 1 (overflowing), 8 and 24;
    e1m1-scale at B=32 on the paint path's mid pool, on the same pool
    laid out as the JAX package's [B, W, K] store and read through its
    strides ("-bwk"), on the scan path's unified pool, and in blocks
    that emit_block picks only elsewhere: 64 threads (the columns in
    five passes) and no seg -> item table (each seg looked up by a walk
    of the pack, the fallback for levels whose table does not fit)."""
    block = {"t64": (64, True), "notable": (320, False)}.get(
        case.rsplit("-", 1)[1])
    if block is not None:
        monkeypatch.setattr(kem, "emit_block", lambda *a: block)
    if case.startswith("demo"):
        cfg = RenderConfig(item_capacity=int(case.split("KI")[1]),
                           use_pallas_paint=True)
        eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=cfg,
                                        device=cuda)
        views = VIEWS * 2
        st = _state(eng, np.asarray([v[:2] for v in views], np.float32),
                    np.asarray([v[2] for v in views], np.float32))
    else:
        cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                           clip_capacity=64, item_capacity=24,
                           span_capacity=96, use_pallas_paint=True)
        eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device=cuda)
        st = _state(eng, *_spread(eng.tables, 32))
    lvl = eng.level
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(lvl, cfg, px, py, st.angle, st.floor_height,
                                st.sector_light, st.timestamp)
    order = cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))
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
    pack, _ = things.item_pack(lvl, cfg, frame, order, px, py, st.angle,
                               st.floor_height, st.sector_light,
                               st.mobj_state)
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
    """A render launches the emission kernel once on the paint path and
    on the scan path (the deferred pass), never with the item pass."""
    eng, _ = engines
    views = VIEWS * 2
    pos = np.asarray([v[:2] for v in views], np.float32)
    ang = np.asarray([v[2] for v in views], np.float32)
    for cfg, want in ((eng.config, 1),
                      (dataclasses.replace(eng.config,
                                           use_pallas_paint=False), 1),
                      (dataclasses.replace(eng.config,
                                           use_item_pass_kernel=True), 0)):
        e = dataclasses.replace(eng, config=cfg)
        st = _state(e, pos, ang)
        before = (kem.emit.launches, tip.item_pass.launches)
        e.render(st)
        torch.cuda.synchronize()
        assert kem.emit.launches - before[0] == want, cfg
        assert tip.item_pass.launches - before[1] == 1 - want, cfg


def test_render_walls_on_card_equals_cpu(engines):
    """B=16 spread poses, so the camera sort runs."""
    gpu, cpu = engines
    pos, ang = _spread(cpu.tables, 16)
    before = tp.paint.launches
    idx, rgb = gpu.render_walls(_state(gpu, pos, ang))
    torch.cuda.synchronize()
    assert tp.paint.launches > before
    assert idx.is_cuda and rgb.is_cuda
    idx_c, rgb_c = cpu.render_walls(_state(cpu, pos, ang))
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(rgb.cpu(), rgb_c)
    assert gpu.render_walls_counters(_state(gpu, pos, ang)) == {
        "overflow": 0, "live_dropped": 0}


@pytest.mark.parametrize("wad_fn", ["demo_wad", "e1m1_scale_wad"])
def test_render_on_card_equals_cpu(cuda, wad_fn):
    """Full frames, B=16 spread poses (the camera sort runs), pools deep
    enough to drop nothing."""
    cfg = RenderConfig(mid_capacity=40, clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True)
    wad = getattr(synth, wad_fn)()
    gpu = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=cuda)
    cpu = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device="cpu")
    pos, ang = _spread(cpu.tables, 16)
    before = (tp.paint.launches, ti.composite_items.launches)
    idx, rgb = gpu.render(_state(gpu, pos, ang))
    torch.cuda.synchronize()
    assert tp.paint.launches > before[0]
    assert ti.composite_items.launches > before[1]
    idx_c, rgb_c = cpu.render(_state(cpu, pos, ang))
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(rgb.cpu(), rgb_c)
    counters = gpu.render_counters(_state(gpu, pos, ang))
    assert set(counters.values()) == {0}, counters


def _masked_engine(device, cfg):
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # GRATE on solid walls
        return DoomEngine.from_wad_bytes(synth.e1m1_scale_masked_wad(), "e1m1",
                                         config=cfg, device=device)


@pytest.mark.parametrize("case", ["demo-K16", "demo-K4", "masked-K64"])
def test_scan_kernel_equals_plain_version(cuda, case):
    """Demo views at B=8 (K=4 overflows), e1m1-scale-masked at B=32."""
    K = int(case.split("K")[1])
    cfg = RenderConfig(width=320, height=200, span_capacity=K)
    if case.startswith("demo"):
        eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=cfg,
                                        device=cuda)
        views = VIEWS * 2
        st = _state(eng, np.asarray([v[:2] for v in views], np.float32),
                    np.asarray([v[2] for v in views], np.float32))
    else:
        eng = _masked_engine(cuda, cfg)
        st = _state(eng, *_spread(eng.tables, 32))
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(eng.level, cfg, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.timestamp)
    order = cam.seg_order(eng.level, cam.traversal_rank(eng.level, px, py))
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
                 "640x255", "320x768", "hand-made"]


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
    e1m1-scale's sky with transparent texels, a wide screen of 255 rows
    and a tall one of 768 (rows past 254 take no span), and hand-made
    pools."""
    W, H, K = 320, 200, 96
    if case in ("640x255", "320x768"):
        W, H = map(int, case.split("x"))
    cfg = RenderConfig(width=W, height=H, span_capacity=K)
    if case == "e1m1-scale-masked":
        eng = _masked_engine(cuda, cfg)
        st = _state(eng, *_spread(eng.tables, 32))
    elif case in ("e1m1-scale-B64", "sky-masked"):
        eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device=cuda)
        st = _state(eng, *_spread(eng.tables, 64 if "B64" in case else 32))
    else:
        eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", config=cfg,
                                        device=cuda)
        views = VIEWS * 2
        st = _state(eng, np.asarray([v[:2] for v in views], np.float32),
                    np.asarray([v[2] for v in views], np.float32))
    px, py = st.pos[:, 0], st.pos[:, 1]
    poses = (px, py, st.angle, st.floor_height)
    frame = cam.build_seg_frame(eng.level, cfg, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.timestamp)
    order = cam.seg_order(eng.level, cam.traversal_rank(eng.level, px, py))
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
        assert bool(((ld & tp.LD_SKY) != 0).any())
        opaque = res.resolve_frame(eng.level, cfg, frame, pool, cnt, *poses)
        assert int((opaque[0] != idx).sum()) > 0
    if H > 255:
        assert bool((idx[:, 255:] == -1).all())


def test_render_masked_on_card_equals_cpu(cuda):
    """The scan + resolve pipeline end to end, B=8 spread poses."""
    cfg = RenderConfig(span_capacity=64, mid_capacity=40, clip_capacity=64,
                       item_capacity=24, use_pallas_paint=True)
    gpu, cpu = _masked_engine(cuda, cfg), _masked_engine("cpu", cfg)
    assert not gpu.level.paint_ok
    pos, ang = _spread(cpu.tables, 8)
    before = (tp.paint.launches, ts.scan.launches, kres.resolve.launches,
              ti.composite_items.launches)
    idx, rgb = gpu.render(_state(gpu, pos, ang))
    torch.cuda.synchronize()
    assert (tp.paint.launches, ts.scan.launches, kres.resolve.launches,
            ti.composite_items.launches) == (before[0], before[1] + 1,
                                             before[2] + 1, before[3] + 1)
    idx_c, rgb_c = cpu.render(_state(cpu, pos, ang))
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(rgb.cpu(), rgb_c)
    widx, wrgb = gpu.render_walls(_state(gpu, pos, ang))
    widx_c, wrgb_c = cpu.render_walls(_state(cpu, pos, ang))
    assert torch.equal(widx.cpu(), widx_c) and torch.equal(wrgb.cpu(), wrgb_c)
    counters = gpu.render_counters(_state(gpu, pos, ang))
    assert set(counters.values()) == {0}, counters


@pytest.mark.parametrize("pipeline", ["paint-reuse", "scan"])
def test_moving_rollout_on_card_equals_cpu(cuda, pipeline):
    """16 cameras, 4 ticks of moving controls on e1m1-scale at 320x200:
    a live-reuse rollout on the paint path (live_stale > 0, so the paint
    kernel reads drop bits set by the reuse) and a rollout on the scan +
    resolve path, the final state, the frames and live_stale equal to the
    CPU port's (chip_smoke.moving_rollout)."""
    from chip_smoke import moving_rollout

    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True, paint_percam_compact=True,
                       paint_live_capacity=256)
    reuse = pipeline == "paint-reuse"
    if not reuse:
        cfg = dataclasses.replace(cfg, use_pallas_paint=False,
                                  span_capacity=96)
    diffs, stale, stale_cpu, launches = moving_rollout(cuda, cfg, reuse)
    assert set(diffs.values()) == {0}, diffs
    assert stale == stale_cpu
    assert launches["paint" if reuse else "scan"] == 4
    assert launches["resolve"] == (0 if reuse else 4)
    assert launches["items"] == launches["emit"] == 4
    if reuse:
        assert stale > 16 * 3


@pytest.mark.parametrize("pipeline", ["paint", "scan"])
def test_every_sync_is_in_a_sync_range(cuda, pipeline):
    """torch.cuda's sync debug mode over a tick and a render of 64
    walking cameras on e1m1-scale at 320x200, pools calibrated on the
    state: every synchronizing call lies inside a doom.sync range, no
    range inside another, and the ranges number what the CPU tests hold
    the port to (tests/test_torch_trace.py)."""
    from chip_smoke import spread_poses, sync_census
    from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP
    from test_torch_trace import SYNCS_RENDER, SYNCS_TICK

    cfg = RenderConfig(width=320, height=200,
                       use_pallas_paint=pipeline == "paint",
                       paint_percam_compact=True)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=cuda)
    pos, ang = spread_poses(eng.tables, 64)
    st = _state(eng, pos, ang)
    ctl = torch.full((64,), KEY_UP | KEY_LEFT, dtype=torch.int32,
                     device=cuda)
    st1 = eng.tick(st, ctl)
    eng = eng.calibrate([st1])
    eng.render(st1)
    for call, syncs in ((lambda: eng.tick(st, ctl), SYNCS_TICK),
                        (lambda: eng.render(st1), SYNCS_RENDER[pipeline])):
        c = sync_census(call)
        assert c["inside"] and all(c["inside"]), (c["inside"], c["sites"])
        assert (c["syncs"], c["nested"]) == (syncs, 0), c


def test_calibrate_on_card_equals_cpu(engines):
    """The census on a CUDA engine (its wall scan launches the wall-scan
    kernel) returns the CPU port's config on demo, B=8, a 3-tick chain of
    walking cameras (draws from the CPU, so both chains are the same)."""
    from doomtpu_torch.calibrate import calibrated_config
    from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP
    from doomtpu_torch.sim.thinkers import draw_lights

    card, cpu = engines
    pos = np.asarray([v[:2] for v in VIEWS * 2], np.float32)
    ang = np.asarray([v[2] for v in VIEWS * 2], np.float32)
    st_cpu = _state(cpu, pos, ang)
    st_card = st_cpu.map(lambda x: x.to(card.device))
    gen = torch.Generator().manual_seed(1)
    ctl = torch.full((8,), KEY_UP | KEY_LEFT, dtype=torch.int32)
    chain_cpu, chain_card = [st_cpu], [st_card]
    for _ in range(2):
        draws = draw_lights(gen, 8, cpu.level.num_sectors)
        chain_cpu.append(cpu.tick(chain_cpu[-1], ctl, draws=draws))
        chain_card.append(card.tick(chain_card[-1], ctl, draws=draws))
    ts.scan.launches = 0
    got = calibrated_config(card, chain_card, cache=False)
    assert ts.scan.launches >= 3          # one per state's geometry census
    assert got == calibrated_config(cpu, chain_cpu, cache=False)


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
