"""The item pass: the port's render_frame with use_item_pass_kernel, its
item pack and its plain item-pass version against the JAX package on
the CPU (the CUDA kernel against the plain version is in
tests/test_torch_cuda.py).

On the CPU the JAX render_frame takes its XLA pipeline (the deferred
pass with an item pool); tests/test_paint.py holds the JAX item-pass
kernel to that pipeline wherever the item pool does not overflow.  So
the port's item-pass frame is held to the JAX frame at an item capacity
where JAX counts no item overflow, and, at a capacity where the
deferred pass does overflow, to that same uncapped frame.

Fixtures: the demo at B=8 (four views of tests/test_paint.py and four
spread poses) and e1m1-scale at B=4, 160x96.  The JAX side runs jitted,
once per fixture (render_frame and item_pack in one function); frames
are per camera, so the demo's B=4 case is held to the first four
cameras of the B=8 run.

The benchmark's e1m1-itempass pipeline is held, at a small screen, to
the benchmark's own plain reference (portbench/reference), as each run
of its cell is on the card.

Tolerance: exact equality of idx, rgb, the item packs (f32 rows bit for
bit, NaNs where JAX has NaNs) and the counters.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from doomtpu.assets.bundle import LevelAssets as JaxAssets  # noqa: E402
from doomtpu.config import RenderConfig  # noqa: E402
from doomtpu.level.tables import MapTables as JaxTables  # noqa: E402
from doomtpu.render import camera as jcam  # noqa: E402
from doomtpu.render import frame as jframe  # noqa: E402
from doomtpu.render import things as jthings  # noqa: E402
from doomtpu.render.device import DeviceLevel as JaxLevel  # noqa: E402
from doomtpu.wad.reader import WadFile as JaxWad  # noqa: E402
from doomtpu_torch import config as tcfg  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.ops import itempass as tip  # noqa: E402
from doomtpu_torch.ops import items as ti  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.render import camera as tcam  # noqa: E402
from doomtpu_torch.render import frame as tframe  # noqa: E402
from doomtpu_torch.render import things as tthings  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VIEWS = [(384.0, 256.0, 0.0), (900.0, 256.0, 2.5), (300.0, 700.0, 4.6),
         (384.0, 256.0, 3.1)]
# pools above both fixtures' uncapped peaks (span 30, mid 7, clip 26,
# item 7 on e1m1-scale), no deeper: the JAX side's compile time grows
# with span_capacity and item_capacity
CFG = RenderConfig(width=160, height=96, span_capacity=40, mid_capacity=16,
                   clip_capacity=32, item_capacity=8,
                   use_item_pass_kernel=True, use_pallas_paint=True)


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


def _jax_level(wad_bytes, info):
    wad = JaxWad(wad_bytes)
    t = JaxTables.load(wad, "E1M1")
    return JaxLevel.build(t, JaxAssets.load(wad, t, info.sprite_names), info)


class Fixture:
    """Both levels, a port engine, a game state at the given views and
    the JAX reference: render_frame (the XLA pipeline) and item_pack,
    jitted together once."""

    def __init__(self, wad_fn, info, views, cfg=CFG):
        wad = wad_fn()
        self.te = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg,
                                            device="cpu")
        self.tl = self.te.level
        self.jl = _jax_level(wad, info)
        self.state = self.te.new_game(
            len(views), pos=np.asarray([v[:2] for v in views], np.float32),
            angle=np.asarray([v[2] for v in views], np.float32),
            generator=torch.Generator().manual_seed(0))
        st = self.state
        self.args = (st.pos[:, 0].contiguous(), st.pos[:, 1].contiguous(),
                     st.angle, st.floor_height, st.sector_light,
                     st.mobj_state, st.timestamp)

        def run(level, px, py, pa, fh, sl, ms, tsm):
            idx, rgb, aux = jframe.render_frame(level, cfg, px, py, pa, fh,
                                                sl, ms, tsm)
            frame = jcam.build_seg_frame(level, cfg, px, py, pa, fh, sl, tsm)
            order = jcam.seg_order(level, jcam.traversal_rank(level, px, py))
            pack, paux = jthings.item_pack(level, cfg, frame, order, px, py,
                                           pa, fh, sl, ms)
            return {"idx": idx, "rgb": rgb, "overflow": aux["overflow"],
                    "items_dropped": aux["items_dropped"],
                    "item_overflow": aux["item_overflow"],
                    "i": pack["i"], "f": pack["f"],
                    "pack_dropped": paux["items_dropped"]}

        out = jax.jit(run)(self.jl, *(jnp.asarray(a.numpy())
                                      for a in self.args))
        self.want = jax.tree_util.tree_map(np.asarray, out)

    def cut(self, B):
        return tuple(a[:B] for a in self.args)


@pytest.fixture(scope="module")
def demo(info, demo_level):
    return Fixture(synth.demo_wad, info,
                   VIEWS + _spread(demo_level.tables, 4, seed=1))


@pytest.fixture(scope="module")
def e1m1(info):
    t = JaxTables.load(JaxWad(synth.e1m1_scale_wad()), "E1M1")
    return Fixture(synth.e1m1_scale_wad, info, _spread(t, 4, seed=2))


def _fixture(request, case):
    return request.getfixturevalue(case.split("-")[0])


def _port_pack(fx, B, cfg=CFG):
    px, py, pa, fh, sl, ms, tsm = fx.cut(B)
    frame = tcam.build_seg_frame(fx.tl, cfg, px, py, pa, fh, sl, tsm)
    order = tcam.seg_order(fx.tl, tcam.traversal_rank(fx.tl, px, py))
    return frame, order, tthings.item_pack(fx.tl, cfg, frame, order, px, py,
                                           pa, fh, sl, ms)


@pytest.mark.parametrize("case", ["demo", "e1m1"])
def test_item_pack_equals_jax(case, request):
    fx = _fixture(request, case)
    B = 4
    _, _, (pack, aux) = _port_pack(fx, B)
    w = fx.want
    np.testing.assert_array_equal(pack["i"].numpy(), w["i"][:B])
    got_f, want_f = pack["f"].numpy(), w["f"][:B]
    nan = np.isnan(want_f)
    np.testing.assert_array_equal(np.isnan(got_f), nan)
    np.testing.assert_array_equal(got_f.view(np.int32)[~nan],
                                  want_f.view(np.int32)[~nan])
    np.testing.assert_array_equal(aux["items_dropped"].numpy(),
                                  w["pack_dropped"][:B])
    assert not aux["item_overflow"].any()
    # valid sprites and mids, farthest first, are both in the pack
    fl = pack["i"][..., tip.IPI_FL]
    assert bool(((fl & 3) == 3).any()) and bool(((fl & 3) == 1).any())


@pytest.mark.parametrize("case", ["demo-B4", "demo-B8", "e1m1-B4"])
def test_item_pass_frame_equals_jax(case, request, monkeypatch):
    fx = _fixture(request, case)
    B = int(case.split("B")[1])
    w = fx.want
    assert int(w["item_overflow"][:B].sum()) == 0     # JAX drew every item
    assert tframe.itempass_available(fx.tl, CFG, B)

    def no_deferred_pass(*a, **k):
        raise AssertionError("the deferred pass ran")

    monkeypatch.setattr(tthings, "deferred_pass", no_deferred_pass)
    before = (tip.item_pass.launches, tp.paint.launches,
              ti.composite_items.launches)
    idx, rgb, aux = tframe.render_frame(fx.tl, CFG, *fx.cut(B))
    assert (tip.item_pass.launches, tp.paint.launches,
            ti.composite_items.launches) == before   # CPU: the plain versions
    np.testing.assert_array_equal(idx.numpy(), w["idx"][:B])
    np.testing.assert_array_equal(rgb.numpy(), w["rgb"][:B])
    np.testing.assert_array_equal(aux["items_dropped"].numpy(),
                                  w["items_dropped"][:B])
    assert int(w["overflow"][:B].sum()) == 0
    for k in ("overflow", "item_overflow", "item_block_dropped", "live_dropped",
              "live_stale"):
        assert int(aux[k].sum()) == 0, k


def test_item_pass_draws_what_the_pool_drops(e1m1):
    """At item capacity 1 the deferred pass drops items on these poses;
    the item pass draws every item, equals the JAX frame drawn without
    overflow, and the engine's counters read no item overflow."""
    cap1 = dataclasses.replace(CFG, item_capacity=1)
    deferred = dataclasses.replace(cap1, use_item_pass_kernel=False)
    _, _, aux = tframe.render_frame(e1m1.tl, deferred, *e1m1.args)
    assert int(aux["item_overflow"].sum()) > 0
    eng = dataclasses.replace(e1m1.te, config=cap1)
    idx, rgb = eng.render(e1m1.state)
    np.testing.assert_array_equal(idx.numpy(), e1m1.want["idx"])
    np.testing.assert_array_equal(rgb.numpy(), e1m1.want["rgb"])
    counters = eng.render_counters(e1m1.state)
    assert counters["item_overflow"] == 0
    assert set(counters.values()) == {0}


def test_itempass_available_agrees_with_jax(demo, e1m1, info, monkeypatch):
    """The port's branch test against JAX frame.itempass_available, whose
    backend test is made to see an accelerator."""
    import warnings

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # GRATE on solid walls
        masked = DoomEngine.from_wad_bytes(
            synth.e1m1_scale_masked_wad(), "e1m1", device="cpu").level
        jmasked = _jax_level(synth.e1m1_scale_masked_wad(), info)
    d1 = DoomEngine.from_wad_bytes(synth.doom1_scale_wad(), "e1m1",
                                   device="cpu").level
    jd1 = _jax_level(synth.doom1_scale_wad(), info)
    cfg = CFG
    cases = [
        ("demo", demo.tl, demo.jl, cfg, 8, True),
        ("demo, no use_pallas_paint", demo.tl, demo.jl,
         dataclasses.replace(cfg, use_pallas_paint=False), 8, False),
        ("demo B=6", demo.tl, demo.jl, cfg, 6, False),
        ("demo, no flag", demo.tl, demo.jl,
         dataclasses.replace(cfg, use_item_pass_kernel=False), 8, False),
        ("e1m1-scale", e1m1.tl, e1m1.jl, cfg, 4, True),
        ("doom1-asset-scale", d1, jd1, cfg, 4, False),
        ("doom1-asset-scale, 256 visible", d1, jd1,
         dataclasses.replace(cfg, max_visible_mobjs=256), 4, True),
        ("e1m1-scale-masked", masked, jmasked, cfg, 4, False),
    ]
    for name, tl, jl, c, B, want in cases:
        assert tl.itempaint_ok == jl.itempaint_ok, name
        assert jframe.itempass_available(jl, c, B) == want, name
        assert tframe.itempass_available(tl, c, B) == want, name
    assert demo.tl.itempaint_ok and e1m1.tl.itempaint_ok and d1.itempaint_ok


def _paint_out(B, H, W, KC, KM):
    """A paint result of zeros: frames [B, H, W], pools slot-major."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    return {
        "idx": z(B, H, W), "ld": z(B, H, W), "rgb": z(B, H, W),
        "clippool": tuple(z(B, KC, W).transpose(1, 2) for _ in range(7)),
        "midpool": tuple(z(B, KM, W).transpose(1, 2) for _ in range(7)),
        "cnt_clip": z(B, W), "cnt_mid": z(B, W),
    }


def test_shade_rounds_as_jax(demo):
    """light / 255 in the item-pass shade: one masked-mid pixel whose
    shaded byte differs between the IEEE quotient and the multiply by
    f32(1 / 255), through the JAX item-pass kernel (interpret mode) and
    the port's item pass."""
    from doomtpu.ops.pallas_itempass import item_pass as jax_item_pass

    tl, jl = demo.tl, demo.jl
    B, H, W, KC, KM = 4, 8, 128, 1, 1
    cfg = RenderConfig(width=W, height=H, clip_capacity=KC, mid_capacity=KM)
    T, _, TW = tl.tex_pixels.shape
    rows = tl.atlas_rows
    row0 = tl.atlas_cm.reshape(-1, rows)[:T * TW, 0].numpy()
    cols = np.nonzero((row0 & 0x100) != 0)[0]
    cols = cols[cols % TW < tip.PIC_SIZE]
    chans = (tl.palette_packed.numpy()[row0[cols] & 0xFF, None]
             >> np.array([16, 8, 0])) & 0xFF                 # [cols, 3]
    f32 = np.float32
    light = np.arange(256, dtype=f32)[:, None]
    zd = np.arange(0, 1024, dtype=f32)[None]
    fac_div = np.maximum(light / f32(255) - zd * f32(1 / 4096), f32(0))
    fac_mul = np.maximum(light * (f32(1) / f32(255)) - zd * f32(1 / 4096),
                         f32(0))
    case = None
    for li, zi in np.argwhere(fac_div != fac_mul):
        hit = (np.trunc(chans * fac_div[li, zi])
               != np.trunc(chans * fac_mul[li, zi])).any(1)
        if hit.any():
            case = int(li), int(zi), int(cols[np.argmax(hit)])
            break
    assert case is not None
    lv, zv, col = case
    tex, c = divmod(col, TW)

    # one masked mid (seg 5) in camera 0, column 0: row 0 only, texel
    # row 0 of texture `tex` at column c
    ip = torch.zeros((B, 1, tip.IPI_ROWS), dtype=torch.int32)
    ip[0, 0, tip.IPI_FL], ip[0, 0, tip.IPI_X1E] = 1, 1
    ip[0, 0, tip.IPI_PIC], ip[0, 0, tip.IPI_SOFF] = tex, 5
    items = {"i": ip, "f": torch.zeros((B, 1, tip.IPF_ROWS))}
    out = _paint_out(B, H, W, KC, KM)
    mid = [p.transpose(1, 2) for p in out["midpool"]]        # [B, KM, W]
    for plane, v in zip(mid, ((3 << 29) | (1 << 8) | 1, col, 1 << 16, 1,
                              (lv << 16) | zv, 0, 5)):
        plane[0, 0, 0] = v
    out["cnt_mid"][0, 0] = 1

    j = lambda x: jnp.asarray(x.numpy())
    cnt = lambda x: j(x).reshape(1, B, W)
    raw = {k: j(out[k]) for k in ("idx", "ld", "rgb")}
    raw["midpool"] = [j(p) for p in mid]
    raw["clippool"] = [j(p.transpose(1, 2)) for p in out["clippool"]]
    raw["cnt_mid"], raw["cnt_clip"] = cnt(out["cnt_mid"]), cnt(out["cnt_clip"])
    want = jax_item_pass(jl, cfg, {"i": j(ip), "f": j(items["f"])}, raw,
                         interpret=True)
    got = tip.item_pass(tl, cfg, items, out)
    for name, g, w in zip(("idx", "ld", "rgb"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got[0][0, 0, 0]) == int(row0[col] & 0xFF)


def test_wrapper_takes_plain_version_on_cpu_only(demo):
    B = 4
    frame, order, (pack, _) = _port_pack(demo, B)
    px, py, pa, fh = demo.cut(B)[:4]
    out = lambda: tp.render_paint(demo.tl, CFG, frame, order, pa, px, py, fh)
    before = tip.item_pass.launches
    a = tip.item_pass(demo.tl, CFG, pack, out())
    b = tip.item_pass_reference(demo.tl, CFG, pack, out())
    assert tip.item_pass.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    o = out()
    assert int((a[0] != o["idx"]).sum()) > 100                # items drew
    with pytest.raises(ValueError):                 # pack on meta, frame not
        tip.item_pass(demo.tl, CFG, {k: v.to("meta") for k, v in
                                     pack.items()}, o)
    with pytest.raises(ValueError):
        tip.item_pass(demo.tl, CFG, dict(pack, i=pack["i"].to(torch.int64)),
                      o)
    with pytest.raises(ValueError):                 # a level K3 does not take
        tip.item_pass(dataclasses.replace(demo.tl, itempaint_ok=False), CFG,
                      pack, o)


@pytest.mark.parametrize("kc, km", [(32, 16), (64, 40), (96, 40)])
def test_itempass_tile_fits_every_height(kc, km):
    """The item-pass kernel's tile (ops/itempass.itempass_tile): at every
    height up to 1200 rows, at least one column whose 16-bit marks,
    round terms, staged clip records and mid keys fit the shared memory
    a Hopper block may use, within the block's threads; 32 columns and
    16 bands at the bench's 200 rows, and at most 75 KB there, so that
    three blocks share an SM."""
    for H in range(1, 1201):
        tc, bands = tip.itempass_tile(H, kc, km)
        smem = tip.itempass_smem_bytes(tc, bands, H, kc, km)
        assert tc >= 1 and bands >= 1, H
        assert 2 * tc * H < smem <= tp.SMEM_BLOCK_BYTES, H
        assert tc * bands <= tip.MAX_BLOCK_THREADS, H
    assert tip.itempass_tile(200, 64, 40) == (32, 16)
    assert tip.itempass_smem_bytes(32, 16, 200, 64, 40) <= 75 * 1024


def test_item_pass_frame_equals_the_benchmark_reference(monkeypatch):
    """The e1m1-itempass cell's pipeline at a small screen: e1m1-scale
    at B=8, 64x48, spread poses (portbench.generate) after 2 zero-control
    ticks, pools calibrated, against the benchmark's plain reference
    (portbench/reference: the scan pipeline and an uncapped deferred
    pass, another algorithm, which imports nothing of the port).  Every
    idx and rgb pixel equal, every counter 0; the item pass drew and the
    deferred pass never ran."""
    from portbench import generate, manifest
    from portbench.reference import Reference

    W, H = 64, 48
    config = manifest.read_json(manifest.config_path("e1m1-itempass"))
    mix = manifest.read_json(manifest.traffic_path("render-spread"))
    mix.update(batch=8, chain=3)
    inputs = generate.generate(mix, 2**33 + 7, generate.level_tables(config))
    wad = generate.wad_bytes(config)
    eng = DoomEngine.from_wad_bytes(
        wad, "e1m1", config=tcfg.RenderConfig(
            **dict(config["render"], width=W, height=H)), device="cpu")
    controls = torch.as_tensor(inputs.controls)
    draws = torch.as_tensor(inputs.draws)
    st = eng.new_game(inputs.batch, pos=inputs.pos, angle=inputs.angle,
                      generator=torch.Generator().manual_seed(
                          inputs.light_seed))
    for t in range(inputs.ticks):
        st = eng.tick(st, controls[t], draws=draws[t])
    assert not controls.any()
    eng = eng.calibrate([st])
    assert tframe.itempass_available(eng.level, eng.config, inputs.batch)

    drawn = []
    item_pass = tframe.item_pass

    def counted(level, cfg, items, out):
        before = out["idx"].clone()
        got = item_pass(level, cfg, items, out)
        drawn.append(int((out["idx"] != before).sum()))
        return got

    def no_deferred(*a, **kw):
        raise AssertionError("the deferred pass ran on the item pass")
    monkeypatch.setattr(tframe, "item_pass", counted)
    monkeypatch.setattr(tthings, "deferred_pass", no_deferred)
    idx, rgb = eng.render(st)
    counters = eng.render_counters(st)
    assert len(drawn) == 2 and drawn[0] > 0
    assert set(counters.values()) == {0}, counters

    ref = Reference(wad, "e1m1", W, H, "cpu")
    rs = ref.initial(inputs.pos, inputs.angle,
                     torch.Generator().manual_seed(inputs.light_seed))
    for t in range(inputs.ticks):
        rs = ref.tick(rs, controls[t], draws[t])
    ridx, rrgb = ref.render(rs)
    assert int((idx != ridx).sum()) == 0
    assert int((rgb != rrgb).sum()) == 0
