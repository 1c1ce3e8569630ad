"""The deferred item pass and the item composite: the port's plain
PyTorch versions against the JAX package (the CUDA kernel against the
plain version is in tests/test_torch_cuda.py).

Demo fixture, the four views of tests/test_paint.py at B=4 and 160x96.
The port's paint stage (held equal to the JAX paint kernel by
tests/test_torch_paint.py) gives both sides the same pools and
background frame.  Then:

- the composite: the port's item pool goes through the port's
  composite_items (on the CPU, its plain version) and through JAX
  composite_items(interpret=True) -- at item capacity 8 with the clip
  pool (the JAX `_kernel`, clip in kernel), and at 16 without it (the
  JAX `_kernel_kouter`, after the clip the port's clipped_words applies
  as the JAX XLA reductions do);
- the deferred pass: the port's deferred_pass against the JAX
  deferred_pass (XLA clip reductions and fold, jitted), with every item
  drawn and with max_visible_mobjs dropping items;
- the emission (ops/emit.py): item_pool hands it item_pack's pack, and
  its wrapper takes the plain version on CPU tensors and raises on a
  wrong dtype, shape or device (the kernel against the plain version is
  in tests/test_torch_cuda.py).

Tolerance: exact equality of idx, ld (light / dist / sky), rgb and the
item counters.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from doomtpu.render import camera as jcam  # noqa: E402
from doomtpu.render import things as jthings  # noqa: E402
from doomtpu.render.device import DeviceLevel as JaxLevel  # noqa: E402
from doomtpu_torch.ops import emit as te  # noqa: E402
from doomtpu_torch.ops import itempass as tip  # noqa: E402
from doomtpu_torch.ops import items as ti  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.render import camera as tcam  # noqa: E402
from doomtpu_torch.render import things as tthings  # noqa: E402
from doomtpu_torch.render.device import DeviceLevel  # noqa: E402


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


@pytest.fixture(scope="module")
def cfg(config):
    # a clip pool at the views' peak (10), no deeper: the JAX item
    # kernel's in-kernel clip unrolls one step per slot (its interpret
    # call takes ~28 s at 10 slots, ~39 s at 16)
    return dataclasses.replace(config, width=160, height=96, clip_capacity=10)


@pytest.fixture(scope="module")
def scene(demo_level, cfg):
    """Both levels, the poses, and the port's camera and paint stages."""
    t, a, info = demo_level.tables, demo_level.assets, demo_level.info
    jl, tl = JaxLevel.build(t, a, info), DeviceLevel.build(t, a, info, "cpu")
    B = len(VIEWS)
    poses = {
        "px": np.asarray([v[0] for v in VIEWS], np.float32),
        "py": np.asarray([v[1] for v in VIEWS], np.float32),
        "angle": np.asarray([v[2] for v in VIEWS], np.float32),
        "floor_height": np.asarray(
            [float(t.sector_floor_h[t.sector_at(v[0], v[1])]) for v in VIEWS],
            np.float32),
        "sector_light": np.repeat(
            np.asarray(t.sector_light, np.int32)[None], B, 0),
        "timestamp": np.full(B, 0.4, np.float32),
        "mobj_state": np.repeat(
            np.asarray(jl.mobj_spawn_state, np.int32)[None], B, 0),
    }
    p = {k: torch.from_numpy(v) for k, v in poses.items()}
    frame = tcam.build_seg_frame(
        tl, cfg, p["px"], p["py"], p["angle"], p["floor_height"],
        p["sector_light"], p["timestamp"])
    order = tcam.seg_order(tl, tcam.traversal_rank(tl, p["px"], p["py"]))
    out = tp.render_paint(tl, cfg, frame, order, p["angle"], p["px"],
                          p["py"], p["floor_height"])
    assert int(out["overflow"].sum()) == 0          # pools hold every record
    return jl, tl, poses, p, frame, order, out


def _port_pool(scene, cfg):
    _, tl, _, p, frame, order, out = scene
    pools = tthings.pools_from_paint(out)
    ipool, icnt, daux = tthings.item_pool(
        tl, cfg, frame, pools, order, p["px"], p["py"], p["angle"],
        p["floor_height"], p["sector_light"], p["mobj_state"])
    return pools, ipool, icnt, daux


def _bg(out):
    return [out[k].clone() for k in ("idx", "ld", "rgb")]


def _bwk(x):
    """[B, K, W] slot-major -> the JAX [B, W, K] layout, as jnp."""
    return jnp.asarray(x.transpose(1, 2).numpy())


@pytest.mark.parametrize("ki, with_clip", [(8, True), (16, False)])
def test_plain_composite_equals_jax_kernel(scene, cfg, ki, with_clip):
    from doomtpu.ops.pallas_items import composite_items as jax_composite

    jl, tl, *_, out = scene
    cfg = dataclasses.replace(cfg, item_capacity=ki)
    pools, ipool, icnt, _ = _port_pool(scene, cfg)
    clip = pools[0]
    assert int(icnt.max()) > 1 and bool(((ipool[0] & ti.SPR_MARK) != 0).any())

    words = ipool[0] if with_clip else ti.clipped_words(ipool, clip, cfg.height)
    jpool = [_bwk(words)] + [_bwk(ipool[i]) for i in range(1, 6)]
    jargs = [jnp.asarray(x.numpy()) for x in _bg(out)]
    jclip = jvp = None
    if with_clip:
        jclip = {k: _bwk(clip[k]) for k in ti.CLIP_FIELDS}
        jclip["cnt"] = jnp.asarray(clip["cnt"].numpy())
        jvp = (_bwk(ipool[6]), _bwk(ipool[7]))
    want = jax_composite(jl, cfg, jpool, jnp.asarray(icnt.numpy()), *jargs,
                         clip=jclip, vp=jvp, interpret=True)

    before = ti.composite_items.launches
    got = ti.composite_items(tl, cfg, ipool, icnt, *_bg(out), clip=clip)
    assert ti.composite_items.launches == before    # CPU: the plain version
    for name, g, w in zip(("idx", "ld", "rgb"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    # the items drew something, and the clip moved some sprite bounds
    assert int((got[0] != out["idx"]).sum()) > 100
    assert bool((ti.clipped_words(ipool, clip, cfg.height) != ipool[0]).any())


@pytest.mark.parametrize("max_visible", [0, 2])
def test_deferred_pass_equals_jax(scene, cfg, max_visible):
    jl, tl, poses, p, frame, order, out = scene
    cfg = dataclasses.replace(cfg, item_capacity=8,
                              max_visible_mobjs=max_visible)
    jn = lambda x: jnp.asarray(x.numpy())
    ld = out["ld"]

    def run(level, j, paint, idx, light, dist, sky, rgb):
        jframe = jcam.build_seg_frame(level, cfg, j["px"], j["py"],
                                      j["angle"], j["floor_height"],
                                      j["sector_light"], j["timestamp"])
        jorder = jcam.seg_order(level,
                                jcam.traversal_rank(level, j["px"], j["py"]))
        return jorder, jthings.deferred_pass(
            level, cfg, jframe, jthings.pools_from_paint(paint), jorder,
            j["px"], j["py"], j["angle"], j["floor_height"],
            j["sector_light"], j["mobj_state"], idx, light, dist, sky,
            rgb=rgb)

    paint = {"clippool": tuple(jn(x) for x in out["clippool"]),
             "midpool": tuple(jn(x) for x in out["midpool"]),
             "cnt_clip": jn(out["cnt_clip"]), "cnt_mid": jn(out["cnt_mid"])}
    jorder, (jidx, jlight, jdist, jsky, jaux) = jax.jit(run)(
        jl, {k: jnp.asarray(v) for k, v in poses.items()}, paint,
        jn(out["idx"]), jn((ld >> 16) & 0xFF), jn(((ld & 0xFFFF) << 16) >> 16),
        jn((ld & tp.LD_SKY) != 0), jn(out["rgb"]))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))

    idx, ld2, rgb, daux = tthings.deferred_pass(
        tl, cfg, frame, tthings.pools_from_paint(out), order, p["px"],
        p["py"], p["angle"], p["floor_height"], p["sector_light"],
        p["mobj_state"], *_bg(out))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jaux["rgb"]))
    np.testing.assert_array_equal(((ld2 >> 16) & 0xFF).numpy(),
                                  np.asarray(jlight))
    np.testing.assert_array_equal((((ld2 & 0xFFFF) << 16) >> 16).numpy(),
                                  np.asarray(jdist))
    np.testing.assert_array_equal(((ld2 & tp.LD_SKY) != 0).numpy(),
                                  np.asarray(jsky))
    for k in ("items_dropped", "item_overflow"):
        np.testing.assert_array_equal(daux[k].numpy(), np.asarray(jaux[k]), k)
    dropped = int(daux["items_dropped"].sum())
    assert (dropped > 0) == (max_visible > 0)
    assert int((idx != out["idx"]).sum()) > 100


def test_wrapper_takes_plain_version_on_cpu_only(scene, cfg):
    *_, out = scene
    tl = scene[1]
    pools, ipool, icnt, _ = _port_pool(scene, cfg)
    before = ti.composite_items.launches
    a = ti.composite_items(tl, cfg, ipool, icnt, *_bg(out), clip=pools[0])
    b = ti.composite_items_reference(tl, cfg, ipool, icnt, *_bg(out),
                                     clip=pools[0])
    assert ti.composite_items.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    meta = [x.to("meta") for x in _bg(out)]
    with pytest.raises(ValueError):                # pool on cpu, frame on meta
        ti.composite_items(tl, cfg, ipool, icnt, *meta)
    with pytest.raises(ValueError):
        ti.composite_items(tl, cfg, ipool.to(torch.int64), icnt, *_bg(out))
    with pytest.raises(ValueError):                # the clip needs vpx / vpy
        ti.composite_items(tl, cfg, ipool[:6], icnt, *_bg(out), clip=pools[0])


def test_shade_rounds_as_jax(scene, cfg):
    """light / 255 in the item shade is the multiply by f32(1 / 255)
    that XLA makes of it (one ulp off the IEEE quotient for many light
    levels): one item pixel whose shaded byte differs between the two
    forms, through both composites."""
    from doomtpu.ops.pallas_items import composite_items as jax_composite

    jl, tl, *_ = scene
    cfg = dataclasses.replace(cfg, width=128, height=8, item_capacity=8)
    rows = tl.atlas_rows
    row0 = tl.atlas_cm.reshape(-1, rows)[:, 0].numpy()
    cols = np.nonzero(row0 & 0x100)[0]
    chans = (tl.palette_packed.numpy()[row0[cols] & 0xFF, None]
             >> np.array([16, 8, 0])) & 0xFF                # [cols, 3]
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
    B, W, H = 4, cfg.width, cfg.height
    ipool = torch.zeros((ti.ITEM_PLANES, B, 8, W), dtype=torch.int32)
    ipool[0, 0, 0, 0] = (1 << 16) | 1               # rows [0, 0]
    ipool[1, 0, 0, 0] = col
    ipool[2, 0, 0, 0] = 1 << 16                     # by 1, ty 0
    ipool[3, 0, 0, 0] = 1                           # off_y 0, th 1: row 0
    ipool[4, 0, 0, 0] = (lv << 16) | zv
    icnt = torch.zeros((B, W), dtype=torch.int32)
    icnt[0, 0] = 1
    bg = lambda: [torch.zeros((B, H, W), dtype=torch.int32) for _ in range(3)]
    got = ti.composite_items(tl, cfg, ipool, icnt, *bg())
    want = jax_composite(jl, cfg, [_bwk(ipool[i]) for i in range(6)],
                         jnp.asarray(icnt.numpy()),
                         *[jnp.asarray(x.numpy()) for x in bg()],
                         interpret=True)
    for name, g, w in zip(("idx", "ld", "rgb"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    assert int(got[0][0, 0, 0]) == int(row0[col] & 0xFF)


def test_item_pool_chunks_agree(scene, cfg):
    """Stages 1-4 over one camera at a time give the pool of one pass
    over the batch: no camera's pool depends on another's."""
    _, tl, _, p, frame, order, out = scene
    pools, ipool, icnt, daux = _port_pool(scene, cfg)
    for b in range(len(VIEWS)):
        cut = lambda d: {k: v[b:b + 1] for k, v in d.items()}
        one = tthings.item_pool(
            tl, cfg, cut(frame), (cut(pools[0]), cut(pools[1])),
            order[b:b + 1], *(p[k][b:b + 1] for k in (
                "px", "py", "angle", "floor_height", "sector_light",
                "mobj_state")))
        assert torch.equal(one[0], ipool[:, b:b + 1])
        assert torch.equal(one[1], icnt[b:b + 1])
        for k in ("items_dropped", "item_overflow", "item_peak"):
            assert torch.equal(one[2][k], daux[k][b:b + 1]), k


@pytest.mark.parametrize("ki, kc", [(8, 0), (24, 64)])
def test_items_tile_fits_every_height(ki, kc):
    """The item kernel's tile (ops/items.items_tile): at every height up
    to 1200 rows, at least one column whose marks, slot rows and staged
    clip records fit the shared memory a Hopper block may use, within
    the block's threads; 32 columns at 200 rows."""
    for H in range(1, 1201):
        tc, bands = ti.items_tile(H, ki, kc)
        assert tc >= 1 and bands >= 1, H
        assert 4 * tc * (H + 2 * ki + 5 * kc) <= tp.SMEM_BLOCK_BYTES, H
        assert tc * bands <= ti.MAX_BLOCK_THREADS, H
    assert ti.items_tile(200, ki, kc)[0] >= 32


def test_item_pool_emits_from_item_packs_pack(scene, cfg, monkeypatch):
    """item_pool and item_pack read one pack: the pack the deferred pass
    hands the emission equals the item pass's, field by field."""
    _, tl, _, p, frame, order, out = scene
    cfg = dataclasses.replace(cfg, item_capacity=8)
    args = (p["px"], p["py"], p["angle"], p["floor_height"],
            p["sector_light"], p["mobj_state"])
    seen = []

    def spy(level, cfg_, pack, mid):
        seen.append(pack)
        return te.emit(level, cfg_, pack, mid)
    monkeypatch.setattr(tthings, "emit", spy)
    pools = tthings.pools_from_paint(out)
    _, _, daux = tthings.item_pool(tl, cfg, frame, pools, order, *args)
    pack, aux = tthings.item_pack(tl, cfg, frame, order, *args)
    assert len(seen) == 1
    for k, rows in (("i", tip.IPI_ROWS), ("f", tip.IPF_ROWS)):
        assert seen[0][k].dtype == pack[k].dtype, k
        bits = lambda t: t.view(torch.int32)        # NaN words compare too
        for r in range(rows):
            assert torch.equal(bits(seen[0][k])[..., r],
                               bits(pack[k])[..., r]), (k, r)
    assert torch.equal(daux["items_dropped"], aux["items_dropped"])
    # both kinds of item are in the pack
    fl = pack["i"][..., 0]
    assert bool(((fl & 3) == 3).any()) and bool(((fl & 3) == 1).any())


def test_emit_takes_plain_version_on_cpu_and_checks(scene, cfg):
    _, tl, _, p, frame, order, out = scene
    pack, _ = tthings.item_pack(
        tl, cfg, frame, order, p["px"], p["py"], p["angle"],
        p["floor_height"], p["sector_light"], p["mobj_state"])
    mid = tthings.pools_from_paint(out)[1]
    before = te.emit.launches
    got = te.emit(tl, cfg, pack, mid)
    want = te.emit_reference(tl, cfg, pack, mid)
    assert te.emit.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    bad = [
        (dict(pack, i=pack["i"].long()), mid),                     # dtype
        (dict(pack, f=pack["f"][..., :-1].contiguous()), mid),     # shape
        (pack, dict(mid, d3=mid["d3"][:, :-1])),                   # shape
        (pack, dict(mid, cnt=mid["cnt"][:, :-1])),                 # width
        (pack, dict(mid, span=mid["span"].to("meta"))),            # device
        ({k: v.to("meta") for k, v in pack.items()},
         {k: v.to("meta") for k, v in mid.items()}),               # no kernel
    ]
    for bp, bm in bad:
        with pytest.raises(ValueError):
            te.emit(tl, cfg, bp, bm)
    assert te.emit.launches == before


@pytest.mark.parametrize("W, N, KI, G", [
    (320, 320, 24, 736), (1024, 320, 24, 736), (32, 64, 1, 1),
    (320, 320, 24, 60_000), (320, 20_000, 24, 736)])
def test_emit_block_fits(W, N, KI, G):
    """The emission block (ops/emit.emit_block): whole warps, within the
    kernel's threads and the shared memory a Hopper block may use; the
    seg -> item table where it fits, a warp of columns a thread each at
    e1m1 scale (320 columns at 320 items, KI 24, 736 segs)."""
    threads, table = te.emit_block(W, N, KI, G)
    assert threads % 32 == 0 and 32 <= threads <= te.MAX_BLOCK_THREADS
    assert te.emit_smem_bytes(threads, N, KI, G, table) <= tp.SMEM_BLOCK_BYTES
    assert threads <= -(-W // 32) * 32
    if (W, N, G) == (320, 320, 736):
        assert (threads, table) == (320, True)
    if G == 60_000:
        assert not table
