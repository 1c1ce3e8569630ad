"""The scan + resolve pipeline's stages: the port's wall scan, resolve,
shade and unified pools (through the deferred pass) against the JAX
package's, on the CPU, where the port runs the kernels' plain versions
(the CUDA wall-scan kernel against its plain version is in
tests/test_torch_cuda.py).

The JAX side runs jitted (its divisions by constants become multiplies
by f32 reciprocals there, and the port copies that), once per
configuration, in module fixtures.  Inputs: the demo fixture at B=8
(four views of tests/test_paint.py and four spread poses) at 160x100,
and the e1m1-scale-masked fixture (e1m1-scale with GRATE on a quarter
of its one-sided walls) at B=4.

Tolerance: exact equality.  The span pool is compared in every plane at
every slot below a column's count; slots at or past it hold no record
and are never read (the resolve and the item pool mask them), so they
may differ.
"""

import dataclasses
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from doomtpu.assets.bundle import LevelAssets as JaxAssets  # noqa: E402
from doomtpu.config import RenderConfig  # noqa: E402
from doomtpu.level.tables import MapTables as JaxTables  # noqa: E402
from doomtpu.render import camera as jcam  # noqa: E402
from doomtpu.render import resolve as jres  # noqa: E402
from doomtpu.render import things as jthings  # noqa: E402
from doomtpu.render import walls as jwalls  # noqa: E402
from doomtpu.render.device import DeviceLevel as JaxLevel  # noqa: E402
from doomtpu.wad.reader import WadFile as JaxWad  # noqa: E402
from doomtpu_torch.ops import items as ti  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.ops import resolve as tkernel  # noqa: E402
from doomtpu_torch.ops import scan as ts  # noqa: E402
from doomtpu_torch.render import camera as tcam  # noqa: E402
from doomtpu_torch.render import frame as tframe  # noqa: E402
from doomtpu_torch.render import resolve as tres  # noqa: E402
from doomtpu_torch.render import things as tthings  # noqa: E402
from doomtpu_torch.render import walls as twalls  # noqa: E402
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


CFG = RenderConfig(width=160, height=100, span_capacity=16, mid_capacity=16,
                   clip_capacity=32, item_capacity=16)
VIEWS = [(384.0, 256.0, 0.0), (900.0, 256.0, 2.5), (300.0, 700.0, 4.6),
         (384.0, 256.0, 3.1)]


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


def _poses(t, views, mobj_state):
    """(px, py, angle, floor_h, sector_light, mobj_state, timestamp) as
    numpy, the map objects in their spawn states."""
    B = len(views)
    f = lambda xs: np.asarray(xs, np.float32)
    return (
        f([v[0] for v in views]), f([v[1] for v in views]),
        f([v[2] for v in views]),
        f([float(t.sector_floor_h[t.sector_at(v[0], v[1])]) for v in views]),
        np.repeat(np.asarray(t.sector_light, np.int32)[None], B, 0),
        np.repeat(mobj_state[None], B, 0),
        np.full(B, 0.4, np.float32),
    )


class Fixture:
    def __init__(self, t, a, info, views):
        with warnings.catch_warnings():
            # a masked wall texture warns at build; its own test is
            # test_level_warns_on_transparent_wall_textures
            warnings.simplefilter("ignore", UserWarning)
            self.jl = JaxLevel.build(t, a, info)
            self.tl = DeviceLevel.build(t, a, info, "cpu")
        self.t, self.a, self.info = t, a, info
        self.np = _poses(t, views, np.asarray(self.tl.mobj_spawn_state))
        self.torch = tuple(torch.from_numpy(x) for x in self.np)

    def port_frame(self, cfg):
        px, py, pa, fh, sl, _, tsm = self.torch
        frame = tcam.build_seg_frame(self.tl, cfg, px, py, pa, fh, sl, tsm)
        order = tcam.seg_order(self.tl, tcam.traversal_rank(self.tl, px, py))
        return frame, order


def _load(wad_bytes, info):
    wad = JaxWad(wad_bytes)
    t = JaxTables.load(wad, "E1M1")
    return t, JaxAssets.load(wad, t, info.sprite_names)


@pytest.fixture(scope="module")
def demo(demo_level):
    t, a, info = demo_level.tables, demo_level.assets, demo_level.info
    return Fixture(t, a, info, VIEWS + _spread(t, 4, seed=1))


@pytest.fixture(scope="module")
def masked(info):
    t, a = _load(synth.e1m1_scale_masked_wad(), info)
    return Fixture(t, a, info, _spread(t, 4, seed=2))


def _jax_scan(fx, cfg):
    def run(level, px, py, pa, fh, sl, ms, tsm):
        frame = jcam.build_seg_frame(level, cfg, px, py, pa, fh, sl, tsm)
        order = jcam.seg_order(level, jcam.traversal_rank(level, px, py))
        return jwalls.wall_scan(level, cfg, frame, order)

    return jax.jit(run)(fx.jl, *map(jnp.asarray, fx.np))


def _jax_resolve(level, cfg, pool, cnt, poses):
    def run(level, pool, cnt, px, py, pa, fh):
        out = jres.resolve_frame(level, cfg, None, pool, cnt, px, py, pa, fh)
        return out + (jres.shade(level, *out),)

    px, py, pa, fh = map(jnp.asarray, poses[:4])
    return jax.jit(run)(level, pool, cnt, px, py, pa, fh)


@pytest.fixture(scope="module")
def jax_demo(demo):
    """The JAX pipeline on the demo, jitted once: scan, resolve, shade,
    the deferred pass over the unified pools, the final shade."""
    cfg = CFG

    def run(level, px, py, pa, fh, sl, ms, tsm):
        frame = jcam.build_seg_frame(level, cfg, px, py, pa, fh, sl, tsm)
        order = jcam.seg_order(level, jcam.traversal_rank(level, px, py))
        pool, cnt, ovf = jwalls.wall_scan(level, cfg, frame, order)
        idx, light, dist, sky = jres.resolve_frame(
            level, cfg, frame, pool, cnt, px, py, pa, fh)
        rgb = jres.shade(level, idx, light, dist, sky)
        idx2, light2, dist2, sky2, daux = jthings.deferred_pass(
            level, cfg, frame, jthings.pools_from_unified(pool, cnt), order,
            px, py, pa, fh, sl, ms, idx, light, dist, sky)
        return {
            "pool": pool, "cnt": cnt, "overflow": ovf,
            "idx": idx, "light": light, "dist": dist, "is_sky": sky,
            "rgb": rgb, "idx2": idx2, "light2": light2, "dist2": dist2,
            "is_sky2": sky2, "rgb2": jres.shade(level, idx2, light2, dist2,
                                                sky2),
            "items_dropped": daux["items_dropped"],
            "item_overflow": daux["item_overflow"],
        }

    out = jax.jit(run)(demo.jl, *map(jnp.asarray, demo.np))
    return jax.tree_util.tree_map(np.asarray, out)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_pool_equal(got, want):
    """Port (pool, cnt, overflow) == JAX's at every slot below cnt."""
    (g_sp, g_d), g_cnt, g_ovf = got
    (w_sp, w_d), w_cnt, w_ovf = want
    np.testing.assert_array_equal(_np(g_cnt), _np(w_cnt))
    np.testing.assert_array_equal(_np(g_ovf), _np(w_ovf))
    cnt = _np(w_cnt)
    K = np.shape(w_sp)[2]
    below = np.arange(K)[None, None] < cnt[..., None]
    for i, (g, w) in enumerate(zip([g_sp] + list(g_d), [w_sp] + list(w_d))):
        assert tuple(g.shape) == np.shape(w), i
        np.testing.assert_array_equal(np.where(below, _np(g), 0),
                                      np.where(below, _np(w), 0), f"plane {i}")
    return cnt


def test_span_helpers_equal_jax():
    rng = np.random.default_rng(0)
    kind = rng.integers(0, 4, 64).astype(np.int32)
    y0, y1 = (rng.integers(-300, 600, 64).astype(np.int32) for _ in range(2))
    t = lambda x: torch.from_numpy(x)
    span = twalls.pack_span(t(kind), t(y0), t(y1))
    np.testing.assert_array_equal(
        span.numpy(), np.asarray(jwalls.pack_span(jnp.asarray(kind),
                                                  jnp.asarray(y0),
                                                  jnp.asarray(y1))))
    for g, w in zip(twalls.unpack_span(span),
                    jwalls.unpack_span(jnp.asarray(span.numpy()))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        twalls.pack16(t(y0), t(y1)).numpy(),
        np.asarray(jwalls.pack16(jnp.asarray(y0), jnp.asarray(y1))))
    for name in ("KIND_WALL", "KIND_FLOOR", "KIND_CEIL", "KIND_MID",
                 "N_PLANES", "SPAN_E2T", "SPAN_E2B", "SPAN_DC",
                 "SPAN_NODRAW"):
        assert getattr(twalls, name) == getattr(jwalls, name), name


@pytest.mark.parametrize("case", ["demo-K16", "demo-K4", "masked-K64"])
def test_wall_scan_equals_jax(case, demo, masked, jax_demo):
    if case == "demo-K16":
        fx, cfg = demo, CFG
        want = ((jax_demo["pool"][0], jax_demo["pool"][1]), jax_demo["cnt"],
                jax_demo["overflow"])
    else:
        fx = demo if case == "demo-K4" else masked
        cfg = dataclasses.replace(CFG, span_capacity=int(case.split("K")[1]))
        want = _jax_scan(fx, cfg)
    frame, order = fx.port_frame(cfg)
    before = ts.scan.launches
    got = twalls.wall_scan(fx.tl, cfg, frame, order)
    assert ts.scan.launches == before            # CPU: the plain version
    cnt = _assert_pool_equal(got, want)
    ovf = _np(got[2])
    if case == "demo-K4":
        assert ovf.sum() > 0 and cnt.max() == 4
    else:
        assert ovf.sum() == 0
    # every kind of record is there
    below = np.arange(cfg.span_capacity)[None, None] < cnt[..., None]
    kinds = set(((_np(got[0][0]) >> 29) & 3)[below].tolist())
    assert kinds == {0, 1, 2, 3}, kinds


def _slot_major(pool):
    """A [B, W, K] pool (JAX's layout) as [B, W, K] views of slot-major
    [B, K, W] stores, the layout of the port's wall scan."""
    t = lambda x: torch.from_numpy(
        np.ascontiguousarray(np.swapaxes(np.asarray(x), 1, 2))
    ).transpose(1, 2)
    return t(pool[0]), [t(p) for p in pool[1]]


def _port_resolve(fx, cfg, level, pool, cnt):
    """The port's resolve_frame on a JAX pool: (idx, ld, rgb)."""
    px, py, pa, fh = fx.torch[:4]
    return tres.resolve_frame(level, cfg, None, _slot_major(pool),
                              torch.from_numpy(np.array(cnt)), px, py, pa, fh)


def _decoded(out):
    """(idx, light, dist, is_sky, rgb) of resolve_frame's (idx, ld, rgb)."""
    idx, ld, rgb = out
    d = tframe._decoded(ld)
    return idx, d["light"], d["dist"], d["is_sky"], rgb


def _assert_resolve_equal(got, want):
    for name, g, w in zip(("idx", "light", "dist", "is_sky", "rgb"),
                          _decoded(got), want):
        assert g.dtype == (torch.bool if name == "is_sky" else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


def test_resolve_and_shade_equal_jax(demo, jax_demo):
    """The port's resolve_frame and shade on the JAX pool."""
    j = jax_demo
    got = _port_resolve(demo, CFG, demo.tl, j["pool"], j["cnt"])
    _assert_resolve_equal(got, [j[k] for k in ("idx", "light", "dist",
                                               "is_sky", "rgb")])
    idx, is_sky = got[0], _decoded(got)[3]
    assert float((idx >= 0).float().mean()) > 0.5 and bool(is_sky.any())


@pytest.fixture(scope="module")
def masked_sky(demo, jax_demo):
    """The demo level with a sky texture of transparent texels, in both
    packages, and JAX's resolve and shade of the demo pool there:
    (port level, JAX's idx, light, dist, is_sky, rgb)."""
    a = demo.a
    mask = np.array(a.tex_mask)
    mask[a.sky_tex, :64, ::2] = False
    a2 = dataclasses.replace(a, tex_mask=mask)
    jl = JaxLevel.build(demo.t, a2, demo.info)
    tl = DeviceLevel.build(demo.t, a2, demo.info, "cpu")
    assert not jl.sky_is_opaque and not tl.sky_is_opaque and not tl.paint_ok
    j = jax_demo
    want = _jax_resolve(jl, CFG, j["pool"], j["cnt"], demo.np)
    return tl, [np.asarray(w) for w in want]


def test_resolve_masked_sky_equals_jax(demo, jax_demo, masked_sky):
    """A sky texture with transparent texels takes the resolve's
    masked-sky fetch in both packages (resolve.py:197-221)."""
    tl, want = masked_sky
    j = jax_demo
    got = _port_resolve(demo, CFG, tl, j["pool"], j["cnt"])
    _assert_resolve_equal(got, want)
    # the transparent sky texels changed the frame
    assert int((got[0].numpy() != j["idx"]).sum()) > 0


@pytest.mark.parametrize("sky", ["opaque", "masked"])
def test_resolve_frame_is_the_shade_and_the_ld_of_the_fields(
        demo, jax_demo, masked_sky, sky):
    """On CPU tensors resolve_frame (the plain version) gives the idx,
    the shade and pack_ld of the resolved fields: JAX's resolve_frame,
    then its shade, and the port's pack_ld of JAX's fields, bit for bit
    in every word (the written and sky bits too)."""
    j = jax_demo
    if sky == "opaque":
        level, want = demo.tl, [j[k] for k in ("idx", "light", "dist",
                                                "is_sky", "rgb")]
    else:
        level, want = masked_sky
    before = tkernel.resolve.launches
    idx, ld, rgb = _port_resolve(demo, CFG, level, j["pool"], j["cnt"])
    assert tkernel.resolve.launches == before      # CPU: the plain version
    t = lambda x: torch.from_numpy(np.array(x))
    np.testing.assert_array_equal(idx.numpy(), want[0])
    np.testing.assert_array_equal(
        ld.numpy(), tres.pack_ld(*map(t, want[:4])).numpy())
    np.testing.assert_array_equal(rgb.numpy(), want[4])
    px, py, pa, fh = demo.torch[:4]
    ref = tres.resolve_reference(level, CFG, None, _slot_major(j["pool"]),
                                 t(j["cnt"]), px, py, pa, fh)
    for g, r in zip((idx, ld, rgb), ref):
        assert torch.equal(g, r)


def test_render_walls_planes_decodes_aux_from_ld(demo, jax_demo):
    """The scan branch of render_walls_planes decodes light, dist and
    is_sky from the resolve's ld frame: JAX's resolved fields, and JAX's
    idx and shade."""
    j = jax_demo
    px, py, pa, fh, sl, _, tsm = demo.torch
    idx, rgb, aux = tframe.render_walls_planes(demo.tl, CFG, px, py, pa, fh,
                                               sl, tsm)
    np.testing.assert_array_equal(idx.numpy(), j["idx"])
    np.testing.assert_array_equal(rgb.numpy(), j["rgb"])
    for k in ("light", "dist", "is_sky"):
        np.testing.assert_array_equal(aux[k].numpy(), j[k], k)


@pytest.fixture(scope="module")
def demo_scan(demo):
    """The port's frame and wall scan of the demo poses: (frame, pool,
    cnt)."""
    frame, order = demo.port_frame(CFG)
    pool, cnt, _ = twalls.wall_scan(demo.tl, CFG, frame, order)
    return frame, pool, cnt


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "layout",
                                   "cnt"])
def test_resolve_wrapper_raises_on_what_the_kernel_does_not_take(
        demo, demo_scan, fault):
    frame, (spans, planes), cnt = demo_scan
    px, py, pa, fh = demo.torch[:4]
    if fault == "dtype":
        spans = spans.to(torch.int64)
    elif fault == "shape":
        px = px[:-1]
    elif fault == "device":
        spans, planes, cnt = (spans.to("meta"), [p.to("meta") for p in planes],
                              cnt.to("meta"))
    elif fault == "layout":       # [B, W, K] contiguous: not slot-major
        spans = spans.contiguous()
    else:
        cnt = cnt.t().contiguous().t()
    with pytest.raises(ValueError):
        tres.resolve_frame(demo.tl, CFG, frame, (spans, planes), cnt, px, py,
                           pa, fh)


def test_unified_pools_through_deferred_pass_equal_jax(demo, jax_demo):
    """pools_from_unified + deferred_pass (item kernel's plain version)
    over the port's own scan and resolve, against JAX deferred_pass over
    its pools_from_unified, then shade."""
    j = jax_demo
    frame, order = demo.port_frame(CFG)
    pool, cnt, _ = twalls.wall_scan(demo.tl, CFG, frame, order)
    px, py, pa, fh, sl, ms, _ = demo.torch
    idx, ld, rgb = tres.resolve_frame(
        demo.tl, CFG, frame, pool, cnt, px, py, pa, fh)
    clip, mid = tthings.pools_from_unified(pool, cnt, frame)

    # plane records sit among the clip records and carry no clip bit
    K = CFG.span_capacity
    below = torch.arange(K)[None, :, None] < cnt[:, None, :]
    kind = (clip["span"] >> 29) & 3
    plane = below & ((kind == 1) | (kind == 2))
    assert int(plane.sum()) > 100
    bits = twalls.SPAN_E2B | twalls.SPAN_E2T | twalls.SPAN_DC
    assert not bool((plane & ((clip["span"] & bits) != 0)).any())

    before = ti.composite_items.launches
    idx2, ld2, rgb2, daux = tthings.deferred_pass(
        demo.tl, CFG, frame, (clip, mid), order, px, py, pa, fh, sl, ms,
        idx.clone(), ld.clone(), rgb.clone())
    assert ti.composite_items.launches == before
    np.testing.assert_array_equal(idx2.numpy(), j["idx2"])
    np.testing.assert_array_equal(rgb2.numpy(), j["rgb2"])
    np.testing.assert_array_equal(((ld2 >> 16) & 0xFF).numpy(), j["light2"])
    np.testing.assert_array_equal((((ld2 & 0xFFFF) << 16) >> 16).numpy(),
                                  j["dist2"])
    np.testing.assert_array_equal(((ld2 & tp.LD_SKY) != 0).numpy(),
                                  j["is_sky2"])
    for k in ("items_dropped", "item_overflow"):
        np.testing.assert_array_equal(daux[k].numpy(), j[k], k)
    assert int((idx2 != idx).sum()) > 100           # the items drew

    # the plane records are inert: put their seg endpoints in front of
    # every sprite, and nothing changes
    far = torch.tensor(-1e6, dtype=torch.float32).view(torch.int32)
    poisoned = dict(clip)
    for k in ("lsx", "lsy", "lex", "ley"):
        poisoned[k] = torch.where(plane, far, clip[k])
    again = tthings.deferred_pass(
        demo.tl, CFG, frame, (poisoned, mid), order, px, py, pa, fh, sl, ms,
        idx.clone(), ld.clone(), rgb.clone())
    for g, w in zip(again[:3], (idx2, ld2, rgb2)):
        assert torch.equal(g, w)


def test_scan_wrapper_takes_plain_version_on_cpu_only(demo):
    frame, order = demo.port_frame(CFG)
    rows, scnt = tp.build_rows(demo.tl, frame, order)
    before = ts.scan.launches
    a = ts.scan(demo.tl, CFG, rows, scnt)
    b = ts.scan_reference(demo.tl, CFG, rows, scnt)
    assert ts.scan.launches == before          # no kernel launched on CPU
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert tuple(a["pool"].shape) == (ts.POOL_PLANES, 8, CFG.span_capacity,
                                      CFG.width)
    with pytest.raises(ValueError):
        ts.scan(demo.tl, CFG, rows.to("meta"), scnt.to("meta"))
    with pytest.raises(ValueError):
        ts.scan(demo.tl, CFG, rows.to(torch.int64), scnt)
    with pytest.raises(ValueError):
        ts.scan(demo.tl, CFG, rows[:, :-1], scnt)


def test_level_warns_on_transparent_wall_textures(single_level):
    """The port's build warns as the JAX build does when a solid wall
    texture has transparent texels, and records the three resolve
    fields."""
    rooms, things = synth.single_room_level()
    for r in rooms:
        r.wall_tex = "GRATE"
    t, a = _load(synth.build_wad(rooms, things), single_level.info)
    with pytest.warns(UserWarning, match="transparent texels"):
        jl = JaxLevel.build(t, a, single_level.info)
    with pytest.warns(UserWarning, match="transparent texels"):
        tl = DeviceLevel.build(t, a, single_level.info, "cpu")
    assert not tl.wall_tex_all_opaque and not tl.paint_ok
    assert (tl.sky_tex, tl.sky_is_opaque, tl.wall_tex_all_opaque) == (
        int(jl.sky_tex), jl.sky_is_opaque, jl.wall_tex_all_opaque)
