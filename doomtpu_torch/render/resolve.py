"""Per-pixel resolve: the unified span pool -> the idx, ld and rgb
frames of the scan + resolve pipeline.

Counterpart of doomtpu/render/resolve.py (resolve_frame, shade), which
the JAX package computes in XLA, outside any kernel.  The wall scan
(render/walls.py) computed every slot's draw parameters; the resolve
finds each pixel's winning slot, fetches one texel and shades it:

- the winner fold: walls draw during the scan and planes after, so a
  plane beats a wall and a later slot beats an earlier one.  The port
  finds one winner slot per pixel for walls and one for planes and
  reads the data planes at the winners once, where the JAX fold carries
  seven [B, H, W] i32 accumulators through all K slots: the same values,
  with work and memory that follow the covered rows;
- walls: linear v from the slot's full bottom/top edges
  (bitmap_render.rs:213-276), u came from the scan;
- floors/ceilings: per-pixel inverse projection into the 64x64 flat
  (visplanes.rs:103-129); sky: angle-scrolled (visplanes.rs:42-80);
- one fetch from the column atlas when the sky is opaque, else the
  masked-sky fetch (a transparent sky texel shows the wall drawn
  earlier);
- the shade, and the ld word the paint kernel writes (`pack_ld`), so
  the deferred pass takes the same (idx, ld, rgb) frames from both
  pipelines.  JAX composites the items over (idx, light, dist, is_sky)
  and then shades; the item kernel shades the pixels it writes with the
  same arithmetic, so shading first gives the same bits.

`resolve_frame` launches the hand-written CUDA kernel on CUDA tensors
(ops/resolve.py, csrc/resolve.cu: one pass, no [B, H, W] temporaries)
and runs `resolve_reference`, its plain PyTorch version, on CPU tensors.

Arithmetic follows the jitted JAX functions: a division by a constant
is a multiply by its f32 reciprocal (jmath.div_const), a division by a
tensor a true IEEE division (jmath.fdiv).  The winner fold is exact when
every solid / lower / upper wall-piece texture is opaque
(DeviceLevel.wall_tex_all_opaque, which warns at build otherwise); the
JAX package shares that limit.
"""

from __future__ import annotations

import math

import torch

from doomtpu_torch.config import (
    ASPECT_RATIO_CORRECTION, FLAT_SIZE, PLAYER_EYE_HEIGHT, SKY_TEXTURE_HEIGHT,
    SKY_TEXTURE_WIDTH, RenderConfig,
)
from doomtpu_torch.ops import resolve as kernel
from doomtpu_torch.ops.layout import (
    KIND_CEIL, KIND_FLOOR, KIND_WALL, LD_SKY, LD_WRITTEN, unpack_span,
)
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    F32, I32, as_i16, div_const, div_trunc, f32, fdiv, reciprocal, rem_trunc,
    rotate, smul, wrap_tex,
)
from doomtpu_torch.trace import span, spanned


def unpack16_hi(v):
    return v >> 16  # arithmetic shift keeps the sign


def unpack16_lo(v):
    return (v << 16) >> 16  # sign-extend the low half


def _winners(lo, hi, ok, H: int):
    """[B, H, W] i32: per pixel, the last slot k with ok[:, k] whose rows
    lo[:, k] <= y <= hi[:, k] ([B, K, W], within [0, H)) cover it, else
    -1.  Each covering (slot, row) pair is listed once and the slot ids
    are scatter-maxed into the pixels: the work follows the rows the
    slots cover, not K full frames."""
    B, K, W = lo.shape
    dev = lo.device
    length = torch.where(ok, hi - lo + 1, 0).clamp(min=0).reshape(-1)
    with span("doom.sync"):          # the host reads the list's length
        total = int(length.sum())
    slot = torch.repeat_interleave(                  # (b, k, w) per pair
        torch.arange(length.numel(), device=dev), length, output_size=total)
    first = torch.cumsum(length, 0) - length
    y = lo.reshape(-1)[slot] + (torch.arange(total, device=dev) - first[slot])
    del first
    w, k, b = slot % W, (slot // W) % K, slot // (K * W)
    del slot
    win = torch.full((B * H * W,), -1, dtype=I32, device=dev)
    win.scatter_reduce_(0, (b * H + y) * W + w, k.to(I32), "amax")
    return win.view(B, H, W)


@spanned("doom.resolve")
def resolve_frame(
    level: DeviceLevel,
    cfg: RenderConfig,
    frame: dict,
    pool, cnt,
    px, py, angle, floor_height,      # player state [B]
    trig=None,                        # the angles' trig bundle
):
    """Walls + planes + sky, shaded -> (idx, ld, rgb), each [B, H, W] i32:
    palette indices (-1 unwritten), the ld words (`pack_ld`) and the
    packed 0xRRGGBB shade (0 where unwritten).  The kernel's per-camera
    trig is `trig`'s (ops/resolve.py::camera_scalars).

    pool is render/walls.wall_scan's (spans, [d1..d6]), each a [B, W, K]
    view of a slot-major [B, K, W] store; slots at or past cnt [B, W]
    are never read.  CUDA tensors launch the kernel (ops/resolve.py);
    CPU tensors run `resolve_reference`.  Anything else raises."""
    kernel.check_inputs(level, cfg, pool, cnt, px, py, angle, floor_height)
    if cnt.device.type == "cpu":
        return resolve_reference(level, cfg, frame, pool, cnt, px, py, angle,
                                 floor_height)
    if cnt.device.type != "cuda":
        raise ValueError(f"resolve: no kernel for device {cnt.device}")
    camf, cami = kernel.camera_scalars(angle, px, py, floor_height, trig)
    return kernel.resolve(level, cfg, pool, cnt, camf, cami)


def resolve_reference(level: DeviceLevel, cfg: RenderConfig, frame: dict,
                      pool, cnt, px, py, angle, floor_height):
    """The plain PyTorch resolve: `resolve_frame`'s arguments and
    outputs, the same bits, from [B, H, W] tensor operations (the winner
    fold, the texel fetch, the shade, the ld packing)."""
    kernel.check_inputs(level, cfg, pool, cnt, px, py, angle, floor_height)
    idx, light, dist, is_sky = _resolve_fields(level, cfg, pool, cnt, px,
                                               py, angle, floor_height)
    rgb = shade(level, idx, light, dist, is_sky)
    return idx, pack_ld(idx, light, dist, is_sky), rgb


def _resolve_fields(level: DeviceLevel, cfg: RenderConfig, pool, cnt,
                    px, py, angle, floor_height):
    """The plain resolve before the shade: (idx, light, dist, is_sky),
    each [B, H, W], as JAX's resolve_frame returns them."""
    spans, (d1, d2, d3, d4, d5, _) = pool
    B, W, K = spans.shape
    H = cfg.height
    dev = spans.device
    TW = level.tex_pixels.shape[2]
    ROWS = level.atlas_rows
    sm = lambda t: t.transpose(1, 2)                          # [B, K, W]
    yy = torch.arange(H, dtype=I32, device=dev)[None, :, None]

    s = sm(spans)
    kind, y0, y1 = unpack_span(s)
    valid_k = torch.arange(K, dtype=I32, device=dev)[None, :, None] \
        < cnt[:, None, :]
    wall_ok = valid_k & (kind == KIND_WALL) & (s >= 0)  # bit 31: no texture
    plane_ok = valid_k & ((kind == KIND_FLOOR) | (kind == KIND_CEIL))

    # ---------------- winner slots per pixel ---------------------------------
    lo, hi = torch.clamp(y0, min=0), torch.clamp(y1, max=H - 1)
    w_win = _winners(lo, hi, wall_ok, H)
    p_win = _winners(lo, hi, plane_ok, H)
    del lo, hi

    def gather_at(win, planes, empties):
        """The planes' values at each pixel's winner slot, `empty` where
        no slot covers the pixel."""
        has = win >= 0
        ix = torch.clamp(win, min=0).long()
        return [torch.where(has, torch.gather(sm(p), 1, ix), e)
                for p, e in zip(planes, empties)]

    A1, A2, A3, A4, A5 = gather_at(w_win, (d1, d2, d3, d4, d5),
                                   (-1, 0, 0, 0, 0))
    P1, P2 = gather_at(p_win, (d1, d2), (-1, 0))
    # the dels below free each [B, H, W] temporary once it is dead: the
    # resolve's peak at B=4096 is tens of GiB
    del w_win, p_win
    has_wall = A1 >= 0
    has_plane = P1 >= 0

    # ---------------- wall texel index per pixel ----------------------------
    by_p = unpack16_hi(A2)
    tyl_p = unpack16_lo(A2)
    off_y_p = unpack16_hi(A3)
    th_p = unpack16_lo(A3)
    light_w = unpack16_hi(A4)
    dist_w = unpack16_lo(A4)
    uy1_p = A5.view(F32)
    ay = fdiv(f32(yy - tyl_p), f32(by_p - tyl_p))
    tyv = as_i16(f32(th_p) + smul(ay, uy1_p)) + off_y_p
    tyv = wrap_tex(tyv, torch.clamp(th_p, min=1), pow2=level.tex_sizes_pow2)
    wall_index = torch.clamp(A1, min=0) * ROWS + tyv
    del A2, A3, A4, A5, ay, tyv, by_p, tyl_p, off_y_p, th_p, uy1_p

    # ---------------- plane texel index per pixel ---------------------------
    light_p = P1 >> 22
    is_sky = (((P1 >> 21) & 1) != 0) & has_plane
    pflat_p = (P1 >> 8) & 0x1FFF
    pheight_p = unpack16_hi(P2)

    xxw = torch.arange(W, dtype=I32, device=dev)[None, None, :]
    vx = div_const(cfg.camera_focus_x - f32(xxw), ASPECT_RATIO_CORRECTION)
    vy = cfg.camera_focus_y - f32(yy)
    wz = (f32(pheight_p) - f32(floor_height)[:, None, None]) \
        - float(f32(PLAYER_EYE_HEIGHT))
    wx = fdiv(wz * float(f32(cfg.game_camera_focus_x)), vy)
    wy = fdiv(wz * vx, vy)
    rx, ry = rotate(wx, wy, f32(angle)[:, None, None])
    ftx = (as_i16(rx) + as_i16(f32(px))[:, None, None]) & (FLAT_SIZE - 1)
    fty = (as_i16(ry) + as_i16(f32(py))[:, None, None]) & (FLAT_SIZE - 1)
    flat_index = (
        level.col_flat_off + pflat_p * FLAT_SIZE + ftx
    ) * ROWS + fty
    plane_dist = as_i16(wx)
    del wz, wx, wy, rx, ry, ftx, fty, pflat_p, pheight_p, P2

    # ---------------- sky texel index (visplanes.rs:42-80) -----------------
    stw, sth = SKY_TEXTURE_WIDTH, SKY_TEXTURE_HEIGHT
    tx_off = as_i16(div_const(f32(angle) * -float(stw), math.pi / 2.0)) + stw
    tx_off = torch.where(
        tx_off < 0, tx_off + stw * (1 - div_trunc(tx_off, stw)), tx_off
    )[:, None, None]
    stx = rem_trunc(
        as_i16((f32(xxw) * float(stw)) * reciprocal(W)) + tx_off, stw)
    sty = as_i16(((f32(yy) * float(sth)) * 2.0) * reciprocal(H))
    sty = rem_trunc(torch.where(sty < 0, sty + sth, sty), sth)
    sky_index = (level.sky_tex * TW + stx) * ROWS + sty       # [B, H, W]

    # ---------------- unified texel fetch -----------------------------------
    use_plane = has_plane & ~is_sky
    n_atlas = level.atlas_cm.numel()
    clipix = lambda ix: level.atlas_cm[torch.clamp(ix, 0, n_atlas - 1).long()]

    if level.sky_is_opaque:
        # single gather: plane / sky / wall are mutually exclusive sources
        index = torch.where(
            use_plane, flat_index, torch.where(is_sky, sky_index, wall_index))
        del flat_index, wall_index
        packed = clipix(index)
        del index
        texel = packed & 0xFF
        opaque = (packed & 0x100) != 0
        use_sky = is_sky
        use_wall = has_wall & opaque & ~has_plane
        use_plane_px = use_plane & opaque
        idx = torch.where(use_wall | use_plane_px | use_sky, texel, -1)
        from_plane = use_plane_px | use_sky
        light = torch.where(from_plane, light_p, light_w)
        dist = torch.where(from_plane, plane_dist, dist_w)
        return idx.to(I32), light, dist, use_sky

    # masked sky: transparent sky texels show the wall drawn earlier
    index = torch.where(use_plane, flat_index, wall_index)
    packed = clipix(index)
    texel = packed & 0xFF
    opaque = (packed & 0x100) != 0
    sky_packed = clipix(sky_index)
    sky_opaque = (sky_packed & 0x100) != 0

    use_sky = is_sky & sky_opaque
    use_wall = has_wall & opaque & ~has_plane & ~use_sky
    use_plane_px = use_plane & opaque
    under_sky_wall = is_sky & ~sky_opaque & has_wall & opaque

    idx = torch.full((B, H, W), -1, dtype=I32, device=dev)
    idx = torch.where(use_wall, texel, idx)
    idx = torch.where(under_sky_wall, texel, idx)
    idx = torch.where(use_plane_px, texel, idx)
    idx = torch.where(use_sky, sky_packed & 0xFF, idx)

    from_plane = use_plane_px | use_sky
    light = torch.where(from_plane, light_p, light_w)
    light = torch.where(under_sky_wall, light_w, light)
    dist = torch.where(from_plane, plane_dist, dist_w)
    dist = torch.where(under_sky_wall, dist_w, dist)
    return idx, light, dist, use_sky


def pack_ld(idx, light, dist, is_sky):
    """The ld frame the paint kernel writes and the item kernel reads:
    light(8) << 16 | dist(u16) | written << 24 | sky << 25."""
    return ((light << 16) | (dist & 0xFFFF)
            | ((idx >= 0).to(I32) * LD_WRITTEN) | (is_sky.to(I32) * LD_SKY))


@spanned("doom.resolve")
def shade(level: DeviceLevel, idx, light, dist, is_sky):
    """Palette lookup + light diminish (bitmap_render.rs:190-208) ->
    packed 0xRRGGBB i32 per pixel, 0 where idx < 0.  light / 255 is a
    multiply by f32(1/255), as the jitted JAX shade computes it."""
    factor = f32(light) * reciprocal(255.0) - smul(f32(dist), 1.0 / 4096.0)
    with span("doom.sync"):          # each upload waits for the device
        zero, one = (torch.tensor(v, dtype=F32, device=idx.device)
                     for v in (0.0, 1.0))
    factor = torch.where(is_sky, one, torch.maximum(factor, zero))
    pal = level.palette_packed[torch.clamp(idx, min=0).long()]
    packed = torch.zeros_like(idx)
    for shift in (16, 8, 0):
        # Rust `as u8`: trunc toward zero, saturate to [0, 255]
        chan = f32((pal >> shift) & 0xFF)
        byte = torch.clamp(torch.trunc(chan * factor), 0.0, 255.0).to(I32)
        packed = packed | (byte << shift)
    return torch.where(idx >= 0, packed, 0)
