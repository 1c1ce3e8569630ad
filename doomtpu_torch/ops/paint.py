"""The paint stage: walls, visplanes and sky drawn at emit time.

Counterpart of doomtpu/ops/pallas_paint.py.  `render_paint` builds the
kernel's inputs from a camera-stage frame (the host side of the JAX
`render_paint`); `paint` launches the hand-written CUDA kernel
(csrc/paint.cu) on CUDA tensors and runs `paint_reference`, its plain
PyTorch version, on CPU tensors.  Both give the same bits.  The seg rows
(`build_rows`) and the per-camera live drop (`live_drop`) are kernels too
(csrc/rows.cu), beside `build_rows_reference` and `live_drop_reference`.

What is computed, per camera and screen column, walking the camera's
active segs front to back with the occlusion state (hor / fo / co):

- wall columns: 1/z-perspective texture u, linear v, texture wrap;
- floor and ceiling spans: per-pixel inverse projection into a 64x64
  flat; sky spans: the angle-scrolled sky texture;
- masked-mid records (mid pool, KM slots) and sprite-clip records
  (clip pool, KC slots) per column, with overflow counts;
- the composite (planes over walls) and the shade (palette + light
  diminish, bitmap_render.rs:190-208).

Draw order: walls paint front to back into the wall buffer (a later
emission wins at the 1-px span-boundary overlaps, the reference's paint
order); planes and sky paint in emission order into the plane buffer;
the composite takes plane over wall (visplanes draw after all walls,
renderer/mod.rs:118-136).

flags bits: 0-3 piece active, 4 two_sided, 5 draw_ceiling, 6-9 draws,
10 floor-flat-is-sky, 11 ceiling-flat-is-sky, 12 seg has a middle
texture.

Seg rows (`rows`, [B, G, NR] i32, f32 fields as their bits; the word
layout is in ops/layout.py and csrc/layout.cuh): row k of camera b is
that camera's k-th ACTIVE seg in traversal order; rows at k >= scnt[b]
are inactive segs and never read by the kernel.  One contiguous row per
seg suits the kernel: every thread of a camera's block reads the same
row, which is one or two cache lines.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from doomtpu_torch.config import (
    ASPECT_RATIO_CORRECTION,
    FLAT_SIZE,
    PLAYER_EYE_HEIGHT,
    SKY_TEXTURE_HEIGHT,
    SKY_TEXTURE_WIDTH,
    RenderConfig,
)
from doomtpu_torch.ops.layout import (
    KIND_MID, KIND_WALL, LD_SKY, LD_WRITTEN, NR, P_OFFY, P_TEX, P_TH, P_TW,
    P_UY1, P_UY1RAW, P_WORDS, P_YBD, P_YBS, P_YTD, P_YTS, PIECE_FIELDS,
    R_FLAGS, R_FLAT, R_G, R_LENGTH, R_LEX, R_LEY, R_LIGHT, R_LSX, R_LSY,
    R_OFFX, R_PIECE0, R_PLANEH, R_SOFF, R_X0, R_X1, ROW_FIELDS, SPAN_DC,
    SPAN_E2B, SPAN_E2T, SPAN_NODRAW, pack16, pack_span,
)
from doomtpu_torch.ops.resolve import camera_scalars
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    F32, I32, as_i16, f32, fdiv, reciprocal, rem_trunc, smul, wrap_tex,
)
from doomtpu_torch.render.resolve import shade
from doomtpu_torch.trace import spanned

FLAG_HAS_MID = 1 << 12

MID_PLANES = 7    # span, d1 (texel column), d2 (by|ty), d3 (offy|th),
#                   d4 (light|zdist), d5 (uy1 bits), d6 (seg id)
CLIP_PLANES = 7   # span, d2 (by|ty), d6 (seg id), lsx, lsy, lex, ley


def _texel_columns(level: DeviceLevel) -> int:
    """Texel columns a wall piece may sample: 256 on a level with wall
    textures wider than 128, else 128 (the JAX kernel's clamp)."""
    return min(256 if level.texq_wide else 128, level.tex_pixels.shape[2])


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(F32).contiguous().view(I32)


def _consts(cfg: RenderConfig) -> dict:
    """f32 constants of the plane projection, sky lookup and shade,
    rounded exactly where the JAX kernel rounds them.  Its divisions by
    constants are multiplies by f32 reciprocals (see jmath.div_const)."""
    W, H = cfg.width, cfg.height
    return {
        "half_w": float(np.float32(W / 2.0)),
        "half_h": float(np.float32(H / 2.0)),
        "inv_aspect": reciprocal(ASPECT_RATIO_CORRECTION),
        "wx_c": float(np.float32(W / 2.0 / ASPECT_RATIO_CORRECTION)),
        "eye": float(np.float32(PLAYER_EYE_HEIGHT)),
        "inv_w": reciprocal(W),
        "inv_h": reciprocal(H),
        "inv_255": reciprocal(255.0),
    }


# ---------------------------------------------------------------------------
# input build (the host side of the JAX render_paint)
# ---------------------------------------------------------------------------

def _check_rows(level: DeviceLevel, frame: dict, order):
    if order.dim() != 2 or order.dtype != I32 or not order.is_contiguous():
        raise ValueError(f"build_rows: order must be contiguous int32 "
                         f"[B, G], got {order.dtype} {tuple(order.shape)}")
    B, G = order.shape
    dev = order.device
    fields = [(n, dt, (B, G)) for n, dt in ROW_FIELDS] + [
        (n, dt, (B, G, 4)) for n, dt in PIECE_FIELDS]
    for name, dt, shape in fields:
        t = frame[name]
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"build_rows: frame[{name!r}] must be {dt} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"build_rows: frame[{name!r}] is on "
                             f"{t.device}, order on {dev}")
    for name, dt in (("flat_is_sky", torch.bool), ("tex_h", I32),
                     ("tex_w", I32)):
        t = getattr(level, name)
        if (t.dtype != dt or t.dim() != 1 or not t.is_contiguous()
                or t.device != dev or t.numel() == 0):
            raise ValueError(f"build_rows: level.{name} must be a non-empty "
                             f"contiguous {dt} vector on {dev}")


@spanned("doom.rows")
def build_rows(level: DeviceLevel, frame: dict, order):
    """(rows [B, G, NR] i32, scnt [B] i32): one row per (camera, seg),
    the camera's active segs first in traversal order, from a
    camera-stage frame and the traversal order (a permutation of the
    segs, `seg_order`'s).  The paint and the wall scan kernels both read
    them.  CUDA tensors launch the kernel (csrc/rows.cu), counted in
    `build_rows.launches`; CPU tensors run `build_rows_reference`.
    Anything else raises.  The kernel reads each field through its own
    strides (the [1, G] fields expanded to B in place)."""
    from doomtpu_torch.ops.build import load_library

    _check_rows(level, frame, order)
    dev = order.device
    if dev.type == "cpu":
        return build_rows_reference(level, frame, order)
    if dev.type != "cuda":
        raise ValueError(f"build_rows: no kernel for device {dev}")
    B, G = order.shape
    lib = load_library("rows")
    smem = lib.doom_rows_smem_bytes(G)
    if smem > SMEM_BLOCK_BYTES:
        raise ValueError(f"build_rows: {G} segs need {smem} bytes of shared "
                         f"memory a block, more than {SMEM_BLOCK_BYTES}")
    rows = torch.empty((B, G, NR), dtype=I32, device=dev)
    scnt = torch.empty((B,), dtype=I32, device=dev)
    desc = []
    for name, _ in ROW_FIELDS + PIECE_FIELDS:
        t = frame[name]
        desc += [t.data_ptr(), *t.stride(), *(0,) * (3 - t.dim())]
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.doom_rows(
        (ctypes.c_longlong * len(desc))(*desc), len(desc) // 4, p(order),
        p(level.flat_is_sky), level.flat_is_sky.numel(), p(level.tex_h),
        p(level.tex_w), B, G, p(rows), p(scnt), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"rows kernel launch failed: CUDA error {err} "
                           f"({lib.doom_rows_error_string(err).decode()})")
    build_rows.launches += 1
    return rows, scnt


build_rows.launches = 0


def build_rows_reference(level: DeviceLevel, frame: dict, order):
    """Plain PyTorch seg rows: every field of a row through stacks and a
    concatenation by seg id, then the stable partition (an argsort of
    the active bits along the order) and a gather.  Same arguments and
    outputs as `build_rows`, and the same bits."""
    B, G = order.shape
    active, draws, tex = frame["active"], frame["draws"], frame["tex"]
    ffl, cfl = frame["floor_flat"], frame["ceil_flat"]
    bit = lambda x, s: x.to(I32) << s
    flags = (
        bit(active[..., 0], 0) | bit(active[..., 1], 1)
        | bit(active[..., 2], 2) | bit(active[..., 3], 3)
        | bit(frame["two_sided"], 4) | bit(frame["draw_ceiling"], 5)
        | bit(draws[..., 0], 6) | bit(draws[..., 1], 7)
        | bit(draws[..., 2], 8) | bit(draws[..., 3], 9)
        | bit(level.flat_is_sky[ffl.long()], 10)
        | bit(level.flat_is_sky[cfl.long()], 11)
        | bit(tex[..., 1] >= 0, 12)
    )
    tex_safe = torch.clamp(tex, min=0)
    ts = tex_safe.long()

    def fin(x):
        return torch.where(torch.isfinite(x), x, torch.zeros_like(x))

    # ints the JAX field matrix carries as f32 go through f32 here too.
    # For x0 / x1 that is the identity, so the wall scan, which reads
    # them as i32 (JAX walls.py), reads the same words: camera.project_x
    # makes them Rust `as i32` of an f32 (an integer f32 holds exactly,
    # or +-2^31 saturated) clamped to W - 1.  fin() changes nothing on an
    # active seg: its endpoints passed the FOV clip and its x range is
    # not empty, so every such f32 is finite
    via_f32 = lambda x: x.to(F32).to(I32)
    seg_ids = torch.arange(G, dtype=I32, device=order.device)
    base = [
        seg_ids[None].expand(B, G),
        via_f32(frame["x0"]), via_f32(frame["x1"]), flags,
        _bits(fin(frame["lsx"])), _bits(fin(frame["lsy"])),
        _bits(fin(frame["lex"])), _bits(fin(frame["ley"])),
        _bits(fin(frame["length"])), _bits(fin(frame["start_offset"])),
        via_f32(frame["offset_x_total"]), frame["light"].to(I32),
        ffl, cfl, frame["floor_h_i"], frame["ceil_h_i"],
    ]
    uy1 = frame["uy1"]
    piece = torch.stack(
        [
            _bits(f32(frame["yb_s"])), _bits(fin(frame["yb_d"])),
            _bits(f32(frame["yt_s"])), _bits(fin(frame["yt_d"])),
            level.tex_h[ts], level.tex_w[ts], frame["off_y"], tex_safe,
            _bits(fin(uy1)), _bits(uy1),
        ],
        dim=-1,
    ).reshape(B, G, 4 * P_WORDS)
    rows_seg = torch.cat(
        [torch.stack([x.to(I32) for x in base], -1), piece.to(I32)], -1
    )                                                      # [B, G, NR]

    # per-camera active segs first, each group in traversal order: an
    # inactive seg changes nothing, so the kernels stop at scnt
    act_o = torch.gather((flags & 15) != 0, 1, order.long())
    first = torch.argsort((~act_o).to(torch.int8), dim=1, stable=True)
    comb = torch.gather(order.long(), 1, first)
    scnt = act_o.sum(1, dtype=I32)
    rows = torch.gather(
        rows_seg, 1, comb[..., None].expand(B, G, NR)
    ).contiguous()
    return rows, scnt


def build_inputs(level: DeviceLevel, cfg: RenderConfig, frame: dict, order,
                 angle, px, py, floor_height):
    """(rows [B, G, NR] i32, scnt [B] i32, camf [B, 3] f32, cami [B, 3]
    i32) for `paint`, from a camera-stage frame and the traversal
    order."""
    rows, scnt = build_rows(level, frame, order)
    camf, cami = camera_scalars(angle, px, py, floor_height)
    return rows, scnt, camf, cami


def render_paint(level: DeviceLevel, cfg: RenderConfig, frame: dict, order,
                 angle, px, py, floor_height, reuse: dict | None = None,
                 want_reuse: bool = False) -> dict:
    """Run the paint stage over B cameras.

    Returns idx/ld/rgb [B, H, W], the mid pool (7 x [B, W, KM]), cnt_mid,
    the clip pool (7 x [B, W, KC]), cnt_clip, overflow [B, 2] (mid,
    clip), live_dropped (the live segs `paint_live_capacity` dropped,
    `live_drop`) and live_stale.  ld packs light(8)<<16 | dist(u16) |
    written<<24 | sky<<25.

    Cross-tick live-list reuse (JAX pallas_paint.py:1396-1420, per-camera
    lists only): `want_reuse=True` adds out["reuse"], the refresh tick's
    KEPT live set, {"kept": [B, G, NBW] bool by seg index, "live_dropped"}:
    live in a 128-column block and not dropped by the cap.  Passed back
    as `reuse` on a later tick (the same camera order, the traversal order
    of the refresh tick), every seg live now and absent from the kept set
    gets its drop bit, and live_stale counts those (camera, seg, block)
    triples; live_dropped is the refresh tick's.  JAX visits the segs of
    the kept set in the given order and masks those dead now with its
    per-camera checks; this visits the segs active now in the given order
    less the dropped ones: the same segs in the same order, so the same
    frame and pools, stale or not.  live_stale == 0 proves the kept set
    held every live seg, so the frame is the one a fresh tick draws.  The
    mask is built even where no cap is set: a seg live now and not at the
    refresh tick is not drawn, as in JAX.
    """
    if not level.paint_ok:
        raise ValueError("level not eligible for the paint kernel "
                         "(wall-piece textures > 256x128 or transparent)")
    if (reuse is not None or want_reuse) and not cfg.paint_percam_compact:
        raise ValueError("live-list reuse needs per-camera live lists "
                         "(paint_percam_compact)")
    rows, scnt, camf, cami = build_inputs(
        level, cfg, frame, order, angle, px, py, floor_height
    )
    if reuse is None:
        drop, live_dropped = live_drop(cfg, rows, scnt, order)
        live_stale = torch.zeros((), dtype=I32, device=rows.device)
    else:
        drop, live_stale = reuse_drop(cfg, rows, scnt, order, reuse["kept"])
        live_dropped = reuse["live_dropped"]
    out = paint(level, cfg, rows, scnt, camf, cami, drop)
    out["live_dropped"] = live_dropped
    out["live_stale"] = live_stale
    if want_reuse:
        out["reuse"] = {"kept": kept_set(cfg, rows, scnt, order),
                        "live_dropped": live_dropped}
    return out


@spanned("doom.rows")
def kept_set(cfg: RenderConfig, rows, scnt, order) -> torch.Tensor:
    """[B, G, NBW] bool by seg index: the segs live in each 128-column
    block and kept by the cap (`live_lists`, `live_capacity`), per
    camera: JAX's `live_kept` (pallas_paint.py:1697-1712)."""
    live, rank, _ = live_lists(cfg, rows, scnt, order)
    gc = live_capacity(cfg, order.shape[1])
    kept = live if gc is None else live & (rank <= gc)
    seg = rows[..., R_G].long()[..., None].expand_as(kept)
    return torch.zeros_like(kept).scatter_(1, seg, kept)


@spanned("doom.rows")
def reuse_drop(cfg: RenderConfig, rows, scnt, order, kept):
    """(drop [B, G] i32, live_stale i32 scalar) of a tick that reuses an
    earlier tick's `kept_set`: bit w of drop[b, k] where row k of camera
    b is live in block w now and its seg is not kept there; live_stale
    counts those (camera, seg, block) triples."""
    live, _, _ = live_lists(cfg, rows, scnt, order)
    seg = rows[..., R_G].long()[..., None].expand_as(live)
    stale = live & ~torch.gather(kept, 1, seg)
    return drop_bits(cfg, stale), stale.sum(dtype=I32)


# the JAX kernel's live lists: 128-column blocks, and a capacity rounded
# up to a multiple of its seg unroll x group (pallas_paint.py SEG_UNROLL,
# SEG_GSUB; U = min(SEG_UNROLL, G))
LIVE_BLOCK = 128
SEG_UNROLL, SEG_GSUB = 4, 8


def live_capacity(cfg: RenderConfig, G: int) -> int | None:
    """The live segs a (camera or tile, block) keeps under
    cfg.paint_live_capacity (JAX render_paint's `capped`), or None where
    the cap keeps every seg."""
    ug = min(SEG_UNROLL, G) * SEG_GSUB
    gp = -(-G // ug) * ug
    if not 0 < cfg.paint_live_capacity < gp:
        return None
    return min(gp, -(-cfg.paint_live_capacity // ug) * ug)


def live_lists(cfg: RenderConfig, rows, scnt, order):
    """(live [B, G, NBW] bool, rank [B, G, NBW] i32, cnt [L, NBW] i32):
    the live-seg lists of JAX render_paint (pallas_paint.py:1605-1745)
    over the rows of ops/paint.build_rows.

    A seg is live in a 128-column block where it is active and its
    [x0, x1] meets the block.  Per camera (`paint_percam_compact`) a
    list holds a camera's live segs of a block in traversal order (front
    to back); otherwise a tile of 8 cameras (4 where B is no multiple of
    8) shares, per block, the list of traversal positions live for any
    of its cameras.  live[b, k, w]: row k of camera b is live in block
    w; rank: its place in its list, from 1; cnt: each list's length (L
    lists: one a camera or one a tile)."""
    B, G = order.shape
    nbw = -(-cfg.width // LIVE_BLOCK)
    dev = rows.device
    active = torch.arange(G, device=dev)[None] < scnt[:, None]
    wlo = torch.arange(nbw, dtype=I32, device=dev) * LIVE_BLOCK
    x0 = as_i16(rows[..., R_X0])[..., None]
    x1 = as_i16(rows[..., R_X1])[..., None]
    live = active[..., None] & (x0 < wlo + LIVE_BLOCK) & (x1 >= wlo)
    if cfg.paint_percam_compact:
        return live, torch.cumsum(live.to(I32), 1, dtype=I32), live.sum(
            1, dtype=I32)
    if B % 4:
        raise ValueError(f"live lists: batch {B} is no multiple of the "
                         f"4-camera tile")
    tb = 8 if B % 8 == 0 else 4
    # each row's traversal position: the rows hold every seg once
    pos = torch.gather(torch.argsort(order.long(), 1), 1,
                       rows[..., R_G].long())[..., None].expand_as(live)
    live_t = torch.zeros_like(live).scatter_(1, pos, live).view(
        B // tb, tb, G, nbw).any(1)
    rank_t = torch.cumsum(live_t.to(I32), 1, dtype=I32)
    rank = torch.gather(rank_t.repeat_interleave(tb, 0), 1, pos)
    return live, rank, live_t.sum(1, dtype=I32)


@spanned("doom.rows")
def live_drop(cfg: RenderConfig, rows, scnt, order):
    """(drop [B, G] i32 or None, live_dropped i32 scalar): the segs
    cfg.paint_live_capacity drops, farthest first: each list of
    `live_lists` keeps its first `live_capacity` entries.  Bit w of
    drop[b, k] is set where row k of camera b is live in block w and
    dropped; the paint skips it at that block's columns.  None: the cap
    keeps every seg.  Under a cap, CUDA tensors launch the drop kernel
    (csrc/rows.cu: a warp a camera for per-camera lists, a block a tile
    for the tile-shared ones), counted in `live_drop.launches`; CPU
    tensors run `live_drop_reference`.  Anything else raises."""
    from doomtpu_torch.ops.build import load_library

    gc = live_capacity(cfg, order.shape[1])
    dev = rows.device
    if gc is None:
        return None, torch.zeros((), dtype=I32, device=dev)
    if dev.type == "cpu":
        return live_drop_reference(cfg, rows, scnt, order)
    if dev.type != "cuda":
        raise ValueError(f"live_drop: no kernel for device {dev}")
    B, G = order.shape
    for name, t, dt, shape in (("rows", rows, I32, (B, G, NR)),
                               ("scnt", scnt, I32, (B,)),
                               ("order", order, I32, (B, G))):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"live_drop: {name} must be contiguous {dt} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"live_drop: {name} is on {t.device}, rows on "
                             f"{dev}")
    nbw = -(-cfg.width // LIVE_BLOCK)
    if nbw > 32:
        raise ValueError(f"paint: {cfg.width} columns make {nbw} live-list "
                         f"blocks; the drop mask holds 32")
    if cfg.paint_percam_compact:
        tb = 1
    elif B % 4:
        raise ValueError(f"live lists: batch {B} is no multiple of the "
                         f"4-camera tile")
    else:
        tb = 8 if B % 8 == 0 else 4
    lib = load_library("rows")
    smem = lib.doom_live_drop_smem_bytes(G, tb)
    if smem > SMEM_BLOCK_BYTES:
        raise ValueError(f"live_drop: {G} segs need {smem} bytes of shared "
                         f"memory a tile, more than {SMEM_BLOCK_BYTES}")
    drop = torch.empty((B, G), dtype=I32, device=dev)
    dropped = torch.empty((), dtype=I32, device=dev)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.doom_live_drop(p(rows), p(scnt), p(order), B, G, nbw, gc, tb,
                             p(drop), p(dropped), ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.doom_rows_error_string(err).decode()
        raise RuntimeError(f"live drop kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    live_drop.launches += 1
    return drop, dropped


live_drop.launches = 0


def live_drop_reference(cfg: RenderConfig, rows, scnt, order):
    """Plain PyTorch live drop over `live_lists` ([B, G, NBW] live
    masks, their cumsum ranks and counts).  Same arguments and outputs
    as `live_drop`, and the same bits."""
    gc = live_capacity(cfg, order.shape[1])
    if gc is None:
        return None, torch.zeros((), dtype=I32, device=rows.device)
    live, rank, cnt = live_lists(cfg, rows, scnt, order)
    drop = drop_bits(cfg, live & (rank > gc))
    return drop, (cnt - gc).clamp(min=0).sum().to(I32)


def drop_bits(cfg: RenderConfig, dropped) -> torch.Tensor:
    """[B, G] i32 drop mask from dropped [B, G, NBW]: bit w of drop[b, k]
    set where row k of camera b is dropped at 128-column block w."""
    nbw = dropped.shape[-1]
    if nbw > 32:
        raise ValueError(f"paint: {cfg.width} columns make {nbw} live-list "
                         f"blocks; the drop mask holds 32")
    drop = torch.zeros(dropped.shape[:2], dtype=I32, device=dropped.device)
    for w in range(nbw):                       # bit 31 wraps to the sign
        drop |= dropped[..., w].to(I32) << w
    return drop


def pools_from_paint(out_or_aux: dict):
    """(clip, mid) pools from the paint stage's output dict or aux, as
    slot-major [B, K, W] planes (the paint kernel's own layout)."""
    sm = lambda p: p.transpose(1, 2)
    c_span, c_d2, c_d6, c_lsx, c_lsy, c_lex, c_ley = map(
        sm, out_or_aux["clippool"])
    m = [sm(p) for p in out_or_aux["midpool"]]
    clip = {
        "span": c_span, "d2": c_d2, "d6": c_d6,
        "lsx": c_lsx, "lsy": c_lsy, "lex": c_lex, "ley": c_ley,
        "cnt": out_or_aux["cnt_clip"],
    }
    mid = {
        "span": m[0], "d1": m[1], "d2": m[2], "d3": m[3], "d4": m[4],
        "d5": m[5], "d6": m[6], "cnt": out_or_aux["cnt_mid"],
    }
    return clip, mid


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

def _check_inputs(level, cfg, rows, scnt, camf, cami, drop):
    B = rows.shape[0]
    want = {
        "rows": (rows, I32, (B, level.num_segs, NR)),
        "scnt": (scnt, I32, (B,)),
        "camf": (camf, F32, (B, 3)),
        "cami": (cami, I32, (B, 3)),
    }
    if drop is not None:
        want["drop"] = (drop, I32, (B, level.num_segs))
        if cfg.width > 32 * LIVE_BLOCK:
            raise ValueError(f"paint: a drop mask covers {32 * LIVE_BLOCK} "
                             f"columns, the screen {cfg.width}")
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"paint: {name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != rows.device:
            raise ValueError(f"paint: {name} is on {t.device}, rows on "
                             f"{rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"paint: {name} must be contiguous")
    # the tables the kernel reads through raw pointers, with the shapes
    # it assumes (None: any size)
    for name, shape in (
        ("tex_pixels", (None, None, None)),
        ("flat_pixels", (None, FLAT_SIZE, FLAT_SIZE)),
        ("sky_pixels", (SKY_TEXTURE_HEIGHT, SKY_TEXTURE_WIDTH)),
        ("palette_packed", (256,)),
    ):
        t = getattr(level, name)
        if t.device != rows.device:
            raise ValueError(f"paint: level on {t.device}, inputs on "
                             f"{rows.device}")
        if t.dtype != I32 or not t.is_contiguous():
            raise ValueError(f"paint: level.{name} must be contiguous int32")
        if t.dim() != len(shape) or any(
            s not in (None, n) for s, n in zip(shape, t.shape)
        ):
            raise ValueError(f"paint: level.{name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if cfg.width < 1 or cfg.height < 1:
        raise ValueError("paint: empty screen")


def _alloc_outputs(B, W, H, KM, KC, device):
    e = lambda *s: torch.empty(s, dtype=I32, device=device)
    return {
        "idx": e(B, H, W), "ld": e(B, H, W), "rgb": e(B, H, W),
        "mpool": e(MID_PLANES, B, KM, W), "cpool": e(CLIP_PLANES, B, KC, W),
        "cnt_mid": e(B, W), "cnt_clip": e(B, W), "overflow": e(B, 2),
    }


def _result(o: dict) -> dict:
    """Kernel-layout outputs -> the JAX render_paint layout (pools as
    [B, W, K] views)."""
    return {
        "idx": o["idx"], "ld": o["ld"], "rgb": o["rgb"],
        "midpool": tuple(p.transpose(1, 2) for p in o["mpool"]),
        "cnt_mid": o["cnt_mid"],
        "clippool": tuple(p.transpose(1, 2) for p in o["cpool"]),
        "cnt_clip": o["cnt_clip"], "overflow": o["overflow"],
    }


# shared memory one block may use on Hopper (227 KB), and the threads of
# a paint block (csrc/paint.cu's MAX_THREADS)
SMEM_BLOCK_BYTES = 232_448
MAX_BLOCK_THREADS = 256
# rows a paint thread's band holds: fewer rows, more threads a column
# (band 0 walks, every band paints); timed on the card (PERF.md)
BAND_ROWS = 25

# csrc/paint.cu's LIST (the tile's seg list), TERMS (words a (seg,
# column) term) and JOBS (paint jobs of a seg and column, 2 words each)
LIST_ROWS, SEG_TERMS, SEG_JOBS = 256, 6, 4


def paint_smem_bytes(tc: int, bands: int, H: int) -> int:
    """Shared memory of a paint block (csrc/paint.cu): the tile's frame
    (an ld word and a 16-bit texel a pixel), its seg list, the terms and
    paint jobs of `bands` segs a column, two flags a column and two
    counters."""
    pixels = tc * H
    return 4 * (pixels + (pixels + 1) // 2 + LIST_ROWS
                + (SEG_TERMS + 2 * SEG_JOBS) * bands * tc + 2 * tc + 2)


def paint_tile(H: int) -> tuple[int, int]:
    """(TC, R) of a paint block at screen height H: TC columns, 32 while
    the block's shared memory (`paint_smem_bytes`) fits the
    SMEM_BLOCK_BYTES a block may use, else the largest power of two
    that fits (so a tile never straddles a 128-column live-list block,
    whose drop bit the kernel tests once a tile); R threads a column,
    each painting a band of about BAND_ROWS rows,
    TC * R <= MAX_BLOCK_THREADS."""
    for tc in (32, 16, 8, 4, 2, 1):
        bands = max(1, min(-(-H // BAND_ROWS), MAX_BLOCK_THREADS // tc))
        if paint_smem_bytes(tc, bands, H) <= SMEM_BLOCK_BYTES:
            return tc, bands
    raise ValueError(f"paint: height {H} leaves no column of its frame "
                     f"within {SMEM_BLOCK_BYTES} bytes")


def paint_blocks_per_sm(H: int, lib: str = "paint") -> int:
    """Paint blocks one SM of this card holds at height H (the CUDA
    occupancy calculator, from the built kernel's registers and the
    block's shared memory); `lib` names a cost-probe build instead."""
    from doomtpu_torch.ops.build import load_library

    tc, bands = paint_tile(H)
    return load_library(lib).doom_paint_blocks_per_sm(tc, bands, H)


@spanned("doom.walls")
def paint(level: DeviceLevel, cfg: RenderConfig, rows, scnt, camf,
          cami, drop=None) -> dict:
    """Paint B cameras, skipping each row at the 128-column blocks its
    `drop` word's bits name (`live_drop`; None: none).  CUDA tensors
    launch the kernel (csrc/paint.cu); CPU tensors run
    `paint_reference`.  Anything else raises.  The kernel leaves pool
    slots past a column's count unwritten (the plain version zero-fills
    them); nothing reads them."""
    _check_inputs(level, cfg, rows, scnt, camf, cami, drop)
    if rows.device.type == "cpu":
        return paint_reference(level, cfg, rows, scnt, camf, cami, drop)
    if rows.device.type != "cuda":
        raise ValueError(f"paint: no kernel for device {rows.device}")
    out = _launch("paint", level, cfg, rows, scnt, camf, cami, drop)
    paint.launches += 1
    return out


def paint_probe(level: DeviceLevel, cfg: RenderConfig, rows, scnt, camf,
                cami, probe: int) -> dict:
    """The paint kernel for the cost probe only (CUDA tensors; not
    counted as a launch of `paint`): PAINT_PROBE level 1 inits and
    writes the outputs, 2 adds the seg x-range checks, 3 the occlusion
    and emit math without painting (csrc/paint.cu).  Its outputs are not
    the paint's."""
    _check_inputs(level, cfg, rows, scnt, camf, cami, None)
    if rows.device.type != "cuda" or probe not in (1, 2, 3):
        raise ValueError(f"paint_probe: level {probe} on {rows.device}")
    return _launch(f"paint_probe{probe}", level, cfg, rows, scnt, camf, cami,
                   None)


def _launch(lib_name, level, cfg, rows, scnt, camf, cami, drop) -> dict:
    from doomtpu_torch.ops.build import load_library

    B, G = rows.shape[:2]
    W, H, KM, KC = cfg.width, cfg.height, cfg.mid_capacity, cfg.clip_capacity
    tc, bands = paint_tile(H)
    lib = load_library(lib_name)
    o = _alloc_outputs(B, W, H, KM, KC, rows.device)
    o["overflow"].zero_()          # the tiles of a camera add into it
    TH, TW = level.tex_pixels.shape[1:]
    twq = _texel_columns(level)
    k = _consts(cfg)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.doom_paint(
        p(rows), p(scnt), ctypes.c_void_p(None if drop is None
                                          else drop.data_ptr()),
        p(camf), p(cami), B, G,
        p(level.tex_pixels), TH, TW, p(level.flat_pixels),
        p(level.sky_pixels), p(level.palette_packed),
        W, H, KM, KC, int(level.tex_sizes_pow2), twq,
        k["half_w"], k["half_h"], k["inv_aspect"], k["wx_c"], k["eye"],
        k["inv_w"], k["inv_h"], k["inv_255"], tc, bands,
        p(o["idx"]), p(o["ld"]), p(o["rgb"]),
        p(o["mpool"]), p(o["cpool"]), p(o["cnt_mid"]), p(o["cnt_clip"]),
        p(o["overflow"]), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"paint kernel launch failed: CUDA error {err} "
                           f"({lib.doom_cuda_error_string(err).decode()})")
    return _result(o)


paint.launches = 0


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def paint_reference(level: DeviceLevel, cfg: RenderConfig, rows, scnt, camf,
                    cami, drop=None) -> dict:
    """Plain PyTorch paint: a Python loop over the ordered seg slots with
    [B, W] state tensors, painting [B, H, W] buffers under masks.  Same
    arguments and outputs as `paint`; every op is an IEEE f32 op with
    the kernel's rounding, so the two agree bit for bit."""
    _check_inputs(level, cfg, rows, scnt, camf, cami, drop)
    dev = rows.device
    B = rows.shape[0]
    W, H, KM, KC = cfg.width, cfg.height, cfg.mid_capacity, cfg.clip_capacity
    TH, TW = level.tex_pixels.shape[1:]
    twq = _texel_columns(level)
    pow2 = level.tex_sizes_pow2
    k = _consts(cfg)
    zi = lambda *s: torch.zeros(s, dtype=I32, device=dev)

    xx = torch.arange(W, dtype=I32, device=dev)[None]         # [1, W]
    yy = torch.arange(H, dtype=I32, device=dev)[None, :, None]  # [1, H, 1]
    hor = torch.zeros((B, W), dtype=torch.bool, device=dev)
    fo = torch.full((B, W), H, dtype=I32, device=dev)
    co = torch.full((B, W), -1, dtype=I32, device=dev)
    widx, wld, pidx, pld = zi(B, H, W), zi(B, H, W), zi(B, H, W), zi(B, H, W)
    mpool, cpool = zi(MID_PLANES, B, KM, W), zi(CLIP_PLANES, B, KC, W)
    cnt_m, cnt_c, ovf = zi(B, W), zi(B, W), zi(B, 2)
    km_iota = torch.arange(KM, dtype=I32, device=dev)[None, :, None]
    kc_iota = torch.arange(KC, dtype=I32, device=dev)[None, :, None]

    cosv, sinv, fh = camf[:, 0:1], camf[:, 1:2], camf[:, 2:3]   # [B, 1]
    pxi, pyi, txoff = cami[:, 0:1], cami[:, 1:2], cami[:, 2:3]
    # sky column per screen column (row-invariant)
    stx = rem_trunc(
        as_i16((f32(xx) * float(SKY_TEXTURE_WIDTH)) * k["inv_w"]) + txoff,
        SKY_TEXTURE_WIDTH,
    )                                                            # [B, W]
    vx = (k["half_w"] - f32(xx)) * k["inv_aspect"]               # [1, W]

    def emit(pool, cnt, ovf_col, iota, K, mask, planes):
        if not bool(mask.any()):
            return cnt
        fits = cnt < K
        do = mask & fits
        write = do[:, None, :] & (iota == cnt[:, None, :])
        for i, d in enumerate(planes):
            pool[i] = torch.where(write, d[:, None, :], pool[i])
        ovf[:, ovf_col] += (mask & ~fits).sum(-1, dtype=I32)
        return cnt + do.to(I32)

    def paint_wall(m, ct, cb, by, ty, tx, zdist, th, uy1, offy, texid,
                   light):
        if not bool(m.any()):
            return
        ylo, yhi = int(ct[m].min()), int(cb[m].max())
        ys = yy[:, ylo:yhi + 1]
        cover = m[:, None] & (ys >= ct[:, None]) & (ys <= cb[:, None])
        ay = fdiv(f32(ys - ty[:, None]), f32(by - ty)[:, None])
        thb = torch.clamp(th, min=1)[:, None]                   # [B, 1, 1]
        tyv = as_i16(f32(thb) + smul(ay, uy1[:, None])) + offy[:, None]
        tyv = wrap_tex(tyv, thb, pow2)
        texel = level.tex_pixels[
            texid[:, None].long(),
            torch.clamp(tyv, 0, TH - 1).long(),
            torch.clamp(tx, 0, twq - 1)[:, None].long(),
        ] & 0xFF
        ldw = (((light << 16) | LD_WRITTEN) | (zdist & 0xFFFF))[:, None]
        sl = slice(ylo, yhi + 1)
        widx[:, sl] = torch.where(cover, texel, widx[:, sl])
        wld[:, sl] = torch.where(cover, ldw.expand_as(cover), wld[:, sl])

    def paint_plane(m, y0, y1, fl, is_sky, h_s, light):
        if not bool(m.any()):
            return
        ylo, yhi = int(y0[m].min()), int(y1[m].max())
        if ylo > yhi:
            return
        ys = yy[:, ylo:yhi + 1]
        cover = m[:, None] & (ys >= y0[:, None]) & (ys <= y1[:, None])
        wz = (f32(h_s) - fh - k["eye"])[:, None]                 # [B, 1, 1]
        vy = k["half_h"] - f32(ys)                               # [1, Y, 1]
        wx = fdiv(wz * k["wx_c"], vy)                            # [B, Y, 1]
        wy = fdiv(wz * vx[:, None], vy)                          # [B, Y, W]
        rx = smul(wx, cosv[:, None]) - smul(wy, sinv[:, None])
        ry = smul(wy, cosv[:, None]) + smul(wx, sinv[:, None])
        ftx = (as_i16(rx) + pxi[:, None]) & (FLAT_SIZE - 1)
        fty = (as_i16(ry) + pyi[:, None]) & (FLAT_SIZE - 1)
        flat_texel = level.flat_pixels[
            fl[:, None].long(), fty.long(), ftx.long()
        ] & 0xFF
        pdist = as_i16(wx) & 0xFFFF
        sth = SKY_TEXTURE_HEIGHT
        sty = as_i16((f32(ys) * float(sth) * 2.0) * k["inv_h"])
        sty = rem_trunc(torch.where(sty < 0, sty + sth, sty), sth)
        sky_texel = level.sky_pixels[
            sty.long(), stx[:, None].long()
        ] & 0xFF
        is_sky = is_sky[:, None]
        texel = torch.where(is_sky, sky_texel, flat_texel)
        ldw = ((light << 16) | LD_WRITTEN)[:, None] | (
            is_sky.to(I32) * LD_SKY
        ) | pdist
        sl = slice(ylo, yhi + 1)
        pidx[:, sl] = torch.where(cover, texel, pidx[:, sl])
        pld[:, sl] = torch.where(cover, ldw, pld[:, sl])

    def clamp_span(y0, y1):
        return (torch.clamp(torch.clamp(y0, -1, 254), min=0),
                torch.clamp(torch.clamp(y1, -1, 254), max=H - 1))

    n_slots = int(scnt.max()) if B else 0
    for slot in range(n_slots):
        r = rows[:, slot]                                        # [B, NR]
        iv = lambda f: r[:, f:f + 1]
        fv = lambda f: r[:, f:f + 1].view(F32)
        flags = torch.where((slot < scnt)[:, None], iv(R_FLAGS), 0)
        x0, x1 = iv(R_X0), iv(R_X1)
        x0i, x1i = as_i16(x0), as_i16(x1)
        inrange = (xx >= x0i) & (xx <= x1i)
        if drop is not None:    # dropped at this column's live-list block
            block = xx // LIVE_BLOCK
            inrange &= ((drop[:, slot:slot + 1] >> block) & 1) == 0
        if not bool((inrange & ((flags & 15) != 0) & ~hor).any()):
            continue    # every piece is a no-op on every open column
        two_sided = (flags & 16) != 0
        draw_c = (flags & 32) != 0
        f_sky = (flags & 1024) != 0
        c_sky = (flags & 2048) != 0
        has_mid = (flags & FLAG_HAS_MID) != 0
        light = iv(R_LIGHT)
        g = iv(R_G).expand(B, W)
        one = 1.0
        dx = f32(xx - x0)                      # i32 wraps, as in JAX
        ax = fdiv(dx, f32(x1 - x0))
        uz0, uz1 = fv(R_LSX), fv(R_LEX)
        inv0, inv1 = fdiv(one, uz0), fdiv(one, uz1)
        denom = smul(one - ax, inv0) + smul(ax, inv1)
        u = fdiv(
            smul(one - ax, fdiv(0.0, uz0))
            + smul(ax, fdiv(fv(R_LENGTH), uz1)),
            denom,
        )
        tx_base = as_i16(u) + as_i16(fv(R_SOFF)) + iv(R_OFFX)
        zdist = as_i16(fdiv((one - ax) + ax, denom))
        coords = [iv(f).expand(B, W) for f in (R_LSX, R_LSY, R_LEX, R_LEY)]

        for p in range(4):
            act = (flags & (1 << p)) != 0
            covered = inrange & act
            if not bool((covered & ~hor).any()) and p != 0:
                continue    # pieces 1-3 change nothing on closed columns
            pb = R_PIECE0 + P_WORDS * p
            draws_p = (flags & (64 << p)) != 0
            open_ = covered & ~hor
            by = as_i16(fv(pb + P_YBS) + smul(dx, fv(pb + P_YBD)))
            ty = as_i16(fv(pb + P_YTS) + smul(dx, fv(pb + P_YTD)))
            cb = torch.clamp(torch.minimum(fo, by), max=H - 1)
            ct = torch.clamp(torch.maximum(co, ty), min=0)
            in_ver = (cb >= ct) & open_
            th, tw = iv(pb + P_TH), iv(pb + P_TW)
            tx = wrap_tex(tx_base, torch.clamp(tw, min=1), pow2)
            cd2 = pack16(by, ty)
            texid, offy = iv(pb + P_TEX), iv(pb + P_OFFY)

            if p == 0:
                solid = ~two_sided
                gap = open_ & ~in_ver & (fo > co)
                keep_g = (torch.clamp(fo, max=H - 1)
                          - torch.clamp(co, min=0)) > 1
                gap_b = gap & (by <= co)
                gap_t = gap & draw_c & (ty >= fo)
                rec = pack_span(KIND_WALL, ct, cb) | SPAN_E2B | SPAN_E2T
                rec = torch.where(draws_p, rec, rec | SPAN_NODRAW)
                m_e = in_ver & solid
                m_w = m_e & draws_p
                fl_keep = f_sky | (torch.clamp(fo, max=H - 1) - cb > 1)
                fl_emit = in_ver & (cb < fo) & (cb != H - 1) & fl_keep
                m_f = fl_emit | (gap_b & (f_sky | keep_g))
                y0f, y1f = clamp_span(torch.where(fl_emit, cb, co), fo)
                ce_keep = c_sky | (
                    torch.clamp(ct, max=H - 1) - torch.clamp(co, min=0) > 1
                )
                ce_emit = in_ver & draw_c & (ct > co) & ce_keep
                m_c = ce_emit | (gap_t & (c_sky | keep_g))
                y0c, y1c = clamp_span(co, torch.where(ce_emit, ct, fo))
                cnt_c = emit(cpool, cnt_c, 1, kc_iota, KC, m_e,
                             [rec, cd2, g] + coords)
                paint_wall(m_w, ct, cb, by, ty, tx, zdist, th,
                           fv(pb + P_UY1RAW), offy, texid, light)
                paint_plane(m_f, y0f, y1f, iv(R_FLAT), f_sky,
                            iv(R_PLANEH), light)
                paint_plane(m_c, y0c, y1c, iv(R_FLAT + 1), c_sky,
                            iv(R_PLANEH + 1), light)
                gap_occl = gap_b | gap_t
                occl_m = in_ver & two_sided
                fo = torch.where(occl_m, cb, fo)
                co = torch.where(occl_m & draw_c, ct, co)
                solid_occl = (covered & solid) | gap_occl
                hor = hor | solid_occl
                fo = torch.where(solid_occl, H // 2, fo)
                co = torch.where(solid_occl, H // 2, co)
            elif p == 1:
                rec = pack_span(KIND_MID, ct, cb) | (draw_c.to(I32) * SPAN_DC)
                cnt_c = emit(cpool, cnt_c, 1, kc_iota, KC, in_ver,
                             [rec, cd2, g] + coords)
                md1 = texid * level.tex_pixels.shape[2] + tx
                md3 = pack16(offy, th).expand(B, W)
                md4 = pack16(light, zdist)
                md5 = iv(pb + P_UY1).expand(B, W)
                cnt_m = emit(mpool, cnt_m, 0, km_iota, KM, in_ver & has_mid,
                             [rec, md1, cd2, md3, md4, md5, g])
            else:
                e2 = SPAN_E2B if p == 2 else SPAN_E2T
                rec = pack_span(KIND_WALL, ct, cb) | e2
                rec = torch.where(draws_p, rec, rec | SPAN_NODRAW)
                cnt_c = emit(cpool, cnt_c, 1, kc_iota, KC, in_ver,
                             [rec, cd2, g] + coords)
                paint_wall(in_ver & draws_p, ct, cb, by, ty, tx, zdist, th,
                           fv(pb + P_UY1RAW), offy, texid, light)
                if p == 2:
                    fo = torch.where(in_ver, ct, fo)
                else:
                    co = torch.where(in_ver, cb, co)

    # composite (plane over wall) + shade
    use_p = (pld & LD_WRITTEN) != 0
    ldw = torch.where(use_p, pld, wld)
    texel = torch.where(use_p, pidx, widx)
    idx = torch.where((ldw & LD_WRITTEN) != 0, texel, -1).to(I32)
    o = {
        "idx": idx,
        "ld": ldw,
        "rgb": shade(level, idx, (ldw >> 16) & 0xFF,
                     ((ldw & 0xFFFF) << 16) >> 16, (ldw & LD_SKY) != 0),
        "mpool": mpool, "cpool": cpool,
        "cnt_mid": cnt_m, "cnt_clip": cnt_c, "overflow": ovf,
    }
    return _result(o)
