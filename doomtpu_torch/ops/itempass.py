"""The item pass: every selected sprite and masked mid painted over the
paint frame, with no per-column item cap.

Counterpart of doomtpu/ops/pallas_itempass.py.  `item_pass` launches the
hand-written CUDA kernel (csrc/itempass.cu) on CUDA tensors and runs
`item_pass_reference`, its plain PyTorch version, on CPU tensors.  Both
give the same bits.

What is computed, per camera and screen column, over the camera's items
in pack order (render/things.item_pack: farthest first), skipping
invalid items and items whose [x0, x1e) misses the column:

- a sprite's billboard math: perspective texel column u, zdist, the
  bottom / top rows from the y slopes; then its rows [ct, cb] clipped
  against every clip record of the column whose seg lies in front of the
  sprite (renderer/map_objects.rs:127-166);
- a masked mid's draw data from the column's mid pool: the last record
  of kind KIND_MID whose seg id equals the item's;
- per row y in [ct, cb]: ay = (y - ty) / (by - ty), texel row
  wrap_tex(as_i16(th + ay * uy1) + off_y, th), texel and opacity of the
  item's picture at column clamp(tx, 0, 127); opaque texels overwrite
  (the painter's order, map_objects.rs:216-240);
- the written pixels are shaded (palette, light diminish,
  bitmap_render.rs:190-208) and merged over idx / ld / rgb, with
  ld = light << 16 | zdist | written.

Every selected item is drawn: there is no item pool, so no item
overflow.  Texels and opacity come from the column atlas `atlas_cm`; a
picture's column c (c <= 127) is atlas column pic * TW + c for a wall
texture (pic < T) and col_spr_off + (pic - T) * spr_pw + c for a sprite,
transparent at c past the picture table's width and at rows >= 128, as
the JAX kernel's 128 x 128 item_q / item_mq tables are.

The pools are the paint stage's (ops/paint.render_paint), read
slot-major: each clip and mid plane [B, K, W].  idx / ld / rgb
[B, H, W] are updated in place and returned.
"""

from __future__ import annotations

import ctypes

import torch

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.ops.items import (
    CLIP_FIELDS, CLIP_RECORD_WORDS, clip_record_bounds, shade_over,
)
from doomtpu_torch.ops.layout import KIND_MID, LD_WRITTEN
from doomtpu_torch.ops.paint import (
    SMEM_BLOCK_BYTES, _consts, pools_from_paint,
)
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    F32, I32, as_i16, f32, fdiv, smul, wrap_tex,
)
from doomtpu_torch.render.resolve import unpack16_lo
from doomtpu_torch.trace import spanned

# the item pack (render/things.item_pack): per selected item and camera,
# the scalars the kernel recomputes each column's sprite math from, as
# i32 rows and f32 rows laid out as the JAX things.item_pack lays them
IPI_FL = 0       # bit0 valid, bit1 is_sprite
IPI_X0 = 1       # first screen column (as_i16(bsx) / seg x0)
IPI_X1E = 2      # exclusive end column (as_i16(bex) / seg x1 + 1)
IPI_LW = 3       # sprite: light | wpic << 16
IPI_PIC = 4      # unified picture id: mid texture | T + sprite picture
IPI_TH = 5       # sprite picture height
IPI_SOFF = 6     # sprite as_i16(start_offset) / mid seg id
IPI_BSX = 7      # screen x of the billboard start (project_x)
IPI_ROWS = 8
IPF_DX = 0       # f32(bex - bsx)
IPF_INV0 = 1     # 1 / lsx
IPF_INV1 = 2     # 1 / lex
IPF_Z0 = 3       # 0 / lsx
IPF_Z1 = 4       # s_len / lex
IPF_YBS = 5      # f32(yb_s)
IPF_YBD = 6      # yb slope
IPF_YTS = 7      # f32(yt_s)
IPF_YTD = 8      # yt slope
IPF_UY1 = 9      # top_h - bottom_h
IPF_VPX = 10     # view-space mobj x (seg clip)
IPF_VPY = 11     # view-space mobj y
IPF_ROWS = 12

MID_FIELDS = ("span", "d1", "d2", "d3", "d4", "d5", "d6")
PIC_SIZE = 128     # the JAX kernel's per-picture tables: 128 x 128 texels


def _check(level: DeviceLevel, cfg: RenderConfig, items: dict,
           paint_out: dict):
    if not level.itempaint_ok:
        raise ValueError("item_pass: level not eligible (sprite or mid "
                         "pictures over 128 x 128, or atlas rows > 128)")
    ip, fp = items["i"], items["f"]
    idx = paint_out["idx"]
    dev = idx.device
    B, H, W = idx.shape
    N = ip.shape[1]
    clip, mid = pools_from_paint(paint_out)
    KC, KM = clip["span"].shape[1], mid["span"].shape[1]
    want = {"items i": (ip, I32, (B, N, IPI_ROWS)),
            "items f": (fp, F32, (B, N, IPF_ROWS))}
    for k in ("idx", "ld", "rgb"):
        want[k] = (paint_out[k], I32, (B, H, W))
    for k in CLIP_FIELDS:
        want[f"clip {k}"] = (clip[k], I32, (B, KC, W))
    for k in MID_FIELDS:
        want[f"mid {k}"] = (mid[k], I32, (B, KM, W))
    want["clip cnt"] = (clip["cnt"], I32, (B, W))
    want["mid cnt"] = (mid["cnt"], I32, (B, W))
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"item_pass: {name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"item_pass: {name} is on {t.device}, idx on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"item_pass: {name} must be contiguous")
    if (H, W) != (cfg.height, cfg.width):
        raise ValueError(f"item_pass: frame {H}x{W}, config "
                         f"{cfg.height}x{cfg.width}")
    for name in ("atlas_cm", "palette_packed"):
        t = getattr(level, name)
        if t.device != dev or t.dtype != I32 or not t.is_contiguous():
            raise ValueError(f"item_pass: level.{name} must be contiguous "
                             f"int32 on {dev}")
    return clip, mid


def _picture_columns(level: DeviceLevel) -> dict:
    """Where each unified picture's columns start in the atlas: wall
    textures (ids < T) TW columns apart, sprites (T + picture) spr_pw
    apart from col_spr_off."""
    return {"T": level.tex_pixels.shape[0], "TW": level.tex_pixels.shape[2],
            "spr0": level.col_spr_off, "PW": level.spr_pw}


# csrc/itempass.cu: items a round (S), words of an (item, column) pair's
# terms and of an item's staged pack, threads a block at most
ROUND_ITEMS, PAIR_TERMS, PACK_WORDS = 16, 6, IPI_ROWS + IPF_ROWS
MAX_BLOCK_THREADS = 512
# rows a band of the item-pass block holds (see paint.BAND_ROWS); timed
# on the card (PERF.md)
BAND_ROWS = 13


def itempass_smem_bytes(tc: int, bands: int, H: int, KC: int,
                        KM: int) -> int:
    """Shared memory of an item-pass block of `tc` columns and `bands`
    threads a column (csrc/itempass.cu): a 16-bit mark a pixel, a
    round's (item, column) terms and pack words, the staged clip records
    and mid keys of pools of KC / KM slots, and a pass's list (an item a
    thread) and warp counts."""
    threads = tc * bands
    return (4 * (tc * (PAIR_TERMS * ROUND_ITEMS + CLIP_RECORD_WORDS * KC
                       + KM) + ROUND_ITEMS * PACK_WORDS + threads
                 + -(-threads // 32)) + 2 * tc * H)


def itempass_tile(H: int, KC: int, KM: int) -> tuple[int, int]:
    """(TC, R) of an item-pass block at screen height H and clip / mid
    capacities KC / KM: TC columns, 32 while `itempass_smem_bytes` fits
    the SMEM_BLOCK_BYTES a block may use, else as many as fit; R threads
    a column, each folding a band of about BAND_ROWS rows."""
    for tc in range(32, 0, -1):
        bands = max(1, min(-(-H // BAND_ROWS), MAX_BLOCK_THREADS // tc))
        if itempass_smem_bytes(tc, bands, H, KC, KM) <= SMEM_BLOCK_BYTES:
            return tc, bands
    raise ValueError(f"item_pass: height {H} and pools {KC} / {KM} leave "
                     f"no column within {SMEM_BLOCK_BYTES} bytes")


def itempass_blocks_per_sm(H: int, KC: int, KM: int) -> int:
    """Item-pass blocks one SM of this card holds (the CUDA occupancy
    calculator, from the built kernel's registers and the block's
    shared memory)."""
    from doomtpu_torch.ops.build import load_library

    tc, bands = itempass_tile(H, KC, KM)
    return load_library("itempass").doom_itempass_blocks_per_sm(
        tc, bands, H, KC, KM)


@spanned("doom.itempass")
def item_pass(level: DeviceLevel, cfg: RenderConfig, items: dict,
              paint_out: dict):
    """Paint `items` (render/things.item_pack) over the paint frame of
    `paint_out` (ops/paint.render_paint), whose idx / ld / rgb are
    updated in place and returned.  CUDA tensors launch the kernel
    (csrc/itempass.cu); CPU tensors run `item_pass_reference`.  Anything
    else raises."""
    _check(level, cfg, items, paint_out)
    idx = paint_out["idx"]
    if idx.device.type == "cpu":
        return item_pass_reference(level, cfg, items, paint_out)
    if idx.device.type != "cuda":
        raise ValueError(f"item_pass: no kernel for device {idx.device}")
    from doomtpu_torch.ops.build import load_library

    clip, mid = pools_from_paint(paint_out)
    ld, rgb = paint_out["ld"], paint_out["rgb"]
    lib = load_library("itempass")
    B, H, W = idx.shape
    KC, KM = clip["span"].shape[1], mid["span"].shape[1]
    tc, bands = itempass_tile(H, KC, KM)
    pc = _picture_columns(level)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = lib.doom_itempass(
        ptr(items["i"]), ptr(items["f"]), items["i"].shape[1],
        *[ptr(clip[k]) for k in CLIP_FIELDS], ptr(clip["cnt"]),
        *[ptr(mid[k]) for k in MID_FIELDS], ptr(mid["cnt"]),
        ptr(level.atlas_cm), level.atlas_cm.numel(), level.atlas_rows,
        pc["T"], pc["TW"], pc["spr0"], pc["PW"], ptr(level.palette_packed),
        B, W, H, KC, KM, _consts(cfg)["inv_255"], tc, bands,
        ptr(idx), ptr(ld), ptr(rgb), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"item-pass kernel launch failed: CUDA error {err} "
                           f"({lib.doom_itempass_error_string(err).decode()})")
    item_pass.launches += 1
    return idx, ld, rgb


item_pass.launches = 0


def _texels(level: DeviceLevel, pic, tyv, tx):
    """(texel, opaque) of picture `pic` at row tyv and column
    clamp(tx, 0, 127), as the JAX kernel's item_q / item_mq give them."""
    pc = _picture_columns(level)
    rows = level.atlas_rows
    c = torch.clamp(tx, 0, PIC_SIZE - 1)
    is_tex = pic < pc["T"]
    col = torch.where(is_tex, pic * pc["TW"],
                      pc["spr0"] + (pic - pc["T"]) * pc["PW"]) + c
    t_ix = torch.clamp(col * rows + tyv, 0, level.atlas_cm.numel() - 1)
    packed = level.atlas_cm[t_ix.long()]
    opaque = (((packed & 0x100) != 0)
              & (c < torch.where(is_tex, pc["TW"], pc["PW"]))
              & (tyv < min(rows, PIC_SIZE)))
    return packed & 0xFF, opaque


def item_pass_reference(level: DeviceLevel, cfg: RenderConfig, items: dict,
                        paint_out: dict):
    """Plain PyTorch item pass: a Python loop over the items in pack
    order, each with per-column math over the cameras whose columns it
    covers and [cameras, rows, W] masks for its rows, then the shade.
    Same arguments and in-place outputs as `item_pass`, and the same
    bits."""
    clip, mid = _check(level, cfg, items, paint_out)
    idx, ld, rgb = (paint_out[k] for k in ("idx", "ld", "rgb"))
    ip, fp = items["i"], items["f"]
    B, H, W = idx.shape
    dev = idx.device
    KC, KM = clip["span"].shape[1], mid["span"].shape[1]
    TW = level.tex_pixels.shape[2]
    xx = torch.arange(W, dtype=I32, device=dev)[None]           # [1, W]
    kc_iota = torch.arange(KC, dtype=I32, device=dev)[None, :, None]
    km_iota = torch.arange(KM, dtype=I32, device=dev)[None, :, None]
    pidx = torch.zeros_like(idx)
    pld = torch.zeros_like(idx)
    one = 1.0

    for n in range(ip.shape[1]):
        fl = ip[:, n, IPI_FL:IPI_FL + 1]
        in_r = (((fl & 1) != 0) & (xx >= ip[:, n, IPI_X0:IPI_X0 + 1])
                & (xx < ip[:, n, IPI_X1E:IPI_X1E + 1]))          # [B, W]
        cams = in_r.any(1).nonzero()[:, 0]
        if cams.numel() == 0:
            continue
        in_r = in_r[cams]
        iv = lambda k: ip[cams, n, k:k + 1]                      # [nb, 1]
        fv = lambda k: fp[cams, n, k:k + 1]
        spr = (iv(IPI_FL) & 2) != 0
        soff = iv(IPI_SOFF)

        # the sprite's billboard math
        xb = f32(xx - iv(IPI_BSX))
        ax = fdiv(xb, fv(IPF_DX))
        denom = smul(one - ax, fv(IPF_INV0)) + smul(ax, fv(IPF_INV1))
        u = fdiv(smul(one - ax, fv(IPF_Z0)) + smul(ax, fv(IPF_Z1)), denom)
        lw = iv(IPI_LW)
        s_tx = wrap_tex(as_i16(u) + soff, torch.clamp(lw >> 16, min=1))
        s_zd = as_i16(fdiv((one - ax) + ax, denom))
        s_by = as_i16(fv(IPF_YBS) + smul(xb, fv(IPF_YBD)))
        s_ty = as_i16(fv(IPF_YTS) + smul(xb, fv(IPF_YTD)))

        # the sprite's seg clip over the column's clip records
        top, bottom = clip_record_bounds(
            {k: clip[k][cams] for k in CLIP_FIELDS},             # [nb, KC, W]
            fv(IPF_VPX)[..., None], fv(IPF_VPY)[..., None],
            kc_iota < clip["cnt"][cams][:, None], H)
        tsc, bsc = top.amax(1), bottom.amin(1)
        s_ct = torch.maximum(torch.clamp(s_ty, min=0), tsc)
        s_cb = torch.minimum(torch.clamp(s_by, max=H - 1), bsc)

        # the mid's draw data: the last matching record of its mid pool
        m = lambda k: mid[k][cams]                               # [nb, KM, W]
        ms = m("span")
        hit = ((((ms >> 29) & 3) == KIND_MID)
               & (km_iota < mid["cnt"][cams][:, None])
               & (m("d6") == soff[..., None]))
        k_last = torch.where(hit, km_iota, -1).amax(1)           # [nb, W]
        found = k_last >= 0
        at = lambda k: torch.gather(m(k), 1, torch.clamp(k_last, min=0)
                                    [:, None].long())[:, 0]
        w_m, d1, d2, d3, d4 = at("span"), at("d1"), at("d2"), at("d3"), \
            at("d4")

        pres = in_r & (spr | found)
        ct = torch.where(spr, s_ct, ((w_m >> 8) & 255) - 1)
        cb = torch.where(spr, s_cb, (w_m & 255) - 1)
        by = torch.where(spr, s_by, d2 >> 16)
        ty = torch.where(spr, s_ty, unpack16_lo(d2))
        tx = torch.where(spr, s_tx, d1 - iv(IPI_PIC) * TW)
        offy = torch.where(spr, 0, d3 >> 16)
        th = torch.where(spr, iv(IPI_TH), unpack16_lo(d3))
        light = torch.where(spr, lw & 0xFFFF, d4 >> 16)
        zd = torch.where(spr, s_zd, unpack16_lo(d4))
        uy1 = torch.where(spr, fv(IPF_UY1), at("d5").view(F32))
        if not bool(pres.any()):
            continue
        ylo = max(int(ct[pres].min()), 0)
        yhi = min(int(cb[pres].max()), H - 1)
        if ylo > yhi:
            continue

        # its rows: opaque texels overwrite
        ys = torch.arange(ylo, yhi + 1, dtype=I32, device=dev)[None, :, None]
        e = lambda v: v[:, None]                                 # [nb, 1, W]
        cover = e(pres) & (ys >= e(ct)) & (ys <= e(cb))
        ay = fdiv(f32(ys - e(ty)), f32(e(by) - e(ty)))
        thb = e(torch.clamp(th, min=1))
        tyv = wrap_tex(as_i16(f32(e(th)) + smul(ay, e(uy1))) + e(offy), thb)
        texel, opaque = _texels(level, iv(IPI_PIC)[..., None], tyv, e(tx))
        wr = cover & opaque
        ldw = e((light << 16) | (zd & 0xFFFF) | LD_WRITTEN)
        sl = slice(ylo, yhi + 1)
        pidx[cams, sl] = torch.where(wr, texel, pidx[cams, sl])
        pld[cams, sl] = torch.where(wr, ldw, pld[cams, sl])

    # shade the written pixels and merge them over the frame
    return shade_over(level, cfg, (pld & LD_WRITTEN) != 0, pidx, pld, idx, ld,
                      rgb)
