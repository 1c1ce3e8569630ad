"""The item composite: the deferred pass's item pool folded over the
paint frame.

Counterpart of doomtpu/ops/pallas_items.py.  `composite_items` launches
the hand-written CUDA kernel (csrc/items.cu) on CUDA tensors and runs
`composite_items_reference`, its plain PyTorch version, on CPU tensors.
Both give the same bits.

What is computed, per camera and screen column, over the column's
`icnt` pool slots from the farthest (slot icnt-1) to the nearest (0):

- with a clip pool, a sprite slot's rows [ct, cb] are first clipped
  against every clip record of the column whose seg lies in front of
  the sprite (renderer/map_objects.rs:127-166; the JAX `_kernel`'s
  in-kernel clip, or the XLA clip reductions of render/things.py);
- per row y in [ct, cb]: ay = (y - ty) / (by - ty), texel row
  wrap_tex(as_i16(th + ay * uy1) + off_y, th), texel and opacity from
  the column atlas; opaque texels overwrite (the painter's order,
  map_objects.rs:216-240);
- the written pixels are shaded (palette, light diminish,
  bitmap_render.rs:190-208) and merged over idx / ld / rgb, with
  ld = light | zdist | written.

Pools are slot-major: each item plane is [B, KI, W] (`ipool` stacks
ITEM_PLANES of them, see render/things.py), each clip plane [B, KC, W].
idx / ld / rgb [B, H, W] are updated in place and returned.
"""

from __future__ import annotations

import ctypes

import torch

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.ops.layout import (
    KIND_MID, LD_WRITTEN, SPAN_DC, SPAN_E2B, SPAN_E2T,
)
from doomtpu_torch.ops.paint import SMEM_BLOCK_BYTES, _consts
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    F32, I32, as_i16, f32, fdiv, is_left_of, smul, wrap_tex,
)
from doomtpu_torch.render.resolve import unpack16_lo

SPR_MARK = 1 << 29   # item word flag: the slot is a sprite (seg-clippable)
# word, atlas column, by|ty, off_y|th, light|zdist, uy1 bits, vpx, vpy
ITEM_PLANES = 8
CLIP_FIELDS = ("span", "d2", "lsx", "lsy", "lex", "ley")


def _check(level: DeviceLevel, cfg: RenderConfig, ipool, icnt, idx, ld, rgb,
           clip):
    dev = idx.device
    P, B, KI, W = ipool.shape
    H = cfg.height
    need = ITEM_PLANES if clip is not None else ITEM_PLANES - 2
    want = {"ipool": (ipool, (P, B, KI, W)), "icnt": (icnt, (B, W)),
            "idx": (idx, (B, H, W)), "ld": (ld, (B, H, W)),
            "rgb": (rgb, (B, H, W))}
    if clip is not None:
        KC = clip["span"].shape[1]
        want.update({f"clip {k}": (clip[k], (B, KC, W)) for k in CLIP_FIELDS})
        want["clip cnt"] = (clip["cnt"], (B, W))
    for name, (t, shape) in want.items():
        if t.dtype != I32 or tuple(t.shape) != shape:
            raise ValueError(f"composite_items: {name} must be int32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"composite_items: {name} is on {t.device}, idx "
                             f"on {dev}")
    if P < need or W != cfg.width:
        raise ValueError(f"composite_items: ipool has {P} planes of width "
                         f"{W}; need {need} of width {cfg.width}")
    for name in ("atlas_cm", "palette_packed"):
        t = getattr(level, name)
        if t.device != dev or t.dtype != I32 or not t.is_contiguous():
            raise ValueError(f"composite_items: level.{name} must be "
                             f"contiguous int32 on {dev}")


# rows a band of the item kernel's block holds (see paint.BAND_ROWS);
# timed on the card (PERF.md)
BAND_ROWS = 13
CLIP_RECORD_WORDS = 5    # csrc/layout.cuh's staged clip record
MAX_BLOCK_THREADS = 512  # csrc/items.cu's MAX_THREADS


def items_smem_bytes(tc: int, H: int, KI: int, KC: int) -> int:
    """Shared memory of an item-kernel block (csrc/items.cu): a mark a
    pixel, two words a slot and a staged clip record a clip slot, for
    `tc` columns."""
    return 4 * tc * (H + 2 * KI + CLIP_RECORD_WORDS * KC)


def items_tile(H: int, KI: int, KC: int) -> tuple[int, int]:
    """(TC, R) of an item-kernel block at screen height H, item capacity
    KI and clip capacity KC: TC columns, 32 while their shared memory
    (a mark a pixel, two words a slot, a staged clip record a clip slot)
    fits the SMEM_BLOCK_BYTES a block may use, else as many as fit; R
    threads a column, each shading a band of about BAND_ROWS rows."""
    per_column = items_smem_bytes(1, H, KI, KC)
    tc = min(32, SMEM_BLOCK_BYTES // per_column)
    if tc < 1:
        raise ValueError(f"composite_items: {per_column} bytes a column "
                         f"exceed the {SMEM_BLOCK_BYTES} a block may use")
    return tc, max(1, min(-(-H // BAND_ROWS), MAX_BLOCK_THREADS // tc))


def items_blocks_per_sm(H: int, KI: int, KC: int) -> int:
    """Item-kernel blocks one SM of this card holds (the CUDA occupancy
    calculator, from the built kernel's registers and the block's
    shared memory)."""
    from doomtpu_torch.ops.build import load_library

    tc, bands = items_tile(H, KI, KC)
    return load_library("items").doom_items_blocks_per_sm(tc, bands, H, KI,
                                                          KC)


def composite_items(level: DeviceLevel, cfg: RenderConfig, ipool, icnt, idx,
                    ld, rgb, clip=None):
    """Fold the item pool into (idx, ld, rgb), in place.  CUDA tensors
    launch the kernel (csrc/items.cu); CPU tensors run
    `composite_items_reference`.  Anything else raises.

    ipool: [ITEM_PLANES, B, KI, W] i32 (planes 6-7, vpx / vpy, are read
    only with a clip pool); icnt [B, W]; clip: None or the clip pool of
    render/things.pools_from_paint ([B, KC, W] planes and cnt)."""
    _check(level, cfg, ipool, icnt, idx, ld, rgb, clip)
    if idx.device.type == "cpu":
        return composite_items_reference(level, cfg, ipool, icnt, idx, ld,
                                         rgb, clip)
    if idx.device.type != "cuda":
        raise ValueError(f"composite_items: no kernel for device {idx.device}")
    from doomtpu_torch.ops.build import load_library

    lib = load_library("items")
    _, B, KI, W = ipool.shape
    c = lambda t: t.contiguous()
    planes = [c(ipool[i]) for i in range(ipool.shape[0])]
    icnt = c(icnt)
    for name, t in (("idx", idx), ("ld", ld), ("rgb", rgb)):
        if not t.is_contiguous():
            raise ValueError(f"composite_items: {name} must be contiguous "
                             "(it is updated in place)")
    if clip is not None:
        cp = [c(clip[k]) for k in CLIP_FIELDS] + [c(clip["cnt"])]
        KC = clip["span"].shape[1]
    else:
        cp = [None] * (len(CLIP_FIELDS) + 1)
        KC = 0
        planes += [None] * (ITEM_PLANES - len(planes))
    tc, bands = items_tile(cfg.height, KI, KC)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = lib.doom_items(
        *[ptr(t) for t in planes[:ITEM_PLANES]], ptr(icnt),
        ptr(level.atlas_cm), level.atlas_cm.numel(), level.atlas_rows,
        ptr(level.palette_packed), *[ptr(t) for t in cp],
        B, W, cfg.height, KI, KC, _consts(cfg)["inv_255"], tc, bands,
        ptr(idx), ptr(ld), ptr(rgb), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"items kernel launch failed: CUDA error {err} "
                           f"({lib.doom_items_error_string(err).decode()})")
    composite_items.launches += 1
    return idx, ld, rgb


composite_items.launches = 0


def clipped_words(ipool, clip, H: int):
    """The word plane with the sprite seg clip applied, as the JAX XLA
    path packs it (render/things.py clip reductions): on sprite slots
    ct' = min(max(ct, tsc), H) and cb' = min(cb, bsc), where tsc / bsc
    are the tightest top / bottom of the clip records in front of the
    sprite.  Folding these words without a clip pool gives the same
    frame as folding ipool with one."""
    word = ipool[0]
    B, KI, W = word.shape
    vpx, vpy = ipool[6].view(F32), ipool[7].view(F32)
    tsc = torch.full((B, KI, W), -1, dtype=I32, device=word.device)
    bsc = torch.full((B, KI, W), H, dtype=I32, device=word.device)
    for kc in range(clip["span"].shape[1]):
        rec = {k: clip[k][:, kc:kc + 1] for k in CLIP_FIELDS}   # [B, 1, W]
        top, bottom = clip_record_bounds(
            rec, vpx, vpy, (kc < clip["cnt"])[:, None], H)
        tsc = torch.maximum(tsc, top)
        bsc = torch.minimum(bsc, bottom)
    ct = ((word >> 16) & 0x1FF) - 1
    cb = unpack16_lo(word) - 1
    ct = torch.clamp(torch.maximum(ct, tsc), max=H)
    cb = torch.minimum(cb, bsc)
    clipped = (((ct + 1) & 0xFFFF) << 16) | ((cb + 1) & 0xFFFF) | SPR_MARK
    return torch.where((word & SPR_MARK) != 0, clipped, word)


def clip_record_bounds(rec: dict, vx, vy, valid, H: int):
    """One clip record's bounds on a sprite at view-space (vx, vy)
    (map_objects.rs:127-166): (top, bottom), -1 / H where the record is
    not `valid` or its seg lies behind the sprite.  `rec` holds the
    CLIP_FIELDS planes (broadcasting with vx, vy, valid); a column's
    clip is the max of its records' tops and the min of their bottoms."""
    f = lambda k: rec[k].view(F32)
    cw, d2 = rec["span"], rec["d2"]
    front = valid & ~is_behind_vertex(f("lsx"), f("lsy"), f("lex"), f("ley"),
                                      vx, vy)
    is_mid = ((cw >> 29) & 3) == KIND_MID
    dc = ((cw & SPAN_DC) != 0) & is_mid
    top = torch.maximum(
        torch.where(front & ((cw & SPAN_E2T) != 0), (cw & 255) - 1, -1),
        torch.where(front & dc, unpack16_lo(d2), -1))
    bottom = torch.minimum(
        torch.where(front & ((cw & SPAN_E2B) != 0), ((cw >> 8) & 255) - 1, H),
        torch.where(front & is_mid, d2 >> 16, H))
    return top, bottom


def is_behind_vertex(lsx, lsy, lex, ley, vx, vy):
    """bitmap_render.rs:137-165 (batched, broadcasting args): the seg
    ls -> le is not in front of the vertex v."""
    min_x = torch.minimum(lsx, lex)
    max_x = torch.maximum(lsx, lex)
    return (min_x > vx) | (
        (max_x > vx) & ~is_left_of(vx, vy, lsx, lsy, lex, ley)
    )


def composite_items_reference(level: DeviceLevel, cfg: RenderConfig, ipool,
                              icnt, idx, ld, rgb, clip=None):
    """Plain PyTorch composite: the clip reductions, then the XLA fold of
    render/things.py (a Python loop over slots, farthest first, with
    [B, H, W] masks), then the shade.  Same arguments and in-place
    outputs as `composite_items`, and the same bits."""
    _check(level, cfg, ipool, icnt, idx, ld, rgb, clip)
    H = cfg.height
    dev = idx.device
    KI = ipool.shape[2]
    word = clipped_words(ipool, clip, H) if clip is not None else ipool[0]
    rows = level.atlas_rows
    n_atlas = level.atlas_cm.numel()
    yy = torch.arange(H, dtype=I32, device=dev)[None, :, None]
    texel_v = torch.zeros_like(idx)
    lz_v = torch.zeros_like(idx)
    touched = torch.zeros(idx.shape, dtype=torch.bool, device=dev)
    for k in reversed(range(KI)):
        ok = (k < icnt)[:, None, :]                           # [B, 1, W]
        if not bool(ok.any()):
            continue
        plane = lambda i: ipool[i][:, k][:, None, :]          # [B, 1, W]
        w_k = word[:, k][:, None, :]
        ct = ((w_k >> 16) & 0x1FF) - 1
        cb = unpack16_lo(w_k) - 1
        by, ty = plane(2) >> 16, unpack16_lo(plane(2))
        off_y, th = plane(3) >> 16, unpack16_lo(plane(3))
        uy1 = plane(5).view(F32)
        cover = ok & (yy >= ct) & (yy <= cb)
        ay = fdiv(f32(yy - ty), f32(by - ty))
        tyv = as_i16(f32(th) + smul(ay, uy1)) + off_y
        tyv = wrap_tex(tyv, torch.clamp(th, min=1))
        t_ix = torch.clamp(plane(1) * rows + tyv, 0, n_atlas - 1)
        packed = level.atlas_cm[t_ix.long()]
        write = cover & ((packed & 0x100) != 0)
        texel_v = torch.where(write, packed & 0xFF, texel_v)
        lz_v = torch.where(write, plane(4), lz_v)
        touched = touched | write
    return shade_over(level, cfg, touched, texel_v, lz_v | LD_WRITTEN, idx, ld,
                      rgb)


def shade_over(level: DeviceLevel, cfg: RenderConfig, touched, texel, ldw,
               idx, ld, rgb):
    """The item pixels `touched` marks, shaded from their texel and
    written ld word ldw (bitmap_render.rs:190-208: palette, light
    diminish; light / 255 is the multiply by f32(1/255) that XLA makes
    of it) and merged over idx / ld / rgb in place."""
    factor = (f32((ldw >> 16) & 0xFF) * _consts(cfg)["inv_255"]
              - smul(f32(unpack16_lo(ldw)), 1.0 / 4096.0))
    factor = torch.clamp(factor, min=0.0)
    rgbw = level.palette_packed[texel.long()]
    shaded = torch.zeros_like(idx)
    for shift in (16, 8, 0):
        chan = f32((rgbw >> shift) & 0xFF)
        byte = torch.clamp(torch.trunc(chan * factor), 0.0, 255.0).to(I32)
        shaded = shaded | (byte << shift)
    idx.copy_(torch.where(touched, texel, idx))
    ld.copy_(torch.where(touched, ldw, ld))
    rgb.copy_(torch.where(touched, shaded, rgb))
    return idx, ld, rgb

