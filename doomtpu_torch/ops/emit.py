"""The item pool's emission: which selected items each screen column
holds, in which slot, and each slot's words.

Counterpart of the item pool's presence, emission, per-slot sprite math
and mid fill in doomtpu/render/things.py::item_pool (XLA code there, no
`pl.pallas_call`).  `emit` launches the hand-written CUDA kernel
(csrc/emit.cu) on CUDA tensors and runs `emit_reference`, its plain
PyTorch version, on CPU tensors.  Both give the same bits.

The inputs are the item pack (render/things.item_pack: per camera the N
selected items in painter order, slot N-1 the nearest, as IPI_ROWS i32
and IPF_ROWS f32 words; a mid carries its seg id in IPI_SOFF) and the mid
pool (ops/paint.pools_from_paint or render/things.pools_from_unified:
[B, KM, W] planes, read through their strides, and cnt [B, W]).  Per
camera and screen column:

- item n is present where it is valid and either a sprite with
  x0 <= x < x1e, or a mid whose seg id some record k < cnt of kind
  KIND_MID in the column's mid pool carries;
- nearest first, the first KI = item_capacity present items take slots
  0..KI-1; the rest count in item_overflow (the farthest-first drop),
  and the column's full count is its share of item_peak (the largest
  over the camera's columns); icnt = min(count, KI);
- a sprite slot holds the billboard column's eight words (ITEM_PLANES,
  ops/items.py): ct+1 | cb+1 << 16 | SPR_MARK with the screen clamp
  only, the atlas column, by | ty, 0 | th, light | zdist, and the bits
  of uy1, vpx and vpy;
- a mid slot holds the word (ct+1 | cb+1) and d1..d5 of the last
  (largest k) matching record of its column, planes 6-7 zero;
- every other slot is 0.

Returns (ipool [ITEM_PLANES, B, KI, W] i32, icnt [B, W] i32,
item_overflow [B] i32, item_peak [B] i32).
"""

from __future__ import annotations

import ctypes

import torch

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.ops.itempass import (
    IPF_DX, IPF_INV0, IPF_INV1, IPF_ROWS, IPF_UY1, IPF_VPX, IPF_VPY,
    IPF_YBD, IPF_YBS, IPF_YTD, IPF_YTS, IPF_Z0, IPF_Z1, IPI_BSX, IPI_FL,
    IPI_LW, IPI_PIC, IPI_ROWS, IPI_SOFF, IPI_TH, IPI_X0, IPI_X1E,
    MID_FIELDS,
)
from doomtpu_torch.ops.items import ITEM_PLANES, SPR_MARK
from doomtpu_torch.ops.layout import KIND_MID, pack16
from doomtpu_torch.ops.paint import SMEM_BLOCK_BYTES
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    F32, I32, as_i16, f32, fdiv, smul, wrap_tex,
)

MAX_BLOCK_THREADS = 512    # csrc/emit.cu's MAX_THREADS


def _check(level: DeviceLevel, cfg: RenderConfig, pack: dict, mid: dict):
    ip, fp = pack["i"], pack["f"]
    dev = ip.device
    if ip.dim() != 3:
        raise ValueError(f"emit: pack i must be [B, N, {IPI_ROWS}], got "
                         f"{tuple(ip.shape)}")
    B, N, _ = ip.shape
    W = cfg.width
    KM = mid["span"].shape[1] if mid["span"].dim() == 3 else -1
    want = {"pack i": (ip, I32, (B, N, IPI_ROWS)),
            "pack f": (fp, F32, (B, N, IPF_ROWS)),
            "mid cnt": (mid["cnt"], I32, (B, W))}
    for k in MID_FIELDS:
        want[f"mid {k}"] = (mid[k], I32, (B, KM, W))
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"emit: {name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"emit: {name} is on {t.device}, pack on {dev}")
    if N < 1:
        raise ValueError("emit: the pack holds no item")
    for name in ("pack i", "pack f", "mid cnt"):
        if not want[name][0].is_contiguous():
            raise ValueError(f"emit: {name} must be contiguous")
    if cfg.item_capacity < 0:
        raise ValueError(f"emit: item_capacity {cfg.item_capacity} < 0")


def emit_smem_bytes(threads: int, N: int, KI: int, G: int,
                    table: bool) -> int:
    """Shared memory of an emission block of `threads` columns
    (csrc/emit.cu): a slot list (KI words) and a mid mask (a bit an
    item) a column, the warps' reductions and, with `table`, the
    seg -> item table (a word a seg)."""
    return 4 * (threads * (KI + -(-N // 32)) + 2 * (threads // 32)
                + (G if table else 0))


def emit_block(W: int, N: int, KI: int, G: int) -> tuple[int, bool]:
    """(threads, table) of an emission block within SMEM_BLOCK_BYTES: a
    thread a column, the screen's width rounded up to warps, at most
    MAX_BLOCK_THREADS (a wider screen in passes), fewer where the block
    does not fit; with the seg -> item table in shared memory where any
    warp count fits beside it, else without (a walk of the pack a
    lookup)."""
    top = min(-(-W // 32) * 32, MAX_BLOCK_THREADS)
    for table in (True, False):
        for threads in range(top, 0, -32):
            if emit_smem_bytes(threads, N, KI, G, table) <= SMEM_BLOCK_BYTES:
                return threads, table
    raise ValueError(f"emit: {N} items at item capacity {KI} leave no "
                     f"warp of columns within {SMEM_BLOCK_BYTES} bytes")


def emit_blocks_per_sm(W: int, N: int, KI: int, G: int) -> int:
    """Emission blocks one SM of this card holds (the CUDA occupancy
    calculator, from the built kernel's registers and the block's shared
    memory)."""
    from doomtpu_torch.ops.build import load_library

    threads, table = emit_block(W, N, KI, G)
    return load_library("emit").doom_emit_blocks_per_sm(threads, N, KI, G,
                                                        int(table))


def emit(level: DeviceLevel, cfg: RenderConfig, pack: dict, mid: dict):
    """The item pool of `pack` (render/things.item_pack) over the mid
    pool `mid`.  CUDA tensors launch the kernel (csrc/emit.cu), counted
    in `emit.launches`; CPU tensors run `emit_reference`.  Anything else
    raises."""
    from doomtpu_torch.ops.build import load_library

    _check(level, cfg, pack, mid)
    ip, fp = pack["i"], pack["f"]
    dev = ip.device
    if dev.type == "cpu":
        return emit_reference(level, cfg, pack, mid)
    if dev.type != "cuda":
        raise ValueError(f"emit: no kernel for device {dev}")
    strides = {mid[k].stride() for k in MID_FIELDS}
    if len(strides) != 1:
        raise ValueError(f"emit: the kernel reads the mid planes through one "
                         f"set of strides; they have {sorted(strides)}")
    lib = load_library("emit")
    B, N, _ = ip.shape
    W, H, KI = cfg.width, cfg.height, cfg.item_capacity
    G = level.num_segs
    threads, table = emit_block(W, N, KI, G)
    ipool = torch.empty((ITEM_PLANES, B, KI, W), dtype=I32, device=dev)
    icnt = torch.empty((B, W), dtype=I32, device=dev)
    overflow = torch.empty((B,), dtype=I32, device=dev)
    peak = torch.empty((B,), dtype=I32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.doom_emit(
        ptr(ip), ptr(fp), N, *[ptr(mid[k]) for k in MID_FIELDS],
        ptr(mid["cnt"]), *mid["span"].stride(), mid["span"].shape[1], B, W,
        H, KI, G, level.tex_pixels.shape[0], level.col_spr_off,
        level.spr_pw, threads, int(table), ptr(ipool), ptr(icnt),
        ptr(overflow), ptr(peak), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"emission kernel launch failed: CUDA error {err} "
                           f"({lib.doom_emit_error_string(err).decode()})")
    emit.launches += 1
    return ipool, icnt, overflow, peak


emit.launches = 0


def emit_reference(level: DeviceLevel, cfg: RenderConfig, pack: dict,
                   mid: dict):
    """Plain PyTorch emission, in one pass over the batch: presence
    [B, N, W], a reversed cumsum over the items for the slots, a scatter
    of item ids into a slot -> item table, per-slot gathers of the
    pack's words and the sprite column math, and the mid fill (a
    scatter_reduce of record ids, then gathers).  Same arguments and
    outputs as `emit`, and the same bits."""
    _check(level, cfg, pack, mid)
    ip, fp = pack["i"], pack["f"]
    B, N, _ = ip.shape
    W, H, KI = cfg.width, cfg.height, cfg.item_capacity
    G = level.num_segs
    dev = ip.device
    row, frow = (lambda r: ip[:, :, r]), (lambda r: fp[:, :, r])
    fl = row(IPI_FL)
    sel_valid, is_spr = (fl & 1) != 0, (fl & 2) != 0
    xcol = torch.arange(W, dtype=I32, device=dev)

    # ---- presence [B, N, W] -------------------------------------------
    pres = torch.zeros((B, N + 1, W), dtype=torch.bool, device=dev)
    pres[:, :N] = ((xcol >= row(IPI_X0)[..., None])
                   & (xcol < row(IPI_X1E)[..., None]) & is_spr[..., None])
    m_span, m_d6 = mid["span"], mid["d6"]                  # [B, KM, W]
    KM = m_span.shape[1]
    k_iota = torch.arange(KM, dtype=I32, device=dev)[None, :, None]
    mid_slot = (((m_span >> 29) & 3) == KIND_MID) & (
        k_iota < mid["cnt"][:, None, :])
    # seg -> selected mid item; each valid mid-pool entry then marks its
    # item present in its column (item n present iff some valid mid-pool
    # slot of the column holds n's seg)
    want = ~is_spr & sel_valid
    seg_to_n = torch.full((B, G + 1), -1, dtype=I32, device=dev)
    seg_to_n.scatter_(
        1, torch.where(want, row(IPI_SOFF), G).long(),
        torch.arange(N, dtype=I32, device=dev)[None].expand(B, N),
    )
    seg_to_n[:, G] = -1
    n_e = torch.gather(
        seg_to_n, 1, torch.where(mid_slot, m_d6, G).reshape(B, -1).long()
    ).reshape(B, KM, W)                                       # [B, KM, W]
    pres.scatter_(1, torch.where(n_e >= 0, n_e, N).long(), True)
    pres = pres[:, :N] & sel_valid[..., None]

    # ---- emission: nearest item first (slot 0) -------------------------
    rc = torch.flip(torch.cumsum(torch.flip(pres, [1]), 1, dtype=I32), [1])
    fits = rc <= KI
    item_overflow = (pres & ~fits).sum((1, 2), dtype=I32)
    item_peak = rc[:, 0].amax(1)
    icnt = torch.clamp(rc[:, 0], max=KI)
    slot_of = torch.where(pres & fits, rc - 1, KI).long()      # [B, N, W]
    tab = torch.full((B, KI + 1, W), -1, dtype=I32, device=dev)
    tab.scatter_(1, slot_of,
                 torch.arange(N, dtype=I32, device=dev)[None, :, None]
                 .expand(B, N, W))
    tab = tab[:, :KI]                                         # [B, KI, W]
    used = tab >= 0
    n_ix = torch.clamp(tab, min=0).reshape(B, KI * W).long()

    def per_slot(x):
        """[B, N] per-item values -> [B, KI, W] per pool slot."""
        return torch.gather(x, 1, n_ix).reshape(B, KI, W)

    zero_s = torch.zeros((B, KI, W), dtype=I32, device=dev)
    is_spr_slot = per_slot(is_spr) & used

    # ---- sprite per-slot column math ------------------------------------
    one = 1.0
    lw = row(IPI_LW)
    f = {
        "bsx": row(IPI_BSX), "dx": frow(IPF_DX),
        "inv0": frow(IPF_INV0), "inv1": frow(IPF_INV1),
        "z0": frow(IPF_Z0), "z1": frow(IPF_Z1),
        "soffi": row(IPI_SOFF), "wpic": lw >> 16,
        "pic": row(IPI_PIC) - level.tex_pixels.shape[0], "th": row(IPI_TH),
        "light": lw & 0xFFFF,
        "ybs": frow(IPF_YBS), "ybd": frow(IPF_YBD),
        "yts": frow(IPF_YTS), "ytd": frow(IPF_YTD),
        "uy1": frow(IPF_UY1), "vpx": frow(IPF_VPX), "vpy": frow(IPF_VPY),
    }
    sc = {k: per_slot(v) for k, v in f.items()}
    xw = xcol[None, None]                                     # [1, 1, W]
    xbf = f32(xw - sc["bsx"])
    ax = fdiv(xbf, sc["dx"])
    denom = smul(one - ax, sc["inv0"]) + smul(ax, sc["inv1"])
    u = fdiv(smul(one - ax, sc["z0"]) + smul(ax, sc["z1"]), denom)
    s_tx = wrap_tex(as_i16(u) + sc["soffi"], torch.clamp(sc["wpic"], min=1))
    s_zd = as_i16(fdiv((one - ax) + ax, denom))
    s_by = as_i16(sc["ybs"] + smul(xbf, sc["ybd"]))
    s_ty = as_i16(sc["yts"] + smul(xbf, sc["ytd"]))
    # the screen clamp only: the item kernel applies the seg clip.  The
    # upper clamp to H keeps ct+1 inside the word's 9-bit field (ct == H
    # draws nothing, like any ct > H)
    s_ct = torch.clamp(torch.clamp(s_ty, min=0), max=H)
    s_cb = torch.clamp(s_by, max=H - 1)
    spr_planes = [
        pack16(s_ct + 1, s_cb + 1) | SPR_MARK,
        level.col_spr_off + sc["pic"] * level.spr_pw + s_tx,
        pack16(s_by, s_ty),
        pack16(zero_s, sc["th"]),
        pack16(sc["light"], s_zd),
        sc["uy1"].view(I32), sc["vpx"].view(I32), sc["vpy"].view(I32),
    ]
    planes = [torch.where(is_spr_slot, p, 0) for p in spr_planes]

    if KM == 0:
        return torch.stack(planes), icnt, item_overflow, item_peak

    # ---- mid slots: filled from the mid pool -----------------------------
    # the pool slot each valid mid-pool entry's item took in its column;
    # the last (largest k) matching entry wins, as in JAX
    ok_e = n_e >= 0
    slot_e = torch.gather(rc, 1, torch.clamp(n_e, min=0).long()) - 1
    src = torch.full((B, KI + 1, W), -1, dtype=I32, device=dev)
    src.scatter_reduce_(
        1, torch.where(ok_e & (slot_e < KI), slot_e, KI).long(),
        k_iota.expand(B, KM, W), "amax",
    )
    src = src[:, :KI]
    is_mid_slot = used & ~is_spr_slot & (src >= 0)
    k_ix = torch.clamp(src, min=0).long()
    take = lambda p: torch.gather(p, 1, k_ix)
    w_new = pack16((m_span >> 8) & 255, m_span & 255)
    mid_planes = [w_new] + [mid[k] for k in ("d1", "d2", "d3", "d4", "d5")]
    for i, p in enumerate(mid_planes):
        planes[i] = torch.where(is_mid_slot, take(p), planes[i])
    return torch.stack(planes), icnt, item_overflow, item_peak
