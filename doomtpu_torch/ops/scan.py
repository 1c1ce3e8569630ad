"""The wall scan: the unified span pool of the scan + resolve pipeline.

Counterpart of doomtpu/ops/pallas_scan.py (and of the seg walk of
doomtpu/render/walls.py::wall_scan, which it reproduces).  `scan`
launches the hand-written CUDA kernel (csrc/scan.cu) on CUDA tensors and
runs `scan_reference`, its plain PyTorch version, on CPU tensors.  Both
give the same bits in every slot below a column's count; slots at or
past it hold no record (the kernel leaves them unwritten, the plain
version zero).

The inputs are the paint kernel's seg rows (ops/paint.py::build_rows:
one row per camera and active seg, in traversal order).  Per camera and
screen column the scan walks them front to back with the occlusion
state (hor / fo / co) and appends each emitted record (the span word and
d1..d6, see ops/layout.py) at the column's cursor while cursor < K,
else counts it in the camera's overflow.  Per seg, in this order:
piece 0's solid wall, floor and ceiling spans and the two occluded-gap
fills, then the occlusion update; the mid piece; the lower piece (then
fo); the upper piece (then co).

The pool is slot-major: plane p of record slot k of (camera b, column x)
is pool[p, b, k, x], so neighbouring columns' records are neighbouring
words.
"""

from __future__ import annotations

import ctypes

import torch

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.ops.layout import (
    KIND_CEIL, KIND_FLOOR, KIND_MID, KIND_WALL, N_PLANES, NR, P_OFFY, P_TEX,
    P_TH, P_TW, P_UY1RAW, P_WORDS, P_YBD, P_YBS, P_YTD, P_YTS, R_FLAGS,
    R_FLAT, R_G, R_LENGTH, R_LEX, R_LIGHT, R_LSX, R_OFFX, R_PIECE0, R_PLANEH,
    R_SOFF, R_X0, R_X1, SPAN_DC, SPAN_E2B, SPAN_E2T, SPAN_NODRAW,
    pack16, pack_span,
)
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    F32, I32, as_i16, f32, fdiv, smul, wrap_tex,
)
from doomtpu_torch.trace import spanned

POOL_PLANES = 1 + N_PLANES     # span, d1..d6


def _check_inputs(level: DeviceLevel, cfg: RenderConfig, rows, scnt):
    B = rows.shape[0]
    for name, t, dt, shape in (
        ("rows", rows, I32, (B, level.num_segs, NR)),
        ("scnt", scnt, I32, (B,)),
    ):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"scan: {name} must be {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != rows.device:
            raise ValueError(f"scan: {name} is on {t.device}, rows on "
                             f"{rows.device}")
        if not t.is_contiguous():
            raise ValueError(f"scan: {name} must be contiguous")
    if cfg.width < 1 or cfg.height < 1 or cfg.span_capacity < 1:
        raise ValueError("scan: empty screen or span pool")


# columns a wall-scan block takes (csrc/scan.cu: one thread a column, a
# multiple of 32 up to 128); timed on the card (PERF.md)
SCAN_COLUMNS = 32


def scan_blocks_per_sm() -> int:
    """Wall-scan blocks of SCAN_COLUMNS columns one SM of this card holds
    (the CUDA occupancy calculator, from the built kernel's registers
    and shared memory)."""
    from doomtpu_torch.ops.build import load_library

    return load_library("scan").doom_scan_blocks_per_sm(SCAN_COLUMNS)


@spanned("doom.walls")
def scan(level: DeviceLevel, cfg: RenderConfig, rows, scnt) -> dict:
    """Scan B cameras.  Returns {"pool": [POOL_PLANES, B, K, W] i32,
    "cnt": [B, W] i32, "overflow": [B] i32}.  CUDA tensors launch the
    kernel (csrc/scan.cu); CPU tensors run `scan_reference`.  Anything
    else raises."""
    _check_inputs(level, cfg, rows, scnt)
    if rows.device.type == "cpu":
        return scan_reference(level, cfg, rows, scnt)
    if rows.device.type != "cuda":
        raise ValueError(f"scan: no kernel for device {rows.device}")
    from doomtpu_torch.ops.build import load_library

    lib = load_library("scan")
    B, G = rows.shape[:2]
    W, H, K = cfg.width, cfg.height, cfg.span_capacity
    dev = rows.device
    pool = torch.empty((POOL_PLANES, B, K, W), dtype=I32, device=dev)
    cnt = torch.empty((B, W), dtype=I32, device=dev)
    ovf = torch.zeros((B,), dtype=I32, device=dev)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.doom_scan(
        p(rows), p(scnt), B, G, W, H, K, level.tex_pixels.shape[2],
        int(level.tex_sizes_pow2), SCAN_COLUMNS, p(pool), p(cnt), p(ovf),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"scan kernel launch failed: CUDA error {err} "
                           f"({lib.doom_scan_error_string(err).decode()})")
    scan.launches += 1
    return {"pool": pool, "cnt": cnt, "overflow": ovf}


scan.launches = 0


def scan_reference(level: DeviceLevel, cfg: RenderConfig, rows, scnt) -> dict:
    """Plain PyTorch scan: a Python loop over the ordered seg slots with
    [B, W] state tensors; each emission scatters its record at the
    columns' cursors.  Same arguments and outputs as `scan`, and the
    same bits below each column's count (zeros past it)."""
    _check_inputs(level, cfg, rows, scnt)
    dev = rows.device
    B = rows.shape[0]
    W, H, K = cfg.width, cfg.height, cfg.span_capacity
    TW = level.tex_pixels.shape[2]
    pow2 = level.tex_sizes_pow2

    xx = torch.arange(W, dtype=I32, device=dev)[None]          # [1, W]
    hor = torch.zeros((B, W), dtype=torch.bool, device=dev)
    fo = torch.full((B, W), H, dtype=I32, device=dev)
    co = torch.full((B, W), -1, dtype=I32, device=dev)
    # slot K takes the writes of columns that do not emit
    pool = torch.zeros((POOL_PLANES, B, K + 1, W), dtype=I32, device=dev)
    cnt = torch.zeros((B, W), dtype=I32, device=dev)
    ovf = torch.zeros((B,), dtype=I32, device=dev)

    def emit(mask, record):
        fits = cnt < K
        do = mask & fits
        slot = torch.where(do, cnt, K).long()
        src = torch.stack([v.expand(B, W).to(I32) for v in record])
        pool.scatter_(2, slot[None, :, None, :].expand(POOL_PLANES, B, 1, W),
                      src[:, :, None, :])
        ovf.add_((mask & ~fits).sum(-1, dtype=I32))
        cnt.add_(do.to(I32))

    n_slots = int(scnt.max()) if B else 0
    for slot in range(n_slots):
        r = rows[:, slot]                                        # [B, NR]
        iv = lambda f: r[:, f:f + 1]
        fv = lambda f: r[:, f:f + 1].view(F32)
        flags = torch.where((slot < scnt)[:, None], iv(R_FLAGS), 0)
        x0, x1 = iv(R_X0), iv(R_X1)
        inrange = (xx >= as_i16(x0)) & (xx <= as_i16(x1))
        if not bool((inrange & ((flags & 15) != 0) & ~hor).any()):
            continue    # every piece is a no-op on every open column
        two_sided = (flags & 16) != 0
        draw_c = (flags & 32) != 0
        f_sky = (flags & 1024) != 0
        c_sky = (flags & 2048) != 0
        light = iv(R_LIGHT)
        g = iv(R_G)
        zero = torch.zeros_like(g)
        fl_d = [(light << 22) | (iv(R_FLAT) << 8) | (f_sky.to(I32) << 21),
                pack16(iv(R_PLANEH), 0), zero, zero, zero, g]
        ce_d = [(light << 22) | (iv(R_FLAT + 1) << 8) | (c_sky.to(I32) << 21),
                pack16(iv(R_PLANEH + 1), 0), zero, zero, zero, g]

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

        for p in range(4):
            act = (flags & (1 << p)) != 0
            covered = inrange & act
            open_ = covered & ~hor
            if p != 0 and not bool(open_.any()):
                continue    # pieces 1-3 change nothing on closed columns
            pb = R_PIECE0 + P_WORDS * p
            draws_p = (flags & (64 << p)) != 0
            by = as_i16(fv(pb + P_YBS) + smul(dx, fv(pb + P_YBD)))
            ty = as_i16(fv(pb + P_YTS) + smul(dx, fv(pb + P_YTD)))
            cb = torch.clamp(torch.minimum(fo, by), max=H - 1)
            ct = torch.clamp(torch.maximum(co, ty), min=0)
            in_ver = (cb >= ct) & open_
            tx = wrap_tex(tx_base, torch.clamp(iv(pb + P_TW), min=1), pow2)
            wall_d = [iv(pb + P_TEX) * TW + tx, pack16(by, ty),
                      pack16(iv(pb + P_OFFY), iv(pb + P_TH)),
                      pack16(light, zdist), iv(pb + P_UY1RAW), g]

            def wall_rec(flag_bits):
                rec = pack_span(KIND_WALL, ct, cb) | flag_bits
                return torch.where(draws_p, rec, rec | SPAN_NODRAW)

            if p == 0:
                solid = ~two_sided
                emit(in_ver & solid,
                     [wall_rec(SPAN_E2B | SPAN_E2T)] + wall_d)
                # visplanes (segs.rs:263-291), 1-pixel skip at emission
                fl_keep = f_sky | (torch.clamp(fo, max=H - 1) - cb > 1)
                emit(in_ver & (cb < fo) & (cb != H - 1) & fl_keep,
                     [pack_span(KIND_FLOOR, cb, fo)] + fl_d)
                ce_keep = c_sky | (
                    torch.clamp(ct, max=H - 1) - torch.clamp(co, min=0) > 1)
                emit(in_ver & draw_c & (ct > co) & ce_keep,
                     [pack_span(KIND_CEIL, co, ct)] + ce_d)
                # occluded-gap fill (segs.rs:293-318)
                gap = open_ & ~in_ver & (fo > co)
                keep_g = (torch.clamp(fo, max=H - 1)
                          - torch.clamp(co, min=0)) > 1
                gap_b = gap & (by <= co)
                emit(gap_b & (f_sky | keep_g),
                     [pack_span(KIND_FLOOR, co, fo)] + fl_d)
                gap_t = gap & draw_c & (ty >= fo)
                emit(gap_t & (c_sky | keep_g),
                     [pack_span(KIND_CEIL, co, fo)] + ce_d)
                occl_m = in_ver & two_sided
                fo = torch.where(occl_m, cb, fo)
                co = torch.where(occl_m & draw_c, ct, co)
                solid_occl = (covered & solid) | gap_b | gap_t
                hor = hor | solid_occl
                fo = torch.where(solid_occl, H // 2, fo)
                co = torch.where(solid_occl, H // 2, co)
            elif p == 1:
                rec = pack_span(KIND_MID, ct, cb) | (draw_c.to(I32) * SPAN_DC)
                emit(in_ver, [rec] + wall_d)
            elif p == 2:
                emit(in_ver, [wall_rec(SPAN_E2B)] + wall_d)
                fo = torch.where(in_ver, ct, fo)         # segs.rs:329-331
            else:
                emit(in_ver, [wall_rec(SPAN_E2T)] + wall_d)
                co = torch.where(in_ver, cb, co)         # segs.rs:333-335

    # slot-major and contiguous, as the kernel's pool (the resolve kernel
    # reads each plane in place)
    return {"pool": pool[:, :, :K].contiguous(), "cnt": cnt, "overflow": ovf}
