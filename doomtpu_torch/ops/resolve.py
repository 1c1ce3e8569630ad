"""The resolve kernel: the scan pipeline's span pool -> idx, ld and rgb.

`resolve` launches the hand-written CUDA kernel (csrc/resolve.cu) on
CUDA tensors; `render/resolve.py::resolve_frame` calls it there and runs
`resolve_reference`, the plain PyTorch version of the same function (the
winner fold, the texel fetch, the shade and the ld packing), on CPU
tensors.  Both give the same bits in every pixel.

The kernel reads the wall scan's pool in place: each plane a [B, W, K]
view of a slot-major [B, K, W] store (ops/scan.py), slots at or past a
column's count never read.  Per camera it takes the sky column offset,
the player's integer position, the floor height and the cos and sin of
the view angle (`camera_scalars`, the paint kernel's per-camera words:
the trig comes from the host, as the strict-FP rule wants, in the call's
trig bundle).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from doomtpu_torch.config import (
    ASPECT_RATIO_CORRECTION, PLAYER_EYE_HEIGHT, SKY_TEXTURE_WIDTH,
    RenderConfig,
)
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    COS, SIN, I32, as_i16, camera_trig, div_const, div_trunc, f32,
    reciprocal,
)

# slot ids the kernel's winner arrays hold (u16, 0xFFFF: no slot)
MAX_SLOTS = 0xFFFF - 1
# csrc/resolve.cu: columns a block, and the rows a span word can cover
# (its 8-bit y fields: rows 0 .. 254)
COLUMNS, COVER_ROWS = 32, 255


def camera_scalars(angle, px, py, floor_height, trig=None):
    """(camf [B, 3] f32: cos and sin of the angle, the floor height;
    cami [B, 3] i32: px and py as i16, the sky's texture column offset
    (visplanes.rs:42-80)), the per-camera words of the paint and resolve
    kernels.  The trig is the rows COS and SIN of `trig`, the call's
    bundle (jmath.camera_trig), else of a round trip here."""
    stw = SKY_TEXTURE_WIDTH
    ang = f32(angle)
    if trig is None:
        trig = camera_trig(ang)
    camf = torch.stack([trig[COS], trig[SIN], f32(floor_height)],
                       -1).contiguous()
    tx_off = as_i16(div_const(ang * -float(stw), math.pi / 2.0))
    tx_off = tx_off + stw
    tx_off = torch.where(
        tx_off < 0, tx_off + stw * (1 - div_trunc(tx_off, stw)), tx_off
    )
    cami = torch.stack(
        [as_i16(f32(px)), as_i16(f32(py)), tx_off], -1
    ).to(I32).contiguous()
    return camf, cami


def check_inputs(level: DeviceLevel, cfg: RenderConfig, pool, cnt, px, py,
                 angle, floor_height):
    """Raise ValueError unless the pool (spans, [d1..d6]) holds i32 [B, W,
    K] views of slot-major stores (each plane's transpose contiguous),
    cnt is a contiguous i32 [B, W], the poses are [B] and everything,
    the level's tables too, lies on one device."""
    spans, planes = pool
    if cnt.dtype != I32 or cnt.dim() != 2 or not cnt.is_contiguous():
        raise ValueError(f"resolve: cnt must be contiguous int32 [B, W], "
                         f"got {cnt.dtype} {tuple(cnt.shape)}")
    B, W = cnt.shape
    K = spans.shape[-1]
    if W != cfg.width or cfg.height < 1:
        raise ValueError(f"resolve: {W} columns, the screen {cfg.width} x "
                         f"{cfg.height}")
    if not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"resolve: {K} slots a column, at most {MAX_SLOTS}")
    if len(planes) < 5:
        raise ValueError("resolve: the pool needs the planes d1..d5")
    for i, p in enumerate([spans, *planes[:5]]):
        if p.dtype != I32 or tuple(p.shape) != (B, W, K):
            raise ValueError(f"resolve: pool plane {i} must be int32 "
                             f"{(B, W, K)}, got {p.dtype} {tuple(p.shape)}")
        if not p.transpose(1, 2).is_contiguous():
            raise ValueError(f"resolve: pool plane {i} is not a view of a "
                             f"slot-major [B, K, W] store")
    for name, t in (("px", px), ("py", py), ("angle", angle),
                    ("floor_height", floor_height)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"resolve: {name} must be [{B}], got "
                             f"{tuple(t.shape)}")
    tables = (level.atlas_cm, level.palette_packed)
    for t in [spans, *planes[:5], px, py, angle, floor_height, *tables]:
        if t.device != cnt.device:
            raise ValueError(f"resolve: a tensor on {t.device}, cnt on "
                             f"{cnt.device}")
    for name, t in (("atlas_cm", level.atlas_cm),
                    ("palette_packed", level.palette_packed)):
        if t.dtype != I32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"resolve: level.{name} must be contiguous "
                             f"1-d int32")
    if level.palette_packed.numel() != 256 or level.atlas_cm.numel() < 1:
        raise ValueError("resolve: a palette of 256 colours and an atlas")


def resolve(level: DeviceLevel, cfg: RenderConfig, pool, cnt, camf,
            cami) -> tuple:
    """(idx, ld, rgb), each [B, H, W] i32, from the kernel (csrc/
    resolve.cu) on checked CUDA inputs (`check_inputs`; camf, cami from
    `camera_scalars`).  Counted in `resolve.launches`."""
    from doomtpu_torch.ops.build import load_library

    if cnt.device.type != "cuda":
        raise ValueError(f"resolve: no kernel for device {cnt.device}")
    lib = load_library("resolve")
    spans, planes = pool
    B, W, K = spans.shape
    H = cfg.height
    e = lambda: torch.empty((B, H, W), dtype=I32, device=cnt.device)
    idx, ld, rgb = e(), e(), e()
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    c32 = lambda v: float(np.float32(v))
    stream = torch.cuda.current_stream(cnt.device).cuda_stream
    err = lib.doom_resolve(
        *(p(t) for t in (spans, *planes[:5], cnt, camf, cami)),
        p(level.atlas_cm), level.atlas_cm.numel(), level.atlas_rows,
        level.tex_pixels.shape[2], level.sky_tex, level.col_flat_off,
        p(level.palette_packed), B, W, H, K, int(level.tex_sizes_pow2),
        int(level.sky_is_opaque), c32(cfg.camera_focus_x),
        c32(cfg.camera_focus_y), reciprocal(ASPECT_RATIO_CORRECTION),
        c32(cfg.game_camera_focus_x), c32(PLAYER_EYE_HEIGHT), reciprocal(W),
        reciprocal(H), reciprocal(255.0), p(idx), p(ld), p(rgb),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"resolve kernel launch failed: CUDA error {err} "
                           f"({lib.doom_resolve_error_string(err).decode()})")
    resolve.launches += 1
    return idx, ld, rgb


resolve.launches = 0


def resolve_smem_bytes(H: int) -> int:
    """Shared memory of a resolve block at height H (csrc/resolve.cu):
    the palette and, for each coverable row and column, a u16 wall and
    plane winner."""
    return 4 * 256 + min(H, COVER_ROWS) * 2 * COLUMNS * 2


def resolve_blocks_per_sm(H: int) -> int:
    """Resolve blocks one SM of this card holds at height H (the CUDA
    occupancy calculator)."""
    from doomtpu_torch.ops.build import load_library

    return load_library("resolve").doom_resolve_blocks_per_sm(H)
