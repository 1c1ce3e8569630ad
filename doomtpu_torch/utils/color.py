"""Packed-RGB helpers, copied from doomtpu/utils/color.py.

Frames keep one int32 0xRRGGBB per pixel, as the JAX package's do.
Unpack on the host for viewing (a CUDA tensor goes through `.cpu()`
first).
"""

from __future__ import annotations

import numpy as np


def unpack_rgb(packed) -> np.ndarray:
    """[...] i32 0xRRGGBB -> [..., 3] u8 (host)."""
    p = np.asarray(packed)
    return np.stack(
        [(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF], axis=-1
    ).astype(np.uint8)


def pack_rgb(rgb) -> np.ndarray:
    """[..., 3] u8 -> [...] i32 0xRRGGBB (host)."""
    r = np.asarray(rgb).astype(np.int32)
    return (r[..., 0] << 16) | (r[..., 1] << 8) | r[..., 2]
