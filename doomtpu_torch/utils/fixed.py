"""Rust-exact integer cast / wrap semantics, for NumPy and PyTorch alike.

The reference renderer leans on Rust numeric conversions everywhere
(`x as i16`, `%`, `/` on integers).  Bit-exact parity requires reproducing:

- float -> int casts truncate toward zero and SATURATE at the type bounds
  (Rust semantics; e.g. renderer/segs.rs:205-209, bitmap_render.rs:242-263).
- integer `/` truncates toward zero, `%` takes the dividend's sign
  (used by the texture wrap idiom `t += size * (1 - t / size); t %= size`,
  bitmap_render.rs:244-248, 253-263).

NumPy's `astype` wraps instead of saturating and `//`/`%` floor (so do
torch's `.to` and `//`), so these helpers exist.  They take NumPy arrays
(or scalars) or torch tensors and return the same kind; the NumPy branch
is the JAX package's (doomtpu/utils/fixed.py) unchanged.
"""

import numpy as np


def _is_torch(x) -> bool:
    return type(x).__module__.startswith("torch")


def as_int_sat(x, dtype, out_dtype=None):
    """`x as iN` for a float/int input: trunc toward zero, saturating.

    Returns `out_dtype` (a NumPy dtype, defaults to int32) holding values
    limited to the range of `dtype`, so follow-on arithmetic can't
    overflow.
    """
    info = np.iinfo(dtype)
    out_dtype = out_dtype or np.int32
    if _is_torch(x):
        import torch

        x = torch.trunc(x) if x.is_floating_point() else x
        tdtype = torch.from_numpy(np.zeros(0, out_dtype)).dtype
        return x.clamp(info.min, info.max).to(tdtype)
    x = np.trunc(x) if np.issubdtype(np.asarray(x).dtype, np.floating) else x
    x = np.clip(x, info.min, info.max)
    return np.asarray(x).astype(out_dtype)


def as_i16(x):
    """Rust `x as i16` (saturating trunc), carried as int32."""
    return as_int_sat(x, np.int16)


def as_i32(x):
    return as_int_sat(x, np.int32)


def div_trunc(a, b):
    """Integer division truncating toward zero (Rust/C `/`)."""
    if _is_torch(a):
        import torch

        q = torch.floor_divide(abs(a), abs(b))
        return torch.where((a < 0) ^ (b < 0), -q, q)
    q = np.floor_divide(np.abs(a), np.abs(b))
    return np.where((a < 0) ^ (b < 0), -q, q)


def rem_trunc(a, b):
    """Integer remainder with the dividend's sign (Rust/C `%`)."""
    return a - div_trunc(a, b) * b


def wrap_texcoord(t, size):
    """The reference's texture wrap idiom for possibly-negative coords.

    Mirrors bitmap_render.rs:244-248 (and :259-263):
        if t < 0 { t += size * (1 - t / size) }
        t %= size
    with Rust trunc-division semantics.  `t` and `size` are integers.
    """
    t_neg = t + size * (1 - div_trunc(t, size))
    if _is_torch(t):
        import torch

        t = torch.where(t < 0, t_neg, t)
    else:
        t = np.where(t < 0, t_neg, t)
    return rem_trunc(t, size)
