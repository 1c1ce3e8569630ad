"""Torch math helpers with Rust-exact cast/wrap semantics (vectorized).

Counterpart of doomtpu/render/jmath.py.  `as iN` casts truncate toward
zero and saturate (NaN -> 0); integer div/rem truncate toward zero; the
texture wrap idiom follows bitmap_render.rs:244-248.

Every function here gives the bits of the JAX package's strict-FP mode
(f64 products rounded to f32, host-libm trig), on the CPU and on the
card alike:

- eager torch runs each elementwise op as its own kernel, so no f32
  multiply is ever contracted into an FMA with a neighbouring add;
- a true division by a Python number on a CUDA tensor becomes a
  multiply by its reciprocal inside PyTorch (one bit off), so every
  division goes through `fdiv`, which divides by a tensor;
- cos and sin come from host numpy f32, as the strict mode's do: a
  call reads its cameras' angles once, at its start, and hands the
  values to every stage as one device tensor (`camera_trig`, the rows
  COS .. SSIN);
- a division by a constant goes through `div_const`: under jit, XLA
  rewrites x / c as x * f32(1 / c), and the JAX package divides by
  constants only inside jitted code;
- square roots go through `sqrt`: torch's f32 sqrt on the CPU is not
  correctly rounded (65.01091 for sqrt(4226.419f), where IEEE gives
  65.01092).
"""

from __future__ import annotations

import numpy as np
import torch

from doomtpu_torch.trace import span

F32 = torch.float32
I32 = torch.int32


def f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(F32)
    return torch.as_tensor(x, dtype=F32, device=device)


def fdiv(a, b) -> torch.Tensor:
    """IEEE f32 a / b.  A Python-number operand becomes a 0-dim tensor
    filled on the other operand's device, so no host copy waits for the
    device: PyTorch's CUDA division by a CPU scalar computes a * (1 / b),
    which is not correctly rounded."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=F32, device=a.device)
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=F32, device=b.device)
    return a.to(F32) / b.to(F32)


def div_const(x, c) -> torch.Tensor:
    """x / c for a constant c as the JAX package computes it: XLA's
    algebraic simplifier turns a division by a compile-time constant into
    a multiply by the constant's f32 reciprocal (not correctly rounded:
    (160 - 286) / f32(200 / 240) gives -151.20001, not -151.2)."""
    return f32(x) * reciprocal(c)


def reciprocal(c) -> float:
    """f32(1) / f32(c), the constant XLA multiplies by in place of / c."""
    return float(np.float32(1.0) / np.float32(c))


def smul(a, b) -> torch.Tensor:
    """f32 product, rounded once, as the JAX strict mode computes it.

    Strict JAX multiplies in f64 and rounds to f32.  For two f32
    operands the f64 product is exact, so that is one IEEE-rounded f32
    multiply, which is what eager torch does: an eager multiply is its
    own kernel and can never be contracted into an FMA.  A Python-number
    operand is not an f32 value (JAX widens it to f64 unrounded), so that
    product is taken in f64 and rounded, exactly as strict JAX does."""
    if isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
        return a.to(F32) * b.to(F32)
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if float(np.float32(b)) == float(b):
        return a.to(F32) * float(b)
    return (a.to(torch.float64) * float(b)).to(F32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root: taken in f64 and rounded once
    more, which is exact for sqrt (f64 carries more than 2 * 24 + 2
    bits)."""
    return torch.sqrt(x.to(torch.float64)).to(F32)


def as_i16(x: torch.Tensor) -> torch.Tensor:
    """Rust `as i16` on f32: trunc toward zero, saturate, NaN->0 (as i32).
    NaN is zeroed before the cast: torch's float->int cast of NaN is
    undefined."""
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
        x = torch.clamp(torch.trunc(x), -32768.0, 32767.0)
    else:
        x = torch.clamp(x, -32768, 32767)
    return x.to(I32)


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """Rust `as i32`: trunc toward zero, saturate, NaN->0.  The clamp runs
    in f64, where both i32 bounds are exact (in f32, 2^31-1 rounds up to
    2^31, whose cast to i32 differs between the CPU and the card)."""
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
        x = torch.clamp(torch.trunc(x.to(torch.float64)),
                        -(2.0 ** 31), 2.0 ** 31 - 1)
    return x.to(I32)


def div_trunc(a, b):
    return torch.div(a, b, rounding_mode="trunc")


def rem_trunc(a, b):
    return torch.fmod(a, b)


def wrap_tex(t, size, pow2: bool = False):
    """if t < 0 { t += size * (1 - t / size) }; t %= size  (trunc div).

    With pow2=True (every possible `size` a power of two) the idiom is
    exactly t & (size - 1)."""
    if pow2:
        return t & (size - 1)
    t = torch.where(t < 0, t + size * (1 - div_trunc(t, size)), t)
    return rem_trunc(t, size)


def cos_sin(angle: torch.Tensor):
    """f32 cos/sin from host numpy (the JAX strict mode's source), never
    the device's own trig: a host round trip of its own, for the plain
    versions; the engine's stages read `camera_trig`'s rows."""
    with span("doom.sync"):
        a = angle.detach().to("cpu", F32).numpy()
        c = torch.from_numpy(np.cos(a, dtype=np.float32))
        s = torch.from_numpy(np.sin(a, dtype=np.float32))
        return c.to(angle.device), s.to(angle.device)


# rows of a trig bundle, each [B] f32: cos and sin of the view angle,
# of its negation (the view transform's), and of the strafe direction,
# angle + pi/2 (game.rs:349-359; a tick's bundle only)
COS, SIN, NCOS, NSIN, SCOS, SSIN = range(6)
HALF_PI = np.float32(np.pi) / np.float32(2.0)


def host_trig(a: np.ndarray, rows: int, device) -> torch.Tensor:
    """[..., rows, B] f32 trig bundle of the f32 angles a [..., B] on
    `device`: numpy's f32 cos and sin of a, of -a and (rows 6) of
    a + HALF_PI, each taken as `cos_sin` takes it, written into a host
    tensor (pinned, for a card) and copied without waiting for the
    device."""
    a = np.asarray(a, np.float32)
    cuda = torch.device(device).type == "cuda"
    buf = torch.empty(a.shape[:-1] + (rows, a.shape[-1]), dtype=F32,
                      pin_memory=cuda)
    out = buf.numpy()
    for k, x in enumerate((a, -a, a + HALF_PI)[:rows // 2]):
        np.cos(x, out=out[..., 2 * k, :], dtype=np.float32)
        np.sin(x, out=out[..., 2 * k + 1, :], dtype=np.float32)
    return buf.to(device, non_blocking=True)


def camera_trig(angle: torch.Tensor) -> torch.Tensor:
    """The [4, B] trig bundle (rows COS, SIN, NCOS, NSIN) of the angles
    [B]: one host round trip, which a render makes once, at its start."""
    with span("doom.sync"):
        return host_trig(angle.detach().to("cpu", F32).numpy(), 4,
                         angle.device)


def rotate_cs(x, y, c, s):
    """map/vertexes.rs:20-25 by the angle whose f32 cos and sin are c, s."""
    return smul(x, c) - smul(y, s), smul(y, c) + smul(x, s)


def rotate(x, y, angle):
    """map/vertexes.rs:20-25 (f32 trig, `cos_sin`'s round trip)."""
    return rotate_cs(x, y, *cos_sin(angle))


def cross(ax, ay, bx, by):
    return smul(ax, by) - smul(ay, bx)


def is_left_of(px, py, sx, sy, ex, ey):
    """vertexes.rs:32-34: cross(p - s, e - s) <= 0."""
    return cross(px - sx, py - sy, ex - sx, ey - sy) <= 0.0


def stable_positions(key: torch.Tensor) -> torch.Tensor:
    """Ascending stable-sort position of each element along axis 1: the
    position a stable argsort on (key, index) assigns."""
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.sort(order, dim=1, stable=True).indices.to(I32)
