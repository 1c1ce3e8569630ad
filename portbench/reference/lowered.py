"""The reference computed a precision lower: the correctness control.

The configurations state f32 arithmetic (the upstream renderer's Rust
f32).  `bfloat16()` rounds the result of every f32 product, division,
square root and trig value of the reference to bfloat16, the step below
f32 that would tempt a faster program, inside the `with` block.  Every
module of the reference that bound one of these names is patched, and
restored on exit.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from portbench.reference.render import jmath

_NAMES = ("smul", "fdiv", "sqrt", "div_const", "cos_sin")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _lowered(fn):
    if fn is jmath.cos_sin:
        return lambda angle: tuple(_bf16(v) for v in fn(angle))
    return lambda *a, **kw: _bf16(fn(*a, **kw))


@contextlib.contextmanager
def bfloat16():
    originals = {n: getattr(jmath, n) for n in _NAMES}
    lowered = {n: _lowered(fn) for n, fn in originals.items()}
    undo = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("portbench.reference") or mod is None:
            continue
        for n, fn in originals.items():
            if getattr(mod, n, None) is fn:
                undo.append((mod, n, fn))
                setattr(mod, n, lowered[n])
    try:
        yield
    finally:
        for mod, n, fn in undo:
            setattr(mod, n, fn)
