"""Camera sort: Morton-sort cameras before rendering, unsort after.

Counterpart of doomtpu/render/camsort.py.  The permutation only
changes which cameras sit next to each other, never a pixel value.  A
batch split over devices (parallel/mesh.py) sorts each shard's cameras
on their own, which is the JAX package's shard-local sort.  Key
layout: coarse region, angle bucket, fine position (angle above fine
position, the JAX package's measured default).
"""

from __future__ import annotations

import numpy as np
import torch

from doomtpu_torch.render.jmath import F32, I32
from doomtpu_torch.trace import spanned


def camera_sort_key(pos: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Morton key [B] (i32) from pos [B, 2] / angle [B]."""
    x = pos[:, 0].to(F32)
    y = pos[:, 1].to(F32)

    def spread(v):  # interleave 8 bits with zeros
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    def morton(xq, yq):
        return spread(xq) | (spread(yq) << 1)

    # float -> int casts truncate toward zero, as XLA's convert does
    xr = (x * (1.0 / 1024.0)).to(I32) & 0x3F
    yr = (y * (1.0 / 1024.0)).to(I32) & 0x3F
    aq = (angle.to(F32) * float(np.float32(4.0 / np.pi))).to(I32) & 7
    xf = (x * 0.015625).to(I32) & 0xF
    yf = (y * 0.015625).to(I32) & 0xF
    return (morton(xr, yr) << 16) | (aq << 13) | morton(xf, yf)


@spanned("doom.camera")
def sort_perm(pos: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """[B] i32 camera permutation: sorted position -> original camera."""
    return torch.argsort(camera_sort_key(pos, angle), stable=True).to(I32)


@spanned("doom.camera")
def sort_state(state, perm: torch.Tensor | None = None):
    """(state with cameras in Morton order, perm)."""
    if perm is None:
        perm = sort_perm(state.pos, state.angle)
    ix = perm.long()
    return state.map(lambda x: x[ix]), perm


@spanned("doom.camera")
def unsort_out(out, perm: torch.Tensor):
    """Undo sort_state on a tuple of [B, ...] outputs."""
    inv = torch.argsort(perm, stable=True)
    return tuple(x[inv] for x in out)
