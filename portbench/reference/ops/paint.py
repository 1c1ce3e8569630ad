"""Seg rows and the shade constants of the wall pipelines (frozen copy).

A copy of the port's ops/paint.py as of its first benchmark, cut to what
the plain scan + resolve pipeline reads: `build_rows` (one row per
(camera, active seg) in traversal order) and the f32 constants of the
plane projection and shade.  Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.config import (
    ASPECT_RATIO_CORRECTION, PLAYER_EYE_HEIGHT, RenderConfig,
)
from portbench.reference.ops.layout import NR, P_WORDS
from portbench.reference.render.device import DeviceLevel
from portbench.reference.render.jmath import F32, I32, f32, reciprocal

LD_WRITTEN = 1 << 24
LD_SKY = 1 << 25
FLAG_HAS_MID = 1 << 12

MID_PLANES = 7    # span, d1 (texel column), d2 (by|ty), d3 (offy|th),
#                   d4 (light|zdist), d5 (uy1 bits), d6 (seg id)
CLIP_PLANES = 7   # span, d2 (by|ty), d6 (seg id), lsx, lsy, lex, ley


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(F32).contiguous().view(I32)


def _consts(cfg: RenderConfig) -> dict:
    """f32 constants of the plane projection, sky lookup and shade,
    rounded exactly where the JAX kernel rounds them.  Its divisions by
    constants are multiplies by f32 reciprocals (see jmath.div_const)."""
    W, H = cfg.width, cfg.height
    return {
        "half_w": float(np.float32(W / 2.0)),
        "half_h": float(np.float32(H / 2.0)),
        "inv_aspect": reciprocal(ASPECT_RATIO_CORRECTION),
        "wx_c": float(np.float32(W / 2.0 / ASPECT_RATIO_CORRECTION)),
        "eye": float(np.float32(PLAYER_EYE_HEIGHT)),
        "inv_w": reciprocal(W),
        "inv_h": reciprocal(H),
        "inv_255": reciprocal(255.0),
    }


# ---------------------------------------------------------------------------
# input build (the host side of the JAX render_paint)
# ---------------------------------------------------------------------------

def build_rows(level: DeviceLevel, frame: dict, order):
    """(rows [B, G, NR] i32, scnt [B] i32): one row per (camera, seg),
    the camera's active segs first in traversal order, from a
    camera-stage frame and the traversal order.  The paint and the wall
    scan kernels both read them."""
    B, G = order.shape
    active, draws, tex = frame["active"], frame["draws"], frame["tex"]
    ffl, cfl = frame["floor_flat"], frame["ceil_flat"]
    bit = lambda x, s: x.to(I32) << s
    flags = (
        bit(active[..., 0], 0) | bit(active[..., 1], 1)
        | bit(active[..., 2], 2) | bit(active[..., 3], 3)
        | bit(frame["two_sided"], 4) | bit(frame["draw_ceiling"], 5)
        | bit(draws[..., 0], 6) | bit(draws[..., 1], 7)
        | bit(draws[..., 2], 8) | bit(draws[..., 3], 9)
        | bit(level.flat_is_sky[ffl.long()], 10)
        | bit(level.flat_is_sky[cfl.long()], 11)
        | bit(tex[..., 1] >= 0, 12)
    )
    tex_safe = torch.clamp(tex, min=0)
    ts = tex_safe.long()

    def fin(x):
        return torch.where(torch.isfinite(x), x, torch.zeros_like(x))

    # ints the JAX field matrix carries as f32 go through f32 here too.
    # For x0 / x1 that is the identity, so the wall scan, which reads
    # them as i32 (JAX walls.py), reads the same words: camera.project_x
    # makes them Rust `as i32` of an f32 (an integer f32 holds exactly,
    # or +-2^31 saturated) clamped to W - 1.  fin() changes nothing on an
    # active seg: its endpoints passed the FOV clip and its x range is
    # not empty, so every such f32 is finite
    via_f32 = lambda x: x.to(F32).to(I32)
    seg_ids = torch.arange(G, dtype=I32, device=order.device)
    base = [
        seg_ids[None].expand(B, G),
        via_f32(frame["x0"]), via_f32(frame["x1"]), flags,
        _bits(fin(frame["lsx"])), _bits(fin(frame["lsy"])),
        _bits(fin(frame["lex"])), _bits(fin(frame["ley"])),
        _bits(fin(frame["length"])), _bits(fin(frame["start_offset"])),
        via_f32(frame["offset_x_total"]), frame["light"].to(I32),
        ffl, cfl, frame["floor_h_i"], frame["ceil_h_i"],
    ]
    uy1 = frame["uy1"]
    piece = torch.stack(
        [
            _bits(f32(frame["yb_s"])), _bits(fin(frame["yb_d"])),
            _bits(f32(frame["yt_s"])), _bits(fin(frame["yt_d"])),
            level.tex_h[ts], level.tex_w[ts], frame["off_y"], tex_safe,
            _bits(fin(uy1)), _bits(uy1),
        ],
        dim=-1,
    ).reshape(B, G, 4 * P_WORDS)
    rows_seg = torch.cat(
        [torch.stack([x.to(I32) for x in base], -1), piece.to(I32)], -1
    )                                                      # [B, G, NR]

    # per-camera active segs first, each group in traversal order: an
    # inactive seg changes nothing, so the kernels stop at scnt
    act_o = torch.gather((flags & 15) != 0, 1, order.long())
    first = torch.argsort((~act_o).to(torch.int8), dim=1, stable=True)
    comb = torch.gather(order.long(), 1, first)
    scnt = act_o.sum(1, dtype=I32)
    rows = torch.gather(
        rows_seg, 1, comb[..., None].expand(B, G, NR)
    ).contiguous()
    return rows, scnt
