"""Word layouts shared by the kernels and the modules around them.

A leaf module: it imports nothing of the port (torch only), so the
kernel wrappers (ops/) and the render stages (render/) both import it at
the top.
csrc/layout.cuh mirrors it for the CUDA kernels; each kernel library
reports its row width (`doom_row_words`) and ops/build.py checks it
against `NR` when it loads the library.

The span record of the unified pool (render/walls.py re-exports it under
the JAX package's names), one slot = the span word and six data planes:

    span  nodraw(1, sign bit) | kind(2) | dc(1) | e2b(1) | e2t(1)
          | y0+1 (8) | y1+1 (8)
    d1    walls/mids: atlas column (tex * TW + tx, TW the atlas stride)
          planes:     light(8) << 22 | is_sky << 21 | flat(13) << 8
    d2    walls/mids: bottom_y(16) | top_y(16)   (full, for v interp)
          planes:     plane height (16) << 16
    d3    walls/mids: off_y(16) | tex_h(16)
    d4    walls/mids: light(16) | z-dist(16)
    d5    walls/mids: uy1 (f32 bits)
    d6    seg index g (full i32)

The 8-bit y fields clip rows to [-1, 254], as the JAX package packs
them.  The paint kernel's clip and mid pools use the same span word.

The seg row (ops/paint.py::build_rows; i32 words, "f" = f32 bits): one
row per (camera, active seg), read by the paint and wall-scan kernels.
"""

from __future__ import annotations

import torch

# ---- the span record -------------------------------------------------------
KIND_WALL = 0
KIND_FLOOR = 1
KIND_CEIL = 2
KIND_MID = 3

N_PLANES = 6  # d1..d6

SPAN_E2T = 1 << 26     # wall span extends-to-top (sprite clip)
SPAN_E2B = 1 << 27     # wall span extends-to-bottom
SPAN_DC = 1 << 28      # mid span's seg draws its ceiling (sky hack)
SPAN_NODRAW = -(2 ** 31)  # clip-only (texture-less) wall span


# the ld word of a frame (the paint and resolve kernels write it, the
# item kernels read it): light(8) << 16 | z-dist(u16) | written | sky
LD_WRITTEN = 1 << 24
LD_SKY = 1 << 25


def pack_span(kind, y0, y1):
    y0c = torch.clamp(y0, -1, 254) + 1
    y1c = torch.clamp(y1, -1, 254) + 1
    return (kind << 29) | (y0c << 8) | y1c


def unpack_span(slot):
    kind = (slot >> 29) & 3
    y0 = ((slot >> 8) & 255) - 1
    y1 = (slot & 255) - 1
    return kind, y0, y1


def pack16(hi, lo):
    return ((hi & 0xFFFF) << 16) | (lo & 0xFFFF)


# ---- the seg row -------------------------------------------------------------
R_G = 0          # seg id
R_X0 = 1         # screen x range (i32; see build_rows: exact in f32)
R_X1 = 2
R_FLAGS = 3      # see ops/paint.py
R_LSX = 4        # f: FOV-clipped view-space endpoints (non-finite -> 0)
R_LSY = 5
R_LEX = 6
R_LEY = 7
R_LENGTH = 8     # f
R_SOFF = 9       # f: start offset
R_OFFX = 10      # texture x offset total
R_LIGHT = 11
R_FLAT = 12      # floor, ceiling flat ids (12, 13)
R_PLANEH = 14    # floor, ceiling heights (14, 15)
R_PIECE0 = 16    # 10 words per piece:
P_YBS = 0        # f: bottom edge y at x0
P_YBD = 1        # f: bottom edge slope
P_YTS = 2        # f: top edge y at x0
P_YTD = 3        # f: top edge slope
P_TH = 4         # texture height
P_TW = 5         # texture width
P_OFFY = 6       # texture y offset total
P_TEX = 7        # texture id (>= 0)
P_UY1 = 8        # f: top - bottom height (non-finite -> 0), mid records
P_UY1RAW = 9     # f: the same, as computed (wall texel v)
P_WORDS = 10
NR = R_PIECE0 + 4 * P_WORDS      # 56

# the camera-stage fields a row is built from, with their dtypes, in the
# order the rows kernel takes them (csrc/rows.cu FIELDS): [B, G] fields,
# then [B, G, 4] ones (one a piece)
ROW_FIELDS = (
    ("x0", torch.int32), ("x1", torch.int32), ("lsx", torch.float32),
    ("lsy", torch.float32), ("lex", torch.float32), ("ley", torch.float32),
    ("length", torch.float32), ("start_offset", torch.float32),
    ("offset_x_total", torch.int32), ("light", torch.int32),
    ("floor_flat", torch.int32), ("ceil_flat", torch.int32),
    ("floor_h_i", torch.int32), ("ceil_h_i", torch.int32),
    ("two_sided", torch.bool), ("draw_ceiling", torch.bool),
)
PIECE_FIELDS = (
    ("active", torch.bool), ("draws", torch.bool), ("yb_s", torch.int32),
    ("yb_d", torch.float32), ("yt_s", torch.int32), ("yt_d", torch.float32),
    ("uy1", torch.float32), ("off_y", torch.int32), ("tex", torch.int32),
)


def row_fields_spec() -> str:
    """ROW_FIELDS + PIECE_FIELDS as csrc/rows.cu's doom_rows_fields()
    spells them: name:dtype (b bool, i int32, f float32), spaced."""
    code = {torch.bool: "b", torch.int32: "i", torch.float32: "f"}
    return " ".join(f"{n}:{code[d]}" for n, d in ROW_FIELDS + PIECE_FIELDS)
