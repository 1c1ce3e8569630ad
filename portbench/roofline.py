"""The yardstick of a kernel's roofline share: the card's peaks and the
bytes and operations each kernel's layer must move.

A share is least time / kernel time, the least time being the larger of
bytes / peak bandwidth and operations / peak f32 rate.  The counts are
what the kernel's layer must read and write whatever implements it, each
byte once: the frame planes the user receives where the layer writes
them, the level's decoded pictures and tables that the layer reads,
once, the per-camera records.  The port's own intermediate formats (seg
rows, span and item pools, the ld plane) are not counted, so a change of
a row layout does not move the yardstick.  Where the work depends on the
data, the traced run counts it on the same calls it profiles (`PROBES`
of a metric file, installed by tracing.Probes), and the counts take the
least: a texel a byte, no opacity bits, a pixel written once.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, 3.35 TB/s
of HBM3 and 67 TFLOP/s of f32 outside the tensor cores.  A card set
below 700 W (nvidia-smi's power.limit, printed beside every share) runs
slower than these.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.assets.bundle import LevelAssets
from portbench.reference.info.tables import load_default_tables
from portbench.reference.level.tables import MapTables
from portbench.reference.wad.reader import MapLump, WadFile

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# the idx plane (palette index) and the rgb plane (packed 0xRRGGBB), i32
FRAME_PLANE_BYTES = 4
# a span of the occlusion walk: which wall or plane (4 bytes) over which
# rows of its column (two 2-byte rows)
SPAN_BYTES = 8
# linedef flag: two-sided (the only lines with masked mids)
TWOSIDED = 4
# the map's geometry lumps, read once
_GEOMETRY = (MapLump.THINGS, MapLump.LINEDEFS, MapLump.SIDEDEFS,
             MapLump.VERTEXES, MapLump.SEGS, MapLump.SSECTORS,
             MapLump.NODES, MapLump.SECTORS)


@dataclass(frozen=True)
class LevelBytes:
    walls: int       # wall, mid and sky texture texels
    mids: int        # texels of the textures on two-sided lines' mids
    flats: int       # flat texels
    sprites: int     # sprite picture texels
    palette: int
    geometry: int    # the map's lumps
    sectors: int
    mobjs: int


def level_bytes(wad_bytes: bytes, map_name: str) -> LevelBytes:
    """The decoded sizes of the level's pictures and tables."""
    wad = WadFile(wad_bytes)
    info = load_default_tables()
    tables = MapTables.load(wad, map_name)
    a = LevelAssets.load(wad, tables, info.sprite_names)
    texels = lambda w, h: int((np.asarray(w, np.int64)
                               * np.asarray(h, np.int64)).sum())
    sides = tables.line_sides[(tables.line_flags & TWOSIDED) != 0]
    mid = np.unique(a.side_middle_tex[sides[sides >= 0]])
    mid = mid[mid >= 0]
    return LevelBytes(
        walls=texels(a.tex_w, a.tex_h),
        mids=texels(a.tex_w[mid], a.tex_h[mid]),
        flats=int(a.flat_pixels.shape[0]) * 64 * 64,
        sprites=texels(a.spr_w, a.spr_h),
        palette=int(a.palette.size),
        geometry=sum(int(wad.map_lump_entry(map_name, k).size)
                     for k in _GEOMETRY),
        sectors=int(len(tables.sector_light)),
        mobjs=int(len(tables.thing_type)),
    )


def camera_bytes(lv: LevelBytes, items: bool) -> int:
    """A camera's record: pos, angle, floor height, time, the sectors'
    light levels, and for the items layer the map objects' states."""
    return 4 * (5 + lv.sectors + (lv.mobjs if items else 0))


@dataclass(frozen=True)
class Work:
    bytes: float
    ops: float

    def least_s(self) -> tuple[float, str]:
        mem, ops = self.bytes / HBM_BYTES_PER_S, self.ops / F32_FLOP_PER_S
        return (mem, "bytes") if mem >= ops else (ops, "operations")


def paint_layer(B: int, H: int, W: int, lv: LevelBytes) -> Work:
    """K1 (walls, planes and sky at emit time): writes the idx and rgb
    planes; reads the wall and flat texels, the palette and the geometry
    once and every camera's record; one f32 operation a pixel (the light
    diminish)."""
    return Work(
        bytes=2 * FRAME_PLANE_BYTES * B * H * W + lv.walls + lv.flats
        + lv.palette + lv.geometry + B * camera_bytes(lv, False),
        ops=B * H * W)


def items_layer(B: int, written_px: float, lv: LevelBytes) -> Work:
    """K2 (sprites and masked mids over the frame): writes the idx and
    rgb planes at the `written_px` pixels that items cover, and nowhere
    else; reads the sprite texels and the two-sided lines' mid texels,
    the palette and the geometry once and every camera's record with its
    map objects; one f32 operation a pixel written (the light diminish)."""
    return Work(
        bytes=2 * FRAME_PLANE_BYTES * written_px + lv.sprites + lv.mids
        + lv.palette + lv.geometry + B * camera_bytes(lv, True),
        ops=written_px)


def scan_layer(B: int, spans: float, lv: LevelBytes) -> Work:
    """K4 (the occlusion walk of the scan pipeline): writes the `spans`
    it hands on, one a visible piece of a wall or plane in a column,
    SPAN_BYTES each (a per-pixel surface id, 4 bytes a pixel, would be
    several times as much: about 16 spans a column of 200 rows at the
    cells' views; the resolve that follows expands the spans);
    reads the geometry once and every camera's record; no operation
    counted (the walk's arithmetic depends on the data)."""
    return Work(bytes=SPAN_BYTES * spans + lv.geometry
                + B * camera_bytes(lv, False), ops=0)


# ---- the probes: counts of the data-dependent work, on the same calls
# the traced run profiles (tracing.Probes).  Each takes the wrapped
# function and its arguments and returns (its result, the count).

def items_written_px(fn, level, cfg, ipool, icnt, idx, ld, rgb, *a, **kw):
    """The pixels the item composite (ops/items.py::composite_items)
    writes: those whose idx, ld or rgb it changes.  A pixel an item
    rewrites with the very values it held goes uncounted, so the count
    is a lower bound."""
    before = (idx.clone(), ld.clone(), rgb.clone())
    out = fn(level, cfg, ipool, icnt, idx, ld, rgb, *a, **kw)
    changed = torch.zeros_like(before[0], dtype=torch.bool)
    for x0, x1 in zip(before, out):
        changed |= x0 != x1
    return out, changed.sum()


def scan_spans(fn, *a, **kw):
    """The spans the wall scan (ops/scan.py::scan) emits: its counts."""
    out = fn(*a, **kw)
    return out, out["cnt"].to(torch.int64).sum()
