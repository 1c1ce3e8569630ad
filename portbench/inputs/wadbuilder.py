"""Programmatic WAD construction.

There is no game WAD in this environment, so the framework ships a builder
that emits fully valid IWAD bytes — used by the test suite and the bench
as fixtures, and usable by downstream users to author levels from Python.

Formats implemented (all little-endian, per the public WAD spec and the
offsets the reference loader reads):
- container: 12-byte header + lumps + 16-byte directory (wad.rs:57-64,131-158)
- picture format: header + column offsets + posts (pictures.rs:100-126)
- PNAMES / TEXTURE1 texture definitions (textures.rs:182-255)
- flats: raw 64x64 bytes (flats.rs:116-136)
"""

from __future__ import annotations

import struct

import numpy as np

FLAT_SIZE = 64  # flats are 64x64 tiles


def _name8(name: str) -> bytes:
    b = name.upper().encode("ascii")
    if len(b) > 8:
        raise ValueError(f"lump name too long: {name}")
    return b.ljust(8, b"\0")


class WadBuilder:
    def __init__(self, magic: str = "IWAD"):
        self.magic = magic
        self.lumps: list[tuple[str, bytes]] = []

    def add(self, name: str, data: bytes = b"") -> "WadBuilder":
        self.lumps.append((name, bytes(data)))
        return self

    def build(self) -> bytes:
        header_size = 12
        body = bytearray()
        dir_entries = bytearray()
        offset = header_size
        for name, data in self.lumps:
            dir_entries += struct.pack("<II", offset if data else 0, len(data))
            dir_entries += _name8(name)
            body += data
            offset += len(data)
        header = struct.pack("<4sII", self.magic.encode(), len(self.lumps), offset)
        return bytes(header + body + dir_entries)


# ---------------------------------------------------------------------------
# Asset encoders
# ---------------------------------------------------------------------------

def encode_picture(
    pixels: np.ndarray, mask: np.ndarray, left_offset: int = 0, top_offset: int = 0
) -> bytes:
    """Encode a paletted image into the Doom picture (patch) format.

    pixels: [h, w] uint8 palette indices; mask: [h, w] bool (True=opaque).
    Columns are runs of opaque posts with a 0xFF terminator
    (decoded by the reference at pictures.rs:100-126).
    """
    h, w = pixels.shape
    header = struct.pack("<hhhh", w, h, left_offset, top_offset)
    columns = []
    for x in range(w):
        col = bytearray()
        y = 0
        while y < h:
            if not mask[y, x]:
                y += 1
                continue
            top = y
            while y < h and mask[y, x] and (y - top) < 127:
                y += 1
            data = bytes(pixels[top:y, x].astype(np.uint8))
            # post: topdelta, length, unused pad, data, unused pad
            col += bytes([top, len(data), 0]) + data + b"\0"
        col += b"\xff"
        columns.append(bytes(col))

    col_dir_size = 4 * w
    offsets = []
    pos = 8 + col_dir_size
    for col in columns:
        offsets.append(pos)
        pos += len(col)
    return header + struct.pack(f"<{w}I", *offsets) + b"".join(columns)


def encode_flat(pixels: np.ndarray) -> bytes:
    """A flat is 64x64 raw palette indices (flats.rs:116-136)."""
    assert pixels.shape == (FLAT_SIZE, FLAT_SIZE)
    return bytes(pixels.astype(np.uint8).ravel())


def encode_pnames(names: list[str]) -> bytes:
    out = struct.pack("<I", len(names))
    for n in names:
        out += _name8(n)
    return out


def encode_texture1(textures: list[dict]) -> bytes:
    """TEXTURE1 lump: list of texture defs made of patch placements.

    Each dict: {name, width, height, patches: [(origin_x, origin_y, pname_idx)]}
    Field offsets as read by the reference (textures.rs:208-255).
    """
    defs = []
    for t in textures:
        d = _name8(t["name"])
        d += struct.pack("<I", 0)  # masked (unused)
        d += struct.pack("<hh", t["width"], t["height"])
        d += struct.pack("<I", 0)  # columndirectory (unused)
        d += struct.pack("<h", len(t["patches"]))
        for ox, oy, pidx in t["patches"]:
            d += struct.pack("<hhhhh", ox, oy, pidx, 0, 0)
        defs.append(d)

    header = struct.pack("<I", len(defs))
    offsets = []
    pos = 4 + 4 * len(defs)
    for d in defs:
        offsets.append(pos)
        pos += len(d)
    return header + struct.pack(f"<{len(defs)}I", *offsets) + b"".join(defs)


def default_palette() -> np.ndarray:
    """A deterministic 256-color palette for synthetic WADs.

    Index 0 is black; a gray ramp lives at 1..32; the rest is a procedural
    but perceptually-spread ramp so rendered screenshots are debuggable.
    """
    pal = np.zeros((256, 3), dtype=np.uint8)
    for i in range(1, 33):
        g = int(i * 255 / 32)
        pal[i] = (g, g, g)
    for i in range(33, 256):
        pal[i] = ((i * 7) % 256, (i * 13) % 256, (i * 29) % 256)
    return pal


def encode_playpal(palette: np.ndarray) -> bytes:
    """PLAYPAL: 14 palettes of 768 bytes; we repeat palette 0.

    The reference reads only palette 0 (palette.rs:11-28).
    """
    one = bytes(palette.astype(np.uint8).ravel())
    return one * 14


def encode_colormap(palette: np.ndarray) -> bytes:
    """COLORMAP: 34 light-level maps of 256 indices.

    The reference never reads this lump (light diminishing is float RGB
    arithmetic, bitmap_render.rs:190-208) but real IWADs carry it and the
    framework's optional colormap-LUT lighting path consumes it.
    Map i scales brightness by (32-i)/32 and snaps to the nearest palette
    entry; map 32 is the inverted "invulnerability" map, 33 is black.
    """
    pal = palette.astype(np.int32)
    maps = []
    for i in range(32):
        scaled = (pal * (32 - i)) // 32
        # nearest palette entry (L2) per scaled color
        d = ((scaled[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
        maps.append(np.argmin(d, axis=1).astype(np.uint8))
    gray = pal.mean(axis=1, keepdims=True)
    inv = 255 - gray
    d = ((inv[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
    maps.append(np.argmin(d, axis=1).astype(np.uint8))
    maps.append(np.zeros(256, dtype=np.uint8))
    return b"".join(bytes(m) for m in maps)
