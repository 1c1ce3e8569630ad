"""Doom picture (patch) format decoding (layer L2).

A picture is column-major run-length data: per column a list of posts
(top offset, length, pixels) terminated by 0xff; pixels outside posts are
transparent (decoded by the reference at pictures.rs:100-126).

Decoded form: dense [h, w] uint8 palette indices + [h, w] bool opacity
mask — the reference's Vec<Vec<Option<u8>>> (bitmap.rs:10-15) split into
two planes, which is what fixed-shape device gathers want.

The NumPy decoder of the port, copied (the reference has no native
decoder).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np



@dataclass
class Picture:
    name: str
    width: int
    height: int
    left_offset: int
    top_offset: int
    pixels: np.ndarray  # [h, w] u8
    mask: np.ndarray    # [h, w] bool

    def mirrored(self) -> "Picture":
        """Horizontal mirror (used for shared sprite rotations,
        pictures.rs:129-147)."""
        return Picture(
            self.name, self.width, self.height, self.left_offset,
            self.top_offset, self.pixels[:, ::-1].copy(), self.mask[:, ::-1].copy(),
        )


def decode_picture(raw: np.ndarray, name: str = "?") -> Picture:
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    w = int(raw[0:2].view("<i2")[0])
    h = int(raw[2:4].view("<i2")[0])
    left = int(raw[4:6].view("<i2")[0])
    top = int(raw[6:8].view("<i2")[0])

    pixels = np.zeros((h, w), dtype=np.uint8)
    mask = np.zeros((h, w), dtype=bool)
    col_offsets = raw[8 : 8 + 4 * w].view("<u4")
    for x in range(w):
        off = int(col_offsets[x])
        while True:
            y_offset = int(raw[off])
            if y_offset == 0xFF:
                break
            length = int(raw[off + 1])
            data = raw[off + 3 : off + 3 + length]
            pixels[y_offset : y_offset + length, x] = data
            mask[y_offset : y_offset + length, x] = True
            off += length + 4
    return Picture(name, w, h, left, top, pixels, mask)
