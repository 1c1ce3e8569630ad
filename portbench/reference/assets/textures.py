"""Wall textures: PNAMES + TEXTURE1/2 definitions composed from patches.

Composition semantics match the reference exactly (textures.rs:74-103):
patches are blitted in definition order with bounds clipping, and a later
patch's TRANSPARENT pixels overwrite earlier opaque ones (the reference
assigns the Option wholesale).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference.assets.pictures import Picture, decode_picture
from portbench.reference.wad.reader import WadFile


@dataclass
class TextureDef:
    name: str
    width: int
    height: int
    patches: list[tuple[int, int, int]]  # (origin_x, origin_y, pname index)


class TextureStore:
    def __init__(self, wad: WadFile):
        self.wad = wad
        self.pnames: list[str] = []
        self.defs: dict[str, TextureDef] = {}
        self._pictures: dict[int, Picture] = {}
        self._composed: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._load_pnames()
        # TEXTURE1 always present; TEXTURE2 only in registered IWADs
        # (textures.rs:141-148)
        if wad.has("TEXTURE1"):
            self._load_list("TEXTURE1")
        if wad.has("TEXTURE2"):
            self._load_list("TEXTURE2")

    def _load_pnames(self) -> None:
        if not self.wad.has("PNAMES"):
            return
        raw = self.wad.lump("PNAMES")
        count = int(raw[0:4].view("<u4")[0])
        for i in range(count):
            off = 4 + i * 8
            self.pnames.append(
                bytes(raw[off : off + 8]).split(b"\0", 1)[0].decode("ascii")
            )

    def _load_list(self, lump_name: str) -> None:
        raw = np.ascontiguousarray(self.wad.lump(lump_name))
        count = int(raw[0:4].view("<u4")[0])
        offsets = raw[4 : 4 + 4 * count].view("<u4")
        for i in range(count):
            off = int(offsets[i])
            name = bytes(raw[off : off + 8]).split(b"\0", 1)[0].decode("ascii")
            width = int(raw[off + 12 : off + 14].view("<i2")[0])
            height = int(raw[off + 14 : off + 16].view("<i2")[0])
            patch_count = int(raw[off + 20 : off + 22].view("<i2")[0])
            patches = []
            for j in range(patch_count):
                p = off + 22 + j * 10
                patches.append((
                    int(raw[p : p + 2].view("<i2")[0]),
                    int(raw[p + 2 : p + 4].view("<i2")[0]),
                    int(raw[p + 4 : p + 6].view("<i2")[0]),
                ))
            self.defs[name.upper()] = TextureDef(name, width, height, patches)

    def _picture(self, pname_ix: int) -> Picture:
        if pname_ix not in self._pictures:
            name = self.pnames[pname_ix]
            self._pictures[pname_ix] = decode_picture(self.wad.lump(name), name)
        return self._pictures[pname_ix]

    def compose(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """Compose a texture -> (pixels [h,w] u8, mask [h,w] bool)."""
        key = name.upper()
        if key in self._composed:
            return self._composed[key]
        d = self.defs.get(key)
        if d is None:
            raise KeyError(f"Unknown texture {name}")
        pix = np.zeros((d.height, d.width), dtype=np.uint8)
        mask = np.zeros((d.height, d.width), dtype=bool)
        for ox, oy, pnum in d.patches:
            pic = self._picture(pnum)
            # clipped blit; Option assigned wholesale (textures.rs:88-100)
            x0, y0 = max(0, ox), max(0, oy)
            x1 = min(d.width, ox + pic.width)
            y1 = min(d.height, oy + pic.height)
            if x1 <= x0 or y1 <= y0:
                continue
            sx0, sy0 = x0 - ox, y0 - oy
            pix[y0:y1, x0:x1] = pic.pixels[sy0 : sy0 + y1 - y0, sx0 : sx0 + x1 - x0]
            mask[y0:y1, x0:x1] = pic.mask[sy0 : sy0 + y1 - y0, sx0 : sx0 + x1 - x0]
        self._composed[key] = (pix, mask)
        return pix, mask

    def has(self, name: str) -> bool:
        return name.upper() in self.defs
