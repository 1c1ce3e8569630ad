"""WAD container I/O (layer L0).

Parses the IWAD/PWAD header and directory into NumPy-friendly structures.
Behavioral parity with the reference loader (wad.rs:84-196):

- 12-byte header: 4-char magic, lump count u32, directory offset u32.
- 16-byte directory entries: offset u32, size u32, 8-byte name
  (NUL-padded or exactly 8 chars), uppercased for lookups.
- Map lumps are located by a fixed offset from the map marker lump
  (THINGS=+1 ... BLOCKMAP=+10, wad.rs:8-19).
- The sprite lump range is S_START..S_END (wad.rs:105-106).

Unlike the reference we accept PWADs too (useful for fixtures); the CLI
mirrors the reference's IWAD-only strictness via `require_iwad`.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


class MapLump(enum.IntEnum):
    """Offset of each map lump from its map marker (reference wad.rs:8-19)."""

    THINGS = 1
    LINEDEFS = 2
    SIDEDEFS = 3
    VERTEXES = 4
    SEGS = 5
    SSECTORS = 6
    NODES = 7
    SECTORS = 8
    REJECT = 9
    BLOCKMAP = 10


def decode_name(raw: bytes) -> str:
    """Decode an 8-byte lump name: NUL-terminated or exactly 8 chars."""
    return raw.split(b"\0", 1)[0].decode("ascii", errors="replace")


@dataclass
class DirEntry:
    index: int
    name: str
    offset: int
    size: int


class WadFile:
    """A loaded WAD: raw bytes + parsed directory."""

    def __init__(self, data: bytes, require_iwad: bool = False):
        self.data = np.frombuffer(bytes(data), dtype=np.uint8)
        magic = bytes(self.data[0:4]).decode("ascii", errors="replace")
        if magic not in ("IWAD", "PWAD"):
            raise ValueError(f"Not a WAD file (magic {magic!r})")
        if require_iwad and magic != "IWAD":
            # The reference only handles IWADs (wad.rs:90-92).
            raise ValueError(f"Unhandled WAD file type: {magic}")
        self.magic = magic
        self.lump_count = int(self.read_u32(4))
        dir_offset = int(self.read_u32(8))

        self.dirs: list[DirEntry] = []
        self.by_name: dict[str, DirEntry] = {}
        for i in range(self.lump_count):
            off = dir_offset + i * 16
            entry = DirEntry(
                index=i,
                name=decode_name(bytes(self.data[off + 8 : off + 16])).upper(),
                offset=int(self.read_u32(off)),
                size=int(self.read_u32(off + 4)),
            )
            self.dirs.append(entry)
            self.by_name[entry.name] = entry

        self.first_sprite_lump = (
            self.by_name["S_START"].index if "S_START" in self.by_name else -1
        )
        self.last_sprite_lump = (
            self.by_name["S_END"].index if "S_END" in self.by_name else -1
        )

    @classmethod
    def from_path(cls, path: str, require_iwad: bool = False) -> "WadFile":
        with open(path, "rb") as f:
            return cls(f.read(), require_iwad=require_iwad)

    # -- little-endian scalar readers (wad.rs:185-195) ---------------------
    def read_i16(self, offset: int) -> int:
        return int(self.data[offset : offset + 2].view("<i2")[0])

    def read_u32(self, offset: int) -> int:
        return int(self.data[offset : offset + 4].view("<u4")[0])

    def read_name(self, offset: int) -> str:
        return decode_name(bytes(self.data[offset : offset + 8]))

    # -- lump access --------------------------------------------------------
    def entry(self, name: str) -> DirEntry:
        e = self.by_name.get(name.upper())
        if e is None:
            raise KeyError(f"Could not find lump {name}")
        return e

    def has(self, name: str) -> bool:
        return name.upper() in self.by_name

    def lump(self, name: str) -> np.ndarray:
        e = self.entry(name)
        return self.data[e.offset : e.offset + e.size]

    def lump_at(self, entry: DirEntry) -> np.ndarray:
        return self.data[entry.offset : entry.offset + entry.size]

    def map_lump_entry(self, map_name: str, which: MapLump) -> DirEntry:
        """Map lumps live at a fixed offset after the marker (wad.rs:175-183)."""
        marker = self.entry(map_name)
        return self.dirs[marker.index + int(which)]

    def map_lump(self, map_name: str, which: MapLump) -> np.ndarray:
        return self.lump_at(self.map_lump_entry(map_name, which))

    def records(self, map_name: str, which: MapLump, rec_size: int) -> np.ndarray:
        """A map lump reshaped to [count, rec_size] bytes."""
        raw = self.map_lump(map_name, which)
        count = len(raw) // rec_size
        return raw[: count * rec_size].reshape(count, rec_size)

    def sprite_entries(self) -> list[DirEntry]:
        """Lumps in the S_START..S_END range (wad.rs:105-106, sprites.rs:35)."""
        if self.first_sprite_lump < 0:
            return []
        return self.dirs[self.first_sprite_lump : self.last_sprite_lump]


def fields_i16(records: np.ndarray, byte_offset: int) -> np.ndarray:
    """Read an i16 field from every record of a [N, rec] byte array."""
    return records[:, byte_offset : byte_offset + 2].copy().view("<i2").ravel()


def fields_name(records: np.ndarray, byte_offset: int) -> list[str]:
    """Read an 8-byte name field from every record."""
    return [
        decode_name(bytes(records[i, byte_offset : byte_offset + 8]))
        for i in range(records.shape[0])
    ]
