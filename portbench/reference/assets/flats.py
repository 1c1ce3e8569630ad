"""Flats: 64x64 floor/ceiling tiles + the hardcoded animation cycles.

Animated groups and the 3-cycles-per-second rule mirror the reference
(flats.rs:30-75, get_animated flats.rs:103-111): every member of a group
renders as ``group[(timestamp * 3) as usize % len]``.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.config import FLAT_SIZE
from portbench.reference.wad.reader import WadFile

# https://doomwiki.org/wiki/Animated_flat — defined in doom p_spec.c
ANIMATED_FLAT_GROUPS: list[list[str]] = [
    ["NUKAGE1", "NUKAGE2", "NUKAGE3"],
    ["FWATER1", "FWATER2", "FWATER3", "FWATER4"],
    ["SWATER1", "SWATER2", "SWATER3", "SWATER4"],
    ["LAVA1", "LAVA2", "LAVA3", "LAVA4"],
    ["BLOOD1", "BLOOD2", "BLOOD3"],
    ["RROCK05", "RROCK06", "RROCK07", "RROCK08"],
    ["SLIME01", "SLIME02", "SLIME03", "SLIME04"],
    ["SLIME05", "SLIME06", "SLIME07", "SLIME08"],
    ["SLIME09", "SLIME10", "SLIME11", "SLIME12"],
]

ANIM_GROUP_OF = {
    name: group for group in ANIMATED_FLAT_GROUPS for name in group
}


def expand_animated(names: set[str]) -> set[str]:
    """Close a set of flat names under animation groups."""
    out = set(names)
    for n in names:
        out.update(ANIM_GROUP_OF.get(n, []))
    return out


def decode_flat(raw: np.ndarray) -> np.ndarray:
    """Raw 4096-byte lump -> [64, 64] u8 (flats.rs:116-136)."""
    return np.asarray(raw[: FLAT_SIZE * FLAT_SIZE], dtype=np.uint8).reshape(
        FLAT_SIZE, FLAT_SIZE
    )


class FlatStore:
    """All flats a level needs, in one [F, 64, 64] atlas.

    Per-flat animation metadata lets the renderer resolve the animated
    variant as pure indexing:
        rendered_id = anim_base[id] + cycle(timestamp) % anim_len[id]
    where cycle uses consecutive atlas slots for each group.
    """

    def __init__(self, wad: WadFile, needed: set[str]):
        needed = expand_animated({n.upper() for n in needed})
        # place animated groups contiguously, in group order
        ordered: list[str] = []
        seen = set()
        for group in ANIMATED_FLAT_GROUPS:
            if any(n in needed for n in group):
                for n in group:
                    if wad.has(n):
                        ordered.append(n)
                        seen.add(n)
        for n in sorted(needed):
            if n not in seen and wad.has(n):
                ordered.append(n)
                seen.add(n)

        self.names = ordered
        self.index = {n: i for i, n in enumerate(ordered)}
        pixels = np.zeros((max(len(ordered), 1), FLAT_SIZE, FLAT_SIZE), np.uint8)
        for i, n in enumerate(ordered):
            pixels[i] = decode_flat(wad.lump(n))
        self.pixels = pixels

        f = len(ordered)
        self.anim_base = np.arange(max(f, 1), dtype=np.int32)
        self.anim_len = np.ones(max(f, 1), dtype=np.int32)
        for group in ANIMATED_FLAT_GROUPS:
            present = [n for n in group if n in self.index]
            if len(present) > 1:
                base = self.index[present[0]]
                for n in present:
                    self.anim_base[self.index[n]] = base
                    self.anim_len[self.index[n]] = len(present)

        # the sky flat is special-cased by name (visplanes.rs:91)
        self.is_sky = np.array(
            [("SKY" in n) for n in ordered] or [False], dtype=bool
        )

    def id_of(self, name: str) -> int:
        return self.index.get(name.upper(), -1)

    def animated_id(self, flat_id: int, timestamp: float) -> int:
        """Host-side mirror of get_animated (flats.rs:103-111)."""
        base = int(self.anim_base[flat_id])
        n = int(self.anim_len[flat_id])
        if n == 1:
            return flat_id
        return base + int(timestamp * 3.0) % n
