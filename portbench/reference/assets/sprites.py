"""Sprites: frame/rotation pictures scanned from the S_START..S_END range.

Lump naming (sprites.rs:26-97): ``NNNNFR[FR]`` — 4-char sprite name, frame
letter (A=0...), rotation digit (0 = omnidirectional, 1..8 = 45-degree
steps); an optional second frame/rotation pair reuses the same lump
MIRRORED.  A rotated frame must have exactly 8 rotations.

Output: a flat picture list plus a dense (sprite, frame, rotation) ->
picture-id table for device-side lookup.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.assets.pictures import Picture, decode_picture
from portbench.reference.wad.reader import WadFile


class SpriteStore:
    def __init__(self, wad: WadFile, sprite_names: list[str]):
        self.sprite_names = sprite_names
        self.pictures: list[Picture] = []
        # (sprite_ix, frame) -> {rotation(0-indexed or 0): pic_ix}
        frames: dict[tuple[int, int], dict[int, int]] = {}
        self.rotate: dict[tuple[int, int], bool] = {}

        name_ix = {n: i for i, n in enumerate(sprite_names)}
        raw_found: dict[int, dict[int, dict[int, int]]] = {}

        for entry in wad.sprite_entries():
            nm = entry.name
            if len(nm) < 6:
                continue
            six = name_ix.get(nm[:4])
            if six is None:
                continue
            pic_ix = len(self.pictures)
            self.pictures.append(decode_picture(wad.lump_at(entry), nm))
            frame = ord(nm[4]) - ord("A")
            rotation = ord(nm[5]) - ord("0")
            raw_found.setdefault(six, {}).setdefault(frame, {})[rotation] = pic_ix
            if len(nm) > 6:
                # mirrored second frame/rotation (sprites.rs:48-56)
                mpic_ix = len(self.pictures)
                self.pictures.append(self.pictures[pic_ix].mirrored())
                frame2 = ord(nm[6]) - ord("A")
                rot2 = ord(nm[7]) - ord("0")
                raw_found.setdefault(six, {}).setdefault(frame2, {})[rot2] = mpic_ix

        for six, sprite_frames in raw_found.items():
            for frame, rotations in sprite_frames.items():
                rotate = len(rotations) != 1
                if rotate and len(rotations) != 8:
                    raise ValueError(
                        f"Got something other than 8 rotations for "
                        f"{self.sprite_names[six]}/{frame}: {len(rotations)}"
                    )
                self.rotate[(six, frame)] = rotate
                frames[(six, frame)] = rotations

        self.frames = frames
        self.max_frame = 1 + max(
            (f for (_, f) in frames.keys()), default=-1
        )

    def picture_ix(self, sprite_ix: int, frame: int, rotation: int) -> int:
        """(sprite, frame, player-relative rotation 0..7) -> picture index.

        Mirrors get_picture (sprites.rs:99-117): non-rotated frames ignore
        the rotation; rotated frames index rotation+1 in lump numbering.
        """
        rotations = self.frames.get((sprite_ix, frame))
        if rotations is None:
            raise KeyError(
                f"Unknown frame {frame} for {self.sprite_names[sprite_ix]}"
            )
        if not self.rotate[(sprite_ix, frame)]:
            return next(iter(rotations.values()))
        return rotations[rotation + 1]

    def lookup_table(self) -> np.ndarray:
        """[NSPR, MAXFRAME, 8] i32 picture ids (-1 where undefined)."""
        n = len(self.sprite_names)
        table = np.full((n, max(self.max_frame, 1), 8), -1, dtype=np.int32)
        for (six, frame), rotations in self.frames.items():
            for rot in range(8):
                if self.rotate[(six, frame)]:
                    table[six, frame, rot] = rotations[rot + 1]
                else:
                    table[six, frame, rot] = next(iter(rotations.values()))
        return table
