"""LevelAssets: every texture/flat/sprite a level needs, as padded atlases.

This is the device-upload boundary: after construction everything is a
fixed-shape NumPy array (palette, flat atlas, wall-texture atlas, sprite
atlas, id tables), ready to become jnp device constants.  Name resolution
(sector flat names, sidedef texture names, sky selection by map name)
happens here, once, at load time.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from portbench.reference.assets.flats import FlatStore
from portbench.reference.assets.sprites import SpriteStore
from portbench.reference.assets.textures import TextureStore
from portbench.reference.level.tables import MapTables
from portbench.reference.wad.reader import WadFile


def select_sky_name(map_name: str) -> str:
    """Sky texture from the map name (game.rs:199-227)."""
    m = re.search(r"e(\d+)m(\d+)", map_name.lower())
    if m:
        episode = int(m.group(1))
        return {1: "SKY1", 2: "SKY2", 3: "SKY3"}.get(episode, "SKY1")
    m = re.search(r"(\d\d)", map_name)
    if m:
        n = int(m.group(1))
        return "SKY1" if n < 12 else ("SKY2" if n < 21 else "SKY3")
    return "SKY1"


@dataclass
class LevelAssets:
    palette: np.ndarray        # [256, 3] u8

    # flats
    flat_pixels: np.ndarray    # [F, 64, 64] u8
    flat_anim_base: np.ndarray # [F] i32
    flat_anim_len: np.ndarray  # [F] i32
    flat_is_sky: np.ndarray    # [F] bool
    sector_floor_flat: np.ndarray  # [SEC] i32
    sector_ceil_flat: np.ndarray   # [SEC] i32

    # wall textures (padded atlas)
    tex_pixels: np.ndarray     # [T, TH, TW] u8
    tex_mask: np.ndarray       # [T, TH, TW] bool
    tex_w: np.ndarray          # [T] i32
    tex_h: np.ndarray          # [T] i32
    tex_names: list[str]
    side_upper_tex: np.ndarray   # [S] i32 (-1 = none)
    side_lower_tex: np.ndarray   # [S] i32
    side_middle_tex: np.ndarray  # [S] i32
    sky_tex: int

    # sprites (padded atlas)
    spr_pixels: np.ndarray     # [P, PH, PW] u8
    spr_mask: np.ndarray       # [P, PH, PW] bool
    spr_w: np.ndarray          # [P] i32
    spr_h: np.ndarray          # [P] i32
    spr_left: np.ndarray       # [P] i32
    spr_top: np.ndarray        # [P] i32
    spr_table: np.ndarray      # [NSPR, MAXFRAME, 8] i32 picture ids

    flat_names: list[str] = field(default_factory=list)

    # ------------------------------------------------------------------
    @classmethod
    def load(
        cls, wad: WadFile, tables: MapTables, sprite_names: list[str]
    ) -> "LevelAssets":
        palette = np.asarray(wad.lump("PLAYPAL")[:768]).reshape(256, 3).copy()

        # ---- flats -----------------------------------------------------
        needed = set(tables.sector_floor_flat) | set(tables.sector_ceil_flat)
        flats = FlatStore(wad, needed)
        sector_floor_flat = np.array(
            [flats.id_of(n) for n in tables.sector_floor_flat], np.int32
        )
        sector_ceil_flat = np.array(
            [flats.id_of(n) for n in tables.sector_ceil_flat], np.int32
        )

        # ---- wall textures ----------------------------------------------
        store = TextureStore(wad)
        wanted: list[str] = []

        def want(name: str) -> None:
            key = name.upper()
            if key != "-" and key not in wanted and store.has(key):
                wanted.append(key)

        for names in (tables.side_upper, tables.side_lower, tables.side_middle):
            for n in names:
                want(n)
        sky_name = select_sky_name(tables.name)
        if not store.has(sky_name):
            # fall back to any SKY* texture, then to the first texture
            for cand in sorted(store.defs):
                if cand.startswith("SKY"):
                    sky_name = cand
                    break
        want(sky_name)

        composed = [store.compose(n) for n in wanted]
        tex_w = np.array([p.shape[1] for p, _ in composed] or [1], np.int32)
        tex_h = np.array([p.shape[0] for p, _ in composed] or [1], np.int32)
        th, tw = int(tex_h.max()), int(tex_w.max())
        t = max(len(composed), 1)
        tex_pixels = np.zeros((t, th, tw), np.uint8)
        tex_mask = np.zeros((t, th, tw), bool)
        for i, (p, m) in enumerate(composed):
            tex_pixels[i, : p.shape[0], : p.shape[1]] = p
            tex_mask[i, : m.shape[0], : m.shape[1]] = m

        tex_ix = {n: i for i, n in enumerate(wanted)}

        def resolve(names: list[str]) -> np.ndarray:
            return np.array(
                [tex_ix.get(n.upper(), -1) if n != "-" else -1 for n in names],
                np.int32,
            )

        # ---- sprites ------------------------------------------------------
        sprites = SpriteStore(wad, sprite_names)
        p = max(len(sprites.pictures), 1)
        spr_w = np.array([pic.width for pic in sprites.pictures] or [1], np.int32)
        spr_h = np.array([pic.height for pic in sprites.pictures] or [1], np.int32)
        ph = int(spr_h.max()) if len(sprites.pictures) else 1
        pw = int(spr_w.max()) if len(sprites.pictures) else 1
        spr_pixels = np.zeros((p, ph, pw), np.uint8)
        spr_mask = np.zeros((p, ph, pw), bool)
        for i, pic in enumerate(sprites.pictures):
            spr_pixels[i, : pic.height, : pic.width] = pic.pixels
            spr_mask[i, : pic.height, : pic.width] = pic.mask

        return cls(
            palette=palette,
            flat_pixels=flats.pixels,
            flat_anim_base=flats.anim_base,
            flat_anim_len=flats.anim_len,
            flat_is_sky=flats.is_sky,
            sector_floor_flat=sector_floor_flat,
            sector_ceil_flat=sector_ceil_flat,
            tex_pixels=tex_pixels,
            tex_mask=tex_mask,
            tex_w=tex_w,
            tex_h=tex_h,
            tex_names=wanted,
            side_upper_tex=resolve(tables.side_upper),
            side_lower_tex=resolve(tables.side_lower),
            side_middle_tex=resolve(tables.side_middle),
            sky_tex=tex_ix.get(sky_name.upper(), 0),
            spr_pixels=spr_pixels,
            spr_mask=spr_mask,
            spr_w=spr_w,
            spr_h=spr_h,
            spr_left=np.array(
                [pic.left_offset for pic in sprites.pictures] or [0], np.int32
            ),
            spr_top=np.array(
                [pic.top_offset for pic in sprites.pictures] or [0], np.int32
            ),
            spr_table=sprites.lookup_table(),
            flat_names=flats.names,
        )
