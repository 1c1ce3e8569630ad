"""Device-resident level tables for the torch renderer.

Counterpart of doomtpu/render/device.py.  One `DeviceLevel` per loaded
map: every camera-independent quantity the render path needs, computed
once on the host with numpy and moved to the given device.  The JAX
level's TPU packings (texel rows 4 per word, the bf16 column atlases,
the 40-word item rows, the per-picture item_q / item_mq tables, one-hot
operands) have no counterpart: the paint kernel reads the unpacked
`tex_pixels`, `flat_pixels` and `sky_pixels` tables, the item and
item-pass kernels the unpacked column atlas `atlas_cm`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields

import numpy as np
import torch

from portbench.reference.assets.bundle import LevelAssets
from portbench.reference.config import (
    FLAT_SIZE, SKY_TEXTURE_HEIGHT, SKY_TEXTURE_WIDTH,
)
from portbench.reference.info.tables import InfoTables
from portbench.reference.level.tables import MapTables


def _sky_pixels(tex_pixels: np.ndarray, sky_tex: int) -> np.ndarray:
    """[128, 256] sky texel table: the sky texture's top-left window,
    zero-padded where the texture is smaller (the sky lookup's domain)."""
    sky = np.zeros((SKY_TEXTURE_HEIGHT, SKY_TEXTURE_WIDTH), np.int32)
    src = np.asarray(tex_pixels[sky_tex])
    sh = min(src.shape[0], SKY_TEXTURE_HEIGHT)
    sw = min(src.shape[1], SKY_TEXTURE_WIDTH)
    sky[:sh, :sw] = src[:sh, :sw]
    return sky


def _atlas(a: LevelAssets) -> tuple[np.ndarray, int]:
    """(atlas_cm, rows): every texture, flat and sprite column as one
    row of texel | opaque << 8, flattened [C * rows] (JAX device.py's
    atlas_cols / atlas_cm build, without its bf16 and packed copies)."""
    T, TH, TW = a.tex_pixels.shape
    F = a.flat_pixels.shape[0]
    P, PH, PW = a.spr_pixels.shape
    rows = max(TH, FLAT_SIZE, PH)

    def columns(pixels, mask, n, h, w):
        out = np.zeros((n * w, rows), np.int32)
        cm = pixels.astype(np.int32) | (mask.astype(np.int32) << 8)
        out[:, :h] = np.where(mask, cm, 0).transpose(0, 2, 1).reshape(n * w, h)
        return out

    flat_mask = np.ones(a.flat_pixels.shape, bool)
    atlas = np.concatenate([
        columns(a.tex_pixels, a.tex_mask, T, TH, TW),
        columns(a.flat_pixels, flat_mask, F, FLAT_SIZE, FLAT_SIZE),
        columns(a.spr_pixels, a.spr_mask, P, PH, PW),
    ])
    return atlas.reshape(-1), rows


_I32, _F32, _BOOL = torch.int32, torch.float32, torch.bool


@dataclass(eq=False)
class DeviceLevel:
    # --- seg geometry ------------------------------------------------
    seg_v1: torch.Tensor          # [G,2] f32
    seg_v2: torch.Tensor          # [G,2] f32
    seg_offset: torch.Tensor      # [G] i32
    seg_sub: torch.Tensor         # [G] i32
    seg_front_side: torch.Tensor  # [G] i32 (-1 = none)
    seg_front_sector: torch.Tensor  # [G] i32 (-1)
    seg_back_sector: torch.Tensor   # [G] i32 (-1)
    seg_two_sided: torch.Tensor   # [G] bool
    seg_unpeg_top: torch.Tensor   # [G] bool
    seg_unpeg_bottom: torch.Tensor  # [G] bool
    seg_xoff: torch.Tensor        # [G] i32 sidedef x offset (as i16)
    seg_yoff: torch.Tensor        # [G] i32
    seg_mid_tex: torch.Tensor     # [G] i32 (-1 = none)
    seg_low_tex: torch.Tensor     # [G] i32
    seg_up_tex: torch.Tensor      # [G] i32
    seg_draw_ceiling: torch.Tensor  # [G] bool
    seg_sky_hack: torch.Tensor    # [G] bool
    # --- BSP traversal -------------------------------------------------
    node_xy: torch.Tensor         # [N,2] f32
    node_dxy: torch.Tensor        # [N,2] f32
    sub_path_nodes: torch.Tensor  # [SS,D] i32
    sub_path_left: torch.Tensor   # [SS,D] i32
    sub_depth: torch.Tensor       # [SS] i32
    sub_sector: torch.Tensor      # [SS] i32
    node_child: torch.Tensor      # [N,2] i32 (raw, bit15 = subsector)
    # --- sectors ---------------------------------------------------------
    sector_floor_h: torch.Tensor  # [SEC] i32
    sector_ceil_h: torch.Tensor   # [SEC] i32
    sector_light0: torch.Tensor   # [SEC] i32
    sector_floor_flat: torch.Tensor  # [SEC] i32
    sector_ceil_flat: torch.Tensor   # [SEC] i32
    # --- assets ----------------------------------------------------------
    palette_packed: torch.Tensor  # [256] i32 0xRRGGBB
    flat_pixels: torch.Tensor     # [F,64,64] i32
    flat_is_sky: torch.Tensor     # [F] bool
    flat_anim_base: torch.Tensor  # [F] i32
    flat_anim_len: torch.Tensor   # [F] i32
    tex_pixels: torch.Tensor      # [T,TH,TW] i32
    tex_w: torch.Tensor           # [T] i32
    tex_h: torch.Tensor           # [T] i32
    sky_pixels: torch.Tensor      # [128,256] i32 (port only, see _sky_pixels)
    # --- sprites (the item pass) -------------------------------------------
    spr_w: torch.Tensor           # [P] i32
    spr_h: torch.Tensor           # [P] i32
    spr_top: torch.Tensor         # [P] i32
    spr_table: torch.Tensor       # [NSPR, MAXFRAME, 8] i32 picture ids
    # column-major sampling atlas over [wall texture columns | flat
    # columns | sprite columns], flattened: texel | opaque << 8 at
    # column * atlas_rows + row (the JAX level's atlas_cm)
    atlas_cm: torch.Tensor        # [C * ROWS] i32
    # --- info tables -------------------------------------------------------
    state_sprite: torch.Tensor      # [NS] i32
    state_frame: torch.Tensor       # [NS] i32
    state_full_bright: torch.Tensor  # [NS] bool
    state_tics: torch.Tensor        # [NS] i32
    state_next: torch.Tensor        # [NS] i32
    # --- map objects (static placement; the state lives in GameState) -------
    mobj_pos: torch.Tensor          # [MO,2] f32
    mobj_angle: torch.Tensor        # [MO] f32
    mobj_sector: torch.Tensor       # [MO] i32
    mobj_spawn_state: torch.Tensor  # [MO] i32
    mobj_death_state: torch.Tensor  # [MO] i32 (0: no death state)
    mobj_xdeath_state: torch.Tensor  # [MO] i32 (0: no extreme death)
    # segs with a drawable two-sided middle texture (the masked mids)
    dseg_ix: torch.Tensor           # [D] i32

    # static metadata
    tex_sizes_pow2: bool = False
    # eligibility for the paint kernel: wall-piece textures <= 256 x 128,
    # opaque wall pieces and an opaque sky (as the JAX level)
    paint_ok: bool = False
    # some wall-piece texture is wider than 128 (the texel column clamp
    # of the paint kernel is 256 then, else 128)
    texq_wide: bool = False
    # rows per atlas column: max(texture height, 64, sprite height)
    atlas_rows: int = 0
    # columns per sprite picture in the atlas (the padded sprite width)
    spr_pw: int = 0
    # texture id of the sky
    sky_tex: int = 0
    # the sky texture has no transparent texel (the resolve's one-gather
    # fetch); else transparent sky texels show the wall drawn earlier
    sky_is_opaque: bool = True
    # every solid / lower / upper wall-piece texture is opaque: the
    # resolve's winner fold is exact then (see render/resolve.py)
    wall_tex_all_opaque: bool = True
    # eligibility for the item-pass kernel (as the JAX level): atlas rows
    # <= 128, every sprite picture and every two-sided mid texture
    # <= 128 x 128
    itempaint_ok: bool = False

    STATIC_FIELDS = ("tex_sizes_pow2", "paint_ok", "texq_wide", "atlas_rows",
                     "spr_pw", "sky_tex", "sky_is_opaque",
                     "wall_tex_all_opaque", "itempaint_ok")

    @classmethod
    def tensor_fields(cls) -> tuple[str, ...]:
        return tuple(
            f.name for f in fields(cls) if f.name not in cls.STATIC_FIELDS
        )

    @property
    def device(self) -> torch.device:
        return self.seg_v1.device

    @property
    def num_segs(self) -> int:
        return self.seg_v1.shape[0]

    @property
    def num_sectors(self) -> int:
        return self.sector_floor_h.shape[0]

    @property
    def num_mobjs(self) -> int:
        return self.mobj_spawn_state.shape[0]

    @property
    def col_flat_off(self) -> int:
        """First flat column of the atlas."""
        return self.tex_pixels.shape[0] * self.tex_pixels.shape[2]

    @property
    def col_spr_off(self) -> int:
        """First sprite column of the atlas."""
        return self.col_flat_off + self.flat_pixels.shape[0] * FLAT_SIZE

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, tables: MapTables, assets: LevelAssets, info: InfoTables,
              device) -> "DeviceLevel":
        """Port of the JAX DeviceLevel.build, as far as this package reads
        it: numpy on the host, then one move to `device`."""
        t, a = tables, assets
        if t.sub_path_nodes.shape[1] > 62:
            raise NotImplementedError(
                f"BSP depth {t.sub_path_nodes.shape[1]} > 62; widen the "
                "two-word rank in camera.traversal_rank"
            )
        lines = t.seg_line
        front_side = t.line_sides[lines, t.seg_dir]
        back_side = t.line_sides[lines, 1 - t.seg_dir]
        front_sector = np.where(
            front_side >= 0, t.side_sector[np.maximum(front_side, 0)], -1
        )
        back_sector = np.where(
            back_side >= 0, t.side_sector[np.maximum(back_side, 0)], -1
        )
        flags = t.line_flags[lines]

        # sky hack: both sectors' ceiling flats are SKY (segs.rs:459-477)
        front_sky = np.array(
            ["SKY" in t.sector_ceil_flat[s] if s >= 0 else False
             for s in front_sector]
        )
        back_sky = np.array(
            ["SKY" in t.sector_ceil_flat[s] if s >= 0 else False
             for s in back_sector]
        )
        sky_hack = (back_side >= 0) & front_sky & back_sky
        fs_safe = np.maximum(front_side, 0)

        # mobjs: one per THINGS entry except player/deathmatch starts
        # (map_objects.rs:30-47)
        dn = info.mobj_index_by_doomednum()
        keep = ~(
            ((t.thing_type >= 1) & (t.thing_type <= 4)) | (t.thing_type == 11)
        )
        ids = np.nonzero(keep)[0]
        mobj_info_ix = np.array(
            [dn[int(t.thing_type[i])] for i in ids], np.int32
        )
        mobj_pos = t.thing_pos[ids]
        mobj_sector = np.array(
            [t.sector_at(float(p[0]), float(p[1])) for p in mobj_pos], np.int32
        )

        i16c = lambda x: np.clip(np.trunc(x), -32768, 32767).astype(np.int32)

        # textures drawn as non-masked wall pieces (solid mids, lowers,
        # uppers): the paint path needs them fully opaque
        two_sided_np = (flags & 4) != 0
        mid_np = np.asarray(a.side_middle_tex[fs_safe])
        dseg_ix = np.nonzero(two_sided_np & (mid_np >= 0))[0].astype(np.int32)
        low_np = np.asarray(a.side_lower_tex[fs_safe])
        up_np = np.asarray(a.side_upper_tex[fs_safe])
        wall_piece_tex = np.unique(np.concatenate([
            mid_np[~two_sided_np], low_np, up_np
        ]))
        wall_piece_tex = wall_piece_tex[wall_piece_tex >= 0]
        tex_opaque = np.array([
            bool(a.tex_mask[ti, : a.tex_h[ti], : a.tex_w[ti]].all())
            for ti in wall_piece_tex
        ], bool)
        wall_tex_all_opaque = bool(tex_opaque.all())
        if not wall_tex_all_opaque:
            bad = wall_piece_tex[~tex_opaque]
            warnings.warn(
                "level uses texture(s) with transparent texels on "
                f"solid/lower/upper wall pieces (tex ids {bad.tolist()}): "
                "pixels where multiple drawn wall spans overlap (span "
                "boundaries) may show black instead of the earlier wall "
                "(reference skip behavior, bitmap_render.rs:265)",
                stacklevel=2,
            )
        texq_wide = any(a.tex_w[ti] > 128 for ti in wall_piece_tex)
        twq = 256 if texq_wide else 128
        sky_is_opaque = bool(a.tex_mask[a.sky_tex].all())
        paint_ok = (
            wall_tex_all_opaque
            and all(a.tex_w[ti] <= twq and a.tex_h[ti] <= 128
                    for ti in wall_piece_tex)
            and sky_is_opaque
        )
        pal = a.palette.astype(np.int64)
        atlas_cm, atlas_rows = _atlas(a)
        mid_tex = np.unique(mid_np[two_sided_np])
        itempaint_ok = (
            atlas_rows <= 128
            and bool(np.all(a.spr_w <= 128)) and bool(np.all(a.spr_h <= 128))
            and all(a.tex_w[ti] <= 128 and a.tex_h[ti] <= 128
                    for ti in mid_tex[mid_tex >= 0])
        )

        arrays = dict(
            seg_v1=t.vertexes[t.seg_v[:, 0]],
            seg_v2=t.vertexes[t.seg_v[:, 1]],
            seg_offset=t.seg_offset,
            seg_sub=t.seg_sub,
            seg_front_side=front_side,
            seg_front_sector=front_sector,
            seg_back_sector=back_sector,
            seg_two_sided=two_sided_np,
            seg_unpeg_top=(flags & 8) != 0,
            seg_unpeg_bottom=(flags & 16) != 0,
            seg_xoff=i16c(t.side_offset[fs_safe, 0]),
            seg_yoff=i16c(t.side_offset[fs_safe, 1]),
            seg_mid_tex=a.side_middle_tex[fs_safe],
            seg_low_tex=a.side_lower_tex[fs_safe],
            seg_up_tex=a.side_upper_tex[fs_safe],
            seg_draw_ceiling=~sky_hack,
            seg_sky_hack=sky_hack,
            node_xy=t.node_xy,
            node_dxy=t.node_dxy,
            sub_path_nodes=np.maximum(t.sub_path_nodes, 0),
            sub_path_left=t.sub_path_left,
            sub_depth=t.sub_depth,
            sub_sector=t.sub_sector,
            node_child=t.node_child,
            sector_floor_h=t.sector_floor_h,
            sector_ceil_h=t.sector_ceil_h,
            sector_light0=t.sector_light,
            sector_floor_flat=a.sector_floor_flat,
            sector_ceil_flat=a.sector_ceil_flat,
            palette_packed=(pal[:, 0] << 16) | (pal[:, 1] << 8) | pal[:, 2],
            flat_pixels=a.flat_pixels,
            flat_is_sky=a.flat_is_sky,
            flat_anim_base=a.flat_anim_base,
            flat_anim_len=a.flat_anim_len,
            tex_pixels=a.tex_pixels,
            tex_w=a.tex_w,
            tex_h=a.tex_h,
            sky_pixels=_sky_pixels(a.tex_pixels, int(a.sky_tex)),
            spr_w=a.spr_w,
            spr_h=a.spr_h,
            spr_top=a.spr_top,
            spr_table=a.spr_table,
            atlas_cm=atlas_cm,
            state_sprite=info.state_sprite,
            state_frame=info.state_frame,
            state_full_bright=info.state_full_bright,
            state_tics=info.state_tics,
            state_next=info.state_next,
            mobj_pos=mobj_pos,
            mobj_angle=t.thing_angle[ids],
            mobj_sector=mobj_sector,
            mobj_spawn_state=info.mobj_spawn[mobj_info_ix],
            mobj_death_state=info.mobj_death[mobj_info_ix],
            mobj_xdeath_state=info.mobj_xdeath[mobj_info_ix],
            dseg_ix=dseg_ix,
            tex_sizes_pow2=bool(
                np.all((a.tex_w & (a.tex_w - 1)) == 0)
                and np.all((a.tex_h & (a.tex_h - 1)) == 0)
            ),
            paint_ok=paint_ok,
            texq_wide=texq_wide,
            atlas_rows=atlas_rows,
            spr_pw=a.spr_pixels.shape[2],
            sky_tex=int(a.sky_tex),
            sky_is_opaque=sky_is_opaque,
            wall_tex_all_opaque=wall_tex_all_opaque,
            itempaint_ok=itempaint_ok,
        )
        return level_from_numpy(arrays, device)


_DTYPES = {
    "seg_v1": _F32, "seg_v2": _F32, "node_xy": _F32, "node_dxy": _F32,
    "seg_two_sided": _BOOL, "seg_unpeg_top": _BOOL, "seg_unpeg_bottom": _BOOL,
    "seg_draw_ceiling": _BOOL, "seg_sky_hack": _BOOL, "flat_is_sky": _BOOL,
    "state_full_bright": _BOOL, "mobj_pos": _F32, "mobj_angle": _F32,
}


def level_from_numpy(fields_: dict, device) -> DeviceLevel:
    """The port's level from numpy arrays keyed by field name.

    Takes the JAX DeviceLevel's fields (`np.asarray` of each, plus its
    static fields as Python values) or the port's own build; fields the
    port does not use are ignored, `sky_pixels` is derived from
    `tex_pixels`/`sky_tex` and `spr_pw` from `spr_pixels` when absent.
    Every tensor is moved to `device` with the port's dtype."""
    kw = {}
    for name in DeviceLevel.tensor_fields():
        if name == "sky_pixels" and name not in fields_:
            arr = _sky_pixels(fields_["tex_pixels"], int(fields_["sky_tex"]))
        else:
            arr = np.asarray(fields_[name])
        kw[name] = torch.as_tensor(
            np.array(arr, order="C"), dtype=_DTYPES.get(name, _I32)
        ).to(device)
    for name in DeviceLevel.STATIC_FIELDS:
        if name == "spr_pw" and name not in fields_:
            kw[name] = int(np.shape(fields_["spr_pixels"])[2])
        else:
            kw[name] = type(getattr(DeviceLevel, name))(fields_[name])
    return DeviceLevel(**kw)
