"""The scalar NumPy renderer: an independent witness of every frame.

A loop-based transcription of the upstream renderer's algorithm and
arithmetic (freewilll/doom-rust-renderer; f32 operations, `as i16`
truncation, Rust `%` semantics), one camera and one frame at a time,
with the upstream file:line each stage models.  It shares no code path
with the batched reference (portbench/reference/render) or with the
program: it walks the BSP front to back, draws solid walls, collects
visplanes and defers two-sided mids, draws the visplanes, then sprites
interleaved with the deferred segs in painter's order, then the segs
left.  It is slow (seconds a 320x200 frame), so the check draws a few
frames of its sample with it (check.SPEC_FRAMES).

Stages (renderer/mod.rs:118-136):
  1. front-to-back BSP walk drawing solid walls, collecting visplanes and
     deferring two-sided mids
  2. visplane (floor/ceiling/sky) drawing
  3. sprites interleaved with deferred two-sided segs, painter's order
  4. flush of still-undrawn two-sided segs
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from portbench.reference.assets.bundle import LevelAssets
from portbench.reference.config import (
    ASPECT_RATIO_CORRECTION,
    FLAT_SIZE,
    PLAYER_EYE_HEIGHT,
    SKY_TEXTURE_HEIGHT,
    SKY_TEXTURE_WIDTH,
    RenderConfig,
)
from portbench.reference.info.tables import InfoTables
from portbench.reference.level.tables import NODE_IS_SUBSECTOR, MapTables

F32 = np.float32

# linedef flags (map/linedefs.rs:9-19)
TWOSIDED = 4
DONTPEGTOP = 8
DONTPEGBOTTOM = 16


def f32(x) -> np.float32:
    return np.float32(x)


def as_i16(x) -> int:
    """Rust `as i16`: trunc toward zero, saturating (NaN -> 0)."""
    x = float(x)
    if math.isnan(x):
        return 0
    if x >= 32767.0:
        return 32767
    if x <= -32768.0:
        return -32768
    return int(math.trunc(x))


def as_i32(x) -> int:
    x = float(x)
    if math.isnan(x):
        return 0
    if x >= 2**31 - 1:
        return 2**31 - 1
    if x <= -(2**31):
        return -(2**31)
    return int(math.trunc(x))


def as_u8(x) -> int:
    """Rust `as u8`: trunc toward zero, saturating to [0, 255] (NaN -> 0).

    diminish_color (bitmap_render.rs:204-207) relies on this: on the
    exact horizon row the inverse plane projection divides by vy == 0,
    the i16-saturated distance can go negative and the light factor
    exceeds 1 — Rust saturates the final u8 cast instead of wrapping.
    """
    x = float(x)
    if math.isnan(x):
        return 0
    if x >= 255.0:
        return 255
    if x <= 0.0:
        return 0
    return int(math.trunc(x))


def wrap_tex(t: int, size: int) -> int:
    """bitmap_render.rs:244-248 wrap idiom with Rust trunc division."""
    if t < 0:
        t += size * (1 - int(math.trunc(t / size)))
    return int(math.fmod(t, size))


@dataclass
class Player:
    x: float
    y: float
    angle: float
    floor_height: float = 0.0


def rotate(x: F32, y: F32, angle: F32) -> tuple[F32, F32]:
    """map/vertexes.rs:20-25 (f32 trig).

    Callers may pass ±inf/NaN coordinates (visplane inverse projection on
    the exact horizon row, visplanes.rs:112-114 — wz/vy with vy == 0); the
    resulting NumPy "invalid value" RuntimeWarning is expected: Rust f32
    propagates inf/NaN identically (IEEE 754) and the downstream `as i16`
    saturating cast (as_i16 here, Rust's semantics: NaN -> 0, ±inf ->
    i16::MIN/MAX) makes the final pixels match the reference bit-for-bit.
    np.errstate silences the expected "invalid value" warning without
    changing IEEE results.
    """
    c, s = f32(np.cos(f32(angle))), f32(np.sin(f32(angle)))
    with np.errstate(invalid="ignore"):
        return f32(x * c - y * s), f32(y * c + x * s)


def cross(ax, ay, bx, by) -> F32:
    return f32(ax * by - ay * bx)


def is_left_of(px, py, sx, sy, ex, ey) -> bool:
    """vertexes.rs:32-34: cross(p - s, e - s) <= 0."""
    return cross(f32(px - sx), f32(py - sy), f32(ex - sx), f32(ey - sy)) <= 0.0


def line_intersection(x1, y1, x2, y2, x3, y3, x4, y4):
    """geometry.rs:56-82; returns None when |quot| < 0.001 (parallel)."""
    x1, y1, x2, y2 = f32(x1), f32(y1), f32(x2), f32(y2)
    x3, y3, x4, y4 = f32(x3), f32(y3), f32(x4), f32(y4)
    quot = f32((x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4))
    if abs(quot) < 0.001:
        return None
    inv = f32(1.0) / quot
    px = f32(inv * ((x1 * y2 - y1 * x2) * (x3 - x4) - (x1 - x2) * (x3 * y4 - y3 * x4)))
    py = f32(inv * ((x1 * y2 - y1 * x2) * (y3 - y4) - (y1 - y2) * (x3 * y4 - y3 * x4)))
    return px, py


def clip_to_viewport(sx, sy, ex, ey):
    """misc.rs:13-115.  Returns (sx, sy, ex, ey, start_offset) or None.

    Clips a view-space line against the 45-degree frustum edges
    y = x (left) and y = -x (right); start_offset is the world-space
    length clipped off the start (for texture alignment).
    """
    sx, sy, ex, ey = f32(sx), f32(sy), f32(ex), f32(ey)
    # frustum edge lines through the origin
    L = (f32(0), f32(0), f32(1), f32(1))
    R = (f32(0), f32(0), f32(1), f32(-1))

    start_outside_left = is_left_of(sx, sy, *L)
    end_outside_left = is_left_of(ex, ey, *L)
    start_outside_right = not is_left_of(sx, sy, *R)
    end_outside_right = not is_left_of(ex, ey, *R)

    start_in = sx > 0.0 and not start_outside_left and not start_outside_right
    end_in = ex > 0.0 and not end_outside_left and not end_outside_right

    if start_in and end_in:
        return sx, sy, ex, ey, f32(0.0)

    li = line_intersection(sx, sy, ex, ey, *L)
    ri = line_intersection(sx, sy, ex, ey, *R)
    left_intersected = li is not None and li[0] >= 0.0
    right_intersected = ri is not None and ri[0] >= 0.0

    if not start_in and not end_in and not left_intersected and not right_intersected:
        return None
    if not start_in and not end_in and (left_intersected != right_intersected):
        return None
    if (right_intersected and start_outside_right and end_outside_right) or (
        left_intersected and start_outside_left and end_outside_left
    ):
        return None

    start_offset = f32(0.0)
    nsx, nsy, nex, ney = sx, sy, ex, ey
    if left_intersected:
        if start_outside_left:
            start_offset = f32(
                np.sqrt(f32(f32(li[0] - sx) ** 2 + f32(li[1] - sy) ** 2))
            )
            nsx, nsy = li
        if end_outside_left:
            nex, ney = li
    if right_intersected:
        if start_outside_right:
            nsx, nsy = ri
        if end_outside_right:
            nex, ney = ri
    return nsx, nsy, nex, ney, start_offset


@dataclass
class SpecConfig:
    cfg: RenderConfig

    @property
    def W(self):
        return self.cfg.width

    @property
    def H(self):
        return self.cfg.height


# BitmapRender states (bitmap_render.rs:12-17)
SOLID_SEG = 0
TWO_SIDED_SEG = 1
DRAWN_SEG = 2
MAP_OBJECT = 3


@dataclass
class BitmapRender:
    """Deferred-draw record (bitmap_render.rs:29-46)."""

    state: int
    texture: int  # atlas id; -1 = none
    is_sprite_tex: bool
    light_level: int
    # clipped line, view space
    lsx: F32
    lsy: F32
    lex: F32
    ley: F32
    start_offset: F32
    start_x: int
    end_x: int
    bottom_height: F32
    top_height: F32
    offset_x: int
    offset_y: int
    extends_to_bottom: bool
    extends_to_top: bool
    draw_ceiling: bool
    columns: list = field(default_factory=list)  # (x, ct, cb, by, ty)

    def is_behind_vertex(self, vx: F32, vy: F32) -> bool:
        """bitmap_render.rs:137-165."""
        min_x = min(self.lsx, self.lex)
        max_x = max(self.lsx, self.lex)
        if min_x > vx:
            return True
        if max_x > vx and not is_left_of(vx, vy, self.lsx, self.lsy, self.lex, self.ley):
            return True
        return False


@dataclass
class Visplane:
    """visplanes.rs:17-38."""

    flat: int  # flat atlas id
    height: int
    light_level: int
    left: int
    right: int
    top: np.ndarray
    bottom: np.ndarray


class SpecRenderer:
    """One frame, one camera.  Mirrors renderer/mod.rs + segs.rs."""

    def __init__(
        self,
        tables: MapTables,
        assets: LevelAssets,
        info: InfoTables,
        config: RenderConfig,
        reciprocal_constants: bool = False,
    ):
        self.reciprocal_constants = reciprocal_constants
        self.t = tables
        self.a = assets
        self.info = info
        self.cfg = config
        self.W = config.width
        self.H = config.height
        self.FOCUS_X = f32(config.camera_focus_x)
        self.FOCUS_Y = f32(config.camera_focus_y)
        self.GAME_FOCUS = f32(config.game_camera_focus_x)

    # ------------------------------------------------------------------
    def render(
        self,
        player: Player,
        sector_light: np.ndarray | None = None,
        sector_floor_h: np.ndarray | None = None,
        sector_ceil_h: np.ndarray | None = None,
        mobj_pos: np.ndarray | None = None,
        mobj_angle: np.ndarray | None = None,
        mobj_state: np.ndarray | None = None,
        timestamp: float = 0.0,
    ) -> dict:
        t = self.t
        self.player = player
        self.timestamp = timestamp
        self.sector_light = (
            sector_light if sector_light is not None else t.sector_light
        )
        self.sector_floor_h = (
            sector_floor_h if sector_floor_h is not None else t.sector_floor_h
        )
        self.sector_ceil_h = (
            sector_ceil_h if sector_ceil_h is not None else t.sector_ceil_h
        )
        self.mobj_pos = mobj_pos
        self.mobj_angle = mobj_angle
        self.mobj_state = mobj_state

        W, H = self.W, self.H
        self.rgb = np.zeros((H, W, 3), dtype=np.uint8)
        self.idx = np.full((H, W), -1, dtype=np.int32)  # palette-index plane
        self.hor_ocl = np.zeros(W, dtype=bool)
        self.floor_ocl = np.full(W, H, dtype=np.int64)
        self.ceil_ocl = np.full(W, -1, dtype=np.int64)
        self.visplanes: list[Visplane] = []
        self.segs: list[BitmapRender] = []

        self._render_node(t.root_node)
        self._draw_visplanes()
        self.segs.reverse()  # back to front (mod.rs:124)
        self._draw_map_objects()
        for seg in self.segs:  # draw_remaining_segs (segs.rs:593-597)
            self._render_bitmap(seg)

        return {"rgb": self.rgb, "idx": self.idx}

    # -- BSP walk (mod.rs:69-104) ----------------------------------------
    def _render_node(self, node: int) -> None:
        t = self.t
        sx, sy = t.node_xy[node]
        dx, dy = t.node_dxy[node]
        is_left = is_left_of(
            f32(self.player.x), f32(self.player.y), f32(sx), f32(sy),
            f32(sx + dx), f32(sy + dy),
        )
        order = (1, 0) if is_left else (0, 1)  # front child first
        for side in order:
            child = int(t.node_child[node, side]) & 0xFFFF
            if child & NODE_IS_SUBSECTOR:
                ss = child & (NODE_IS_SUBSECTOR - 1)
                for g in range(t.sub_first[ss], t.sub_first[ss] + t.sub_nseg[ss]):
                    self._process_seg(g)
            else:
                self._render_node(child)

    # -- flats ---------------------------------------------------------------
    def _animated_flat(self, flat_id: int) -> int:
        """flats.rs:103-111: cycle 3 times a second."""
        base = int(self.a.flat_anim_base[flat_id])
        n = int(self.a.flat_anim_len[flat_id])
        if n == 1:
            return flat_id
        return base + int(self.timestamp * 3.0) % n

    # -- seg processing (segs.rs:353-590) -------------------------------------
    def _process_seg(self, g: int) -> None:
        t = self.t
        line = t.seg_line[g]
        direction = t.seg_dir[g]
        front_side = t.line_sides[line, direction]
        back_side = t.line_sides[line, 1 - direction]
        if front_side < 0:
            return
        front_sector = t.side_sector[front_side]

        floor_height = f32(self.sector_floor_h[front_sector])
        ceiling_height = f32(self.sector_ceil_h[front_sector])

        portal_bottom = None
        portal_top = None
        if back_side >= 0:
            back_sector = t.side_sector[back_side]
            if self.sector_floor_h[back_sector] > self.sector_floor_h[front_sector]:
                portal_bottom = f32(self.sector_floor_h[back_sector])
            if self.sector_ceil_h[back_sector] < self.sector_ceil_h[front_sector]:
                portal_top = f32(self.sector_ceil_h[back_sector])

        flags = int(t.line_flags[line])
        is_two_sided = bool(flags & TWOSIDED)
        top_unpegged = bool(flags & DONTPEGTOP)
        bottom_unpegged = bool(flags & DONTPEGBOTTOM)

        v1 = t.vertexes[t.seg_v[g, 0]]
        v2 = t.vertexes[t.seg_v[g, 1]]
        msx, msy = f32(v1[0] - self.player.x), f32(v1[1] - self.player.y)
        mex, mey = f32(v2[0] - self.player.x), f32(v2[1] - self.player.y)
        ssx, ssy = rotate(msx, msy, f32(-self.player.angle))
        sex, sey = rotate(mex, mey, f32(-self.player.angle))

        clipped = clip_to_viewport(ssx, ssy, sex, sey)
        if clipped is None:
            return
        lsx, lsy, lex, ley, start_offset = clipped
        assert lsx >= -0.01, f"Clipped line x < -0.01: {lsx}"

        player_height = f32(self.player.floor_height + PLAYER_EYE_HEIGHT)

        # back-face check on one projected line (segs.rs:491-498... 446-448)
        fl = self._project(lsx, lsy, lex, ley, f32(floor_height - player_height))
        if fl[0][0] > fl[1][0]:
            return

        floor_flat = self._animated_flat(
            int(self.a.sector_floor_flat[front_sector])
        )
        ceiling_flat = self._animated_flat(
            int(self.a.sector_ceil_flat[front_sector])
        )

        draw_ceiling = True
        # sky hack (segs.rs:459-477)
        if back_side >= 0:
            back_sector = t.side_sector[back_side]
            if (
                "SKY" in t.sector_ceil_flat[front_sector]
                and "SKY" in t.sector_ceil_flat[back_sector]
            ):
                portal_top = None
                ceiling_height = f32(
                    min(f32(self.sector_ceil_h[back_sector]), ceiling_height)
                )
                draw_ceiling = False

        sds = dict(
            lsx=lsx, lsy=lsy, lex=lex, ley=ley, start_offset=start_offset,
            sidedef=front_side,
            offset_x=int(t.seg_offset[g]),
            floor_height=int(self.sector_floor_h[front_sector]),
            ceiling_height=int(self.sector_ceil_h[front_sector]),
            floor_flat=floor_flat, ceiling_flat=ceiling_flat,
            light_level=int(self.sector_light[front_sector]),
            player_height=player_height,
        )

        mid_tex = int(self.a.side_middle_tex[front_side])
        low_tex = int(self.a.side_lower_tex[front_side])
        up_tex = int(self.a.side_upper_tex[front_side])

        if not is_two_sided:
            offset_y = (
                as_i32(floor_height - ceiling_height) if bottom_unpegged else 0
            )
            self._process_sidedef(
                sds, f32(floor_height - player_height),
                f32(ceiling_height - player_height), offset_y, mid_tex,
                only_occl=False, lower=False, upper=False,
                draw_ceiling=draw_ceiling, two_sided_mid=False,
            )
        else:
            # full-height occlusion pass (segs.rs:516-523)
            self._process_sidedef(
                sds, f32(floor_height - player_height),
                f32(ceiling_height - player_height), 0, mid_tex,
                only_occl=True, lower=False, upper=False,
                draw_ceiling=draw_ceiling, two_sided_mid=False,
            )
            # the deferred two-sided middle (segs.rs:527-548)
            mid_floor = portal_bottom if portal_bottom is not None else floor_height
            mid_ceil = portal_top if portal_top is not None else ceiling_height
            self._process_sidedef(
                sds, f32(mid_floor - player_height),
                f32(mid_ceil - player_height), 0, mid_tex,
                only_occl=False, lower=False, upper=False,
                draw_ceiling=draw_ceiling, two_sided_mid=True,
            )
            # lower wall (segs.rs:551-567)
            if portal_bottom is not None:
                offset_y = (
                    as_i32(ceiling_height - portal_bottom)
                    if bottom_unpegged else 0
                )
                self._process_sidedef(
                    sds, f32(floor_height - player_height),
                    f32(portal_bottom - player_height), offset_y, low_tex,
                    only_occl=False, lower=True, upper=False,
                    draw_ceiling=draw_ceiling, two_sided_mid=False,
                )
            # upper wall (segs.rs:570-587)
            if portal_top is not None:
                offset_y = (
                    0 if top_unpegged else as_i32(portal_top - ceiling_height)
                )
                self._process_sidedef(
                    sds, f32(portal_top - player_height),
                    f32(ceiling_height - player_height), offset_y, up_tex,
                    only_occl=False, lower=False, upper=True,
                    draw_ceiling=draw_ceiling, two_sided_mid=False,
                )

    # -- projection (misc.rs:130-161) -----------------------------------------
    def _project(self, lsx, lsy, lex, ley, height):
        """make_sidedef_non_vertical_line: two screen points (x, y) i32.

        vx == 0.0 divides by zero here; this matches the reference exactly:
        Rust f32 division by zero is IEEE-defined (±inf, or NaN for 0/0,
        misc.rs:130-135) and the following `as i32` saturates (inf ->
        i32::MAX, NaN -> 0), which as_i32 reproduces.  np.errstate silences
        the expected RuntimeWarnings without changing the IEEE results.
        """
        pts = []
        for (vx, vy) in ((lsx, lsy), (lex, ley)):
            # weak perspective: x = v.y, z = v.x
            with np.errstate(divide="ignore", invalid="ignore"):
                tx = f32(self.GAME_FOCUS * f32(vy) / f32(vx))
                ty = f32(self.GAME_FOCUS * f32(height) / f32(vx))
            tx = f32(tx * f32(ASPECT_RATIO_CORRECTION))
            px = as_i32(f32(self.FOCUS_X - tx))
            py = as_i32(f32(self.FOCUS_Y - ty))
            px = min(px, self.W - 1)
            pts.append((px, py))
        return pts

    # -- the per-column engine (segs.rs:121-350) --------------------------------
    def _process_sidedef(
        self, sds, bottom_height, top_height, offset_y, texture,
        only_occl, lower, upper, draw_ceiling, two_sided_mid,
    ) -> None:
        H, W = self.H, self.W
        (bsx, bsy), (bex, bey) = self._project(
            sds["lsx"], sds["lsy"], sds["lex"], sds["ley"], bottom_height
        )
        (tsx, tsy), (tex_, tey) = self._project(
            sds["lsx"], sds["lsy"], sds["lex"], sds["ley"], top_height
        )
        assert bsx == tsx and bex == tex_, "Wall start not vertical"

        # side-on view (segs.rs:151-155)
        if as_i16(bsx) == as_i16(bex) or as_i16(tsx) == as_i16(tex_):
            return

        assert 0 <= bsx < W and 0 <= bex < W, f"Invalid line x {bsx} {bex}"

        bottom_delta = f32(f32(bsy - bey) / f32(bsx - bex))
        top_delta = f32(f32(tsy - tey) / f32(tsx - tex_))

        is_full_height = not lower and not upper and not only_occl

        t = self.t
        side_off = t.side_offset[sds["sidedef"]]
        offset_x_total = as_i16(side_off[0]) + sds["offset_x"]
        offset_y_total = as_i16(side_off[1]) + as_i16(offset_y)

        br = BitmapRender(
            state=TWO_SIDED_SEG if two_sided_mid else SOLID_SEG,
            texture=texture, is_sprite_tex=False,
            light_level=sds["light_level"],
            lsx=sds["lsx"], lsy=sds["lsy"], lex=sds["lex"], ley=sds["ley"],
            start_offset=sds["start_offset"],
            start_x=bsx, end_x=bex,
            bottom_height=bottom_height, top_height=top_height,
            offset_x=offset_x_total, offset_y=offset_y_total,
            extends_to_bottom=lower or (not two_sided_mid and is_full_height),
            extends_to_top=upper or (not two_sided_mid and is_full_height),
            draw_ceiling=draw_ceiling,
        )

        # per-sidedef growing visplane pair (sidedef_visplanes.rs)
        vp_state = {
            "bottom": None, "top": None,
        }

        def new_plane(which):
            return Visplane(
                flat=sds["floor_flat"] if which == "bottom" else sds["ceiling_flat"],
                height=sds["floor_height"] if which == "bottom" else sds["ceiling_height"],
                light_level=sds["light_level"],
                left=-1, right=-1,
                top=np.zeros(W, dtype=np.int64),
                bottom=np.zeros(W, dtype=np.int64),
            )

        def add_point(which, x, top_y, bottom_y):
            if vp_state[which] is None:
                vp_state[which] = new_plane(which)
                vp_state[which].left = x
            vp_state[which].right = x
            vp_state[which].top[x] = top_y
            vp_state[which].bottom[x] = bottom_y

        def flush():
            for which in ("bottom", "top"):
                if vp_state[which] is not None:
                    self.visplanes.append(vp_state[which])
                    vp_state[which] = None

        for x in range(as_i16(bsx), as_i16(bex) + 1):
            if not self.hor_ocl[x]:
                bottom_y = as_i16(f32(bsy) + f32(x - bsx) * bottom_delta)
                top_y = as_i16(f32(tsy) + f32(x - tsx) * top_delta)

                floor_ocl = int(self.floor_ocl[x])
                ceil_ocl = int(self.ceil_ocl[x])

                clipped_bottom = min(floor_ocl, bottom_y)
                clipped_top = max(ceil_ocl, top_y)
                clipped_bottom = min(H - 1, clipped_bottom)
                clipped_top = max(0, clipped_top)

                in_ver = clipped_bottom >= clipped_top

                if in_ver:
                    if not two_sided_mid and not only_occl and texture >= 0:
                        self._draw_wall_column(
                            br, x, clipped_bottom, clipped_top, bottom_y, top_y
                        )
                    br.columns.append(
                        (x, clipped_top, clipped_bottom, bottom_y, top_y)
                    )

                if not two_sided_mid and in_ver and (is_full_height or only_occl):
                    visplane_added = False
                    if clipped_bottom < floor_ocl and clipped_bottom != H - 1:
                        add_point("bottom", x, clipped_bottom, floor_ocl)
                        visplane_added = True
                    if (
                        not two_sided_mid and draw_ceiling
                        and clipped_top > ceil_ocl and clipped_top != -1
                    ):
                        add_point("top", x, ceil_ocl, clipped_top)
                        visplane_added = True
                    if not visplane_added:
                        flush()
                elif (
                    not two_sided_mid and not in_ver
                    and (is_full_height or only_occl)
                    and floor_ocl > ceil_ocl
                ):
                    # occluded, but an unoccluded vertical gap remains
                    # (segs.rs:293-318)
                    if bottom_y <= ceil_ocl:
                        add_point("bottom", x, ceil_ocl, floor_ocl)
                        self._occlude_column(x)
                    if draw_ceiling and top_y >= floor_ocl:
                        add_point("top", x, ceil_ocl, floor_ocl)
                        self._occlude_column(x)

                if not two_sided_mid and in_ver and only_occl:
                    self.floor_ocl[x] = clipped_bottom
                    if draw_ceiling:
                        self.ceil_ocl[x] = clipped_top
                if not two_sided_mid and in_ver and lower:
                    self.floor_ocl[x] = clipped_top
                if not two_sided_mid and in_ver and upper:
                    self.ceil_ocl[x] = clipped_bottom
            else:
                flush()

            if not two_sided_mid and is_full_height:
                self._occlude_column(x)

        flush()
        self.segs.append(br)

    def _occlude_column(self, x: int) -> None:
        """segs.rs:113-117."""
        self.hor_ocl[x] = True
        self.floor_ocl[x] = self.H // 2
        self.ceil_ocl[x] = self.H // 2

    def _cdiv(self, a, c) -> F32:
        """f32 a / c for a constant c.  The upstream renderer divides
        (IEEE, correctly rounded); with `reciprocal_constants`, a is
        multiplied by f32(1) / f32(c) instead, as XLA rewrites a
        division by a compile-time constant: the JAX package's and so
        the port's arithmetic (one ulp off at times, e.g. (160 - 301) /
        f32(200 / 240) gives -169.20001, not -169.2)."""
        if self.reciprocal_constants:
            return f32(f32(a) * f32(f32(1.0) / f32(c)))
        return f32(f32(a) / f32(c))

    # -- pixel writes ------------------------------------------------------------
    def _diminish(self, pal_idx: int, light_level: int, distance: int):
        """bitmap_render.rs:190-208."""
        factor = self._cdiv(f32(light_level), 255.0)
        factor = f32(factor - f32(distance) * f32(1.0 / (16.0 * 256.0)))
        if factor < 0.0:
            factor = f32(0.0)
        col = self.a.palette[pal_idx]
        return (
            as_u8(f32(col[0]) * factor),
            as_u8(f32(col[1]) * factor),
            as_u8(f32(col[2]) * factor),
        )

    def _set(self, x: int, y: int, rgb, pal_idx: int) -> None:
        """pixels.rs:22-31 (bounds semantics, y==H excluded to stay safe)."""
        if x >= self.W or y >= self.H or x < 0 or y < 0:
            return
        self.rgb[y, x] = rgb
        self.idx[y, x] = pal_idx

    # -- wall column texturing (bitmap_render.rs:213-276) -------------------------
    def _tex_lookup(self, br: BitmapRender, ty: int, tx: int):
        """Returns (pal_idx or None)."""
        if br.texture < 0:
            return None
        if br.is_sprite_tex:
            pix = self.a.spr_pixels[br.texture]
            mask = self.a.spr_mask[br.texture]
        else:
            pix = self.a.tex_pixels[br.texture]
            mask = self.a.tex_mask[br.texture]
        if not mask[ty, tx]:
            return None
        return int(pix[ty, tx])

    def _tex_dims(self, br: BitmapRender) -> tuple[int, int]:
        if br.is_sprite_tex:
            return int(self.a.spr_w[br.texture]), int(self.a.spr_h[br.texture])
        return int(self.a.tex_w[br.texture]), int(self.a.tex_h[br.texture])

    def _draw_wall_column(
        self, br: BitmapRender, x, clipped_bottom, clipped_top, bottom_y, top_y
    ) -> None:
        if br.texture < 0:
            return
        tw, th = self._tex_dims(br)
        length = f32(
            np.sqrt(f32(f32(br.lsx - br.lex) ** 2 + f32(br.lsy - br.ley) ** 2))
        )
        ux0, ux1 = f32(0.0), length
        uy1 = f32(br.top_height - br.bottom_height)
        uz0, uz1 = f32(br.lsx), f32(br.lex)

        with np.errstate(divide="ignore", invalid="ignore"):
            ax = f32(f32(x - br.start_x) / f32(br.end_x - br.start_x))
            one = f32(1.0)
            denom = f32(f32(one - ax) * f32(one / uz0) + f32(ax * f32(one / uz1)))
            tx = as_i16(
                f32(
                    f32(f32(one - ax) * f32(ux0 / uz0) + f32(ax * f32(ux1 / uz1)))
                    / denom
                )
            )
            z = as_i16(f32(f32((one - ax) + ax) / denom))
        tx += as_i16(br.start_offset) + br.offset_x
        tx = wrap_tex(tx, tw)

        # bottom_y == top_y divides by zero; IEEE inf/NaN then saturate in
        # as_i16 exactly like Rust's `as i16` (bitmap_render.rs:253-263).
        for y in range(clipped_top, clipped_bottom + 1):
            with np.errstate(divide="ignore", invalid="ignore"):
                ay = f32(f32(y - top_y) / f32(bottom_y - top_y))
                ty = as_i16(f32(f32(th) + f32(one - ay) * f32(0.0) + f32(ay * uy1)))
            ty += br.offset_y
            ty = wrap_tex(ty, th)
            pal_idx = self._tex_lookup(br, ty, tx)
            if pal_idx is not None:
                rgb = self._diminish(pal_idx, br.light_level, z)
                self._set(x, y, rgb, pal_idx)

    def _render_bitmap(self, br: BitmapRender) -> None:
        """BitmapRender::render (bitmap_render.rs:101-135)."""
        if br.state in (SOLID_SEG, DRAWN_SEG):
            return
        if br.texture >= 0:
            for (x, ct, cb, by, ty) in br.columns:
                self._draw_wall_column(br, x, cb, ct, by, ty)
        br.state = DRAWN_SEG

    # -- visplanes (visplanes.rs:82-152) ----------------------------------------
    def _draw_visplanes(self) -> None:
        for vp in self.visplanes:
            if self.a.flat_is_sky[vp.flat]:
                self._draw_sky(vp)
            else:
                self._draw_visplane(vp)

    def _draw_visplane(self, vp: Visplane) -> None:
        H, W = self.H, self.W
        flat = self.a.flat_pixels[vp.flat]
        for x in range(vp.left, vp.right + 1):
            top = max(0, int(vp.top[x]))
            bottom = min(H - 1, int(vp.bottom[x]))
            if bottom - top <= 1:
                continue  # one-pixel visplanes skipped (visplanes.rs:98-101)
            for y in range(top, bottom + 1):
                vx = self._cdiv(f32(self.FOCUS_X - f32(x)), ASPECT_RATIO_CORRECTION)
                vy = f32(self.FOCUS_Y - f32(y))
                wz = f32(
                    f32(vp.height)
                    - f32(self.player.floor_height)
                    - f32(PLAYER_EYE_HEIGHT)
                )
                # vy == 0 on the exact horizon row: inf/NaN propagate just
                # like the reference's f32 math (visplanes.rs:113-114) and
                # die in the saturating as_i16/as_u8 casts below
                with np.errstate(divide="ignore", invalid="ignore"):
                    wx = f32(self.GAME_FOCUS * wz / vy)
                    wy = f32(wz * vx / vy)
                rx, ry = rotate(wx, wy, f32(self.player.angle))
                tx = (as_i16(rx) + as_i16(self.player.x)) & (FLAT_SIZE - 1)
                ty = (as_i16(ry) + as_i16(self.player.y)) & (FLAT_SIZE - 1)
                pal_idx = int(flat[ty, tx])
                rgb = self._diminish(pal_idx, vp.light_level, as_i16(wx))
                self._set(x, y, rgb, pal_idx)

    def _draw_sky(self, vp: Visplane) -> None:
        """visplanes.rs:42-80: no diminishing, angle-scrolled."""
        H, W = self.H, self.W
        sky = self.a.tex_pixels[self.a.sky_tex]
        sky_mask = self.a.tex_mask[self.a.sky_tex]
        stw, sth = SKY_TEXTURE_WIDTH, SKY_TEXTURE_HEIGHT
        tx_offset = as_i16(self._cdiv(
            f32(-f32(stw) * f32(self.player.angle)), math.pi / 2.0)) + stw
        if tx_offset < 0:
            tx_offset += stw * (1 - int(math.trunc(tx_offset / stw)))
        for x in range(vp.left, vp.right + 1):
            top = max(0, int(vp.top[x]))
            bottom = min(H - 1, int(vp.bottom[x]))
            for y in range(top, bottom + 1):
                tx = as_i16(self._cdiv(f32(f32(x) * f32(stw)), W))
                tx = int(math.fmod(tx + tx_offset, stw))
                ty = as_i16(self._cdiv(f32(f32(y) * f32(sth) * f32(2.0)), H))
                if ty < 0:
                    ty += sth
                ty = int(math.fmod(ty, sth))
                if sky_mask[ty, tx]:
                    pal_idx = int(sky[ty, tx])
                    self._set(x, y, tuple(self.a.palette[pal_idx]), pal_idx)

    # -- things (renderer/map_objects.rs:19-241) ----------------------------------
    def _draw_map_objects(self) -> None:
        if self.mobj_pos is None:
            return
        H, W = self.H, self.W
        renders: list[BitmapRender] = []
        for i in range(len(self.mobj_pos)):
            state_id = int(self.mobj_state[i])
            if state_id == 0:  # S_NULL
                continue
            sprite_ix = int(self.info.state_sprite[state_id])
            frame = int(self.info.state_frame[state_id])
            full_bright = bool(self.info.state_full_bright[state_id])

            # rotation selection (:53-67), f32 arithmetic like the reference
            pi = f32(np.float32(math.pi))
            angle = f32(f32(f32(self.player.angle) - f32(self.mobj_angle[i])) - pi)
            angle = f32(angle + f32(pi / f32(16.0)))
            angle = f32(math.fmod(angle, f32(2.0) * pi))
            if angle < 0.0:
                angle = f32(angle + f32(2.0) * pi)
            angle = f32(math.fmod(angle, f32(2.0) * pi))
            rotation = min(255, max(0, int(self._cdiv(f32(angle * f32(8.0)),
                                                      f32(2.0) * pi))))

            pic = int(self.a.spr_table[sprite_ix, frame, rotation])
            if pic < 0:
                continue  # no picture available for this frame

            mx = f32(self.mobj_pos[i][0] - self.player.x)
            my = f32(self.mobj_pos[i][1] - self.player.y)
            vpx, vpy = rotate(mx, my, f32(-self.player.angle))

            width = int(self.a.spr_w[pic])
            sx, sy = vpx, f32(vpy + f32(width) / f32(2.0))
            ex, ey = vpx, f32(vpy - f32(width) / f32(2.0))
            clipped = clip_to_viewport(sx, sy, ex, ey)
            if clipped is None:
                continue
            lsx, lsy, lex, ley, start_offset = clipped
            assert lsx >= -0.01

            sector = self.t.sector_at(
                float(self.mobj_pos[i][0]), float(self.mobj_pos[i][1])
            )
            if sector < 0:
                continue  # thing outside map (:100-104)
            light = 255 if full_bright else int(self.sector_light[sector])

            ph = f32(self.player.floor_height + PLAYER_EYE_HEIGHT)
            z = int(self.sector_floor_h[sector])
            pic_h = int(self.a.spr_h[pic])
            top_off = int(self.a.spr_top[pic])
            # Rust `a += b - c` groups as a + (b - c)
            bottom_height = f32(f32(z) - ph)
            top_height = f32(f32(f32(f32(z) + f32(pic_h)) - f32(1.0)) - ph)
            off_adj = f32(f32(top_off) - f32(pic_h))
            bottom_height = f32(bottom_height + off_adj)
            top_height = f32(top_height + off_adj)

            (bsx, bsy), (bex, bey) = self._project(lsx, lsy, lex, ley, bottom_height)
            (tsx, tsy), (tex_, tey) = self._project(lsx, lsy, lex, ley, top_height)

            # accumulate seg-based clip ranges (:127-166)
            top_seg_clip = np.full(W, -1, dtype=np.int64)
            bottom_seg_clip = np.full(W, H, dtype=np.int64)
            for seg in self.segs:
                if seg.is_behind_vertex(vpx, vpy):
                    continue
                for (cx, ct, cb, by, ty) in seg.columns:
                    if seg.state == SOLID_SEG:
                        if seg.extends_to_bottom:
                            bottom_seg_clip[cx] = min(bottom_seg_clip[cx], ct)
                        if seg.extends_to_top:
                            top_seg_clip[cx] = max(top_seg_clip[cx], cb)
                    elif seg.state == TWO_SIDED_SEG:
                        if seg.draw_ceiling:
                            top_seg_clip[cx] = max(top_seg_clip[cx], ty)
                        bottom_seg_clip[cx] = min(bottom_seg_clip[cx], by)

            br = BitmapRender(
                state=MAP_OBJECT, texture=pic, is_sprite_tex=True,
                light_level=light,
                lsx=lsx, lsy=lsy, lex=lex, ley=ley, start_offset=start_offset,
                start_x=bsx, end_x=bex,
                bottom_height=bottom_height, top_height=top_height,
                offset_x=0, offset_y=0,
                extends_to_bottom=False, extends_to_top=False,
                draw_ceiling=False,
            )

            if bsx != bex:
                bottom_delta = f32(f32(bsy - bey) / f32(bsx - bex))
                top_delta = f32(f32(tsy - tey) / f32(tsx - tex_))
                # end exclusive: prevents texture wrap (:194)
                for x in range(as_i16(bsx), as_i16(bex)):
                    bottom_y = as_i16(f32(bsy) + f32(x - bsx) * bottom_delta)
                    top_y = as_i16(f32(tsy) + f32(x - tsx) * top_delta)
                    ct = max(top_y, int(top_seg_clip[x]))
                    cb = min(bottom_y, int(bottom_seg_clip[x]))
                    ct = max(0, ct)
                    cb = min(H - 1, cb)
                    br.columns.append((x, ct, cb, bottom_y, top_y))
            renders.append(br)

        # back-to-front: stable sort by clipped start x then reverse (:216-217)
        renders = sorted(
            renders, key=lambda r: as_i16(r.lsx)
        )[::-1]

        for br in renders:
            vx = f32(f32(br.lsx + br.lex) / f32(2.0))
            vy = f32(f32(br.lsy + br.ley) / f32(2.0))
            for seg in self.segs:
                if seg.is_behind_vertex(vx, vy):
                    self._render_bitmap(seg)
            self._render_bitmap(br)
