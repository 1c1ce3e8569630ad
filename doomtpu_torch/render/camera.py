"""Camera stage: batched seg transform, FOV clip, projection, BSP order.

Counterpart of doomtpu/render/camera.py: one vectorized pass over all
segs for all cameras [B, G], and the front-to-back BSP walk as a
rank-and-argsort.  The frame dict keeps the JAX version's keys and
dtypes.  Index results (argsort, arange) are cast to int32.
"""

from __future__ import annotations

import torch

from doomtpu_torch.config import (
    ASPECT_RATIO_CORRECTION, PLAYER_EYE_HEIGHT, RenderConfig,
)
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    NCOS, NSIN, I32, as_i16, as_i32, camera_trig, f32, fdiv, is_left_of,
    rotate_cs, smul, sqrt,
)
from doomtpu_torch.trace import spanned


# ---------------------------------------------------------------------------
# BSP traversal order
# ---------------------------------------------------------------------------

def node_side_is_left(level: DeviceLevel, px, py):
    """[B, N] is_left bit per node partition (mod.rs:74-85)."""
    sx, sy = level.node_xy[:, 0], level.node_xy[:, 1]
    dx, dy = level.node_dxy[:, 0], level.node_dxy[:, 1]
    return is_left_of(
        px[:, None], py[:, None], sx[None], sy[None],
        (sx + dx)[None], (sy + dy)[None],
    )


@spanned("doom.camera")
def traversal_rank(level: DeviceLevel, px, py):
    """Front-to-back rank of each subsector: [B, SS] i32 for BSP depth
    <= 31, else a lexicographic (hi, lo) pair covering depth <= 62.
    Bit d (MSB-first along the path) is 1 where the path takes the
    node's back child."""
    is_left = node_side_is_left(level, px, py)            # [B, N]
    path_nodes = level.sub_path_nodes.long()              # [SS, D]
    depth = level.sub_depth                               # [SS]
    D = path_nodes.shape[1]

    side_at = is_left[:, path_nodes]                      # [B, SS, D]
    bits = (level.sub_path_left[None] != side_at.to(I32)).to(I32)
    d_ix = torch.arange(D, dtype=I32, device=px.device)
    bits = torch.where(d_ix[None, None] < depth[None, :, None], bits, 0)
    if D <= 31:
        weights = (1 << (D - 1 - d_ix)).to(I32)
        return (bits * weights[None, None]).sum(-1, dtype=I32)
    if D > 62:
        raise NotImplementedError(
            f"BSP depth {D} > 62: widen traversal_rank to a third word"
        )
    w_hi = torch.where(d_ix < 31, 1 << (30 - torch.clamp(d_ix, max=30)), 0)
    w_lo = torch.where(d_ix >= 31, 1 << (61 - torch.clamp(d_ix, min=31)), 0)
    hi = (bits * w_hi.to(I32)[None, None]).sum(-1, dtype=I32)
    lo = (bits * w_lo.to(I32)[None, None]).sum(-1, dtype=I32)
    return hi, lo


@spanned("doom.camera")
def seg_order(level: DeviceLevel, rank):
    """[B, G] i32 seg indices in front-to-back draw order: a stable
    argsort on the subsector rank, so segs of one subsector keep
    ascending index order, as the recursion visits them."""
    sub = level.seg_sub.long()
    if isinstance(rank, tuple):
        hi, lo = rank
        perm = torch.argsort(lo[:, sub], dim=1, stable=True)
        hi_p = torch.gather(hi[:, sub], 1, perm)
        perm2 = torch.argsort(hi_p, dim=1, stable=True)
        return torch.gather(perm, 1, perm2).to(I32)
    return torch.argsort(rank[:, sub], dim=1, stable=True).to(I32)


def order_matches_rank(level: DeviceLevel, rank, order) -> torch.Tensor:
    """[B] bool: is `order` exactly what seg_order(level, rank) gives?
    True where, along `order`, the seg rank never falls and seg indices
    ascend within equal ranks: the defining property of the stable
    rank-argsort, checked with one gather and compares (no argsort).  A
    camera that crossed a BSP partition since `order` was taken fails.
    A (hi, lo) rank compares lexicographically, as seg_order sorts."""
    sub = level.seg_sub.long()
    o = order.long()
    if isinstance(rank, tuple):
        hi, lo = rank
        rh = torch.gather(hi[:, sub], 1, o)
        rl = torch.gather(lo[:, sub], 1, o)
        lt = (rh[:, :-1] < rh[:, 1:]) | (
            (rh[:, :-1] == rh[:, 1:]) & (rl[:, :-1] < rl[:, 1:]))
        eq = (rh[:, :-1] == rh[:, 1:]) & (rl[:, :-1] == rl[:, 1:])
    else:
        r = torch.gather(rank[:, sub], 1, o)
        lt = r[:, :-1] < r[:, 1:]
        eq = r[:, :-1] == r[:, 1:]
    return (lt | (eq & (order[:, :-1] < order[:, 1:]))).all(dim=1)


# ---------------------------------------------------------------------------
# FOV clip (misc.rs:13-115), vectorized
# ---------------------------------------------------------------------------

def clip_to_viewport(sx, sy, ex, ey):
    """Returns (ok, nsx, nsy, nex, ney, start_offset), all batched.
    The frustum edges are y = x (left) and y = -x (right)."""
    sx, sy, ex, ey = f32(sx), f32(sy), f32(ex), f32(ey)
    zero = torch.zeros_like(sx)

    s_out_l = (sx * 1.0 - sy * 1.0) <= 0.0
    e_out_l = (ex * 1.0 - ey * 1.0) <= 0.0
    s_out_r = ~((sx * -1.0 - sy * 1.0) <= 0.0)
    e_out_r = ~((ex * -1.0 - ey * 1.0) <= 0.0)

    s_in = (sx > 0.0) & ~s_out_l & ~s_out_r
    e_in = (ex > 0.0) & ~e_out_l & ~e_out_r

    # line-line intersection (geometry.rs:56-82) with the edge lines
    d = smul(sx, ey) - smul(sy, ex)
    dx12, dy12 = sx - ex, sy - ey
    quot_l = dx12 * -1.0 - dy12 * -1.0
    quot_r = dx12 * 1.0 - dy12 * -1.0
    ok_l = torch.abs(quot_l) >= 0.001
    ok_r = torch.abs(quot_r) >= 0.001
    inv_l = fdiv(1.0, quot_l)
    inv_r = fdiv(1.0, quot_r)
    lix = inv_l * (d * -1.0 - dx12 * 0.0)
    liy = inv_l * (d * -1.0 - dy12 * 0.0)
    rix = inv_r * (d * -1.0 - dx12 * 0.0)
    riy = inv_r * (d * 1.0 - dy12 * 0.0)

    l_hit = ok_l & (lix >= 0.0)
    r_hit = ok_r & (rix >= 0.0)

    reject = (
        (~s_in & ~e_in & ~l_hit & ~r_hit)
        | (~s_in & ~e_in & (l_hit != r_hit))
        | (r_hit & s_out_r & e_out_r)
        | (l_hit & s_out_l & e_out_l)
    )
    fully_in = s_in & e_in
    ok = fully_in | ~reject

    # apply clips (left first, then right — misc.rs:85-112)
    clip_s_l = l_hit & s_out_l & ~fully_in
    clip_e_l = l_hit & e_out_l & ~fully_in
    clip_s_r = r_hit & s_out_r & ~fully_in
    clip_e_r = r_hit & e_out_r & ~fully_in

    start_offset = torch.where(
        clip_s_l,
        sqrt(smul(lix - sx, lix - sx) + smul(liy - sy, liy - sy)),
        zero,
    )
    nsx = torch.where(clip_s_r, rix, torch.where(clip_s_l, lix, sx))
    nsy = torch.where(clip_s_r, riy, torch.where(clip_s_l, liy, sy))
    nex = torch.where(clip_e_r, rix, torch.where(clip_e_l, lix, ex))
    ney = torch.where(clip_e_r, riy, torch.where(clip_e_l, liy, ey))
    return ok, nsx, nsy, nex, ney, start_offset


# ---------------------------------------------------------------------------
# Projection (misc.rs:130-161)
# ---------------------------------------------------------------------------

def project_x(cfg: RenderConfig, vx, vy):
    """Screen x (i32) of a view-space vertex; clamped to W-1 above."""
    tx = fdiv(f32(vy) * float(f32(cfg.game_camera_focus_x)), f32(vx))
    tx = smul(tx, ASPECT_RATIO_CORRECTION)
    px = as_i32(float(f32(cfg.camera_focus_x)) - tx)
    return torch.clamp(px, max=cfg.width - 1)


def project_y(cfg: RenderConfig, vx, height):
    """Screen y (i32) of a view-space vertex at a given world height."""
    ty = fdiv(f32(height) * float(f32(cfg.game_camera_focus_x)), f32(vx))
    return as_i32(float(f32(cfg.camera_focus_y)) - ty)


# ---------------------------------------------------------------------------
# Seg frame assembly
# ---------------------------------------------------------------------------

def animated_flat(level: DeviceLevel, flat_id, timestamp):
    """flats.rs:103-111 as pure indexing; timestamp broadcasts per camera."""
    fl = flat_id.long()
    base = level.flat_anim_base[fl]
    n = level.flat_anim_len[fl]
    cycle = torch.remainder((f32(timestamp) * 3.0).to(I32), n)
    return torch.where(n > 1, base + cycle, flat_id)


@spanned("doom.camera")
def build_seg_frame(
    level: DeviceLevel,
    cfg: RenderConfig,
    px, py, angle, floor_height,       # player state, each [B]
    sector_light,                      # [B, SEC]
    timestamp,                         # [B]
    trig=None,                         # the angles' trig bundle
):
    """All per-(camera, seg) quantities the paint stage needs: a dict of
    [B, G] / [B, G, 4] tensors in ORIGINAL seg index order.  Mirrors
    process_seg (segs.rs:353-489).  The view transform's trig comes from
    `trig` (jmath.camera_trig's rows), else from a round trip here."""
    B = px.shape[0]
    G = level.num_segs

    # --- view transform --------------------------------------------------
    v1x = level.seg_v1[None, :, 0] - px[:, None]
    v1y = level.seg_v1[None, :, 1] - py[:, None]
    v2x = level.seg_v2[None, :, 0] - px[:, None]
    v2y = level.seg_v2[None, :, 1] - py[:, None]
    if trig is None:
        trig = camera_trig(angle)
    nc, ns = trig[NCOS][:, None], trig[NSIN][:, None]     # of -angle
    ssx, ssy = rotate_cs(v1x, v1y, nc, ns)
    sex, sey = rotate_cs(v2x, v2y, nc, ns)

    ok, lsx, lsy, lex, ley, start_offset = clip_to_viewport(ssx, ssy, sex, sey)
    valid = ok & (level.seg_front_side[None] >= 0)

    # --- sector attributes -------------------------------------------------
    fsec = torch.clamp(level.seg_front_sector, min=0).long()
    bsec_raw = level.seg_back_sector
    bsec = torch.clamp(bsec_raw, min=0).long()
    has_back = bsec_raw >= 0

    floor_h_i = level.sector_floor_h[fsec][None]                    # [1,G]
    ceil_h_i = level.sector_ceil_h[fsec][None]
    bfloor_i = level.sector_floor_h[bsec][None]
    bceil_i = level.sector_ceil_h[bsec][None]

    floor_h = f32(floor_h_i)
    ceil_h = f32(ceil_h_i)

    sky_hack = level.seg_sky_hack[None]
    has_pb = has_back[None] & (bfloor_i > floor_h_i)
    has_pt = has_back[None] & (bceil_i < ceil_h_i) & ~sky_hack
    pb = f32(bfloor_i)
    pt = f32(bceil_i)

    # sky hack lowers the drawn ceiling (segs.rs:459-477)
    ceil_used = torch.where(sky_hack, torch.minimum(pt, ceil_h), ceil_h)
    draw_ceiling = level.seg_draw_ceiling[None].expand(B, G)

    ph = f32(floor_height)[:, None] + float(f32(PLAYER_EYE_HEIGHT))

    # --- backface + side-on tests on the projected floor line ---------------
    bsx_px = project_x(cfg, lsx, lsy)
    bex_px = project_x(cfg, lex, ley)
    valid = valid & (bsx_px <= bex_px)                 # backface (segs.rs:446)
    valid = valid & (as_i16(bsx_px) != as_i16(bex_px))  # side-on (segs.rs:151)

    # --- per-piece line endpoints ---------------------------------------------
    two_sided = level.seg_two_sided[None].expand(B, G)
    h_floor = floor_h - ph
    h_ceil = ceil_used - ph
    h_pb = pb - ph
    h_pt = pt - ph
    h_mid_b = torch.where(has_pb, h_pb, h_floor)
    h_mid_t = torch.where(has_pt, h_pt, h_ceil)

    # piece (bottom, top) heights, [B, G, 4]
    hb = torch.stack(
        [h_floor, h_mid_b, h_floor, torch.where(has_pt, h_pt, h_ceil)], -1
    )
    ht = torch.stack(
        [h_ceil, h_mid_t, torch.where(has_pb, h_pb, h_floor), h_ceil], -1
    )

    def proj_y_pair(h):
        return (
            project_y(cfg, lsx[..., None], h),
            project_y(cfg, lex[..., None], h),
        )

    yb_s, yb_e = proj_y_pair(hb)
    yt_s, yt_e = proj_y_pair(ht)

    denom = f32(bsx_px - bex_px)
    yb_d = fdiv(f32(yb_s - yb_e), denom[..., None])
    yt_d = fdiv(f32(yt_s - yt_e), denom[..., None])

    active = torch.stack(
        [
            torch.ones_like(two_sided),     # piece 0 always runs
            two_sided,                      # mid
            two_sided & has_pb,             # lower
            two_sided & has_pt,             # upper
        ],
        -1,
    ) & valid[..., None]

    # texture offsets (segs.rs:496-587)
    unpeg_b = level.seg_unpeg_bottom[None]
    unpeg_t = level.seg_unpeg_top[None]
    zero = torch.zeros((), dtype=I32, device=px.device)
    bg = lambda x: x.expand(B, G)
    off0 = bg(torch.where(~two_sided & unpeg_b, as_i32(floor_h - ceil_used), zero))
    off2 = bg(torch.where(unpeg_b, as_i32(ceil_used - pb), zero))
    off3 = bg(torch.where(unpeg_t, zero, as_i32(pt - ceil_used)))
    off_y = torch.stack([off0, torch.zeros_like(off0), off2, off3], -1)
    # the reference adds two i16s; i32 here (map offsets never overflow i16)
    off_y_total = level.seg_yoff[None, :, None] + as_i16(off_y)

    mid = level.seg_mid_tex[None].expand(B, G)
    tex = torch.stack(
        [mid, mid, level.seg_low_tex[None].expand(B, G),
         level.seg_up_tex[None].expand(B, G)],
        -1,
    )

    solid = ~two_sided
    wall_emit = torch.stack(
        [solid, two_sided, active[..., 2], active[..., 3]], -1
    ) & active
    draws = torch.stack(
        [
            solid & (tex[..., 0] >= 0),
            torch.zeros_like(solid),
            tex[..., 2] >= 0,
            tex[..., 3] >= 0,
        ],
        -1,
    ) & active

    light = torch.gather(sector_light, 1, fsec[None].expand(B, G))

    flat_f = animated_flat(
        level, level.sector_floor_flat[fsec][None], timestamp[:, None]
    )
    flat_c = animated_flat(
        level, level.sector_ceil_flat[fsec][None], timestamp[:, None]
    )

    length = sqrt(
        smul(lsx - lex, lsx - lex) + smul(lsy - ley, lsy - ley)
    )

    return {
        "valid": valid,
        "x0": bsx_px, "x1": bex_px,
        "lsx": lsx, "lsy": lsy, "lex": lex, "ley": ley,
        "start_offset": start_offset, "length": length,
        "offset_x_total": (
            as_i16(level.seg_xoff)[None] + level.seg_offset[None]
        ).expand(B, G),
        "light": light,
        "floor_flat": flat_f, "ceil_flat": flat_c,
        "floor_h_i": floor_h_i.expand(B, G),
        "ceil_h_i": ceil_h_i.expand(B, G),
        "draw_ceiling": draw_ceiling,
        "two_sided": two_sided,
        "active": active, "wall_emit": wall_emit, "draws": draws,
        "yb_s": yb_s, "yb_d": yb_d, "yt_s": yt_s, "yt_d": yt_d,
        "uy1": ht - hb,
        "off_y": off_y_total,
        "tex": tex,
    }
