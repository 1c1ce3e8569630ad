"""Deferred pass: map-object sprites + masked two-sided mid walls.

Counterpart of doomtpu/render/things.py (`pools_from_paint` or
`pools_from_unified` -> `deferred_pass` with the item kernel) at its
shipping defaults: dense emission (no block-local path), mid presence
per selected item and the vectorized mid fill.  `item_pack` builds the
item-pass kernel's inputs from the same selection (stages 1-2), and
`item_census` counts what the pool would hold uncapped (calibration).  The
stages and their arithmetic are the JAX package's:

1. per-item scalars [B, I], I = mobjs + drawable mids: billboard
   projection and painter keys (renderer/map_objects.rs:37-121);
2. the nearest max_visible_mobjs items in painter order are selected;
   the rest count in items_dropped; the selected items' per-item packs
   (`item_pack`'s, made once for both passes);
3. presence per selected item and column; each column's present items
   fill its item pool [B, KI, W] nearest first, so a full column drops
   its farthest items (counted in item_overflow);
4. per-slot sprite column math, and mid slots filled from the mid
   pool;
5. the item kernel (ops/items.py) clips sprite slots against the clip
   pool and folds the pool farthest -> nearest over the paint frame.

The JAX package gathers per-slot values with one-hot MXU contractions
([B, I, N] for the selection, [B, W, N, KI] for the emission); here the
selection is a stable sort, and stages 3-4 are ops/emit.py: one CUDA
kernel on the card (csrc/emit.cu), exact index operations in its plain
version.  Each stage runs once over the whole batch.

The item pool is slot-major, [B, KI, W] per plane, the item kernel's
layout.  Its planes: word (ct+1 | cb+1 << 16 | marks), atlas column,
by|ty, off_y|th, light|zdist, uy1 bits, and the sprite's view-space
position vpx, vpy (bits) for the in-kernel clip.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from doomtpu_torch.config import PLAYER_EYE_HEIGHT, RenderConfig
from doomtpu_torch.ops.emit import emit
from doomtpu_torch.ops.items import composite_items, is_behind_vertex
from doomtpu_torch.ops.itempass import (
    IPF_DX, IPF_INV0, IPF_INV1, IPF_ROWS, IPF_UY1, IPF_VPX, IPF_VPY,
    IPF_YBD, IPF_YBS, IPF_YTD, IPF_YTS, IPF_Z0, IPF_Z1, IPI_BSX, IPI_FL,
    IPI_LW, IPI_PIC, IPI_ROWS, IPI_SOFF, IPI_TH, IPI_X0, IPI_X1E,
)
from doomtpu_torch.ops.layout import KIND_MID
from doomtpu_torch.ops.paint import LIVE_BLOCK
# re-exported: the JAX package's things.py holds pools_from_paint
from doomtpu_torch.ops.paint import pools_from_paint  # noqa: F401
from doomtpu_torch.render import camera as cam
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    NCOS, NSIN, F32, I32, as_i16, camera_trig, fdiv, reciprocal, rotate_cs,
    smul, sqrt, stable_positions,
)
from doomtpu_torch.trace import spanned

_PI = np.float32(math.pi)
_TWO_PI = np.float32(2.0) * _PI


def sprite_rotation(player_angle, mobj_angle):
    """0..7 rotation index (map_objects.rs:53-67), f32 like the
    reference.  The division by 2 pi is XLA's multiply by the constant's
    f32 reciprocal (jmath.div_const)."""
    two_pi = float(_TWO_PI)
    angle = (player_angle.to(F32) - mobj_angle.to(F32)) - float(_PI)
    angle = angle + float(_PI / np.float32(16.0))
    angle = torch.fmod(angle, two_pi)
    angle = torch.where(angle < 0.0, angle + two_pi, angle)
    angle = torch.fmod(angle, two_pi)
    rot = (angle * 8.0) * reciprocal(_TWO_PI)
    return torch.clamp(torch.trunc(rot), 0, 255).to(I32)


def pools_from_unified(pool, cnt, frame: dict):
    """(clip, mid) pools from the unified span pool of the scan + resolve
    pipeline (render/walls.wall_scan: (spans, [d1..d6]) as [B, W, K]
    views), as slot-major [B, K, W] planes.  Both views are the same
    slots, as in the JAX pools_from_unified: plane records are inert in
    the clip (no E2B / E2T / DC bit, not KIND_MID) and in the mid pool
    (not KIND_MID).  The item kernel's clip reads each record's seg
    endpoints, which the span pool does not carry: they are gathered
    from the camera-stage frame by the record's seg id d6, as the JAX
    XLA clip does (slots at or past cnt gather seg 0 and are never
    read)."""
    spans, planes = pool
    sm = lambda p: p.transpose(1, 2)
    s = sm(spans)
    d1, d2, d3, d4, d5, d6 = (sm(p) for p in planes)
    B, K, W = s.shape
    valid = torch.arange(K, dtype=I32, device=s.device)[None, :, None] \
        < cnt[:, None, :]
    seg = torch.where(valid, d6, 0).reshape(B, K * W).long()
    coord = lambda k: torch.gather(frame[k], 1, seg).reshape(B, K, W).view(I32)
    clip = {"span": s, "d2": d2, "d6": d6, "cnt": cnt}
    clip.update({k: coord(k) for k in ("lsx", "lsy", "lex", "ley")})
    mid = {"span": s, "d1": d1, "d2": d2, "d3": d3, "d4": d4, "d5": d5,
           "d6": d6, "cnt": cnt}
    return clip, mid


def _sprite_scalars(level: DeviceLevel, cfg: RenderConfig, px, py, angle,
                    floor_height, sector_light, mobj_state, trig):
    """Per-mobj billboard scalars [B, MO] (map_objects.rs:37-121); the
    view transform's trig is the rows NCOS, NSIN of `trig`, the angles'
    bundle (jmath.camera_trig)."""
    MO = level.num_mobjs
    state = mobj_state.long()
    alive = mobj_state != 0                                   # S_NULL
    sprite_ix = level.state_sprite[state].long()
    frame_n = level.state_frame[state]
    bright = level.state_full_bright[state]
    rot = sprite_rotation(angle[:, None], level.mobj_angle[None])
    max_frame = level.spr_table.shape[1]
    frame_ok = frame_n < max_frame
    pic = level.spr_table[
        sprite_ix, torch.clamp(frame_n, max=max_frame - 1).long(), rot.long()
    ]
    valid = alive & frame_ok & (pic >= 0) & (level.mobj_sector[None] >= 0)
    pic_s = torch.clamp(pic, min=0)
    ps = pic_s.long()

    mx = level.mobj_pos[None, :, 0] - px[:, None]
    my = level.mobj_pos[None, :, 1] - py[:, None]
    vpx, vpy = rotate_cs(mx, my, trig[NCOS][:, None], trig[NSIN][:, None])
    w_pic = level.spr_w[ps]
    half = w_pic.to(F32) * 0.5
    ok, lsx, lsy, lex, ley, start_off = cam.clip_to_viewport(
        vpx, vpy + half, vpx, vpy - half
    )
    valid = valid & ok

    sec = torch.clamp(level.mobj_sector, min=0).long()
    light_m = torch.where(bright, 255, sector_light[:, sec])
    ph = floor_height.to(F32)[:, None] + float(np.float32(PLAYER_EYE_HEIGHT))
    z_f = level.sector_floor_h[sec].to(F32)[None]
    pic_h = level.spr_h[ps].to(F32)
    top_off = level.spr_top[ps].to(F32)
    bottom_h = z_f - ph
    top_h = ((z_f + pic_h) - 1.0) - ph
    off_adj = top_off - pic_h
    bottom_h = bottom_h + off_adj
    top_h = top_h + off_adj

    bsx = cam.project_x(cfg, lsx, lsy)
    bex = cam.project_x(cfg, lex, ley)
    yb_s = cam.project_y(cfg, lsx, bottom_h)
    yb_e = cam.project_y(cfg, lex, bottom_h)
    yt_s = cam.project_y(cfg, lsx, top_h)
    yt_e = cam.project_y(cfg, lex, top_h)
    denom_x = (bsx - bex).to(F32)
    yb_d = fdiv((yb_s - yb_e).to(F32), denom_x)
    yt_d = fdiv((yt_s - yt_e).to(F32), denom_x)

    # back-to-front painter position: MO-1 minus the ascending stable
    # position of as_i16(lsx)
    j_of_m = (MO - 1) - stable_positions(as_i16(lsx))
    return dict(
        valid=valid, pic_s=pic_s, w_pic=w_pic, light_m=light_m,
        lsx=lsx, lsy=lsy, lex=lex, ley=ley, start_off=start_off,
        vpx=vpx, vpy=vpy, bsx=bsx, bex=bex,
        yb_s=yb_s, yb_d=yb_d, yt_s=yt_s, yt_d=yt_d,
        bottom_h=bottom_h, top_h=top_h, j_of_m=j_of_m,
    )


def _select_items(level: DeviceLevel, cfg: RenderConfig, frame: dict, order,
                  px, py, angle, floor_height, sector_light, mobj_state,
                  trig):
    """Per-item scalars and the nearest-N painter-order selection.

    Returns None when the level has no items, else a dict with the
    selected item ids `sel` [B, N] (ascending painter key: slot N-1 is
    the nearest), `sel_valid`, `is_spr_sel`, `items_dropped` [B], the
    selected sprites' scalars `spr` (zeros at mid slots) and the selected
    mids' seg ids `segsel` (zeros at sprite slots)."""
    B, dev = px.shape[0], px.device
    G, MO = level.num_segs, level.num_mobjs
    dsegs = level.dseg_ix.long()
    D = dsegs.shape[0]
    I = MO + D
    if I == 0:
        return None
    N = I if cfg.max_visible_mobjs <= 0 else min(cfg.max_visible_mobjs, I)

    if MO > 0:
        sps = _sprite_scalars(level, cfg, px, py, angle, floor_height,
                              sector_light, mobj_state, trig)
        valid, j_of_m = sps["valid"], sps["j_of_m"]
    else:
        valid = torch.zeros((B, 0), dtype=torch.bool, device=dev)

    if D > 0:
        if MO > 0:
            midx = (sps["lsx"] + sps["lex"]) * 0.5
            midy = (sps["lsy"] + sps["ley"]) * 0.5
            fr = lambda k: frame[k][:, dsegs, None]
            behind_mid = is_behind_vertex(
                fr("lsx"), fr("lsy"), fr("lex"), fr("ley"),
                midx[:, None, :], midy[:, None, :],
            )                                                  # [B, D, MO]
            # first draw-order position among behind + valid mobjs
            bv = behind_mid & valid[:, None, :]
            j_first = torch.where(bv, j_of_m[:, None, :], MO).amin(-1)
        else:
            j_first = torch.zeros((B, D), dtype=I32, device=dev)
        # traversal position of each drawable-mid seg: order inverted by
        # one unique-index scatter (the JAX SELPOS form, bit-identical to
        # its one-hot compare-reduce)
        positions = torch.empty_like(order)
        positions.scatter_(
            1, order.long(),
            torch.arange(G, dtype=I32, device=dev)[None].expand(B, G),
        )
        tie_d = (G - 1) - positions[:, dsegs]
        dseg_valid = frame["valid"][:, dsegs] & frame["active"][:, dsegs, 1]
    else:
        j_first = torch.zeros((B, 0), dtype=I32, device=dev)
        tie_d = torch.zeros((B, 0), dtype=I32, device=dev)
        dseg_valid = torch.zeros((B, 0), dtype=torch.bool, device=dev)

    TIE = G + 1
    key_sprite = ((2 * j_of_m + 1) * TIE if MO > 0
                  else torch.zeros((B, 0), dtype=I32, device=dev))
    key_seg = (2 * j_first) * TIE + tie_d
    item_valid = torch.cat([valid, dseg_valid], 1)
    # invalid items get key -1, so the last N of the ascending stable
    # order are exactly the nearest N valid items
    item_key = torch.where(item_valid, torch.cat([key_sprite, key_seg], 1), -1)
    sel = torch.sort(item_key, dim=1, stable=True).indices[:, I - N:]  # i64
    n_valid = item_valid.sum(1, dtype=I32)
    out = {
        "N": N,
        "sel": sel.to(I32),
        "sel_valid": torch.gather(item_valid, 1, sel),
        "is_spr_sel": sel < MO,
        "items_dropped": torch.clamp(n_valid - N, min=0),
    }

    def at_sel(x):
        """[B, MO] or [B, D] values at the selected items, zeros at the
        other kind's slots (the JAX fold's zero padding)."""
        if x.shape[1] == MO:
            x = torch.cat([x, torch.zeros((B, D), dtype=x.dtype, device=dev)], 1)
        else:
            x = torch.cat([torch.zeros((B, MO), dtype=x.dtype, device=dev), x],
                          1)
        return torch.gather(x, 1, sel)

    if MO > 0:
        out["spr"] = {
            k: at_sel(sps[k]) for k in (
                "lsx", "lsy", "lex", "ley", "start_off", "pic_s", "w_pic",
                "light_m", "bsx", "bex", "yb_s", "yb_d", "yt_s", "yt_d",
                "vpx", "vpy")
        }
        out["spr"]["uy1"] = at_sel(sps["top_h"] - sps["bottom_h"])
        sp = out["spr"]
        sp["slen"] = sqrt(smul(sp["lsx"] - sp["lex"], sp["lsx"] - sp["lex"])
                          + smul(sp["lsy"] - sp["ley"], sp["lsy"] - sp["ley"]))
    if D > 0:
        out["segsel"] = at_sel(level.dseg_ix[None].expand(B, D))
    return out


def _item_pack(level: DeviceLevel, cfg: RenderConfig, frame: dict, order,
               px, py, angle, floor_height, sector_light, mobj_state,
               trig=None):
    """The selection and the per-item packs, in no span: the code that
    `item_pack` (the item pass) and `item_pool` (the deferred pass) share.
    `trig`: the angles' trig bundle (jmath.camera_trig), else one round
    trip here.  Returns (pack, items_dropped [B]), or (None, None) when
    the level has no items."""
    B, dev = px.shape[0], px.device
    if trig is None:
        trig = camera_trig(angle)
    s = _select_items(level, cfg, frame, order, px, py, angle, floor_height,
                      sector_light, mobj_state, trig)
    if s is None:
        return None, None
    N = s["N"]
    sel_valid, is_spr = s["sel_valid"], s["is_spr_sel"]
    zero = torch.zeros((B, N), dtype=I32, device=dev)
    zf = torch.zeros((B, N), dtype=F32, device=dev)
    T = level.tex_pixels.shape[0]

    spr_i = dict.fromkeys(range(IPI_ROWS), zero)
    spr_f = dict.fromkeys(range(IPF_ROWS), zf)
    if "spr" in s:
        sp = s["spr"]
        inv0, inv1 = fdiv(1.0, sp["lsx"]), fdiv(1.0, sp["lex"])
        z0 = fdiv(0.0, sp["lsx"])
        spr_i.update({
            IPI_X0: as_i16(sp["bsx"]),
            IPI_X1E: as_i16(sp["bex"]),          # bex is exclusive already
            IPI_LW: sp["light_m"] | (sp["w_pic"] << 16),
            IPI_PIC: T + sp["pic_s"],
            IPI_TH: level.spr_h[sp["pic_s"].long()],
            IPI_SOFF: as_i16(sp["start_off"]),
            IPI_BSX: sp["bsx"],
        })
        spr_f.update({
            IPF_DX: (sp["bex"] - sp["bsx"]).to(F32),
            IPF_INV0: inv0,
            IPF_INV1: inv1,
            IPF_Z0: z0,
            IPF_Z1: fdiv(sp["slen"], sp["lex"]),
            IPF_YBS: sp["yb_s"].to(F32), IPF_YBD: sp["yb_d"],
            IPF_YTS: sp["yt_s"].to(F32), IPF_YTD: sp["yt_d"],
            IPF_UY1: sp["uy1"], IPF_VPX: sp["vpx"], IPF_VPY: sp["vpy"],
        })

    mid_i = dict.fromkeys(range(IPI_ROWS), zero)
    if "segsel" in s:
        segsel = s["segsel"]
        at = lambda x: torch.gather(x, 1, segsel.long())
        mid_i.update({
            IPI_X0: as_i16(at(frame["x0"])),
            IPI_X1E: as_i16(at(frame["x1"])) + 1,
            IPI_PIC: torch.clamp(level.seg_mid_tex[segsel.long()], min=0),
            IPI_SOFF: segsel,
        })

    fl = sel_valid.to(I32) | (is_spr.to(I32) << 1)
    rows_i = [fl if r == IPI_FL else torch.where(is_spr, spr_i[r], mid_i[r])
              for r in range(IPI_ROWS)]
    # the f32 rows are the sprites' (a mid reads its mid-pool slot)
    pack = {"i": torch.stack(rows_i, -1).contiguous(),
            "f": torch.stack([spr_f[r] for r in range(IPF_ROWS)],
                             -1).contiguous()}
    return pack, s["items_dropped"]


@spanned("doom.itempass")
def item_pack(level: DeviceLevel, cfg: RenderConfig, frame: dict, order,
              px, py, angle, floor_height, sector_light, mobj_state,
              trig=None):
    """The item-pass kernel's per-item packs (JAX things.item_pack).

    Returns ({"i": [B, N, IPI_ROWS] i32, "f": [B, N, IPF_ROWS] f32},
    aux), or (None, aux) when the level has no items; aux counts
    items_dropped (beyond max_visible_mobjs) and item_overflow (0: the
    item pass has no per-column cap).  Items are in painter order,
    farthest first, so painting them in index order with nearer items
    overwriting is the reference's back-to-front painter
    (map_objects.rs:216-240).  The deferred pass's `item_pool` emits its
    item pool from the same pack (`_item_pack`)."""
    B, dev = px.shape[0], px.device
    zero_aux = {"items_dropped": torch.zeros((B,), dtype=I32, device=dev),
                "item_overflow": torch.zeros((B,), dtype=I32, device=dev)}
    pack, dropped = _item_pack(level, cfg, frame, order, px, py, angle,
                               floor_height, sector_light, mobj_state, trig)
    if pack is None:
        return None, zero_aux
    return pack, dict(zero_aux, items_dropped=dropped)


def item_census(level: DeviceLevel, cfg: RenderConfig, frame: dict, pools,
                px, py, angle, floor_height, sector_light, mobj_state,
                tile: int = 1, trig=None) -> dict:
    """Uncapped per-column item presence and valid-item totals: the
    census behind calibration (doomtpu_torch/calibrate.py), JAX
    things.item_census.

    `pools` is the (clip, mid) pair; only the mid pool's span, d6 and cnt
    ([B, K, W] slot-major, as pools_from_unified gives them) are read.
    Returns {"n_valid": [B] i32, "presence": [B, W] i32,
    "presence_block": [] i32}: presence[b, w] is the item-pool occupancy
    the deferred pass would see with max_visible_mobjs and item_capacity
    both uncapped, and presence_block the peak count of distinct live
    items per (camera `tile`, 128-column block), the requirement of the
    JAX package's block emission (item_block_capacity).

    Sprite coverage [bsx, bex) goes through a difference array and a
    cumsum; mid coverage counts the mid-pool slots whose seg is a valid
    drawable mid."""
    B, W, dev = px.shape[0], cfg.width, px.device
    MO, G = level.num_mobjs, level.num_segs
    dsegs = level.dseg_ix.long()
    nbw = -(-W // LIVE_BLOCK)
    wlo = torch.arange(nbw, dtype=I32, device=dev) * LIVE_BLOCK
    T = tile if tile > 1 and B % tile == 0 else 1

    def tile_any(x):                    # [B, I, NBW] -> [B/T, I, NBW]
        return x.view(B // T, T, x.shape[1], nbw).any(1)

    blk_cnt = torch.zeros((B // T, nbw), dtype=I32, device=dev)
    n_valid = torch.zeros((B,), dtype=I32, device=dev)
    presence = torch.zeros((B, W), dtype=I32, device=dev)
    if MO > 0:
        if trig is None:
            trig = camera_trig(angle)
        sps = _sprite_scalars(level, cfg, px, py, angle, floor_height,
                              sector_light, mobj_state, trig)
        valid = sps["valid"]
        x0, x1 = as_i16(sps["bsx"]), as_i16(sps["bex"])      # x1 exclusive
        lo, hi = torch.clamp(x0, 0, W), torch.clamp(x1, 0, W)
        use = valid & (hi > lo)
        # unused intervals land on the dumped column W, outside the cumsum
        diff = torch.zeros((B, W + 1), dtype=I32, device=dev)
        one = torch.ones_like(lo)
        diff.scatter_add_(1, torch.where(use, lo, W).long(), one)
        diff.scatter_add_(1, torch.where(use, hi, W).long(), -one)
        presence += torch.cumsum(diff[:, :W], 1, dtype=I32)
        n_valid += valid.sum(1, dtype=I32)
        live = ((x0[..., None] < wlo + LIVE_BLOCK) & (x1[..., None] > wlo)
                & valid[..., None])                           # [B, MO, NBW]
        blk_cnt += tile_any(live).sum(1, dtype=I32)
    if dsegs.shape[0] > 0:
        midp = pools[1]
        span, d6 = midp["span"], midp["d6"]                   # [B, K, W]
        K = span.shape[1]
        ok = torch.arange(K, device=dev)[None, :, None] < midp["cnt"][:, None]
        mid_slot = (((span >> 29) & 3) == KIND_MID) & ok
        dseg_valid = frame["valid"][:, dsegs] & frame["active"][:, dsegs, 1]
        valid_of_seg = torch.zeros((B, G + 1), dtype=torch.bool, device=dev)
        valid_of_seg[:, dsegs] = dseg_valid
        # slots past a column's count hold no record: they read seg G
        seg = torch.where(mid_slot, d6, G).long()
        drawn = torch.gather(valid_of_seg, 1, seg.view(B, -1)).view(B, K, W)
        presence += drawn.sum(1, dtype=I32)
        n_valid += dseg_valid.sum(1, dtype=I32)
        # distinct live mids per block: the drawn slots set (block, seg)
        # flags, read back per drawable mid
        blk = torch.arange(W, device=dev) // LIVE_BLOCK
        flat = blk * (G + 1) + torch.where(drawn, seg, G)
        segblk = torch.zeros((B, nbw * (G + 1)), dtype=torch.bool,
                             device=dev)
        segblk.scatter_(1, flat.view(B, -1), True)
        live_mid = (segblk.view(B, nbw, G + 1)[:, :, dsegs].transpose(1, 2)
                    & dseg_valid[..., None])                  # [B, D, NBW]
        blk_cnt += tile_any(live_mid).sum(1, dtype=I32)
    return {"n_valid": n_valid, "presence": presence,
            "presence_block": blk_cnt.max()}


def item_pool(level: DeviceLevel, cfg: RenderConfig, frame: dict, pools,
              order, px, py, angle, floor_height, sector_light, mobj_state,
              trig=None):
    """The item kernel's inputs for B cameras, in one pass over the
    batch: (ipool [ITEM_PLANES, B, KI, W] i32, icnt [B, W] i32, daux);
    ipool is None when the level has no items.  daux counts
    items_dropped and item_overflow per camera, and item_peak is each
    camera's largest uncapped column occupancy (the item_capacity that
    would drop nothing).

    The selection and the per-item packs are item_pack's (`_item_pack`);
    ops/emit.py::emit emits the pool from them and the mid pool: the
    emission kernel on CUDA tensors, its plain version on CPU tensors."""
    B, dev = px.shape[0], px.device
    daux = {"item_block_dropped": torch.zeros((), dtype=I32, device=dev)}
    if level.num_mobjs + level.dseg_ix.shape[0] == 0:
        for k in ("items_dropped", "item_overflow", "item_peak"):
            daux[k] = torch.zeros((B,), dtype=I32, device=dev)
        return None, None, daux
    pack, daux["items_dropped"] = _item_pack(
        level, cfg, frame, order, px, py, angle, floor_height, sector_light,
        mobj_state, trig)
    ipool, icnt, daux["item_overflow"], daux["item_peak"] = emit(
        level, cfg, pack, pools[1])
    return ipool, icnt, daux


@spanned("doom.deferred")
def deferred_pass(level: DeviceLevel, cfg: RenderConfig, frame: dict, pools,
                  order, px, py, angle, floor_height, sector_light,
                  mobj_state, idx, ld, rgb, trig=None):
    """Composite sprites + masked mids over the frame.

    `pools` is the (clip, mid) pair from pools_from_paint or
    pools_from_unified; idx/ld/rgb [B, H, W] are the shaded frame of
    walls, planes and sky (ld packed as the paint kernel's) and are
    updated in place.
    Returns (idx, ld, rgb, daux), daux counting items_dropped (beyond
    max_visible_mobjs) and item_overflow (item-pool column overflow).
    `trig`: the angles' trig bundle (jmath.camera_trig), passed on to the
    item selection."""
    ipool, icnt, daux = item_pool(
        level, cfg, frame, pools, order, px, py, angle, floor_height,
        sector_light, mobj_state, trig,
    )
    if ipool is not None:
        idx, ld, rgb = composite_items(level, cfg, ipool, icnt, idx, ld, rgb,
                                       clip=pools[0])
    return idx, ld, rgb, daux
