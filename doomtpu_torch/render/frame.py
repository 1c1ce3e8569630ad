"""Frame orchestration: camera stage -> traversal order -> walls, planes
and sky -> deferred items.

Counterpart of doomtpu/render/frame.py.  Walls, planes and sky come from
the paint kernel where the level and screen allow it (`paint_available`,
the JAX frame.py:245-259 path), else from the scan + resolve pipeline:
the wall-scan kernel's unified span pool, the resolve and the shade
(JAX frame.py:261-272).  Both then run the same deferred pass with the
item kernel.
"""

from __future__ import annotations

import torch

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.ops.paint import LD_SKY, LD_WRITTEN, render_paint
from doomtpu_torch.render import camera as cam
from doomtpu_torch.render import resolve as res
from doomtpu_torch.render import things, walls
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import I32


def paint_available(level: DeviceLevel, cfg: RenderConfig) -> bool:
    """The paint path takes every level whose wall-piece textures fit
    256x128 and are opaque, with an opaque sky, at any batch or height,
    up to 1024 columns (one thread per column in one block).  Every
    other level or screen takes the scan + resolve pipeline."""
    return level.paint_ok and cfg.width <= 1024


def _frame_and_order(level, cfg, px, py, angle, floor_height, sector_light,
                     timestamp):
    frame = cam.build_seg_frame(
        level, cfg, px, py, angle, floor_height, sector_light, timestamp
    )
    return frame, cam.seg_order(level, cam.traversal_rank(level, px, py))


def pack_ld(idx, light, dist, is_sky):
    """The ld frame the paint kernel writes and the item kernel reads:
    light(8) << 16 | dist(u16) | written << 24 | sky << 25."""
    return ((light << 16) | (dist & 0xFFFF)
            | ((idx >= 0).to(I32) * LD_WRITTEN) | (is_sky.to(I32) * LD_SKY))


def _decoded(ld) -> dict:
    """light, dist and is_sky of a packed ld frame."""
    return {
        "light": (ld >> 16) & 0xFF,
        "dist": ((ld & 0xFFFF) << 16) >> 16,
        "is_sky": (ld & LD_SKY) != 0,
    }


def _aux_paint(frame, order, out) -> dict:
    """aux of the paint path without the per-pixel frames (the caller
    decodes its final ld once)."""
    return {
        "frame": frame, "order": order,
        "midpool": out["midpool"], "cnt_mid": out["cnt_mid"],
        "clippool": out["clippool"], "cnt_clip": out["cnt_clip"],
        "overflow": out["overflow"], "live_dropped": out["live_dropped"],
        "live_stale": out["live_stale"],
    }


def _stages_scan(level, cfg, px, py, angle, floor_height, sector_light,
                 timestamp):
    """The scan + resolve pipeline (JAX _stages_1_2): camera stage ->
    order -> wall scan -> resolve.  Returns (idx, light, dist, is_sky,
    aux); aux carries the frame, order, span pool, its counts and
    overflow [B], and live_dropped / live_stale (0: every active seg is
    visited), not the per-pixel frames (callers free them early)."""
    frame, order = _frame_and_order(level, cfg, px, py, angle, floor_height,
                                    sector_light, timestamp)
    pool, cnt, overflow = walls.wall_scan(level, cfg, frame, order)
    idx, light, dist, is_sky = res.resolve_frame(
        level, cfg, frame, pool, cnt, px, py, angle, floor_height
    )
    zero = torch.zeros((), dtype=I32, device=px.device)
    aux = {
        "frame": frame, "order": order, "pool": pool, "cnt": cnt,
        "overflow": overflow, "live_dropped": zero, "live_stale": zero,
    }
    return idx, light, dist, is_sky, aux


def render_walls_planes(
    level: DeviceLevel,
    cfg: RenderConfig,
    px, py, angle, floor_height,           # [B] player state
    sector_light,                          # [B, SEC]
    timestamp,                             # [B]
):
    """Solid walls + visplanes/sky -> (idx, rgb, aux).  aux carries the
    camera-stage frame and order, the pools (the paint kernel's mid and
    clip pools, or the unified span pool) and counters, and the
    per-pixel light, dist and is_sky."""
    if not paint_available(level, cfg):
        idx, light, dist, is_sky, aux = _stages_scan(
            level, cfg, px, py, angle, floor_height, sector_light, timestamp
        )
        aux.update(light=light, dist=dist, is_sky=is_sky)
        return idx, res.shade(level, idx, light, dist, is_sky), aux
    frame, order = _frame_and_order(level, cfg, px, py, angle, floor_height,
                                    sector_light, timestamp)
    out = render_paint(level, cfg, frame, order, angle, px, py, floor_height)
    aux = _aux_paint(frame, order, out)
    aux.update(_decoded(out["ld"]))
    return out["idx"], out["rgb"], aux


def render_frame(
    level: DeviceLevel,
    cfg: RenderConfig,
    px, py, angle, floor_height,           # [B] player state
    sector_light,                          # [B, SEC]
    mobj_state,                            # [B, MO]
    timestamp,                             # [B]
):
    """The full frame: walls, planes, sky, sprites, masked mids.

    Returns (idx [B,H,W] palette indices with -1 = unwritten, rgb
    [B,H,W] packed 0xRRGGBB i32, aux).  aux carries what
    render_walls_planes' does, with light / dist / is_sky of the final
    frame, plus the item counters items_dropped, item_overflow and
    item_block_dropped (0: there is no block-local emission)."""
    args = (px, py, angle, floor_height, sector_light, mobj_state)
    if not paint_available(level, cfg):
        idx, light, dist, is_sky, aux = _stages_scan(
            level, cfg, px, py, angle, floor_height, sector_light, timestamp
        )
        # JAX composites the items over (idx, light, dist, is_sky) and
        # then shades; the item kernel shades the pixels it writes with
        # the same arithmetic, so shading first gives the same bits
        rgb = res.shade(level, idx, light, dist, is_sky)
        ld = pack_ld(idx, light, dist, is_sky)
        del light, dist, is_sky
        pools = things.pools_from_unified(aux["pool"], aux["cnt"],
                                          aux["frame"])
    else:
        frame, order = _frame_and_order(level, cfg, px, py, angle,
                                        floor_height, sector_light, timestamp)
        out = render_paint(level, cfg, frame, order, angle, px, py,
                           floor_height)
        idx, ld, rgb = out["idx"], out["ld"], out["rgb"]
        aux = _aux_paint(frame, order, out)
        pools = things.pools_from_paint(out)
    idx, ld, rgb, daux = things.deferred_pass(
        level, cfg, aux["frame"], pools, aux["order"], *args, idx, ld, rgb,
    )
    aux.update(_decoded(ld))
    aux.update(daux)
    return idx, rgb, aux
