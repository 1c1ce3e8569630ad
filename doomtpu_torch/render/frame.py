"""Frame orchestration: camera stage -> traversal order -> paint ->
deferred items.

Counterpart of doomtpu/render/frame.py on its paint pipeline (the JAX
frame.py:245-259 path; the item-pass kernel and the scan + resolve
fallback are not ported yet).
"""

from __future__ import annotations

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.ops.paint import LD_SKY, render_paint
from doomtpu_torch.render import camera as cam
from doomtpu_torch.render import things
from doomtpu_torch.render.device import DeviceLevel


def paint_available(level: DeviceLevel, cfg: RenderConfig) -> bool:
    """The paint path takes every level whose wall-piece textures fit
    256x128 and are opaque, with an opaque sky, at any batch or height,
    up to 1024 columns (one thread per column in one block)."""
    return level.paint_ok and cfg.width <= 1024


def _require_paint(level: DeviceLevel, cfg: RenderConfig):
    if not paint_available(level, cfg):
        raise NotImplementedError(
            "this level or screen is not eligible for the paint kernel; "
            "the scan + resolve fallback is not ported yet"
        )


def _aux(frame, order, out) -> dict:
    ld = out["ld"]
    return {
        "frame": frame, "order": order,
        "midpool": out["midpool"], "cnt_mid": out["cnt_mid"],
        "clippool": out["clippool"], "cnt_clip": out["cnt_clip"],
        "overflow": out["overflow"], "live_dropped": out["live_dropped"],
        "live_stale": out["live_stale"],
        "light": (ld >> 16) & 0xFF,
        "dist": ((ld & 0xFFFF) << 16) >> 16,
        "is_sky": (ld & LD_SKY) != 0,
    }


def render_walls_planes(
    level: DeviceLevel,
    cfg: RenderConfig,
    px, py, angle, floor_height,           # [B] player state
    sector_light,                          # [B, SEC]
    timestamp,                             # [B]
):
    """Solid walls + visplanes/sky -> (idx, rgb, aux).  aux carries the
    camera-stage frame and order, the paint pools and counters, and the
    per-pixel light, dist and is_sky decoded from ld."""
    _require_paint(level, cfg)
    frame = cam.build_seg_frame(
        level, cfg, px, py, angle, floor_height, sector_light, timestamp
    )
    order = cam.seg_order(level, cam.traversal_rank(level, px, py))
    out = render_paint(level, cfg, frame, order, angle, px, py, floor_height)
    return out["idx"], out["rgb"], _aux(frame, order, out)


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
    _require_paint(level, cfg)
    frame = cam.build_seg_frame(
        level, cfg, px, py, angle, floor_height, sector_light, timestamp
    )
    order = cam.seg_order(level, cam.traversal_rank(level, px, py))
    out = render_paint(level, cfg, frame, order, angle, px, py, floor_height)
    idx, ld, rgb, daux = things.deferred_pass(
        level, cfg, frame, things.pools_from_paint(out), order,
        px, py, angle, floor_height, sector_light, mobj_state,
        out["idx"], out["ld"], out["rgb"],
    )
    aux = _aux(frame, order, dict(out, ld=ld))
    aux.update(daux)
    return idx, rgb, aux
