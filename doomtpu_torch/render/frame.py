"""Frame orchestration: camera stage -> traversal order -> walls, planes
and sky -> deferred items.

Counterpart of doomtpu/render/frame.py.  Walls, planes and sky come from
the paint kernel where the config asks for it and the level, batch and
screen allow it (`paint_available`, the JAX frame.py:245-259 path), else
from the scan + resolve pipeline:
the wall-scan kernel's unified span pool, the resolve and the shade
(JAX frame.py:261-272).  Both then run the same deferred pass with the
item kernel, unless the config asks for the item-pass kernel and the
level takes it (`itempass_available`, JAX frame.py:206-244): then the
paint stage's frame gets every selected item from that one kernel.
"""

from __future__ import annotations

import torch

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.ops.itempass import item_pass
from doomtpu_torch.ops.layout import LD_SKY
from doomtpu_torch.ops.paint import render_paint
from doomtpu_torch.render import camera as cam
from doomtpu_torch.render import resolve as res
from doomtpu_torch.render import things, walls
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import I32, camera_trig


def paint_available(level: DeviceLevel, cfg: RenderConfig, B: int) -> bool:
    """The paint path runs where the JAX package's does (JAX
    frame.py:21-51, less its backend test): the config asks for it
    (`use_pallas_paint`), the level's wall-piece textures fit 256x128
    and are opaque with an opaque sky, the level's segs fit
    `paint_max_segs` or a live-seg cap is set, the batch is a multiple
    of 4 and the height of 8.  Every other config, level or screen takes
    the scan + resolve pipeline, so one config draws the same frame and
    counts the same pools in both packages."""
    return (
        cfg.use_pallas_paint
        and level.paint_ok
        and (level.num_segs <= cfg.paint_max_segs
             or cfg.paint_live_capacity > 0)
        and B % 4 == 0
        and cfg.height % 8 == 0
    )


def _itempack_fits(level: DeviceLevel, cfg: RenderConfig) -> bool:
    """The JAX package's item-pack budget (frame.py:54-62): the selected
    items' packs, 1280 bytes each, within 600,000 bytes of the TPU's
    scalar memory.  A TPU limit, kept because the branch it picks
    decides the frame (every item drawn, or a capped item pool)."""
    I = level.num_mobjs + int(level.dseg_ix.shape[0])
    if I == 0:
        return False
    N = I if cfg.max_visible_mobjs <= 0 else min(cfg.max_visible_mobjs, I)
    return N * 1280 <= 600_000


def itempass_available(level: DeviceLevel, cfg: RenderConfig, B: int) -> bool:
    """The item-pass kernel draws the items when the config asks for it
    and the JAX package's conditions hold, so that one config draws the
    same frame in both: the paint path (`paint_available`), a level
    whose sprite and mid pictures fit 128 x 128, and packs within
    _itempack_fits.  Otherwise the deferred pass runs."""
    return (
        cfg.use_item_pass_kernel
        and paint_available(level, cfg, B)
        and level.itempaint_ok
        and _itempack_fits(level, cfg)
    )


def _frame_and_order(level, cfg, px, py, angle, floor_height, sector_light,
                     timestamp, trig):
    frame = cam.build_seg_frame(
        level, cfg, px, py, angle, floor_height, sector_light, timestamp, trig
    )
    return frame, cam.seg_order(level, cam.traversal_rank(level, px, py))


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
                 timestamp, trig):
    """The scan + resolve pipeline (JAX _stages_1_2): camera stage ->
    order -> wall scan -> resolve and shade.  Returns (idx, ld, rgb,
    aux), the frames the paint kernel gives; aux carries the frame,
    order, span pool, its counts and overflow [B], and live_dropped /
    live_stale (0: every active seg is visited)."""
    frame, order = _frame_and_order(level, cfg, px, py, angle, floor_height,
                                    sector_light, timestamp, trig)
    pool, cnt, overflow = walls.wall_scan(level, cfg, frame, order)
    idx, ld, rgb = res.resolve_frame(
        level, cfg, frame, pool, cnt, px, py, angle, floor_height, trig
    )
    zero = torch.zeros((), dtype=I32, device=px.device)
    aux = {
        "frame": frame, "order": order, "pool": pool, "cnt": cnt,
        "overflow": overflow, "live_dropped": zero, "live_stale": zero,
    }
    return idx, ld, rgb, aux


def render_walls_planes(
    level: DeviceLevel,
    cfg: RenderConfig,
    px, py, angle, floor_height,           # [B] player state
    sector_light,                          # [B, SEC]
    timestamp,                             # [B]
    trig=None,                             # the angles' trig bundle
):
    """Solid walls + visplanes/sky -> (idx, rgb, aux).  aux carries the
    camera-stage frame and order, the pools (the paint kernel's mid and
    clip pools, or the unified span pool) and counters, and the
    per-pixel light, dist and is_sky.  Every stage takes its trig from
    `trig` (jmath.camera_trig of `angle`), made here when not given."""
    if trig is None:
        trig = camera_trig(angle)
    if not paint_available(level, cfg, px.shape[0]):
        idx, ld, rgb, aux = _stages_scan(
            level, cfg, px, py, angle, floor_height, sector_light, timestamp,
            trig
        )
    else:
        frame, order = _frame_and_order(level, cfg, px, py, angle,
                                        floor_height, sector_light, timestamp,
                                        trig)
        out = render_paint(level, cfg, frame, order, angle, px, py,
                           floor_height, trig=trig)
        idx, ld, rgb = out["idx"], out["ld"], out["rgb"]
        aux = _aux_paint(frame, order, out)
    aux.update(_decoded(ld))
    return idx, rgb, aux


def render_frame(
    level: DeviceLevel,
    cfg: RenderConfig,
    px, py, angle, floor_height,           # [B] player state
    sector_light,                          # [B, SEC]
    mobj_state,                            # [B, MO]
    timestamp,                             # [B]
    reuse: dict | None = None, want_reuse: bool = False,
    trig=None,                             # the angles' trig bundle
):
    """The full frame: walls, planes, sky, sprites, masked mids.

    Returns (idx [B,H,W] palette indices with -1 = unwritten, rgb
    [B,H,W] packed 0xRRGGBB i32, aux).  aux carries what
    render_walls_planes' does, with light / dist / is_sky of the final
    frame, plus the item counters items_dropped, item_overflow and
    item_block_dropped (0: there is no block-local emission).

    Cross-tick live-list reuse (JAX frame.py:76-119, 178-205), on the
    paint + deferred pipeline with per-camera live lists only (else
    ValueError): `want_reuse` adds aux["reuse"], this tick's traversal
    order and kept live set (ops/paint.py::render_paint); passed back as
    `reuse`, a later tick draws in that order with that set, and
    aux["live_stale"] adds the cameras whose reused order is not the
    one their pose gives (camera.order_matches_rank) to the paint
    stage's count.  0 proves the frame is the one a fresh tick draws.

    Every stage takes its trig from `trig`, the angles' bundle
    (jmath.camera_trig), made here with one host round trip when not
    given."""
    args = (px, py, angle, floor_height, sector_light, mobj_state)
    B = px.shape[0]
    if (reuse is not None or want_reuse) and (
            not paint_available(level, cfg, B)
            or itempass_available(level, cfg, B)):
        raise ValueError("live-list reuse needs the paint + deferred "
                         "pipeline")
    if trig is None:
        trig = camera_trig(angle)
    if itempass_available(level, cfg, B):
        return _render_item_pass(level, cfg, *args, timestamp, trig)
    if not paint_available(level, cfg, B):
        idx, ld, rgb, aux = _stages_scan(
            level, cfg, px, py, angle, floor_height, sector_light, timestamp,
            trig
        )
        pools = things.pools_from_unified(aux["pool"], aux["cnt"],
                                          aux["frame"])
    else:
        frame = cam.build_seg_frame(level, cfg, px, py, angle, floor_height,
                                    sector_light, timestamp, trig)
        rank = cam.traversal_rank(level, px, py)
        order_stale = 0
        if reuse is None:
            order = cam.seg_order(level, rank)
        else:
            order = reuse["order"]
            order_stale = (~cam.order_matches_rank(level, rank, order)).sum(
                dtype=I32)
        out = render_paint(level, cfg, frame, order, angle, px, py,
                           floor_height, reuse=reuse, want_reuse=want_reuse,
                           trig=trig)
        idx, ld, rgb = out["idx"], out["ld"], out["rgb"]
        aux = _aux_paint(frame, order, out)
        aux["live_stale"] = out["live_stale"] + order_stale
        if want_reuse:
            aux["reuse"] = dict(out["reuse"], order=order)
        pools = things.pools_from_paint(out)
    idx, ld, rgb, daux = things.deferred_pass(
        level, cfg, aux["frame"], pools, aux["order"], *args, idx, ld, rgb,
        trig=trig,
    )
    aux.update(_decoded(ld))
    aux.update(daux)
    return idx, rgb, aux


def _render_item_pass(level, cfg, px, py, angle, floor_height, sector_light,
                      mobj_state, timestamp, trig):
    """render_frame through the item-pass kernel (JAX frame.py:206-244):
    the paint stage, then every selected item painted over its frame.
    No item pool, so item_overflow is 0."""
    frame, order = _frame_and_order(level, cfg, px, py, angle, floor_height,
                                    sector_light, timestamp, trig)
    out = render_paint(level, cfg, frame, order, angle, px, py, floor_height,
                       trig=trig)
    aux = _aux_paint(frame, order, out)
    aux["item_block_dropped"] = torch.zeros((), dtype=I32, device=px.device)
    ipack, item_aux = things.item_pack(level, cfg, frame, order, px, py,
                                       angle, floor_height, sector_light,
                                       mobj_state, trig)
    aux.update(item_aux)
    if ipack is not None:
        item_pass(level, cfg, ipack, out)
    aux.update(_decoded(out["ld"]))
    return out["idx"], out["rgb"], aux
