"""Auto-capacity calibration: pool capacities from a census.

Counterpart of doomtpu/calibrate.py, with its names and semantics.
Undersized pools drop work (wrong pixels), so every capacity must ride
above the workload's true peak; this measures the peaks on the states
the caller will render:

    cfg = calibrated_config(engine, states)

  span pool peak              -> span_capacity
  wall+mid clip-span peak     -> clip_capacity (sprites clip against these)
  mid-span peak               -> mid_capacity
  item presence peak          -> item_capacity
  valid item count peak       -> max_visible_mobjs
  per-(tile, block) live-seg peaks (union or per camera)
                              -> paint_live_capacity

and returns a copy of engine.config with those set: pools rounded up to
a multiple of 8, max_visible_mobjs to 32, the live cap to 32 above the
peak (one full quantum of headroom).

The census runs uncapped on the scan pipeline's wall scan
(render/walls.py): the wall-scan kernel on a CUDA engine, its plain
version on a CPU one.  Its pool grows and the census reruns until its
own overflow counter is 0.  It sorts and chunks the batch as the JAX
package's engine does (the Morton sort above 8 cameras; pieces of
`render_chunk` cameras, whose size picks the live-union tile), so it
returns the JAX package's numbers although the port renders unchunked.
The geometry census reruns only where the poses changed; the item census
(the part mobj animation changes) runs on every state.

It covers the unsplit batch's sort only.  A batch split over devices
(parallel/mesh.py) sorts within each shard, so with union live lists
(paint_percam_compact=False) its tiles are not the census's, and its
renders are not shown drop-free; the JAX package has the same limit.

Results are cached on disk under a sha256 of the inputs
(DOOMTPU_CALIB_CACHE names the directory, =0 turns the cache off); the
key carries this package's tag, so the two packages never read each
other's entries.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from doomtpu_torch.config import RenderConfig
from doomtpu_torch.ops.paint import LIVE_BLOCK
from doomtpu_torch.render import camera as cam
from doomtpu_torch.render import things, walls
from doomtpu_torch.render.camsort import sort_perm, sort_state
from doomtpu_torch.render.jmath import as_i16

# bump when the census logic changes (invalidates every cache entry)
_CACHE_VERSION = 1
_CACHE_TAG = "doomtpu_torch"

# config fields that change the census result: chunking and tiling, the
# sort, which live peak is taken, the screen
_KEY_FIELDS = (
    "width", "height", "render_chunk", "camera_sort",
    "paint_percam_compact",
)
# the capacity fields a cache entry stores and re-applies
_OUT_FIELDS = (
    "span_capacity", "mid_capacity", "clip_capacity", "item_capacity",
    "max_visible_mobjs", "item_block_capacity", "paint_live_capacity",
)
# the census span pool's least first capacity
_MIN_SPAN = 64


def _cache_key(engine, states, margin_q) -> str:
    """sha256 over what the census depends on: the WAD bytes and map,
    the key config fields and the state arrays."""
    cfg = engine.config
    h = hashlib.sha256()
    h.update(f"{_CACHE_TAG};v{_CACHE_VERSION};{engine.tables.name};".encode())
    h.update(np.ascontiguousarray(engine.wad.data).tobytes())
    h.update(json.dumps(
        [getattr(cfg, f) for f in _KEY_FIELDS]
        + [cfg.item_block_capacity > 0, list(margin_q)]
    ).encode())
    for st in states:
        for t in (st.pos, st.angle, st.floor_height, st.mobj_state,
                  st.sector_light, st.timestamp):
            a = t.cpu().numpy()
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _cache_dir() -> str:
    return os.environ.get(
        "DOOMTPU_CALIB_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".calib_cache"),
    )


def _round_up(v: int, q: int) -> int:
    return max(q, ((int(v) + q - 1) // q) * q)


def _geom_census(cfg, level, px, py, angle, floor_height, tile,
                 sector_light, timestamp) -> dict:
    """Span / clip / mid pool peaks and live-list peaks of one pose
    chunk, and the mid pool the item census reads."""
    frame = cam.build_seg_frame(
        level, cfg, px, py, angle, floor_height, sector_light, timestamp
    )
    order = cam.seg_order(level, cam.traversal_rank(level, px, py))
    pool, cnt, overflow = walls.wall_scan(level, cfg, frame, order)
    spans = pool[0]                                     # [B, W, K]
    K = spans.shape[2]
    k_ok = torch.arange(K, device=px.device) < cnt[..., None]
    kind = (spans >> 29) & 3
    is_mid = k_ok & (kind == walls.KIND_MID)
    is_clip = is_mid | (k_ok & (kind == walls.KIND_WALL))

    # live-list census: the paint stage's predicate (active, and [x0, x1]
    # meets the 128-column block), in traversal order
    B, G = order.shape
    nbw = -(-cfg.width // LIVE_BLOCK)
    o = order.long()
    pact = torch.gather(frame["active"].any(-1), 1, o)
    x0 = torch.gather(as_i16(frame["x0"]), 1, o)[..., None]
    x1 = torch.gather(as_i16(frame["x1"]), 1, o)[..., None]
    wlo = torch.arange(nbw, device=px.device) * LIVE_BLOCK
    live = pact[..., None] & (x0 < wlo + LIVE_BLOCK) & (x1 >= wlo)
    cnt_cam = live.sum(1)                               # [B, NBW]
    if B % tile == 0 and tile > 1:
        cnt_uni = live.view(B // tile, tile, G, nbw).any(1).sum(1)
    else:
        cnt_uni = cnt_cam
    return {
        "span": int(cnt.max()),
        "mid": int(is_mid.sum(2).max()),
        "clip": int(is_clip.sum(2).max()),
        "overflow": int(overflow.sum()),
        "live_cam": int(cnt_cam.max()),
        "live_union": int(cnt_uni.max()),
        # the item census reads the mid pool: kept so that it need not
        # rerun the scan for every state
        "mid_pool": {"span": spans.transpose(1, 2),
                     "d6": pool[1][5].transpose(1, 2), "cnt": cnt},
    }


def _item_census(cfg, level, mid_pool, px, py, angle, floor_height,
                 sector_light, timestamp, mobj_state, tile) -> dict:
    frame = cam.build_seg_frame(
        level, cfg, px, py, angle, floor_height, sector_light, timestamp
    )
    out = things.item_census(
        level, cfg, frame, (None, mid_pool), px, py, angle, floor_height,
        sector_light, mobj_state, tile=tile,
    )
    return {
        "items": int(out["presence"].max()),
        "n_valid": int(out["n_valid"].max()),
        "items_block": int(out["presence_block"]),
    }


def calibrated_config(engine, states, margin_q=(8, 32),
                      cache=True) -> RenderConfig:
    """Measure capacity peaks over `states` and return engine.config
    with span / mid / clip / item / max_visible_mobjs /
    paint_live_capacity set (item_block_capacity too where the caller set
    it above 0).

    `states`: a GameState or a list of them, on the engine's device: the
    exact states the caller will render (ticked states too, if the
    workload ticks).  `margin_q`: the (pool, live cap) round-up quanta.
    `cache`: read and write the disk cache (see the module docstring).
    """
    if not isinstance(states, (list, tuple)):
        states = [states]
    cdir = _cache_dir()
    use_cache = cache and cdir != "0"
    if use_cache:
        key = _cache_key(engine, states, margin_q)
        path = os.path.join(cdir, key + ".json")
        try:
            with open(path) as f:
                entry = json.load(f)
            return dataclasses.replace(
                engine.config,
                **{f: int(entry[f]) for f in _OUT_FIELDS},
            )
        except (OSError, KeyError, ValueError):
            pass
    cfg = engine.config
    level = engine.level
    B = states[0].batch
    C = cfg.render_chunk
    chunked = B > C and B % C == 0
    tile = 8 if B % 8 == 0 else (4 if B % 4 == 0 else 1)
    if chunked:
        tile = 8 if C % 8 == 0 else (4 if C % 4 == 0 else 1)
    n_chunks = B // C if chunked else 1
    per = C if chunked else B

    peaks = dict.fromkeys(("span", "mid", "clip", "live_cam", "live_union",
                           "items", "n_valid", "items_block"), 0)
    span_cap = _round_up(max(cfg.span_capacity, _MIN_SPAN), 8)
    while True:
        ccfg = dataclasses.replace(
            cfg, span_capacity=span_cap, max_visible_mobjs=0,
            use_pallas_scan=False, use_pallas_paint=False,
            use_item_pass_kernel=False, paint_live_capacity=0,
        )
        overflow = 0
        prev_pose = None
        geos = {}
        for state in states:
            if cfg.camera_sort and B > 8:
                state, _ = sort_state(state, sort_perm(state.pos,
                                                       state.angle))
            pose = (state.pos, state.angle, state.floor_height)
            pose_changed = prev_pose is None or not all(
                torch.equal(a, b) for a, b in zip(pose, prev_pose)
            )
            prev_pose = pose
            for ci in range(n_chunks):
                sl = state.map(lambda a: a[ci * per:(ci + 1) * per])
                px, py = sl.pos[:, 0], sl.pos[:, 1]
                if pose_changed or ci not in geos:
                    geo = _geom_census(
                        ccfg, level, px, py, sl.angle, sl.floor_height,
                        tile, sl.sector_light, sl.timestamp,
                    )
                    geos[ci] = geo["mid_pool"]
                    for k in ("span", "mid", "clip", "live_cam",
                              "live_union"):
                        peaks[k] = max(peaks[k], geo[k])
                    overflow += geo["overflow"]
                it = _item_census(
                    ccfg, level, geos[ci], px, py, sl.angle,
                    sl.floor_height, sl.sector_light, sl.timestamp,
                    sl.mobj_state, tile,
                )
                for k in ("items", "n_valid", "items_block"):
                    peaks[k] = max(peaks[k], it[k])
        if overflow == 0:
            break
        span_cap *= 2          # the census pool itself clipped: grow, rerun
        peaks = dict.fromkeys(peaks, 0)

    pq, lq = margin_q
    live_peak = (
        peaks["live_cam"] if cfg.paint_percam_compact
        else peaks["live_union"]
    )
    out = dataclasses.replace(
        cfg,
        span_capacity=_round_up(peaks["span"], pq),
        mid_capacity=_round_up(peaks["mid"], pq),
        clip_capacity=_round_up(peaks["clip"], pq),
        item_capacity=_round_up(peaks["items"], pq),
        max_visible_mobjs=_round_up(peaks["n_valid"], 32),
        # the block emission is the JAX package's opt-in (the port has
        # none): its peak is substituted only where the caller asked for
        # it with a placeholder above 0, as there
        item_block_capacity=(
            _round_up(peaks["items_block"], pq)
            if cfg.item_block_capacity > 0 else 0
        ),
        # +1 forces a full quantum of headroom even at exact multiples
        paint_live_capacity=_round_up(live_peak + 1, lq),
    )
    if use_cache:
        try:
            os.makedirs(cdir, exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(
                    {f: getattr(out, f) for f in _OUT_FIELDS}
                    | {"peaks": peaks}, f,
                )
            os.replace(tmp, path)
        except OSError:
            pass
    return out
