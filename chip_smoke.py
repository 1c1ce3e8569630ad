#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, all started together), holds each kernel against its
plain PyTorch version on the card, drives the port's main paths on the
e1m1-scale fixture at 320x200 with 4096 spread cameras --
DoomEngine.render_walls (walls, planes, sky) and DoomEngine.render (the
full frame with sprites and masked mids) -- checks their output, then
times them.  Any failed phase raises, so the script exits non-zero
before its last line.  The last line is one JSON object naming the
device; the line before it lists every kernel with its launches, error,
times and bound.

It needs a CUDA card and fails without one: nothing moves to the CPU.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def spread_poses(t, n, seed=0):
    """Random valid camera poses spread over the map (bench.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    poses = []
    left, right, top, bottom = [float(v) for v in t.bbox]
    while len(poses) < n:
        x = rng.uniform(left, right)
        y = rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            poses.append((x, y, rng.uniform(0, 2 * math.pi)))
    return (
        np.asarray([(p[0], p[1]) for p in poses], np.float32),
        np.asarray([p[2] for p in poses], np.float32),
    )


def outputs_of(out: dict) -> dict:
    """Every kernel output of a paint result, by name."""
    named = {k: out[k] for k in ("idx", "ld", "rgb", "cnt_mid", "cnt_clip",
                                 "overflow")}
    for i, p in enumerate(out["midpool"]):
        named[f"midpool{i}"] = p
    for i, p in enumerate(out["clippool"]):
        named[f"clippool{i}"] = p
    return named


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of bytes over the HBM rate and
    operations over the float32 rate."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def profile_render(call, state, card, log, plain_ms) -> None:
    """torch.profiler over one warm call: kernel launches, device busy
    time (the union of kernel intervals) and device time by op.  The
    device's idle share is given against the ms per batch measured
    without the profiler (`plain_ms`), whose own overhead on every
    launch would count as idle time, and against the profiled call's
    wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    stats = prof.key_averages()
    launches = sum(e.count for e in stats if e.key == "cudaLaunchKernel")
    dev_ms = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / 1e3
    top = sorted(stats, key=dev_ms, reverse=True)[:8]
    log(f"profile of one render (torch.profiler): {launches} kernel "
        f"launches, device busy {busy_ms:.3f} ms; device idle share "
        f"{1 - busy_ms / plain_ms:.4f} of the {plain_ms:.3f} ms per batch "
        f"without the profiler ({1 - busy_ms / wall_ms:.4f} of the "
        f"{wall_ms:.3f} ms wall time with it on)  [{card}]")
    log("  device ms by op: " + json.dumps(
        {e.key[:60]: round(dev_ms(e), 3) for e in top}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script only runs on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.ops import build
    from doomtpu_torch.ops import items as items_mod
    from doomtpu_torch.ops import paint as paint_mod
    from doomtpu_torch.render import camera as cam
    from doomtpu_torch.render import things
    from doomtpu_torch.render.camsort import sort_state, unsort_out
    from doomtpu_torch.wad import synth

    composite = items_mod.composite_items

    # ---- 1. device and build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"nvcc: {build.nvcc_path() or 'not found'}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_libraries("paint", "items")
    for name in ("paint", "items"):
        build.load_library(name)
        log(f"build: {name}.cu (nvcc ended "
            f"{build.build_seconds.get(name, 0.0):.2f} s after the builds "
            f"started)")
        for line in build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build, both kernels in parallel: {time.perf_counter() - t0:.2f} s")

    def event_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    # ---- 2. each kernel against its plain version ---------------------------
    def new_game(eng, B, poses=None):
        pos, ang = spread_poses(eng.tables, B) if poses is None else poses
        return eng.new_game(B, pos=pos, angle=ang,
                            generator=torch.Generator(dev).manual_seed(0))

    def stage_inputs(eng, st, cfg=None):
        """Camera stage, order and paint inputs of a state."""
        lvl, cfg = eng.level, cfg or eng.config
        px, py = st.pos[:, 0], st.pos[:, 1]
        frame = cam.build_seg_frame(lvl, cfg, px, py, st.angle,
                                    st.floor_height, st.sector_light,
                                    st.timestamp)
        order = cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))
        args = paint_mod.build_inputs(lvl, cfg, frame, order, st.angle,
                                      px, py, st.floor_height)
        return frame, order, args

    def compare_paint(eng, args, label):
        lvl, cfg = eng.level, eng.config
        got = outputs_of(paint_mod.paint(lvl, cfg, *args))
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        ref = outputs_of(paint_mod.paint_reference(lvl, cfg, *args))
        b.record()
        torch.cuda.synchronize()
        worst, diffs = 0, {}
        for k in ref:
            d = (got[k] != ref[k]).sum().item()
            diffs[k] = d
            if d:
                worst = max(worst,
                            (got[k].long() - ref[k].long()).abs().max().item())
        log(f"paint {label}: differing elements per output {json.dumps(diffs)}")
        check(all(v == 0 for v in diffs.values()),
              f"paint {label}: kernel differs from paint_reference")
        log(f"  peak pool use per column: mid {got['cnt_mid'].max().item()} "
            f"of {cfg.mid_capacity}, clip {got['cnt_clip'].max().item()} "
            f"of {cfg.clip_capacity}")
        return worst, a.elapsed_time(b)

    def item_inputs(eng, st, frame, order, out, cfg):
        """(ipool, icnt, daux, clip pool) of the deferred pass."""
        pools = things.pools_from_paint(out)
        ipool, icnt, daux = things.item_pool(
            eng.level, cfg, frame, pools, order, st.pos[:, 0], st.pos[:, 1],
            st.angle, st.floor_height, st.sector_light, st.mobj_state)
        return ipool, icnt, daux, pools[0]

    def compare_items(eng, cfg, ipool, icnt, bg, clip, label):
        lvl = eng.level
        fresh = lambda: [x.clone() for x in bg]
        got = composite(lvl, cfg, ipool, icnt, *fresh(), clip=clip)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ref_in = fresh()
        a.record()
        ref = items_mod.composite_items_reference(lvl, cfg, ipool, icnt,
                                                  *ref_in, clip=clip)
        b.record()
        torch.cuda.synchronize()
        worst, diffs = 0, {}
        for k, g, r in zip(("idx", "ld", "rgb"), got, ref):
            d = (g != r).sum().item()
            diffs[k] = d
            if d:
                worst = max(worst, (g.long() - r.long()).abs().max().item())
        drawn = int((got[0] != bg[0]).sum())
        log(f"items {label}: differing elements per output "
            f"{json.dumps(diffs)}; pixels the items changed {drawn}; peak "
            f"slots per column {int(icnt.max())} of {cfg.item_capacity}")
        check(all(v == 0 for v in diffs.values()),
              f"items {label}: kernel differs from composite_items_reference")
        check(drawn > 0, f"items {label}: no item drew anything")
        return worst, a.elapsed_time(b)

    def check_items(eng, st, cfg, label):
        frame, order, args = stage_inputs(eng, st, cfg)
        out = paint_mod.paint(eng.level, cfg, *args)
        ipool, icnt, _, clip = item_inputs(eng, st, frame, order, out, cfg)
        bg = [out[k] for k in ("idx", "ld", "rgb")]
        return compare_items(eng, cfg, ipool, icnt, bg, clip, label)[0]

    demo = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", device=dev)
    views = [(384.0, 256.0, 0.0), (900.0, 256.0, 2.5), (300.0, 700.0, 4.6),
             (384.0, 256.0, 3.1)] * 2
    demo_poses = (np.asarray([v[:2] for v in views], np.float32),
                  np.asarray([v[2] for v in views], np.float32))
    demo_st = new_game(demo, 8, demo_poses)
    err_paint, _ = compare_paint(demo, stage_inputs(demo, demo_st)[2],
                                 "demo B=8")
    err_items = 0
    for ki in (8, 24):
        err_items = max(err_items, check_items(
            demo, demo_st, RenderConfig(item_capacity=ki),
            f"demo B=8 item_capacity={ki}"))

    # spread poses need deeper pools than the defaults (mid 8 / clip 24 /
    # item 8): this script's own config, the library defaults stay as
    # they are.  Item capacity 24 is the TPU bench's calibrated value.
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24)
    log(f"config: {cfg.width}x{cfg.height} mid_capacity={cfg.mid_capacity} "
        f"clip_capacity={cfg.clip_capacity} item_capacity={cfg.item_capacity} "
        f"render_chunk={cfg.render_chunk} camera_sort={cfg.camera_sort}")
    e1 = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1", config=cfg,
                                   device=dev)
    st32 = new_game(e1, 32)
    args32 = stage_inputs(e1, st32)[2]
    err_paint = max(err_paint, compare_paint(e1, args32, "e1m1-scale B=32")[0])
    err_items = max(err_items, check_items(e1, st32, cfg,
                                           "e1m1-scale B=32"))
    # textures wider than 128 and ~48 flats take the kernels' other paths
    d1 = DoomEngine.from_wad_bytes(synth.doom1_scale_wad(), "e1m1",
                                   config=cfg, device=dev)
    check(d1.level.texq_wide, "doom1-asset-scale has no wide textures")
    st16 = new_game(d1, 16)
    err_paint = max(err_paint, compare_paint(
        d1, stage_inputs(d1, st16)[2], "doom1-asset-scale B=16")[0])
    err_items = max(err_items, check_items(d1, st16, cfg,
                                           "doom1-asset-scale B=16"))

    kern_ms32 = event_ms(lambda: paint_mod.paint(e1.level, cfg, *args32), 20)
    plain_ms32 = event_ms(
        lambda: paint_mod.paint_reference(e1.level, cfg, *args32), 2)
    log(f"paint at e1m1-scale B=32: kernel {kern_ms32:.4f} ms, plain "
        f"PyTorch {plain_ms32:.2f} ms  [{card}]")

    # ---- 3. the main paths at full size --------------------------------------
    B = 4096
    t0 = time.perf_counter()
    state = new_game(e1, B)
    torch.cuda.synchronize()
    log(f"B={B} spread poses + new_game: {time.perf_counter() - t0:.2f} s")
    sel = torch.linspace(0, B - 1, 16).long().to(dev)
    cpu_eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device="cpu")
    cpu_state = state.map(lambda x: x[sel].cpu())

    def check_frames(idx, rgb, what):
        check(idx.is_cuda and rgb.is_cuda, f"{what}: outputs not on the card")
        check(tuple(idx.shape) == (B, cfg.height, cfg.width)
              and tuple(rgb.shape) == (B, cfg.height, cfg.width),
              f"{what}: output shapes {tuple(idx.shape)} {tuple(rgb.shape)}")
        check(idx.dtype == torch.int32 and rgb.dtype == torch.int32,
              f"{what}: dtypes")
        written = (idx >= 0).float().mean().item()
        log(f"{what}: written share {written:.6f}; idx range "
            f"[{idx.min().item()}, {idx.max().item()}]; rgb nonzero share "
            f"{(rgb != 0).float().mean().item():.6f}")
        check(int(idx.max()) <= 255 and int(idx.min()) >= -1,
              f"{what}: idx out of range")
        check(written > 0.9, f"{what}: most pixels unwritten")
        check(bool(((rgb >= 0) & (rgb <= 0xFFFFFF)).all()),
              f"{what}: rgb not packed RGB")

    def against_cpu(idx, rgb, cpu_call, what):
        """16 cameras against the CPU port (the plain versions, which the
        CPU tests hold against the JAX package)."""
        t0 = time.perf_counter()
        idx_c, rgb_c = cpu_call(cpu_state)
        d_idx = (idx[sel].cpu() != idx_c).sum().item()
        d_rgb = (rgb[sel].cpu() != rgb_c).sum().item()
        log(f"{what}: 16 cameras vs the CPU port "
            f"({time.perf_counter() - t0:.1f} s): differing idx {d_idx}, "
            f"rgb {d_rgb}")
        check(d_idx == 0 and d_rgb == 0, f"{what}: card and CPU port disagree")

    # 3a. render_walls (slice 1's path)
    paint_mod.paint.launches = 0
    composite.launches = 0
    widx, wrgb = e1.render_walls(state)
    torch.cuda.synchronize()
    walls_launches = {"paint": paint_mod.paint.launches,
                      "items": composite.launches}
    log(f"main path render_walls B={B}: launches {walls_launches}")
    check(walls_launches["paint"] > 0,
          "render_walls never launched the paint kernel")
    check_frames(widx, wrgb, "render_walls")
    counters = e1.render_walls_counters(state)
    log(f"render_walls_counters: {counters}")
    check(all(v == 0 for v in counters.values()),
          f"render_walls capacity counters not 0: {counters}")
    against_cpu(widx, wrgb, cpu_eng.render_walls, "render_walls")

    # 3b. render (this slice's path: the full frame)
    paint_mod.paint.launches = 0
    composite.launches = 0
    idx, rgb = e1.render(state)
    torch.cuda.synchronize()
    launches = {"paint": paint_mod.paint.launches,
                "items": composite.launches}
    log(f"main path render B={B}: launches {launches}")
    check(launches["paint"] > 0, "render never launched the paint kernel")
    check(launches["items"] > 0, "render never launched the item kernel")
    check_frames(idx, rgb, "render")
    changed = (idx != widx).float().mean().item()
    log(f"render: share of pixels the items changed {changed:.6f}")
    check(changed > 0.01, "the items drew almost nothing")
    counters = e1.render_counters(state)
    log(f"render_counters: {counters}")
    check(all(v == 0 for v in counters.values()),
          f"render capacity counters not 0: {counters}")
    against_cpu(idx, rgb, cpu_eng.render, "render")

    # ---- 4. timing: warm once, 5 timed calls, synchronize, host checksum ---
    def time_path(call, what):
        out = call(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            out = call(state)
        torch.cuda.synchronize()
        checksum = int(out[1].sum().item())
        dt = (time.perf_counter() - t0) / 5
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"{what} e1m1-scale 320x200 B={B}: {dt * 1e3:.3f} ms/batch, "
            f"{B / dt:.1f} frames/s, peak {peak:.2f} GiB, checksum "
            f"{checksum}  [{card}]")
        return dt * 1e3

    time_path(e1.render_walls, "render_walls")
    render_ms = time_path(e1.render, "render")
    profile_render(e1.render, state, card, log, render_ms)

    # where the time goes: each stage alone on the Morton-sorted batch
    sp, _ = sort_state(state)
    lvl = e1.level
    px, py = sp.pos[:, 0], sp.pos[:, 1]
    stage = {}
    stage["camera stage + order"] = event_ms(lambda: (
        cam.build_seg_frame(lvl, cfg, px, py, sp.angle, sp.floor_height,
                            sp.sector_light, sp.timestamp),
        cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))), 3)
    frame, order, args_full = stage_inputs(e1, sp)
    stage["paint input build"] = event_ms(lambda: paint_mod.build_inputs(
        lvl, cfg, frame, order, sp.angle, px, py, sp.floor_height), 3)
    stage["paint kernel"] = event_ms(
        lambda: paint_mod.paint(lvl, cfg, *args_full), 5)
    out = paint_mod.paint(lvl, cfg, *args_full)
    stage["deferred pass (item pool)"] = event_ms(
        lambda: item_inputs(e1, sp, frame, order, out, cfg), 3)
    ipool, icnt, daux, clip = item_inputs(e1, sp, frame, order, out, cfg)

    # the item pool's one pass over the batch against the same work in
    # chunks of cameras: time and the memory its temporaries take
    pools = things.pools_from_paint(out)

    def pool_in_chunks(C):
        for c0 in range(0, B, C):
            cut = lambda d: {k: v[c0:c0 + C] for k, v in d.items()}
            things.item_pool(
                lvl, cfg, cut(frame), (cut(pools[0]), cut(pools[1])),
                order[c0:c0 + C], px[c0:c0 + C], py[c0:c0 + C],
                sp.angle[c0:c0 + C], sp.floor_height[c0:c0 + C],
                sp.sector_light[c0:c0 + C], sp.mobj_state[c0:c0 + C])

    for C in (B, 1366, cfg.render_chunk):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = event_ms(lambda: pool_in_chunks(C), 3)
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        log(f"item pool in chunks of {C} cameras: {ms:.4f} ms, temporaries "
            f"{extra:.2f} GiB above the {base / 2 ** 30:.2f} GiB held  "
            f"[{card}]")
    bg = [out[k] for k in ("idx", "ld", "rgb")]
    item_ms = []
    for _ in range(6):
        fresh = [x.clone() for x in bg]
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        composite(lvl, cfg, ipool, icnt, *fresh, clip=clip)
        b.record()
        torch.cuda.synchronize()
        item_ms.append(a.elapsed_time(b))
    stage["item kernel"] = sum(item_ms[1:]) / 5
    stage["sort + unsort"] = event_ms(
        lambda: unsort_out((idx, rgb), sort_state(state)[1]), 3)
    log(f"stages at B={B} (CUDA events, ms): " + json.dumps(
        {k: round(v, 4) for k, v in stage.items()}) + f"  [{card}]")
    scnt = args_full[1]
    log(f"active segs per camera: mean {scnt.float().mean().item():.1f}, max "
        f"{scnt.max().item()} of {lvl.num_segs}")
    peak_items = int(daux["item_peak"].max())
    log(f"item slots per column: peak {int(icnt.max())} of "
        f"{cfg.item_capacity}; uncapped peak {peak_items}; mean over "
        f"columns with items {icnt[icnt > 0].float().mean().item():.2f}")
    check(peak_items <= cfg.item_capacity,
          f"item_capacity {cfg.item_capacity} below the uncapped peak "
          f"{peak_items}")

    # ---- 5. the kernels against their plain versions on the main path's
    # own inputs
    err, paint_plain_ms = compare_paint(e1, args_full,
                                        f"e1m1-scale B={B} main-path inputs")
    err_paint = max(err_paint, err)
    err, items_plain_ms = compare_items(e1, cfg, ipool, icnt, bg, clip,
                                        f"e1m1-scale B={B} main-path inputs")
    err_items = max(err_items, err)
    log(f"paint at B={B}: kernel {stage['paint kernel']:.4f} ms, plain "
        f"PyTorch {paint_plain_ms:.2f} ms (one call)  [{card}]")
    log(f"items at B={B}: kernel {stage['item kernel']:.4f} ms, plain "
        f"PyTorch {items_plain_ms:.2f} ms (one call)  [{card}]")

    # ---- 6. bounds: what these inputs need moved and computed ---------------
    # paint: the rows of the active segs, the per-camera scalars and the
    # tables read once; the frame planes and counts written whole, the
    # pools only in their occupied slots (nothing reads past a column's
    # count).  Operations, counted loosely from above: ~40 per (column,
    # visited seg) and ~20 per pixel.
    nb = lambda t: t.numel() * t.element_size()
    p_in = (int(scnt.sum()) * paint_mod.NR * 4 + nb(scnt) + nb(args_full[2])
            + nb(args_full[3]) + sum(nb(getattr(lvl, k)) for k in (
                "tex_pixels", "flat_pixels", "sky_pixels", "palette_packed")))
    mid_used = int(torch.clamp(out["cnt_mid"], max=cfg.mid_capacity).sum())
    clip_used = int(torch.clamp(out["cnt_clip"], max=cfg.clip_capacity).sum())
    p_out = (sum(nb(out[k]) for k in ("idx", "ld", "rgb", "cnt_mid",
                                      "cnt_clip", "overflow"))
             + (mid_used * len(out["midpool"])
                + clip_used * len(out["clippool"])) * 4)
    p_ops = (40.0 * float(scnt.sum()) * cfg.width
             + 20.0 * B * cfg.height * cfg.width)
    paint_bound, paint_by = bound(p_in + p_out, p_ops)
    # items: the pool words of the occupied slots, the clip records of
    # the columns that hold a sprite, the counts and the atlas read once;
    # idx / ld / rgb written once where the items changed them.
    # Operations: 3 per (slot, row) of the fold (divide, multiply, add),
    # ~8 per clip test of a sprite slot, ~8 per shaded pixel.
    occupied = torch.arange(cfg.item_capacity, device=dev)[None, :, None] \
        < icnt[:, None, :]
    spr = occupied & ((ipool[0] & items_mod.SPR_MARK) != 0)
    n_slots, n_spr = int(occupied.sum()), int(spr.sum())
    spr_cols = spr.any(1)
    ccnt = clip["cnt"]
    clip_recs = int(ccnt[spr_cols].sum())
    clip_tests = int((spr.sum(1) * ccnt).sum())
    words = items_mod.clipped_words(ipool, clip, cfg.height)
    ct = torch.clamp(((words >> 16) & 0x1FF) - 1, min=0)
    cb = torch.clamp(((words << 16) >> 16) - 1, max=cfg.height - 1)
    fold_rows = int(torch.where(occupied, torch.clamp(cb - ct + 1, min=0),
                                0).sum())
    got = composite(lvl, cfg, ipool, icnt, *[x.clone() for x in bg], clip=clip)
    touched = int(((got[0] != bg[0]) | (got[1] != bg[1])
                   | (got[2] != bg[2])).sum())
    i_in = (n_slots * 6 * 4 + n_spr * 2 * 4 + clip_recs * 6 * 4
            + nb(icnt) + int(spr_cols.sum()) * 4 + nb(lvl.atlas_cm)
            + nb(lvl.palette_packed))
    i_out = touched * 3 * 4
    i_ops = 3.0 * fold_rows + 8.0 * clip_tests + 8.0 * touched
    items_bound, items_by = bound(i_in + i_out, i_ops)
    log(f"bound paint: {p_in + p_out} bytes ({mid_used} mid and "
        f"{clip_used} clip pool slots used), ~{p_ops:.4g} operations -> "
        f"{paint_bound:.4f} ms ({paint_by})")
    log(f"bound items: {i_in + i_out} bytes ({n_slots} occupied slots, "
        f"{clip_recs} clip records, {touched} pixels written), "
        f"~{i_ops:.4g} operations ({fold_rows} fold rows, {clip_tests} clip "
        f"tests) -> {items_bound:.4f} ms ({items_by})")

    check(not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                  for m in sys.modules), "jax was imported")
    check(not any(m == "doomtpu" or m.startswith("doomtpu.")
                  for m in sys.modules), "the JAX package doomtpu was imported")
    log(json.dumps({"kernels": [
        {
            "name": "paint", "route": "cuda",
            "source": "doomtpu_torch/ops/csrc/paint.cu",
            "replaces": "doomtpu/ops/pallas_paint.py:326",
            "launches": launches["paint"], "max_abs_err": err_paint,
            "ms": stage["paint kernel"], "plain_ms": paint_plain_ms,
            "bound_ms": paint_bound, "bound_by": paint_by,
            "library_ms": None,
        },
        {
            "name": "items", "route": "cuda",
            "source": "doomtpu_torch/ops/csrc/items.cu",
            "replaces": "doomtpu/ops/pallas_items.py:245",
            "launches": launches["items"], "max_abs_err": err_items,
            "ms": stage["item kernel"], "plain_ms": items_plain_ms,
            "bound_ms": items_bound, "bound_by": items_by,
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
