#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, drives the
port's main path (DoomEngine.render_walls on the e1m1-scale fixture at
320x200, 4096 spread cameras) and checks its output, then times it.
Any failed phase raises, so the script exits non-zero before its last
line.  The last line is one JSON object naming the device; the line
before it lists every kernel with its launches, error and times.

It needs a CUDA card and fails without one: nothing moves to the CPU.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script only runs on "
              "the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from doomtpu.config import RenderConfig
    from doomtpu.wad import synth
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.ops import build
    from doomtpu_torch.ops import paint as paint_mod
    from doomtpu_torch.render import camera as cam
    from doomtpu_torch.render.camsort import sort_state, unsort_out

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
    try:
        import triton  # noqa: F401
        has_triton = f"yes ({triton.__version__})"
    except ImportError:
        has_triton = "no"
    log(f"nvcc: {build.nvcc_path() or 'not found'}; triton: {has_triton}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load_library("paint")
    log(f"build: paint.cu {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds.get('paint', 0.0):.2f} s)")
    for line in build.build_log.get("paint", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 2. kernel against its plain version -----------------------------
    def new_game(eng, B, poses=None):
        pos, ang = spread_poses(eng.tables, B) if poses is None else poses
        return eng.new_game(B, pos=pos, angle=ang,
                            generator=torch.Generator(dev).manual_seed(0))

    def paint_inputs(eng, st):
        lvl, cfg = eng.level, eng.config
        px, py = st.pos[:, 0], st.pos[:, 1]
        frame = cam.build_seg_frame(lvl, cfg, px, py, st.angle,
                                    st.floor_height, st.sector_light,
                                    st.timestamp)
        order = cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))
        return paint_mod.build_inputs(lvl, cfg, frame, order, st.angle,
                                      px, py, st.floor_height)

    def compare(eng, args, label):
        lvl, cfg = eng.level, eng.config
        got = outputs_of(paint_mod.paint(lvl, cfg, *args))
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        ref = outputs_of(paint_mod.paint_reference(lvl, cfg, *args))
        b.record()
        torch.cuda.synchronize()
        worst = 0
        diffs = {}
        for k in ref:
            d = (got[k] != ref[k]).sum().item()
            diffs[k] = d
            if d:
                worst = max(worst, (got[k].long() - ref[k].long()).abs().max().item())
        log(f"{label}: differing elements per output {json.dumps(diffs)}")
        check(all(v == 0 for v in diffs.values()),
              f"{label}: kernel differs from paint_reference")
        log(f"  peak pool use per column: mid {got['cnt_mid'].max().item()} "
            f"of {cfg.mid_capacity}, clip {got['cnt_clip'].max().item()} "
            f"of {cfg.clip_capacity}")
        return worst, a.elapsed_time(b)

    demo = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", device=dev)
    views = [(384.0, 256.0, 0.0), (900.0, 256.0, 2.5), (300.0, 700.0, 4.6),
             (384.0, 256.0, 3.1)] * 2
    demo_poses = (np.asarray([v[:2] for v in views], np.float32),
                  np.asarray([v[2] for v in views], np.float32))
    max_err, _ = compare(
        demo, paint_inputs(demo, new_game(demo, 8, demo_poses)), "demo B=8")

    # spread poses need deeper pools than the defaults (mid 8 / clip 24):
    # this script's own config, the library defaults stay as they are
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64)
    log(f"config: {cfg.width}x{cfg.height} mid_capacity={cfg.mid_capacity} "
        f"clip_capacity={cfg.clip_capacity} camera_sort={cfg.camera_sort}")
    e1 = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1", config=cfg,
                                   device=dev)
    args32 = paint_inputs(e1, new_game(e1, 32))
    max_err = max(max_err, compare(e1, args32, "e1m1-scale B=32")[0])
    # textures wider than 128 and ~48 flats take the kernel's other paths
    d1 = DoomEngine.from_wad_bytes(synth.doom1_scale_wad(), "e1m1",
                                   config=cfg, device=dev)
    check(d1.level.texq_wide, "doom1-asset-scale has no wide textures")
    max_err = max(max_err, compare(d1, paint_inputs(d1, new_game(d1, 16)),
                                   "doom1-asset-scale B=16")[0])

    # kernel and plain version timed on the same B=32 inputs (CUDA events)
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

    kern_ms32 = event_ms(lambda: paint_mod.paint(e1.level, cfg, *args32), 20)
    plain_ms32 = event_ms(
        lambda: paint_mod.paint_reference(e1.level, cfg, *args32), 2)
    log(f"paint at e1m1-scale B=32: kernel {kern_ms32:.4f} ms, plain "
        f"PyTorch {plain_ms32:.2f} ms  [{card}]")

    # ---- 3. the slice at full size ----------------------------------------
    B = 4096
    t0 = time.perf_counter()
    state = new_game(e1, B)
    torch.cuda.synchronize()
    log(f"B={B} spread poses + new_game: {time.perf_counter() - t0:.2f} s")

    paint_mod.paint.launches = 0
    idx, rgb = e1.render_walls(state)
    torch.cuda.synchronize()
    launches = paint_mod.paint.launches
    log(f"main path: render_walls B={B}: paint launches {launches}")
    check(launches > 0, "the main path never launched the paint kernel")
    check(idx.is_cuda and rgb.is_cuda, "outputs are not on the card")
    check(tuple(idx.shape) == (B, cfg.height, cfg.width)
          and tuple(rgb.shape) == (B, cfg.height, cfg.width),
          f"output shapes {tuple(idx.shape)} {tuple(rgb.shape)}")
    check(idx.dtype == torch.int32 and rgb.dtype == torch.int32, "dtypes")
    written = (idx >= 0).float().mean().item()
    log(f"written share {written:.6f}; idx range [{idx.min().item()}, "
        f"{idx.max().item()}]; rgb nonzero share "
        f"{(rgb != 0).float().mean().item():.6f}")
    check(int(idx.max()) <= 255 and int(idx.min()) >= -1, "idx out of range")
    check(written > 0.9, "most pixels unwritten")
    check(bool(((rgb >= 0) & (rgb <= 0xFFFFFF)).all()), "rgb not packed RGB")
    counters = e1.render_walls_counters(state)
    log(f"render_walls_counters: {counters}")
    check(all(v == 0 for v in counters.values()),
          f"capacity counters not 0: {counters}")

    # 16 cameras against the CPU port (camera stage + paint_reference,
    # which the CPU tests hold against the JAX package)
    sel = torch.linspace(0, B - 1, 16).long().to(dev)
    cpu_eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device="cpu")
    t0 = time.perf_counter()
    idx_c, rgb_c = cpu_eng.render_walls(state.map(lambda x: x[sel].cpu()))
    d_idx = (idx[sel].cpu() != idx_c).sum().item()
    d_rgb = (rgb[sel].cpu() != rgb_c).sum().item()
    log(f"16 cameras vs the CPU port ({time.perf_counter() - t0:.1f} s): "
        f"differing idx {d_idx}, rgb {d_rgb}")
    check(d_idx == 0 and d_rgb == 0, "card and CPU port disagree")

    # timing: warm once, 5 timed calls, synchronize, host checksum
    out = e1.render_walls(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        out = e1.render_walls(state)
    torch.cuda.synchronize()
    checksum = int(out[1].sum().item())
    dt = (time.perf_counter() - t0) / 5
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"render_walls e1m1-scale 320x200 B={B}: {dt * 1e3:.3f} ms/batch, "
        f"{B / dt:.1f} frames/s, peak {peak:.2f} GiB, checksum {checksum}  "
        f"[{card}]")
    # where the time goes: each stage alone on the Morton-sorted batch
    sp, _ = sort_state(state)
    lvl = e1.level
    px, py = sp.pos[:, 0], sp.pos[:, 1]
    stage = {}
    stage["camera stage + order"] = event_ms(lambda: (
        cam.build_seg_frame(lvl, cfg, px, py, sp.angle, sp.floor_height,
                            sp.sector_light, sp.timestamp),
        cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))), 3)
    frame = cam.build_seg_frame(lvl, cfg, px, py, sp.angle, sp.floor_height,
                                sp.sector_light, sp.timestamp)
    order = cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))
    stage["paint input build"] = event_ms(lambda: paint_mod.build_inputs(
        lvl, cfg, frame, order, sp.angle, px, py, sp.floor_height), 3)
    args_full = paint_mod.build_inputs(lvl, cfg, frame, order, sp.angle, px,
                                       py, sp.floor_height)
    stage["paint kernel"] = event_ms(
        lambda: paint_mod.paint(lvl, cfg, *args_full), 5)
    stage["sort + unsort"] = event_ms(
        lambda: unsort_out(out, sort_state(state)[1]), 3)
    log(f"stages at B={B} (CUDA events, ms): " + json.dumps(
        {k: round(v, 4) for k, v in stage.items()}) + f"  [{card}]")
    log(f"active segs per camera: mean "
        f"{args_full[1].float().mean().item():.1f}, max "
        f"{args_full[1].max().item()} of {lvl.num_segs}")

    # the kernel against its plain version on the main path's own inputs
    err, plain_ms = compare(e1, args_full,
                            f"e1m1-scale B={B} main-path inputs")
    max_err = max(max_err, err)
    log(f"paint at e1m1-scale B={B}: kernel {stage['paint kernel']:.4f} ms, "
        f"plain PyTorch {plain_ms:.2f} ms (one call)  [{card}]")

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    log(json.dumps({"kernels": [{
        "name": "paint", "route": "cuda",
        "source": "doomtpu_torch/ops/csrc/paint.cu",
        "replaces": "doomtpu/ops/pallas_paint.py:326",
        "launches": launches, "max_abs_err": max_err,
        "ms": stage["paint kernel"], "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
