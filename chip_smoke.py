#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels and their cost probes from the sources
in this checkout (one nvcc per source, all started together) and
reports each build's resources (registers, spills, shared memory,
blocks an SM; a spill fails the run).  Then it holds each kernel
against its plain PyTorch version on the card (the paint kernel also
under a live-seg cap that drops segs; the resolve kernel also under a
sky with transparent texels; every kernel at 320x200, 320x768 and
1024x200; the item kernel also on a WAD whose masked mid is 256
rows tall, rendered against the CPU port; the emission kernel at item
capacity 1, 8 and 24 and on the paint, the JAX-layout and the scan mid
pools), then the Hopper probes P1-P4
(ops/probe_visit.py, ops/probe_ybounds.py: each probe kernel against
its plain version, then the probes' own path with its counts set to 0
just before and read just after: every P1 construct timed at both
launch shapes beside its SASS bound, the price of a tensor-core field
product with w in registers against w from shared memory, P2's and
P3's one-hot exactness beside torch.matmul's, their times in turns with
torch.matmul and their price of a field product at full-card
occupancy, P4's row-bound modes serial and over the full card; and the
native picture
decoder, built with the host C++ compiler, on four WADs' pictures), and
drives the port's main paths with 4096 spread cameras at 320x200, the
paint path asked for
(`use_pallas_paint=True`), each with the launch counts set to 0 just
before it and read just after, so a path that took another pipeline
fails:

- e1m1-scale (paint-eligible): DoomEngine.render_walls (walls, planes,
  sky through the paint kernel) and DoomEngine.render (the full frame:
  the emission and item kernels too), with the deferred pass's stage
  table (selection and packs, emission, item kernel) and the emission
  against its byte bound;
- e1m1-scale under a live-seg cap set from the measured live peak:
  render through the paint kernel with its drop mask, live_dropped 0,
  the uncapped frames;
- e1m1-scale-masked (GRATE on some solid walls, so the paint kernel
  does not take it): render_walls and render through the wall-scan
  kernel and the resolve kernel (its winner fold, texel fetch and
  shade; timed alone at B=2048 and 4096), then the item kernel;
- e1m1-scale with use_item_pass_kernel: render through the paint kernel
  and the item-pass kernel, which draws every selected item (no item
  pool, no item cap);
- e1m1-scale rollouts (DoomEngine.rollout, T=32 ticks of zero controls,
  checksums, per-camera live lists under the live-seg cap), with and
  without cross-tick live-list reuse: the paint and item kernels once a
  tick, live_stale 0, equal checksums, every counter of the final state
  0; then 16 cameras of moving controls through a reuse rollout (stale
  segs, so the paint kernel reads drop bits the reuse set) and a scan +
  resolve rollout (the wall-scan kernel), each against the CPU port;
- e1m1-scale calibration (DoomEngine.calibrate over bench.py's 33-state
  chain of zero controls, cache off): the census's wall scan launches
  the wall-scan kernel; every counter 0 under the calibrated config on
  chain states 0, 16 and 32 on both pipelines; the card's calibrated
  config equal to the CPU port's on 16 cameras x 4 states; render timed
  at the calibrated pools beside the hand pools, same frames;
- the batch split (doomtpu_torch/parallel): 64 cameras in two shards on
  [cuda:0, cuda:0], render, both counter calls and a 4-tick live-reuse
  rollout equal to the unsplit engine's;
- the shell: `python -m doomtpu_torch.cli --synth demo --walk --steps 35
  --out <tmp>.npy` in a process of its own, its dump equal to the
  engine's frame after the same ticks.

It checks their output against the CPU port on 16 cameras, then times
them.  The cells also run the cost probes (the paint, item-pass and
wall-scan kernels built at PAINT_PROBE, ITEMPASS_PROBE and SCAN_PROBE
levels, see their sources) and time the paint, item and item-pass
kernels at 1 to 16 threads a column and the wall scan at 32 to 128
columns a block.  Any failed phase raises, so the script exits non-zero
before its last line.  The last line is one JSON object naming the
device; the line before it lists every kernel with its launches, error,
times and bound, and the one before that the probe builds' resources.

It needs a CUDA card and fails without one: nothing moves to the CPU.

    python3 chip_smoke.py --ab ROOT_A ROOT_B

times the e1m1-scale cell's render_walls and render through the port in
two checkouts (say, a parent commit unpacked under build/ and this
tree) on the same card, alternating A B B A, one process per timing.

    python3 chip_smoke.py --ab-exact ROOT_A ROOT_B [ROOT_C ...]

times P1's seven tensor-core constructs at both launch shapes, P2 and
P3 (one copy in turns with torch.matmul, device-paced and eager; the
price of a field at full-card occupancy where the checkout has it) and
P4's six modes (serial, and at the full-card chunking where the
checkout has it) the same way through each checkout, by this script's
own timing code.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

# the card's published peaks (H100 SXM data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores and dense TF32 tensor-core
# operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# the Hopper probes' libraries (ops/probe_visit.py, ops/probe_ybounds.py)
PROBE_LIBS = ("probe_visit", "probe_ybounds")
B = 4096
T0 = time.perf_counter()
# band heights the probe times the paint and item kernels at (at 200
# rows: 1, 2, 4, 8 and 16 threads a column)
BAND_SWEEP = (200, 100, 50, 25, 13)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def phase(name: str) -> None:
    log(f"---- {name} ({time.perf_counter() - T0:.1f} s into the run)")


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


def sky_masked(level):
    """The level with transparent texels in its sky texture (every other
    column of its first 64 rows): the resolve's masked-sky fetch."""
    TW, R = level.tex_pixels.shape[2], level.atlas_rows
    atlas = level.atlas_cm.clone()
    sky = atlas[level.sky_tex * TW * R:(level.sky_tex + 1) * TW * R]
    sky.view(TW, R)[::2, :64] &= ~0x100
    return dataclasses.replace(level, atlas_cm=atlas, sky_is_opaque=False)


def tall_atlas(level, ipool, rows=256):
    """(level, ipool) for K2 at atlas_rows > 128: the level's column
    atlas re-laid `rows` rows a column (each column's rows repeated) and
    the item pool with every slot's picture height doubled, so the fold
    reads atlas rows past 128."""
    import torch

    cols = level.atlas_cm.view(-1, level.atlas_rows)
    reps = -(-rows // level.atlas_rows)
    cm = cols.repeat(1, reps)[:, :rows].contiguous().view(-1)
    ip = ipool.clone()
    th = (ip[3] << 16) >> 16
    ip[3] = (ip[3] & -65536) | (torch.clamp(th * 2, max=rows) & 0xFFFF)
    return dataclasses.replace(level, atlas_cm=cm, atlas_rows=rows), ip


def tall_mid_wad(synth, builder, rows_128_255=0) -> bytes:
    """Two rooms 320 high, the portal between them hung with TALLMID: a
    64x256 masked texture (grate, step, then the patch `rows_128_255`
    over rows 128-255, then grate) from TEXTURE2, so the level's column
    atlas holds 256 rows; a barrel and a lamp.  Built with the given
    package's synth and builder modules (the port's here, either
    package's in tests/test_torch_faults.py)."""
    rooms = [
        synth.RoomSpec(0, 0, 512, 512, floor_h=0, ceil_h=320, light=200,
                       mid_tex="TALLMID"),
        synth.RoomSpec(512, 0, 1024, 512, floor_h=0, ceil_h=320, light=160,
                       floor_flat="FLOOR2"),
    ]
    things = [synth.ThingSpec(96, 256, 0, 1),
              synth.ThingSpec(700, 200, 180, 2035),
              synth.ThingSpec(400, 320, 90, 2028)]
    b = builder.WadBuilder("IWAD")
    synth.standard_assets(b)
    # PNAMES: 0 PWALL, 1 PSTEP, 2 PGRATE, 4 PWIDE
    b.add("TEXTURE2", builder.encode_texture1([
        {"name": "TALLMID", "width": 64, "height": 256,
         "patches": [(0, 0, 2), (0, 64, 1), (0, 128, rows_128_255),
                     (0, 192, 2)]},
    ]))
    lb = synth.LevelBuilder(rooms, things)
    lb.build_walls()
    lb.build_bsp()
    lumps = lb.lumps()
    b.add("E1M1")
    for name in ("THINGS", "LINEDEFS", "SIDEDEFS", "VERTEXES", "SEGS",
                 "SSECTORS", "NODES", "SECTORS", "REJECT", "BLOCKMAP"):
        b.add(name, lumps[name])
    return b.build()


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


def against_plain(kernel_call, plain_call):
    """(kernel outputs, plain outputs, plain ms): the kernel's call, then
    its plain version's, timed with CUDA events."""
    import torch

    got = kernel_call()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    ref = plain_call()
    b.record()
    torch.cuda.synchronize()
    return got, ref, a.elapsed_time(b)


def differing(pairs: dict) -> tuple[int, dict]:
    """(worst absolute difference, differing elements per output) of
    named (kernel, plain) output pairs."""
    worst, diffs = 0, {}
    for k, (g, r) in pairs.items():
        diffs[k] = (g != r).sum().item()
        if diffs[k]:
            worst = max(worst, (g.long() - r.long()).abs().max().item())
    return worst, diffs


# event_ms(spin=True): spin cycles queued ahead of each timed call (~100
# us at 1.98 GHz, longer than the host takes to queue one)
SPIN_CYCLES = 200_000


def event_ms(fn, n, spin=False):
    """Mean device ms of n calls after a warm one (CUDA events).  spin:
    the n calls are queued behind a spin kernel (torch.cuda._sleep) long
    enough that they run back to back on the card, so that the host's
    cost of a call does not pace a call shorter than it (device time);
    else a call shorter than its host cost is timed at the host's pace
    (eager time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if spin:
        torch.cuda._sleep(SPIN_CYCLES * n)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def profile_render(call, state, card, plain_ms, what="one render",
                   warm=True):
    """torch.profiler over one warm call: kernel launches, device busy
    time (the union of kernel intervals) and device time by op.  The
    device's idle share is given against the ms per batch measured
    without the profiler (`plain_ms`), whose own overhead on every
    launch would count as idle time, and against the profiled call's
    wall time.  Returns (launches, busy ms, idle share).  warm=False:
    the caller just ran `call`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
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
    log(f"profile of {what} (torch.profiler): {launches} kernel "
        f"launches, device busy {busy_ms:.3f} ms; device idle share "
        f"{1 - busy_ms / plain_ms:.4f} of the {plain_ms:.3f} ms per batch "
        f"without the profiler ({1 - busy_ms / wall_ms:.4f} of the "
        f"{wall_ms:.3f} ms wall time with it on)  [{card}]")
    log("  device ms by op: " + json.dumps(
        {e.key[:60]: round(dev_ms(e), 3) for e in top}))
    return launches, busy_ms, 1 - busy_ms / plain_ms


class Smoke:
    """Device, modules and the checks shared by the cells."""

    def __init__(self, card, dev):
        from doomtpu_torch.ops import (
            emit, itempass, items, layout, paint, resolve, scan,
        )
        from doomtpu_torch.render import resolve as res
        from doomtpu_torch.render import walls

        self.card, self.dev = card, dev
        self.checksums = {}                 # timed path -> its rgb checksum
        self.paint, self.items, self.scan = paint, items, scan
        self.itempass, self.emit = itempass, emit
        self.layout = layout
        self.resolve, self.res, self.walls = resolve, res, walls
        self.composite = items.composite_items
        self.kernels = {"paint": paint.paint, "items": self.composite,
                        "scan": scan.scan, "itempass": itempass.item_pass,
                        "resolve": resolve.resolve, "emit": emit.emit}

    def zero_counts(self):
        for fn in self.kernels.values():
            fn.launches = 0

    def counts(self) -> dict:
        return {k: fn.launches for k, fn in self.kernels.items()}

    def new_game(self, eng, n, poses=None):
        import torch

        pos, ang = spread_poses(eng.tables, n) if poses is None else poses
        return eng.new_game(n, pos=pos, angle=ang,
                            generator=torch.Generator(self.dev).manual_seed(0))

    def frame_order(self, eng, st, cfg=None):
        from doomtpu_torch.render import camera as cam

        lvl, cfg = eng.level, cfg or eng.config
        px, py = st.pos[:, 0], st.pos[:, 1]
        frame = cam.build_seg_frame(lvl, cfg, px, py, st.angle,
                                    st.floor_height, st.sector_light,
                                    st.timestamp)
        return frame, cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))

    def stage_inputs(self, eng, st, cfg=None):
        """Camera stage, order and paint inputs of a state."""
        frame, order = self.frame_order(eng, st, cfg)
        args = self.paint.build_inputs(eng.level, cfg or eng.config, frame,
                                       order, st.angle, st.pos[:, 0],
                                       st.pos[:, 1], st.floor_height)
        return frame, order, args

    # ---- each kernel against its plain version ------------------------------
    def compare_paint(self, eng, args, label, drop=None):
        """K1 against paint_reference: idx, ld, rgb, both counts and the
        overflow exactly, and both pools in every slot below its column's
        count (the kernel writes no slot past it; the plain version
        zero-fills them, and nothing reads them).  `drop`: a live-cap
        drop mask (paint.live_drop) both take."""
        import torch

        lvl, cfg = eng.level, eng.config
        got, ref, plain_ms = against_plain(
            lambda: outputs_of(self.paint.paint(lvl, cfg, *args, drop)),
            lambda: outputs_of(self.paint.paint_reference(lvl, cfg, *args,
                                                          drop)))
        for pool, cnt, K in (("midpool", "cnt_mid", cfg.mid_capacity),
                             ("clippool", "cnt_clip", cfg.clip_capacity)):
            below = (torch.arange(K, device=self.dev)[None, None, :]
                     < ref[cnt][..., None])              # [B, W, K]
            for k in [k for k in ref if k.startswith(pool)]:
                got[k] = torch.where(below, got[k], 0)
                ref[k] = torch.where(below, ref[k], 0)
        worst, diffs = differing({k: (got[k], ref[k]) for k in ref})
        log(f"paint {label}: differing elements per output {json.dumps(diffs)}")
        check(all(v == 0 for v in diffs.values()),
              f"paint {label}: kernel differs from paint_reference")
        log(f"  peak pool use per column: mid {got['cnt_mid'].max().item()} "
            f"of {cfg.mid_capacity}, clip {got['cnt_clip'].max().item()} "
            f"of {cfg.clip_capacity}; overflow "
            f"{int(got['overflow'].sum())}")
        return worst, plain_ms

    def compare_frames(self, what, got, ref, bg_idx, label, detail):
        """An item kernel's (idx, ld, rgb) against its plain version's:
        0 differing elements, and some pixel drawn.  Returns the worst
        difference."""
        worst, diffs = differing(dict(zip(("idx", "ld", "rgb"),
                                          zip(got, ref))))
        drawn = int((got[0] != bg_idx).sum())
        log(f"{what} {label}: differing elements per output "
            f"{json.dumps(diffs)}; pixels the items changed {drawn}; "
            f"{detail}")
        check(all(v == 0 for v in diffs.values()),
              f"{what} {label}: kernel differs from its plain version")
        check(drawn > 0, f"{what} {label}: no item drew anything")
        return worst

    def compare_items(self, eng, cfg, ipool, icnt, bg, clip, label):
        lvl = eng.level
        fresh = lambda: [x.clone() for x in bg]
        ref_in = fresh()
        got, ref, plain_ms = against_plain(
            lambda: self.composite(lvl, cfg, ipool, icnt, *fresh(), clip=clip),
            lambda: self.items.composite_items_reference(
                lvl, cfg, ipool, icnt, *ref_in, clip=clip))
        worst = self.compare_frames(
            "items", got, ref, bg[0], label, f"peak slots per column "
            f"{int(icnt.max())} of {cfg.item_capacity}")
        return worst, plain_ms

    def compare_scan(self, eng, cfg, rows, scnt, label):
        """K4 against scan_reference: cnt, overflow and every pool plane
        below each column's count (the kernel writes no slot past it)."""
        import torch

        lvl = eng.level
        got, ref, plain_ms = against_plain(
            lambda: self.scan.scan(lvl, cfg, rows, scnt),
            lambda: self.scan.scan_reference(lvl, cfg, rows, scnt))
        K = cfg.span_capacity
        below = (torch.arange(K, device=self.dev)[None, :, None]
                 < ref["cnt"][:, None, :])
        pairs = {"cnt": (got["cnt"], ref["cnt"]),
                 "overflow": (got["overflow"], ref["overflow"])}
        for i, name in enumerate(("span", "d1", "d2", "d3", "d4", "d5",
                                  "d6")):
            pairs[name] = (torch.where(below, got["pool"][i], 0),
                           torch.where(below, ref["pool"][i], 0))
        worst, diffs = differing(pairs)
        log(f"scan {label}: differing elements per output "
            f"{json.dumps(diffs)}; peak records per column "
            f"{int(ref['cnt'].max())} of {K}; overflow "
            f"{int(ref['overflow'].sum())}")
        check(all(v == 0 for v in diffs.values()),
              f"scan {label}: kernel differs from scan_reference")
        return worst, plain_ms

    def resolve_inputs(self, eng, st, cfg):
        """(frame, pool, cnt, poses) of the wall scan of a state."""
        frame, order = self.frame_order(eng, st, cfg)
        pool, cnt, _ = self.walls.wall_scan(eng.level, cfg, frame, order)
        return frame, pool, cnt, (st.pos[:, 0], st.pos[:, 1], st.angle,
                                  st.floor_height)

    def compare_resolve(self, level, cfg, frame, pool, cnt, poses, label):
        """The resolve kernel against resolve_reference: idx, ld and rgb
        exactly.  Returns (worst error, plain ms)."""
        got, ref, plain_ms = against_plain(
            lambda: self.res.resolve_frame(level, cfg, frame, pool, cnt,
                                           *poses),
            lambda: self.res.resolve_reference(level, cfg, frame, pool, cnt,
                                               *poses))
        worst, diffs = differing(dict(zip(("idx", "ld", "rgb"),
                                          zip(got, ref))))
        written = (got[0] >= 0).float().mean().item()
        log(f"resolve {label}: differing elements per output "
            f"{json.dumps(diffs)}; share of pixels written {written:.4f}; "
            f"sky opaque {level.sky_is_opaque}")
        check(all(v == 0 for v in diffs.values()),
              f"resolve {label}: kernel differs from resolve_reference")
        return worst, plain_ms

    def check_resolve(self, eng, st, cfg, label, level=None):
        frame, pool, cnt, poses = self.resolve_inputs(eng, st, cfg)
        return self.compare_resolve(level or eng.level, cfg, frame, pool,
                                    cnt, poses, label)[0]

    def resolve_bound(self, cfg, cnt, B):
        """The resolve's bytes, each once: the span word and d1..d5 of
        every occupied slot, the counts, and idx / ld / rgb written (12
        bytes a pixel); the level's atlas and palette come from L2.
        Operations, loosely from above: ~60 a pixel."""
        used = int(cnt.sum())
        pixels = B * cfg.height * cfg.width
        r_bytes = used * 6 * 4 + cnt.numel() * 4 + pixels * 3 * 4
        ms, by = bound(r_bytes, 60.0 * pixels)
        log(f"bound resolve B={B}: {r_bytes} bytes ({used} occupied slots, "
            f"{pixels} pixels) -> {ms:.4f} ms ({by})")
        return ms, by

    def row_bytes(self, rows, scnt, row_words):
        """Bytes of the seg rows a kernel must read: `row_words` words of
        each active row (k < scnt) and 9 words of each active piece of it
        (edges, texture size, offset and id, and the one uy1 copy the
        kernel takes), counted from this run's flags."""
        import torch

        L = self.layout
        active = (torch.arange(rows.shape[1], device=rows.device)[None]
                  < scnt[:, None])
        flags = rows[..., L.R_FLAGS][active]
        pieces = sum(int(((flags >> p) & 1).sum()) for p in range(4))
        n_rows = int(active.sum())
        return (n_rows * row_words + pieces * 9) * 4, n_rows, pieces

    def item_inputs(self, eng, st, frame, order, pools, cfg):
        """(ipool, icnt, daux) of the deferred pass."""
        from doomtpu_torch.render import things

        return things.item_pool(
            eng.level, cfg, frame, pools, order, st.pos[:, 0], st.pos[:, 1],
            st.angle, st.floor_height, st.sector_light, st.mobj_state)

    def check_items(self, eng, st, cfg, label, variants=False):
        """K2 on a state's paint result and item pool, with its clip pool;
        with `variants` also without one (the words clipped beforehand,
        as the JAX _kernel_kouter takes them) and on an atlas of 256 rows
        a column (`tall_atlas`)."""
        from doomtpu_torch.render import things

        frame, order, args = self.stage_inputs(eng, st, cfg)
        out = self.paint.paint(eng.level, cfg, *args)
        pools = things.pools_from_paint(out)
        ipool, icnt, _ = self.item_inputs(eng, st, frame, order, pools, cfg)
        bg = [out[k] for k in ("idx", "ld", "rgb")]
        worst = self.compare_items(eng, cfg, ipool, icnt, bg, pools[0],
                                   label)[0]
        if variants:
            words = ipool.clone()
            words[0] = self.items.clipped_words(ipool, pools[0], cfg.height)
            worst = max(worst, self.compare_items(
                eng, cfg, words, icnt, bg, None, f"{label} clip=None")[0])
            level, tall = tall_atlas(eng.level, ipool)
            worst = max(worst, self.compare_items(
                dataclasses.replace(eng, level=level), cfg, tall, icnt, bg,
                pools[0], f"{label} atlas_rows={level.atlas_rows}")[0])
        return worst

    def check_scan(self, eng, st, cfg, label):
        frame, order = self.frame_order(eng, st, cfg)
        rows, scnt = self.paint.build_rows(eng.level, frame, order)
        return self.compare_scan(eng, cfg, rows, scnt, label)[0]

    def emit_inputs(self, eng, st, cfg, pipeline):
        """(pack, mid pool) of the deferred pass's emission on a state:
        the item pack and the paint path's mid pool ("paint"), the same
        pool laid out as the JAX package's [B, W, K] store and read
        through its strides ("paint-bwk"), or the scan path's unified
        pool ("scan")."""
        from doomtpu_torch.render import things

        frame, order, args = self.stage_inputs(eng, st, cfg)
        if pipeline == "scan":
            pool, cnt, _ = self.walls.wall_scan(eng.level, cfg, frame, order)
            mid = things.pools_from_unified(pool, cnt, frame)[1]
        else:
            mid = things.pools_from_paint(
                self.paint.paint(eng.level, cfg, *args))[1]
        if pipeline.endswith("bwk"):
            bwk = lambda p: p.transpose(1, 2).contiguous().transpose(1, 2)
            mid = {k: v if k == "cnt" else bwk(v) for k, v in mid.items()}
        pack, _ = things.item_pack(
            eng.level, cfg, frame, order, st.pos[:, 0], st.pos[:, 1],
            st.angle, st.floor_height, st.sector_light, st.mobj_state)
        return pack, mid

    def compare_emit(self, eng, cfg, pack, mid, label):
        """The emission kernel against emit_reference: every plane of the
        pool, icnt, item_overflow and item_peak exactly.  Returns (worst
        difference, plain ms, the kernel's outputs)."""
        lvl = eng.level
        got, ref, plain_ms = against_plain(
            lambda: self.emit.emit(lvl, cfg, pack, mid),
            lambda: self.emit.emit_reference(lvl, cfg, pack, mid))
        names = [f"plane{i}" for i in range(self.items.ITEM_PLANES)] + [
            "icnt", "item_overflow", "item_peak"]
        worst, diffs = differing(dict(zip(names, zip(
            [*got[0], *got[1:]], [*ref[0], *ref[1:]]))))
        icnt, overflow, peak = got[1:]
        word = got[0][0]
        spr = int(((word & self.items.SPR_MARK) != 0).sum())
        mids = int(((word != 0) & ((word & self.items.SPR_MARK) == 0)).sum())
        log(f"emit {label}: differing elements per output "
            f"{json.dumps(diffs)}; slots: {spr} sprite, {mids} mid, peak "
            f"{int(icnt.max())} of {cfg.item_capacity}; uncapped peak "
            f"{int(peak.max())}, overflow {int(overflow.sum())}")
        check(all(v == 0 for v in diffs.values()),
              f"emit {label}: kernel differs from emit_reference")
        check(spr > 0, f"emit {label}: no sprite slot")
        return worst, plain_ms, got

    def check_emit(self, eng, st, cfg, label, pipeline="paint"):
        pack, mid = self.emit_inputs(eng, st, cfg, pipeline)
        return self.compare_emit(eng, cfg, pack, mid,
                                 f"{label} ({pipeline} mid pool)")[0]

    def emit_bound(self, eng, cfg, pack, mid, got):
        """The emission: the pool written whole (every slot, zeros past a
        column's count), icnt and the two counters; of the pack, the
        first three words of every item and the whole of each (camera,
        item) pair that is present in some column (a valid sprite whose
        [x0, x1e) meets the screen, a valid mid whose seg a record
        carries); the mid records below each column's count (kind and
        seg, 2 words) and the 6 words of the record each mid slot takes.
        Operations, ~40 per sprite slot (three IEEE divides among them):
        it is bytes-bound."""
        import torch

        ipool, icnt = got[0], got[1]
        nb = lambda t: t.numel() * t.element_size()
        ip = pack["i"]
        B, N, _ = ip.shape
        KI, W, G = cfg.item_capacity, cfg.width, eng.level.num_segs
        word = ipool[0]
        spr_slots = int(((word & self.items.SPR_MARK) != 0).sum())
        mid_slots = int(((word != 0)
                         & ((word & self.items.SPR_MARK) == 0)).sum())
        KM = mid["span"].shape[1]
        rec = ((((mid["span"] >> 29) & 3) == self.layout.KIND_MID)
               & (torch.arange(KM, device=self.dev)[None, :, None]
                  < mid["cnt"][:, None]))
        records = int(torch.clamp(mid["cnt"], max=KM).sum())
        carried = torch.zeros((B, G + 1), dtype=torch.bool, device=self.dev)
        carried.scatter_(1, torch.where(rec, mid["d6"], G).reshape(B, -1)
                         .long(), True)
        carried[:, G] = False
        fl, x0, x1e, seg = ip[..., 0], ip[..., 1], ip[..., 2], ip[..., 6]
        valid, spr = (fl & 1) != 0, (fl & 2) != 0
        on_mid = torch.gather(carried, 1, torch.clamp(seg, 0, G).long())
        pairs = int((valid & spr & (x1e > 0) & (x0 < W)).sum()
                    + (valid & ~spr & on_mid).sum())
        row = (ip.shape[2] + pack["f"].shape[2]) * 4
        e_in = (B * N * 12 + pairs * row + records * 2 * 4
                + mid_slots * 6 * 4 + nb(mid["cnt"]))
        e_out = nb(ipool) + nb(icnt) + 2 * B * 4
        e_ops = 40.0 * spr_slots
        ms, by = bound(e_in + e_out, e_ops)
        log(f"bound emit: {e_in + e_out} bytes (pool {nb(ipool)} written "
            f"whole: B={B} x KI={KI} x W={W} x 8 planes; {pairs} (camera, "
            f"item) pairs present; {spr_slots} sprite and {mid_slots} mid "
            f"slots, {records} mid records), ~{e_ops:.4g} operations -> "
            f"{ms:.4f} ms ({by})")
        return ms, by

    @staticmethod
    def fresh(out):
        """The paint result with its own copies of idx / ld / rgb (the
        item passes update them in place)."""
        return dict(out, **{k: out[k].clone() for k in ("idx", "ld", "rgb")})

    def compare_itempass(self, eng, cfg, pack, out, label):
        """K3 against item_pass_reference on the same pack and paint
        result; returns (worst error, plain ms, the kernel's frames)."""
        lvl = eng.level
        ref_in = self.fresh(out)
        got, ref, plain_ms = against_plain(
            lambda: self.itempass.item_pass(lvl, cfg, pack, self.fresh(out)),
            lambda: self.itempass.item_pass_reference(lvl, cfg, pack, ref_in))
        worst = self.compare_frames(
            "itempass", got, ref, out["idx"], label,
            f"items per camera {pack['i'].shape[1]}")
        return worst, plain_ms, got

    def check_itempass(self, eng, st, cfg, label, capped=False):
        """K3 on a state's paint result and item pack.  With `capped`,
        the deferred pass at cfg.item_capacity on the same inputs must
        overflow, and its frame then differs from the item pass's, which
        draws every item."""
        from doomtpu_torch.render import things

        frame, order, args = self.stage_inputs(eng, st, cfg)
        out = self.paint.paint(eng.level, cfg, *args)
        pack, _ = things.item_pack(
            eng.level, cfg, frame, order, st.pos[:, 0], st.pos[:, 1],
            st.angle, st.floor_height, st.sector_light, st.mobj_state)
        worst, _, got = self.compare_itempass(eng, cfg, pack, out, label)
        if capped:
            pools = things.pools_from_paint(out)
            ipool, icnt, daux = self.item_inputs(eng, st, frame, order,
                                                 pools, cfg)
            pool_idx = self.composite(
                eng.level, cfg, ipool, icnt,
                *[out[k].clone() for k in ("idx", "ld", "rgb")],
                clip=pools[0])[0]
            dropped = int(daux["item_overflow"].sum())
            differ = int((pool_idx != got[0]).sum())
            log(f"  deferred pass at item_capacity={cfg.item_capacity}: "
                f"{dropped} item records dropped (uncapped peak "
                f"{int(daux['item_peak'].max())}); pixels where its frame "
                f"and the item pass's differ: {differ}")
            check(dropped > 0 and differ > 0,
                  f"{label}: the capped deferred pass dropped nothing")
        return worst

    # ---- the main paths ---------------------------------------------------
    def check_frames(self, idx, rgb, cfg, what):
        import torch

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

    def against_cpu(self, idx, rgb, cpu_call, cpu_state, sel, what):
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

    def main_paths(self, eng, cpu_eng, state, cfg, label, walls_kernel,
                   item_kernel="items", with_walls=True):
        """render_walls (unless `with_walls` is False), then render, each
        driven once: its launches (the walls kernel `walls_kernel` once
        and the other never; the item kernel `item_kernel` once in render
        only, the other item kernel never; the emission kernel once with
        K2, never with K3), its frames, its counters (all
        0) and 16 cameras against the CPU port; then each timed and
        render profiled.  Returns render's launches."""
        import torch

        other = "scan" if walls_kernel == "paint" else "paint"
        no_items = {"items": 0, "itempass": 0, "emit": 0,
                    "resolve": int(walls_kernel == "scan")}
        sel = torch.linspace(0, B - 1, 16).long().to(self.dev)
        cpu_state = state.map(lambda x: x[sel].cpu())
        runs = [(eng.render, eng.render_counters, cpu_eng.render,
                 dict(no_items, **{item_kernel: 1},
                      emit=int(item_kernel == "items")))]
        if with_walls:
            runs.insert(0, (eng.render_walls, eng.render_walls_counters,
                            cpu_eng.render_walls, no_items))
        frames = {}
        for call, counters, cpu_call, items in runs:
            what = f"{call.__name__} {label}"
            idx, rgb = self.drive(eng, state, call, what,
                                  {walls_kernel: 1, other: 0, **items})
            launches = self.counts()
            self.check_frames(idx, rgb, cfg, what)
            got = counters(state)
            log(f"{counters.__name__} {label}: {got}")
            check(all(v == 0 for v in got.values()),
                  f"{what}: capacity counters not 0: {got}")
            self.against_cpu(idx, rgb, cpu_call, cpu_state, sel, what)
            frames[call.__name__] = idx
        walls = frames.get("render_walls")
        if walls is None:
            walls = eng.render_walls(state)[0]
        changed = (frames["render"] != walls).float().mean()
        log(f"render {label}: share of pixels the items changed "
            f"{changed.item():.6f}")
        check(changed.item() > 0.01, f"{label}: the items drew almost nothing")
        del frames, walls, idx, rgb

        # timing: warm once, timed calls, synchronize, host checksum
        if with_walls:
            self.time_path(eng.render_walls, state, f"render_walls {label}")
        render_ms = self.time_path(eng.render, state, f"render {label}")
        profile_render(eng.render, state, self.card, render_ms)
        return launches

    def drive(self, eng, state, call, what, want):
        """One main-path call with the launch counts set to 0 just before
        it and read just after; `want` maps each kernel to the launches
        the path must make."""
        import torch

        self.zero_counts()
        out = call(state)
        torch.cuda.synchronize()
        got = self.counts()
        log(f"main path {what} B={B}: launches {got}")
        for k, n in want.items():
            check(got[k] == n, f"{what}: {got[k]} {k} launches, want {n}")
        return out

    def time_path(self, call, state, what, reps=5):
        import torch

        out = call(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = call(state)
        torch.cuda.synchronize()
        checksum = int(out[1].sum().item())
        dt = (time.perf_counter() - t0) / reps
        self.checksums[what] = checksum
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"{what} 320x200 B={B}: {dt * 1e3:.3f} ms/batch, "
            f"{B / dt:.1f} frames/s, peak {peak:.2f} GiB, checksum "
            f"{checksum}  [{self.card}]")
        return dt * 1e3

    def timed_items(self, eng, cfg, ipool, icnt, bg, clip):
        """K2's mean device ms over 5 calls on fresh frame copies."""
        import torch

        ms = []
        for _ in range(6):
            fresh = [x.clone() for x in bg]
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            self.composite(eng.level, cfg, ipool, icnt, *fresh, clip=clip)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return sum(ms[1:]) / 5

    def items_bound(self, eng, cfg, ipool, icnt, bg, clip):
        """K2: the pool words of the occupied slots, the clip records of
        the columns that hold a sprite, the counts and the atlas read
        once; idx / ld / rgb written once where the items changed them.
        Operations: 3 per (slot, row) of the fold (divide, multiply,
        add), ~8 per clip test of a sprite slot, ~8 per shaded pixel."""
        import torch

        lvl, items = eng.level, self.items
        nb = lambda t: t.numel() * t.element_size()
        occupied = (torch.arange(cfg.item_capacity, device=self.dev)
                    [None, :, None] < icnt[:, None, :])
        spr = occupied & ((ipool[0] & items.SPR_MARK) != 0)
        n_slots, n_spr = int(occupied.sum()), int(spr.sum())
        spr_cols = spr.any(1)
        ccnt = torch.clamp(clip["cnt"], max=clip["span"].shape[1])
        clip_recs = int(ccnt[spr_cols].sum())
        clip_tests = int((spr.sum(1) * ccnt).sum())
        words = items.clipped_words(ipool, clip, cfg.height)
        ct = torch.clamp(((words >> 16) & 0x1FF) - 1, min=0)
        cb = torch.clamp(((words << 16) >> 16) - 1, max=cfg.height - 1)
        fold_rows = int(torch.where(occupied, torch.clamp(cb - ct + 1, min=0),
                                    0).sum())
        got = self.composite(lvl, cfg, ipool, icnt, *[x.clone() for x in bg],
                             clip=clip)
        touched = int(((got[0] != bg[0]) | (got[1] != bg[1])
                       | (got[2] != bg[2])).sum())
        i_in = (n_slots * 6 * 4 + n_spr * 2 * 4 + clip_recs * 6 * 4
                + nb(icnt) + int(spr_cols.sum()) * 4 + nb(lvl.atlas_cm)
                + nb(lvl.palette_packed))
        i_out = touched * 3 * 4
        i_ops = 3.0 * fold_rows + 8.0 * clip_tests + 8.0 * touched
        ms, by = bound(i_in + i_out, i_ops)
        log(f"bound items: {i_in + i_out} bytes ({n_slots} occupied slots, "
            f"{clip_recs} clip records, {touched} pixels written), "
            f"~{i_ops:.4g} operations ({fold_rows} fold rows, {clip_tests} "
            f"clip tests) -> {ms:.4f} ms ({by})")
        return ms, by

    def timed_itempass(self, eng, cfg, pack, out):
        """K3's mean device ms over 5 calls on fresh frame copies."""
        import torch

        ms = []
        for _ in range(6):
            fresh = self.fresh(out)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            self.itempass.item_pass(eng.level, cfg, pack, fresh)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return sum(ms[1:]) / 5

    def itempass_bound(self, eng, cfg, pack, out, got):
        """K3: of the pack, the first three words of every item (valid,
        x0, x1e) and the rest of each item that covers a column of its
        camera; the clip records of the columns a sprite covers and the
        mid records of the columns a mid covers; both counts of every
        column; the atlas and palette once; idx / ld / rgb written once
        where the items changed them.  Operations: ~30 per (item,
        column) of billboard math, ~8 per clip test, ~3 per mid-record
        test, ~8 per written pixel."""
        import torch

        lvl = eng.level
        nb = lambda t: t.numel() * t.element_size()
        ip = pack["i"]
        Bn, N, _ = ip.shape
        fl, x0, x1e = ip[..., 0], ip[..., 1], ip[..., 2]
        valid, spr = (fl & 1) != 0, (fl & 2) != 0
        xs = torch.arange(cfg.width, device=self.dev)
        cov = valid[..., None] & (xs >= x0[..., None]) & (xs < x1e[..., None])
        cov_s = (cov & spr[..., None]).sum(1, dtype=torch.int32)     # [B, W]
        cov_m = (cov & ~spr[..., None]).sum(1, dtype=torch.int32)
        covering = int(cov.any(2).sum())
        del cov
        ccnt = torch.clamp(out["cnt_clip"], max=cfg.clip_capacity)
        mcnt = torch.clamp(out["cnt_mid"], max=cfg.mid_capacity)
        clip_recs = int(ccnt[cov_s > 0].sum())
        mid_recs = int(mcnt[cov_m > 0].sum())
        clip_tests = int((cov_s * ccnt).sum())
        mid_tests = int((cov_m * mcnt).sum())
        item_cols = int(cov_s.sum() + cov_m.sum())
        touched = int(((got[0] != out["idx"]) | (got[1] != out["ld"])
                       | (got[2] != out["rgb"])).sum())
        rest = (nb(ip) + nb(pack["f"])) // (Bn * N) - 12
        i_in = (Bn * N * 12 + covering * rest + clip_recs * 6 * 4
                + mid_recs * 7 * 4 + nb(ccnt) + nb(mcnt) + nb(lvl.atlas_cm)
                + nb(lvl.palette_packed))
        i_out = touched * 3 * 4
        i_ops = (30.0 * item_cols + 8.0 * clip_tests + 3.0 * mid_tests
                 + 8.0 * touched)
        ms, by = bound(i_in + i_out, i_ops)
        log(f"bound itempass: {i_in + i_out} bytes ({Bn * N} (camera, item) "
            f"pairs, {covering} covering a column; {clip_recs} clip and "
            f"{mid_recs} mid records; {touched} pixels written), "
            f"~{i_ops:.4g} operations ({item_cols} (item, column) pairs, "
            f"{clip_tests} clip tests, {mid_tests} mid-record tests) -> "
            f"{ms:.4f} ms ({by})")
        return ms, by


def tall_mid_cell(s: Smoke) -> int:
    """The WAD of `tall_mid_wad` (a masked mid 256 rows tall, so the
    column atlas holds 256 rows) at 320x200, 16 spread poses: render
    through K2 on the card (the level leaves the paint path: its sky's
    mask is padded to 256 rows) against the CPU port, whose plain
    version tests/test_torch_faults.py holds to the JAX package there.
    Returns the worst difference (0)."""
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.wad import builder, synth

    cfg = RenderConfig(width=320, height=200, span_capacity=64,
                       mid_capacity=40, clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True)
    wad = tall_mid_wad(synth, builder)
    gpu = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=s.dev)
    cpu = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device="cpu")
    check(gpu.level.atlas_rows == 256, "the tall mid's atlas is not 256 rows")
    n, what = 16, "render tall-mid (atlas_rows 256) B=16"
    st = s.new_game(gpu, n)
    s.zero_counts()
    idx, rgb = gpu.render(st)
    torch.cuda.synchronize()
    got = s.counts()
    log(f"{what}: launches {got}")
    check(got["items"] == got["emit"] == 1 and got["itempass"] == 0,
          f"{what}: the item and emission kernels did not run once")
    s.against_cpu(idx, rgb, cpu.render, st.map(lambda x: x.cpu()),
                  torch.arange(n, device=s.dev), what)
    counters = gpu.render_counters(st)
    check(set(counters.values()) == {0}, f"{what}: counters {counters}")
    drawn = int((gpu.render_walls(st)[0] != idx).sum())
    log(f"{what}: pixels the items changed {drawn}; counters {counters}")
    check(drawn > 0, f"{what}: no item drew anything")
    return 0


def probe_paint(s: Smoke, lvl, cfg, args, full_ms: float) -> None:
    """The paint kernel's cost split (the TPU probe
    scripts/probe_paint_cost.py, on the card): the kernel built at
    PAINT_PROBE levels 1-3 (csrc/paint.cu), each timed on the same
    inputs as the full kernel (`full_ms`); then the full kernel at other
    band heights (threads a column, paint.paint_tile)."""
    phase("paint kernel cost probe")
    split = {}
    for n, what in ((1, "init and outputs only"),
                    (2, "+ seg x-range checks"),
                    (3, "+ occlusion and emit math, no painting")):
        split[what] = event_ms(
            lambda: s.paint.paint_probe(lvl, cfg, *args, n), 5)
    split["full kernel"] = full_ms
    log(f"paint cost probe at B={args[0].shape[0]}, "
        f"{s.paint.paint_tile(cfg.height)} (columns, threads a column) "
        "(CUDA events, ms): "
        + json.dumps({k: round(v, 4) for k, v in split.items()})
        + f"  [{s.card}]")
    sweep = {}
    for rows in BAND_SWEEP:
        tile = s.paint.paint_tile(cfg.height, rows)
        sweep[f"{tile}"] = (round(event_ms(
            lambda: s.paint.paint_probe(lvl, cfg, *args, 4, rows), 5), 4),
            s.paint.paint_blocks_per_sm(cfg.height, rows))
    log(f"paint kernel by (columns, threads a column), band rows "
        f"{BAND_SWEEP}: [ms (CUDA events), blocks an SM holds] "
        f"{json.dumps(sweep)}  [{s.card}]")


def probe_itempass(s: Smoke, lvl, cfg, pack, out, full_ms: float) -> None:
    """The item-pass kernel's cost split: the kernel built at
    ITEMPASS_PROBE levels 1-3 (csrc/itempass.cu), each timed on the same
    inputs as the full kernel (`full_ms`); then the full kernel at other
    band heights (threads a column, itempass.itempass_tile).  The kernel
    never reads the frame it writes, so repeated calls on one copy time
    the same work."""
    phase("item-pass kernel cost probe")
    ip = s.itempass
    KC, KM = cfg.clip_capacity, cfg.mid_capacity
    split = {}
    for n, what in ((1, "cull and staging only"),
                    (2, "+ (item, column) terms"),
                    (3, "+ fold into the marks, no write")):
        split[what] = event_ms(
            lambda: ip.item_pass_probe(lvl, cfg, pack, out, n), 5)
    split["full kernel"] = full_ms
    log(f"itempass cost probe at B={out['idx'].shape[0]}, "
        f"{ip.itempass_tile(cfg.height, KC, KM)} (columns, threads a "
        "column) (CUDA events, ms): "
        + json.dumps({k: round(v, 4) for k, v in split.items()})
        + f"  [{s.card}]")
    sweep = {}
    for rows in BAND_SWEEP:
        tile = ip.itempass_tile(cfg.height, KC, KM, rows)
        sweep[f"{tile}"] = (round(event_ms(
            lambda: ip.item_pass_probe(lvl, cfg, pack, out, 4, rows), 5), 4),
            ip.itempass_blocks_per_sm(cfg.height, KC, KM, rows))
    log(f"item-pass kernel by (columns, threads a column), band rows "
        f"{BAND_SWEEP}: [ms (CUDA events), blocks an SM holds] "
        f"{json.dumps(sweep)}  [{s.card}]")


def probe_scan(s: Smoke, lvl, cfg, rows, scnt, full_ms: float) -> None:
    """The wall-scan kernel's cost split: the kernel built at SCAN_PROBE
    levels 1-2 (csrc/scan.cu), each timed on the same inputs as the full
    kernel (`full_ms`); then the full kernel at other tile widths."""
    phase("wall-scan kernel cost probe")
    split = {}
    for n, what in ((1, "lists and staging only"),
                    (2, "+ walk and records, not stored")):
        split[what] = event_ms(
            lambda: s.scan.scan_probe(lvl, cfg, rows, scnt, n), 5)
    split["full kernel"] = full_ms
    log(f"scan cost probe at B={rows.shape[0]}, {s.scan.SCAN_COLUMNS} "
        "columns a block (CUDA events, ms): "
        + json.dumps({k: round(v, 4) for k, v in split.items()})
        + f"  [{s.card}]")
    sweep = {tc: (round(event_ms(lambda: s.scan.launch_scan(
        lvl, cfg, rows, scnt, tc), 5), 4), s.scan.scan_blocks_per_sm(tc))
        for tc in (32, 64, 96, 128)}
    log(f"wall-scan kernel by columns a block: [ms (CUDA events), blocks "
        f"an SM holds] {json.dumps(sweep)}  [{s.card}]")


def sweep_items(s: Smoke, lvl, cfg, ipool, icnt, bg, clip) -> None:
    """The item kernel at other band heights (items.items_tile), each on
    fresh copies of the same frame."""
    import torch

    KC = clip["span"].shape[1]
    sweep = {}
    for rows in BAND_SWEEP:
        tile = s.items.items_tile(cfg.height, cfg.item_capacity, KC, rows)
        ms = []
        for _ in range(4):
            fresh = [x.clone() for x in bg]
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            s.items.launch_items(lvl, cfg, ipool, icnt, *fresh, clip, rows)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        sweep[f"{tile}"] = (round(sum(ms[1:]) / 3, 4),
                            s.items.items_blocks_per_sm(
                                cfg.height, cfg.item_capacity, KC, rows))
    log(f"item kernel by (columns, threads a column), band rows "
        f"{BAND_SWEEP}: [ms (CUDA events), blocks an SM holds] "
        f"{json.dumps(sweep)}  [{s.card}]")


def log_deferred_stages(stage: dict, label: str, card: str) -> None:
    """The deferred pass's stage table: the selection and the per-item
    packs, the emission kernel, K2, their sum and the item pool (packs
    and emission) in one call."""
    parts = {k: stage[k] for k in ("selection + pack", "emission kernel",
                                   "item kernel")}
    whole = sum(parts.values())
    log(f"deferred pass stages {label} (CUDA events, ms): " + json.dumps(
        {**{k: round(v, 4) for k, v in parts.items()},
         "sum": round(whole, 4)}) + "; shares " + json.dumps(
        {k: round(v / whole, 4) for k, v in parts.items()})
        + f"  [{card}]")


def paint_cell(s: Smoke) -> dict:
    """e1m1-scale, paint-eligible: render_walls and render through K1
    and K2 (the walls-only and full-frame paths of the first slices)."""
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.render import camera as cam
    from doomtpu_torch.render import things
    from doomtpu_torch.render.camsort import sort_state, unsort_out
    from doomtpu_torch.wad import synth

    phase("e1m1-scale: the paint path")
    # spread poses need deeper pools than the defaults (mid 8 / clip 24 /
    # item 8): this script's own config, the library defaults stay as
    # they are.  Item capacity 24 is the TPU bench's calibrated value.
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True)
    log(f"config: {cfg.width}x{cfg.height} mid_capacity={cfg.mid_capacity} "
        f"clip_capacity={cfg.clip_capacity} item_capacity={cfg.item_capacity} "
        f"render_chunk={cfg.render_chunk} camera_sort={cfg.camera_sort} "
        f"use_pallas_paint={cfg.use_pallas_paint}")
    e1 = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1", config=cfg,
                                   device=s.dev)
    check(e1.level.paint_ok, "e1m1-scale is not paint-eligible")
    state = s.new_game(e1, B)
    cpu_eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device="cpu")
    launches = s.main_paths(e1, cpu_eng, state, cfg, "e1m1-scale", "paint")

    # where the time goes: each stage alone on the Morton-sorted batch
    sp, _ = sort_state(state)
    lvl = e1.level
    px, py = sp.pos[:, 0], sp.pos[:, 1]
    stage = {}
    stage["camera stage + order"] = event_ms(lambda: (
        cam.build_seg_frame(lvl, cfg, px, py, sp.angle, sp.floor_height,
                            sp.sector_light, sp.timestamp),
        cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))), 3)
    frame, order, args_full = s.stage_inputs(e1, sp)
    stage["paint input build"] = event_ms(lambda: s.paint.build_inputs(
        lvl, cfg, frame, order, sp.angle, px, py, sp.floor_height), 3)
    stage["paint kernel"] = event_ms(
        lambda: s.paint.paint(lvl, cfg, *args_full), 5)
    probe_paint(s, lvl, cfg, args_full, stage["paint kernel"])
    out = s.paint.paint(lvl, cfg, *args_full)
    pools = things.pools_from_paint(out)
    stage["deferred pass (item pool)"] = event_ms(
        lambda: s.item_inputs(e1, sp, frame, order, pools, cfg), 3)
    ipool, icnt, daux = s.item_inputs(e1, sp, frame, order, pools, cfg)
    clip = pools[0]
    # the deferred pass's parts: the selection and the per-item packs
    # (things._item_pack, shared with item_pack), the emission kernel, K2
    pack_args = (lvl, cfg, frame, order, px, py, sp.angle, sp.floor_height,
                 sp.sector_light, sp.mobj_state)
    stage["selection + pack"] = event_ms(
        lambda: things._item_pack(*pack_args), 3)
    pack, _ = things._item_pack(*pack_args)
    stage["emission kernel"] = event_ms(
        lambda: s.emit.emit(lvl, cfg, pack, pools[1]), 10, spin=True)

    # the item pool's one pass over the batch against the same work in
    # chunks of cameras: time and the memory its temporaries take
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
            f"[{s.card}]")
    bg = [out[k] for k in ("idx", "ld", "rgb")]
    stage["item kernel"] = s.timed_items(e1, cfg, ipool, icnt, bg, clip)
    sweep_items(s, lvl, cfg, ipool, icnt, bg, clip)
    stage["sort + unsort"] = event_ms(
        lambda: unsort_out((out["idx"], out["rgb"]), sort_state(state)[1]), 3)
    log(f"stages e1m1-scale at B={B} (CUDA events, ms): " + json.dumps(
        {k: round(v, 4) for k, v in stage.items()}) + f"  [{s.card}]")
    log_deferred_stages(stage, f"e1m1-scale B={B}", s.card)
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

    # the kernels against their plain versions on the path's own inputs
    err_paint, paint_plain_ms = s.compare_paint(
        e1, args_full, f"e1m1-scale B={B} main-path inputs")
    err_items, items_plain_ms = s.compare_items(
        e1, cfg, ipool, icnt, bg, clip, f"e1m1-scale B={B} main-path inputs")
    err_emit, emit_plain_ms, got_emit = s.compare_emit(
        e1, cfg, pack, pools[1], f"e1m1-scale B={B} main-path inputs")
    check(all(torch.equal(a, b) for a, b in zip(
        got_emit, (ipool, icnt, daux["item_overflow"], daux["item_peak"]))),
        "the emission's outputs differ from the deferred pass's item pool")
    log(f"emit at B={B}: kernel {stage['emission kernel']:.4f} ms, plain "
        f"PyTorch {emit_plain_ms:.2f} ms (one call)  [{s.card}]")
    log(f"paint at B={B}: kernel {stage['paint kernel']:.4f} ms, plain "
        f"PyTorch {paint_plain_ms:.2f} ms (one call)  [{s.card}]")
    log(f"items at B={B}: kernel {stage['item kernel']:.4f} ms, plain "
        f"PyTorch {items_plain_ms:.2f} ms (one call)  [{s.card}]")

    # bounds: what these inputs need moved and computed.  paint: the row
    # words it reads of the active segs (16 of a row: all before the
    # pieces; 9 per active piece), the per-camera scalars and the tables
    # read once; the frame planes and counts written whole, the pools
    # only in their occupied slots (the kernel writes no slot past a
    # column's count, and nothing reads one).
    # Operations, counted loosely from above: ~40 per (column, visited
    # seg) and ~20 per pixel.
    nb = lambda t: t.numel() * t.element_size()
    r_bytes, n_rows, n_pieces = s.row_bytes(args_full[0], scnt,
                                            s.layout.R_PIECE0)
    p_in = (r_bytes + nb(scnt) + nb(args_full[2])
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
    log(f"bound paint: {p_in + p_out} bytes ({n_rows} active rows with "
        f"{n_pieces} active pieces: {r_bytes} row bytes; {mid_used} mid and "
        f"{clip_used} clip pool slots used), ~{p_ops:.4g} operations -> "
        f"{paint_bound:.4f} ms ({paint_by})")
    items_bound, items_by = s.items_bound(e1, cfg, ipool, icnt, bg, clip)
    emit_bound, emit_by = s.emit_bound(e1, cfg, pack, pools[1], got_emit)
    log(f"emit at B={B}: {stage['emission kernel']:.4f} ms against a "
        f"{emit_bound:.4f} ms bound ({emit_by}): "
        f"{100 * emit_bound / stage['emission kernel']:.1f}%  [{s.card}]")
    del got_emit, pack
    return {
        "paint": {"launches": launches["paint"], "max_abs_err": err_paint,
                  "ms": stage["paint kernel"], "plain_ms": paint_plain_ms,
                  "bound_ms": paint_bound, "bound_by": paint_by},
        "items": {"launches": launches["items"], "max_abs_err": err_items,
                  "ms": stage["item kernel"], "plain_ms": items_plain_ms,
                  "bound_ms": items_bound, "bound_by": items_by},
        "emit": {"launches": launches["emit"], "max_abs_err": err_emit,
                 "ms": stage["emission kernel"], "plain_ms": emit_plain_ms,
                 "bound_ms": emit_bound, "bound_by": emit_by},
    }


def scan_cell(s: Smoke) -> dict:
    """e1m1-scale-masked, not paint-eligible: render_walls and render
    through K4, the resolve and the shade (and K2 for render)."""
    import warnings

    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.render import resolve as res
    from doomtpu_torch.render import things, walls
    from doomtpu_torch.render.camsort import sort_state
    from doomtpu_torch.wad import synth

    phase("e1m1-scale-masked: the scan + resolve pipeline")
    wad = synth.e1m1_scale_masked_wad()
    cfg = RenderConfig(width=320, height=200, span_capacity=256,
                       mid_capacity=40, clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # GRATE on solid walls
        eng = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=s.dev)
        cpu_eng = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg,
                                            device="cpu")
    lvl = eng.level
    check(not lvl.paint_ok and not lvl.wall_tex_all_opaque,
          "e1m1-scale-masked is paint-eligible")
    log(f"level: {lvl.num_segs} segs, {lvl.num_mobjs} map objects, "
        f"atlas_rows {lvl.atlas_rows}, paint_ok {lvl.paint_ok}")
    state = s.new_game(eng, B)

    # span_capacity: the uncapped peak of this cell, rounded up to 8
    frame, order = s.frame_order(eng, state)
    _, cnt, ovf = walls.wall_scan(lvl, cfg, frame, order)
    peak = int(cnt.max())
    check(int(ovf.sum()) == 0 and peak < cfg.span_capacity,
          f"span pool of {cfg.span_capacity} overflowed measuring the peak")
    cfg = dataclasses.replace(cfg, span_capacity=-(-peak // 8) * 8)
    log(f"span records per column: uncapped peak {peak}, mean "
        f"{cnt.float().mean().item():.2f}; span_capacity "
        f"{cfg.span_capacity}")
    eng = dataclasses.replace(eng, config=cfg)
    cpu_eng = dataclasses.replace(cpu_eng, config=cfg)
    del frame, order, cnt, ovf
    launches = s.main_paths(eng, cpu_eng, state, cfg, "e1m1-scale-masked",
                            "scan")

    # where the time goes: each stage alone on the Morton-sorted batch
    sp, _ = sort_state(state)
    px, py = sp.pos[:, 0], sp.pos[:, 1]
    stage = {}
    stage["camera stage + order"] = event_ms(
        lambda: s.frame_order(eng, sp), 3)
    frame, order = s.frame_order(eng, sp)
    stage["input build (rows)"] = event_ms(
        lambda: s.paint.build_rows(lvl, frame, order), 3)
    rows, scnt = s.paint.build_rows(lvl, frame, order)
    stage["wall-scan kernel"] = event_ms(
        lambda: s.scan.scan(lvl, cfg, rows, scnt), 5)
    probe_scan(s, lvl, cfg, rows, scnt, stage["wall-scan kernel"])
    pool, cnt, _ = walls.wall_scan(lvl, cfg, frame, order)
    poses = (px, py, sp.angle, sp.floor_height)
    resolve = lambda: res.resolve_frame(lvl, cfg, frame, pool, cnt, *poses)
    stage["resolve and shade (kernel)"] = event_ms(resolve, 5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ridx, ld, rgb0 = resolve()
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"resolve: {extra:.2f} GiB above the {base / 2 ** 30:.2f} GiB held "
        f"(its three frames: {3 * ridx.numel() * 4 / 2 ** 30:.2f} GiB)")
    err_resolve, resolve_plain_ms = s.compare_resolve(
        lvl, cfg, frame, pool, cnt, poses,
        f"e1m1-scale-masked B={B} main-path inputs")
    resolve_ms = time_resolve(s, lvl, cfg, pool, cnt, poses)
    unified = lambda: things.pools_from_unified(pool, cnt, frame)
    stage["deferred pass (unified pools + item pool)"] = event_ms(
        lambda: s.item_inputs(eng, sp, frame, order, unified(), cfg), 3)
    pools = unified()
    ipool, icnt, daux = s.item_inputs(eng, sp, frame, order, pools, cfg)
    pack_args = (lvl, cfg, frame, order, px, py, sp.angle, sp.floor_height,
                 sp.sector_light, sp.mobj_state)
    stage["selection + pack"] = event_ms(
        lambda: things._item_pack(*pack_args), 3)
    pack, _ = things._item_pack(*pack_args)
    stage["emission kernel"] = event_ms(
        lambda: s.emit.emit(lvl, cfg, pack, pools[1]), 10, spin=True)
    bg = [ridx, ld, rgb0]
    stage["item kernel"] = s.timed_items(eng, cfg, ipool, icnt, bg, pools[0])
    log(f"stages e1m1-scale-masked at B={B} (CUDA events, ms): "
        + json.dumps({k: round(v, 4) for k, v in stage.items()})
        + f"  [{s.card}]")
    log_deferred_stages(stage, f"e1m1-scale-masked B={B}", s.card)
    log(f"active segs per camera: mean {scnt.float().mean().item():.1f}, max "
        f"{scnt.max().item()} of {lvl.num_segs}")
    check(int(daux["item_peak"].max()) <= cfg.item_capacity,
          "item_capacity below the uncapped peak")

    err_scan, scan_plain_ms = s.compare_scan(
        eng, cfg, rows, scnt, f"e1m1-scale-masked B={B} main-path inputs")
    err_items, items_plain_ms = s.compare_items(
        eng, cfg, ipool, icnt, bg, pools[0],
        f"e1m1-scale-masked B={B} main-path inputs")
    err_emit, _, got_emit = s.compare_emit(
        eng, cfg, pack, pools[1],
        f"e1m1-scale-masked B={B} main-path inputs (unified pool)")
    s.emit_bound(eng, cfg, pack, pools[1], got_emit)
    del got_emit, pack
    log(f"scan at B={B}: kernel {stage['wall-scan kernel']:.4f} ms, plain "
        f"PyTorch {scan_plain_ms:.2f} ms (one call)  [{s.card}]")
    log(f"resolve at B={B}: kernel {resolve_ms[B]:.4f} ms, plain PyTorch "
        f"{resolve_plain_ms:.2f} ms (one call)  [{s.card}]")
    log(f"items at B={B} masked: kernel {stage['item kernel']:.4f} ms, plain "
        f"PyTorch {items_plain_ms:.2f} ms (one call)  [{s.card}]")

    # K4's bound: the row words it reads of the active segs once (14 of
    # a row: seg id, flags, x range, lsx / lex, length, offsets, light,
    # flats, plane heights; 9 per active piece), the counts, the
    # overflow and the occupied slots' 7 words written once (nothing
    # reads a slot past its column's count).  Operations, loosely from
    # above: ~40 per (column, active seg).
    nb = lambda t: t.numel() * t.element_size()
    used = int(cnt.sum())
    r_bytes, n_rows, n_pieces = s.row_bytes(rows, scnt, 14)
    k_in = r_bytes + nb(scnt)
    k_out = nb(cnt) + B * 4 + used * s.scan.POOL_PLANES * 4
    k_ops = 40.0 * float(scnt.sum()) * cfg.width
    scan_bound, scan_by = bound(k_in + k_out, k_ops)
    log(f"bound scan: {k_in + k_out} bytes ({n_rows} active rows with "
        f"{n_pieces} active pieces: {r_bytes} row bytes; {used} occupied "
        f"slots), ~{k_ops:.4g} operations -> {scan_bound:.4f} ms "
        f"({scan_by})")
    s.items_bound(eng, cfg, ipool, icnt, bg, pools[0])
    resolve_bound, resolve_by = s.resolve_bound(cfg, cnt, B)
    return {
        "scan": {"launches": launches["scan"], "max_abs_err": err_scan,
                 "ms": stage["wall-scan kernel"], "plain_ms": scan_plain_ms,
                 "bound_ms": scan_bound, "bound_by": scan_by},
        "resolve": {"launches": launches["resolve"],
                    "max_abs_err": err_resolve, "ms": resolve_ms[B],
                    "plain_ms": resolve_plain_ms, "bound_ms": resolve_bound,
                    "bound_by": resolve_by},
        "items_err": err_items,
        "emit_err": err_emit,
    }


def time_resolve(s: Smoke, lvl, cfg, pool, cnt, poses,
                 batches=(2048, 4096)) -> dict:
    """The resolve kernel's mean device ms over 10 calls on the first n
    cameras of a scan's pool (its per-camera words made once: the trig's
    host read is no part of it), for each n of `batches`, beside its
    bound and the blocks an SM holds; {n: ms}."""
    spans, planes = pool
    out = {}
    for n in batches:
        sub_pool = (spans[:n], [p[:n] for p in planes])
        sub_cnt = cnt[:n].contiguous()
        camf, cami = s.resolve.camera_scalars(*(x[:n] for x in poses))
        ms = event_ms(lambda: s.resolve.resolve(lvl, cfg, sub_pool, sub_cnt,
                                                camf, cami), 10, spin=True)
        bound_ms, by = s.resolve_bound(cfg, sub_cnt, n)
        log(f"resolve kernel B={n} 320x200: {ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({by}, {100 * bound_ms / ms:.1f}%), "
            f"{s.resolve.resolve_blocks_per_sm(cfg.height)} blocks an SM  "
            f"[{s.card}]")
        out[n] = ms
    return out


def livecap_cell(s: Smoke, paint_ms: float) -> None:
    """e1m1-scale render under a live-seg cap, per-camera lists (as
    bench.py runs the JAX package, bench.py:89-91), the cap calibrated
    by hand from the measured per-camera live peak of the 4096 poses as
    JAX calibrate.py:308 rounds it (round_up(peak + 1, 32)): K1 (with
    its drop mask, all clear) and K2, live_dropped 0, the same frames as
    the paint cell's uncapped render, and K1 timed against the uncapped
    kernel's `paint_ms`."""
    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.render.camsort import sort_state
    from doomtpu_torch.wad import synth

    phase("e1m1-scale: the paint path under a live-seg cap")
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True, paint_percam_compact=True)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=s.dev)
    state = s.new_game(eng, B)
    sp, _ = sort_state(state)
    _, order, args = s.stage_inputs(eng, sp)
    _, _, cnt = s.paint.live_lists(cfg, args[0], args[1], order)
    peak = int(cnt.max())
    cfg = dataclasses.replace(cfg, paint_live_capacity=-(-(peak + 1) // 32)
                              * 32)
    log(f"live segs per (camera, 128-column block): peak {peak}, mean "
        f"{cnt.float().mean().item():.2f} of {eng.level.num_segs} segs; "
        f"paint_live_capacity {cfg.paint_live_capacity}, per camera")
    eng = dataclasses.replace(eng, config=cfg)
    cpu_eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device="cpu")
    s.main_paths(eng, cpu_eng, state, cfg, "e1m1-scale live cap", "paint",
                 with_walls=False)
    check(s.checksums["render e1m1-scale live cap"]
          == s.checksums["render e1m1-scale"],
          "the capped render's frames differ from the uncapped render's")
    drop, dropped = s.paint.live_drop(cfg, args[0], args[1], order)
    check(int(dropped) == 0 and not bool(drop.any()),
          f"the calibrated cap drops {int(dropped)} live segs")
    capped_ms = event_ms(lambda: s.paint.paint(eng.level, cfg, *args, drop),
                         5)
    log(f"paint at B={B} under the cap (drop mask read, all clear): "
        f"{capped_ms:.4f} ms against {paint_ms:.4f} ms uncapped  [{s.card}]")


def itempass_cell(s: Smoke) -> dict:
    """e1m1-scale with use_item_pass_kernel: render through K1 and K3,
    every selected item drawn (no item pool, no item cap).  The same map,
    poses and pools as the paint cell, whose render takes the deferred
    pass and K2."""
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.render import camera as cam
    from doomtpu_torch.render import things
    from doomtpu_torch.render.camsort import sort_state, unsort_out
    from doomtpu_torch.render.frame import itempass_available
    from doomtpu_torch.wad import synth

    phase("e1m1-scale: the item pass")
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, use_item_pass_kernel=True,
                       use_pallas_paint=True)
    log(f"config: {cfg.width}x{cfg.height} mid_capacity={cfg.mid_capacity} "
        f"clip_capacity={cfg.clip_capacity} use_item_pass_kernel="
        f"{cfg.use_item_pass_kernel} (item_capacity {cfg.item_capacity} "
        f"unused)")
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=s.dev)
    check(itempass_available(eng.level, cfg, B),
          "e1m1-scale does not take the item pass")
    state = s.new_game(eng, B)
    cpu_eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device="cpu")
    launches = s.main_paths(eng, cpu_eng, state, cfg, "e1m1-scale item pass",
                            "paint", item_kernel="itempass", with_walls=False)
    # the paint cell's deferred pass dropped no item on these poses (its
    # uncapped peak fits its item pool), so both draw the same frames
    check(s.checksums["render e1m1-scale item pass"]
          == s.checksums["render e1m1-scale"],
          "the item pass and the drop-free deferred pass disagree")

    # where the time goes: each stage alone on the Morton-sorted batch
    sp, _ = sort_state(state)
    lvl = eng.level
    px, py = sp.pos[:, 0], sp.pos[:, 1]
    stage = {}
    stage["camera stage + order"] = event_ms(lambda: (
        cam.build_seg_frame(lvl, cfg, px, py, sp.angle, sp.floor_height,
                            sp.sector_light, sp.timestamp),
        cam.seg_order(lvl, cam.traversal_rank(lvl, px, py))), 3)
    frame, order, args = s.stage_inputs(eng, sp)
    stage["paint input build"] = event_ms(lambda: s.paint.build_inputs(
        lvl, cfg, frame, order, sp.angle, px, py, sp.floor_height), 3)
    stage["paint kernel"] = event_ms(lambda: s.paint.paint(lvl, cfg, *args), 5)
    out = s.paint.paint(lvl, cfg, *args)
    pack_args = (lvl, cfg, frame, order, px, py, sp.angle, sp.floor_height,
                 sp.sector_light, sp.mobj_state)
    stage["item pack"] = event_ms(lambda: things.item_pack(*pack_args), 3)
    pack, _ = things.item_pack(*pack_args)
    stage["item-pass kernel"] = s.timed_itempass(eng, cfg, pack, out)
    probe_itempass(s, lvl, cfg, pack, s.fresh(out), stage["item-pass kernel"])
    stage["sort + unsort"] = event_ms(
        lambda: unsort_out((out["idx"], out["rgb"]), sort_state(state)[1]), 3)
    log(f"stages e1m1-scale item pass at B={B} (CUDA events, ms): "
        + json.dumps({k: round(v, 4) for k, v in stage.items()})
        + f"  [{s.card}]")

    # K3 against its plain version on the path's own inputs, whole batch
    err, plain_ms, got = s.compare_itempass(
        eng, cfg, pack, out, f"e1m1-scale B={B} main-path inputs")
    log(f"itempass at B={B}: kernel {stage['item-pass kernel']:.4f} ms, "
        f"plain PyTorch {plain_ms:.2f} ms (one call)  [{s.card}]")
    bound_ms, bound_by = s.itempass_bound(eng, cfg, pack, out, got)
    return {"itempass": {"launches": launches["itempass"], "max_abs_err": err,
                         "ms": stage["item-pass kernel"], "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}}


# control masks of the moving rollouts (sim/player.py's bits): walk, turn,
# strafe, back up and run, one a camera in turn
MOVES = (1, 1 | 4, 1 | 8, 2, 16 | 4, 1 | 32, 4, 16 | 8 | 32)


def moving_rollout(dev, cfg, live_reuse, n=16, ticks=4, seed=3):
    """An n-camera rollout of `ticks` ticks of moving controls on
    e1m1-scale under `cfg`, on the card and through the CPU port, with
    the same light draws.  Returns (differing elements per output: the
    final state field by field and the idx frames; the card's
    live_stale; the CPU port's; the card's kernel launches)."""
    import numpy as np
    import torch

    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.ops import emit, itempass, items, paint, resolve, scan
    from doomtpu_torch.wad import synth

    kernels = {"paint": paint.paint, "items": items.composite_items,
               "scan": scan.scan, "itempass": itempass.item_pass,
               "resolve": resolve.resolve, "emit": emit.emit}
    wad = synth.e1m1_scale_wad()
    card = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=dev)
    cpu = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device="cpu")
    pos, ang = spread_poses(card.tables, n, seed)
    controls = np.resize(np.asarray(MOVES, np.int32), (ticks, n))
    draws = torch.randint(0, 1 << 30, (ticks, 2, n, card.level.num_sectors),
                          generator=torch.Generator().manual_seed(seed),
                          dtype=torch.int32)
    runs = []
    for eng in (card, cpu):
        st = eng.new_game(n, pos=pos, angle=ang,
                          generator=torch.Generator().manual_seed(seed))
        for fn in kernels.values():
            fn.launches = 0
        r = eng.rollout(st, controls, draws=draws, live_reuse=live_reuse)
        if eng is card:
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in kernels.items()}
        runs.append(r)
    (fc, frames_c, *stale_c), (fp, frames_p, *stale_p) = runs
    diffs = {f.name: (getattr(fc, f.name).cpu() != getattr(fp, f.name)).sum()
             .item() for f in dataclasses.fields(fc)}
    diffs["frames"] = (frames_c.cpu() != frames_p).sum().item()
    stale = lambda x: int(x[0]) if x else None
    return diffs, stale(stale_c), stale(stale_p), launches


def rollout_cell(s: Smoke) -> None:
    """e1m1-scale rollouts, as bench.py's rollout cell runs them
    (bench.py:208-280): T=32 ticks of zero controls, checksums, per-camera
    live lists under the cap `livecap_cell` sets, with and without
    cross-tick live-list reuse; each tick renders through K1 and K2.
    Then a 16-camera rollout of moving controls with reuse (live_stale >
    0, so K1 reads drop bits set by the reuse) and one on the scan path
    (K4), each against the CPU port."""
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.render import camera as cam
    from doomtpu_torch.render.camsort import sort_state
    from doomtpu_torch.sim import player, thinkers
    from doomtpu_torch.wad import synth

    phase("e1m1-scale: the rollout")
    T = 32
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True, paint_percam_compact=True)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=s.dev)
    state = s.new_game(eng, B)
    sp, _ = sort_state(state)
    _, order, args = s.stage_inputs(eng, sp)
    _, _, cnt = s.paint.live_lists(cfg, args[0], args[1], order)
    cfg = dataclasses.replace(cfg, paint_live_capacity=-(-(int(cnt.max())
                                                           + 1) // 32) * 32)
    eng = dataclasses.replace(eng, config=cfg)
    del sp, order, args, cnt
    log(f"config: {cfg.width}x{cfg.height} B={B} T={T} zero controls, "
        f"return_frames=False, paint_live_capacity "
        f"{cfg.paint_live_capacity} per camera")
    controls = torch.zeros((T, B), dtype=torch.int32, device=s.dev)
    gen = torch.Generator(s.dev).manual_seed(0)
    sec = eng.level.num_sectors
    draws = torch.stack([thinkers.draw_lights(gen, B, sec) for _ in range(T)])
    run = {True: lambda st: eng.rollout(st, controls, draws=draws,
                                        return_frames=False, live_reuse=True),
           False: lambda st: eng.rollout(st, controls, draws=draws,
                                         return_frames=False)}
    sums = {}
    for reuse in (True, False):
        what = f"rollout live_reuse={reuse}"
        s.zero_counts()
        out = run[reuse](state)
        torch.cuda.synchronize()
        got = s.counts()
        log(f"main path {what} B={B} T={T}: launches {got}; per tick "
            + json.dumps({k: v / T for k, v in got.items()}))
        check(got == {"paint": T, "items": T, "scan": 0, "itempass": 0,
                      "resolve": 0, "emit": T},
              f"{what}: launches {got}, want K1, the emission and K2 once "
              f"a tick")
        final, sums[reuse] = out[0], out[1]
        check(tuple(sums[reuse].shape) == (T, B)
              and int(final.tick[0]) == T, f"{what}: output shapes")
        if reuse:
            stale = int(out[2])
            log(f"{what}: live_stale {stale}")
            check(stale == 0, f"{what}: live_stale {stale} with zero controls")
        counters = eng.render_counters(final)
        log(f"render_counters of the final state ({what}): {counters}")
        check(all(v == 0 for v in counters.values()),
              f"{what}: capacity counters not 0: {counters}")
    check(torch.equal(sums[True], sums[False]),
          "the reuse and no-reuse rollouts' checksums differ")
    # timed in turns, reuse / plain / plain / reuse, a rollout each
    times, peaks = {True: [], False: []}, {True: 0.0, False: 0.0}
    for reuse in (True, False, False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run[reuse](state)
        torch.cuda.synchronize()
        times[reuse].append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(out[1], sums[reuse]),
              f"rollout live_reuse={reuse}: checksums moved between runs")
        peaks[reuse] = max(peaks[reuse],
                           torch.cuda.max_memory_allocated() / 2 ** 30)
    for reuse in (True, False):
        ms = sum(times[reuse]) / 2
        log(f"rollout live_reuse={reuse} 320x200 B={B} T={T}: {ms:.3f} ms "
            f"a rollout ({' and '.join(f'{t:.3f}' for t in times[reuse])}),"
            f" {ms / T:.3f} ms a tick, {T * B / ms * 1e3:.1f} step+render "
            f"frames/s, peak {peaks[reuse]:.2f} GiB, checksum "
            f"{int(sums[reuse].sum())}  [{s.card}]")
    ms = sum(times[True]) / 2
    launches, busy, idle = profile_render(
        run[True], state, s.card, ms, "one rollout (live_reuse)", warm=False)
    log(f"rollout live_reuse=True: {launches / T:.1f} kernel launches a "
        f"tick, device busy {busy / T:.3f} ms a tick, idle share "
        f"{idle:.4f}  [{s.card}]")

    # where a tick's time goes: the tick, and the stages reuse swaps
    # (CUDA events, on the Morton-sorted batch)
    sp, _ = sort_state(state)
    lvl = eng.level
    px, py = sp.pos[:, 0], sp.pos[:, 1]
    rank = cam.traversal_rank(lvl, px, py)
    order = cam.seg_order(lvl, rank)
    frame = cam.build_seg_frame(lvl, cfg, px, py, sp.angle, sp.floor_height,
                                sp.sector_light, sp.timestamp)
    rows, scnt = s.paint.build_rows(lvl, frame, order)
    kept = s.paint.kept_set(cfg, rows, scnt, order)
    stage = {
        "tick": event_ms(lambda: eng.tick(sp, controls[0], draws=draws[0]),
                         5),
        "tick: move_player": event_ms(lambda: player.move_player(
            lvl, sp.pos, sp.angle, controls[0]), 5),
        "tick: lights + mobjs": event_ms(lambda: (
            thinkers.step_lights(eng.thinkers, sp.sector_light,
                                 sp.light_count, sp.light_up, draws[0]),
            thinkers.step_mobjs(lvl, sp.mobj_state, sp.mobj_tics)), 5),
        "traversal_rank": event_ms(
            lambda: cam.traversal_rank(lvl, px, py), 5),
        "seg_order (fresh tick)": event_ms(
            lambda: cam.seg_order(lvl, rank), 5),
        "order_matches_rank (reuse tick)": event_ms(
            lambda: cam.order_matches_rank(lvl, rank, order), 5),
        "live_drop (fresh tick)": event_ms(
            lambda: s.paint.live_drop(cfg, rows, scnt, order), 5),
        "kept_set (refresh tick)": event_ms(
            lambda: s.paint.kept_set(cfg, rows, scnt, order), 5),
        "reuse_drop (reuse tick)": event_ms(
            lambda: s.paint.reuse_drop(cfg, rows, scnt, order, kept), 5),
    }
    log(f"stages of a rollout tick at B={B} (CUDA events, ms): "
        + json.dumps({k: round(v, 4) for k, v in stage.items()})
        + f"  [{s.card}]")
    log(f"tick alone at B={B} (CUDA events): {stage['tick']:.4f} ms  "
        f"[{s.card}]")
    del state, sp, draws, sums, out, frame, rows, kept

    # moving cameras: reuse with stale segs (K1's drop bits set by the
    # reuse), then the scan path (K4), 16 cameras against the CPU port
    for label, c, reuse, want in (
            ("paint, live_reuse", cfg, True,
             {"paint": 4, "items": 4, "emit": 4}),
            ("scan + resolve", dataclasses.replace(
                cfg, use_pallas_paint=False, span_capacity=96), False,
             {"scan": 4, "resolve": 4, "items": 4, "emit": 4})):
        t0 = time.perf_counter()
        diffs, stale, stale_cpu, got = moving_rollout(s.dev, c, reuse)
        log(f"moving rollout B=16 T=4 {label} vs the CPU port "
            f"({time.perf_counter() - t0:.1f} s): differing elements "
            f"{json.dumps(diffs)}; live_stale {stale} (CPU {stale_cpu}); "
            f"launches {got}")
        check(all(v == 0 for v in diffs.values()),
              f"moving rollout {label}: card and CPU port disagree")
        check(stale == stale_cpu, f"moving rollout {label}: live_stale "
              f"{stale} on the card, {stale_cpu} on the CPU")
        check(all(got[k] == want.get(k, 0) for k in got),
              f"moving rollout {label}: launches {got}, want {want}")
        # more stale than cameras whose order went stale: the paint
        # stage's own term, the drop bits, is not 0
        check(not reuse or stale > 16 * 3,
              f"moving rollout {label}: live_stale {stale}, no drop bit "
              f"set by the reuse")


def calibration_cell(s: Smoke) -> None:
    """e1m1-scale calibration as bench.py runs it (bench.py:136-180):
    bench.py's config (per-camera live lists, render_chunk 256) and its
    33-state chain of zero controls, made with the port's tick, censused
    by engine.calibrate with the cache off.  On the card the census's
    wall scan is K4.  Then every counter 0 on chain states 0, 16 and 32
    under the calibrated config, on the paint and the scan path; the
    card's calibrated config equal to the CPU port's on 16 cameras x 4
    states; and render timed at the calibrated pools beside the hand
    pools of the other cells, frames equal."""
    import torch

    from doomtpu_torch.calibrate import calibrated_config
    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.wad import synth

    phase("e1m1-scale: calibration")
    t_phase = time.perf_counter()
    cfg = RenderConfig(width=320, height=200, use_pallas_paint=True,
                       paint_percam_compact=True)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=s.dev)
    controls = torch.zeros((B,), dtype=torch.int32, device=s.dev)
    gen = torch.Generator(s.dev).manual_seed(1)
    chain = [s.new_game(eng, B)]
    for _ in range(32):
        chain.append(eng.tick(chain[-1], controls, gen))
    os.environ["DOOMTPU_CALIB_CACHE"] = "0"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s.zero_counts()
    t0 = time.perf_counter()
    cal = eng.calibrate(chain)
    torch.cuda.synchronize()
    census_s = time.perf_counter() - t0
    got = s.counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    c = cal.config
    log(f"calibrated config B={B}, {len(chain)} states: span_capacity "
        f"{c.span_capacity} mid_capacity {c.mid_capacity} clip_capacity "
        f"{c.clip_capacity} item_capacity {c.item_capacity} "
        f"max_visible_mobjs {c.max_visible_mobjs} item_block_capacity "
        f"{c.item_block_capacity} paint_live_capacity "
        f"{c.paint_live_capacity} (render_chunk {c.render_chunk}, "
        f"paint_percam_compact {c.paint_percam_compact})")
    log(f"census (engine.calibrate) B={B} x {len(chain)} states: "
        f"{census_s:.3f} s, launches {got}, peak {peak:.2f} GiB  [{s.card}]")
    check(got["scan"] > 0, "the census launched no wall-scan kernel")
    check(got["paint"] == got["items"] == got["itempass"]
          == got["resolve"] == got["emit"] == 0,
          f"the census launched a render kernel: {got}")

    scan_cal = dataclasses.replace(
        cal, config=dataclasses.replace(c, use_pallas_paint=False))
    for label, e, want in (("paint", cal, "paint"),
                           ("scan + resolve", scan_cal, "scan")):
        for i in (0, 16, 32):
            s.zero_counts()
            counters = e.render_counters(chain[i])
            log(f"render_counters under the calibrated config, {label} "
                f"path, chain state {i}: {counters}; launches {s.counts()}")
            check(s.counts()[want] == 1, f"{label}: pipeline not taken")
            check(all(v == 0 for v in counters.values()),
                  f"calibrated config, {label} path, state {i}: counters "
                  f"not 0: {counters}")

    # the card's census against the CPU port's on a slice of the chain
    sel = torch.linspace(0, B - 1, 16).long().to(s.dev)
    cpu_eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                        config=cfg, device="cpu")
    sub = [st.map(lambda x: x[sel]) for st in chain[:4]]
    t0 = time.perf_counter()
    on_card = calibrated_config(eng, sub, cache=False)
    on_cpu = calibrated_config(cpu_eng, [st.map(lambda x: x.cpu())
                                         for st in sub], cache=False)
    differ = {f: (getattr(on_card, f), getattr(on_cpu, f))
              for f in (f.name for f in dataclasses.fields(on_card))
              if getattr(on_card, f) != getattr(on_cpu, f)}
    log(f"calibrated config of 16 cameras x 4 states, card vs CPU port "
        f"({time.perf_counter() - t0:.1f} s): fields that differ {differ}")
    check(not differ, "the card's census and the CPU port's disagree")

    # render at the calibrated pools beside the hand pools, in turns
    hand = dataclasses.replace(eng, config=dataclasses.replace(
        cfg, mid_capacity=40, clip_capacity=64, item_capacity=24))
    st = chain[0]
    for a, b in zip(cal.render(st), hand.render(st)):
        check(torch.equal(a, b), "calibrated and hand pools draw different "
              "frames")
    del chain, sub, scan_cal
    torch.cuda.empty_cache()
    times = {"calibrated": [], "hand": []}
    for which in ("calibrated", "hand", "hand", "calibrated"):
        e = cal if which == "calibrated" else hand
        times[which].append(s.time_path(e.render, st, f"render e1m1-scale "
                                        f"{which} pools"))
    sums = {s.checksums[f"render e1m1-scale {w} pools"] for w in times}
    check(len(sums) == 1, f"checksums differ: {sums}")
    for which, ms in times.items():
        log(f"render e1m1-scale {which} pools: mean {sum(ms) / 2:.3f} ms "
            f"({' and '.join(f'{t:.3f}' for t in ms)})  [{s.card}]")
    log(f"phase e1m1-scale calibration: {time.perf_counter() - t_phase:.1f} "
        f"s  [{s.card}]")


def split_cell(s: Smoke) -> None:
    """The batch split over devices (doomtpu_torch/parallel): 64 cameras
    in two shards on [cuda, cuda:0], driven by a SplitEngine over an
    engine whose home is the CPU (so each shard runs against the copy of
    the level on the card), against the unsplit card engine: render,
    both counter calls (the per-shard sums), and a 4-tick live-reuse
    rollout.  `cuda` and `cuda:0` name one card: one copy."""
    import numpy as np
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.parallel import SplitEngine
    from doomtpu_torch.wad import synth

    phase("the split on the card")
    t_phase = time.perf_counter()
    n, T = 64, 4
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True, paint_percam_compact=True)
    wad = synth.e1m1_scale_wad()
    card = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=s.dev)
    home = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device="cpu")
    state = s.new_game(card, n)
    split_engine = SplitEngine(home, ["cuda", "cuda:0"])
    split = split_engine.shard(state)
    check([sh.device for sh in split.shards] == [state.device] * 2
          and list(split_engine.engines) == [state.device],
          f"shards not on the card: {split_engine.mesh}")
    check(SplitEngine(card, ["cuda"]).engines[state.device] is card,
          "the card engine's own device got a copy")
    s.zero_counts()
    got = split_engine.render(split)
    torch.cuda.synchronize()
    launches = s.counts()
    want = card.render(state)
    diff = sum(int((a != b).sum()) for a, b in zip(got, want))
    log(f"split render B={n} in 2 shards: launches {launches}; differing "
        f"elements against the unsplit render {diff}")
    check(got[0].is_cuda and launches["paint"] == 2
          and launches["items"] == launches["emit"] == 2,
          f"split render: launches {launches}")
    check(diff == 0, "split and unsplit renders differ")
    for call in ("render_counters", "render_walls_counters"):
        c_split = getattr(split_engine, call)(split)
        per = [getattr(card, call)(sh) for sh in split.shards]
        c_sum = {k: sum(p[k] for p in per) for k in c_split}
        log(f"split {call}: {c_split}; per-shard sums {c_sum}")
        check(c_split == c_sum == getattr(card, call)(state),
              f"split {call} differs")
    controls = torch.as_tensor(np.resize(np.asarray(MOVES, np.int32),
                                         (T, n)))
    draws = torch.randint(0, 1 << 30, (T, 2, n, card.level.num_sectors),
                          generator=torch.Generator().manual_seed(2),
                          dtype=torch.int32)
    s.zero_counts()
    fs, frames_s, stale_s = split_engine.rollout(split, controls,
                                                 draws=draws,
                                                 live_reuse=True)
    torch.cuda.synchronize()
    launches = s.counts()
    fu, frames_u, stale_u = card.rollout(state, controls, draws=draws,
                                         live_reuse=True)
    diff = int((frames_s != frames_u).sum()) + sum(
        int((getattr(fs.gather(), f.name) != getattr(fu, f.name)).sum())
        for f in dataclasses.fields(fu))
    log(f"split rollout B={n} T={T} live_reuse: launches {launches}; "
        f"live_stale {int(stale_s)} (unsplit {int(stale_u)}); differing "
        f"elements against the unsplit rollout {diff}")
    check(launches["paint"] == 2 * T
          and launches["items"] == launches["emit"] == 2 * T,
          f"split rollout: launches {launches}")
    check(diff == 0 and int(stale_s) == int(stale_u),
          "split and unsplit rollouts differ")
    log(f"phase split: {time.perf_counter() - t_phase:.1f} s  [{s.card}]")


def cli_cell(s: Smoke) -> None:
    """The shell on the card: `python -m doomtpu_torch.cli --synth demo
    --walk --steps 35 --out <tmp>.npy` in a process of its own; its dump
    equals the engine's frame after the same ticks (render, then tick,
    each step: the last frame follows 34 ticks)."""
    import tempfile

    import numpy as np
    import torch

    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP
    from doomtpu_torch.wad import synth

    phase("the shell on the card")
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame.npy")
        p = subprocess.run(
            [sys.executable, "-m", "doomtpu_torch.cli", "--synth", "demo",
             "--walk", "--steps", "35", "--out", out],
            cwd=root, capture_output=True, text=True, timeout=600)
        log(f"cli: exit {p.returncode} ({time.perf_counter() - t0:.1f} s); "
            f"stdout {p.stdout.strip()[-200:]!r}")
        check(p.returncode == 0, f"cli failed:\n{p.stderr[-4000:]}")
        dump = np.load(out)
    eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", device=s.dev)
    gen = torch.Generator(s.dev).manual_seed(0)
    state = eng.new_game(1, generator=gen)
    walk = torch.full((1,), KEY_UP | KEY_LEFT, dtype=torch.int32)
    for _ in range(34):
        state = eng.tick(state, walk, gen)
    ref = eng.render(state)[1].cpu().numpy()
    diff = int((dump != ref).sum()) if dump.shape == ref.shape else -1
    log(f"cli dump {dump.shape} {dump.dtype} against the engine's frame "
        f"after 34 ticks: differing elements {diff}")
    check(diff == 0 and (ref != 0).any(), "cli dump differs from the engine")
    log(f"phase shell: {time.perf_counter() - t0:.1f} s  [{s.card}]")


def picture_lumps(wad):
    """Every picture lump of a WAD: its patches (PNAMES) and sprites."""
    from doomtpu_torch.assets.textures import TextureStore

    store = TextureStore(wad)
    return [(n, wad.lump(n)) for n in store.pnames if wad.has(n)] + [
        (e.name, wad.lump_at(e)) for e in wad.sprite_entries()
        if wad.lump_at(e).size > 8]


def check_native_decoder(card: str) -> None:
    """ops/native.py: the port's decoder built with the host C++ compiler,
    every picture of four WADs decoded as the NumPy decode does."""
    from unittest import mock

    from doomtpu_torch.assets import pictures
    from doomtpu_torch.ops import build, native
    from doomtpu_torch.wad import synth
    from doomtpu_torch.wad.reader import WadFile

    t0 = time.perf_counter()
    native.build()
    check(native.available(), "the native decoder did not load")
    lumps = [(wad_fn, name, raw) for wad_fn in (
        "demo_wad", "e1m1_scale_wad", "doom1_scale_wad", "decoder_wad")
        for name, raw in picture_lumps(WadFile(getattr(synth, wad_fn)()))]
    numpy_only = mock.patch.object(native, "decode_picture", lambda *a: None)
    for wad_fn, name, raw in lumps:
        with numpy_only:
            want = pictures.decode_picture(raw, name)
        got = native.decode_picture(raw, want.width, want.height)
        check(got is not None and (got[0] == want.pixels).all()
              and (got[1] == want.mask).all(),
              f"native decode of {wad_fn} {name} differs")
    check(len(lumps) > 50, f"only {len(lumps)} pictures")
    build_s = time.perf_counter() - t0

    def decode_all_ms():
        t = time.perf_counter()
        for _, name, raw in lumps:
            pictures.decode_picture(raw, name)
        return (time.perf_counter() - t) * 1e3

    # assets/pictures.py both ways, in turns, best of 5 each
    ms = {"native": [], "numpy": []}
    for _ in range(5):
        ms["native"].append(decode_all_ms())
        with numpy_only:
            ms["numpy"].append(decode_all_ms())
    log(f"native decoder ({build.host_library_path('doomdec').name}, "
        f"{build.cxx_path()}): {len(lumps)} pictures of 4 WADs "
        f"({sum(r.size for *_, r in lumps)} bytes) equal to the NumPy "
        f"decode, {build_s:.2f} s with the build; decode_picture over all "
        f"of them, host clock, best of 5 in turns: native "
        f"{min(ms['native']):.3f} ms, NumPy {min(ms['numpy']):.3f} ms  "
        f"[{card}]")


def probes_cell(s: Smoke) -> dict:
    """The Hopper probes P1-P4 (ops/probe_visit.py, ops/probe_ybounds.py).
    First each probe kernel against its plain version on the card: every
    P1 construct at N = 64 on both launch shapes (and mxu13diff / mxu13hi
    with w read from shared memory at the occupancy shape), P2 on every
    input, P2 and P3 on the control input (exact in TF32), at one copy
    and at OCCUPANCY_COPIES (every copy written, and one slice written),
    P4 every mode at S = 64 and 4096 serial (chunks = 1), at the
    full-card chunking and at 7 chunks (which divide neither); 0
    differing elements.  Then the probes' own path, with their counts
    set to 0 just before and read after: every construct at N = 40000
    on both shapes beside its bound (the operations it needs,
    ops/probe_visit.py::NEEDS) and its SASS count, P2's and P3's bad
    counts, their turns with torch.matmul (TF32 allowed for P2, not for
    P3; exact_turns) and their price of a field at full-card occupancy,
    written and one slice written (exact_price), beside P1's, the price
    of a field with w in registers against w from shared memory
    (field_variants), P4's modes at S = 4096 serial and at the full-card
    chunking; then torch.matmul's bad counts on P2 / P3's operands, and
    the native picture decoder.  A spill in P1's tensor-core kernels,
    P2 / P3's or P4's fails.  Returns the four kernel rows' numbers."""
    import torch

    from doomtpu_torch.ops import build
    from doomtpu_torch.ops import probe_visit as pv
    from doomtpu_torch.ops import probe_ybounds as pyb

    phase("Hopper probes P1-P4")
    dev, card = s.dev, s.card
    # a probe that spills prices its local-memory traffic too: reported,
    # not a failure (no probe is on a path of the engine)
    spills = {}
    for name in PROBE_LIBS:
        for fn, r in build.ptxas_resources(build.nvcc_output(name)).items():
            if "registers" in r:
                log(f"resources {name} {fn}: {json.dumps(r)}")
            if r.get("spill_stores") or r.get("spill_loads"):
                spills[fn] = r
    log(f"probe kernels that spill registers: {json.dumps(spills)}")
    redesigned = ("mma_kernel", "exact_kernel", "ybounds_kernel")
    check(not any(k in fn for fn in spills for k in redesigned),
          f"P1's tensor-core kernels, P2 / P3 or P4 spill registers: "
          f"{json.dumps(spills)}")
    diff = lambda g, r: (int((g != r).sum()),
                         int((g.long() - r.long()).abs().max()))
    fdiff = lambda g, r: float((g.view(torch.float32).double()
                                - r.view(torch.float32).double())
                               .abs().max())
    rows = {k: {"max_abs_err": 0, "plain_ms": 0.0}
            for k in ("probe_visit", "probe_exact1", "probe_exact3",
                      "probe_ybounds")}
    inputs = pv.device_inputs(dev)
    for name in pv.CONSTRUCTS:
        x, t, arg = inputs[name]
        shapes = list(pv.configs(dev, name).values())
        if name in pv.W_FROM_SMEM:    # w's fragments from shared memory
            shapes.append((*shapes[-1], True))
        copies = max(pv.copies_of(name, *sh[:2]) for sh in shapes)
        got, ref, ms = against_plain(
            lambda: [pv.construct(name, x, t, pv.CHECK_N, arg, *sh)
                     for sh in shapes],
            lambda: pv.construct_reference(name, x, t, pv.CHECK_N, arg,
                                           copies))
        for g, sh in zip(got, shapes):
            n_bad, worst = diff(g, ref[:g.shape[0]])
            check(n_bad == 0, f"probe {name} {sh}: {n_bad} elements differ "
                  f"from the plain version (N={pv.CHECK_N}, {g.shape[0]} "
                  f"copies)")
            rows["probe_visit"]["max_abs_err"] = max(
                rows["probe_visit"]["max_abs_err"], worst)
        rows["probe_visit"]["plain_ms"] += ms
    # branchy_mxu's vote group: one element's test takes the branch for
    # its warp's 32 lanes of all 8 rows
    vx, vt = (torch.from_numpy(v).to(dev) for v in pv.vote_inputs())
    for sh in pv.configs(dev, "branchy_mxu").values():
        g = pv.construct("branchy_mxu", vx, vt, 1, 0, *sh)
        n_bad = diff(g, pv.construct_reference("branchy_mxu", vx, vt, 1, 0,
                                               g.shape[0]))[0]
        check(n_bad == 0, f"probe branchy_mxu {sh} on vote_inputs: {n_bad} "
              f"elements differ from the plain version")
    log(f"P1: {len(pv.CONSTRUCTS)} constructs x 2 launch shapes (and "
        f"{', '.join(pv.W_FROM_SMEM)} with w from shared memory) equal to "
        f"their plain versions at N={pv.CHECK_N} (plain versions "
        f"{rows['probe_visit']['plain_ms']:.1f} ms in all)  [{card}]")
    sel = torch.from_numpy(pv.exact_selectors()).to(dev)
    ws = {k: torch.from_numpy(v).to(dev) for k, v in pv.exact_inputs().items()}
    for name, w in ws.items():
        g1, r1, ms1 = against_plain(lambda: pv.exact1(w, sel),
                                    lambda: pv.exact1_reference(w, sel))
        check(diff(g1, r1)[0] == 0, f"P2 {name}: differs from its plain "
              f"version in {diff(g1, r1)[0]} elements")
        g3, r3, ms3 = against_plain(lambda: pv.exact3(w, sel),
                                    lambda: pv.exact3_reference(w, sel))
        if name == "control":
            exact = pv.broadcast(w)
            check(diff(g1, exact)[0] == 0 and diff(g3, exact)[0] == 0,
                  "P2 / P3 differ from the exact broadcast on the control "
                  "input (exact in TF32)")
        rows["probe_exact1"]["max_abs_err"] = max(
            rows["probe_exact1"]["max_abs_err"], fdiff(g1, r1))
        rows["probe_exact3"]["max_abs_err"] = max(
            rows["probe_exact3"]["max_abs_err"], fdiff(g3, r3))
        if name == "f32":    # the input the kernels are timed on
            rows["probe_exact1"]["plain_ms"] = ms1
            rows["probe_exact3"]["plain_ms"] = ms3
        # the full-card shape: every copy written, and one slice written
        n_occ = pv.OCCUPANCY_COPIES
        for stored in (n_occ, 1):
            n_bad = int((pv.exact1(w, sel, n_occ, stored)
                         != pv.exact1_reference(w, sel, n_occ, stored)).sum())
            check(n_bad == 0, f"P2 {name} x {n_occ} copies, {stored} "
                  f"written: differs from its plain version in {n_bad} "
                  f"elements")
            if name == "control":
                exact = pv.broadcast(w)
                n_bad = [int((fn(w, sel, n_occ, stored) != exact).sum())
                         for fn in (pv.exact1, pv.exact3)]
                check(n_bad == [0, 0], f"P2 / P3 x {n_occ} copies, {stored} "
                      f"written, differ from the exact broadcast on the "
                      f"control input in {n_bad} elements")
            torch.cuda.empty_cache()
    for n_emit in (pyb.CHECK_S, pyb.S):
        lo, hi = (torch.from_numpy(v).to(dev)
                  for v in pyb.ybounds_inputs(n_emit))
        for mode in pyb.MODES:
            got, ref, ms = against_plain(
                lambda: [pyb.ybounds(lo, hi, mode, c) for c in (1, None, 7)],
                lambda: pyb.ybounds_reference(lo, hi, mode))
            for g, c in zip(got, (1, pyb.full_chunks(mode), 7)):
                n_bad, worst = diff(g, ref)
                check(n_bad == 0, f"P4 {mode} S={n_emit} chunks={c}: "
                      f"{n_bad} elements differ from the plain version")
            if n_emit == pyb.S:
                rows["probe_ybounds"]["plain_ms"] += ms
    log(f"P2 on 3 inputs, P3 and P2 on the control input (at 1 and "
        f"{pv.OCCUPANCY_COPIES} copies, all or one written), P4's "
        f"{len(pyb.MODES)} modes at S={pyb.CHECK_S} and {pyb.S} in 1, "
        f"{pyb.full_chunks('union')} (full card) and 7 chunks: equal to "
        f"their plain versions  [{card}]")

    # ---- the probes' own path ---------------------------------------
    counted = {"probe_visit": pv.construct, "probe_exact1": pv.exact1,
               "probe_exact3": pv.exact3, "probe_ybounds": pyb.ybounds}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    p1 = pv.measure(dev, reps=2, card=card, log=log)
    pv.exactness(dev, card=card, log=log)
    w = ws["f32"]
    turns = exact_turns(pv, dev)
    price = exact_price(pv, dev, pv.OCCUPANCY_COPIES)
    log_exact(turns, price, pv.p1_field_ns(p1, dev), card)
    variants = field_variants(pv, dev, card)
    p4_serial = pyb.measure(dev, card=card, chunks=1, log=log)
    p4 = pyb.measure(dev, card=card, log=log)
    for k, fn in counted.items():
        rows[k]["launches"] = fn.launches
        check(fn.launches > 0, f"{k}: the probes' path launched no kernel")
    log(f"the probes' path: {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps({k: r['launches'] for k, r in rows.items()})}")
    for name in pv.CONSTRUCTS:
        check(p1[name]["bound_ns"] > 0, f"P1 {name}: no bound")
    # a time under its bound would mean a rate or a count of NEEDS is wrong
    under = {n: r["ns_per_iter"] for n, r in p1.items()
             if min(r["ns_per_iter"].values()) < r["bound_ns"]}
    log(f"P1 constructs timed under their bound: {json.dumps(under)}")
    # ms at N = 40000, plain_ms at N = CHECK_N (the plain versions step
    # one iteration at a time): the row says so
    rows["probe_visit"].update(
        ms=sum(sum(r["ms"].values()) for r in p1.values()),
        bound_ms=sum(r["bound_ns"] * pv.N * len(r["ms"]) / 1e6
                     for r in p1.values()), bound_by="operations",
        iterations={"ms": pv.N, "bound_ms": pv.N, "plain_ms": pv.CHECK_N})
    # P2 / P3: the one-hot products' bytes and TF32 operations
    bytes_moved = (w.numel() + sel.numel() + 64 * 128) * 4
    # ms and library_ms: the device-paced turns at one copy (exact_turns;
    # the eager ones beside them), and the price at full-card occupancy
    for k, label, passes in (("probe_exact1", "P2", 1),
                             ("probe_exact3", "P3", 3)):
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = passes * 8 * 2 * 8 * 128 * 128 / TF32_OPS_PER_S
        r = turns[label]
        rows[k].update(ms=r["ms"], bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=r["library_ms"], eager_ms=r["eager_ms"],
                       eager_library_ms=r["eager_library_ms"],
                       occupancy=price[label])
    # torch.matmul of the same operands, one (8, 128) x (128, 1024) call
    operand = sel.reshape(8, 128, 128).permute(1, 0, 2).reshape(128, 1024)
    for k, tf32 in (("probe_exact1", True), ("probe_exact3", False)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        bad = {}
        for name, wi in ws.items():
            out = torch.matmul(wi, operand).reshape(8, 8, 128).permute(
                1, 0, 2).reshape(64, 128).contiguous().view(torch.int32)
            bad[name] = int((out != pv.broadcast(wi)).sum())
        log(f"torch.matmul (allow_tf32={tf32}) of P2 / P3's operands: bad "
            f"{json.dumps(bad)}, {rows[k]['library_ms']:.4f} ms (device, "
            f"in turns with the kernel)  [{card}]")
    torch.backends.cuda.matmul.allow_tf32 = False
    # P4: each mode reads the bounds once and writes the counts once; its
    # operations are its +1s (empty: one add a lo word)
    lo, hi = (torch.from_numpy(v).to(dev) for v in pyb.ybounds_inputs())
    bounds = [bound(2 * lo.numel() * 4 + 8 * 200 * 128 * 4,
                    lo.numel() if mode == "empty" else
                    int(pyb.ybounds_reference(lo, hi, mode).long().sum()))
              for mode in pyb.MODES]
    rows["probe_ybounds"].update(
        ms=sum(r["ms"] for r in p4.values()),
        serial_ms=sum(r["ms"] for r in p4_serial.values()),
        chunks={m: r["chunks"] for m, r in p4.items()},
        bound_ms=sum(b for b, _ in bounds),
        bound_by=max(bounds)[1])
    rows["probe_visit"]["w_variants"] = variants
    for k, r in rows.items():
        log(f"{k}: {json.dumps(r)}  [{card}]")
    check_native_decoder(card)
    return rows


def launch_ns(call, n: int, warm: int) -> float:
    """ns an iteration of call(n): one launch timed with CUDA events after
    a warm call(warm)."""
    import torch

    call(warm)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    call(n)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e6 / n


def field_variants(pv, dev, card: str, n: int = 10000) -> dict:
    """What paces a field product on the tensor cores (PERF.md §7): each
    W_FROM_SMEM construct at the occupancy shape, w's fragments held in
    registers across the 13 products against read from shared memory
    for every product, in turns (registers, shared, shared, registers),
    one launch of n iterations each after a warm one at CHECK_N; ns a
    field product ((8, 128) x (128, 128), all its passes) an SM, beside
    the TF32 FMA bound.  Returns name -> numbers."""
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(pv._smi("clocks.max.sm"))
    inputs = pv.device_inputs(dev)
    res = {}
    for name in pv.W_FROM_SMEM:
        x, t, arg = inputs[name]
        blocks, threads = pv.configs(dev, name)["K1 occupancy"]
        products = pv.copies_of(name, blocks, threads) * pv.FIELDS
        ns = {False: [], True: []}
        for smem in (False, True, True, False):
            ns[smem].append(launch_ns(
                lambda n_: pv.construct(name, x, t, n_, arg, blocks, threads,
                                        w_from_smem=smem),
                n, pv.CHECK_N) * sms / products)
        passes = 1 if name in pv.TF32_ONE_PASS else 3
        fma = pv.field_bounds_ns(passes, 1, sms, mhz)["fma"]
        r = {"registers_ns": sum(ns[False]) / 2,
             "shared_ns": sum(ns[True]) / 2, "fma_ns": fma,
             "turns_ns": [ns[False][0], ns[True][0], ns[True][1],
                          ns[False][1]]}
        res[name] = r
        log(f"P1 {name} at K1 occupancy, ns a field product an SM (turns "
            f"registers / shared / shared / registers, N={n}): "
            f"{' / '.join(f'{v:.2f}' for v in r['turns_ns'])}; w in "
            f"registers {r['registers_ns']:.2f} "
            f"({r['registers_ns'] / fma:.2f}x the TF32 FMA bound "
            f"{fma:.2f} at {mhz:.0f} MHz), w from shared memory "
            f"{r['shared_ns']:.2f} ({r['shared_ns'] / fma:.2f}x)  [{card}]")
    return res


# iterations a P1 tensor-core construct is timed over in --ab-exact (the
# parent's take ~87 us an iteration)
AB_P1_N = 10000


def p1_mma_times(pv, dev, n: int = AB_P1_N) -> dict:
    """P1's tensor-core constructs at both launch shapes through any
    checkout's ops/probe_visit (its `configs(dev, name)` where it takes a
    name): after a warm launch at CHECK_N, one launch of n iterations
    timed with CUDA events.  Returns name -> shape -> ns an iteration."""
    import inspect

    per_name = "name" in inspect.signature(pv.configs).parameters
    inputs = pv.device_inputs(dev)
    res = {}
    for name in sorted(pv.MMA, key=pv.CONSTRUCTS.index):
        x, t, arg = inputs[name]
        shapes = pv.configs(dev, name) if per_name else pv.configs(dev)
        res[name] = {
            cfg: launch_ns(lambda n_: pv.construct(name, x, t, n_, arg, *sh),
                           n, pv.CHECK_N)
            for cfg, sh in shapes.items()}
    return res


def p4_times(pyb, dev, reps: int = 8) -> dict:
    """P4's modes at S = 4096 through any checkout's ops/probe_ybounds:
    serial (chunks = 1; a checkout without chunks has only its 32-block
    walk) and at the full-card chunking, each the mean of `reps` calls
    after a warm one.  Returns mode -> shape -> us an emission."""
    import inspect

    import torch

    chunked = "chunks" in inspect.signature(pyb.ybounds).parameters
    lo, hi = (torch.from_numpy(v).to(dev) for v in pyb.ybounds_inputs())
    shapes = {"serial": (1,), "full card": (None,)} if chunked else {
        "serial": ()}
    return {mode: {cfg: event_ms(lambda: pyb.ybounds(lo, hi, mode, *c), reps)
                   * 1e3 / lo.shape[0] for cfg, c in shapes.items()}
            for mode in pyb.MODES}


def exact_turns(pv, dev, reps: int = 20) -> dict:
    """P2 and P3 at one copy on main6's f32 input, in turns with
    torch.matmul of the same operands ((8, 128) x (128, 1024); P2 against
    allow_tf32=True, P3 against False): kernel, matmul, matmul, kernel,
    each the mean of `reps` calls, first device-paced (event_ms with
    spin), then eager.  `pv` is the ops/probe_visit of any checkout (its
    exact1 / exact3 taking (w, s)), so a parent commit is timed by the
    same code.  Returns "P2" / "P3" -> {"ms", "library_ms" (device
    time), "eager_ms", "eager_library_ms", "turns_ms",
    "eager_turns_ms"}."""
    import torch

    s = torch.from_numpy(pv.exact_selectors()).to(dev)
    w = torch.from_numpy(pv.exact_inputs()["f32"]).to(dev)
    operand = s.reshape(8, 128, 128).permute(1, 0, 2).reshape(128, 1024)
    was = torch.backends.cuda.matmul.allow_tf32
    res = {}
    for label, fn, tf32 in (("P2", pv.exact1, True), ("P3", pv.exact3, False)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        kern = lambda: fn(w, s)
        lib = lambda: torch.matmul(w, operand)
        turns = (kern, lib, lib, kern)
        dev_t = [event_ms(f, reps, spin=True) for f in turns]
        eager_t = [event_ms(f, reps) for f in turns]
        res[label] = {"ms": (dev_t[0] + dev_t[3]) / 2,
                      "library_ms": (dev_t[1] + dev_t[2]) / 2,
                      "eager_ms": (eager_t[0] + eager_t[3]) / 2,
                      "eager_library_ms": (eager_t[1] + eager_t[2]) / 2,
                      "turns_ms": dev_t, "eager_turns_ms": eager_t}
    torch.backends.cuda.matmul.allow_tf32 = was
    return res


def exact_price(pv, dev, copies: int, reps: int = 3) -> dict:
    """P2 and P3's price of a field product at full-card occupancy:
    `copies` copies of the 8 products, the mean of `reps` calls after a
    warm one, written (stored = copies, the function) and run with one
    slice written (stored = 1: the tensor cores' and shared memory's
    part without the output's HBM bytes); ns a field product an SM, time
    x SMs / (copies x 8), beside the TF32 FMA and byte bounds
    (pv.field_bounds_ns).  Returns "P2" / "P3" -> numbers."""
    import torch

    s = torch.from_numpy(pv.exact_selectors()).to(dev)
    w = torch.from_numpy(pv.exact_inputs()["f32"]).to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(pv._smi("clocks.max.sm"))
    res = {}
    for label, fn, passes in (("P2", pv.exact1, 1), ("P3", pv.exact3, 3)):
        r = {"copies": copies}
        for key, stored in (("", copies), ("_one_slice", 1)):
            ms = event_ms(lambda: fn(w, s, copies, stored), reps)
            bounds = pv.field_bounds_ns(passes, copies, sms, mhz, stored)
            r.update({f"occupancy_ms{key}": ms,
                      f"ns_per_field{key}": ms * 1e6 * sms / (copies * 8),
                      f"bytes_ns{key}": bounds["bytes"]})
        r["fma_ns"] = bounds["fma"]
        r["mhz"] = mhz
        res[label] = r
        torch.cuda.empty_cache()
    return res


def log_exact(turns: dict, price: dict | None, p1_ns: dict, card: str,
              reps: int = 20) -> None:
    for label, r in turns.items():
        tf32 = label == "P2"
        log(f"{label} (64, 128) against torch.matmul (allow_tf32={tf32}), "
            f"turns kernel / matmul / matmul / kernel, ms of {reps} calls: "
            f"device {' / '.join(f'{t:.5f}' for t in r['turns_ms'])}; "
            f"eager {' / '.join(f'{t:.5f}' for t in r['eager_turns_ms'])}"
            f"  [{card}]")
        if price is None:
            continue
        q = price[label]
        log(f"{label} at full-card occupancy, {q['copies']} copies: "
            f"{q['occupancy_ms']:.4f} ms, {q['ns_per_field']:.2f} ns a field "
            f"product an SM (bytes bound {q['bytes_ns']:.2f}); one slice "
            f"written: {q['occupancy_ms_one_slice']:.4f} ms, "
            f"{q['ns_per_field_one_slice']:.2f} ns (bytes bound "
            f"{q['bytes_ns_one_slice']:.2f}); TF32 FMA bound "
            f"{q['fma_ns']:.2f} at {q['mhz']:.0f} MHz: "
            f"{q['ns_per_field'] / q['fma_ns']:.2f}x / "
            f"{q['ns_per_field_one_slice'] / q['fma_ns']:.2f}x"
            + "".join(f"; P1 {k} {v:.2f} ns a field product an SM at K1 "
                      f"occupancy" for k, v in p1_ns.items())
            + f"  [{card}]")


def resource_report(s: Smoke, libs) -> dict:
    """The resources of every kernel library built (the TPU probe
    scripts/probe_mosaic_layout.py asked which layouts Mosaic takes; on
    the card the question is resource legality): from nvcc's -Xptxas -v
    report, each kernel's registers a thread, spill stores and spill
    loads and static shared memory; the dynamic shared memory a block
    takes at the main path's launch (320x200, pools mid 40 / clip 64 /
    item 24; the emission at e1m1 scale's 408 items and 736 segs) and
    the blocks an SM then holds (the CUDA occupancy
    calculator).  Any spill fails the run."""
    import re

    from doomtpu_torch.ops import build

    phase("resources of every kernel library")
    H, KM, KC, KI = 200, 40, 64, 24
    # the emission at e1m1 scale: every item selected (215 map objects,
    # 193 drawable mids), 736 segs
    N, G = 408, 736
    p, it, ip, sc, em = s.paint, s.items, s.itempass, s.scan, s.emit
    e_threads, e_table = em.emit_block(320, N, KI, G)
    launch = {
        "paint": (lambda: p.paint_smem_bytes(*p.paint_tile(H), H),
                  lambda lib: p.paint_blocks_per_sm(H, lib=lib)),
        "items": (lambda: it.items_smem_bytes(it.items_tile(H, KI, KC)[0],
                                              H, KI, KC),
                  lambda lib: it.items_blocks_per_sm(H, KI, KC)),
        "itempass": (lambda: ip.itempass_smem_bytes(
                         *ip.itempass_tile(H, KC, KM), H, KC, KM),
                     lambda lib: ip.itempass_blocks_per_sm(H, KC, KM,
                                                           lib=lib)),
        "scan": (lambda: 0, lambda lib: sc.scan_blocks_per_sm(lib=lib)),
        "resolve": (lambda: s.resolve.resolve_smem_bytes(H),
                    lambda lib: s.resolve.resolve_blocks_per_sm(H)),
        "emit": (lambda: em.emit_smem_bytes(e_threads, N, KI, G, e_table),
                 lambda lib: em.emit_blocks_per_sm(320, N, KI, G)),
    }
    report = {}
    for name in libs:
        src = build.VARIANTS.get(name, (name,))[0]
        funcs = build.ptxas_resources(build.nvcc_output(name))
        kernels = {k: v for k, v in funcs.items() if "registers" in v}
        check(len(kernels) == 1, f"{name}: ptxas reported kernels "
              f"{sorted(kernels)}")
        (mangled, r), = kernels.items()
        spills = {f: (v.get("spill_stores", 0), v.get("spill_loads", 0))
                  for f, v in funcs.items()}
        smem_fn, blocks_fn = launch[src]
        row = {"kernel": re.search(r"\d+([a-z_]+_kernel)", mangled).group(1),
               "registers": r["registers"],
               "spill_stores": sum(a for a, _ in spills.values()),
               "spill_loads": sum(b for _, b in spills.values()),
               "smem_static": r["smem_static"],
               "smem_dynamic": smem_fn(), "blocks_per_sm": blocks_fn(name)}
        report[name] = row
        log(f"resources {name}: {json.dumps(row)}  [{s.card}]")
        check(row["spill_stores"] == 0 and row["spill_loads"] == 0,
              f"{name}: ptxas spills registers {spills}")
        check(row["blocks_per_sm"] >= 1, f"{name}: no block fits an SM")
    return report


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def time_paint_cell(root: str, reps: int = 10) -> int:
    """--time-paint-cell ROOT: the e1m1-scale cell's `render_walls` and
    `render` at B=4096 through the port in the checkout ROOT (this tree
    or another commit's), each warmed once and then timed as the main
    run times them over `reps` calls; prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.ops import build
    from doomtpu_torch.wad import synth

    check(torch.cuda.is_available(), "no CUDA device")
    import doomtpu_torch

    check(os.path.dirname(os.path.dirname(doomtpu_torch.__file__))
          == os.path.abspath(root), f"doomtpu_torch not imported from {root}")
    build.build_libraries("paint", "items")
    dev = torch.device("cuda", 0)
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True)
    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    config=cfg, device=dev)
    pos, ang = spread_poses(eng.tables, B)
    state = eng.new_game(B, pos=pos, angle=ang,
                         generator=torch.Generator(dev).manual_seed(0))
    got = {"root": root}
    for call in (eng.render_walls, eng.render):
        out = call(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = call(state)
        torch.cuda.synchronize()
        checksum = int(out[1].sum().item())
        got[call.__name__] = {
            "ms": (time.perf_counter() - t0) / reps * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "checksum": checksum}
    print(json.dumps(got), flush=True)
    return 0


def compare_trees(roots: list[str], rounds: int = 2) -> int:
    """--ab ROOT_A ROOT_B: the paint cell timed through two checkouts on
    one card, in the order A B B A per round, each timing in a process
    of its own (--time-paint-cell); prints every timing, then per tree
    the mean, min and max ms per batch.  The checksums must agree."""
    check(len(roots) == 2, "--ab takes two checkout roots")
    a, b = roots
    card = card_line()
    log(card)
    runs = {a: [], b: []}
    for _ in range(rounds):
        for root in (a, b, b, a):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--time-paint-cell", root],
                capture_output=True, text=True, timeout=600)
            check(p.returncode == 0,
                  f"timing {root} failed:\n{p.stdout}\n{p.stderr[-4000:]}")
            got = json.loads(p.stdout.strip().splitlines()[-1])
            log(f"{json.dumps(got)}  ({time.perf_counter() - t0:.1f} s)")
            runs[root].append(got)
    for path in ("render_walls", "render"):
        sums = {r[path]["checksum"] for rs in runs.values() for r in rs}
        check(len(sums) == 1, f"{path}: checksums differ between trees "
              f"{sorted(sums)}")
        for root, rs in runs.items():
            ms = [r[path]["ms"] for r in rs]
            log(f"{path} e1m1-scale 320x200 B={B} under {root}: mean "
                f"{sum(ms) / len(ms):.3f} ms/batch, min {min(ms):.3f}, max "
                f"{max(ms):.3f} over {len(ms)} processes, peak "
                f"{max(r[path]['peak_gib'] for r in rs):.2f} GiB  [{card}]")
    return 0


def time_exact(root: str) -> int:
    """--time-exact ROOT: P1's tensor-core constructs, P2, P3 and P4
    through the ops/probe_visit and ops/probe_ybounds of the checkout
    ROOT (this tree or another commit's), timed by this script's
    p1_mma_times, exact_turns (and exact_price where that checkout's
    wrappers take copies) and p4_times; prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import doomtpu_torch
    from doomtpu_torch.ops import build
    from doomtpu_torch.ops import probe_visit as pv
    from doomtpu_torch.ops import probe_ybounds as pyb

    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.dirname(os.path.dirname(doomtpu_torch.__file__))
          == os.path.abspath(root), f"doomtpu_torch not imported from {root}")
    build.build_libraries(*PROBE_LIBS)
    dev = torch.device("cuda", 0)
    got = {"root": root, "p1": p1_mma_times(pv, dev),
           "turns": exact_turns(pv, dev)}
    if hasattr(pv, "OCCUPANCY_COPIES"):
        got["price"] = exact_price(pv, dev, pv.OCCUPANCY_COPIES)
    got["p4"] = p4_times(pyb, dev)
    print(json.dumps(got), flush=True)
    return 0


def compare_exact(roots: list[str], rounds: int = 2) -> int:
    """--ab-exact ROOT ...: P1's tensor-core constructs, P2, P3 and P4
    timed through several checkouts on one card, in the order A B ... B
    A per round, each timing in a process of its own (--time-exact);
    prints every timing, then per tree and number the mean, min and
    max."""
    check(len(roots) >= 2, "--ab-exact takes two or more checkout roots")
    card = card_line()
    log(card)
    runs = {r: [] for r in roots}
    for _ in range(rounds):
        for root in (*roots, *reversed(roots)):
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--time-exact",
                 root], capture_output=True, text=True, timeout=600)
            check(p.returncode == 0,
                  f"timing {root} failed:\n{p.stdout}\n{p.stderr[-4000:]}")
            got = json.loads(p.stdout.strip().splitlines()[-1])
            log(json.dumps(got))
            runs[root].append(got)
    for root, rs in runs.items():
        for label in ("P2", "P3"):
            vals = {k: [r["turns"][label][k] for r in rs]
                    for k in ("ms", "library_ms", "eager_ms",
                              "eager_library_ms")}
            if all("price" in r for r in rs):
                vals.update({k: [r["price"][label][k] for r in rs]
                             for k in ("ns_per_field",
                                       "ns_per_field_one_slice")})
            log(f"{label} under {root}: " + ", ".join(
                f"{k} mean {sum(v) / len(v):.6g} min {min(v):.6g} max "
                f"{max(v):.6g}" for k, v in vals.items())
                + f" over {len(rs)} processes  [{card}]")
        for key, unit in (("p1", f"ns an iteration, N={AB_P1_N}"),
                          ("p4", "us an emission, S=4096")):
            for name, shapes in rs[0][key].items():
                log(f"{'P1' if key == 'p1' else 'P4'} {name} under {root}, "
                    f"{unit}: " + ", ".join(
                        f"{cfg} mean {sum(v) / len(v):.6g} min {min(v):.6g} "
                        f"max {max(v):.6g}"
                        for cfg in shapes
                        for v in [[r[key][name][cfg] for r in rs]])
                    + f" over {len(rs)} processes  [{card}]")
    return 0


def sync_census(call) -> dict:
    """Every synchronizing CUDA call `call()` makes, found by torch.cuda's
    sync debug mode: {"sites": the port's innermost three frames at each
    warning (the stack's innermost four where no frame is the port's),
    "inside": whether a doom.sync range held each (a
    `census.sync` mark is put in a CPU profile at the warning),
    "syncs": the doom.sync ranges opened, "nested": those inside
    another}."""
    import traceback
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    sites = []

    def note(message, category, filename, lineno, file=None, line=None):
        # the mode's own notice on first use ("...does not yet detect
        # all synchronizing operations") is no synchronizing call
        if not str(message).startswith("called a synchronizing"):
            return
        with record_function("census.sync"):
            pass
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if "doomtpu_torch" in f.filename
                  and not f.filename.endswith("trace.py")][-3:] or stack[-4:]
        sites.append(" < ".join(
            f"{f.filename.split('doomtpu_torch/')[-1]}:{f.name}:{f.lineno}"
            for f in frames[::-1]) + f" (warned at {filename}:{lineno})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        # the profiler's own start and stop synchronize: outside the mode
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ev = [(e.start_ns(), e.end_ns(), e.name())
          for e in prof.profiler.kineto_results.events()
          if e.name() in ("doom.sync", "census.sync")]
    syncs = sorted((a, b) for a, b, n in ev if n == "doom.sync")
    marks = sorted(a for a, _, n in ev if n == "census.sync")
    nested = sum(1 for i, (a, b) in enumerate(syncs)
                 if any(x <= a and b <= y for x, y in syncs[:i]))
    return {"sites": sites, "syncs": len(syncs), "nested": nested,
            "inside": [any(a <= m <= b for a, b in syncs) for m in marks]}


def trace_report(out_path: str, n: int = 2048, ticks: int = 32) -> int:
    """The program's spans on the card (doomtpu_torch/trace.py), as the
    benchmark's cells run the engine: e1m1-scale at 320x200, n spread
    cameras walking, pools calibrated on the states rendered, on the
    paint, the scan and the item-pass pipeline.  For each: the sync
    census of one tick and one render (`sync_census`), every warning
    inside a doom.sync range; the emission kernel's launches a render
    and a rollout tick (1 on paint and scan, 0 on the item pass); on the
    item pass, its launches a render
    and whether it takes a batch of 4096 (`frame.itempass_available`);
    the spans a tick; the cost of a span outside a profiler; and
    one profiled episode with the program's spans and without them, in
    turns (on, off, off, on, twice), its frames' checksums equal.  Writes the
    numbers to `out_path` as JSON."""
    import types
    import timeit

    import torch
    from torch.profiler import ProfilerActivity, profile

    from doomtpu_torch import trace
    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.ops.emit import emit
    from doomtpu_torch.ops.itempass import item_pass
    from doomtpu_torch.render import frame
    from doomtpu_torch.sim import player
    from doomtpu_torch.wad import synth

    dev = torch.device("cuda", 0)
    card = card_line()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "is_user_annotation": hasattr(torch.autograd._KinetoEvent,
                                            "is_user_annotation")}
    log(card, report)
    # the cost of a span outside a profiler, on this host
    f = lambda: None
    g = trace.spanned("doom.x")(f)

    def with_span():
        with trace.span("doom.x"):
            pass
    reps = 200_000
    cost = {name: timeit.timeit(fn, number=reps) / reps * 1e6
            for name, fn in (("bare_call_us", f), ("span_us", with_span),
                             ("spanned_call_us", g))}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        cost["span_profiled_us"] = timeit.timeit(
            with_span, number=reps // 10) / (reps // 10) * 1e6
    report["off_path"] = cost
    log(f"a span outside a profiler: {cost}")
    moves = torch.tensor([player.KEY_UP, player.KEY_UP | player.KEY_LEFT,
                          player.KEY_UP | player.KEY_RIGHT,
                          player.KEY_ALT | player.KEY_LEFT], dtype=torch.int32)
    ok = True
    wad = synth.e1m1_scale_wad()
    paint = RenderConfig(width=320, height=200, use_pallas_paint=True,
                         paint_percam_compact=True)
    for pipeline, cfg in (
            ("paint", paint),
            ("scan", RenderConfig(width=320, height=200)),
            ("itempass", dataclasses.replace(paint,
                                             use_item_pass_kernel=True))):
        eng = DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=dev)
        pos, ang = spread_poses(eng.tables, n)
        s0 = eng.new_game(n, pos=pos, angle=ang,
                          generator=torch.Generator(dev).manual_seed(0))
        controls = moves.repeat(ticks, -(-n // 4))[:, :n].to(dev)
        draws = eng.light_draws(n, torch.Generator(dev).manual_seed(1),
                                ticks=ticks)
        chain, s = [], s0
        for t in range(ticks):
            s = eng.tick(s, controls[t], draws=draws[t])
            chain.append(s)
        eng = eng.calibrate(chain)
        del chain
        r = {"config": str(eng.config)}
        one = lambda: eng.tick(s0, controls[0], draws=draws[0])
        s1 = one()
        eng.render(s1)
        for what, call in (("tick", one), ("render", lambda: eng.render(s1))):
            c = sync_census(call)
            r[what] = c
            inside = sum(c["inside"])
            log(f"{pipeline} {what}: {len(c['sites'])} synchronizing calls, "
                f"{inside} inside a doom.sync range; doom.sync ranges "
                f"{c['syncs']} ({c['nested']} nested)")
            for site in c["sites"]:
                log(f"  {site}")
            ok &= inside == len(c["sites"]) and c["nested"] == 0
        if cfg.use_item_pass_kernel:
            n0 = item_pass.launches
            eng.render(s1)
            torch.cuda.synchronize()
            r["item_pass_launches_a_render"] = item_pass.launches - n0
            r["itempass_available_4096"] = frame.itempass_available(
                eng.level, eng.config, 4096)
            log(f"{pipeline}: {r['item_pass_launches_a_render']} item-pass "
                f"launch(es) a render; B=4096 takes the item pass: "
                f"{r['itempass_available_4096']}")
            ok &= (r["item_pass_launches_a_render"] == 1
                   and r["itempass_available_4096"])
        # the emission kernel: once a render and once a rollout tick on
        # the deferred pass (paint, scan), never with the item pass
        want = 0 if cfg.use_item_pass_kernel else 1
        n0 = emit.launches
        eng.render(s1)
        torch.cuda.synchronize()
        r["emit_launches_a_render"] = emit.launches - n0
        # spans a tick of a rollout, by name, and the episode timed
        two = lambda: eng.rollout(s0, controls[:2], draws=draws[:2],
                                  return_frames=True)
        n0 = emit.launches
        two()
        torch.cuda.synchronize()
        r["emit_launches_a_tick"] = (emit.launches - n0) / 2
        log(f"{pipeline}: emission launches a render "
            f"{r['emit_launches_a_render']}, a tick "
            f"{r['emit_launches_a_tick']} (want {want} each)")
        ok &= (r["emit_launches_a_render"] == want
               and r["emit_launches_a_tick"] == want)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            two()
            torch.cuda.synchronize()
        by = {}
        for e in prof.profiler.kineto_results.events():
            if e.name().startswith("doom."):
                by[e.name()] = by.get(e.name(), 0) + 1
        r["spans_2_tick_rollout"] = by
        log(f"{pipeline}: spans of a 2-tick rollout {by}")

        def episode():
            st, fr = eng.rollout(s0, controls, draws=draws,
                                 return_frames=True)
            sums = fr.sum(dim=(2, 3), dtype=torch.int64)
            del fr
            return sums

        plain = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sums0 = episode()
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t0)
        r["plain_episode_s"] = plain
        turns = []
        enabled = trace._profiler
        for spans_on in (True, False, False, True) * 2:
            trace._profiler = (enabled if spans_on else
                               types.SimpleNamespace(
                                   _is_profiler_enabled=False))
            try:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]):
                    t0 = time.perf_counter()
                    sums = episode()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                trace._profiler = enabled
            same = bool(torch.equal(sums, sums0))
            ok &= same
            turns.append({"spans": spans_on, "s": wall,
                          "frames_per_s": n * ticks / wall,
                          "checksums_equal": same})
            log(f"{pipeline}: profiled episode, program spans "
                f"{'on' if spans_on else 'off'}: {wall:.4f} s, "
                f"{n * ticks / wall:.1f} frames/s, checksums equal {same}")
        r["profiled_episodes"] = turns
        log(f"{pipeline}: unprofiled episodes {plain} s")
        report[pipeline] = r
        del eng, s0, s1
        torch.cuda.empty_cache()
    report["ok"] = ok
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=1)
    log(json.dumps({"ok": ok, "report": out_path}))
    return 0 if ok else 1


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
    from doomtpu_torch.wad import synth

    # ---- 1. device and build ---------------------------------------------
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"nvcc: {build.nvcc_path() or 'not found'}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = ("paint", "items", "scan", "itempass", "resolve", "emit",
            *build.VARIANTS)
    t0 = time.perf_counter()
    build.build_libraries(*libs, *PROBE_LIBS)
    for name in (*libs, *PROBE_LIBS):
        build.load_library(name)
        log(f"build: {name}.cu (nvcc ended "
            f"{build.build_seconds.get(name, 0.0):.2f} s after the builds "
            f"started)")
        for line in build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build, {len(libs) + len(PROBE_LIBS)} kernels in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    s = Smoke(card, dev)
    resources = resource_report(s, libs)

    # ---- 2. each kernel against its plain version ---------------------------
    phase("kernel checks")
    demo = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", device=dev)
    views = [(384.0, 256.0, 0.0), (900.0, 256.0, 2.5), (300.0, 700.0, 4.6),
             (384.0, 256.0, 3.1)] * 2
    demo_poses = (np.asarray([v[:2] for v in views], np.float32),
                  np.asarray([v[2] for v in views], np.float32))
    demo_st = s.new_game(demo, 8, demo_poses)
    err = {"paint": s.compare_paint(demo, s.stage_inputs(demo, demo_st)[2],
                                    "demo B=8")[0]}
    err["items"] = max(s.check_items(
        demo, demo_st, RenderConfig(item_capacity=ki),
        f"demo B=8 item_capacity={ki}", variants=ki == 24) for ki in (8, 24))
    err["scan"] = max(s.check_scan(
        demo, demo_st, RenderConfig(span_capacity=k),
        f"demo B=8 span_capacity={k}") for k in (16, 4))
    err["itempass"] = s.check_itempass(
        demo, demo_st, RenderConfig(use_item_pass_kernel=True), "demo B=8")
    # the emission at item capacity 1 (every column past it overflows),
    # 8 and 24
    err["emit"] = max(s.check_emit(
        demo, demo_st, RenderConfig(item_capacity=ki),
        f"demo B=8 item_capacity={ki}") for ki in (1, 8, 24))

    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24)
    e1 = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1", config=cfg,
                                   device=dev)
    st32 = s.new_game(e1, 32)
    args32 = s.stage_inputs(e1, st32)[2]
    err["paint"] = max(err["paint"],
                       s.compare_paint(e1, args32, "e1m1-scale B=32")[0])
    err["items"] = max(err["items"],
                       s.check_items(e1, st32, cfg, "e1m1-scale B=32"))
    err["emit"] = max([err["emit"]] + [s.check_emit(
        e1, st32, dataclasses.replace(cfg, span_capacity=96),
        "e1m1-scale B=32", pipeline) for pipeline in (
            "paint", "paint-bwk", "scan")])
    # the item pass draws the items a capped item pool drops
    err["itempass"] = max(err["itempass"], s.check_itempass(
        e1, st32, dataclasses.replace(cfg, item_capacity=8),
        "e1m1-scale B=32", capped=True))
    # the scan on a paint-eligible level (the pipeline forced) and on the
    # masked one
    err["scan"] = max(err["scan"], s.check_scan(
        e1, st32, dataclasses.replace(cfg, span_capacity=96),
        "e1m1-scale B=32 (paint-eligible, scan forced)"))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        masked = DoomEngine.from_wad_bytes(
            synth.e1m1_scale_masked_wad(), "e1m1", config=cfg, device=dev)
    st_m = s.new_game(masked, 32)
    err["scan"] = max(err["scan"], s.check_scan(
        masked, st_m, dataclasses.replace(cfg, span_capacity=96),
        "e1m1-scale-masked B=32"))
    # the resolve on the scans of both levels, and under a sky with
    # transparent texels (the masked-sky fetch)
    err["resolve"] = max(
        s.check_resolve(demo, demo_st, RenderConfig(span_capacity=16),
                        "demo B=8 span_capacity=16"),
        s.check_resolve(e1, st32, dataclasses.replace(cfg, span_capacity=96),
                        "e1m1-scale B=32"),
        s.check_resolve(e1, st32, dataclasses.replace(cfg, span_capacity=96),
                        "e1m1-scale B=32, a sky with transparent texels",
                        level=sky_masked(e1.level)),
        s.check_resolve(masked, st_m,
                        dataclasses.replace(cfg, span_capacity=96),
                        "e1m1-scale-masked B=32"))
    # textures wider than 128 and ~48 flats take the kernels' other paths
    d1 = DoomEngine.from_wad_bytes(synth.doom1_scale_wad(), "e1m1",
                                   config=cfg, device=dev)
    check(d1.level.texq_wide, "doom1-asset-scale has no wide textures")
    st16 = s.new_game(d1, 16)
    err["paint"] = max(err["paint"], s.compare_paint(
        d1, s.stage_inputs(d1, st16)[2], "doom1-asset-scale B=16")[0])
    err["items"] = max(err["items"], s.check_items(d1, st16, cfg,
                                                   "doom1-asset-scale B=16"))
    check(d1.level.itempaint_ok, "doom1-asset-scale is not item-pass eligible")
    err["itempass"] = max(err["itempass"], s.check_itempass(
        d1, st16, dataclasses.replace(cfg, max_visible_mobjs=256),
        "doom1-asset-scale B=16 max_visible_mobjs=256"))
    # K1 under a live-seg cap that drops segs, per camera and per tile
    frame32, order32, _ = s.stage_inputs(e1, st32)
    for percam in (True, False):
        cfg_c = dataclasses.replace(cfg, paint_live_capacity=32,
                                    paint_percam_compact=percam)
        drop, dropped = s.paint.live_drop(cfg_c, args32[0], args32[1],
                                          order32)
        label = (f"e1m1-scale B=32 paint_live_capacity=32 "
                 f"{'per camera' if percam else 'per tile'}, "
                 f"{int(dropped)} live segs dropped")
        check(int(dropped) > 0, f"{label}: the cap drops nothing")
        err["paint"] = max(err["paint"], s.compare_paint(
            dataclasses.replace(e1, config=cfg_c), args32, label, drop)[0])
    del frame32, order32
    # a tall screen and the widest paint screen of the demo, B=8: K1-K4
    for w, h in ((320, 768), (1024, 200)):
        cfg_s = RenderConfig(width=w, height=h, item_capacity=24)
        eng_s = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1",
                                          config=cfg_s, device=dev)
        st_s = s.new_game(eng_s, 8, demo_poses)
        err["paint"] = max(err["paint"], s.compare_paint(
            eng_s, s.stage_inputs(eng_s, st_s)[2], f"demo {w}x{h} B=8")[0])
        err["items"] = max(err["items"], s.check_items(
            eng_s, st_s, cfg_s, f"demo {w}x{h} B=8", variants=True))
        err["emit"] = max(err["emit"], s.check_emit(
            eng_s, st_s, cfg_s, f"demo {w}x{h} B=8"))
        err["scan"] = max(err["scan"], s.check_scan(
            eng_s, st_s, dataclasses.replace(cfg_s, span_capacity=32),
            f"demo {w}x{h} B=8 span_capacity=32"))
        err["resolve"] = max(err["resolve"], s.check_resolve(
            eng_s, st_s, dataclasses.replace(cfg_s, span_capacity=32),
            f"demo {w}x{h} B=8 span_capacity=32"))
        err["itempass"] = max(err["itempass"], s.check_itempass(
            eng_s, st_s, dataclasses.replace(cfg_s, use_item_pass_kernel=True),
            f"demo {w}x{h} B=8"))
    # a masked mid 256 rows tall: the atlas holds 256 rows a column
    err["items"] = max(err["items"], tall_mid_cell(s))
    kern_ms32 = event_ms(lambda: s.paint.paint(e1.level, cfg, *args32), 20)
    plain_ms32 = event_ms(
        lambda: s.paint.paint_reference(e1.level, cfg, *args32), 2)
    log(f"paint at e1m1-scale B=32: kernel {kern_ms32:.4f} ms, plain "
        f"PyTorch {plain_ms32:.2f} ms  [{card}]")
    del demo, e1, masked, d1, args32
    r_probes = probes_cell(s)
    torch.cuda.empty_cache()

    # ---- 3. the main paths at full size, timed ----------------------------
    r_paint = paint_cell(s)
    torch.cuda.empty_cache()
    livecap_cell(s, r_paint["paint"]["ms"])
    torch.cuda.empty_cache()
    r_scan = scan_cell(s)
    torch.cuda.empty_cache()
    r_ip = itempass_cell(s)
    torch.cuda.empty_cache()
    rollout_cell(s)
    torch.cuda.empty_cache()
    calibration_cell(s)
    torch.cuda.empty_cache()
    split_cell(s)
    cli_cell(s)
    phase("done")

    check(not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                  for m in sys.modules), "jax was imported")
    check(not any(m == "doomtpu" or m.startswith("doomtpu.")
                  for m in sys.modules), "the JAX package doomtpu was imported")
    # the cost probes' builds: resources only (no main-path launches)
    log(json.dumps({"probes": [
        dict(name=name, source=f"doomtpu_torch/ops/csrc/"
             f"{name.split('_probe')[0]}.cu", **resources[name])
        for name in build.VARIANTS]}))
    row = lambda name, source, replaces, r, e: dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=r["launches"], max_abs_err=e, ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None)
    log(json.dumps({"kernels": [
        row("paint", "doomtpu_torch/ops/csrc/paint.cu",
            "doomtpu/ops/pallas_paint.py:326", r_paint["paint"],
            max(err["paint"], r_paint["paint"]["max_abs_err"])),
        row("items", "doomtpu_torch/ops/csrc/items.cu",
            "doomtpu/ops/pallas_items.py:245", r_paint["items"],
            max(err["items"], r_paint["items"]["max_abs_err"],
                r_scan["items_err"])),
        row("scan", "doomtpu_torch/ops/csrc/scan.cu",
            "doomtpu/ops/pallas_scan.py:46", r_scan["scan"],
            max(err["scan"], r_scan["scan"]["max_abs_err"])),
        row("itempass", "doomtpu_torch/ops/csrc/itempass.cu",
            "doomtpu/ops/pallas_itempass.py:57", r_ip["itempass"],
            max(err["itempass"], r_ip["itempass"]["max_abs_err"])),
        row("resolve", "doomtpu_torch/ops/csrc/resolve.cu",
            "none (doomtpu/render/resolve.py:85, XLA)", r_scan["resolve"],
            max(err["resolve"], r_scan["resolve"]["max_abs_err"])),
        row("emit", "doomtpu_torch/ops/csrc/emit.cu",
            "none (doomtpu/render/things.py item_pool, XLA)",
            r_paint["emit"], max(err["emit"], r_paint["emit"]["max_abs_err"],
                                 r_scan["emit_err"])),
        *[dict(row(name, f"doomtpu_torch/ops/csrc/{src}.cu", replaces,
                   r_probes[name], r_probes[name]["max_abs_err"]),
               library_ms=r_probes[name].get("library_ms"),
               **{k: r_probes[name][k]
                  for k in ("iterations", "occupancy", "serial_ms")
                  if k in r_probes[name]})
          for name, src, replaces in (
              ("probe_visit", "probe_visit",
               "scripts/probe_visit_cost.py:31"),
              ("probe_exact1", "probe_visit",
               "scripts/probe_visit_cost.py:301"),
              ("probe_exact3", "probe_visit",
               "scripts/probe_visit_cost.py:350"),
              ("probe_ybounds", "probe_ybounds",
               "scripts/probe_percam_ybounds.py:141"))],
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time-paint-cell"]:
        sys.exit(time_paint_cell(sys.argv[2]))
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(compare_trees(sys.argv[2:]))
    if sys.argv[1:2] == ["--time-exact"]:
        sys.exit(time_exact(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-exact"]:
        sys.exit(compare_exact(sys.argv[2:]))
    if sys.argv[1:2] == ["--trace-report"]:
        sys.exit(trace_report(*sys.argv[2:3]))
    sys.exit(main())
