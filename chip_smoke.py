#!/usr/bin/env python3
"""Builds of the PyTorch / CUDA port on one NVIDIA H100, and its kernels
timed alone.

    python3 chip_smoke.py

Builds every kernel library from the sources in this checkout (the
engine's seven, the paint kernel's cost-probe builds and the Hopper
probes; one nvcc per source, all started together) and reports each
build's resources (registers, spills, shared memory, blocks an SM; a
spill fails the run).  Then, on e1m1-scale's B=4096 inputs at 320x200
(spread poses, Morton-sorted, as the engine takes them), it runs each
engine kernel once against its plain PyTorch version and times it alone
beside the least time its bytes and operations need: the seg rows and
the live drop (csrc/rows.cu), K1 (paint), K2 (items), the emission and
K3 (item pass) on the paint path's inputs, K4
(wall scan) and the resolve on e1m1-scale-masked's.  It times the paint
kernel's cost probe (P6: the kernel built at PAINT_PROBE levels 1-3,
csrc/paint.cu) on the same inputs.  It then runs each pipeline once
through DoomEngine at the same size, untimed (a paint render, a scan
render, an item-pass render, a reuse rollout), and holds each run's
kernel launches to its pipeline's.  Last, it times the Hopper probes
P1-P4 (ops/probe_visit.py, ops/probe_ybounds.py) beside their bounds.

Any failed step raises, so the script exits non-zero before its last
line.  The last line is one JSON object naming the device; the line
before it lists every kernel with its launches in the main path that
takes it, its error against the plain version, times and bound, and the
one before that the probe builds' resources.
It needs a CUDA card and fails without one: nothing moves to the CPU.

The card's other tools: `python -m pytest tests/test_torch_cuda.py
--noconftest` holds every kernel to its plain version and the engine on
the card to the CPU port; `python3 portbench/run.py` measures the
engine end to end (BENCHMARK.json's cells, A/B runs and traces).
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

# the card's published peaks (H100 SXM data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores and dense TF32 tensor-core
# operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# the engine's kernel libraries and the Hopper probes' (ops/probe_visit.py,
# ops/probe_ybounds.py)
ENGINE_LIBS = ("rows", "paint", "items", "scan", "itempass", "resolve",
               "emit")
PROBE_LIBS = ("probe_visit", "probe_ybounds")
B = 4096
T0 = time.perf_counter()
# event_ms(spin=True): spin cycles queued ahead of each timed call (~100
# us at 1.98 GHz, longer than the host takes to queue one)
SPIN_CYCLES = 200_000


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def phase(name: str) -> None:
    log(f"---- {name} ({time.perf_counter() - T0:.1f} s into the run)")


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of bytes over the HBM rate and
    operations over the float32 rate."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(t) -> int:
    return t.numel() * t.element_size()


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


def differing(what: str, pairs: dict) -> int:
    """Logs the differing elements of each named (kernel, plain) output
    pair and fails unless there are none; returns the worst absolute
    difference (0)."""
    worst, diffs = 0, {}
    for k, (g, r) in pairs.items():
        diffs[k] = (g != r).sum().item()
        if diffs[k]:
            worst = max(worst, (g.long() - r.long()).abs().max().item())
    log(f"{what}: differing elements per output {json.dumps(diffs)}")
    check(all(v == 0 for v in diffs.values()),
          f"{what}: the kernel differs from its plain version")
    return worst


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


def fresh_ms(call, frames, n=5):
    """Mean device ms of n calls of call(copy) after a warm one, each on
    its own copy of `frames` (a call that updates its frames in place);
    the copies are made outside the timed span."""
    import torch

    ms = []
    for _ in range(n + 1):
        copy = frames()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call(copy)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return sum(ms[1:]) / n


def kernel_row(err, ms, plain_ms, bound_ms, by) -> dict:
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by}


# ---- 1. builds and resources ----------------------------------------------

def build_all() -> tuple:
    """Every kernel library, built in parallel; nvcc's ptxas lines
    logged.  Returns the engine's and the cost probe's library names."""
    from doomtpu_torch.ops import build

    phase("builds")
    log(f"nvcc: {build.nvcc_path() or 'not found'}")
    libs = (*ENGINE_LIBS, *build.VARIANTS)
    t0 = time.perf_counter()
    build.build_libraries(*libs, *PROBE_LIBS)
    for name in (*libs, *PROBE_LIBS):
        build.load_library(name)
        log(f"build: {name} (nvcc ended "
            f"{build.build_seconds.get(name, 0.0):.2f} s after the builds "
            f"started)")
        for line in build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build, {len(libs) + len(PROBE_LIBS)} libraries in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    return libs


def resource_report(libs, card: str) -> dict:
    """The resources of every engine and cost-probe library (the TPU
    probe scripts/probe_mosaic_layout.py asked which layouts Mosaic
    takes; on the card the question is resource legality): from nvcc's
    -Xptxas -v report, each kernel's registers a thread, spill stores and
    spill loads and static shared memory; the dynamic shared memory a
    block takes at the main path's launch (320x200, pools mid 40 / clip
    64 / item 24; the emission at e1m1 scale's 408 items and 736 segs,
    the seg rows at its 736 segs)
    and the blocks an SM then holds (the CUDA occupancy calculator).  Any
    spill fails the run."""
    from doomtpu_torch.ops import build
    from doomtpu_torch.ops import emit as em
    from doomtpu_torch.ops import itempass as ip
    from doomtpu_torch.ops import items as it
    from doomtpu_torch.ops import paint as p
    from doomtpu_torch.ops import resolve as rs
    from doomtpu_torch.ops import scan as sc

    phase("resources of every kernel library")
    H, KM, KC, KI = 200, 40, 64, 24
    # the emission at e1m1 scale: every item selected (215 map objects,
    # 193 drawable mids), 736 segs
    N, G = 408, 736
    e_threads, e_table = em.emit_block(320, N, KI, G)
    rows_lib = build.load_library("rows")
    # by kernel: (its dynamic shared memory, blocks an SM given the library)
    launch = {
        "paint_kernel": (lambda: p.paint_smem_bytes(*p.paint_tile(H), H),
                         lambda lib: p.paint_blocks_per_sm(H, lib=lib)),
        "items_kernel": (lambda: it.items_smem_bytes(
                             it.items_tile(H, KI, KC)[0], H, KI, KC),
                         lambda lib: it.items_blocks_per_sm(H, KI, KC)),
        "itempass_kernel": (lambda: ip.itempass_smem_bytes(
                                *ip.itempass_tile(H, KC, KM), H, KC, KM),
                            lambda lib: ip.itempass_blocks_per_sm(H, KC, KM)),
        "scan_kernel": (lambda: 0, lambda lib: sc.scan_blocks_per_sm()),
        "resolve_kernel": (lambda: rs.resolve_smem_bytes(H),
                           lambda lib: rs.resolve_blocks_per_sm(H)),
        "emit_kernel": (lambda: em.emit_smem_bytes(e_threads, N, KI, G,
                                                   e_table),
                        lambda lib: em.emit_blocks_per_sm(320, N, KI, G)),
        "rows_kernel": (lambda: rows_lib.doom_rows_smem_bytes(G),
                        lambda lib: rows_lib.doom_rows_blocks_per_sm(G)),
        "drop_kernel": (lambda: 0,
                        lambda lib: rows_lib.doom_live_drop_blocks_per_sm(
                            G, 1)),
        "tile_drop_kernel": (
            lambda: rows_lib.doom_live_drop_smem_bytes(G, 8),
            lambda lib: rows_lib.doom_live_drop_blocks_per_sm(G, 8)),
    }
    report = {}
    for name in libs:
        funcs = build.ptxas_resources(build.nvcc_output(name))
        kernels = {re.search(r"\d+([a-z_]+_kernel)", k).group(1): v
                   for k, v in funcs.items() if "registers" in v}
        check(kernels and set(kernels) <= set(launch),
              f"{name}: ptxas reported kernels {sorted(kernels)}")
        spills = {f: (v.get("spill_stores", 0), v.get("spill_loads", 0))
                  for f, v in funcs.items()}
        for kernel, r in kernels.items():
            smem_fn, blocks_fn = launch[kernel]
            row = {"kernel": kernel, "registers": r["registers"],
                   "spill_stores": sum(a for a, _ in spills.values()),
                   "spill_loads": sum(b for _, b in spills.values()),
                   "smem_static": r["smem_static"],
                   "smem_dynamic": smem_fn(),
                   "blocks_per_sm": blocks_fn(name)}
            key = name if len(kernels) == 1 else f"{name}.{kernel}"
            report[key] = row
            log(f"resources {key}: {json.dumps(row)}  [{card}]")
            check(row["spill_stores"] == 0 and row["spill_loads"] == 0,
                  f"{name}: ptxas spills registers {spills}")
            check(row["blocks_per_sm"] >= 1, f"{key}: no block fits an SM")
    # a probe that spills prices its local-memory traffic too: reported;
    # a spill fails only in P1's tensor-core kernels, P2 / P3 and P4
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
    return report


# ---- 2. the engine's kernels alone, B=4096 ---------------------------------

def engine(dev, wad, cfg):
    from doomtpu_torch.engine import DoomEngine

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # GRATE on solid walls
        return DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device=dev)


def new_game(eng, dev):
    """A new game of B cameras at spread poses (seed 0)."""
    import torch

    from torch_fixtures import spread_poses

    pos, ang = spread_poses(eng.tables, B)
    return eng.new_game(B, pos=pos, angle=ang,
                        generator=torch.Generator(dev).manual_seed(0))


def e1m1_inputs(dev, wad, cfg):
    """(engine, Morton-sorted state of B spread poses, seg frame, order)
    on the level of `wad` under `cfg`."""
    from doomtpu_torch.render import camera as cam
    from doomtpu_torch.render.camsort import sort_state

    eng = engine(dev, wad, cfg)
    st, _ = sort_state(new_game(eng, dev))
    lvl, px, py = eng.level, st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(lvl, cfg, px, py, st.angle, st.floor_height,
                                st.sector_light, st.timestamp)
    return eng, st, frame, cam.seg_order(lvl, cam.traversal_rank(lvl, px,
                                                                  py))


def row_bytes(rows, scnt, row_words) -> tuple[int, int, int]:
    """Bytes of the seg rows a kernel must read: `row_words` words of
    each active row (k < scnt) and 9 words of each active piece of it
    (edges, texture size, offset and id, and the one uy1 copy the
    kernel takes), counted from this run's flags."""
    import torch

    from doomtpu_torch.ops.layout import R_FLAGS

    active = (torch.arange(rows.shape[1], device=rows.device)[None]
              < scnt[:, None])
    flags = rows[..., R_FLAGS][active]
    pieces = sum(int(((flags >> p) & 1).sum()) for p in range(4))
    n_rows = int(active.sum())
    return (n_rows * row_words + pieces * 9) * 4, n_rows, pieces


def paint_pools_below_count(out: dict, cfg) -> dict:
    """A paint result's outputs by name, each pool slot at or past its
    column's count zeroed (the kernel writes no slot past it; the plain
    version zero-fills them, and nothing reads them)."""
    import torch

    named = {k: out[k] for k in ("idx", "ld", "rgb", "cnt_mid", "cnt_clip",
                                 "overflow")}
    for pool, cnt, K in (("midpool", "cnt_mid", cfg.mid_capacity),
                         ("clippool", "cnt_clip", cfg.clip_capacity)):
        below = (torch.arange(K, device=out[cnt].device)[None, None, :]
                 < out[cnt][..., None])
        for i, p in enumerate(out[pool]):
            named[f"{pool}{i}"] = torch.where(below, p, 0)
    return named


def paint_kernels(dev, card: str) -> dict:
    """The seg rows and the live drop (on the camera stage's output), K1,
    K2, the emission and K3 on e1m1-scale's B=4096 paint-path inputs
    (hand pools mid 40 / clip 64 / item 24, which drop nothing there),
    each against its plain version, then timed alone beside its bound;
    P6, the paint kernel's cost split, on K1's inputs."""
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.ops import emit, layout, paint
    from doomtpu_torch.render import things
    from doomtpu_torch.wad import synth

    phase(f"e1m1-scale B={B}: the rows, the live drop, K1, K2, the "
          f"emission, K3")
    cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                       clip_capacity=64, item_capacity=24,
                       use_pallas_paint=True)
    eng, st, frame, order = e1m1_inputs(dev, synth.e1m1_scale_wad(), cfg)
    lvl, px, py = eng.level, st.pos[:, 0], st.pos[:, 1]
    check(lvl.paint_ok, "e1m1-scale is not paint-eligible")
    args = paint.build_inputs(lvl, cfg, frame, order, st.angle, px, py,
                              st.floor_height)
    rows, scnt = args[0], args[1]
    log(f"active segs per camera: mean {scnt.float().mean().item():.1f}, "
        f"max {scnt.max().item()} of {lvl.num_segs}")
    res = rows_kernels(lvl, frame, order, card)

    # K1: the row words it reads of the active segs (16 of a row: all
    # before the pieces; 9 per active piece), the per-camera scalars and
    # the tables read once; the frame planes and counts written whole,
    # the pools only in their occupied slots.  Operations, loosely from
    # above: ~40 per (column, visited seg) and ~20 per pixel.
    got, ref, plain_ms = against_plain(
        lambda: paint.paint(lvl, cfg, *args),
        lambda: paint.paint_reference(lvl, cfg, *args))
    g, r = paint_pools_below_count(got, cfg), paint_pools_below_count(ref,
                                                                      cfg)
    err = differing(f"paint B={B}", {k: (g[k], r[k]) for k in r})
    del ref, g, r
    ms = event_ms(lambda: paint.paint(lvl, cfg, *args), 5)
    r_bytes, n_rows, n_pieces = row_bytes(rows, scnt, layout.R_PIECE0)
    p_in = (r_bytes + nbytes(scnt) + nbytes(args[2]) + nbytes(args[3])
            + sum(nbytes(getattr(lvl, k)) for k in (
                "tex_pixels", "flat_pixels", "sky_pixels", "palette_packed")))
    mid_used = int(torch.clamp(got["cnt_mid"], max=cfg.mid_capacity).sum())
    clip_used = int(torch.clamp(got["cnt_clip"], max=cfg.clip_capacity).sum())
    p_out = (sum(nbytes(got[k]) for k in ("idx", "ld", "rgb", "cnt_mid",
                                           "cnt_clip", "overflow"))
             + (mid_used * len(got["midpool"])
                + clip_used * len(got["clippool"])) * 4)
    p_ops = (40.0 * float(scnt.sum()) * cfg.width
             + 20.0 * B * cfg.height * cfg.width)
    bound_ms, by = bound(p_in + p_out, p_ops)
    log(f"paint B={B}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
        f"{p_in + p_out} bytes, {n_rows} active rows with {n_pieces} active "
        f"pieces, {mid_used} mid and {clip_used} clip slots used), plain "
        f"PyTorch {plain_ms:.2f} ms  [{card}]")
    res["paint"] = kernel_row(err, ms, plain_ms, bound_ms, by)
    probe_paint(lvl, cfg, args, ms, card)
    out = got

    # the item pool: the selection and packs, then the emission
    pools = things.pools_from_paint(out)
    pack, _ = things._item_pack(lvl, cfg, frame, order, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.mobj_state)
    res["emit"] = emit_kernel(lvl, cfg, pack, pools[1], card)
    ipool, icnt, overflow, peak = emit.emit(lvl, cfg, pack, pools[1])
    log(f"item slots per column: peak {int(icnt.max())} of "
        f"{cfg.item_capacity}, uncapped peak {int(peak.max())}, overflow "
        f"{int(overflow.sum())}")
    res["items"] = items_kernel(lvl, cfg, ipool, icnt, out, pools[0], card)
    del ipool, icnt, pack

    # K3 on the same paint result and every selected item
    ip_cfg = dataclasses.replace(cfg, use_item_pass_kernel=True)
    pack, _ = things.item_pack(lvl, ip_cfg, frame, order, px, py, st.angle,
                               st.floor_height, st.sector_light,
                               st.mobj_state)
    res["itempass"] = itempass_kernel(lvl, ip_cfg, pack, out, card)
    return res


def distinct_bytes(t) -> int:
    """Bytes of the distinct elements of `t` (a dimension expanded with
    stride 0 counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def rows_kernels(lvl, frame, order, card: str) -> dict:
    """The seg rows and the live drop (csrc/rows.cu), each against its
    plain version (the drop under a cap of 32, which drops segs, with
    tile-shared lists and then per-camera ones), then timed alone; the
    row kept is the per-camera drop's, the benchmark's.  The rows' bound:
    every frame field the rows take and the order read once (a [1, G]
    field expanded to B once), the rows and scnt written whole; the
    drop's: x0 and x1 of each active row and scnt read (per tile also
    the order twice and each active row's seg id), the drop mask written
    whole.  A few integer operations a word: bytes-bound."""
    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.ops import paint

    got, ref, plain_ms = against_plain(
        lambda: paint.build_rows(lvl, frame, order),
        lambda: paint.build_rows_reference(lvl, frame, order))
    err = differing(f"rows B={B}", {"rows": (got[0], ref[0]),
                                    "scnt": (got[1], ref[1])})
    del ref
    rows, scnt = got
    ms = event_ms(lambda: paint.build_rows(lvl, frame, order), 5)
    fields = paint.ROW_FIELDS + paint.PIECE_FIELDS
    r_in = (sum(distinct_bytes(frame[name]) for name, _ in fields)
            + nbytes(order) + sum(nbytes(getattr(lvl, k)) for k in (
                "flat_is_sky", "tex_h", "tex_w")))
    r_out = nbytes(rows) + nbytes(scnt)
    bound_ms, by = bound(r_in + r_out, 0.0)
    log(f"rows B={B}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: {r_in} "
        f"bytes read, {r_out} written), plain PyTorch {plain_ms:.2f} ms  "
        f"[{card}]")
    res = {"rows": kernel_row(err, ms, plain_ms, bound_ms, by)}

    # the tile-shared drop, then the per-camera one (the benchmark's, kept)
    for percam in (False, True):
        cfg = RenderConfig(width=320, height=200, paint_live_capacity=32,
                           paint_percam_compact=percam)
        what = f"live drop {'per camera' if percam else 'per tile'} B={B}"
        got, ref, plain_ms = against_plain(
            lambda: paint.live_drop(cfg, rows, scnt, order),
            lambda: paint.live_drop_reference(cfg, rows, scnt, order))
        err = differing(what, {"drop": (got[0], ref[0]),
                               "live_dropped": (got[1], ref[1])})
        log(f"{what} at a cap of 32: {int(ref[1])} (camera or tile, seg, "
            f"block) entries dropped")
        del ref
        ms = event_ms(lambda: paint.live_drop(cfg, rows, scnt, order), 5)
        d_in = 8 * int(scnt.sum()) + nbytes(scnt)
        if not percam:                 # the order twice, and R_G
            d_in += 2 * nbytes(order) + 4 * int(scnt.sum())
        d_out = nbytes(got[0]) + nbytes(got[1])
        bound_ms, by = bound(d_in + d_out, 0.0)
        log(f"{what}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
            f"{d_in} bytes read, {d_out} written), plain PyTorch "
            f"{plain_ms:.2f} ms  [{card}]")
    res["live_drop"] = kernel_row(err, ms, plain_ms, bound_ms, by)
    return res


def probe_paint(lvl, cfg, args, full_ms: float, card: str) -> None:
    """P6, the paint kernel's cost split (the TPU probe
    scripts/probe_paint_cost.py, on the card): the kernel built at
    PAINT_PROBE levels 1-3 (csrc/paint.cu), each timed on the inputs the
    full kernel took `full_ms` on."""
    from doomtpu_torch.ops import paint

    split = {}
    for n, what in ((1, "init and outputs only"),
                    (2, "+ seg x-range checks"),
                    (3, "+ occlusion and emit math, no painting")):
        split[what] = event_ms(
            lambda: paint.paint_probe(lvl, cfg, *args, n), 5)
    split["full kernel"] = full_ms
    log(f"paint cost probe at B={args[0].shape[0]}, "
        f"{paint.paint_tile(cfg.height)} (columns, threads a column) "
        "(CUDA events, ms): "
        + json.dumps({k: round(v, 4) for k, v in split.items()})
        + f"  [{card}]")


def emit_kernel(lvl, cfg, pack, mid, card: str) -> dict:
    """The emission against emit_reference, then timed.  Its bound: the
    pool written whole (every slot, zeros past a column's count), icnt
    and the two counters; of the pack, the first three words of every
    item and the whole of each (camera, item) pair that is present in
    some column (a valid sprite whose [x0, x1e) meets the screen, a
    valid mid whose seg a record carries); the mid records below each
    column's count (kind and seg, 2 words) and the 6 words of the record
    each mid slot takes.  Operations, ~40 per sprite slot (three IEEE
    divides among them): it is bytes-bound."""
    import torch

    from doomtpu_torch.ops import emit, items, layout

    got, ref, plain_ms = against_plain(
        lambda: emit.emit(lvl, cfg, pack, mid),
        lambda: emit.emit_reference(lvl, cfg, pack, mid))
    names = [f"plane{i}" for i in range(items.ITEM_PLANES)] + [
        "icnt", "item_overflow", "item_peak"]
    err = differing(f"emit B={B}", dict(zip(names, zip(
        [*got[0], *got[1:]], [*ref[0], *ref[1:]]))))
    del ref
    ms = event_ms(lambda: emit.emit(lvl, cfg, pack, mid), 10, spin=True)
    ipool, icnt = got[0], got[1]
    ip = pack["i"]
    _, N, _ = ip.shape
    W, G = cfg.width, lvl.num_segs
    word = ipool[0]
    spr_slots = int(((word & items.SPR_MARK) != 0).sum())
    mid_slots = int(((word != 0) & ((word & items.SPR_MARK) == 0)).sum())
    KM = mid["span"].shape[1]
    rec = ((((mid["span"] >> 29) & 3) == layout.KIND_MID)
           & (torch.arange(KM, device=word.device)[None, :, None]
              < mid["cnt"][:, None]))
    records = int(torch.clamp(mid["cnt"], max=KM).sum())
    carried = torch.zeros((B, G + 1), dtype=torch.bool, device=word.device)
    carried.scatter_(1, torch.where(rec, mid["d6"], G).reshape(B, -1)
                     .long(), True)
    carried[:, G] = False
    fl, x0, x1e, seg = ip[..., 0], ip[..., 1], ip[..., 2], ip[..., 6]
    valid, spr = (fl & 1) != 0, (fl & 2) != 0
    on_mid = torch.gather(carried, 1, torch.clamp(seg, 0, G).long())
    pairs = int((valid & spr & (x1e > 0) & (x0 < W)).sum()
                + (valid & ~spr & on_mid).sum())
    row = (ip.shape[2] + pack["f"].shape[2]) * 4
    e_in = (B * N * 12 + pairs * row + records * 2 * 4 + mid_slots * 6 * 4
            + nbytes(mid["cnt"]))
    e_out = nbytes(ipool) + nbytes(icnt) + 2 * B * 4
    bound_ms, by = bound(e_in + e_out, 40.0 * spr_slots)
    log(f"emit B={B}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
        f"{e_in + e_out} bytes, the pool {nbytes(ipool)} written whole; "
        f"{pairs} (camera, item) pairs present; {spr_slots} sprite and "
        f"{mid_slots} mid slots, {records} mid records), plain PyTorch "
        f"{plain_ms:.2f} ms  [{card}]")
    return kernel_row(err, ms, plain_ms, bound_ms, by)


def items_kernel(lvl, cfg, ipool, icnt, out, clip, card: str) -> dict:
    """K2 against composite_items_reference, each on its own copy of the
    paint frame, then timed.  Its bound: the pool words of the occupied
    slots, the clip records of the columns that hold a sprite, the counts
    and the atlas read once; idx / ld / rgb written once where the items
    changed them.  Operations: 3 per (slot, row) of the fold (divide,
    multiply, add), ~8 per clip test of a sprite slot, ~8 per shaded
    pixel."""
    import torch

    from doomtpu_torch.ops import items

    bg = lambda: [out[k].clone() for k in ("idx", "ld", "rgb")]
    got, ref, plain_ms = against_plain(
        lambda: items.composite_items(lvl, cfg, ipool, icnt, *bg(),
                                      clip=clip),
        lambda: items.composite_items_reference(lvl, cfg, ipool, icnt,
                                                *bg(), clip=clip))
    err = differing(f"items B={B}", dict(zip(("idx", "ld", "rgb"),
                                             zip(got, ref))))
    del ref
    ms = fresh_ms(lambda f: items.composite_items(lvl, cfg, ipool, icnt, *f,
                                                  clip=clip), bg)
    occupied = (torch.arange(cfg.item_capacity, device=icnt.device)
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
    touched = int(((got[0] != out["idx"]) | (got[1] != out["ld"])
                   | (got[2] != out["rgb"])).sum())
    i_in = (n_slots * 6 * 4 + n_spr * 2 * 4 + clip_recs * 6 * 4
            + nbytes(icnt) + int(spr_cols.sum()) * 4 + nbytes(lvl.atlas_cm)
            + nbytes(lvl.palette_packed))
    i_out = touched * 3 * 4
    i_ops = 3.0 * fold_rows + 8.0 * clip_tests + 8.0 * touched
    bound_ms, by = bound(i_in + i_out, i_ops)
    log(f"items B={B}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
        f"{i_in + i_out} bytes, {n_slots} occupied slots, {clip_recs} clip "
        f"records, {touched} pixels written; ~{i_ops:.4g} operations), "
        f"plain PyTorch {plain_ms:.2f} ms  [{card}]")
    return kernel_row(err, ms, plain_ms, bound_ms, by)


def itempass_kernel(lvl, cfg, pack, out, card: str) -> dict:
    """K3 against item_pass_reference, each on its own copy of the paint
    frame, then timed.  Its bound: of the pack, the first three words of
    every item (valid, x0, x1e) and the rest of each item that covers a
    column of its camera; the clip records of the columns a sprite
    covers and the mid records of the columns a mid covers; both counts
    of every column; the atlas and palette once; idx / ld / rgb written
    once where the items changed them.  Operations: ~30 per (item,
    column) of billboard math, ~8 per clip test, ~3 per mid-record test,
    ~8 per written pixel."""
    import torch

    from doomtpu_torch.ops import itempass

    fresh = lambda: dict(out, **{k: out[k].clone()
                                 for k in ("idx", "ld", "rgb")})
    got, ref, plain_ms = against_plain(
        lambda: itempass.item_pass(lvl, cfg, pack, fresh()),
        lambda: itempass.item_pass_reference(lvl, cfg, pack, fresh()))
    err = differing(f"itempass B={B}", dict(zip(("idx", "ld", "rgb"),
                                                zip(got, ref))))
    del ref
    ms = fresh_ms(lambda f: itempass.item_pass(lvl, cfg, pack, f), fresh)
    ip = pack["i"]
    _, N, _ = ip.shape
    fl, x0, x1e = ip[..., 0], ip[..., 1], ip[..., 2]
    valid, spr = (fl & 1) != 0, (fl & 2) != 0
    xs = torch.arange(cfg.width, device=ip.device)
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
    rest = (nbytes(ip) + nbytes(pack["f"])) // (B * N) - 12
    i_in = (B * N * 12 + covering * rest + clip_recs * 6 * 4
            + mid_recs * 7 * 4 + nbytes(ccnt) + nbytes(mcnt)
            + nbytes(lvl.atlas_cm) + nbytes(lvl.palette_packed))
    i_out = touched * 3 * 4
    i_ops = (30.0 * item_cols + 8.0 * clip_tests + 3.0 * mid_tests
             + 8.0 * touched)
    bound_ms, by = bound(i_in + i_out, i_ops)
    log(f"itempass B={B}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
        f"{i_in + i_out} bytes, {B * N} (camera, item) pairs, {covering} "
        f"covering a column; {clip_recs} clip and {mid_recs} mid records; "
        f"{touched} pixels written; ~{i_ops:.4g} operations), plain "
        f"PyTorch {plain_ms:.2f} ms  [{card}]")
    return kernel_row(err, ms, plain_ms, bound_ms, by)


def scan_kernels(dev, card: str) -> dict:
    """K4 and the resolve on e1m1-scale-masked's B=4096 inputs (GRATE on
    some solid walls, so the paint kernel does not take the level; its
    span_capacity the measured uncapped peak, rounded up to 8), each
    against its plain version, then timed alone beside its bound."""
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.ops import paint, resolve, scan
    from doomtpu_torch.render import resolve as res
    from doomtpu_torch.wad import synth

    phase(f"e1m1-scale-masked B={B}: K4, the resolve")
    cfg = RenderConfig(width=320, height=200, span_capacity=256,
                       mid_capacity=40, clip_capacity=64, item_capacity=24)
    eng, st, frame, order = e1m1_inputs(dev, synth.e1m1_scale_masked_wad(),
                                        cfg)
    lvl = eng.level
    check(not lvl.paint_ok, "e1m1-scale-masked is paint-eligible")
    rows, scnt = paint.build_rows(lvl, frame, order)
    peak = int(scan.scan(lvl, cfg, rows, scnt)["cnt"].max())
    check(peak < cfg.span_capacity, f"span pool of {cfg.span_capacity} "
          f"overflowed measuring the peak")
    cfg = dataclasses.replace(cfg, span_capacity=-(-peak // 8) * 8)
    log(f"span records per column: uncapped peak {peak}; span_capacity "
        f"{cfg.span_capacity}; active segs per camera: mean "
        f"{scnt.float().mean().item():.1f}, max {scnt.max().item()}")
    res_rows = {}

    # K4: the row words it reads of the active segs once (14 of a row:
    # seg id, flags, x range, lsx / lex, length, offsets, light, flats,
    # plane heights; 9 per active piece), the counts, the overflow and
    # the occupied slots' 7 words written once (nothing reads a slot past
    # its column's count).  Operations, loosely from above: ~40 per
    # (column, active seg).
    got, ref, plain_ms = against_plain(
        lambda: scan.scan(lvl, cfg, rows, scnt),
        lambda: scan.scan_reference(lvl, cfg, rows, scnt))
    K = cfg.span_capacity
    below = (torch.arange(K, device=dev)[None, :, None]
             < ref["cnt"][:, None, :])
    pairs = {"cnt": (got["cnt"], ref["cnt"]),
             "overflow": (got["overflow"], ref["overflow"])}
    for i, name in enumerate(("span", "d1", "d2", "d3", "d4", "d5", "d6")):
        pairs[name] = (torch.where(below, got["pool"][i], 0),
                       torch.where(below, ref["pool"][i], 0))
    err = differing(f"scan B={B}", pairs)
    del ref, pairs, below
    ms = event_ms(lambda: scan.scan(lvl, cfg, rows, scnt), 5)
    cnt = got["cnt"]
    used = int(cnt.sum())
    r_bytes, n_rows, n_pieces = row_bytes(rows, scnt, 14)
    k_in = r_bytes + nbytes(scnt)
    k_out = nbytes(cnt) + B * 4 + used * scan.POOL_PLANES * 4
    bound_ms, by = bound(k_in + k_out, 40.0 * float(scnt.sum()) * cfg.width)
    log(f"scan B={B}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
        f"{k_in + k_out} bytes, {n_rows} active rows with {n_pieces} active "
        f"pieces, {used} occupied slots), {scan.scan_blocks_per_sm()} "
        f"blocks an SM, plain PyTorch {plain_ms:.2f} ms  [{card}]")
    res_rows["scan"] = kernel_row(err, ms, plain_ms, bound_ms, by)
    del got, rows

    # the resolve: the span word and d1..d5 of every occupied slot, the
    # counts, and idx / ld / rgb written (12 bytes a pixel), each once;
    # the level's atlas and palette come from L2.  Operations, loosely
    # from above: ~60 a pixel.  Timed on its per-camera words made once
    # (the trig's host read is no part of it).
    from doomtpu_torch.render import walls

    pool, cnt, _ = walls.wall_scan(lvl, cfg, frame, order)
    poses = (st.pos[:, 0], st.pos[:, 1], st.angle, st.floor_height)
    got, ref, plain_ms = against_plain(
        lambda: res.resolve_frame(lvl, cfg, frame, pool, cnt, *poses),
        lambda: res.resolve_reference(lvl, cfg, frame, pool, cnt, *poses))
    err = differing(f"resolve B={B}", dict(zip(("idx", "ld", "rgb"),
                                               zip(got, ref))))
    del got, ref
    camf, cami = resolve.camera_scalars(*poses)
    ms = event_ms(lambda: resolve.resolve(lvl, cfg, pool, cnt, camf, cami),
                  10, spin=True)
    pixels = B * cfg.height * cfg.width
    r_bytes = int(cnt.sum()) * 6 * 4 + nbytes(cnt) + pixels * 3 * 4
    bound_ms, by = bound(r_bytes, 60.0 * pixels)
    log(f"resolve B={B}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
        f"{r_bytes} bytes), {resolve.resolve_blocks_per_sm(cfg.height)} "
        f"blocks an SM, plain PyTorch {plain_ms:.2f} ms  [{card}]")
    res_rows["resolve"] = kernel_row(err, ms, plain_ms, bound_ms, by)
    return res_rows


# ---- 3. the main paths, B=4096: the launches each makes ------------------

def main_paths(dev, card: str) -> dict:
    """One untimed run of each pipeline through DoomEngine on B=4096
    spread poses at 320x200, with the hand pools of the kernel phases and
    the benchmark's per-camera live lists under a cap above every live
    count (512): render on e1m1-scale (the rows, the live drop, K1, the
    emission and K2), on e1m1-scale-masked (the rows, K4, the resolve,
    the emission and K2) and with use_item_pass_kernel (the rows, the
    live drop, K1 and K3), and a reuse rollout of T=8 ticks of zero
    controls (the rows, K1, the emission and K2 once a tick, the live
    drop on the refresh tick; live_stale 0).  Each run's launches, read
    after a synchronize, must be its pipeline's, and each render's
    capacity counters 0.  Returns path -> launches."""
    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.wad import synth
    from torch_fixtures import kernels, launches

    phase(f"the main paths at B={B}: launches")
    T = 8
    paint_cfg = RenderConfig(width=320, height=200, mid_capacity=40,
                             clip_capacity=64, item_capacity=24,
                             use_pallas_paint=True,
                             paint_percam_compact=True,
                             paint_live_capacity=512)
    none = dict.fromkeys(kernels(), 0)
    runs = {
        "paint render": (synth.e1m1_scale_wad, paint_cfg,
                         dict(none, rows=1, live_drop=1, paint=1, emit=1,
                              items=1)),
        "scan render": (synth.e1m1_scale_masked_wad,
                        dataclasses.replace(paint_cfg, span_capacity=256),
                        dict(none, rows=1, scan=1, resolve=1, emit=1,
                             items=1)),
        "item-pass render": (synth.e1m1_scale_wad, dataclasses.replace(
                                 paint_cfg, use_item_pass_kernel=True),
                             dict(none, rows=1, live_drop=1, paint=1,
                                  itempass=1)),
        "reuse rollout": (synth.e1m1_scale_wad, paint_cfg,
                          dict(none, rows=T, live_drop=1, paint=T, emit=T,
                               items=T)),
    }
    res = {}
    for what, (wad, cfg, want) in runs.items():
        eng = engine(dev, wad(), cfg)
        st = new_game(eng, dev)
        if what == "reuse rollout":
            controls = torch.zeros((T, B), dtype=torch.int32, device=dev)
            draws = eng.light_draws(B, torch.Generator(dev).manual_seed(0),
                                    ticks=T)
            got, (final, sums, stale) = launches(lambda: eng.rollout(
                st, controls, draws=draws, return_frames=False,
                live_reuse=True))
            check(tuple(sums.shape) == (T, B) and int(final.tick[0]) == T,
                  f"{what}: output shapes")
            check(int(stale) == 0, f"{what}: live_stale {int(stale)} with "
                  f"zero controls")
            st = final
        else:
            got, (idx, rgb) = launches(lambda: eng.render(st))
            check(idx.is_cuda and tuple(idx.shape) == (B, 200, 320),
                  f"{what}: frame {tuple(idx.shape)} on {idx.device}")
            del idx, rgb
        counters = eng.render_counters(st)
        log(f"main path {what} B={B}: launches {json.dumps(got)}; "
            f"render_counters {json.dumps(counters)}  [{card}]")
        check(got == want, f"{what}: launches {got}, want {want}")
        check(set(counters.values()) == {0},
              f"{what}: capacity counters not 0: {counters}")
        res[what] = got
        del eng, st
        torch.cuda.empty_cache()
    return res


# ---- 4. the Hopper probes P1-P4, timed -------------------------------------

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


def exact_turns(pv, dev, reps: int = 20) -> dict:
    """P2 and P3 at one copy on main6's f32 input, in turns with
    torch.matmul of the same operands ((8, 128) x (128, 1024); P2 against
    allow_tf32=True, P3 against False): kernel, matmul, matmul, kernel,
    each the mean of `reps` calls, first device-paced (event_ms with
    spin), then eager.  Returns "P2" / "P3" -> {"ms", "library_ms"
    (device time), "eager_ms", "eager_library_ms", "turns_ms",
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


def log_exact(turns: dict, price: dict, p1_ns: dict, card: str,
              reps: int = 20) -> None:
    for label, r in turns.items():
        tf32 = label == "P2"
        log(f"{label} (64, 128) against torch.matmul (allow_tf32={tf32}), "
            f"turns kernel / matmul / matmul / kernel, ms of {reps} calls: "
            f"device {' / '.join(f'{t:.5f}' for t in r['turns_ms'])}; "
            f"eager {' / '.join(f'{t:.5f}' for t in r['eager_turns_ms'])}"
            f"  [{card}]")
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


def probes_timing(dev, card: str) -> dict:
    """The Hopper probes' own path (their kernels against their plain
    versions are tests/test_torch_cuda.py -k probe), with their counts
    set to 0 just before and read after: every P1 construct at N = 40000
    on both shapes beside its bound (the operations it needs,
    ops/probe_visit.py::NEEDS) and its SASS count; P2's and P3's turns
    with torch.matmul (TF32 allowed for P2, not for P3; exact_turns) and
    their price of a field at full-card occupancy, written and one slice
    written (exact_price), beside P1's; the price of a field with w in
    registers against w from shared memory (field_variants); P4's modes
    at S = 4096 serial and at the full-card chunking; torch.matmul's bad
    counts on P2 / P3's operands.  Returns the four kernel rows."""
    import torch

    from doomtpu_torch.ops import probe_visit as pv
    from doomtpu_torch.ops import probe_ybounds as pyb

    phase("Hopper probes P1-P4")
    counted = {"probe_visit": pv.construct, "probe_exact1": pv.exact1,
               "probe_exact3": pv.exact3, "probe_ybounds": pyb.ybounds}
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    p1 = pv.measure(dev, reps=2, card=card, log=log)
    turns = exact_turns(pv, dev)
    price = exact_price(pv, dev, pv.OCCUPANCY_COPIES)
    log_exact(turns, price, pv.p1_field_ns(p1, dev), card)
    variants = field_variants(pv, dev, card)
    p4_serial = pyb.measure(dev, card=card, chunks=1, log=log)
    p4 = pyb.measure(dev, card=card, log=log)
    rows = {k: {"launches": fn.launches, "max_abs_err": None,
                "plain_ms": None} for k, fn in counted.items()}
    for k, r in rows.items():
        check(r["launches"] > 0, f"{k}: the probes' path launched no kernel")
    log(f"the probes' path: {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps({k: r['launches'] for k, r in rows.items()})}")
    for name in pv.CONSTRUCTS:
        check(p1[name]["bound_ns"] > 0, f"P1 {name}: no bound")
    # a time under its bound would mean a rate or a count of NEEDS is wrong
    under = {n: r["ns_per_iter"] for n, r in p1.items()
             if min(r["ns_per_iter"].values()) < r["bound_ns"]}
    log(f"P1 constructs timed under their bound: {json.dumps(under)}")
    rows["probe_visit"].update(
        ms=sum(sum(r["ms"].values()) for r in p1.values()),
        bound_ms=sum(r["bound_ns"] * pv.N * len(r["ms"]) / 1e6
                     for r in p1.values()), bound_by="operations",
        iterations={"ms": pv.N, "bound_ms": pv.N}, w_variants=variants)
    # P2 / P3: the one-hot products' bytes and TF32 operations; ms and
    # library_ms the device-paced turns at one copy (the eager ones beside
    # them), and the price at full-card occupancy
    sel = torch.from_numpy(pv.exact_selectors()).to(dev)
    ws = {k: torch.from_numpy(v).to(dev) for k, v in pv.exact_inputs().items()}
    bytes_moved = (ws["f32"].numel() + sel.numel() + 64 * 128) * 4
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
    for k, r in rows.items():
        log(f"{k}: {json.dumps(r)}  [{card}]")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script only runs on "
              "the card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root), str(root / "tests")]
    from doomtpu_torch.ops import build

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build_all()
    resources = resource_report(libs, card)
    kernels = paint_kernels(dev, card)
    torch.cuda.empty_cache()
    kernels.update(scan_kernels(dev, card))
    torch.cuda.empty_cache()
    paths = main_paths(dev, card)
    probes = probes_timing(dev, card)
    phase("done")
    # each kernel's launches in one run of the main path that takes it
    for k, path in (("rows", "paint render"), ("live_drop", "paint render"),
                    ("paint", "paint render"), ("items", "paint render"),
                    ("emit", "paint render"), ("scan", "scan render"),
                    ("resolve", "scan render"),
                    ("itempass", "item-pass render")):
        kernels[k].update(launches=paths[path][k], launches_path=path)

    check(not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                  for m in sys.modules), "jax was imported")
    check(not any(m == "doomtpu" or m.startswith("doomtpu.")
                  for m in sys.modules), "the JAX package doomtpu was imported")
    # the cost probe's builds: resources only (no engine launches)
    log(json.dumps({"probes": [
        dict(name=name, source=f"doomtpu_torch/ops/csrc/"
             f"{build.VARIANTS[name][0]}.cu", **resources[name])
        for name in build.VARIANTS]}))
    row = lambda name, src, replaces, r: {
        "name": name, "route": "cuda",
        "source": f"doomtpu_torch/ops/csrc/{src}.cu", "replaces": replaces,
        "library_ms": None, **r}
    rows_note = "none (doomtpu/ops/pallas_paint.py render_paint, XLA)"
    log(json.dumps({"kernels": [
        row("rows", "rows", rows_note, kernels["rows"]),
        row("live_drop", "rows", rows_note, kernels["live_drop"]),
        row("paint", "paint", "doomtpu/ops/pallas_paint.py:326",
            kernels["paint"]),
        row("items", "items", "doomtpu/ops/pallas_items.py:245",
            kernels["items"]),
        row("scan", "scan", "doomtpu/ops/pallas_scan.py:46", kernels["scan"]),
        row("itempass", "itempass", "doomtpu/ops/pallas_itempass.py:57",
            kernels["itempass"]),
        row("resolve", "resolve", "none (doomtpu/render/resolve.py:85, XLA)",
            kernels["resolve"]),
        row("emit", "emit", "none (doomtpu/render/things.py item_pool, XLA)",
            kernels["emit"]),
        row("probe_visit", "probe_visit", "scripts/probe_visit_cost.py:31",
            probes["probe_visit"]),
        row("probe_exact1", "probe_visit", "scripts/probe_visit_cost.py:301",
            probes["probe_exact1"]),
        row("probe_exact3", "probe_visit", "scripts/probe_visit_cost.py:350",
            probes["probe_exact3"]),
        row("probe_ybounds", "probe_ybounds",
            "scripts/probe_percam_ybounds.py:141", probes["probe_ybounds"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
