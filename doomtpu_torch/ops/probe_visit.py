"""Hopper probes P1-P3: per-construct cost and one-hot exactness.

Counterpart of scripts/probe_visit_cost.py (P1: `run` and its 17
construct kernels; P2: `main6`; P3: `main7`).  `construct`, `exact1`
and `exact3` launch the hand-written CUDA kernels (csrc/probe_visit.cu)
on CUDA tensors and run their plain PyTorch versions
(`construct_reference`, `exact1_reference`, `exact3_reference`) on CPU
tensors; anything else raises.

P1: construct `name` repeated `n` times into an (8, 128) accumulator
(see csrc/probe_visit.cu for each construct's Hopper form).  The output
is [copies, 8, 128] i32: one copy of the TPU kernel's (8, 128) output
per 1024 threads of the launch (per 128 for the tensor-core constructs,
whose warps own a 32-lane group of all 8 rows, in blocks of at most 256
threads), every copy equal but gather_l2's, whose copy c starts its
chains at x + 1024 c.  Where a TPU construct votes over its whole vector
(`.any()`), the Hopper one votes over a warp (`__any_sync`): the same
output on the TPU probes' inputs.

P2 / P3: the 8 one-hot products (8, 128) x (128, 128) of `main6` /
`main7`, as their (64, 128) i32 bit patterns; rows 8f..8f+7 hold field f
of w broadcast over the lanes when the products are exact.  `copies` > 1
repeats the 8 products into [copies, 64, 128] (every copy equal): the
shape that fills the card, where chip_smoke.py prices one field product
(`field_bounds_ns`); `stored` = 1 runs every copy but writes only the
first, the same price without the output's bytes.

    python -m doomtpu_torch.ops.probe_visit

prints, on the card, every construct's time per iteration at its two
launch shapes (`configs`: one block, and K1's occupancy) beside its
bound, and P2's and P3's exactness, as the JAX script prints them
(`name ... ns/iter`, `mxuexact f32: exact=... bad=...`).
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

I32, F32 = torch.int32, torch.float32
N = 40000          # the TPU probe's iterations
CHECK_N = 64       # iterations where the plain version is compared
ROWS, LANES, WINDOWS, FIELDS = 8, 128, 64, 13
GATHER_WORDS = 1 << 20
CHAIN = 8          # fdiv / fmulrcp: chained operations an iteration
# P2 / P3 at full-card occupancy: copies of the 8 products (512 MB of
# output, a few hundred us on an H100)
OCCUPANCY_COPIES = 16384
# the H100 SXM data sheet: HBM bytes/s; TF32 FMAs a clock an SM (495
# dense TFLOP/s over 132 SMs at the boost clock)
HBM_BYTES_PER_S = 3.35e12
TF32_FMA_PER_CLOCK = 1024

# the order of csrc/probe_visit.cu's Construct enum
CONSTRUCTS = (
    "math", "branch", "branch_f", "branch_div", "relayout", "dynload",
    "gather_l2", "smem", "fori0", "colbcast13", "lanegather13", "mxubcast",
    "mxubcast13", "mxu13diff", "mxu13hi", "mxu48hi", "mxu13cvt",
    "branchy_mxu", "branchy_ld", "fdiv", "fmulrcp",
)
# each construct's TPU body in scripts/probe_visit_cost.py, by function
# name (None: a Hopper suspect with no TPU body)
TPU_BODY = {
    "math": "k_math", "branch": "k_branch", "branch_f": "k_branch_false",
    "branch_div": None, "relayout": "k_relayout", "dynload": "k_dynload",
    "gather_l2": None, "smem": "k_smem", "fori0": "k_fori0",
    "colbcast13": "k_colbcast", "lanegather13": "k_lanegather13",
    "mxubcast": "k_mxubcast", "mxubcast13": "k_mxubcast13",
    "mxu13diff": "k_mxu13diff", "mxu13hi": "k_mxu13hi", "mxu48hi": "k_mxu48",
    "mxu13cvt": "k_mxu13cvt", "branchy_mxu": "_mk_branchy(True)",
    "branchy_ld": "_mk_branchy(False)", "fdiv": None, "fmulrcp": None,
}
MMA = {"mxubcast", "mxubcast13", "mxu13diff", "mxu13hi", "mxu48hi",
       "mxu13cvt", "branchy_mxu"}
# the tensor-core constructs' blocks: at most 256 threads, a copy per 128
# (4 warps, one 32-lane group each); at 2 copies an SM, 8 warps
MMA_THREADS, MMA_COPY_THREADS, MMA_WARPS_PER_SM = 256, 128, 8
# the constructs with a second form (`construct(..., w_from_smem=True)`):
# w's fragments read from shared memory for every product
W_FROM_SMEM = ("mxu13diff", "mxu13hi")
# single-pass TF32 products (the rest of MMA split A into three pieces)
TF32_ONE_PASS = {"mxubcast", "mxubcast13", "mxu13diff"}
# the SASS diagnostic: the share of the iterations whose conditional
# code runs (fdiv: the divide's slow path, for operands near the
# exponent range's ends, which these never are), and the trips of each
# construct's inner loops, outermost first (the tensor-core constructs'
# rolled loop over field pairs, the 13th field after it; fori0's loop
# runs 0 times here)
TAKEN = {"branch": 0.5, "branch_f": 0.0, "fdiv": 0.0}
LOOP_TRIPS = {"fori0": (0,), **{m: (FIELDS // 2,) for m in MMA}}

_W = (1, WINDOWS, ROWS, LANES)
_SEL128, _SEL13, _SEL48 = (LANES, LANES), (FIELDS * LANES, LANES), (
    FIELDS * 48, LANES)
# name -> ((x shape, dtype), (t shape, dtype) or None)
SPEC = {
    **{k: (((ROWS, LANES), I32), None)
       for k in ("math", "branch", "branch_f", "branch_div", "fori0")},
    "relayout": (((1, WINDOWS, ROWS), I32), None),
    "dynload": (((WINDOWS * ROWS, LANES), I32), None),
    "gather_l2": (((ROWS, LANES), I32), ((GATHER_WORDS,), I32)),
    "smem": (((ROWS, WINDOWS), I32), None),
    "colbcast13": ((_W, I32), None), "lanegather13": ((_W, I32), None),
    "mxubcast": ((_W, F32), (_SEL128, F32)),
    "mxubcast13": ((_W, F32), (_SEL128, F32)),
    "mxu13diff": ((_W, F32), (_SEL13, F32)),
    "mxu13hi": ((_W, F32), (_SEL13, F32)),
    "mxu48hi": ((_W, F32), (_SEL48, F32)),
    "mxu13cvt": ((_W, F32), (_SEL48, F32)),
    "branchy_mxu": ((_W, F32), (_SEL48, F32)),
    "branchy_ld": ((_W, F32), None),
    "fdiv": (((ROWS, LANES), F32), ((ROWS, LANES), F32)),
    "fmulrcp": (((ROWS, LANES), F32), ((ROWS, LANES), F32)),
}


def selectors(k: int, fields: int = FIELDS) -> np.ndarray:
    """The TPU probes' one-hot selector stack: block f (k rows) picks
    field f (`s[f * k + f, :] = 1`)."""
    s = np.zeros((fields * k, LANES), np.float32)
    for f in range(fields):
        s[f * k + f % k, :] = 1.0
    return s


def visit_inputs(seed: int = 0) -> dict:
    """name -> (x, t, arg): the inputs of the TPU probe's mains (ones,
    `arange % 97`, uniform [0, 1) windows, x 100 for the i32-converting
    bodies; `np.random.rand` there, a seeded generator here), the
    selectors they build, and the Hopper-only constructs' inputs."""
    rng = np.random.default_rng(seed)
    ones = np.ones((ROWS, LANES), np.int32)
    rand = rng.random(_W).astype(np.float32)
    rand100 = (rng.random(_W) * 100).astype(np.float32)
    eye = np.eye(LANES, dtype=np.float32)
    s13, s48 = selectors(LANES), selectors(48)
    gather = rng.integers(-(1 << 31), 1 << 31, GATHER_WORDS, dtype=np.int64)
    fx = (1 + rng.random((ROWS, LANES))).astype(np.float32)
    div = (1 + rng.random((ROWS, LANES)) * 2.0 ** -20).astype(np.float32)
    return {
        **{k: (ones, None, 0)
           for k in ("math", "branch", "branch_f", "branch_div", "fori0")},
        "relayout": (np.ones((1, WINDOWS, ROWS), np.int32), None, 0),
        "dynload": (np.ones((WINDOWS * ROWS, LANES), np.int32), None, 0),
        "gather_l2": (np.arange(ROWS * LANES, dtype=np.int32).reshape(
            ROWS, LANES), gather.astype(np.int32), 0),
        "smem": (np.ones((ROWS, WINDOWS), np.int32), None, 0),
        "colbcast13": (np.ones(_W, np.int32), None, 0),
        "lanegather13": (
            (np.arange(np.prod(_W)).reshape(_W) % 97).astype(np.int32),
            None, 0),
        "mxubcast": (rand, eye, 0), "mxubcast13": (rand, eye, 0),
        "mxu13diff": (rand, s13, 0), "mxu13hi": (rand, s13, 0),
        "mxu48hi": (rand, s48, 0), "mxu13cvt": (rand100, s48, 0),
        "branchy_mxu": (rand100, s48, 0), "branchy_ld": (rand100, None, 0),
        "fdiv": (fx, div, 0),
        "fmulrcp": (fx, (np.float32(1) / div).astype(np.float32), 0),
    }


def vote_inputs(lane: int = 40) -> tuple[np.ndarray, np.ndarray]:
    """branchy_mxu's (x, t) on which its vote group shows: field 0's
    selector picks column 1 of w for `lane` and column 0 for every other
    lane, and w is -5 but for column 1 of row 0 (3), so field 0's test
    (v0 + i > -1 at i = 0) holds at (row 0, `lane`) alone; fields 1-12
    are the probe's selectors.  At n = 1 a warp's vote takes the branch
    for every element it holds."""
    x = np.full(_W, -5.0, np.float32)
    x[0, :, 0, 1] = 3.0
    t = selectors(48)
    t[0] = 1.0
    t[0, lane] = 0.0
    t[1, lane] = 1.0
    return x, t


def exact_inputs(seed: int = 0) -> dict:
    """P2 / P3's inputs: name -> w (8, 128) f32; `main6`'s `f32`
    (normals x 1e3) and `i24` (integers below 2^24), from
    default_rng(seed) as there, and the `control`: rows 0-3 f32 with at
    most 11 significant bits, rows 4-7 nonzero integers below 2^11 in
    magnitude, all exact in TF32."""
    rng = np.random.default_rng(seed)
    wf = (rng.standard_normal((ROWS, LANES)) * 1e3).astype(np.float32)
    wi = rng.integers(-(1 << 24), 1 << 24, (ROWS, LANES)).astype(np.float32)
    c = np.random.default_rng(seed + 1)
    wc = (c.standard_normal((ROWS, LANES)) * 1e3).astype(np.float32)
    wc = (wc.view(np.int32) & np.int32(-8192)).view(np.float32)
    ints = c.integers(1, 1 << 11, (4, LANES)) * c.choice([-1, 1], (4, LANES))
    wc[4:] = ints.astype(np.float32)
    return {"f32": wf, "i24": wi, "control": wc}


def exact_selectors() -> np.ndarray:
    """`main6`'s s: 8 (128, 128) one-hot blocks, block f picking field f."""
    return selectors(LANES, ROWS)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 values: 10 explicit mantissa bits,
    rounded to nearest, ties away from zero (the low 13 bits cleared)."""
    b = x.contiguous().view(I32)
    return ((b + 0x1000) & -0x2000).view(F32)


def _check(name, x, t):
    if name not in SPEC:
        raise ValueError(f"probe_visit: no construct {name!r}")
    (xs, xd), tspec = SPEC[name]
    for what, v, spec in (("x", x, (xs, xd)), ("t", t, tspec)):
        if spec is None:
            if v is not None:
                raise ValueError(f"probe_visit {name}: takes no {what}")
            continue
        if not isinstance(v, torch.Tensor) or v.dtype != spec[1] \
                or tuple(v.shape) != spec[0]:
            raise ValueError(
                f"probe_visit {name}: {what} must be {spec[1]} {spec[0]}, got "
                f"{getattr(v, 'dtype', None)} {tuple(getattr(v, 'shape', ()))}")
        if not v.is_contiguous() or v.device != x.device:
            raise ValueError(f"probe_visit {name}: {what} must be contiguous "
                             f"and on x's device")


def copies_of(name: str, blocks: int, threads: int) -> int:
    per = MMA_COPY_THREADS if name in MMA else 1024
    most = MMA_THREADS if name in MMA else 1024
    total = blocks * threads
    if threads % 32 or not 32 <= threads <= most or total % per:
        raise ValueError(f"probe_visit {name}: {blocks} x {threads} threads "
                         f"is not a multiple of {per} threads in blocks of "
                         f"32 to {most}")
    return total // per


def _lib(name="probe_visit"):
    from doomtpu_torch.ops.build import load_library

    lib = load_library(name)
    if lib.probe_visit_names().decode().split(",") != list(CONSTRUCTS):
        raise RuntimeError("csrc/probe_visit.cu's constructs differ from "
                           "ops/probe_visit.py's CONSTRUCTS")
    return lib


def _raise(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.probe_visit_error_string(err).decode()})")


def _p(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def construct(name: str, x, t=None, n: int = N, arg: int = 0,
              blocks: int = 1, threads: int = 1024,
              w_from_smem: bool = False) -> torch.Tensor:
    """Construct `name` n times on blocks x threads threads: [copies, 8,
    128] i32.  CUDA tensors launch csrc/probe_visit.cu; CPU tensors run
    `construct_reference`.  w_from_smem (W_FROM_SMEM constructs, blocks a
    multiple of 4): the kernel form that reads w's fragments from shared
    memory for every product instead of holding them in registers (the
    same output)."""
    _check(name, x, t)
    copies = copies_of(name, blocks, threads)
    if n < 0:
        raise ValueError("probe_visit: n < 0")
    if w_from_smem and (name not in W_FROM_SMEM or blocks % 4):
        raise ValueError(f"probe_visit {name}: w_from_smem needs one of "
                         f"{W_FROM_SMEM} on a multiple of 4 blocks")
    if x.device.type == "cpu":
        return construct_reference(name, x, t, n, arg, copies)
    if x.device.type != "cuda":
        raise ValueError(f"probe_visit: no kernel for device {x.device}")
    if name in MMA and x.data_ptr() % 16:
        raise ValueError(f"probe_visit {name}: x must be 16-byte aligned "
                         f"(the kernel reads it 16 bytes at a time)")
    lib = _lib()
    out = torch.empty((copies, ROWS, LANES), dtype=I32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise(lib, lib.probe_visit(CONSTRUCTS.index(name), blocks, threads,
                                _p(x), _p(t), n, arg, int(w_from_smem),
                                _p(out), ctypes.c_void_p(stream)),
           f"probe {name}")
    construct.launches += 1
    return out


construct.launches = 0


def _warp_any(cond: torch.Tensor, mma: bool) -> torch.Tensor:
    """A warp's vote over an (8, 128) condition: a warp holds 32 lanes of
    one row (32 lanes of all 8 rows for the tensor-core constructs)."""
    if mma:
        v = cond.reshape(ROWS, LANES // 32, 32).any(2).any(0)
        return v.repeat_interleave(32)[None].expand(ROWS, LANES)
    v = cond.reshape(ROWS, LANES // 32, 32).any(2)
    return v.repeat_interleave(32, 1)


def _dot(w, sel, one_pass: bool, rounded: bool):
    """(8, K) x (K, 128) with exact products summed exactly and rounded
    once to f32 (the kernel's result where an output has at most one
    nonzero product); TF32 operands for a rounded one-pass product."""
    if one_pass and rounded:
        w, sel = tf32(w), tf32(sel)
    return (w.double() @ sel.double()).float()


def construct_reference(name: str, x, t=None, n: int = N, arg: int = 0,
                        copies: int = 1, tf32_products: bool = True):
    """Plain PyTorch construct `name`, stepping one iteration at a time:
    the kernel's [copies, 8, 128] output.  tf32_products=False gives the
    one-pass tensor-core constructs exact f32 products (as the TPU
    kernel's f32 dot computes them on the CPU)."""
    _check(name, x, t)
    dev = x.device
    lane = torch.arange(LANES, device=dev)
    mma = name in MMA
    if name == "math":
        acc = x.clone()
        for _ in range(n):
            for _ in range(32):
                acc = (acc * 3) ^ (acc >> 1)
    elif name in ("branch", "branch_f", "branch_div"):
        acc = x.clone()
        for i in range(n):
            if name == "branch":
                take = _warp_any((x + i) & 1 != 0, False)
            elif name == "branch_f":
                take = _warp_any(x + i < -5, False)
            else:
                take = (x + i + lane) & 1 != 0
            acc = acc + take.to(I32)
    elif name == "fori0":
        acc = torch.full((ROWS, LANES), n * max(arg, 0), dtype=I32,
                         device=dev)
    elif name == "gather_l2":
        # copy c's chains start at x + 1024 c
        start = torch.arange(copies, device=dev)[:, None, None] * 1024
        u = (x.long() + start) & 0xFFFFFFFF
        for i in range(n):
            h = (u * 0x61C88647 + i) & 0xFFFFFFFF
            u = (u + (t[h >> 12].long() & 0xFFFFFFFF)) & 0xFFFFFFFF
        return (u - ((u >> 31) << 32)).to(I32)
    elif name in ("fdiv", "fmulrcp"):
        a = x.clone()
        for _ in range(n * CHAIN):
            a = a / t if name == "fdiv" else a * t
        acc = a.view(I32)
    elif name in ("mxu13cvt", "branchy_mxu", "branchy_ld"):
        acc = torch.zeros((ROWS, LANES), dtype=I32, device=dev)
        for i in range(n):
            w = x[0, i & (WINDOWS - 1)]
            if name == "branchy_ld":
                v = [w[:, f:f + 1].to(I32).expand(ROWS, LANES)
                     for f in range(FIELDS)]
            else:
                v = [_dot(w[:, :48], t[f * 48:(f + 1) * 48], False,
                          False).to(I32) for f in range(FIELDS)]
            if name == "mxu13cvt":
                for f in range(FIELDS):
                    acc = acc + v[f]
                continue
            tot = v[1] + v[2]
            for f in range(3, FIELDS):
                tot = tot + v[f]
            live = _warp_any(v[0] + i > -1, mma)
            acc = acc + torch.where(live, tot, 0)
    elif mma:
        one_pass = name in TF32_ONE_PASS
        fa = torch.zeros((ROWS, LANES), dtype=F32, device=dev)
        k = 48 if name == "mxu48hi" else LANES
        for i in range(n):
            w = x[0, i & (WINDOWS - 1)][:, :k]
            for f in range(FIELDS):
                if name in ("mxubcast", "mxubcast13"):
                    a, sel = (w + f if name == "mxubcast13" else w), t
                else:
                    a, sel = w, t[f * k:(f + 1) * k]
                fa = fa + _dot(a, sel, one_pass, tf32_products)
        acc = fa.to(I32)
    else:
        acc = torch.zeros((ROWS, LANES), dtype=I32, device=dev)
        for i in range(n):
            if name == "relayout":
                v = x[0, i & (WINDOWS - 1), :, None]
            elif name == "dynload":
                r = ((i * 37) & (WINDOWS - 1)) * ROWS
                v = x[r:r + ROWS]
            elif name == "smem":
                v = x[:, i & (WINDOWS - 1), None]
            else:    # colbcast13, lanegather13
                v = x[0, i & (WINDOWS - 1), :, :FIELDS].sum(
                    1, keepdim=True).to(I32)
            acc = acc + v
    return acc.to(I32)[None].expand(copies, ROWS, LANES)


def broadcast(w) -> torch.Tensor:
    """The exact broadcast `main6` / `main7` hold their output to: rows
    8f..8f+7 are field f of w, as bits, over all lanes (64, 128) i32."""
    bits = w.contiguous().view(I32)[:, :ROWS]              # [s, f]
    return bits.t().reshape(ROWS * ROWS, 1).expand(ROWS * ROWS, LANES)


def _check_exact(w, s, copies, stored):
    # one expression: the host's cost of a call is most of P2 / P3's time
    # at one copy
    if not (isinstance(w, torch.Tensor) and isinstance(s, torch.Tensor)
            and w.dtype == F32 and s.dtype == F32
            and w.shape == (ROWS, LANES) and s.shape == (ROWS * LANES, LANES)
            and w.is_contiguous() and s.is_contiguous()
            and w.device == s.device):
        raise ValueError(f"probe_exact: w and s must be contiguous f32 "
                         f"{(ROWS, LANES)} and {(ROWS * LANES, LANES)} on "
                         f"one device")
    if type(copies) is not int or copies < 1:
        raise ValueError(f"probe_exact: copies must be an int >= 1, got "
                         f"{copies!r}")
    if type(stored) is not int or not 1 <= stored <= copies:
        raise ValueError(f"probe_exact: stored must be an int in [1, "
                         f"copies={copies}], got {stored!r}")


def _exact_reference(w, s, passes, copies, stored):
    stored = copies if stored is None else stored
    _check_exact(w, s, copies, stored)
    sel = s.reshape(ROWS, LANES, LANES)
    out = torch.stack([_dot(w, sel[f], passes == 1, True)
                       for f in range(ROWS)])               # [f, s, l]
    one = out.reshape(ROWS * ROWS, LANES).view(I32)
    return one if copies == 1 else one.repeat(stored, 1, 1)


def exact1_reference(w, s, copies: int = 1,
                     stored: int | None = None) -> torch.Tensor:
    """P2's plain version: each product of TF32 operands (cvt.rna) with
    exact products and one rounding, as bits [64, 128] i32; copies > 1:
    [stored, 64, 128] (stored defaults to copies), every slice the same,
    each its own memory."""
    return _exact_reference(w, s, 1, copies, stored)


def exact3_reference(w, s, copies: int = 1,
                     stored: int | None = None) -> torch.Tensor:
    """P3's plain version: the exact f32 products, as bits (shapes as
    exact1_reference's)."""
    return _exact_reference(w, s, 3, copies, stored)


def _exact(w, s, passes, copies, stored):
    stored = copies if stored is None else stored
    _check_exact(w, s, copies, stored)
    dev = w.device
    if dev.type == "cpu":
        return _exact_reference(w, s, passes, copies, stored)
    if dev.type != "cuda":
        raise ValueError(f"probe_exact: no kernel for device {dev}")
    wp, sp = w.data_ptr(), s.data_ptr()
    if (wp | sp) % 16:
        raise ValueError("probe_exact: w and s must be 16-byte aligned "
                         "(the kernel reads them 16 bytes at a time)")
    out = torch.empty((ROWS * ROWS, LANES) if copies == 1
                      else (stored, ROWS * ROWS, LANES),
                      dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().probe_exact(passes, wp, sp, out.data_ptr(), copies, stored,
                             stream)
    if err:
        _raise(_lib(), err, "probe_exact")
    (exact1 if passes == 1 else exact3).launches += 1
    return out


def exact1(w, s, copies: int = 1, stored: int | None = None) -> torch.Tensor:
    """P2: the one-pass TF32 one-hot products on the tensor cores
    (csrc/probe_visit.cu) for CUDA tensors, `exact1_reference` on CPU:
    (64, 128) i32; copies > 1: the 8 products run `copies` times, the
    first `stored` (default all) written, [stored, 64, 128]."""
    return _exact(w, s, 1, copies, stored)


def exact3(w, s, copies: int = 1, stored: int | None = None) -> torch.Tensor:
    """P3: the three-piece products summed in one tensor-core accumulator
    for CUDA tensors; `exact3_reference` (the exact products) on CPU;
    shapes as exact1's."""
    return _exact(w, s, 3, copies, stored)


exact1.launches = 0
exact3.launches = 0


# ---- the bound: the operations each construct needs -------------------
# warp instructions an SM completes a clock, by class: the CUDA C++
# Programming Guide's arithmetic throughputs for compute capability 9.0
# (operations a clock an SM over 32 lanes), one instruction a clock from
# each of the 4 schedulers, 32 lanes of loads or stores (128 B of L1 or
# shared memory), and for "tensor" one m16n8k8 TF32 product's worth
# (1024 FMA) a clock, the H100's dense TF32 rate.  Conversions: the
# guide gives 16 lanes, but branchy_ld's 13 F2I a warp ran at 0.514 a
# clock at one block on an H100 80GB HBM3, so the bound takes 32.
RATES = {"issue": 4.0, "fp32": 4.0, "imad": 2.0, "alu": 2.0, "sfu": 0.5,
         "conv": 1.0, "shfl": 1.0, "lsu": 1.0, "tensor": 1.0}


def _mma_needs(name: str) -> dict:
    """A tensor-core construct's needs for one 8 x 8 output tile (32 of
    them an SM at 2 copies an SM): of each of the 13 products, P passes
    of K/8 k-steps, each 512 useful FMAs, then the sum of the 13 results
    (f32 adds, or a conversion and an integer add each); the operands'
    loads and TF32 rounding are not counted."""
    k = 48 if name in ("mxu48hi", "mxu13cvt", "branchy_mxu") else LANES
    passes = 1 if name in TF32_ONE_PASS else 3
    need = {"tensor": FIELDS * passes * (k // 8) * 512 / 1024}
    if name in ("mxu13cvt", "branchy_mxu"):
        need.update(conv=2 * FIELDS, alu=FIELDS)
    else:
        need.update(fp32=2 * FIELDS)
    if name == "branchy_mxu":     # field 0's test and the vote
        need["alu"] += 2
        need["other"] = 2
    return need


# warp instructions a warp needs an iteration, by class: the construct's
# own loads, arithmetic, shuffles, votes and branches as the plain
# version states them, no more: not the probe's loop control or address
# arithmetic (unrolling and strength reduction remove them), loads of
# one broadcast row as 16-byte vectors, sums of n terms as n / 2
# three-input adds; "other" takes an issue slot only (branch, vote,
# barrier, FCHK).  A conditional body counts its taken share.
NEEDS = {
    "math": {"imad": 32, "alu": 64},           # 32 x (*3, >>, ^)
    "branch": {"alu": 2 + 0.5, "lsu": 0.5 * 2, "other": 2},
    "branch_f": {"alu": 2, "other": 2},
    "branch_div": {"alu": 3, "lsu": 2, "other": 1},   # body every warp
    "relayout": {"lsu": 1, "alu": 1},
    "dynload": {"lsu": 1, "alu": 1},
    "gather_l2": {"imad": 1, "alu": 2, "lsu": 1},
    "smem": {"lsu": 8, "alu": 8},              # 8 reads, 7 selects, add
    "fori0": {"alu": 2, "other": 1},           # bound, test, branch
    "colbcast13": {"lsu": 2 + 4, "alu": 7, "other": 1},
    "lanegather13": {"lsu": 1, "shfl": FIELDS, "alu": 7},
    "branchy_ld": {"lsu": 4, "conv": FIELDS, "alu": 2 + 6, "other": 2},
    # an IEEE divide: MUFU.RCP, 5 FFMA, FCHK and its branch
    "fdiv": {"sfu": CHAIN, "fp32": 5 * CHAIN, "other": 2 * CHAIN},
    "fmulrcp": {"fp32": CHAIN},
    **{m: _mma_needs(m) for m in MMA},
}


def needs_bound(name: str, warps_per_sm: int = 32) -> tuple[float, str]:
    """(clocks an iteration on one SM, the class that sets it) for
    construct `name`'s NEEDS at warps_per_sm warps: the larger of all
    its instructions over the issue rate (a tensor unit one m16n8k8)
    and each class over its rate."""
    need = NEEDS[name]
    clocks = {"issue": sum(need.values()) / RATES["issue"]}
    for cls, v in need.items():
        if cls != "other":
            clocks[cls] = v / RATES[cls]
    cls = max(clocks, key=clocks.get)
    return clocks[cls] * warps_per_sm, cls


# ---- a diagnostic: the loop's SASS instructions by class --------------
CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSET", "FSEL",
             "FSWZADD", "FCHK"},
    # integer multiply-adds issue to the FMA pipe, the rest to the ALU
    "imad": {"IMAD", "IMUL"},
    "alu": {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP",
            "IMNMX", "LEA", "IABS", "SEL", "PRMT", "POPC", "FLO", "BMSK",
            "BREV", "VIADD", "VIMNMX", "IADD32I"},
    "sfu": {"MUFU"},
    "conv": {"F2I", "I2F", "F2F", "FRND", "I2FP", "F2IP", "F2FP"},
    "shfl": {"SHFL"},
    "lsu": {"LDS", "STS", "LDG", "STG", "LD", "ST", "LDL", "STL", "ATOMS",
            "ATOM", "RED", "LDSM"},
    "tensor": {"HMMA"},
}
_CLASS_OF = {op: c for c, ops in CLASSES.items() for op in ops}
_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a branch target: nvdisasm's label, or cuobjdump's address
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)\s*$")


def sass_loops(text: str) -> dict[str, Counter]:
    """Per function of `cuobjdump -sass` (or nvdisasm) output with a loop:
    the instructions of its outermost loop (the backward branch that
    spans the most code), counted by (depth, conditional, class): depth
    the number of inner loops around the instruction, conditional
    whether a forward conditional branch inside the loop skips it."""
    funcs: dict[str, list] = {}
    cur = None
    pending: list[str] = []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [[], {}])
            pending = []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                cur[1][lab] = addr
            pending = []
            tgt = _TARGET.search(m.group(4)) if m.group(3).startswith(
                "BRA") else None
            if tgt is not None:
                tgt = tgt.group(1) or int(tgt.group(2), 16)
            cur[0].append((addr, m.group(3), bool(m.group(2)), tgt))
    out = {}
    for name, (instrs, labels) in funcs.items():
        branches = [(a, labels.get(t, t), pred) for a, op, pred, t in instrs
                    if isinstance(labels.get(t, t), int)]
        back = [(tgt, a) for a, tgt, _ in branches if tgt <= a]
        if not back:
            continue
        lo, hi = max(back, key=lambda r: r[1] - r[0])
        inner = [(b, e) for b, e in back
                 if (b, e) != (lo, hi) and lo <= b and e <= hi]
        skipped = [(a, tgt) for a, tgt, pred in branches
                   if pred and lo <= a < tgt <= hi + 16]
        c = Counter()
        for addr, op, _, _ in instrs:
            if not lo <= addr <= hi:
                continue
            depth = sum(b <= addr <= e for b, e in inner)
            cond = any(a < addr < tgt for a, tgt in skipped)
            c[depth, cond, _CLASS_OF.get(op.split(".")[0], "other")] += 1
        out[name] = c
    return out


def sass_bound(counts: Counter, taken: float = 1.0, trips: tuple = (),
               warps_per_sm: int = 32) -> tuple[float, str]:
    """(clocks an iteration on one SM, the class that sets it): the
    larger of every instruction over the issue rate and each class over
    its pipe's rate; an instruction inside d inner loops counts the
    product of their first d `trips`, one under a conditional branch
    `taken` times."""
    per = Counter()
    for (depth, cond, cls), v in counts.items():
        if depth > len(trips):
            raise ValueError(f"a loop {depth} deep, trips {trips} given")
        w = math.prod(trips[:depth]) * (taken if cond else 1.0)
        per[cls] += v * w
    clocks = {"issue": sum(per.values()) / RATES["issue"]}
    for cls, rate in RATES.items():
        if cls != "issue" and per[cls]:
            clocks[cls] = per[cls] / rate
    cls = max(clocks, key=clocks.get)
    return clocks[cls] * warps_per_sm, cls


def construct_of(fn: str) -> str | None:
    """The construct whose priced loop the SASS function `fn` (a mangled
    name) holds: `visit_kernel<C>`, or the occupancy shape's
    `mma_kernel<C, true, 0>` for a tensor-core construct; else None."""
    m = re.search(r"(visit|mma)_kernelI((?:L[ib]\d+E)+)E", fn)
    if m is None:
        return None
    args = [int(v) for v in re.findall(r"L[ib](\d+)E", m.group(2))]
    if m.group(1) == "visit" or args[1:] == [1, 0]:
        return CONSTRUCTS[args[0]]
    return None


def construct_sass(sass_text: str) -> dict[str, tuple[float, str, dict]]:
    """name -> (clocks an iteration an SM at 2 copies an SM, class, the
    loop's instruction counts) for every construct of the built library
    (`visit_kernel<C>`; for the tensor-core constructs the occupancy
    shape's `mma_kernel<C, true, 0>`, 8 warps an SM): what the compiler
    emitted, beside NEEDS's bound (a worse loop counts more, so it is no
    bound)."""
    loops = sass_loops(sass_text)
    got = {}
    for fn, counts in loops.items():
        name = construct_of(fn)
        if name is not None:
            clocks, cls = sass_bound(
                counts, TAKEN.get(name, 1.0), LOOP_TRIPS.get(name, ()),
                MMA_WARPS_PER_SM if name in MMA else 32)
            got[name] = (clocks, cls, {
                f"{d}{'c' if c else ''}:{k}": v
                for (d, c, k), v in sorted(counts.items())})
    missing = set(CONSTRUCTS) - set(got)
    if missing:
        raise RuntimeError(f"no loop found in the SASS of {sorted(missing)}")
    return got


# ---- on the card ---------------------------------------------------
def _smi(query: str, units: bool = False) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def configs(dev, name: str | None = None) -> dict[str, tuple[int, int]]:
    """The two launch shapes of construct `name`, each 2 copies an SM:
    one block (of 1024 threads; 256 for the tensor-core constructs), and
    K1's occupancy, 4 blocks of 256 threads on every SM (one block of 256
    threads on every SM for the tensor-core constructs, whose blocks each
    take one 32-lane group of 8 copies)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if name in MMA:
        return {"one block": (1, MMA_THREADS),
                "K1 occupancy": (sms, MMA_THREADS)}
    return {"one block": (1, 1024), "K1 occupancy": (4 * sms, 256)}


def device_inputs(dev, seed: int = 0) -> dict:
    return {k: (torch.from_numpy(x).to(dev),
                None if t is None else torch.from_numpy(t).to(dev), arg)
            for k, (x, t, arg) in visit_inputs(seed).items()}


def _events_ms(fn, reps):
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# a launch at least this long is timed once (its events' resolution is
# far below it); shorter ones `reps` times
ONCE_MS = 500.0


def measure(dev, n: int = N, reps: int = 3, card: str = "",
            log=print) -> dict:
    """P1 on the card: every construct at both launch shapes, n
    iterations, after a warm launch at CHECK_N iterations: one launch
    timed with CUDA events, and if it took under ONCE_MS, the mean of
    `reps` more; beside its bound (NEEDS) and, as a diagnostic, the
    count of its loop's SASS, both at the card's maximum SM clock.
    Returns name -> {"ms": {config: ms}, "ns_per_iter": {...},
    "bound_ns": ns, "bound_by": class, "sass_ns": ns, "sass_by": class,
    "sass": counts}."""
    from doomtpu_torch.ops.build import sass

    emitted = construct_sass(sass("probe_visit"))
    mhz = float(_smi("clocks.max.sm"))
    inputs = device_inputs(dev)
    log(f"P1 per-construct cost: N={n}, after a warm launch at N={CHECK_N} "
        f"one timed launch, then the mean of {reps} if it took under "
        f"{ONCE_MS:.0f} ms; shapes {configs(dev)} (the tensor-core "
        f"constructs {configs(dev, 'mxubcast')}); bound (the operations "
        f"needed) and SASS count at {mhz:.0f} MHz (clocks.max.sm)  "
        f"[{card}]")
    res = {}
    for name in CONSTRUCTS:
        x, t, arg = inputs[name]
        clocks, cls = needs_bound(name)
        sass_clocks, sass_cls, counts = emitted[name]
        r = {"ms": {}, "ns_per_iter": {}, "bound_ns": clocks / mhz * 1e3,
             "bound_by": cls, "sass_ns": sass_clocks / mhz * 1e3,
             "sass_by": sass_cls, "sass": counts}
        shapes = configs(dev, name)
        for cfg, (blocks, threads) in shapes.items():
            call = lambda: construct(name, x, t, n, arg, blocks, threads)
            construct(name, x, t, CHECK_N, arg, blocks, threads)
            torch.cuda.synchronize()
            ms = _events_ms(call, 1)
            if ms < ONCE_MS:
                ms = _events_ms(call, reps)
            r["ms"][cfg] = ms
            r["ns_per_iter"][cfg] = ms * 1e6 / n
        log(f"{name:13s} " + "  ".join(
            f"{cfg}: {r['ms'][cfg] * 1e3:10.1f} us total "
            f"{r['ns_per_iter'][cfg]:9.2f} ns/iter" for cfg in shapes)
            + f"  bound {r['bound_ns']:8.2f} ns/iter ({cls}), SASS "
            f"{r['sass_ns']:8.2f} ({sass_cls})  [{card}]")
        res[name] = r
    return res


def exactness(dev, card: str = "", log=print) -> dict:
    """P2 and P3 on the card: per input, the elements that differ from
    the exact broadcast (`bad`, main6 / main7's answer) and from each
    kernel's plain version."""
    s = torch.from_numpy(exact_selectors()).to(dev)
    res = {}
    for name, w_np in exact_inputs().items():
        w = torch.from_numpy(w_np).to(dev)
        ref = broadcast(w)
        for label, fn, plain in (("mxuexact", exact1, exact1_reference),
                                 ("mxuexact-hi", exact3, exact3_reference)):
            out = fn(w, s)
            bad = int((out != ref).sum())
            off = int((out != plain(w, s)).sum())
            res[(label, name)] = {"bad": bad, "vs_plain": off}
            log(f"{label} {name}: exact={bad == 0} bad={bad} "
                f"(differing from the plain version: {off})  [{card}]")
    return res


def field_bounds_ns(passes: int, copies: int, sms: int, mhz: float,
                    stored: int | None = None) -> dict:
    """P2 / P3's least ns a field product an SM at `copies`: the TF32
    FMAs of one (8, 128) x (128, 128) product (per pass) at
    TF32_FMA_PER_CLOCK, and its share of the bytes (w, S read once, the
    `stored` output slices, default all, written once) at the HBM rate,
    over the card's `sms`."""
    fields = copies * ROWS
    stored = copies if stored is None else stored
    moved = 4 * (ROWS * LANES + ROWS * LANES * LANES
                 + stored * ROWS * ROWS * LANES)
    return {"fma": passes * ROWS * LANES * LANES / TF32_FMA_PER_CLOCK
            / mhz * 1e3,
            "bytes": moved / HBM_BYTES_PER_S * 1e9 * sms / fields}


def p1_field_ns(p1: dict, dev) -> dict:
    """P1's tensor-core broadcasts, mxubcast (one pass) and mxu13hi (three
    pieces), as ns a field product an SM: their ns an iteration at K1's
    occupancy (`measure`) over the products an iteration holds (13 a
    copy), times the card's SMs."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {name: p1[name]["ns_per_iter"]["K1 occupancy"] * sms
            / (copies_of(name, *configs(dev, name)["K1 occupancy"]) * FIELDS)
            for name in ("mxubcast", "mxu13hi")}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_visit: no CUDA device visible; the probes run on the "
              "card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = _smi("name,power.limit", units=True)
    measure(dev, card=card)
    exactness(dev, card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
