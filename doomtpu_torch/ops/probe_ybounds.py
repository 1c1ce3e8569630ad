"""Hopper probe P4: the price of per-camera row bounds.

Counterpart of scripts/probe_percam_ybounds.py (the kernel of
`make_kernel(mode)`).  `ybounds` launches the hand-written CUDA kernel
(csrc/probe_ybounds.cu) on CUDA tensors and runs `ybounds_reference`,
its plain PyTorch version, on CPU tensors; anything else raises.

Input: S emissions' row bounds lo, hi [S, 8, 128] i32 (8 cameras, 128
lanes).  Output: counts [8, 200, 128] i32, zero-initialised (the TPU
kernel leaves its output uninitialised and adds to it):

- `empty`: camera 0's rows 0-7 sum the emissions' lo rows;
- `union`: each emission adds 1 to every camera's rows in the 8-row
  blocks from the union of all cameras' bounds, max(min lo, 0) // 8 up
  to min(max hi, 199) // 8;
- `percam`, `percamS`, `percamR`: the same with each camera's own bounds
  (three mechanisms, one output);
- `band` (Hopper only, K1's mechanism): 1 on each lane's rows lo..hi.

The kernel splits the emissions over `chunks` runs of blocks, whose
partial counts it sums (integers, so any chunk count gives the same
output): chunks = 1 walks all S in order in 32 blocks, the latency of a
mechanism inside a serial loop; the default, `full_chunks`, keeps every
SM as many blocks deep as fit.

    python -m doomtpu_torch.ops.probe_ybounds

prints, on the card, each mode's microseconds an emission at S = 4096,
serial and at the full-card chunking, and the deltas against `union`,
as the JAX script prints them.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

I32 = torch.int32
TB, H, LANES = 8, 200, 128
S = 4096              # the TPU probe's emissions
CHECK_S = 64          # emissions where the plain version is compared
# the order of csrc/probe_ybounds.cu's Mode enum
MODES = ("empty", "union", "percam", "percamS", "percamR", "band")


def ybounds_inputs(s: int = S, seed: int = 0):
    """`probe_percam_ybounds.main`'s census-like ranges: each camera a
    base row in [0, 176), the lanes 8-23 rows tall, hi clipped to 199."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, H - 24, size=(s, TB, 1))
    lo = np.broadcast_to(base, (s, TB, LANES)).astype(np.int32).copy()
    hi = (lo + rng.integers(8, 24, size=(s, TB, LANES))).astype(np.int32)
    return lo, np.minimum(hi, H - 1)


def _check(lo, hi, mode):
    if mode not in MODES:
        raise ValueError(f"probe_ybounds: no mode {mode!r}")
    for what, v in (("lo", lo), ("hi", hi)):
        if v.dtype != I32 or v.dim() != 3 or tuple(v.shape[1:]) != (
                TB, LANES) or v.shape[0] != lo.shape[0]:
            raise ValueError(f"probe_ybounds: {what} must be i32 [S, {TB}, "
                             f"{LANES}], got {v.dtype} {tuple(v.shape)}")
        if not v.is_contiguous() or v.device != lo.device:
            raise ValueError(f"probe_ybounds: {what} must be contiguous and "
                             f"on lo's device")


MAX_CHUNKS = 65535    # the grid's y extent


def _chunks_ok(chunks):
    if type(chunks) is not int or not 1 <= chunks <= MAX_CHUNKS:
        raise ValueError(f"probe_ybounds: chunks must be an int in [1, "
                         f"{MAX_CHUNKS}], got {chunks!r}")


def _lib():
    from doomtpu_torch.ops.build import load_library

    lib = load_library("probe_ybounds")
    if lib.probe_ybounds_names().decode().split(",") != list(MODES):
        raise RuntimeError("csrc/probe_ybounds.cu's modes differ from "
                           "ops/probe_ybounds.py's MODES")
    return lib


def _raise(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.probe_ybounds_error_string(err).decode()})")


def full_chunks(mode: str) -> int:
    """The chunk count that keeps every SM of the current card as many
    blocks of mode `mode` deep as fit (the occupancy calculator's)."""
    if mode not in MODES:
        raise ValueError(f"probe_ybounds: no mode {mode!r}")
    lib = _lib()
    got = ctypes.c_int(0)
    _raise(lib, lib.probe_ybounds_full_chunks(MODES.index(mode),
                                              ctypes.byref(got)),
           "probe_ybounds_full_chunks")
    return got.value


def ybounds(lo, hi, mode: str, chunks: int | None = None) -> torch.Tensor:
    """Mode `mode` over the emissions, split into `chunks` (default: the
    full-card `full_chunks` on the card, 1 on the CPU): [8, 200, 128] i32.
    CUDA tensors launch csrc/probe_ybounds.cu; CPU tensors run
    `ybounds_reference`."""
    _check(lo, hi, mode)
    if chunks is not None:
        _chunks_ok(chunks)
    if lo.device.type == "cpu":
        return ybounds_reference(lo, hi, mode, chunks or 1)
    if lo.device.type != "cuda":
        raise ValueError(f"probe_ybounds: no kernel for device {lo.device}")
    lib = _lib()
    chunks = chunks or full_chunks(mode)
    out = torch.zeros((TB, H, LANES), dtype=I32, device=lo.device)
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = torch.cuda.current_stream(lo.device).cuda_stream
    _raise(lib, lib.probe_ybounds(MODES.index(mode), p(lo), p(hi),
                                  lo.shape[0], chunks, p(out),
                                  ctypes.c_void_p(stream)),
           "probe_ybounds launch")
    ybounds.launches += 1
    return out


ybounds.launches = 0


def _count(a, b):
    """Rows [a, b) (a, b [..., S] int64, clipped to [0, H]) counted over
    the last axis: [..., H] int64, by a difference array."""
    a, b = a.clamp(0, H), b.clamp(0, H)
    live = (a < b).long()
    d = torch.zeros((*a.shape[:-1], H + 1), dtype=torch.int64,
                    device=a.device)
    d.scatter_add_(-1, a, live)
    d.scatter_add_(-1, b, -live)
    return d.cumsum(-1)[..., :H]


def ybounds_reference(lo, hi, mode: str, chunks: int = 1) -> torch.Tensor:
    """Plain PyTorch `ybounds`: each mode's counts with tensor ops, the
    emissions split into `chunks` runs as the kernel splits them (chunk c
    takes [c S // chunks, (c + 1) S // chunks)) and their counts summed."""
    _check(lo, hi, mode)
    _chunks_ok(chunks)
    s = lo.shape[0]
    cuts = [c * s // chunks for c in range(chunks + 1)]
    out = torch.zeros((TB, H, LANES), dtype=torch.int64, device=lo.device)
    for a, b in zip(cuts, cuts[1:]):
        if a < b:
            out += _counts(lo[a:b], hi[a:b], mode)
    return out.to(I32).contiguous()


def _counts(lo, hi, mode: str) -> torch.Tensor:
    """Mode `mode`'s int64 counts [8, 200, 128] over S >= 1 emissions."""
    lo64, hi64 = lo.long(), hi.long()
    out = torch.zeros((TB, H, LANES), dtype=torch.int64, device=lo.device)
    if mode == "empty":
        out[0, :TB] = lo64.sum(0)
    elif mode == "band":
        c = _count(lo64.clamp(min=0).permute(1, 2, 0),
                   hi64.clamp(max=H - 1).permute(1, 2, 0) + 1)
        out = c.permute(0, 2, 1)                       # [TB, H, LANES]
    else:
        if mode == "union":
            ylo, yhi = lo64.amin((1, 2))[None], hi64.amax((1, 2))[None]
        else:
            ylo, yhi = lo64.amin(2).t(), hi64.amax(2).t()  # [TB, S]
        b0 = ylo.clamp(min=0) // 8
        b1 = yhi.clamp(max=H - 1) // 8 + 1
        c = _count(b0 * 8, b1 * 8)                      # [1 or TB, H]
        out = c[:, :, None].expand(TB, H, LANES)
    return out


def measure(dev, s: int = S, reps: int = 8, card: str = "",
            chunks: int | None = None, log=print) -> dict:
    """P4 on the card: each mode over s emissions in `chunks` (default
    the full-card chunking), mean of `reps` launches after a warm one
    (CUDA events).  Returns mode -> {"ms", "us_per_emission",
    "chunks"}; logs the deltas against `union`."""
    lo, hi = (torch.from_numpy(v).to(dev) for v in ybounds_inputs(s))
    res = {}
    for mode in MODES:
        n = chunks or full_chunks(mode)
        ybounds(lo, hi, mode, n)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            out = ybounds(lo, hi, mode, n)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / reps
        res[mode] = {"ms": ms, "us_per_emission": ms * 1e3 / s, "chunks": n}
        log(f"P4 S={s} {mode:8s} {ms * 1e3 / s:8.4f} us/step  (total "
            f"{ms:.4f} ms, 8 x 4 x {n} blocks of 256 threads, "
            f"cs={int(out.sum())})  [{card}]")
    for mode in MODES[2:]:
        d = res[mode]["us_per_emission"] - res["union"]["us_per_emission"]
        log(f"mechanism delta {mode}-union: {d:+.4f} us/emission  [{card}]")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_ybounds: no CUDA device visible; the probe runs on the "
              "card", file=sys.stderr)
        return 2
    from doomtpu_torch.ops.probe_visit import _smi

    card = _smi("name,power.limit", units=True)
    for chunks in (1, None):
        measure(torch.device("cuda", 0), card=card, chunks=chunks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
