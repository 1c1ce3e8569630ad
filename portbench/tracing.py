"""Spans around the port's functions, and the reduction of a profile.

The port records no spans of its own, so a traced run wraps the named
functions in `torch.profiler.record_function` ranges from here (each
metric file names what it wraps: the name its caller looks up at call
time, in the caller's namespace where the caller bound it with
`from ... import`), profiles a few calls, and reduces the profile to
what the metric readers ask of a `Trace`.  Work that depends on the
data (the pixels a kernel writes) is counted apart, by probes around the
port's functions on a pass over the same calls before the profiled one
(`Probes`), so that the probes' own operations stay out of the profile.

The idle share follows the method of the repository's chip smoke test:
the union of the kernel intervals of the profiled calls, per call,
against the ms per call timed without the profiler in the same process
(the profiler's own cost on every launch would count as idle time).
"""

from __future__ import annotations

import functools
import importlib
from bisect import bisect_right

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


class Spans:
    """record_function ranges around the targets of `spans`, {span name:
    [(module, attribute), ...]}, installed inside the `with` block."""

    def __init__(self, spans: dict[str, list[tuple[str, str]]]):
        self.spans = spans
        self._undo = []

    def __enter__(self):
        for name, targets in self.spans.items():
            for module, attr in targets:
                mod = importlib.import_module(module)
                fn = getattr(mod, attr)
                self._undo.append((mod, attr, fn))
                setattr(mod, attr, _ranged(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()


class Probes:
    """Counting wrappers around the targets of `probes`, {count name:
    [(module, attribute, probe), ...]}, installed inside the `with`
    block.  A probe takes the wrapped function and its arguments and
    returns (the function's result, an amount); `totals()` gives each
    count's sum."""

    def __init__(self, probes: dict[str, list[tuple]]):
        self.probes = probes
        self.amounts = {name: [] for name in probes}
        self._undo = []

    def __enter__(self):
        for name, targets in self.probes.items():
            for module, attr, probe in targets:
                mod = importlib.import_module(module)
                fn = getattr(mod, attr)
                self._undo.append((mod, attr, fn))
                setattr(mod, attr, self._counted(name, probe, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)
        self._undo.clear()

    def _counted(self, name: str, probe, fn):
        @functools.wraps(fn)
        def counted(*args, **kw):
            out, amount = probe(fn, *args, **kw)
            self.amounts[name].append(amount)
            return out
        return counted

    def totals(self) -> dict[str, int]:
        return {name: int(sum(int(a) for a in xs))
                for name, xs in self.amounts.items() if xs}


def _ranged(name: str, fn):
    @functools.wraps(fn)
    def ranged(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return ranged


def _is_cuda_call(name: str) -> bool:
    """A CUDA runtime (cudaLaunchKernel, ...) or driver (cuLaunchKernel,
    ...) call, as the profiler names them."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _union(intervals):
    """Disjoint, sorted union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """A profile of `batches` batches (ticks of a rollout, or render
    calls) in `calls` calls, with the ms a call took without the
    profiler (`plain_ms`) and what the layer counts need (`shape`).

    It reads the profiler's raw events (one pass, no event tree): a
    device operation is attributed to the host time at which it was
    launched, found through the profiler's correlation (the launch call
    with the operation's correlation id, else the PyTorch operation it
    is linked to), and a span's device time is that of the operations
    launched inside the span's outermost ranges."""

    def __init__(self, prof, span_names, batches: int, calls: int,
                 plain_ms: float, wall_s: float, shape: dict,
                 counts: dict | None = None):
        from torch.autograd import DeviceType

        self.batches, self.calls = batches, calls
        self.counts = counts or {}
        self.plain_ms, self.wall_s, self.shape = plain_ms, wall_s, shape
        self.span_names = set(span_names)
        cpu, device = [], []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CPU:
                cpu.append(e)
            elif not (e.name() in self.span_names
                      or e.name().startswith("ProfilerStep")
                      or getattr(e, "is_user_annotation", lambda: False)()):
                device.append(e)
        # host intervals (ns): every operation, and each span's ranges
        self.cpu = sorted((e.start_ns(), e.end_ns(), e.name()) for e in cpu)
        self.launches = sum(1 for e in cpu if e.name() in LAUNCH_CALLS)
        self.ranges = {n: _union((a, b) for a, b, name in self.cpu
                                 if name == n) for n in self.span_names}
        # the CUDA runtime's and driver's calls (one id space with the
        # device's operations), and the PyTorch operations and spans
        # (linked to by them)
        launch, ops = {}, {}
        for e in cpu:
            if _is_cuda_call(e.name()):
                launch[e.correlation_id()] = e.start_ns()
            else:
                ops.setdefault(e.correlation_id(), e)
        self.device = []           # (start, end, name, host launch time)
        for e in device:
            at = launch.get(e.correlation_id())
            if at is None and e.linked_correlation_id() in ops:
                at = ops[e.linked_correlation_id()].start_ns()
            self.device.append((e.start_ns(), e.end_ns(), e.name(), at))
        self.busy = _union((a, b) for a, b, _, _ in self.device)
        self.busy_ns = sum(b - a for a, b in self.busy)

    # ---- what the metric readers ask ---------------------------------
    def span_device_ms(self, *names) -> float | None:
        """Device ms a batch of the operations launched inside the spans
        `names`.  None where no span ran."""
        rng = _union(r for n in names for r in self.ranges.get(n, []))
        if not rng:
            return None
        starts = [a for a, _ in rng]
        ns = 0
        for a, b, _, at in self.device:
            if at is None:
                continue
            i = bisect_right(starts, at) - 1
            if i >= 0 and at <= rng[i][1]:
                ns += b - a
        return ns / 1e6 / self.batches

    def span_host_ms(self, *names) -> float | None:
        rng = _union(r for n in names for r in self.ranges.get(n, []))
        if not rng:
            return None
        return sum(b - a for a, b in rng) / 1e6 / self.batches

    def kernel_ms(self, symbol: str) -> float | None:
        """Device ms a batch of the kernels whose name holds `symbol`."""
        ns = [b - a for a, b, name, _ in self.device if symbol in name]
        if not ns:
            return None
        return sum(ns) / 1e6 / self.batches

    def count(self, name: str) -> float | None:
        """A probe's count a batch over the same calls.  None where no
        probe ran."""
        n = self.counts.get(name)
        return None if n is None else n / self.batches

    def idle_share(self) -> float:
        return 1.0 - (self.busy_ns / 1e6 / self.calls) / self.plain_ms

    def launches_per_batch(self) -> float:
        return self.launches / self.batches

    # ---- the result line's device keys and breakdown -------------------
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def device_ops(self, n: int = 10) -> list:
        by = {}
        for a, b, name, _ in self.device:
            by[name] = by.get(name, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps between device operations, each named by
        the span the host was in at the gap's middle and the innermost
        host operation there (the covering one that started last)."""
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(self.busy, self.busy[1:])),
                      reverse=True)[:n]
        starts = [a for a, _, _ in self.cpu]
        out = []
        for ns, a, b in gaps:
            mid = (a + b) // 2
            span = next((s for s, rng in self.ranges.items()
                         if any(x <= mid <= y for x, y in rng)), "no span")
            op = "host"
            hi = bisect_right(starts, mid) - 1
            for i in range(hi, max(-1, hi - 50_000), -1):
                s0, s1, name = self.cpu[i]
                if s1 >= mid and name not in self.span_names:
                    op = name
                    break
            out.append([f"{span}: {op}"[:120], ns / 1e9])
        return out
