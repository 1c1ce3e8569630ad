"""One run of one cell: set-up, the measured window, the traced calls and
the check.

    set-up   inputs from the seed; the engine built on the device; the
             states the window renders, ticked by the program; the pools
             calibrated over exactly those states; every capacity counter
             read over them (it warms every shape too); one warm call
    window   whole calls of the cell's entry, closed-loop, each ending in
             a synchronize, until a call ends past `seconds`
    traced   (--trace 1) the metric files' spans installed, a few more
             calls under torch.profiler, reduced by the metric readers
    check    the program's outputs of the window held to the reference,
             once the program's state is freed (check.py)
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import torch

from portbench import check, generate, manifest, roofline, tracing
from portbench.manifest import Cell

GIB = float(1 << 30)
# calls profiled in a traced run: a rollout call is a whole episode
TRACED_CALLS = {"rollout": 1, "render": 4}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Card:
    """The device's clock barrier and memory counters (none on the CPU,
    where only the tests run a cell)."""

    def __init__(self, device: str):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def describe(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(self.device), "count": 1}


class Program:
    """The system under test: doomtpu_torch's engine on the cell's level,
    and the calls of the cell's entry."""

    def __init__(self, cell: Cell, inputs: generate.Inputs, card: Card,
                 wad: bytes):
        from doomtpu_torch import DoomEngine
        from doomtpu_torch.config import RenderConfig

        self.inputs, self.card = inputs, card
        self.phases = {}
        dev = card.device
        t = time.perf_counter()
        self.engine = DoomEngine.from_wad_bytes(
            wad, cell.config["map"], config=RenderConfig(**cell.config["render"]),
            device=dev)
        self.state0 = self.engine.new_game(
            inputs.batch, pos=inputs.pos, angle=inputs.angle,
            generator=torch.Generator(dev).manual_seed(inputs.light_seed))
        self.controls = torch.as_tensor(inputs.controls).to(dev)
        self.draws = torch.as_tensor(inputs.draws).to(dev)
        t = self.phase("engine", t)
        # the states the window renders: a rollout's ticks 1..T, a
        # render's chain 0..T
        s, chain = self.state0, [self.state0]
        for k in range(inputs.ticks):
            s = self.engine.tick(s, self.controls[k], draws=self.draws[k])
            chain.append(s)
        self.chain = chain if inputs.kind == "render" else chain[1:]
        t = self.phase("ticks", t)
        if cell.config.get("calibrate", False):
            self.engine = self.engine.calibrate(self.chain)
        t = self.phase("calibrate", t)
        self.drops = {}
        for st in self.chain:
            for k, v in self.engine.render_counters(st).items():
                self.drops[k] = self.drops.get(k, 0) + v
        t = self.phase("counters", t)
        if inputs.kind == "render":
            self.produced_states = {t: check.host_state(st)
                                    for t, st in enumerate(self.chain)}
        else:
            self.produced_states = {0: check.host_state(self.state0)}
            self.chain = None

    def phase(self, name: str, t0: float) -> float:
        """Records set-up phase `name` as begun at t0; returns now."""
        self.card.sync()
        t = time.perf_counter()
        self.phases[name] = t - t0
        return t

    def call(self, n: int):
        """Call n of the window: a rollout episode from the spawn state,
        or the render of chain state n mod its length."""
        if self.inputs.kind == "render":
            return self.engine.render(self.chain[n % len(self.chain)])
        return self.engine.rollout(
            self.state0, self.controls, draws=self.draws,
            return_frames=True, live_reuse=False)

    @property
    def min_calls(self) -> int:
        """A window renders every state of a render's chain."""
        return len(self.chain) if self.inputs.kind == "render" else 1

    def batches(self, calls: int) -> int:
        return calls * (self.inputs.ticks if self.inputs.kind == "rollout"
                        else 1)

    def frames(self, calls: int) -> int:
        return self.batches(calls) * self.inputs.batch


class Keeper:
    """Keeps, of the window's outputs, what the check compares: a
    rollout's last episode (final state and the sampled frames), a
    render's latest sampled cameras of each chain state."""

    def __init__(self, inputs: generate.Inputs, device):
        self.kind = inputs.kind
        self.pairs = check.sample_pairs(inputs)
        self.by_state = {}
        for t, b in self.pairs:
            self.by_state.setdefault(t, []).append(b)
        self.rows = {t: torch.as_tensor(bs, device=device)
                     for t, bs in self.by_state.items()}
        self.n_states = inputs.ticks + 1
        self.ring = {}
        self.last = None

    def release(self):
        """Before a call: a rollout's last episode is read and freed."""
        self.last = None

    def keep(self, n: int, out):
        if self.kind == "render":
            t = n % self.n_states
            if t in self.rows:
                r = self.rows[t]
                self.ring[t] = (out[0][r], out[1][r])
        else:
            self.last = out

    def produced(self, program: Program) -> check.Produced:
        p = check.Produced(states=dict(program.produced_states),
                           capacity_drops=sum(program.drops.values()))
        if self.kind == "render":
            for t, (idx, rgb) in self.ring.items():
                for j, b in enumerate(self.by_state[t]):
                    p.frames[(t, b)] = (idx[j].cpu(), rgb[j].cpu())
        else:
            state, frames = self.last
            p.states[program.inputs.ticks] = check.host_state(state)
            for t, b in self.pairs:
                p.frames[(t, b)] = (frames[t - 1, b].cpu(), None)
        return p


def p95(xs: list[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(xs)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        started: float) -> dict:
    """The result line's object of one run.  `started`: time.time() of
    the process's start."""
    card = Card(device)
    wad = generate.wad_bytes(cell.config)
    inputs = generate.generate(cell.traffic, seed,
                               generate.level_tables(cell.config))
    program = Program(cell, inputs, card, wad)
    keeper = Keeper(inputs, card.device)
    t = time.perf_counter()
    out = program.call(0)
    program.phase("warm call", t)
    del out
    setup_s = time.time() - started
    setup_peak = card.peak()
    log(f"set-up {setup_s:.3f} s, of which " + ", ".join(
        f"{k} {v:.3f}" for k, v in program.phases.items())
        + f"; capacity counters over the "
        f"{len(program.chain or range(inputs.ticks))} rendered states: "
        f"{program.drops}; config {program.engine.config}")

    # ---- the window -----------------------------------------------------
    card.reset_peak()
    times, n, out = [], 0, None
    t0 = time.perf_counter()
    while True:
        out = None                     # a consumer has read the last batch
        keeper.release()
        c0 = time.perf_counter()
        out = program.call(n)
        card.sync()
        c1 = time.perf_counter()
        times.append(c1 - c0)
        keeper.keep(n, out)
        n += 1
        if c1 - t0 >= seconds and n >= program.min_calls:
            break
    window_s = c1 - t0
    peak = card.peak()
    frames = program.frames(n)
    metrics = {
        "frames_per_s": (frames / window_s, "frames/s"),
        "batch_ms_p95": (p95(times) * 1e3, "ms"),
        "peak_mem_gib": (peak / GIB, "GiB"),
        "setup_s": (setup_s, "s"),
    }
    log(f"window {window_s:.6f} s: {n} calls, {frames} frames; ms a call "
        f"first {times[0] * 1e3:.3f}, min {min(times) * 1e3:.3f}, median "
        f"{statistics.median(times) * 1e3:.3f}, p95 {p95(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f} over {n} samples; peak "
        f"{peak} B (set-up {setup_peak} B)")

    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": dict(card.describe(),
                             memory_peak_bytes=max(peak, setup_peak))}
    if trace:
        out = None
        per_layer, dev_extra, breakdown = traced(
            cell, program, keeper, n, statistics.fmean(times), card, wad)
        result["metrics"] = per_layer
        result["device"].update(dev_extra)
        result["breakdown"] = breakdown
    else:
        result["metrics"] = {
            m["name"]: {"value": metrics[m["name"]][0],
                        "unit": metrics[m["name"]][1]}
            for m in cell.end_to_end if m["name"] in metrics}

    # ---- the check --------------------------------------------------------
    out = None
    produced = keeper.produced(program)
    del program, keeper
    gc.collect()
    if card.cuda:
        torch.cuda.empty_cache()
    numbers = verify(cell, inputs, produced, wad, card.device)
    result["correct"] = check.judge(numbers)
    result["checked"] = {k: {"value": v, "limit": check.LIMITS[k]}
                         for k, v in numbers.items()}
    return result


def verify(cell: Cell, inputs, produced, wad: bytes, device) -> dict:
    """The check's numbers: the reference over the same inputs, on the
    device, against what the program produced."""
    from portbench.reference import Reference

    t0 = time.perf_counter()
    r = cell.config["render"]
    ref = Reference(wad, cell.config["map"], r.get("width", 320),
                    r.get("height", 200), device)
    pairs = check.sample_pairs(inputs)
    expected = check.reference_run(ref, inputs, pairs)
    numbers = check.compare(produced, expected,
                            with_rgb=inputs.kind == "render")
    log(f"reference: {len(expected.states)} states, "
        f"{len(expected.frames)} frames in {time.perf_counter() - t0:.3f} s")
    return numbers


def traced(cell: Cell, program: Program, keeper: Keeper, n0: int,
           plain_s: float, card: Card, wad: bytes):
    """Per-layer metrics, the device's busy and window seconds and the
    breakdown, from a few calls under the profiler with the metric files'
    spans installed."""
    from torch.profiler import ProfilerActivity, profile

    readers = {m["name"]: manifest.load_metric(m["name"])
               for m in cell.per_layer}
    spans, probes = {}, {}
    for mod in readers.values():
        for name, targets in mod.SPANS.items():
            spans.setdefault(name, []).extend(
                t for t in targets if t not in spans.get(name, []))
        for name, targets in getattr(mod, "PROBES", {}).items():
            probes.setdefault(name, []).extend(
                t for t in targets if t not in probes.get(name, []))
    k = TRACED_CALLS[program.inputs.kind]
    counts = {}
    if probes:
        # the same k calls, counted, outside the profile
        with tracing.Probes(probes) as pr:
            for i in range(k):
                out = None
                keeper.release()
                out = program.call(n0 + i)
                card.sync()
            counts = pr.totals()
        out = None
    with tracing.Spans(spans):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            for i in range(k):
                out = None
                keeper.release()
                out = program.call(n0 + i)
                card.sync()
                keeper.keep(n0 + i, out)
            wall = time.perf_counter() - w0
    out = None
    r0 = time.perf_counter()
    r = cell.config["render"]
    shape = {"batch": program.inputs.batch, "height": r.get("height", 200),
             "width": r.get("width", 320),
             "level": roofline.level_bytes(wad, cell.config["map"])}
    tr = tracing.Trace(prof, spans, batches=program.batches(k), calls=k,
                       plain_ms=plain_s * 1e3, wall_s=wall, shape=shape,
                       counts=counts)
    values = {}
    for m in cell.per_layer:
        v = readers[m["name"]].read(tr)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    for name in spans:
        log(f"span {name}: host ms a batch {tr.span_host_ms(name)}, device "
            f"ms a batch {tr.span_device_ms(name)}")
    log(f"traced {k} calls ({program.batches(k)} batches) in {wall:.6f} s "
        f"under the profiler; device busy {tr.busy_s():.6f} s; launches "
        f"{tr.launches}; ms a call without the profiler "
        f"{plain_s * 1e3:.3f}; counts a batch "
        f"{ {n: tr.count(n) for n in counts} }; reduced in "
        f"{time.perf_counter() - r0:.3f} s")
    breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    return values, {"busy_s": tr.busy_s(), "window_s": wall}, breakdown
