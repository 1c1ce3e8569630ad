"""The readers of the program's own spans (metrics/host.syncs_per_batch,
host.sync_ms, device.sync_idle_ms, frames.ms): on a hand-built Trace
with known host ranges and device intervals (ns), and on a profile of
the port's CPU rollout, where the program's doom.sync ranges are read
as a traced run reads them."""

import pytest

from portbench import manifest, tracing

READERS = {n: manifest.load_metric(n) for n in (
    "host.syncs_per_batch", "host.sync_ms", "device.sync_idle_ms",
    "frames.ms")}


def _trace(ranges: dict, device: list, batches: int = 1):
    """A Trace of host `ranges` {name: [(start, end)]} and `device`
    operations [(start, end, name, host launch time)]."""
    tr = tracing.Trace.__new__(tracing.Trace)
    tr.batches, tr.calls = batches, 1
    tr.span_names = set(ranges)
    tr.cpu = sorted((a, b, n) for n, rs in ranges.items() for a, b in rs)
    tr.ranges = {n: tracing._union(rs) for n, rs in ranges.items()}
    tr.device = list(device)
    tr.busy = tracing._union((a, b) for a, b, _, _ in device)
    tr.busy_ns = sum(b - a for a, b in tr.busy)
    return tr


def _read(name, tr):
    return READERS[name].read(tr)


def test_each_declares_only_its_program_span():
    for name, mod in READERS.items():
        want = "doom.frames" if name == "frames.ms" else "doom.sync"
        assert mod.SPANS == {want: []}, name


def test_a_program_without_the_spans_reads_nothing():
    tr = _trace({"doom.sync": [], "doom.frames": []},
                [(0, 10, "k", 1)], batches=2)
    for name in READERS:
        assert _read(name, tr) is None, name


def test_syncs_and_their_host_time():
    tr = _trace({"doom.sync": [(100, 200), (300, 350), (900, 1000)]},
                [(0, 50, "k", 5)], batches=2)
    assert _read("host.syncs_per_batch", tr) == 1.5
    assert _read("host.sync_ms", tr) == pytest.approx(250 / 2 / 1e6)


def test_bubble_split_by_a_host_to_device_copy():
    """The read's copy runs into the range; the copy back, launched
    inside it, splits the bubble; the kernel launched after the range
    ends closes it.  Idle: [100, 230] less [100, 110] and [150, 155]."""
    tr = _trace({"doom.sync": [(100, 200)]}, [
        (20, 90, "kernel_a", 10),
        (90, 110, "Memcpy DtoH", 95),
        (150, 155, "Memcpy HtoD", 150),
        (230, 300, "kernel_b", 210),
    ])
    assert _read("device.sync_idle_ms", tr) == pytest.approx(115 / 1e6)


def test_a_sync_that_no_launch_follows():
    """No launch after the range: its stretch ends where the device's
    last operation ends (covered here: no idle), and a range after the
    last operation adds nothing."""
    dev = [(390, 450, "kernel", 380)]
    tr = _trace({"doom.sync": [(400, 500)]}, dev)
    assert _read("device.sync_idle_ms", tr) == 0
    tr = _trace({"doom.sync": [(400, 500), (600, 700)]},
                [(300, 420, "kernel", 290)])
    assert _read("device.sync_idle_ms", tr) == pytest.approx(0)
    tr = _trace({"doom.sync": [(400, 500)]}, [(300, 380, "kernel", 290)])
    assert _read("device.sync_idle_ms", tr) == 0


def test_stretches_that_overlap_count_once():
    """Two round trips with no launch between them both end at the
    kernel launched after the second: [100, 260] once, over 2 batches."""
    tr = _trace({"doom.sync": [(100, 150), (160, 200)]}, [
        (0, 120, "kernel_a", 0),
        (260, 300, "kernel_b", 210),
    ], batches=2)
    assert _read("device.sync_idle_ms", tr) == pytest.approx(140 / 2 / 1e6)


def test_frames_copy_time():
    tr = _trace({"doom.frames": [(1000, 1100)], "doom.sync": []}, [
        (900, 990, "kernel", 890),
        (1050, 1850, "CatArrayBatchedCopy", 1010),
        (1850, 2650, "copy", 1090),
        (2700, 2800, "after", 1200),
    ], batches=4)
    assert _read("frames.ms", tr) == pytest.approx(1600 / 4 / 1e6)


def test_the_port_profile_on_the_cpu():
    """A 2-tick scan rollout of the port under torch.profiler, reduced as
    a traced run reduces it: 2 + 10 round trips a tick, and no device
    operation to measure idle by or to charge the copies with."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from doomtpu_torch import DoomEngine
    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.wad import synth

    eng = DoomEngine.from_wad_bytes(
        synth.demo_wad(), "e1m1", device="cpu",
        config=RenderConfig(width=64, height=48, span_capacity=16,
                            mid_capacity=4, clip_capacity=16,
                            item_capacity=4))
    st = eng.new_game(8, generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.rollout(st, torch.ones((2, 8), dtype=torch.int32))
    spans = {"doom.sync": [], "doom.frames": []}
    tr = tracing.Trace(prof, spans, batches=2, calls=1, plain_ms=1.0,
                       wall_s=1.0, shape={})
    assert _read("host.syncs_per_batch", tr) == 12
    assert _read("host.sync_ms", tr) > 0
    assert _read("device.sync_idle_ms", tr) is None
    assert _read("frames.ms", tr) == 0
