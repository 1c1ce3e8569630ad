"""The port's profiler ranges (doomtpu_torch/trace.py) on the CPU.

Outside a profiler a span is the shared no-op; under torch.profiler a
rollout and a render open the `doom.*` ranges at the layer boundaries,
one `doom.sync` range a host round trip (as many a tick and a render
call as the card's census of synchronizing calls found: SYNCS_TICK and
SYNCS_RENDER, listed in PERF.md), `doom.sim.move` inside
`doom.sim.tick`, a `doom.frames` range around each copy of a
rollout's frames, and on the item pass a `doom.itempass` range around
the item pack and one around K3 in the deferred pass's place.  The
profiler changes no bit of the frames or the state.  Every function the
benchmark's metric files wrap or probe is still where they look for it.

Fixture: the demo level, B=8 spread poses at 64x48 (tests/test_torch_sim.py's
smallest), on the scan pipeline, the paint pipeline and the paint
pipeline with the item pass.
"""

import dataclasses
import importlib
import inspect
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from doomtpu_torch import trace  # noqa: E402
from doomtpu_torch.config import RenderConfig  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# host round trips of the CUDA path (the card's census, PERF.md §5): a
# tick's movement, and a render call on each pipeline
SYNCS_TICK = 2
SYNCS_RENDER = {"paint": 7, "scan": 7, "itempass": 7}
# round trips a render's plain versions make on the CPU and the kernels
# on the card do not: the paint kernel's plain version shades with
# render/resolve.shade (its constants' upload, inside doom.walls); the
# plain resolve reads the sizes of its two pair lists (`_winners`) and
# shades (inside doom.resolve, where the kernel's path keeps its one
# trig read); the item pass's plain version makes none
PLAIN_SYNCS = {"paint": 1, "scan": 3, "itempass": 1}

DEMO = RenderConfig(width=64, height=48, span_capacity=16, mid_capacity=4,
                    clip_capacity=16, item_capacity=4)
PAINT = dataclasses.replace(DEMO, use_pallas_paint=True,
                            paint_percam_compact=True)
CONFIGS = {"scan": DEMO, "paint": PAINT,
           "itempass": dataclasses.replace(PAINT, use_item_pass_kernel=True)}
B = 8
T = 2
MOVES = np.array([[1, 1 | 4, 1 | 8, 2, 16 | 4, 1 | 32, 4, 16 | 8 | 32]] * T,
                 np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spread(t, n, seed):
    rng = np.random.default_rng(seed)
    left, right, top, bottom = [float(v) for v in t.bbox]
    out = []
    while len(out) < n:
        x, y = rng.uniform(left, right), rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            out.append((x, y, rng.uniform(0, 2 * math.pi)))
    return (np.asarray([p[:2] for p in out], np.float32),
            np.asarray([p[2] for p in out], np.float32))


def _ranges(prof) -> dict:
    """{name: sorted [(start, end)]} of the doom.* ranges of a profile."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("doom."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


@pytest.fixture(scope="module", params=["scan", "paint", "itempass"])
def runs(request):
    """(pipeline, plain rollout, profiled rollout, profiled render): a
    T-tick rollout with and without the profiler, and the ranges of the
    profiled rollout and of one profiled render."""
    eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1",
                                    config=CONFIGS[request.param],
                                    device="cpu")
    pos, ang = _spread(eng.tables, B, seed=0)
    st = eng.new_game(B, pos=pos, angle=ang,
                      generator=torch.Generator().manual_seed(0))
    draws = eng.light_draws(B, torch.Generator().manual_seed(1), ticks=T)
    plain = eng.rollout(st, MOVES, draws=draws)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = eng.rollout(st, MOVES, draws=draws)
    with profile(activities=[ProfilerActivity.CPU]) as prof_render:
        eng.render(st)
    return request.param, plain, traced, _ranges(prof), _ranges(prof_render)


def test_a_span_outside_a_profiler_is_the_shared_noop(monkeypatch):
    assert trace.span("doom.x") is trace.OFF
    assert trace.span("doom.y") is trace.OFF

    def opened(name):
        raise AssertionError(f"record_function({name!r}) outside a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", opened)

    def f(a, b=2):
        """doc"""
        return a + b
    g = trace.spanned("doom.x")(f)
    assert g(1) == 3 and g(1, b=5) == 6
    assert (g.__name__, g.__module__, g.__doc__) == (f.__name__, f.__module__,
                                                     "doc")
    assert inspect.signature(g) == inspect.signature(f)
    with trace.span("doom.x"):
        pass


def test_decorated_port_functions_keep_their_names():
    from doomtpu_torch.ops import itempass, paint, scan
    from doomtpu_torch.render import camera, camsort, resolve, things
    from doomtpu_torch.sim import player, step

    for mod, name in ((step, "tick"), (player, "move_player"),
                      (camsort, "sort_perm"), (camsort, "sort_state"),
                      (camsort, "unsort_out"), (camera, "build_seg_frame"),
                      (camera, "traversal_rank"), (camera, "seg_order"),
                      (paint, "build_rows"), (paint, "live_drop"),
                      (paint, "reuse_drop"), (paint, "kept_set"),
                      (paint, "paint"), (scan, "scan"),
                      (resolve, "resolve_frame"), (resolve, "shade"),
                      (things, "deferred_pass"), (things, "item_pack"),
                      (itempass, "item_pass")):
        fn = getattr(mod, name)
        assert (fn.__name__, fn.__module__) == (name, mod.__name__)
        assert hasattr(fn, "__wrapped__"), (mod.__name__, name)
    assert paint.paint.launches >= 0 and scan.scan.launches >= 0
    assert itempass.item_pass.launches >= 0
    assert paint.build_rows.launches >= 0 and paint.live_drop.launches >= 0


def _outside(rng, spans):
    return [(a, b) for a, b in rng
            if not any(x <= a and b <= y for x, y in spans)]


def test_one_sync_range_a_round_trip(runs):
    """The round trips of the CUDA path, and those of the plain versions
    the CPU runs in place of the kernels (PLAIN_SYNCS): inside
    doom.walls, one a render on the paint pipelines and none on the
    scan's; inside doom.resolve, the plain resolve's three and the trig
    read of the kernel's path on the scan pipeline; inside
    doom.itempass, the item pack's three: the sprite scalars' rotate and
    viewport clip, and its own upload."""
    pipeline, _, _, rollout, render = runs
    for rng, calls, ticks in ((rollout, T, T), (render, 1, 0)):
        syncs, walls = rng["doom.sync"], rng["doom.walls"]
        plain = calls * PLAIN_SYNCS[pipeline]
        assert len(syncs) - plain == (ticks * SYNCS_TICK + calls
                                      * SYNCS_RENDER[pipeline])
        assert len(syncs) - len(_outside(syncs, walls)) == (
            0 if pipeline == "scan" else plain)
        if pipeline == "scan":
            resolve = rng["doom.resolve"]
            assert len(syncs) - len(_outside(syncs, resolve)) == plain + calls
        if pipeline == "itempass":
            items = rng["doom.itempass"]
            assert len(syncs) - len(_outside(syncs, items)) == 3 * calls
        # no round trip inside another
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(syncs, syncs[1:]))


def test_move_inside_tick(runs):
    _, _, _, rollout, _ = runs
    ticks, moves = rollout["doom.sim.tick"], rollout["doom.sim.move"]
    assert len(ticks) == len(moves) == T
    for (a, b), (c, d) in zip(ticks, moves):
        assert a <= c <= d <= b
    # the tick's two round trips are the movement's
    syncs = rollout["doom.sync"]
    for c, d in moves:
        assert sum(c <= a and b <= d for a, b in syncs) == SYNCS_TICK


def test_frames_ranges_a_rollout(runs):
    """One doom.frames range for the ticks' stack (one segment of
    max_ticks_per_jit ticks) and one for engine.rollout's concatenation
    of the segments, after every tick; none in a render."""
    pipeline, _, _, rollout, render = runs
    frames = rollout["doom.frames"]
    assert len(frames) == 2
    last_tick = max(b for _, b in rollout["doom.sim.tick"])
    assert all(a > last_tick for a, _ in frames)
    assert "doom.frames" not in render
    items = "doom.itempass" if pipeline == "itempass" else "doom.deferred"
    for name in ("doom.camera", "doom.walls", items):
        assert len(render[name]) >= 1, name


def test_itempass_ranges_the_item_stage(runs):
    """On the item pass, two doom.itempass ranges a render, after the
    walls: the item pack, then K3's call; no deferred pass.  The other
    pipelines open none."""
    pipeline, _, _, rollout, render = runs
    if pipeline != "itempass":
        assert "doom.itempass" not in render
        assert "doom.itempass" not in rollout
        return
    assert "doom.deferred" not in render and "doom.deferred" not in rollout
    items, walls = render["doom.itempass"], render["doom.walls"]
    assert len(items) == 2 and len(rollout["doom.itempass"]) == 2 * T
    assert max(b for _, b in walls) <= items[0][0]
    assert items[0][1] <= items[1][0]


def test_profiler_changes_no_bit(runs):
    _, (s0, f0), (s1, f1), _, _ = runs
    assert torch.equal(f0, f1)
    for f in dataclasses.fields(s0):
        assert torch.equal(getattr(s0, f.name), getattr(s1, f.name)), f.name


def _metric_targets():
    """(metric file, module, attribute) of every SPANS and PROBES target
    of the benchmark's metric files."""
    from portbench import manifest

    out = []
    for path in sorted((ROOT / "portbench" / "metrics").glob("*.py")):
        mod = manifest.load_metric(path.stem)
        for targets in mod.SPANS.values():
            out += [(path.stem, m, a) for m, a in targets]
        for targets in getattr(mod, "PROBES", {}).values():
            out += [(path.stem, m, a) for m, a, _ in targets]
    return out


def test_metric_targets_resolve():
    targets = _metric_targets()
    assert len(targets) >= 15
    for metric, module, attr in targets:
        fn = getattr(importlib.import_module(module), attr, None)
        assert callable(fn), (metric, module, attr)
        assert fn.__name__ == attr, (metric, module, attr)
