"""The comparison that decides `correct`.

What the timed path produced (`Produced`: the program's states and a
sample of its frames, drawn from the seed, taken from the calls of the
window) is held to the plain reference (reference/), which works the
states and the frames out again from the same WAD bytes, poses, controls
and draws.  Every number compared is a count of elements that differ,
and its limit is 0: the program's frames and states are exact.

    state_elems_differing  elements of the simulation's state (positions,
                           angles, floor heights, sector lights and their
                           countdowns, map-object states and tics, ticks)
                           that differ: the spawn state, and the state
                           after the episode (rollout) or every state of
                           the chain (render)
    idx_px_differing       palette indices that differ in the sampled
                           frames (walls, planes, sky, sprites, masked
                           mids)
    rgb_px_differing       shaded pixels that differ (render only: a
                           rollout returns the idx frames)
    capacity_drops         work the program's calibrated pools dropped
                           over every state the window renders
                           (render_counters at set-up, live_stale among
                           them)
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from portbench.generate import Inputs
from portbench.reference import Reference
from portbench.reference.sim.state import GameState

LIMITS = {"state_elems_differing": 0, "idx_px_differing": 0,
          "rgb_px_differing": 0, "capacity_drops": 0}

STATE_FIELDS = [f.name for f in fields(GameState)]


@dataclass
class Produced:
    """What the program produced, on the host.  `states`: tick -> state
    fields (all cameras; tick 0 is the spawn state).  `frames`: (tick,
    camera) -> (idx, rgb or None)."""
    states: dict = field(default_factory=dict)
    frames: dict = field(default_factory=dict)
    capacity_drops: int = 0


@dataclass
class Expected:
    """The reference's: `states` tick -> state fields; `frames` (tick,
    camera) -> (idx, rgb)."""
    states: dict = field(default_factory=dict)
    frames: dict = field(default_factory=dict)


def host_state(st) -> dict:
    return {n: getattr(st, n).detach().cpu() for n in STATE_FIELDS}


def sample_pairs(inputs: Inputs) -> list[tuple[int, int]]:
    """The (tick, camera) frames the check compares, drawn from the seed.
    A rollout's frame of tick t (1..T) is the render after t ticks; a
    render's, the render of chain state t (0..T), `check_frames` cameras
    each."""
    r = np.random.default_rng(inputs.check_seed)
    B, T, n = inputs.batch, inputs.ticks, inputs.check_frames
    if inputs.kind == "rollout":
        flat = r.choice(T * B, size=min(n, T * B), replace=False)
        return sorted((int(i // B) + 1, int(i % B)) for i in flat)
    return sorted((t, int(b)) for t in range(T + 1)
                  for b in r.choice(B, size=min(n, B), replace=False))


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x.to(torch.int32)


def state_diff(a: dict, b: dict) -> int:
    return sum(int((_bits(a[n]) != _bits(b[n])).sum()) for n in STATE_FIELDS)


def _rows(st: GameState, rows) -> GameState:
    ix = torch.as_tensor(rows, dtype=torch.long, device=st.device)
    return st.map(lambda x: x[ix])


def _cat(states: list[GameState]) -> GameState:
    return GameState(**{n: torch.cat([getattr(s, n) for s in states])
                        for n in STATE_FIELDS})


def reference_run(ref: Reference, inputs: Inputs, pairs,
                  chunk: int = 32) -> Expected:
    """The reference over the inputs: the states at the ticks `compare`
    checks and the frames of `pairs`."""
    dev = ref.device
    gen = torch.Generator(dev).manual_seed(inputs.light_seed)
    st = ref.initial(inputs.pos, inputs.angle, gen)
    controls = torch.as_tensor(inputs.controls).to(dev)
    draws = torch.as_tensor(inputs.draws).to(dev)
    T = inputs.ticks
    keep = set(range(T + 1)) if inputs.kind == "render" else {0, T}
    by_tick = {}
    for t, b in pairs:
        by_tick.setdefault(t, []).append(b)
    out, picked = Expected(), []
    for t in range(T + 1):
        if t:
            st = ref.tick(st, controls[t - 1], draws[t - 1])
        if t in keep:
            out.states[t] = host_state(st)
        if t in by_tick:
            picked.append(_rows(st, by_tick[t]))
    if picked:
        sample = _cat(picked)
        keys = [(t, b) for t in sorted(by_tick) for b in by_tick[t]]
        for i in range(0, len(keys), chunk):
            idx, rgb = ref.render(sample.map(lambda x: x[i:i + chunk]))
            for j, key in enumerate(keys[i:i + chunk]):
                out.frames[key] = (idx[j].cpu(), rgb[j].cpu())
    return out


def compare(produced: Produced, expected: Expected, with_rgb: bool) -> dict:
    """{number: value} of the program's outputs against the reference's."""
    out = {"state_elems_differing": 0, "idx_px_differing": 0}
    if with_rgb:
        out["rgb_px_differing"] = 0
    for t, ref_state in expected.states.items():
        out["state_elems_differing"] += state_diff(produced.states[t],
                                                   ref_state)
    for key, (ridx, rrgb) in expected.frames.items():
        idx, rgb = produced.frames[key]
        out["idx_px_differing"] += int((idx != ridx).sum())
        if with_rgb:
            out["rgb_px_differing"] += int((rgb != rrgb).sum())
    out["capacity_drops"] = produced.capacity_drops
    return out


def judge(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
