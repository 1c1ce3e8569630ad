"""The one traffic generator: a mix's parameters and a seed in, the
inputs of a run out.

A mix (traffic/<mix>.json) is closed-loop: the harness issues the next
call when the last one has returned.  Its keys:

    kind      "rollout": DoomEngine.rollout over `ticks` ticks from the
              spawn state, every call the same episode (an RL episode
              reset); "render": DoomEngine.render over a chain of
              `chain` states, cycled
    batch     cameras (agents) a call
    ticks     rollout: the episode's ticks
    chain     render: states in the chain (the first is the spawn state,
              each later one a tick of the chain's controls after it)
    poses     "spread": uniform over the map's bounding box, kept where
              the sector's floor lies below its ceiling
    hold      ticks an agent keeps an action before it draws the next
    actions   the actions an agent draws from, uniformly: each a list of
              keys of KEYS (an empty list: no key pressed)
    set_seed  the seed of the set of poses and the set of action
              sequences: every run draws the same two sets, and its own
              seed deals them out to the agents in another order (each
              set shuffled on its own): every seed brings the same views
              and the same action sequences, so the work barely changes
              with it
    check     {"frames": n}: frames the correctness check compares (a
              rollout: (tick, agent) pairs; a render: cameras of each
              chain state)

The run's seed fixes every number drawn but the two sets: which agent
gets which pose and which action sequence, the light step's draws and
the seed of the spawn state's light countdowns.  The level's
tables come from the benchmark's own WAD reader (reference/), so the
program under test shapes none of its inputs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from portbench.inputs import synth
from portbench.reference.level.tables import MapTables
from portbench.reference.sim.player import (
    KEY_ALT, KEY_DOWN, KEY_LEFT, KEY_RIGHT, KEY_SHIFT, KEY_UP,
)
from portbench.reference.wad.reader import WadFile

KEYS = {"up": KEY_UP, "down": KEY_DOWN, "left": KEY_LEFT,
        "right": KEY_RIGHT, "alt": KEY_ALT, "shift": KEY_SHIFT}

# streams of numbers drawn from one seed, one a purpose
_POSES, _ACTIONS, _DRAWS, _LIGHTS, _CHECK = range(5)


@dataclass
class Inputs:
    kind: str
    batch: int
    pos: np.ndarray          # [B, 2] f32
    angle: np.ndarray        # [B] f32
    light_seed: int          # torch.Generator seed of the spawn countdowns
    controls: np.ndarray     # [T, B] i32: the episode's, or the chain's
    draws: np.ndarray        # [T, 2, B, SEC] i32 in [0, 2^30)
    check_frames: int
    check_seed: int

    @property
    def ticks(self) -> int:
        return int(self.controls.shape[0])


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def wad_bytes(config: dict) -> bytes:
    """The configuration's level: a builder of inputs/synth.py by name."""
    return getattr(synth, config["level"])()


def level_tables(config: dict) -> MapTables:
    return MapTables.load(WadFile(wad_bytes(config)), config["map"])


def spread_poses(tables: MapTables, n: int, r: np.random.Generator):
    """n poses uniform over the map's bounding box where the sector's
    floor lies below its ceiling, facing uniformly in [0, 2 pi)."""
    left, right, top, bottom = [float(v) for v in tables.bbox]
    pos, ang = [], []
    while len(pos) < n:
        x, y = r.uniform(left, right), r.uniform(top, bottom)
        s = tables.sector_at(x, y)
        if s >= 0 and tables.sector_floor_h[s] < tables.sector_ceil_h[s]:
            pos.append((x, y))
            ang.append(r.uniform(0, 2 * math.pi))
    return np.asarray(pos, np.float32), np.asarray(ang, np.float32)


def action_masks(mix: dict) -> np.ndarray:
    masks = []
    for keys in mix["actions"]:
        m = 0
        for k in keys:
            m |= KEYS[k]
        masks.append(m)
    return np.asarray(masks, np.int32)


def generate(mix: dict, seed: int, tables: MapTables) -> Inputs:
    kind = mix["kind"]
    if kind not in ("rollout", "render"):
        raise ValueError(f"unknown traffic kind {kind!r}")
    B = int(mix["batch"])
    T = int(mix["ticks"]) if kind == "rollout" else int(mix["chain"]) - 1
    if mix["poses"] != "spread":
        raise ValueError(f"unknown poses {mix['poses']!r}")
    set_seed = int(mix["set_seed"])
    pos, angle = spread_poses(tables, B, rng(set_seed, _POSES))
    masks = action_masks(mix)
    hold = int(mix["hold"])
    picks = rng(set_seed, _ACTIONS).integers(0, len(masks),
                                             size=(-(-T // hold), B))
    order = rng(seed, _POSES).permutation(B)
    pos, angle = pos[order], angle[order]
    picks = picks[:, rng(seed, _ACTIONS).permutation(B)]
    controls = np.repeat(masks[picks], hold, axis=0)[:T]
    sec = int(tables.sector_light.shape[0])
    draws = rng(seed, _DRAWS).integers(0, 1 << 30, size=(T, 2, B, sec),
                                       dtype=np.int32)
    light_seed = int(rng(seed, _LIGHTS).integers(0, 1 << 62))
    return Inputs(
        kind=kind, batch=B, pos=pos, angle=angle, light_seed=light_seed,
        controls=np.ascontiguousarray(controls, np.int32), draws=draws,
        check_frames=int(mix["check"]["frames"]),
        check_seed=int(rng(seed, _CHECK).integers(0, 1 << 62)),
    )
