"""Batched game state: a dataclass of tensors, B environments.

Counterpart of doomtpu/sim/state.py.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from portbench.reference.config import CLOCK_HZ
from portbench.reference.render.device import DeviceLevel
from portbench.reference.render.jmath import F32, I32, div_const


@dataclass(eq=False)
class GameState:
    # player (camera) per environment
    pos: torch.Tensor           # [B, 2] f32
    angle: torch.Tensor         # [B] f32
    floor_height: torch.Tensor  # [B] f32
    # world
    sector_light: torch.Tensor  # [B, SEC] i32
    light_count: torch.Tensor   # [B, SEC] i32 (thinker countdown)
    light_up: torch.Tensor      # [B, SEC] bool (glow direction)
    mobj_state: torch.Tensor    # [B, MO] i32 (state table index)
    mobj_tics: torch.Tensor     # [B, MO] i32
    tick: torch.Tensor          # [B] i32 (35 Hz ticks elapsed)

    @property
    def timestamp(self) -> torch.Tensor:
        """Seconds since start, derived from ticks."""
        return div_const(self.tick.to(F32), float(CLOCK_HZ))

    @property
    def batch(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def map(self, fn) -> "GameState":
        """A new state with `fn` applied to every tensor."""
        return GameState(**{
            f.name: fn(getattr(self, f.name)) for f in fields(self)
        })

    @classmethod
    def initial(cls, level: DeviceLevel, thinkers, batch: int,
                pos=None, angle=None,
                generator: torch.Generator | None = None) -> "GameState":
        """Spawn state: players at the Player1Start (or the given poses),
        mobjs in their spawn states, light countdowns drawn from
        `generator` (seed 0 on the level's device when None)."""
        from portbench.reference.sim.sector_lookup import sector_at

        B, dev = batch, level.device
        if pos is None:
            pos = np.broadcast_to(
                np.asarray(thinkers.player_start_pos, np.float32), (B, 2)
            )
            angle = np.full((B,), thinkers.player_start_angle, np.float32)
        pos = torch.as_tensor(np.array(pos, np.float32)).to(dev).reshape(B, 2)
        angle = torch.as_tensor(np.array(angle, np.float32)).to(dev).reshape(B)

        sec = sector_at(level, pos[:, 0], pos[:, 1])
        floor_h = torch.where(
            sec >= 0,
            level.sector_floor_h[torch.clamp(sec, min=0).long()].to(F32),
            torch.zeros((), dtype=F32, device=dev),
        )
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        nsec, nmo = level.num_sectors, level.num_mobjs
        spawn = level.mobj_spawn_state
        return cls(
            pos=pos,
            angle=angle,
            floor_height=floor_h,
            sector_light=level.sector_light0[None].expand(B, nsec).clone(),
            light_count=thinkers.initial_counts(generator, B),
            light_up=torch.zeros((B, nsec), dtype=torch.bool, device=dev),
            mobj_state=spawn[None].expand(B, nmo).clone(),
            mobj_tics=level.state_tics[spawn.long()][None].expand(B, nmo).clone(),
            tick=torch.zeros((B,), dtype=I32, device=dev),
        )


_DTYPES = {
    "pos": F32, "angle": F32, "floor_height": F32, "light_up": torch.bool,
}


def state_from_numpy(arrays: dict, device) -> GameState:
    """A GameState from numpy arrays keyed by field name (e.g. a JAX
    GameState's fields through np.asarray), on `device`."""
    return GameState(**{
        f.name: torch.as_tensor(
            np.array(arrays[f.name], order="C"),
            dtype=_DTYPES.get(f.name, I32),
        ).to(device)
        for f in fields(GameState)
    })
