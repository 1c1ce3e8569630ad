"""Sector-light thinker tables (counterpart of doomtpu/sim/thinkers.py).

This package holds the table build and the initial countdowns; the step
functions come with the simulation.  Randomness takes an explicit
`torch.Generator`: it cannot reproduce JAX's threefry draws, so parity
tests move a JAX GameState across with `state_from_numpy` instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from doomtpu_torch.info.tables import InfoTables
from doomtpu_torch.level.tables import MapTables

# lights.rs:9-13
SLOW_DARK = 35
FAST_DARK = 15
STROBE_BRIGHT = 5
GLOW_SPEED = 8

K_NONE, K_FLASH, K_STROBE, K_GLOW, K_FIRE = 0, 1, 2, 3, 4


def find_min_surrounding_light(t: MapTables, sector: int, maximum: int) -> int:
    """Minimum neighbor light level (lights.rs:16-42)."""
    light = maximum
    for li in range(len(t.line_flags)):
        f, b = t.line_sides[li]
        if f >= 0 and t.side_sector[f] == sector and b >= 0:
            light = min(light, int(t.sector_light[t.side_sector[b]]))
        if b >= 0 and t.side_sector[b] == sector and f >= 0:
            light = min(light, int(t.sector_light[t.side_sector[f]]))
    return light


@dataclass(eq=False)
class ThinkerTables:
    kind: torch.Tensor         # [SEC] i32
    min_light: torch.Tensor    # [SEC] i32
    max_light: torch.Tensor    # [SEC] i32
    dark_time: torch.Tensor    # [SEC] i32 (strobe)
    bright_time: torch.Tensor  # [SEC] i32
    min_time: torch.Tensor     # [SEC] i32 (flash)
    max_time: torch.Tensor     # [SEC] i32
    sync: torch.Tensor         # [SEC] bool
    player_start_pos: np.ndarray
    player_start_angle: float

    @classmethod
    def build(cls, tables: MapTables, info: InfoTables,
              device) -> "ThinkerTables":
        n = len(tables.sector_light)
        kind = np.zeros(n, np.int32)
        min_l = np.zeros(n, np.int32)
        max_l = np.asarray(tables.sector_light, np.int32).copy()
        dark = np.zeros(n, np.int32)
        bright = np.full(n, STROBE_BRIGHT, np.int32)
        min_t = np.full(n, 7, np.int32)
        max_t = np.full(n, 64, np.int32)
        sync = np.zeros(n, bool)

        for s in range(n):
            sp = int(tables.sector_special[s])
            lv = int(tables.sector_light[s])
            if sp == 1:
                kind[s] = K_FLASH
                min_l[s] = find_min_surrounding_light(tables, s, lv)
            elif sp in (2, 3, 4, 12, 13):
                kind[s] = K_STROBE
                m = find_min_surrounding_light(tables, s, lv)
                if m == lv:
                    m = 0
                min_l[s] = m
                dark[s] = SLOW_DARK if sp in (3, 12) else FAST_DARK
                sync[s] = sp in (12, 13)
            elif sp == 8:
                kind[s] = K_GLOW
                min_l[s] = find_min_surrounding_light(tables, s, lv)
            elif sp == 17:
                kind[s] = K_FIRE
                min_l[s] = find_min_surrounding_light(tables, s, lv) + 16

        try:
            pos, ang = tables.player_start()
        except ValueError:
            pos, ang = np.zeros(2, np.float32), 0.0

        j = lambda x: torch.as_tensor(x).to(device)
        return cls(
            kind=j(kind), min_light=j(min_l), max_light=j(max_l),
            dark_time=j(dark), bright_time=j(bright),
            min_time=j(min_t), max_time=j(max_t), sync=j(sync),
            player_start_pos=np.asarray(pos, np.float32),
            player_start_angle=float(ang),
        )

    def initial_counts(self, generator: torch.Generator,
                       batch: int) -> torch.Tensor:
        """Initial countdowns: flash rand(1..=64), strobe rand(1..=8) or
        1 when synchronized, fire 4 (lights.rs:57-99, 104-164, 216-259).
        The draws come from `generator` (on the generator's device), so
        they differ from the JAX package's for the same seed."""
        SEC = self.kind.shape[0]
        r = torch.randint(
            0, 1 << 30, (batch, SEC), generator=generator,
            device=generator.device, dtype=torch.int32,
        ).to(self.kind.device)
        flash = 1 + torch.remainder(r, self.max_time[None])
        strobe = torch.where(self.sync[None], 1, 1 + torch.remainder(r, 8))
        count = torch.where(self.kind[None] == K_FLASH, flash, 0)
        count = torch.where(self.kind[None] == K_STROBE, strobe, count)
        count = torch.where(self.kind[None] == K_FIRE, 4, count)
        return count.to(torch.int32)
