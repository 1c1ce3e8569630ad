"""The thinkers, vectorized (counterpart of doomtpu/sim/thinkers.py).

Sector light specials are per-sector parameter tables built once on the
host plus a pure step over [B, SEC] state; the map-object state machine
is a pure step over [B, MO].  Randomness is explicit: the light step
takes its two [B, SEC] draws as arguments (`draw_lights` makes them
from a `torch.Generator`).  The port cannot reproduce JAX's threefry
draws, so parity tests feed it JAX's draws and move a JAX GameState
across with `state_from_numpy`.  JAX's `%` floors, as torch.remainder
does; every draw and divisor here is non-negative anyway.

Sector specials handled (thinkers.rs:14-80):
    1 flicker  2 strobe fast  3 strobe slow  4 strobe fast (slime)
    8 glow  12 strobe slow sync  13 strobe fast sync  17 fire flicker
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.info.tables import InfoTables
from portbench.reference.level.tables import MapTables
from portbench.reference.render.device import DeviceLevel

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


def draw_lights(generator: torch.Generator, batch: int,
                sectors: int) -> torch.Tensor:
    """[2, B, SEC] i32 draws in [0, 2^30) for one `step_lights`, on the
    generator's device."""
    return torch.randint(
        0, 1 << 30, (2, batch, sectors), generator=generator,
        device=generator.device, dtype=torch.int32,
    )


def step_lights(tk: ThinkerTables, light, count, going_up, draws):
    """One 35 Hz tick for all sector light thinkers, batched [B, SEC];
    `draws` [2, B, SEC] i32 in [0, 2^30) stand in for JAX's two randint
    draws of split(key) (thinkers.py:145-147).  Returns (light, count,
    going_up)."""
    kind = tk.kind[None]
    rnd, rnd2 = draws[0], draws[1]
    mn, mx = tk.min_light[None], tk.max_light[None]

    # countdown thinkers (flash/strobe/fire) tick their counter first
    counting = (kind == K_FLASH) | (kind == K_STROBE) | (kind == K_FIRE)
    count_new = torch.where(counting, count - 1, count)
    fire_now = counting & (count_new <= 0)

    # LightFlash (lights.rs:79-99)
    at_max = light == mx
    flash_light = torch.where(at_max, mn, mx)
    flash_count = torch.where(
        at_max, 1 + torch.remainder(rnd, tk.min_time[None]),
        1 + torch.remainder(rnd, tk.max_time[None]))

    # StrobeFlash (lights.rs:144-164)
    strobe_light = torch.where(at_max, mn, mx)
    strobe_count = torch.where(at_max, tk.dark_time[None],
                               tk.bright_time[None])

    # FireFlicker (lights.rs:242-258)
    amount = torch.remainder(rnd2, 4) * 16
    fire_light = torch.where(light - amount < mn, mn, mx - amount)
    fire_count = torch.full_like(count, 4)

    light1, count1 = light, count_new
    for k, lv, cv in ((K_FLASH, flash_light, flash_count),
                      (K_STROBE, strobe_light, strobe_count),
                      (K_FIRE, fire_light, fire_count)):
        m = fire_now & (kind == k)
        light1 = torch.where(m, lv, light1)
        count1 = torch.where(m, cv, count1)

    # GlowingLight (lights.rs:169-211): every tick, ramp +/- 8
    is_glow = kind == K_GLOW
    up = going_up
    glow_up = light + GLOW_SPEED
    overshoot_up = glow_up >= mx
    glow_up = torch.where(overshoot_up, glow_up - GLOW_SPEED, glow_up)
    glow_dn = light - GLOW_SPEED
    overshoot_dn = glow_dn <= mn
    glow_dn = torch.where(overshoot_dn, glow_dn + GLOW_SPEED, glow_dn)
    glow_light = torch.where(up, glow_up, glow_dn)
    new_up = torch.where(
        is_glow, torch.where(up, ~overshoot_up & up, overshoot_dn), going_up)
    light1 = torch.where(is_glow, glow_light, light1)
    return light1.to(torch.int32), count1.to(torch.int32), new_up


def step_mobjs(level: DeviceLevel, state, tics):
    """MapObjectThinker::mutate (map_objects.rs:84-97), batched [B, MO]."""
    frozen = tics == -1
    t1 = tics - 1
    advance = ~frozen & (t1 <= 0)
    nxt = level.state_next[state.long()]
    state1 = torch.where(advance, nxt, state)
    tics1 = torch.where(advance, level.state_tics[nxt.long()],
                        torch.where(frozen, tics, t1))
    return state1, tics1


def _move_to(level: DeviceLevel, state, tics, target, cond):
    state1 = torch.where(cond, target, state)
    tics1 = torch.where(cond, level.state_tics[target.long()], tics)
    return state1, tics1


