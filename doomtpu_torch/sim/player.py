"""Player movement, batched (game.rs:311-389).

Counterpart of doomtpu/sim/player.py.  Controls are a bitmask per
environment; one call applies one tick's movement.  The trig comes from
host numpy f32 (`jmath.rotate`), as the JAX package's strict mode takes
it, so each call reads the angles back from the device twice.
"""

from __future__ import annotations

import numpy as np
import torch

from doomtpu_torch.config import CLOCK_HZ
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import F32, rotate
from doomtpu_torch.sim.sector_lookup import sector_at
from doomtpu_torch.trace import spanned

# control bitmask
KEY_UP = 1
KEY_DOWN = 2
KEY_LEFT = 4
KEY_RIGHT = 8
KEY_ALT = 16     # strafe modifier
KEY_SHIFT = 32   # run (2x)

_PI = np.float32(np.pi)


@spanned("doom.sim.move")
def move_player(level: DeviceLevel, pos, angle, controls, turbo=1.0):
    """One tick of movement; returns (pos [B, 2], angle [B],
    floor_height [B]), all f32.

    game.rs:314-373: rotation then strafe then forward/back; shift
    doubles both factors; floor height re-queried from the BSP
    (game.rs:376-389)."""
    duration = np.float32(1000.0 / CLOCK_HZ)
    rotate_factor = np.float32(duration * 0.0025)
    move_factor = np.float32(duration * 0.291)

    alt = (controls & KEY_ALT) != 0
    shift = (controls & KEY_SHIFT) != 0
    up = (controls & KEY_UP) != 0
    down = (controls & KEY_DOWN) != 0
    left = (controls & KEY_LEFT) != 0
    right = (controls & KEY_RIGHT) != 0

    # every constant is an f32 value held as a Python float: an f32
    # operand exactly, with no host-to-device copy
    f = lambda v: float(np.float32(v))
    mult = torch.where(shift, 2.0, 1.0).to(F32) * f(turbo)
    move_len = mult * f(move_factor)
    rot = mult * f(rotate_factor)

    angle = angle + torch.where(left & ~alt, rot, 0.0)
    angle = angle - torch.where(right & ~alt, rot, 0.0)

    px, py = pos[:, 0], pos[:, 1]
    # strafe (game.rs:349-359)
    sdx, sdy = rotate(move_len, 0.0, angle + f(_PI / np.float32(2.0)))
    px = px + torch.where(alt & left, sdx, 0.0) - torch.where(
        alt & right, sdx, 0.0)
    py = py + torch.where(alt & left, sdy, 0.0) - torch.where(
        alt & right, sdy, 0.0)
    # forward / backward (game.rs:361-372)
    fdx, fdy = rotate(move_len, 0.0, angle)
    px = px + torch.where(up, fdx, 0.0) - torch.where(down, fdx, 0.0)
    py = py + torch.where(up, fdy, 0.0) - torch.where(down, fdy, 0.0)

    sec = sector_at(level, px, py)
    floor_h = torch.where(
        sec >= 0,
        level.sector_floor_h[torch.clamp(sec, min=0).long()].to(F32), 0.0)
    return torch.stack([px, py], -1), angle, floor_h
