"""Player movement, batched (game.rs:311-389).

Counterpart of doomtpu/sim/player.py.  Controls are a bitmask per
environment; one call applies one tick's movement.  The trig comes from
host numpy f32, as the JAX package's strict mode takes it: the angle
after a tick depends on nothing but the angle before it, the controls
and turbo, so the host replays the turns (`turns`) and takes the trig of
every tick of a call at its start (`tick_trig`, one host round trip),
and each tick reads its slice as a device tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from doomtpu_torch.config import CLOCK_HZ
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.jmath import (
    COS, F32, SCOS, SIN, SSIN, host_trig, rotate_cs,
)
from doomtpu_torch.sim.sector_lookup import sector_at
from doomtpu_torch.trace import span, spanned

# control bitmask
KEY_UP = 1
KEY_DOWN = 2
KEY_LEFT = 4
KEY_RIGHT = 8
KEY_ALT = 16     # strafe modifier
KEY_SHIFT = 32   # run (2x)

_DURATION = np.float32(1000.0 / CLOCK_HZ)
ROTATE_FACTOR = np.float32(_DURATION * 0.0025)
MOVE_FACTOR = np.float32(_DURATION * 0.291)


def turns(angle: np.ndarray, controls_seq: np.ndarray,
          turbo=1.0) -> np.ndarray:
    """move_player's angle update replayed on the host: the f32 angles
    [T, B] after each tick of `controls_seq` [T, B] from `angle` [B], in
    numpy f32 with the device's operations in the device's order, so the
    bits are the device's."""
    f = np.float32
    c = np.asarray(controls_seq)
    alt = (c & KEY_ALT) != 0
    mult = np.where((c & KEY_SHIFT) != 0, f(2.0), f(1.0)) * f(turbo)
    rot = mult * ROTATE_FACTOR
    left = np.where(((c & KEY_LEFT) != 0) & ~alt, rot, f(0.0))
    right = np.where(((c & KEY_RIGHT) != 0) & ~alt, rot, f(0.0))
    out = np.empty(c.shape, np.float32)
    a = np.asarray(angle, np.float32)
    for t in range(c.shape[0]):
        a = np.subtract(np.add(a, left[t], out=out[t]), right[t], out=out[t])
    return out


def tick_trig(angle: torch.Tensor, controls_seq, turbo=1.0) -> torch.Tensor:
    """[T, 6, B] f32 on angle's device: the trig bundle (jmath's rows COS
    .. SSIN) of the angle after each tick of `controls_seq` [T, B] from
    `angle` [B].  One host round trip: the angles and the controls are
    read once, the host replays the turns (`turns`) and takes the trig,
    and the table is uploaded without waiting."""
    with span("doom.sync"):
        a = angle.detach().to("cpu", F32).numpy()
        ctl = torch.as_tensor(controls_seq).to("cpu").numpy()
        return host_trig(turns(a, ctl, turbo), 6, angle.device)


class Controls(NamedTuple):
    """A tick's controls with the trig of the angle they turn to: the
    bitmask [B] i32 and the tick's [6, B] slice of `tick_trig`.  A
    rollout hands these to each tick in place of the bare bitmask, so
    `step.tick` keeps its arguments."""
    mask: torch.Tensor
    trig: torch.Tensor


@spanned("doom.sim.move")
def move_player(level: DeviceLevel, pos, angle, controls, turbo=1.0):
    """One tick of movement; returns (pos [B, 2], angle [B],
    floor_height [B]), all f32.

    game.rs:314-373: rotation then strafe then forward/back; shift
    doubles both factors; floor height re-queried from the BSP
    (game.rs:376-389).  `controls`: the bitmask [B], whose turn's trig
    is then one round trip here, or `Controls` with the trig."""
    if isinstance(controls, Controls):
        controls, trig = controls
    else:
        trig = tick_trig(angle, controls[None], turbo)[0]

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
    move_len = mult * f(MOVE_FACTOR)
    rot = mult * f(ROTATE_FACTOR)

    angle = angle + torch.where(left & ~alt, rot, 0.0)
    angle = angle - torch.where(right & ~alt, rot, 0.0)

    px, py = pos[:, 0], pos[:, 1]
    # strafe (game.rs:349-359)
    sdx, sdy = rotate_cs(move_len, 0.0, trig[SCOS], trig[SSIN])
    px = px + torch.where(alt & left, sdx, 0.0) - torch.where(
        alt & right, sdx, 0.0)
    py = py + torch.where(alt & left, sdy, 0.0) - torch.where(
        alt & right, sdy, 0.0)
    # forward / backward (game.rs:361-372)
    fdx, fdy = rotate_cs(move_len, 0.0, trig[COS], trig[SIN])
    px = px + torch.where(up, fdx, 0.0) - torch.where(down, fdx, 0.0)
    py = py + torch.where(up, fdy, 0.0) - torch.where(down, fdy, 0.0)

    sec = sector_at(level, px, py)
    floor_h = torch.where(
        sec >= 0,
        level.sector_floor_h[torch.clamp(sec, min=0).long()].to(F32), 0.0)
    return torch.stack([px, py], -1), angle, floor_h
