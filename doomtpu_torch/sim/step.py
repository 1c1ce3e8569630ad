"""The simulation step: one 35 Hz tick for B environments, and rollouts.

Counterpart of doomtpu/sim/step.py.  `tick` mirrors Game::tick
(game.rs:463-466): the player's controls, then every thinker.  A
rollout is T ticks of step and render; on the card each tick renders
through the kernels of the config's pipeline (render/frame.py).  A
rollout reads the device once, at its start: the trig of every tick's
angle (sim/player.py::tick_trig) is one table that the movement and
the render of each tick read on the device.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from doomtpu_torch.render.camsort import sort_perm, sort_state, unsort_out
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.frame import render_frame
from doomtpu_torch.render.jmath import I32
from doomtpu_torch.sim import player as player_mod
from doomtpu_torch.sim import thinkers as tk_mod
from doomtpu_torch.sim.state import GameState
from doomtpu_torch.sim.thinkers import ThinkerTables
from doomtpu_torch.trace import span, spanned


@spanned("doom.sim.tick")
def tick(level: DeviceLevel, tkt: ThinkerTables, state: GameState,
         controls, draws, turbo: float = 1.0) -> GameState:
    """One tick: `controls` [B] i32 bitmask (sim/player.py), or a
    player.Controls that carries the tick's trig along (a rollout's),
    `draws` [2, B, SEC] i32 in [0, 2^30), the light step's randomness
    (thinkers.draw_lights)."""
    pos, angle, floor_h = player_mod.move_player(
        level, state.pos, state.angle, controls, turbo)
    light, count, up = tk_mod.step_lights(
        tkt, state.sector_light, state.light_count, state.light_up, draws)
    mstate, mtics = tk_mod.step_mobjs(level, state.mobj_state,
                                      state.mobj_tics)
    return GameState(
        pos=pos, angle=angle, floor_height=floor_h,
        sector_light=light, light_count=count, light_up=up,
        mobj_state=mstate, mobj_tics=mtics, tick=state.tick + 1,
    )


def kill_everything(level: DeviceLevel, state: GameState) -> GameState:
    """K key (game.rs:414-419, map_objects.rs:123-127)."""
    s, t = tk_mod.kill_mobjs(level, state.mobj_state, state.mobj_tics)
    return replace(state, mobj_state=s, mobj_tics=t)


def explode_everything(level: DeviceLevel, state: GameState) -> GameState:
    s, t = tk_mod.explode_mobjs(level, state.mobj_state, state.mobj_tics)
    return replace(state, mobj_state=s, mobj_tics=t)


def respawn_everything(level: DeviceLevel, state: GameState) -> GameState:
    s, t = tk_mod.respawn_mobjs(level, state.mobj_state, state.mobj_tics)
    return replace(state, mobj_state=s, mobj_tics=t)


def _render(level, cfg, st: GameState, return_frames: bool, trig,
            reuse=None, want_reuse=False):
    """(idx [B, H, W] or checksums [B], live_stale, reuse metadata or
    None) of one tick's full frame, cameras Morton-sorted when the batch
    is larger than 8 (with the reused permutation under `reuse`, and the
    tick's trig bundle `trig` [6, B] gathered to match), outputs in
    caller order.  The whole batch renders at once: JAX's
    render_chunk pieces change no per-camera list, frame or summed
    counter.  The rest of the render's aux is dropped here, so no tick's
    temporaries live on into the next tick's render."""
    perm = None
    if reuse is not None:
        perm = reuse["perm"]
    elif cfg.camera_sort and st.batch > 8:
        perm = sort_perm(st.pos, st.angle)
    trig = trig[:4]
    if perm is not None:
        st, _ = sort_state(st, perm)
        trig = trig.index_select(1, perm)
    idx, _, aux = render_frame(
        level, cfg, st.pos[:, 0], st.pos[:, 1], st.angle, st.floor_height,
        st.sector_light, st.mobj_state, st.timestamp,
        reuse=reuse, want_reuse=want_reuse, trig=trig)
    out = idx if return_frames else idx.sum(dim=(1, 2))
    if perm is not None:
        (out,) = unsort_out((out,), perm)
    meta = None
    if want_reuse:
        meta = dict(aux["reuse"], perm=perm)
    return out, aux["live_stale"], meta


def rollout(level: DeviceLevel, tkt: ThinkerTables, cfg, state: GameState,
            controls_seq, draws, return_frames: bool = True,
            live_reuse: bool = False, turbo: float = 1.0, trig=None):
    """T ticks of step and render: `controls_seq` [T, B] i32, `draws` a
    callable t -> [2, B, SEC] i32 (tick t's light draws), `trig` the
    ticks' [T, 6, B] table (player.tick_trig), else made here with the
    call's one host round trip.

    Returns (final state, out) with out [T, B, H, W] i32 palette-index
    frames (return_frames=True; mind the memory, T*B*H*W*4 bytes) or
    [T, B] int64 per-camera checksums (the sum of a frame's idx; JAX's
    dtype there follows its x64 switch, the values are the same).

    live_reuse=True (the paint + deferred pipeline with per-camera live
    lists only) renders tick 1 with want_reuse and every later tick with
    its traversal order, camera permutation and kept live set
    (render_frame), and returns a third element, the summed live_stale
    (i32): 0 proves every frame is the one live_reuse=False draws."""
    T = controls_seq.shape[0]
    if trig is None:
        trig = player_mod.tick_trig(state.angle, controls_seq, turbo)
    outs = []
    reuse = None
    stale = torch.zeros((), dtype=I32, device=state.device)
    for t in range(T):
        state = tick(level, tkt, state,
                     player_mod.Controls(controls_seq[t], trig[t]), draws(t),
                     turbo)
        out, tick_stale, meta = _render(level, cfg, state, return_frames,
                                        trig[t], reuse=reuse,
                                        want_reuse=live_reuse and t == 0)
        reuse = meta or reuse
        stale = stale + tick_stale        # 0 on a freshly ordered tick
        outs.append(out)
    if outs:
        with span("doom.frames"):
            frames = torch.stack(outs)
    else:
        shape = (0, state.batch) + ((cfg.height, cfg.width)
                                    if return_frames else ())
        frames = torch.zeros(shape, dtype=I32 if return_frames
                             else torch.int64, device=state.device)
    if live_reuse:
        return state, frames, stale
    return state, frames
