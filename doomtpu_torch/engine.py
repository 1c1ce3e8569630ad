"""DoomEngine: the port's user-facing API.

    engine = DoomEngine.from_wad("doom1.wad", "e1m1",     # on the card
                                 config=RenderConfig(use_pallas_paint=True))
    state = engine.new_game(batch=2048, generator=torch.Generator("cuda"))
    idx, rgb = engine.render(state)                  # [B, H, W]
    state = engine.tick(state, controls)             # one 35 Hz tick
    state, frames = engine.rollout(state, controls_seq)

Counterpart of doomtpu/engine.py.  The engine runs on the CUDA card
unless the caller passes device="cpu" (where the kernels' plain PyTorch
versions run).  This package renders full frames (walls, planes, sky,
sprites, masked mids) of every level.  Walls, planes and sky come from
the paint kernel where the config sets `use_pallas_paint` (as the JAX
package's bench does on an accelerator) and the level, batch and screen
allow it, else from the wall-scan kernel and the resolve
(render/frame.py::paint_available: the JAX package's rule, so one config
takes the same pipeline in both).  With `use_item_pass_kernel=True` as
well, an eligible level's sprites and masked mids come from the
item-pass kernel, which draws every selected item (no item pool, no
item_capacity cap).  `tick` and `rollout` step the simulation; a
rollout renders every tick through the same pipeline.  `calibrate`
returns an engine whose pool capacities come from a census of the
states it is given (calibrate.py; on the card its wall scan runs the
wall-scan kernel).  `parallel.SplitEngine` runs these calls over a
batch split across devices.
The command-line shell (cli.py, viewer.py) drives this API.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from doomtpu_torch.assets.bundle import LevelAssets
from doomtpu_torch.config import CLOCK_HZ, RenderConfig
from doomtpu_torch.info import load_default_tables
from doomtpu_torch.info.tables import InfoTables
from doomtpu_torch.level.tables import MapTables
from doomtpu_torch.wad.reader import WadFile
from doomtpu_torch.render.camsort import sort_state, unsort_out
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.frame import render_frame, render_walls_planes
from doomtpu_torch.render.jmath import camera_trig
from doomtpu_torch.sim import player as player_mod
from doomtpu_torch.sim import step as step_mod
from doomtpu_torch.sim.state import GameState, state_from_numpy
from doomtpu_torch.sim.thinkers import ThinkerTables, draw_lights
from doomtpu_torch.trace import span


class Clock:
    """35 Hz tick derivation + 16-sample rolling FPS average
    (game.rs:47-92), copied from the JAX package's engine: `ticks` is
    the total CLOCK_HZ ticks elapsed since start, so the shell's evolve
    loop can run exactly the missed ticks (game.rs:469-483) instead of
    one tick per rendered frame."""

    def __init__(self, samples: int = 16):
        self.samples = samples
        self.list = [0.0] * samples
        self.index = 0
        self.rolling_sum = 0.0
        self.timestamp = 0.0
        self.ticks = 0

    def add_elapsed_interval(self, interval: float) -> None:
        self.timestamp += interval
        self.ticks = int(self.timestamp * CLOCK_HZ)   # game.rs:73
        self.rolling_sum -= self.list[self.index]
        self.rolling_sum += interval
        self.list[self.index] = interval
        self.index = (self.index + 1) % self.samples

    def fps(self) -> float:
        avg = self.rolling_sum / self.samples
        return 1.0 / avg if avg > 0 else 0.0


@dataclass(eq=False)
class DoomEngine:
    wad: WadFile
    tables: MapTables
    assets: LevelAssets
    info: InfoTables
    level: DeviceLevel
    thinkers: ThinkerTables
    config: RenderConfig
    device: torch.device
    turbo: float = 1.0

    @classmethod
    def from_wad_bytes(
        cls, data: bytes, map_name: str = "e1m1",
        config: RenderConfig | None = None, device="cuda",
        require_iwad: bool = False, turbo: float = 1.0,
    ) -> "DoomEngine":
        device = torch.device(device)
        wad = WadFile(data, require_iwad=require_iwad)
        info = load_default_tables()
        tables = MapTables.load(wad, map_name)
        assets = LevelAssets.load(wad, tables, info.sprite_names)
        return cls(
            wad=wad, tables=tables, assets=assets, info=info,
            level=DeviceLevel.build(tables, assets, info, device),
            thinkers=ThinkerTables.build(tables, info, device),
            config=config or RenderConfig(), device=device, turbo=turbo,
        )

    @classmethod
    def from_wad(cls, path: str, map_name: str = "e1m1", **kw) -> "DoomEngine":
        with open(path, "rb") as f:
            return cls.from_wad_bytes(f.read(), map_name, **kw)

    def new_game(self, batch: int = 1, pos=None, angle=None,
                 generator: torch.Generator | None = None) -> GameState:
        """B players at the start (or at `pos` [B, 2] / `angle` [B]) on
        the engine's device; light countdowns drawn from `generator`."""
        return GameState.initial(
            self.level, self.thinkers, batch, pos=pos, angle=angle,
            generator=generator,
        )

    def _render(self, state: GameState, items: bool):
        """(outputs, aux) of a render, cameras Morton-sorted when the
        batch is larger than 8 (aux stays in sorted order).  The call's
        one host round trip comes first, while the device's queue is
        empty: the angles' trig bundle, taken in caller order and
        gathered with the cameras."""
        trig = camera_trig(state.angle)
        perm = None
        if self.config.camera_sort and state.batch > 8:
            state, perm = sort_state(state)
            trig = trig.index_select(1, perm)
        args = (state.pos[:, 0], state.pos[:, 1], state.angle,
                state.floor_height, state.sector_light)
        if items:
            idx, rgb, aux = render_frame(
                self.level, self.config, *args, state.mobj_state,
                state.timestamp, trig=trig,
            )
        else:
            idx, rgb, aux = render_walls_planes(
                self.level, self.config, *args, state.timestamp, trig=trig,
            )
        out = (idx, rgb)
        if perm is not None:
            out = unsort_out(out, perm)
        return out, aux

    def render(self, state: GameState):
        """Full frame of any level -> (idx [B,H,W] with -1 = unwritten,
        rgb packed 0xRRGGBB [B,H,W])."""
        return self._render(state, items=True)[0]

    def render_counters(self, state: GameState) -> dict:
        """Summed capacity counters of a full render of any level:
        {overflow, live_dropped, items_dropped, item_overflow,
        item_block_dropped, live_stale}.  All 0 proves the configured
        capacities (mid / clip pools and paint_live_capacity on the
        paint path, the span pool on the scan path, the item pool,
        max_visible_mobjs) dropped nothing: the frame is exact."""
        _, aux = self._render(state, items=True)
        return {k: int(aux[k].sum()) for k in (
            "overflow", "live_dropped", "items_dropped", "item_overflow",
            "item_block_dropped", "live_stale")}

    def render_walls(self, state: GameState):
        """Walls/planes/sky only (no things) of any level -> (idx, rgb)."""
        return self._render(state, items=False)[0]

    def render_walls_counters(self, state: GameState) -> dict:
        """Summed capacity counters of a walls/planes render of any
        level: {overflow, live_dropped}.  All 0 proves the mid / clip
        pools and the live-seg cap (paint path) or the span pool (scan
        path) dropped nothing."""
        _, aux = self._render(state, items=False)
        return {k: int(aux[k].sum()) for k in ("overflow", "live_dropped")}

    # ---- the simulation ----------------------------------------------------
    def _controls(self, controls) -> torch.Tensor:
        if not isinstance(controls, torch.Tensor):
            controls = torch.as_tensor(np.asarray(controls, np.int32))
        return controls.to(self.device, torch.int32)

    def _generator(self, generator):
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        return generator

    def light_draws(self, batch: int, generator=None, ticks=None):
        """The light step's draws for `batch` cameras from `generator`
        (a new one seeded 0 when None): one tick's [2, B, SEC] i32, or
        with `ticks` T, [T, 2, B, SEC] drawn tick after tick as rollout
        draws them."""
        g = self._generator(generator)
        sec = self.level.num_sectors
        if ticks is None:
            return draw_lights(g, batch, sec).to(self.device)
        return torch.stack([draw_lights(g, batch, sec)
                            for _ in range(ticks)]).to(self.device)

    def tick(self, state: GameState, controls, generator=None,
             draws=None) -> GameState:
        """One 35 Hz tick of `controls` [B] (sim/player.py's bitmask).
        The light step's randomness: `draws` [2, B, SEC] i32 in [0, 2^30)
        (the JAX package's two randint draws of split(key)), else drawn
        from `generator` (on the engine's device; a new one seeded 0
        when None, so repeated calls draw the same)."""
        if draws is None:
            draws = self.light_draws(state.batch, generator)
        return step_mod.tick(self.level, self.thinkers, state,
                             self._controls(controls), draws.to(self.device),
                             self.turbo)

    def rollout(self, state: GameState, controls_seq, generator=None,
                draws=None, return_frames: bool = True,
                max_ticks_per_jit: int = 32, live_reuse: bool = False):
        """T ticks of step and render: `controls_seq` [T, B]; `draws`
        [T, 2, B, SEC] (tick t takes draws[t]), else each tick draws from
        `generator` (seeded 0 when None).  Returns (final state, frames
        [T, B, H, W] i32) or, with return_frames=False, [T, B] int64
        checksums (each frame's idx summed).

        live_reuse=True (the paint + deferred pipeline with per-camera
        live lists) renders the first tick of every segment of
        `max_ticks_per_jit` ticks (0: one segment) fresh and reuses its
        traversal order, camera permutation and kept live set for the
        rest of the segment (sim/step.rollout), and returns a third
        element, the summed live_stale: 0 proves the frames equal
        live_reuse=False's.  In the JAX package the segments are its
        jitted scans; here the argument is only the refresh interval,
        kept so that frames and live_stale equal JAX's engine.rollout
        for the same value.

        The call reads the device once, at its start: the trig of every
        tick's angle (player.tick_trig), which each segment's ticks and
        renders take their slices of."""
        controls_seq = self._controls(controls_seq)
        T = controls_seq.shape[0]
        trig = player_mod.tick_trig(state.angle, controls_seq, self.turbo)
        if draws is None:
            g = self._generator(generator)
            draw = lambda t: self.light_draws(state.batch, g)
        else:
            draws = torch.as_tensor(draws).to(self.device)
            draw = lambda t: draws[t]
        S = max_ticks_per_jit if 0 < max_ticks_per_jit < T else T
        outs = []
        stale = torch.zeros((), dtype=torch.int32, device=self.device)
        for s0 in range(0, T, S) if T else (0,):
            r = step_mod.rollout(
                self.level, self.thinkers, self.config, state,
                controls_seq[s0:s0 + S], lambda t, s0=s0: draw(s0 + t),
                return_frames=return_frames, live_reuse=live_reuse,
                turbo=self.turbo, trig=trig[s0:s0 + S])
            state = r[0]
            outs.append(r[1])
            if live_reuse:
                stale = stale + r[2]
        with span("doom.frames"):
            frames = torch.cat(outs)
        if live_reuse:
            return state, frames, stale
        return state, frames

    def kill_everything(self, state: GameState) -> GameState:
        return step_mod.kill_everything(self.level, state)

    def explode_everything(self, state: GameState) -> GameState:
        return step_mod.explode_everything(self.level, state)

    def respawn_everything(self, state: GameState) -> GameState:
        return step_mod.respawn_everything(self.level, state)

    def calibrate(self, states) -> "DoomEngine":
        """A copy of this engine whose pool capacities are measured from
        an uncapped census of `states` (a GameState or a list, on this
        engine's device), see calibrate.py.  Renders of exactly those
        states are then drop-free (every counter 0)."""
        from doomtpu_torch.calibrate import calibrated_config

        return replace(self, config=calibrated_config(self, states))

    # ---- state API ----------------------------------------------------------
    def player_position_json(self, state: GameState, env: int = 0) -> str:
        """Re-runnable --player-position JSON (game.rs:376-384)."""
        import json

        pos = state.pos[env].cpu()
        return json.dumps({
            "position": {"x": float(pos[0]), "y": float(pos[1])},
            "angle": float(state.angle[env]),
        })

    def save_state(self, state: GameState, path: str) -> None:
        """Checkpoint the full simulation state (every thinker counter,
        mobj state and camera) as npz, one array a GameState field under
        its name, as the JAX package saves it: a checkpoint of either
        package loads in the other."""
        np.savez(path, **{f.name: getattr(state, f.name).cpu().numpy()
                          for f in fields(state)})

    def load_state(self, path: str) -> GameState:
        """A GameState from `save_state`'s npz, on the engine's device."""
        with np.load(path) as data:
            return state_from_numpy(dict(data.items()), self.device)

    def map_2d(self, state: GameState, env: int = 0) -> np.ndarray:
        """The overhead map of camera `env`: [H, W, 3] u8 (game.rs:229-309)."""
        from doomtpu_torch.render.map2d import render_map_2d

        pos = state.pos[env].cpu()
        return render_map_2d(self.tables, self.config, float(pos[0]),
                             float(pos[1]), float(state.angle[env]))
