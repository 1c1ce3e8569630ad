"""DoomEngine: the port's user-facing API.

    engine = DoomEngine.from_wad("doom1.wad", "e1m1",     # on the card
                                 config=RenderConfig(use_pallas_paint=True))
    state = engine.new_game(batch=2048, generator=torch.Generator("cuda"))
    idx, rgb = engine.render(state)                  # [B, H, W]

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
item_capacity cap).  The simulation and calibration come with later
slices and raise NotImplementedError until then.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from doomtpu_torch.assets.bundle import LevelAssets
from doomtpu_torch.config import RenderConfig
from doomtpu_torch.info import load_default_tables
from doomtpu_torch.info.tables import InfoTables
from doomtpu_torch.level.tables import MapTables
from doomtpu_torch.wad.reader import WadFile
from doomtpu_torch.render.camsort import sort_state, unsort_out
from doomtpu_torch.render.device import DeviceLevel
from doomtpu_torch.render.frame import render_frame, render_walls_planes
from doomtpu_torch.sim.state import GameState
from doomtpu_torch.sim.thinkers import ThinkerTables


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

    @classmethod
    def from_wad_bytes(
        cls, data: bytes, map_name: str = "e1m1",
        config: RenderConfig | None = None, device="cuda",
        require_iwad: bool = False,
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
            config=config or RenderConfig(), device=device,
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
        batch is larger than 8 (aux stays in sorted order)."""
        perm = None
        if self.config.camera_sort and state.batch > 8:
            state, perm = sort_state(state)
        args = (state.pos[:, 0], state.pos[:, 1], state.angle,
                state.floor_height, state.sector_light)
        if items:
            idx, rgb, aux = render_frame(
                self.level, self.config, *args, state.mobj_state,
                state.timestamp,
            )
        else:
            idx, rgb, aux = render_walls_planes(
                self.level, self.config, *args, state.timestamp,
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

    def tick(self, state: GameState, controls, generator=None):
        raise NotImplementedError("the simulation is not ported yet")

    def rollout(self, state: GameState, controls_seq, generator=None):
        raise NotImplementedError("the simulation is not ported yet")

    def calibrate(self, states):
        raise NotImplementedError("calibration is not ported yet")
