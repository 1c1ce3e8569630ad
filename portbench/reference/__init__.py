"""The benchmark's plain reference: the simulation tick and the full frame.

Two renderers, and the tick:

- `render`, batched: a frozen copy of the port's plain PyTorch paths
  (the versions it runs on CPU tensors, and the versions its CUDA
  kernels are tested against), cut to the one pipeline that every
  configuration's frame must equal: the camera stage, the seg rows, the
  wall scan, the resolve and shade, and the deferred item pass with its
  composite.  It runs on any device, plain PyTorch operations only, and
  gives the same bits on the CPU and on the card (render/jmath.py).
  Being a copy, it would share a fault the port already had when it was
  frozen; it cannot share one a later change brings.
- `render_scalar`, one camera at a time: the scalar NumPy transcription
  of the upstream renderer (spec.py), which shares no code path with the
  port.  With `reciprocal_constants` it takes a division by a constant
  as a multiply by the constant's f32 reciprocal, as the JAX package
  (under XLA) and the port compute it.  It is a witness, not part of
  the check: the JAX package, which the port follows, departs from the
  upstream renderer in a few pixels of some frames (witness.py measures
  where; PERF.md lists them).
- Both are held to the JAX package's batched renderer and its scalar
  one on the CPU (portbench/tests/test_pb_witness.py).
- `tick`: a frozen copy of the port's simulation, held to the JAX
  package's tick on the CPU (the same test file).

It decodes the WAD bytes itself, builds its own level, thinker and
state tables, and imports nothing of the port: a later change to the
program cannot move it.

Its pools are sized far above any peak the benchmark's levels reach
(`REFERENCE_POOLS`), and `render` raises if one of them still drops: a
drop would make the reference wrong, not the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.assets.bundle import LevelAssets
from portbench.reference.config import RenderConfig
from portbench.reference.info.tables import load_default_tables
from portbench.reference.level.tables import MapTables
from portbench.reference.ops.paint import LD_SKY, LD_WRITTEN
from portbench.reference.render import camera as cam
from portbench.reference.render import resolve as res
from portbench.reference.render import things, walls
from portbench.reference.render.device import DeviceLevel
from portbench.reference.render.jmath import I32
from portbench.reference.sim import player as player_mod
from portbench.reference.sim import thinkers as tk_mod
from portbench.reference.sim.state import GameState
from portbench.reference.sim.thinkers import ThinkerTables
from portbench.reference.spec import Player, SpecRenderer
from portbench.reference.wad.reader import WadFile

# every capacity of the scan pipeline and the deferred pass, uncapped or
# far above the e1m1-scale census peaks (span pool 60, item slots 20)
REFERENCE_POOLS = dict(span_capacity=192, item_capacity=64,
                       max_visible_mobjs=0, item_block_capacity=0)


class Reference:
    """The level of `wad_bytes` / `map_name` at a `width` x `height`
    screen on `device`."""

    def __init__(self, wad_bytes: bytes, map_name: str, width: int,
                 height: int, device="cpu"):
        self.device = torch.device(device)
        wad = WadFile(wad_bytes)
        info = load_default_tables()
        tables = MapTables.load(wad, map_name)
        assets = LevelAssets.load(wad, tables, info.sprite_names)
        self.level = DeviceLevel.build(tables, assets, info, self.device)
        self.thinkers = ThinkerTables.build(tables, info, self.device)
        self.config = RenderConfig(width=width, height=height,
                                   **REFERENCE_POOLS)
        self.spec = SpecRenderer(tables, assets, info, self.config,
                                 reciprocal_constants=True)
        self.mobj_pos = self.level.mobj_pos.cpu().numpy()
        self.mobj_angle = self.level.mobj_angle.cpu().numpy()

    def initial(self, pos, angle, generator: torch.Generator) -> GameState:
        """Spawn state of cameras at `pos` [B, 2] / `angle` [B], light
        countdowns drawn from `generator`."""
        return GameState.initial(self.level, self.thinkers, len(angle),
                                 pos=pos, angle=angle, generator=generator)

    def tick(self, state: GameState, controls, draws) -> GameState:
        """One 35 Hz tick: `controls` [B] i32 bitmask, `draws` [2, B, SEC]
        i32, the light step's randomness."""
        pos, angle, floor_h = player_mod.move_player(
            self.level, state.pos, state.angle,
            controls.to(self.device, I32))
        light, count, up = tk_mod.step_lights(
            self.thinkers, state.sector_light, state.light_count,
            state.light_up, draws.to(self.device))
        mstate, mtics = tk_mod.step_mobjs(self.level, state.mobj_state,
                                          state.mobj_tics)
        return GameState(pos=pos, angle=angle, floor_height=floor_h,
                         sector_light=light, light_count=count, light_up=up,
                         mobj_state=mstate, mobj_tics=mtics,
                         tick=state.tick + 1)

    def render(self, state: GameState):
        """(idx [B, H, W] palette indices, -1 unwritten; rgb [B, H, W]
        packed 0xRRGGBB) of the full frame: walls, planes, sky, sprites
        and masked mids."""
        level, cfg = self.level, self.config
        px, py = state.pos[:, 0], state.pos[:, 1]
        args = (px, py, state.angle, state.floor_height)
        frame = cam.build_seg_frame(level, cfg, *args, state.sector_light,
                                    state.timestamp)
        order = cam.seg_order(level, cam.traversal_rank(level, px, py))
        pool, cnt, overflow = walls.wall_scan(level, cfg, frame, order)
        idx, light, dist, is_sky = res.resolve_frame(level, cfg, frame,
                                                     pool, cnt, *args)
        rgb = res.shade(level, idx, light, dist, is_sky)
        ld = ((light << 16) | (dist & 0xFFFF)
              | ((idx >= 0).to(I32) * LD_WRITTEN) | (is_sky.to(I32) * LD_SKY))
        pools = things.pools_from_unified(pool, cnt, frame)
        idx, ld, rgb, daux = things.deferred_pass(
            level, cfg, frame, pools, order, *args, state.sector_light,
            state.mobj_state, idx, ld, rgb)
        drops = {"overflow": int(overflow.sum())}
        drops.update({k: int(v.sum()) for k, v in daux.items()
                      if k in ("items_dropped", "item_overflow",
                               "item_block_dropped")})
        if any(drops.values()):
            raise RuntimeError(f"the reference's pools dropped work: {drops}")
        return idx, rgb

    def render_scalar(self, state: GameState, b: int):
        """(idx [H, W], rgb [H, W] packed 0xRRGGBB) of camera `b` of
        `state` by the scalar renderer (spec.py), on the host."""
        h = {n: x[b].cpu().numpy()
             for n, x in (("pos", state.pos), ("angle", state.angle),
                          ("floor", state.floor_height),
                          ("light", state.sector_light),
                          ("mobj", state.mobj_state))}
        out = self.spec.render(
            Player(float(h["pos"][0]), float(h["pos"][1]),
                   float(h["angle"]), float(h["floor"])),
            sector_light=h["light"], mobj_pos=self.mobj_pos,
            mobj_angle=self.mobj_angle, mobj_state=h["mobj"],
            timestamp=float(state.timestamp[b]))
        c = out["rgb"].astype(np.int32)
        rgb = (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]
        return (torch.from_numpy(out["idx"].astype(np.int32)),
                torch.from_numpy(rgb))

