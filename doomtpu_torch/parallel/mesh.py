"""Split the camera / environment batch over devices.

Counterpart of doomtpu/parallel/mesh.py.  Every camera is independent,
so the batch splits into contiguous shards, one a device, and each
shard renders and steps on its own device against a copy of the level
there, with no traffic between devices.  JAX places the shards on a
mesh and GSPMD partitions one program over them; PyTorch has no
partitioner, so a `SplitEngine` runs an engine's calls shard by shard,
each on its device with its own camera sort, and returns outputs in
camera order (on the first shard's device) and counters summed.  The
engine itself knows nothing of splits.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from doomtpu_torch.sim.state import GameState


def _indexed(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without an index gets
    the current one, so `cuda` and `cuda:0` name the same card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices=None) -> list[torch.device]:
    """The devices a batch splits over: `devices` (names or
    torch.devices; one may repeat), else every CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return devices


@dataclass(eq=False)
class SplitState:
    """A GameState split into contiguous shards of cameras, shard i on
    its own device; the cameras of shard i precede those of shard i+1."""
    shards: list[GameState]

    @property
    def batch(self) -> int:
        return sum(s.batch for s in self.shards)

    def pieces(self):
        """(slice of the whole batch, shard) per shard, in order."""
        b0 = 0
        for s in self.shards:
            yield slice(b0, b0 + s.batch), s
            b0 += s.batch

    def gather(self) -> GameState:
        """The whole state on the first shard's device."""
        dev = self.shards[0].device
        return GameState(**{
            f.name: torch.cat([getattr(s, f.name).to(dev)
                               for s in self.shards])
            for f in fields(GameState)
        })


def shard_batch(state: GameState, mesh: list[torch.device]) -> SplitState:
    """Split `state`'s cameras into len(mesh) contiguous shards, shard i
    moved to mesh[i].  The batch must divide by the device count."""
    S, B = len(mesh), state.batch
    if B % S:
        raise ValueError(f"shard_batch: batch {B} does not divide into "
                         f"{S} shards")
    n = B // S
    return SplitState([state.map(lambda x, i=i, d=d: x[i * n:(i + 1) * n]
                                 .to(d))
                       for i, d in enumerate(mesh)])


def replicate(tables, device):
    """A copy of a dataclass of tensors (DeviceLevel, ThinkerTables) with
    every tensor on `device`; other fields are shared."""
    return replace(tables, **{
        f.name: getattr(tables, f.name).to(device) for f in fields(tables)
        if isinstance(getattr(tables, f.name), torch.Tensor)
    })


class SplitEngine:
    """`engine`'s render / counters / tick / rollout over a batch split
    across `mesh`.  Each device of the mesh gets one engine: `engine`
    itself on its own device, else a copy whose level and thinker tables
    live there (made once, here).  Calls take a SplitState (`shard`
    makes one) and run each shard on its device's engine."""

    def __init__(self, engine, mesh):
        self.engine = engine
        self.mesh = make_mesh(mesh)
        home = _indexed(engine.level.device)
        self.engines = {}
        for d in self.mesh:
            if d not in self.engines:
                self.engines[d] = engine if d == home else replace(
                    engine, level=replicate(engine.level, d),
                    thinkers=replicate(engine.thinkers, d), device=d)

    def shard(self, state: GameState) -> SplitState:
        return shard_batch(state, self.mesh)

    def _each(self, split: SplitState, call) -> list:
        """call(engine of the shard's device, batch slice, shard) for
        every shard, in camera order."""
        return [call(self.engines[_indexed(s.device)], sl, s)
                for sl, s in split.pieces()]

    def render(self, split: SplitState):
        return _gather(self._each(split, lambda e, sl, s: e.render(s)))

    def render_walls(self, split: SplitState):
        return _gather(self._each(split, lambda e, sl, s: e.render_walls(s)))

    def render_counters(self, split: SplitState) -> dict:
        return _summed(self._each(
            split, lambda e, sl, s: e.render_counters(s)))

    def render_walls_counters(self, split: SplitState) -> dict:
        return _summed(self._each(
            split, lambda e, sl, s: e.render_walls_counters(s)))

    def tick(self, split: SplitState, controls, generator=None,
             draws=None) -> SplitState:
        """engine.tick on every shard, with the controls and light draws
        of its cameras (drawn for the whole batch as engine.tick draws
        them)."""
        if draws is None:
            draws = self.engine.light_draws(split.batch, generator)
        controls = _as_tensor(controls)
        return SplitState(self._each(split, lambda e, sl, s: e.tick(
            s, controls[sl], draws=draws[:, sl])))

    def rollout(self, split: SplitState, controls_seq, generator=None,
                draws=None, return_frames: bool = True,
                max_ticks_per_jit: int = 32, live_reuse: bool = False):
        """engine.rollout on every shard, each with its own camera sort
        and reuse metadata; the draws are those of the unsplit rollout.
        The final state stays split; frames [T, B, ...] (or checksums)
        and live_stale come back on the first shard's device."""
        controls_seq = _as_tensor(controls_seq)
        if draws is None:
            draws = self.engine.light_draws(split.batch, generator,
                                            ticks=controls_seq.shape[0])
        draws = _as_tensor(draws)
        outs = self._each(split, lambda e, sl, s: e.rollout(
            s, controls_seq[:, sl], draws=draws[:, :, sl],
            return_frames=return_frames, max_ticks_per_jit=max_ticks_per_jit,
            live_reuse=live_reuse))
        final = SplitState([o[0] for o in outs])
        (frames,) = _gather([o[1:2] for o in outs], dim=1)
        if live_reuse:
            return final, frames, sum(o[2].to(frames.device) for o in outs)
        return final, frames


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.int32))


def _gather(outs: list, dim: int = 0) -> tuple:
    """Per-shard output tuples -> one tuple in camera order, on the first
    shard's device."""
    dev = outs[0][0].device
    return tuple(torch.cat([o[i].to(dev) for o in outs], dim)
                 for i in range(len(outs[0])))


def _summed(counters: list[dict]) -> dict:
    """Per-shard counter dicts, summed."""
    return {k: sum(c[k] for c in counters) for k in counters[0]}
