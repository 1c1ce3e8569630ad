#!/usr/bin/env python
"""Batched RL-environment workload on the PyTorch / CUDA port: B Doom
cameras stepping and rendering in lockstep on one card.

The port of examples/rl_rollout.py: each of T steps is a 35 Hz game
tick (sector-light thinkers, map-object state machines, player
movement) followed by a full frame render of every env, and the frames
stay on the card unless you ask for them.

    python examples/rl_rollout_torch.py                 # 256 envs x 32 ticks
    B=2048 T=64 python examples/rl_rollout_torch.py     # production shapes
    python examples/rl_rollout_torch.py --device cpu    # or DEVICE=cpu

On a host with several cards, split the env axis over them
(doomtpu_torch/parallel):

    from doomtpu_torch.parallel import SplitEngine
    se = SplitEngine(engine, ["cuda:0", "cuda:1"])
    final_state, out = se.rollout(se.shard(state), controls_seq, ...)
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from doomtpu_torch.engine import DoomEngine
from doomtpu_torch.sim.player import KEY_LEFT, KEY_RIGHT, KEY_UP
from doomtpu_torch.wad import synth


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=os.environ.get("DEVICE", "cuda"),
                    help="torch device (default cuda; DEVICE=cpu or "
                         "--device cpu runs the kernels' plain versions)")
    device = torch.device(ap.parse_args(argv).device)
    B = int(os.environ.get("B", 256))
    T = int(os.environ.get("T", 32))

    # any IWAD works (DoomEngine.from_wad("doom1.wad", "e1m1")); the
    # synthetic e1m1-scale level needs no game files
    engine = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                       device=device)
    state = engine.new_game(
        B, generator=torch.Generator(device).manual_seed(0))

    # a toy policy: every env walks forward, half turn left, half right
    turn = torch.where(torch.arange(B) % 2 == 0, KEY_LEFT, KEY_RIGHT)
    controls_seq = (KEY_UP | turn)[None].expand(T, B).to(torch.int32)

    t0 = time.time()
    # live_reuse=True (the paint pipeline with per-camera live lists,
    # RenderConfig(use_pallas_paint=True, paint_percam_compact=True))
    # reuses each segment's first-tick traversal order and live set for
    # the rest of the segment and returns a staleness counter: 0 proves
    # the frames equal those of the recompute-every-tick path; assert it
    # like the drop counters:
    #   final_state, out, stale = engine.rollout(..., live_reuse=True)
    #   assert int(stale) == 0
    final_state, out = engine.rollout(
        state, controls_seq, torch.Generator(device).manual_seed(0),
        # True: frames [T, B, H, W] stay on the device (mind its memory
        # at scale); False: per-step checksums [T, B] (frames still
        # rendered)
        return_frames=(B * T <= 1 << 14),
    )
    out.sum().item()    # waits for the device
    dt = time.time() - t0

    print(f"rollout: B={B} envs x T={T} ticks in {dt:.2f}s "
          f"({B * T / dt:,.0f} step+render frames/sec, on {device})")
    print(f"final positions (env 0): "
          f"{engine.player_position_json(final_state)}")
    # observations for an RL loop: palette-index frames + game state
    if out.ndim == 4:
        print(f"frames: {tuple(out.shape)} palette indices, "
              f"{(out[-1, 0] >= 0).float().mean().item() * 100:.0f}% "
              f"written")
    return final_state, out


if __name__ == "__main__":
    main()
