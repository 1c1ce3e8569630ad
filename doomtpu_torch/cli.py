"""Command-line shell of the port, mirroring the reference binary's flags
(main.rs:29-54) plus headless / batch extensions: doomtpu/cli.py's flags,
and --device.

Reference flags:
    --map        map name (default e1m1)
    --wad        WAD file path (default doom1.wad)
    --turbo      movement speed percent (default 100)
    --print-fps  print rolling-average FPS per frame
    --print-player-position   print the re-runnable --player-position JSON
    --player-position '<json>'  spawn the camera at a given pose

Extensions (batch workflow):
    --synth demo|two|single   use a built-in synthetic IWAD (no WAD needed)
    --batch N     number of parallel cameras/environments
    --steps N     headless: run N ticks then exit
    --out PATH    write the final frame (env 0) as PNG (needs PIL), or the
                  batch's packed rgb as a .npy dump
    --walk        headless demo controls (walk forward, turning)
    --map-view    render the 2D overhead map instead of the 3D view
    --viewer      interactive pygame window (if pygame is installed)
    --device      where the engine runs: cuda (default) or cpu

    python -m doomtpu_torch.cli --synth demo --walk --steps 35 --out f.npy
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="doomtpu_torch", description=__doc__)
    ap.add_argument("-m", "--map", default="e1m1")
    ap.add_argument("-w", "--wad", default="doom1.wad")
    ap.add_argument("-t", "--turbo", type=int, default=100)
    ap.add_argument("--print-fps", action="store_true")
    ap.add_argument("--print-player-position", action="store_true")
    ap.add_argument("--player-position", default=None)
    ap.add_argument("--synth", choices=["demo", "two", "single"], default=None)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=35)
    ap.add_argument("--out", default=None)
    ap.add_argument("--walk", action="store_true")
    ap.add_argument("--map-view", action="store_true")
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import Clock, DoomEngine
    from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP

    if args.out and not args.out.endswith(".npy"):
        try:
            import PIL  # noqa: F401
        except ImportError:
            print(f"--out {args.out}: writing an image needs PIL, which is "
                  "not installed; name a .npy file instead", file=sys.stderr)
            return 2
    cfg = RenderConfig(width=args.width, height=args.height)
    kw = dict(config=cfg, turbo=args.turbo / 100.0, device=args.device)
    if args.synth:
        from doomtpu_torch.wad import synth

        data = {
            "demo": synth.demo_wad, "two": synth.two_room_wad,
            "single": synth.single_room_wad,
        }[args.synth]()
        engine = DoomEngine.from_wad_bytes(data, args.map, **kw)
    else:
        try:
            engine = DoomEngine.from_wad(args.wad, args.map,
                                         require_iwad=True, **kw)
        except FileNotFoundError:
            print(
                f"WAD not found: {args.wad}; use --synth demo for the "
                "built-in level", file=sys.stderr,
            )
            return 2

    gen = torch.Generator(engine.device).manual_seed(args.seed)
    pos = angle = None
    if args.player_position:
        op = json.loads(args.player_position)
        pos = np.tile(
            [[op["position"]["x"], op["position"]["y"]]], (args.batch, 1)
        )
        angle = np.full(args.batch, op["angle"], np.float32)
    state = engine.new_game(args.batch, pos=pos, angle=angle, generator=gen)

    if args.viewer:
        from doomtpu_torch.viewer import run_viewer

        return run_viewer(engine, state, print_fps=args.print_fps)

    controls = torch.zeros(args.batch, dtype=torch.int32)
    if args.walk:
        controls = torch.full((args.batch,), KEY_UP | KEY_LEFT,
                              dtype=torch.int32)

    clock = Clock()
    rgb = None
    for _ in range(args.steps):
        t0 = time.time()
        _, rgb = engine.render(state)
        if rgb.is_cuda:
            torch.cuda.synchronize(rgb.device)
        state = engine.tick(state, controls, gen)
        clock.add_elapsed_interval(time.time() - t0)
        if args.print_fps:
            print(f"FPS {clock.fps() * args.batch:.1f}")
        if args.print_player_position:
            print(f"--player-position '{engine.player_position_json(state)}'")

    if args.out:
        if args.out.endswith(".npy"):
            np.save(args.out, rgb.cpu().numpy())
        else:
            from PIL import Image

            if args.map_view:
                img = engine.map_2d(state)
            else:
                from doomtpu_torch.utils.color import unpack_rgb

                img = unpack_rgb(rgb[0].cpu())
            Image.fromarray(img).save(args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
