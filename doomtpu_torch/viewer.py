"""Interactive viewer (optional; needs pygame), doomtpu/viewer.py on the
port's engine.

Feature parity with the reference's SDL shell (game.rs:392-454):
arrows move/rotate, Alt strafes, Shift runs, Tab toggles the 2D map,
K/X/R kill/explode/respawn everything, Q/Escape quits.
"""

from __future__ import annotations

import sys
import time


def run_viewer(engine, state, print_fps: bool = False, scale: int = 3,
               max_frames: int | None = None, time_fn=time.time) -> int:
    """max_frames bounds the loop (headless testing on SDL's dummy video);
    None = run until quit, like the reference's main_loop.

    Simulation advances on the reference's fixed 35 Hz clock: each
    frame, the elapsed wall time is added to the Clock and exactly the
    MISSED ticks are run (game.rs:469-483) — simulation speed is
    independent of frame rate.  `time_fn` is injectable so tests can
    drive the loop with simulated frame intervals.  The light step draws
    from one generator on the engine's device, seeded 123."""
    try:
        import pygame
    except ImportError:
        print("viewer requires pygame (pip install pygame)", file=sys.stderr)
        return 3

    import torch

    from doomtpu_torch.engine import Clock
    from doomtpu_torch.sim.player import (
        KEY_ALT, KEY_DOWN, KEY_LEFT, KEY_RIGHT, KEY_SHIFT, KEY_UP,
    )
    from doomtpu_torch.utils.color import unpack_rgb

    cfg = engine.config
    pygame.init()
    screen = pygame.display.set_mode((cfg.width * scale, cfg.height * scale))
    pygame.display.set_caption("doomtpu_torch")
    clock = Clock()
    viewing_map = False
    gen = torch.Generator(engine.device).manual_seed(123)
    frame_i = 0
    last_tick_processed = 0

    while True:
        t0 = time_fn()
        for ev in pygame.event.get():
            if ev.type == pygame.QUIT:
                return 0
            if ev.type == pygame.KEYDOWN:
                if ev.key in (pygame.K_q, pygame.K_ESCAPE):
                    return 0
                if ev.key == pygame.K_TAB:
                    viewing_map = not viewing_map
                if ev.key == pygame.K_k:
                    state = engine.kill_everything(state)
                if ev.key == pygame.K_x:
                    state = engine.explode_everything(state)
                if ev.key == pygame.K_r:
                    state = engine.respawn_everything(state)

        pressed = pygame.key.get_pressed()
        c = 0
        if pressed[pygame.K_UP]:
            c |= KEY_UP
        if pressed[pygame.K_DOWN]:
            c |= KEY_DOWN
        if pressed[pygame.K_LEFT]:
            c |= KEY_LEFT
        if pressed[pygame.K_RIGHT]:
            c |= KEY_RIGHT
        if pressed[pygame.K_LALT] or pressed[pygame.K_RALT]:
            c |= KEY_ALT
        if pressed[pygame.K_LSHIFT] or pressed[pygame.K_RSHIFT]:
            c |= KEY_SHIFT

        if viewing_map:
            img = engine.map_2d(state)
        else:
            _, rgb = engine.render(state)
            img = unpack_rgb(rgb[0].cpu())
        surf = pygame.surfarray.make_surface(img.swapaxes(0, 1))
        surf = pygame.transform.scale(
            surf, (cfg.width * scale, cfg.height * scale)
        )
        screen.blit(surf, (0, 0))
        pygame.display.flip()

        # evolve (game.rs:469-483): run exactly the ticks the elapsed
        # wall time implies — none on a fast frame, several on a slow one
        frame_i += 1
        clock.add_elapsed_interval(time_fn() - t0)
        if print_fps:
            print(f"FPS {clock.fps():.1f}")
        controls = torch.full((state.batch,), c, dtype=torch.int32)
        for _ in range(clock.ticks - last_tick_processed):
            state = engine.tick(state, controls, gen)
        last_tick_processed = clock.ticks
        if max_frames is not None and frame_i >= max_frames:
            return 0
