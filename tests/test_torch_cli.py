"""The port's shell (doomtpu_torch/cli.py, viewer.py) on the CPU
(--device cpu), the cases of tests/test_cli.py and tests/test_viewer.py:

- the headless .npy dump, equal to the engine's own frame after the same
  ticks; the player-position round trip; the missing-WAD exit code; an
  image --out without PIL fails naming .npy;
- the flag set is doomtpu.cli's plus --device;
- the viewer on SDL's dummy video output: frames, and the reference's
  missed-tick evolve (ticks = floor(elapsed * 35), not one per frame).
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from doomtpu_torch.cli import build_parser, main  # noqa: E402

SMALL = ["--width", "64", "--height", "48", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_headless_npy(tmp_path, capsys):
    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.sim.player import KEY_LEFT, KEY_UP
    from doomtpu_torch.wad import synth

    out = tmp_path / "frames.npy"
    rc = main(["--synth", "demo", "--batch", "2", "--steps", "3", "--walk",
               "--seed", "5", "--out", str(out)] + SMALL)
    assert rc == 0
    assert "wrote" in capsys.readouterr().out
    frames = np.load(out)
    assert frames.shape == (2, 48, 64) and frames.dtype == np.int32
    assert (frames != 0).any()
    # the dump is the last rendered frame: render, then tick, each step
    eng = DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", device="cpu",
                                    config=RenderConfig(width=64, height=48))
    gen = torch.Generator().manual_seed(5)
    state = eng.new_game(2, generator=gen)
    walk = torch.full((2,), KEY_UP | KEY_LEFT, dtype=torch.int32)
    for _ in range(2):
        state = eng.tick(state, walk, gen)
    np.testing.assert_array_equal(frames, eng.render(state)[1].numpy())


def test_cli_player_position_round_trip(capsys):
    spawn = {"position": {"x": 384.0, "y": 256.0}, "angle": 1.5}
    rc = main(["--synth", "demo", "--batch", "1", "--steps", "1",
               "--player-position", json.dumps(spawn),
               "--print-player-position"] + SMALL)
    assert rc == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("--player-position")][-1]
    echoed = json.loads(line.split("'", 1)[1].rstrip("'"))
    # one tick of standing still: x/y unchanged, angle preserved
    assert echoed["position"]["x"] == pytest.approx(384.0)
    assert echoed["position"]["y"] == pytest.approx(256.0)
    assert echoed["angle"] == pytest.approx(1.5, abs=1e-5)


def test_cli_missing_wad_exit_code(capsys):
    rc = main(["--wad", "/nonexistent/nowhere.wad", "--steps", "1",
               "--device", "cpu"])
    assert rc == 2
    assert "WAD not found" in capsys.readouterr().err


def test_cli_image_without_pil_names_npy(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)      # import fails
    rc = main(["--synth", "demo", "--steps", "1",
               "--out", str(tmp_path / "f.png")] + SMALL)
    assert rc == 2
    assert ".npy" in capsys.readouterr().err
    assert not (tmp_path / "f.png").exists()


def test_flag_set_is_jax_clis_plus_device():
    from doomtpu.cli import build_parser as jax_parser

    flags = lambda p: {s for a in p._actions for s in a.option_strings}
    assert flags(build_parser()) == flags(jax_parser()) | {"--device"}
    assert build_parser().parse_args([]).device == "cuda"


@pytest.fixture
def viewer_engine(monkeypatch):
    pytest.importorskip("pygame")
    from doomtpu_torch.config import RenderConfig
    from doomtpu_torch.engine import DoomEngine
    from doomtpu_torch.wad import synth

    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    return DoomEngine.from_wad_bytes(synth.demo_wad(), "e1m1", device="cpu",
                                     config=RenderConfig(width=64, height=48))


def test_viewer_headless_frames(viewer_engine):
    import pygame

    from doomtpu_torch.viewer import run_viewer

    state = viewer_engine.new_game(1)
    assert run_viewer(viewer_engine, state, scale=1, max_frames=2) == 0
    pygame.quit()


def test_viewer_missed_tick_evolve(viewer_engine, monkeypatch):
    """Frame intervals 0.1, 0.005, 0.005, 0.05, 0.04 s: 3 ticks on the
    slow first frame, none on the fast ones, then 2 and 2 (game.rs:73:
    ticks = floor(total elapsed * 35) = 7)."""
    import pygame

    from doomtpu_torch.config import CLOCK_HZ
    from doomtpu_torch.viewer import run_viewer

    intervals = [0.1, 0.005, 0.005, 0.05, 0.04]
    calls = {"i": 0, "t": 0.0}

    def fake_time():
        # called at a frame's start and end: only the end call advances
        if calls["i"] % 2 == 1:
            calls["t"] += intervals[calls["i"] // 2]
        calls["i"] += 1
        return calls["t"]

    ticks = []
    real_tick = viewer_engine.tick
    monkeypatch.setattr(viewer_engine, "tick", lambda state, controls, gen:
                        ticks.append(1) or real_tick(state, controls, gen))
    state = viewer_engine.new_game(1)
    rc = run_viewer(viewer_engine, state, scale=1,
                    max_frames=len(intervals), time_fn=fake_time)
    assert rc == 0
    assert len(ticks) == 7 == int(sum(intervals) * CLOCK_HZ)
    pygame.quit()
