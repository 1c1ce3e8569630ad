"""examples/rl_rollout_torch.py, the port of examples/rl_rollout.py, run
on the CPU at B = 4 envs x T = 2 ticks: its frames are [2, 4, 200, 320]
and equal the port's engine.rollout on the same inputs (the toy policy,
generators seeded 0), and it prints the JAX example's three lines.

Tolerance: exact equality of the palette-index frames.
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.sim.player import KEY_LEFT, KEY_RIGHT, KEY_UP  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "rl_rollout_torch.py"


def test_rl_rollout_example_equals_engine_rollout(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location("rl_rollout_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setenv("B", "4")
    monkeypatch.setenv("T", "2")
    final, frames = example.main(["--device", "cpu"])
    assert frames.shape == (2, 4, 200, 320) and frames.device.type == "cpu"
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "rollout", "final positions (env 0)", "frames"]

    eng = DoomEngine.from_wad_bytes(synth.e1m1_scale_wad(), "e1m1",
                                    device="cpu")
    state = eng.new_game(4, generator=torch.Generator().manual_seed(0))
    turn = torch.tensor([KEY_LEFT, KEY_RIGHT] * 2, dtype=torch.int32)
    controls = (KEY_UP | turn)[None].expand(2, 4)
    want_final, want = eng.rollout(state, controls,
                                   torch.Generator().manual_seed(0))
    assert torch.equal(frames, want)
    assert torch.equal(final.pos, want_final.pos)
