"""The plain reference (portbench/reference) against doomtpu_torch on the
CPU at small sizes: two walking ticks, then the full frame (walls,
planes, sky, sprites and masked mids) through each pipeline."""

import pytest
import torch

from portbench import check, generate, manifest
from portbench.reference import Reference

W, H, B = 64, 40, 8
LEVELS = ["e1m1_scale_wad", "e1m1_scale_masked_wad"]


def port_engine(wad, paint: bool):
    from doomtpu_torch import DoomEngine
    from doomtpu_torch.config import RenderConfig

    cfg = RenderConfig(width=W, height=H, use_pallas_paint=paint,
                       paint_percam_compact=paint, span_capacity=96,
                       mid_capacity=32, clip_capacity=48, item_capacity=32)
    return DoomEngine.from_wad_bytes(wad, "e1m1", config=cfg, device="cpu")


@pytest.fixture(scope="module", params=LEVELS)
def walked(request):
    """(wad, inputs, the reference's and the port's states after two
    walking ticks)."""
    cfg = {"level": request.param, "map": "e1m1"}
    wad = generate.wad_bytes(cfg)
    mix = manifest.read_json(manifest.traffic_path("rollout-walk"))
    mix.update(batch=B, ticks=2, hold=1)
    inputs = generate.generate(mix, 2**32 + 77, generate.level_tables(cfg))
    ref = Reference(wad, "e1m1", W, H, "cpu")
    eng = port_engine(wad, paint=False)
    rs = ref.initial(inputs.pos, inputs.angle,
                     torch.Generator().manual_seed(inputs.light_seed))
    ps = eng.new_game(B, pos=inputs.pos, angle=inputs.angle,
                      generator=torch.Generator().manual_seed(inputs.light_seed))
    states = [(check.host_state(rs), check.host_state(ps))]
    for t in range(2):
        c = torch.as_tensor(inputs.controls[t])
        d = torch.as_tensor(inputs.draws[t])
        rs, ps = ref.tick(rs, c, d), eng.tick(ps, c, draws=d)
        states.append((check.host_state(rs), check.host_state(ps)))
    return wad, inputs, ref, rs, ps, states


def test_walking_ticks_equal_the_port(walked):
    _, inputs, _, _, _, states = walked
    assert inputs.controls[:2].any()
    moved = check.state_diff(states[0][0], states[2][0])
    assert moved > 0
    for r, p in states:
        assert check.state_diff(r, p) == 0


@pytest.mark.parametrize("paint", [True, False], ids=["paint", "scan"])
def test_frames_equal_the_port(walked, paint):
    from doomtpu_torch.render import frame

    wad, _, ref, rs, ps, _ = walked
    eng = port_engine(wad, paint)
    if paint and not frame.paint_available(eng.level, eng.config, B):
        pytest.skip("the level takes the scan pipeline only")
    idx, rgb = eng.render(ps)
    assert eng.render_counters(ps) == dict.fromkeys(
        ("overflow", "live_dropped", "items_dropped", "item_overflow",
         "item_block_dropped", "live_stale"), 0)
    ridx, rrgb = ref.render(rs)
    assert torch.equal(idx, ridx) and torch.equal(rgb, rrgb)
    walls, _ = eng.render_walls(ps)
    assert int((walls != ridx).sum()) > 0        # sprites and mids drawn
