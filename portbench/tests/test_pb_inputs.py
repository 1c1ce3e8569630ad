"""The frozen inputs: the level builder's bytes and the generator."""

import numpy as np
import pytest

from portbench import generate, manifest
from portbench.inputs import synth as frozen

MIXES = ["rollout-walk", "render-spread"]


def small(mix: str) -> dict:
    t = manifest.read_json(manifest.traffic_path(mix))
    t["batch"] = 16
    return t


def test_frozen_level_is_todays_builder():
    from doomtpu_torch.wad import synth

    assert frozen.e1m1_scale_wad() == synth.e1m1_scale_wad()


@pytest.fixture(scope="module")
def tables():
    return generate.level_tables({"level": "e1m1_scale_wad", "map": "e1m1"})


@pytest.mark.parametrize("mix", MIXES)
def test_generator_repeats_for_a_seed(mix, tables):
    a = generate.generate(small(mix), 2**33 + 5, tables)
    b = generate.generate(small(mix), 2**33 + 5, tables)
    for f in ("pos", "angle", "controls", "draws"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.light_seed, a.check_seed) == (b.light_seed, b.check_seed)


@pytest.mark.parametrize("mix", MIXES)
def test_generator_differs_across_seeds(mix, tables):
    a = generate.generate(small(mix), 11, tables)
    b = generate.generate(small(mix), 12, tables)
    assert not np.array_equal(a.pos, b.pos)
    assert not np.array_equal(a.draws, b.draws)
    assert a.light_seed != b.light_seed and a.check_seed != b.check_seed
    if mix == "rollout-walk":
        assert not np.array_equal(a.controls, b.controls)


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_deals_the_same_sets(mix, tables):
    """Poses and action sequences: one set, another order a seed."""
    a = generate.generate(small(mix), 11, tables)
    b = generate.generate(small(mix), 2**40 + 3, tables)
    key = lambda inp: sorted(zip(inp.pos[:, 0], inp.pos[:, 1], inp.angle))
    assert key(a) == key(b)
    seqs = lambda inp: sorted(map(tuple, inp.controls.T))
    assert seqs(a) == seqs(b)


def test_poses_lie_in_open_sectors(tables):
    inp = generate.generate(small("render-spread"), 3, tables)
    for (x, y) in inp.pos:
        s = tables.sector_at(float(x), float(y))
        assert s >= 0 and tables.sector_floor_h[s] < tables.sector_ceil_h[s]
    assert np.all((inp.angle >= 0) & (inp.angle < 2 * np.pi))


def test_walking_actions_hold_for_their_ticks(tables):
    inp = generate.generate(small("rollout-walk"), 9, tables)
    c, hold = inp.controls, small("rollout-walk")["hold"]
    assert c.shape == (32, 16)
    assert set(np.unique(c)) <= set(generate.action_masks(small("rollout-walk")))
    for t0 in range(0, 32, hold):
        assert (c[t0:t0 + hold] == c[t0]).all()
    assert len(np.unique(c)) > 2


def test_render_chain_is_zero_controls(tables):
    inp = generate.generate(small("render-spread"), 9, tables)
    assert inp.controls.shape == (7, 16) and not inp.controls.any()
    assert inp.draws.shape[:3] == (7, 2, 16)
