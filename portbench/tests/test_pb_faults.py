"""A run, less its look for a card, on the CPU at a small size: sound, it
comes out correct; with the timed path broken underneath in each way a
cell can break, it comes out not correct."""

import time

import pytest

from portbench import cell as cell_mod
from portbench import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


def small(name: str) -> manifest.Cell:
    c = manifest.cell(name)
    c.config["render"].update(width=48, height=24)
    c.traffic.update(batch=4, ticks=2, chain=3)
    # every frame of the small window is compared
    c.traffic["check"]["frames"] = 8 if c.traffic["kind"] == "rollout" else 4
    return c


def run(name: str) -> dict:
    return cell_mod.run(small(name), 2**31 + 99, 0.0, False, "cpu",
                        time.time())


def _frozen_tick(level, tkt, state, controls, draws, turbo=1.0):
    return state                  # a step that returns its state unchanged


def _halved(render_frame):
    """Renders the first half of the batch and hands it out twice."""
    def half(level, cfg, px, py, angle, floor_height, sector_light,
             mobj_state, timestamp, **kw):
        h = px.shape[0] // 2
        part = lambda x: x[:h].repeat((2,) + (1,) * (x.dim() - 1))
        idx, rgb, aux = render_frame(
            level, cfg, *(part(x) for x in (px, py, angle, floor_height,
                                            sector_light, mobj_state,
                                            timestamp)), **kw)
        return idx, rgb, aux
    return half


def _altered(render_frame):
    """Changes one pixel of every frame where the frame is made."""
    def altered(*args, **kw):
        idx, rgb, aux = render_frame(*args, **kw)
        idx[:, 3, 5] += 1
        rgb[:, 3, 5] ^= 1
        return idx, rgb, aux
    return altered


def _patch_render(monkeypatch, wrap):
    import doomtpu_torch.engine as engine
    import doomtpu_torch.sim.step as step

    for mod in (engine, step):
        monkeypatch.setattr(mod, "render_frame", wrap(mod.render_frame))


@pytest.fixture(autouse=True)
def _no_calibration_cache(monkeypatch):
    monkeypatch.setenv("DOOMTPU_CALIB_CACHE", "0")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checked"]
    assert all(v["value"] == 0 for v in r["checked"].values())
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", CELLS)
def test_frozen_step_is_not_correct(name, monkeypatch):
    import doomtpu_torch.sim.step as step

    monkeypatch.setattr(step, "tick", _frozen_tick)
    r = run(name)
    assert not r["correct"]
    assert r["checked"]["state_elems_differing"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_is_not_correct(name, monkeypatch):
    _patch_render(monkeypatch, _halved)
    r = run(name)
    assert not r["correct"]
    assert r["checked"]["idx_px_differing"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_not_correct(name, monkeypatch):
    _patch_render(monkeypatch, _altered)
    r = run(name)
    assert not r["correct"]
    assert r["checked"]["idx_px_differing"]["value"] > 0


def test_undersized_pools_are_not_correct():
    """Pools set below the census's peaks, not calibrated: the program
    drops work, and capacity_drops reads it."""
    c = small("e1m1-paint.render-spread")
    c.config["calibrate"] = False
    c.config["render"].update(item_capacity=1, clip_capacity=8,
                              mid_capacity=8)
    r = cell_mod.run(c, 2**31 + 99, 0.0, False, "cpu", time.time())
    assert not r["correct"]
    assert r["checked"]["capacity_drops"]["value"] > 0
