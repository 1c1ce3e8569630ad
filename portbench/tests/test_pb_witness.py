"""Witnesses of the reference that share no code with the port, on the
CPU, at the cells' screen: the JAX package, whose frames and ticks the
port is built to reproduce bit for bit, and the scalar transcription of
the upstream renderer.  The reference's batched renderer and its tick
are frozen copies of the port's plain paths, so a fault the port had
when they were copied would be theirs too; these tests hold them to code
the port was not copied from.  The JAX package is imported here only,
never by the benchmark (test_pb_yardstick.py walks its imports).

Where the JAX package itself departs from the upstream renderer (PERF.md
lists what portbench/witness.py finds), the port follows the JAX
package, and so does the reference."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import check, generate, manifest
from portbench.reference import Reference

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

B, W, H = 8, 320, 200                 # the cells' screen
LEVELS = ["e1m1_scale_wad", "e1m1_scale_masked_wad"]


@pytest.fixture(scope="module", autouse=True)
def strict_fp():
    """The JAX package's strict-FP mode (f32 products rounded, host
    trig), in which it equals the upstream renderer's bits."""
    from doomtpu.render import jmath

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jmath.set_strict_fp(True)
    yield
    jmath.set_strict_fp(False)
    jax.config.update("jax_enable_x64", x64)


@pytest.fixture(scope="module", params=LEVELS)
def walked(request):
    """(wad, the reference, its states over three walking ticks, the JAX
    package's engine and its states over the same ticks and draws)."""
    from doomtpu.config import RenderConfig as JaxConfig
    from doomtpu.engine import DoomEngine as JaxEngine
    from doomtpu.sim.state import GameState as JaxState

    cfg = {"level": request.param, "map": "e1m1"}
    wad = generate.wad_bytes(cfg)
    mix = manifest.read_json(manifest.traffic_path("rollout-walk"))
    mix.update(batch=B, ticks=3, hold=1)
    inputs = generate.generate(mix, 2**32 + 901, generate.level_tables(cfg))
    ref = Reference(wad, "e1m1", W, H, "cpu")
    je = JaxEngine.from_wad_bytes(wad, "e1m1", config=JaxConfig(
        width=W, height=H, span_capacity=96, item_capacity=32))
    rs = ref.initial(inputs.pos, inputs.angle,
                     torch.Generator().manual_seed(inputs.light_seed))
    js = JaxState(**{f.name: jnp.asarray(getattr(rs, f.name).numpy())
                     for f in dataclasses.fields(JaxState)})
    sectors = int(rs.sector_light.shape[1])
    states = [(rs, js)]
    for t in range(3):
        key = jax.random.PRNGKey(40 + t)
        draws = np.stack([np.asarray(jax.random.randint(
            k, (B, sectors), 0, 1 << 30, dtype=jnp.int32))
            for k in jax.random.split(key)])
        c = inputs.controls[t]
        rs = ref.tick(rs, torch.as_tensor(c), torch.from_numpy(draws))
        js = je.tick(js, jnp.asarray(c), key)
        states.append((rs, js))
    return wad, ref, je, states, inputs


def test_ticks_equal_the_jax_packages(walked):
    _, _, _, states, inputs = walked
    assert inputs.controls[:3].any()
    assert check.state_diff(check.host_state(states[0][0]),
                            check.host_state(states[-1][0])) > 0
    for rs, js in states:
        for f in check.STATE_FIELDS:
            np.testing.assert_array_equal(getattr(rs, f).numpy(),
                                          np.asarray(getattr(js, f)), f)


def test_scalar_renderer_is_the_jax_packages_oracle(walked):
    """The reference's copy of spec.py, on the reference's own tables and
    dividing by constants as the upstream renderer does, draws what the
    JAX package's spec.py draws on the JAX package's."""
    from doomtpu.assets.bundle import LevelAssets
    from doomtpu.config import RenderConfig as JaxConfig
    from doomtpu.info import load_default_tables
    from doomtpu.level.tables import MapTables
    from doomtpu.render.spec import Player, SpecRenderer
    from doomtpu.wad.reader import WadFile

    wad, ref, _, states, _ = walked
    info = load_default_tables()
    mt = MapTables.load(WadFile(wad), "E1M1")
    spec = SpecRenderer(mt, LevelAssets.load(WadFile(wad), mt,
                                             info.sprite_names),
                        info, JaxConfig(width=W, height=H))
    rs, _ = states[-1]
    ref.spec.reciprocal_constants = False
    try:
        ours = [ref.render_scalar(rs, b) for b in (0, 5)]
    finally:
        ref.spec.reciprocal_constants = True
    for b, (idx, rgb) in zip((0, 5), ours):
        out = spec.render(
            Player(float(rs.pos[b, 0]), float(rs.pos[b, 1]),
                   float(rs.angle[b]), float(rs.floor_height[b])),
            sector_light=rs.sector_light[b].numpy(),
            mobj_pos=ref.mobj_pos, mobj_angle=ref.mobj_angle,
            mobj_state=rs.mobj_state[b].numpy(),
            timestamp=float(rs.timestamp[b]))
        np.testing.assert_array_equal(idx.numpy(), out["idx"])
        c = out["rgb"].astype(np.int32)
        np.testing.assert_array_equal(
            rgb.numpy(), (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2])


def test_frames_equal_the_jax_packages(walked):
    """Every camera after the walking ticks: walls, planes, sky, sprites
    and masked mids, the batched reference against the JAX package's
    batched renderer."""
    _, ref, je, states, _ = walked
    rs, js = states[-1]
    idx, rgb = ref.render(rs)
    jidx, jrgb = je.render(js)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
