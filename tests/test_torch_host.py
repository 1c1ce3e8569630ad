"""The port's own copies of the host layers (config, wad, level, assets,
info, render/map2d) against the JAX package's modules they were copied
from.

For the demo, e1m1-scale and doom1-asset-scale fixtures: the same WAD
bytes from synth, the same MapTables and LevelAssets (every field), the
same info tables, and the same overhead maps.  Tolerance: exact equality
of every value, shape and dtype.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from doomtpu import config as jconfig  # noqa: E402
from doomtpu.assets.bundle import LevelAssets as JaxAssets  # noqa: E402
from doomtpu.info import load_default_tables as jax_info  # noqa: E402
from doomtpu.level.tables import MapTables as JaxTables  # noqa: E402
from doomtpu.wad import synth as jsynth  # noqa: E402
from doomtpu.wad.reader import WadFile as JaxWad  # noqa: E402
from doomtpu_torch import config  # noqa: E402
from doomtpu_torch.assets.bundle import LevelAssets  # noqa: E402
from doomtpu_torch.info import load_default_tables  # noqa: E402
from doomtpu_torch.level.tables import MapTables  # noqa: E402
from doomtpu_torch.wad import synth  # noqa: E402
from doomtpu_torch.wad.reader import WadFile  # noqa: E402


def _assert_same(a, b, where):
    """Field-by-field equality of two dataclass instances."""
    assert [f.name for f in dataclasses.fields(a)] == [
        f.name for f in dataclasses.fields(b)], where
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), (where, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape, (where, f.name)
            np.testing.assert_array_equal(x, y, f"{where}.{f.name}")
        else:
            assert x == y, (where, f.name)


@pytest.mark.parametrize(
    "wad_fn", ["demo_wad", "e1m1_scale_wad", "doom1_scale_wad"])
def test_host_layers_equal_jax_packages(wad_fn):
    wad = getattr(synth, wad_fn)()
    assert wad == getattr(jsynth, wad_fn)()
    info, jinfo = load_default_tables(), jax_info()
    t = MapTables.load(WadFile(wad), "e1m1")
    jt = JaxTables.load(JaxWad(wad), "e1m1")
    _assert_same(t, jt, "MapTables")
    a = LevelAssets.load(WadFile(wad), t, info.sprite_names)
    ja = JaxAssets.load(JaxWad(wad), jt, jinfo.sprite_names)
    _assert_same(a, ja, "LevelAssets")
    assert a.spr_pixels.shape[0] > 0 and a.spr_mask.any()


def test_info_tables_and_config_equal_jax():
    _assert_same(load_default_tables(), jax_info(), "InfoTables")
    _assert_same(config.RenderConfig(), jconfig.RenderConfig(), "RenderConfig")
    for name in ("ASPECT_RATIO_CORRECTION", "PLAYER_EYE_HEIGHT", "CLOCK_HZ",
                 "SKY_TEXTURE_WIDTH", "SKY_TEXTURE_HEIGHT", "FLAT_SIZE"):
        assert getattr(config, name) == getattr(jconfig, name), name


@pytest.mark.parametrize(
    "wad_fn", ["demo_wad", "e1m1_scale_wad", "doom1_scale_wad"])
def test_map2d_equals_jax(wad_fn):
    """render_map_2d of the port's copy against the JAX package's, at
    two screens and three poses (one off the map)."""
    from doomtpu.render.map2d import render_map_2d as jax_map
    from doomtpu_torch.render.map2d import render_map_2d

    wad = getattr(synth, wad_fn)()
    t, jt = MapTables.load(WadFile(wad), "e1m1"), JaxTables.load(
        JaxWad(wad), "e1m1")
    left, right, top, bottom = [float(v) for v in t.bbox]
    poses = [((left + right) / 2, (top + bottom) / 2, 0.7),
             (left + 1.5, bottom - 2.25, 3.9), (right + 500.0, top, -1.0)]
    for w, h in ((320, 200), (64, 48)):
        cfg = config.RenderConfig(width=w, height=h)
        jcfg = jconfig.RenderConfig(width=w, height=h)
        for x, y, a in poses:
            got = render_map_2d(t, cfg, x, y, a)
            assert got.dtype == np.uint8 and got.shape == (h, w, 3)
            np.testing.assert_array_equal(got, jax_map(jt, jcfg, x, y, a))
            assert got.any()


def test_color_helpers_equal_jax():
    """utils/color.py, copied: unpack_rgb and pack_rgb of the port and of
    the JAX package on the same packed and unpacked arrays."""
    from doomtpu.utils import color as jcolor
    from doomtpu_torch.utils import color

    rng = np.random.default_rng(0)
    packed = rng.integers(0, 1 << 24, (3, 5, 7), dtype=np.int32)
    rgb = color.unpack_rgb(packed)
    assert rgb.dtype == np.uint8 and rgb.shape == (3, 5, 7, 3)
    np.testing.assert_array_equal(rgb, jcolor.unpack_rgb(packed))
    back = color.pack_rgb(rgb)
    np.testing.assert_array_equal(back, jcolor.pack_rgb(rgb))
    np.testing.assert_array_equal(back, packed)
