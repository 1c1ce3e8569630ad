"""The port's own copies of the host layers (config, wad, level, assets,
info with its table generator, render/map2d, utils) against the JAX
package's modules they were copied from, and the port's native picture
decoder against the NumPy decode.

For the demo, e1m1-scale and doom1-asset-scale fixtures: the same WAD
bytes from synth, the same MapTables and LevelAssets (every field), the
same info tables, and the same overhead maps; the same generated tables
module from a multigen sample; the same saturating casts and truncating
division at the type bounds.  Tolerance: exact equality of every value,
shape and dtype.
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


def test_fixed_helpers_equal_jax():
    """utils/fixed.py: the saturating casts, truncating / and %, and the
    wrap idiom of the port (its NumPy branch and its torch branch) equal
    the JAX package's on the same NumPy inputs, at the type bounds."""
    import torch

    from doomtpu.utils import fixed as jfixed
    from doomtpu_torch.utils import fixed

    f = np.array([-1e10, -2147483649.0, -32769.5, -32768.0, -32767.9, -2.5,
                  -0.5, 0.0, 0.7, 2.5, 32766.9, 32767.0, 32768.0, 1e10,
                  np.inf, -np.inf])
    i = np.array([-(1 << 31), -70000, -32769, -32768, -7, -1, 0, 1, 7,
                  32767, 32768, 70000, (1 << 31) - 1], np.int64)
    for fn in ("as_i16", "as_i32"):
        for x in (f, f.astype(np.float32), i, i.astype(np.int32)):
            if fn == "as_i32" and x.dtype == np.float32:
                continue    # 2^31 - 1 is not an f32: no bound to saturate at
            want = getattr(jfixed, fn)(x)
            got = getattr(fixed, fn)(x)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, fn)
            t = getattr(fixed, fn)(torch.from_numpy(x))
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), want, f"{fn} (torch)")
    np.testing.assert_array_equal(
        fixed.as_int_sat(f, np.int8, np.int16),
        jfixed.as_int_sat(f, np.int8, np.int16))
    assert fixed.as_int_sat(torch.from_numpy(f), np.int8,
                            np.int16).dtype == torch.int16
    a = np.array([-(1 << 30), -129, -128, -7, -1, 0, 1, 7, 128, 1 << 30],
                 np.int32)
    for b in (np.int32(3), np.int32(-3), np.int32(64), np.int32(-128)):
        for fn in ("div_trunc", "rem_trunc", "wrap_texcoord"):
            if fn == "wrap_texcoord" and b < 0:
                continue
            want = getattr(jfixed, fn)(a, b)
            np.testing.assert_array_equal(getattr(fixed, fn)(a, b), want, fn)
            got = getattr(fixed, fn)(torch.from_numpy(a), int(b))
            np.testing.assert_array_equal(got.numpy(), want, f"{fn} (torch)")
    assert fixed.div_trunc(-7, 2) == jfixed.div_trunc(-7, 2) == -3
    import doomtpu_torch.utils as utils

    assert utils.fixed is fixed


def test_table_generator_equals_jax(tmp_path):
    """info/multigen.py and info/gen_tables.py: the port's parse and
    generated module equal the JAX package's on tests/test_info.py's
    sample, text for text; the command line writes that module."""
    from doomtpu.info.gen_tables import generate as jgenerate
    from doomtpu.info.multigen import parse_multigen as jparse
    from doomtpu_torch.info import gen_tables
    from doomtpu_torch.info.multigen import parse_multigen
    from test_info import SAMPLE

    got, want = parse_multigen(SAMPLE), jparse(SAMPLE)
    assert repr(got.states) == repr(want.states)
    assert [(m.name, m.fields) for m in got.mobjs] == [
        (m.name, m.fields) for m in want.mobjs]
    assert got.sprite_names == want.sprite_names
    code = gen_tables.generate(SAMPLE)
    assert code == jgenerate(SAMPLE)
    src, out = tmp_path / "multigen.txt", tmp_path / "_tables.py"
    src.write_text(SAMPLE)
    gen_tables.main([str(src), "-o", str(out)])
    assert out.read_text() == code
    ns = {}
    exec(code, ns)
    assert ns["STATE_NAMES"] == ["S_NULL", "S_SPIN1", "S_SPIN2"]


def test_table_generator_on_the_full_data_file(tmp_path):
    """The port's copy of the multigen data file is the JAX package's,
    byte for byte, and the port's generator on it gives the committed
    doomtpu_torch/info/_tables.py and the JAX generator's text."""
    from pathlib import Path

    from doomtpu.info.gen_tables import generate as jgenerate
    from doomtpu_torch.info import gen_tables

    root = Path(__file__).resolve().parents[1]
    data = root / "doomtpu_torch" / "info" / "multigen.txt"
    assert data.read_bytes() == (
        root / "doomtpu" / "info" / "multigen.txt").read_bytes()
    out = tmp_path / "_tables.py"
    gen_tables.main([str(data), "-o", str(out)])
    code = out.read_text()
    assert code == (root / "doomtpu_torch" / "info" / "_tables.py").read_text()
    assert code == jgenerate(data.read_text())


def _picture_lumps(wad):
    """Every picture lump of a WAD: its patches (PNAMES) and sprites."""
    from doomtpu_torch.assets.textures import TextureStore

    store = TextureStore(wad)
    return [(n, wad.lump(n)) for n in store.pnames if wad.has(n)] + [
        (e.name, wad.lump_at(e)) for e in wad.sprite_entries()
        if wad.lump_at(e).size > 8]


def test_native_decoder_equals_numpy(monkeypatch):
    """ops/native.py: the port's own decoder (csrc/doomdec.cpp, built
    here with the host C++ compiler) decodes every picture of the demo,
    e1m1-scale, doom1-asset-scale and decoder WADs as the NumPy decode
    does, and assets/pictures.py gives the same Picture either way."""
    from doomtpu_torch.assets import pictures
    from doomtpu_torch.ops import build, native

    if build.cxx_path() is None:
        pytest.skip("no C++ compiler")
    native.build()
    assert native.available()
    assert str(build.host_library_path("doomdec")).startswith(
        str(build.BUILD_DIR))
    n = 0
    for wad_fn in ("demo_wad", "e1m1_scale_wad", "doom1_scale_wad",
                   "decoder_wad"):
        lumps = _picture_lumps(WadFile(getattr(synth, wad_fn)()))
        assert lumps, wad_fn
        fast = [pictures.decode_picture(raw, name) for name, raw in lumps]
        with monkeypatch.context() as m:
            m.setattr(native, "decode_picture", lambda *a: None)
            slow = [pictures.decode_picture(raw, name) for name, raw in lumps]
        for (name, raw), a, b in zip(lumps, fast, slow):
            out = native.decode_picture(raw, b.width, b.height)
            assert out is not None, (wad_fn, name)
            np.testing.assert_array_equal(out[0], b.pixels, name)
            np.testing.assert_array_equal(out[1], b.mask, name)
            _assert_same(a, b, f"{wad_fn} {name}")
            n += 1
    assert n > 50
    # a malformed lump: the native decode refuses it
    assert native.decode_picture(np.zeros(4, np.uint8), 3, 3) is None


def test_native_loader_looks_once(monkeypatch):
    """ops/native.py: with no library built, the first decode looks for
    it and later ones do not (the path is hashed once a process), so
    every decode goes the NumPy way; build() looks again."""
    from doomtpu_torch.assets import pictures
    from doomtpu_torch.ops import build, native

    looked = []

    def missing(name):
        looked.append(name)
        return build.BUILD_DIR / "libdoomdec-missing.so"

    monkeypatch.setattr(build, "host_library_path", missing)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    lumps = _picture_lumps(WadFile(synth.demo_wad()))[:3]
    for name, raw in lumps:
        assert native.decode_picture(raw, 4, 4) is None
        assert pictures.decode_picture(raw, name).pixels.ndim == 2
    assert not native.available()
    assert looked == ["doomdec"]

