"""The port's level tables against the JAX DeviceLevel, and the port's
independence from JAX.

Tolerance: exact equality of every field (values, shapes, and dtypes
where both sides keep one).
"""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from doomtpu.render.device import DeviceLevel as JaxLevel  # noqa: E402
from doomtpu.sim.thinkers import ThinkerTables as JaxThinkers  # noqa: E402
from doomtpu_torch.render.device import (  # noqa: E402
    DeviceLevel, level_from_numpy,
)
from doomtpu_torch.sim.thinkers import ThinkerTables  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def levels(demo_level):
    t, a, info = demo_level.tables, demo_level.assets, demo_level.info
    return JaxLevel.build(t, a, info), DeviceLevel.build(t, a, info, "cpu")


def _jax_fields(jl) -> dict:
    """The JAX level's arrays by port field name, as level_from_numpy
    takes them; its sky texture id stands in for the port's sky table."""
    names = DeviceLevel.tensor_fields() + DeviceLevel.STATIC_FIELDS
    out = {n: (getattr(jl, n) if n in DeviceLevel.STATIC_FIELDS
               else np.asarray(getattr(jl, n)))
           for n in names if hasattr(jl, n)}
    out["sky_tex"] = int(np.asarray(jl.sky_tex))   # a JAX array there
    out["spr_pixels"] = np.asarray(jl.spr_pixels)
    return out


def test_build_equals_jax_field_by_field(levels):
    jl, tl = levels
    fields = _jax_fields(jl)
    # every port field but the port's own unpacked sky table has a JAX twin
    assert set(DeviceLevel.tensor_fields()) - set(fields) == {"sky_pixels"}
    # the item pass's tables are among them
    assert {"spr_table", "state_sprite", "mobj_pos", "mobj_sector",
            "dseg_ix", "atlas_cm"} <= set(fields)
    assert tl.spr_pw == fields["spr_pixels"].shape[2]
    assert tl.col_spr_off == jl.col_spr_off
    # the scan + resolve pipeline's static fields
    assert {"sky_tex", "sky_is_opaque", "wall_tex_all_opaque"} <= set(fields)
    del fields["spr_pixels"]
    for name, want in fields.items():
        got = getattr(tl, name)
        if name in DeviceLevel.STATIC_FIELDS:
            assert got == want, name
            continue
        got = got.numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype), name)
    assert tl.paint_ok and tl.sky_is_opaque and tl.wall_tex_all_opaque


def test_sky_table_matches_the_packed_sky(levels):
    """sky_pixels[r, c] is byte r % 4 of the JAX kernel's packed sky_q
    word [r // 4, c] (its 4-rows-per-word TPU packing)."""
    jl, tl = levels
    q = np.asarray(jl.sky_q).astype(np.int64) & 0xFFFFFFFF
    r = np.arange(128)[:, None]
    unpacked = (q[r // 4, np.arange(256)[None]] >> ((r % 4) * 8)) & 0xFF
    np.testing.assert_array_equal(tl.sky_pixels.numpy(), unpacked)


def test_level_from_numpy_round_trips(levels):
    jl, tl = levels
    from_jax = level_from_numpy(_jax_fields(jl), "cpu")
    again = level_from_numpy(
        {n: (getattr(tl, n) if n in DeviceLevel.STATIC_FIELDS
             else getattr(tl, n).numpy())
         for n in DeviceLevel.tensor_fields() + DeviceLevel.STATIC_FIELDS},
        "cpu",
    )
    for lv in (from_jax, again):
        for n in DeviceLevel.tensor_fields():
            a, b = getattr(lv, n), getattr(tl, n)
            assert a.dtype == b.dtype and a.device == b.device, n
            assert torch.equal(a, b), n
        for n in DeviceLevel.STATIC_FIELDS:
            assert getattr(lv, n) == getattr(tl, n), n


def test_thinker_tables_equal_jax(demo_level):
    t, info = demo_level.tables, demo_level.info
    jt, tt = JaxThinkers.build(t, info), ThinkerTables.build(t, info, "cpu")
    for n in ("kind", "min_light", "max_light", "dark_time", "bright_time",
              "min_time", "max_time", "sync"):
        np.testing.assert_array_equal(getattr(tt, n).numpy(),
                                      np.asarray(getattr(jt, n)), n)
    np.testing.assert_array_equal(tt.player_start_pos, jt.player_start_pos)
    assert tt.player_start_angle == jt.player_start_angle


def _imports_jax(path: Path) -> list[str]:
    return _bad_imports(path.read_text(), str(path.relative_to(ROOT)))


def _bad_imports(source: str, name: str) -> list[str]:
    """Imports in `source` whose top-level module is jax, jaxlib or the
    JAX package doomtpu."""
    bad = []
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            if m.split(".")[0] in ("jax", "jaxlib", "doomtpu"):
                bad.append(f"{name}:{node.lineno} {m}")
    return bad


def test_port_never_imports_jax():
    """Static scan (every process here has jax preloaded, so a runtime
    sys.modules check would prove nothing): no module of the port, nor
    chip_smoke.py, the card-only tests or their fixtures, imports jax,
    jaxlib or any module of the JAX package doomtpu, not even a
    host-only one."""
    files = sorted((ROOT / "doomtpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
              ROOT / "tests" / "torch_fixtures.py"]
    assert len(files) > 10
    bad = [b for f in files for b in _imports_jax(f)]
    assert not bad, bad
    # the scan sees the forms it must reject, and only those
    probe = ("import jaxlib\nfrom doomtpu.wad import synth\n"
             "from doomtpu import config\nimport doomtpu_torch\n"
             "from doomtpu_torch.wad import synth\n")
    assert len(_bad_imports(probe, "probe")) == 3
