"""The roofline arithmetic and what the benchmark may import."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import generate, roofline

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "doomtpu"}


@pytest.fixture(scope="module")
def lv():
    cfg = {"level": "e1m1_scale_wad", "map": "e1m1"}
    return roofline.level_bytes(generate.wad_bytes(cfg), "e1m1")


def test_level_bytes_of_the_e1m1_scale_level(lv):
    assert lv == roofline.LevelBytes(
        walls=65536, mids=4096, flats=36864, sprites=32808, palette=768,
        geometry=47106, sectors=130, mobjs=216)


def test_layer_counts_at_a_small_shape(lv):
    B, H, W = 4, 8, 16
    cam = 4 * (5 + 130)
    cam_items = 4 * (5 + 130 + 216)
    fixed = 65536 + 36864 + 768 + 47106
    assert roofline.paint_layer(B, H, W, lv) == roofline.Work(
        bytes=8 * B * H * W + fixed + B * cam, ops=B * H * W)
    # K2: the pixels items cover, the sprites and the mids only
    assert roofline.items_layer(B, 37, lv) == roofline.Work(
        bytes=8 * 37 + 32808 + 4096 + 768 + 47106 + B * cam_items, ops=37)
    # K4: the spans it hands on, 8 bytes each
    assert roofline.scan_layer(B, 90, lv) == roofline.Work(
        bytes=8 * 90 + 47106 + B * cam, ops=0)


W, H, B = 320, 200, 2          # the cells' screen


@pytest.fixture(scope="module")
def probed():
    """(probe counts, frame, walls-only frame) of one render on the CPU
    at the cells' screen, with the K2 and K4 metric files' probes."""
    import torch

    from doomtpu_torch import DoomEngine
    from doomtpu_torch.config import RenderConfig
    from portbench import manifest, tracing

    cfg = {"level": "e1m1_scale_wad", "map": "e1m1"}
    mix = manifest.read_json(manifest.traffic_path("render-spread"))
    mix.update(batch=B, chain=1)
    inputs = generate.generate(mix, 2**33 + 5, generate.level_tables(cfg))
    probes = {}
    for m in ("k2_items.roofline_pct", "k4_scan.roofline_pct"):
        probes.update(manifest.load_metric(m).PROBES)
    eng = DoomEngine.from_wad_bytes(
        generate.wad_bytes(cfg), "e1m1", device="cpu",
        config=RenderConfig(width=W, height=H, span_capacity=96,
                            item_capacity=32))
    st = eng.new_game(B, pos=inputs.pos, angle=inputs.angle,
                      generator=torch.Generator().manual_seed(1))
    with tracing.Probes(probes) as pr:
        idx, _ = eng.render(st)
    walls, _ = eng.render_walls(st)
    return pr.totals(), idx, walls


def test_items_probe_counts_the_pixels_items_cover(probed, lv):
    counts, idx, walls = probed
    written = counts["items_written_px"]
    drawn = int((idx != walls).sum())          # pixels items changed
    assert 0 < drawn <= written < B * H * W * 3 // 4
    assert roofline.items_layer(B, written, lv).bytes < 8 * B * H * W * 3 // 4


def test_scan_probe_counts_spans_not_pixels(probed, lv):
    spans = probed[0]["scan_spans"]
    assert B * W <= spans < B * H * W // 8      # some spans a column
    assert roofline.scan_layer(B, spans, lv).bytes < 4 * B * H * W // 2


def test_least_time_takes_the_larger_bound():
    w = roofline.Work(bytes=3.35e12, ops=0)
    assert w.least_s() == (1.0, "bytes")
    w = roofline.Work(bytes=0, ops=2 * 67e12)
    assert w.least_s() == (2.0, "operations")


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


# the CPU test that holds the reference to the JAX package; no run, no
# other test and no module of the harness imports it
WITNESS = PB / "tests" / "test_pb_witness.py"


def test_nothing_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        if path == WITNESS:
            continue
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in (PB / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "doomtpu_torch" not in tops, path
    code = ("import sys, pkgutil, importlib, portbench.reference as r\n"
            "for m in pkgutil.walk_packages(r.__path__, 'portbench.reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "import portbench.check, portbench.generate, portbench.roofline\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'doomtpu', 'doomtpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PB.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
