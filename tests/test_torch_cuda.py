"""Tests that need a CUDA card: the paint kernel against its plain
PyTorch version, and the slice on the card against the slice on the CPU.

This file imports no JAX, so it also runs where there is a card and no
JAX; the repo's conftest imports JAX, so leave it out there:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test skips.  Tolerance: exact equality on every
output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from doomtpu.wad import synth  # noqa: E402
from doomtpu_torch.engine import DoomEngine  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.render import camera as cam  # noqa: E402

pytestmark = pytest.mark.cuda

# the demo views of tests/test_paint.py
VIEWS = [
    (384.0, 256.0, 0.0),
    (900.0, 256.0, 2.5),
    (300.0, 700.0, 4.6),
    (384.0, 256.0, 3.1),
]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the paint kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def engines(cuda):
    wad = synth.demo_wad()
    return (DoomEngine.from_wad_bytes(wad, "e1m1", device=cuda),
            DoomEngine.from_wad_bytes(wad, "e1m1", device="cpu"))


def _state(eng, pos, ang):
    return eng.new_game(len(ang), pos=pos, angle=ang,
                        generator=torch.Generator(eng.device).manual_seed(0))


def _outputs(out) -> dict:
    named = {k: out[k] for k in (
        "idx", "ld", "rgb", "cnt_mid", "cnt_clip", "overflow")}
    for name in ("midpool", "clippool"):
        for i, p in enumerate(out[name]):
            named[f"{name}{i}"] = p
    return named


def test_paint_kernel_equals_plain_version(engines):
    eng, _ = engines
    views = VIEWS * 2
    st = _state(eng, np.asarray([v[:2] for v in views], np.float32),
                np.asarray([v[2] for v in views], np.float32))
    px, py = st.pos[:, 0], st.pos[:, 1]
    frame = cam.build_seg_frame(eng.level, eng.config, px, py, st.angle,
                                st.floor_height, st.sector_light,
                                st.timestamp)
    order = cam.seg_order(eng.level, cam.traversal_rank(eng.level, px, py))
    args = tp.build_inputs(eng.level, eng.config, frame, order, st.angle,
                           px, py, st.floor_height)
    before = tp.paint.launches
    got = _outputs(tp.paint(eng.level, eng.config, *args))
    torch.cuda.synchronize()
    assert tp.paint.launches == before + 1
    want = _outputs(tp.paint_reference(eng.level, eng.config, *args))
    for k, v in got.items():
        assert v.is_cuda, k
        assert torch.equal(v, want[k]), k


def test_render_walls_on_card_equals_cpu(engines):
    """B=16 spread poses, so the camera sort runs."""
    gpu, cpu = engines
    rng = np.random.default_rng(0)
    t = cpu.tables
    left, right, top, bottom = [float(v) for v in t.bbox]
    poses = []
    while len(poses) < 16:
        x, y = rng.uniform(left, right), rng.uniform(top, bottom)
        s = t.sector_at(x, y)
        if s >= 0 and t.sector_floor_h[s] < t.sector_ceil_h[s]:
            poses.append((x, y, rng.uniform(0, 2 * np.pi)))
    pos = np.asarray([p[:2] for p in poses], np.float32)
    ang = np.asarray([p[2] for p in poses], np.float32)
    before = tp.paint.launches
    idx, rgb = gpu.render_walls(_state(gpu, pos, ang))
    torch.cuda.synchronize()
    assert tp.paint.launches > before
    assert idx.is_cuda and rgb.is_cuda
    idx_c, rgb_c = cpu.render_walls(_state(cpu, pos, ang))
    assert torch.equal(idx.cpu(), idx_c)
    assert torch.equal(rgb.cpu(), rgb_c)
    assert gpu.render_walls_counters(_state(gpu, pos, ang)) == {
        "overflow": 0, "live_dropped": 0}
