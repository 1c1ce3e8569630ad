"""The paint stage: the port's plain PyTorch version against the JAX
paint kernel (the CUDA kernel against the plain version is in
tests/test_torch_cuda.py).

The JAX side runs its Pallas kernel in interpret mode on the CPU
(strict FP, unroll=1/gsub=2 as tests/test_paint.py does), once, in a
module fixture.  Both sides take the same poses on the demo fixture at
B=4 and build their inputs from them.  Tolerance: exact equality on
every output (idx, ld, rgb, both pools, both counts, overflow).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from doomtpu.render import camera as jcam  # noqa: E402
from doomtpu.render.device import DeviceLevel as JaxLevel  # noqa: E402
from doomtpu_torch.ops import paint as tp  # noqa: E402
from doomtpu_torch.render import camera as tcam  # noqa: E402
from doomtpu_torch.render.device import DeviceLevel  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VIEWS = [
    (384.0, 256.0, 0.0),
    (900.0, 256.0, 2.5),
    (300.0, 700.0, 4.6),
    (384.0, 256.0, 3.1),
]


def _poses(t, views):
    B = len(views)
    return (
        np.asarray([v[0] for v in views], np.float32),
        np.asarray([v[1] for v in views], np.float32),
        np.asarray([v[2] for v in views], np.float32),
        np.asarray([float(t.sector_floor_h[t.sector_at(v[0], v[1])])
                    for v in views], np.float32),
        np.repeat(np.asarray(t.sector_light, np.int32)[None], B, 0),
        np.full(B, 0.4, np.float32),
    )


def _port_inputs(level, cfg, poses, device="cpu"):
    px, py, pa, fh, sl, ts = (torch.from_numpy(p).to(device) for p in poses)
    frame = tcam.build_seg_frame(level, cfg, px, py, pa, fh, sl, ts)
    order = tcam.seg_order(level, tcam.traversal_rank(level, px, py))
    return frame, order, (pa, px, py, fh)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _outputs(out) -> dict:
    """Every paint output as numpy, by name (pools plane by plane)."""
    named = {k: _np(out[k]) for k in (
        "idx", "ld", "rgb", "cnt_mid", "cnt_clip", "overflow")}
    for name in ("midpool", "clippool"):
        for i, p in enumerate(out[name]):
            named[f"{name}{i}"] = _np(p)
    return named


@pytest.fixture(scope="module")
def setup(demo_level):
    t, a, info = demo_level.tables, demo_level.assets, demo_level.info
    return (JaxLevel.build(t, a, info), DeviceLevel.build(t, a, info, "cpu"),
            _poses(t, VIEWS))


@pytest.fixture(scope="module")
def jax_paint(setup, config):
    from doomtpu.ops.pallas_paint import render_paint

    jl, _, (px, py, pa, fh, sl, ts) = setup
    px, py, pa, fh, sl, ts = map(jnp.asarray, (px, py, pa, fh, sl, ts))
    frame = jcam.build_seg_frame(jl, config, px, py, pa, fh, sl, ts)
    order = jcam.seg_order(jl, jcam.traversal_rank(jl, px, py))
    out = render_paint(jl, config, frame, order, pa, px, py, fh,
                       interpret=True, unroll=1, gsub=2)
    return _outputs(out)


def test_plain_paint_equals_jax_kernel(setup, config, jax_paint):
    _, tl, poses = setup
    frame, order, cam_args = _port_inputs(tl, config, poses)
    out = tp.render_paint(tl, config, frame, order, *cam_args)
    got = _outputs(out)
    assert set(got) == set(jax_paint)
    for k, want in jax_paint.items():
        assert got[k].shape == want.shape, k
        np.testing.assert_array_equal(got[k], want, k)
    assert int(out["live_dropped"]) == 0 and int(out["live_stale"]) == 0
    # the fixture's views exercise every output kind
    assert (got["idx"] >= 0).mean() > 0.99
    assert got["cnt_clip"].max() > 0 and got["cnt_mid"].max() > 0


def test_wrapper_takes_plain_version_on_cpu_only(setup, config):
    _, tl, poses = setup
    frame, order, (pa, px, py, fh) = _port_inputs(tl, config, poses)
    args = tp.build_inputs(tl, config, frame, order, pa, px, py, fh)
    before = tp.paint.launches
    a = _outputs(tp.paint(tl, config, *args))
    b = _outputs(tp.paint_reference(tl, config, *args))
    assert tp.paint.launches == before        # no kernel launched on CPU
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError):
        tp.paint(tl, config, *meta)            # level on cpu, inputs on meta
    with pytest.raises(ValueError):
        tp.paint(tl, config, args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError):            # a drop mask of another shape
        tp.paint(tl, config, *args, drop=torch.zeros(len(VIEWS), 1,
                                                     dtype=torch.int32))
    with pytest.raises(ValueError):            # drop bits for 32 blocks only
        tp.render_paint(tl, dataclasses.replace(
            config, width=4104, paint_live_capacity=16), frame, order,
            pa, px, py, fh)



def test_paint_tile_fits_every_height():
    """The paint kernel's tile (ops/paint.paint_tile): at every height up
    to 1200 rows, at least one column whose frame (six bytes a pixel),
    seg list, terms and jobs fit the shared memory a Hopper block may
    use, within the block's threads; 32 columns at the bench's 200
    rows."""
    assert tp.SMEM_BLOCK_BYTES == 227 * 1024
    for H in range(1, 1201):
        tc, bands = tp.paint_tile(H)
        assert tc >= 1 and bands >= 1, H
        assert 6 * H * tc < tp.paint_smem_bytes(tc, bands, H), H
        assert tp.paint_smem_bytes(tc, bands, H) <= tp.SMEM_BLOCK_BYTES, H
        assert tc * bands <= tp.MAX_BLOCK_THREADS, H
        assert tp.LIVE_BLOCK % tc == 0, H     # no tile straddles two blocks
    assert tp.paint_tile(200)[0] >= 32
