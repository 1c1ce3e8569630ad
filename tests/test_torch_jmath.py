"""doomtpu_torch.render.jmath against doomtpu.render.jmath.

Both sides run on the CPU on the same seeded numpy inputs; the JAX side
in the strict-FP mode tests/conftest.py sets (f64 products rounded to
f32, host-libm trig).  Tolerance: exact equality everywhere, bit for bit
on floats, since strict FP makes both sides IEEE per op.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from doomtpu.config import ASPECT_RATIO_CORRECTION  # noqa: E402
from doomtpu.render import jmath as jm  # noqa: E402
from doomtpu_torch.render import jmath as tm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small tensors, several test workers at once: torch's intra-op
    # threads only contend (the port's tests run twice as fast on one)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _floats(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 7, n)
    x = x.astype(np.float32)
    x[:8] = [np.nan, np.inf, -np.inf, 32767.9, -32768.9, 2.0 ** 31,
             -(2.0 ** 31) - 4096, -0.0]
    return x


def _same_bits(a, b):
    """Bit equality; a NaN only has to be a NaN (payloads differ between
    backends and carry no meaning here)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        keep = ~np.isnan(a)
        a, b = a[keep].view(np.int32), b[keep].view(np.int32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["as_i16", "as_i32"])
def test_casts_saturate_and_zero_nan(name):
    x = _floats(0)
    _same_bits(getattr(jm, name)(jnp.asarray(x)),
               getattr(tm, name)(torch.from_numpy(x)))
    i = np.random.default_rng(1).integers(-70000, 70000, 512).astype(np.int32)
    _same_bits(getattr(jm, name)(jnp.asarray(i)),
               getattr(tm, name)(torch.from_numpy(i)))


def test_div_rem_trunc():
    rng = np.random.default_rng(2)
    a = rng.integers(-100000, 100000, 4096).astype(np.int32)
    b = rng.integers(1, 300, 4096).astype(np.int32) * rng.choice([-1, 1], 4096)
    b = b.astype(np.int32)
    for name in ("div_trunc", "rem_trunc"):
        _same_bits(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)),
                   getattr(tm, name)(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("pow2", [False, True])
def test_wrap_tex(pow2):
    rng = np.random.default_rng(3)
    t = rng.integers(-5000, 5000, 4096).astype(np.int32)
    if pow2:
        size = (2 ** rng.integers(0, 9, 4096)).astype(np.int32)
    else:
        size = rng.integers(1, 300, 4096).astype(np.int32)
    got = tm.wrap_tex(torch.from_numpy(t), torch.from_numpy(size), pow2)
    _same_bits(jm.wrap_tex(jnp.asarray(t), jnp.asarray(size), pow2), got)
    assert bool(((got >= 0) & (got < torch.from_numpy(size))).all())


def test_smul_is_one_rounded_product():
    """Strict JAX multiplies in f64 and rounds; for two f32 operands that
    is the plain eager f32 multiply.  A Python constant that is not an
    f32 value (ASPECT_RATIO_CORRECTION) is widened unrounded, as JAX
    widens it."""
    a, b = _floats(4), _floats(5)
    _same_bits(jm.smul(jnp.asarray(a), jnp.asarray(b)),
               tm.smul(torch.from_numpy(a), torch.from_numpy(b)))
    _same_bits(jm.smul(jnp.asarray(a), ASPECT_RATIO_CORRECTION),
               tm.smul(torch.from_numpy(a), ASPECT_RATIO_CORRECTION))
    _same_bits(jm.smul(jnp.asarray(a), 1.0 / 4096.0),
               tm.smul(torch.from_numpy(a), 1.0 / 4096.0))


def test_division_and_sqrt_are_correctly_rounded():
    a, b = _floats(6), _floats(7)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same_bits(jnp.asarray(a) / jnp.asarray(b), tm.fdiv(ta, tb))
    _same_bits(jnp.asarray(a) / np.float32(255.0), tm.fdiv(ta, 255.0))
    pos = np.abs(a)
    _same_bits(jnp.sqrt(jnp.asarray(pos)), tm.sqrt(torch.from_numpy(pos)))


def test_cos_sin_and_rotate():
    rng = np.random.default_rng(8)
    ang = rng.uniform(-7.0, 7.0, 1024).astype(np.float32)
    jc, js = jm.cos_sin(jnp.asarray(ang))
    tc, ts = tm.cos_sin(torch.from_numpy(ang))
    _same_bits(jc, tc)
    _same_bits(js, ts)
    x, y = _floats(9, 1024), _floats(10, 1024)
    for j, t in zip(
        jm.rotate(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ang)),
        tm.rotate(torch.from_numpy(x), torch.from_numpy(y),
                  torch.from_numpy(ang)),
    ):
        _same_bits(j, t)


def test_stable_positions():
    key = np.random.default_rng(11).integers(0, 20, (4, 300)).astype(np.int32)
    _same_bits(jm.stable_positions(jnp.asarray(key)),
               tm.stable_positions(torch.from_numpy(key)))
