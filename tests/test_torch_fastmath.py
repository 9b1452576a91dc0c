"""The port's polynomial and bit-trick math (``fast_log2``, ``fast_exp2``,
``fast_pow``, ``fast_rcp``) against the JAX package's, on the CPU.

Each function is held to the accuracy bounds of tests/test_fastmath.py on
its inputs (pow < 5e-5 over the gamma range, rcp relative error < 1e-6,
the log2/exp2 round trip < 1e-4) and to JAX's output within 1 ulp: the
same coefficients, bit tricks and order of operations (JAX run eagerly,
one rounding per operation, as torch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.ops import fastmath as jfm
from exposure_tpu_torch.ops import fastmath as tfm


def _ulps(got, want):
    """Largest distance in units in the last place between two f32 arrays
    of one sign per element."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert (np.signbit(got) == np.signbit(want)).all()
    return int(np.abs(got.view(np.int32).astype(np.int64) -
                      want.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize('g', [1.0 / 3, 0.7, 1.0, 1.7, 3.0])
def test_fast_pow_gamma_range(g):
    x = np.linspace(1e-3, 2.0, 40001).astype(np.float32)
    got = tfm.fast_pow(torch.from_numpy(x), g).numpy()
    ref = x.astype(np.float64) ** g
    sel = ref <= 1.3
    assert np.abs(got - ref)[sel].max() < 5e-5
    assert _ulps(got, jfm.fast_pow(jnp.asarray(x), g)) <= 1


def test_fast_rcp():
    x = np.linspace(1e-3, 4.0, 40001).astype(np.float32)
    got = tfm.fast_rcp(torch.from_numpy(x)).numpy()
    assert np.abs(got * x.astype(np.float64) - 1.0).max() < 1e-6
    assert _ulps(got, jfm.fast_rcp(jnp.asarray(x))) <= 1


def test_fast_rcp_seed_wraps_as_jax():
    """The seed 0x7EF311C3 - bits goes negative for x above ~1.7e38; int32
    arithmetic gives the same seed bits in both (no Newton steps)."""
    x = np.array([1e-30, 0.5, 3.0, 2e38, 3e38], np.float32)
    got = tfm.fast_rcp(torch.from_numpy(x), iters=0).numpy()
    want = np.asarray(jfm.fast_rcp(jnp.asarray(x), iters=0))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fast_log2_exp2_roundtrip():
    x = np.linspace(1e-3, 8.0, 40001).astype(np.float32)
    log2 = tfm.fast_log2(torch.from_numpy(x))
    back = tfm.fast_exp2(log2).numpy()
    assert np.abs(back / x - 1.0).max() < 1e-4
    # near x = 1 the logarithm passes through 0 and changes sign: compare
    # to JAX away from it, where 1 ulp is a relative bound
    away = np.abs(x - 1.0) > 1e-2
    assert _ulps(log2.numpy()[away],
                 np.asarray(jfm.fast_log2(jnp.asarray(x)))[away]) <= 1
    assert _ulps(back, jfm.fast_exp2(jfm.fast_log2(jnp.asarray(x)))) <= 1


def test_fast_exp2_floor_and_clamp():
    """Negative exponents take the floor (not truncation), and exponents
    past 126 are clamped, as in JAX.  Below about -125.99 the result is
    subnormal, which JAX on the CPU flushes to zero and torch keeps, so
    the inputs stop there."""
    y = np.concatenate([np.linspace(-125.5, 140.0, 20001),
                        [-0.5, -1.0, -1.5, -125.99, 125.99]]).astype(
        np.float32)
    got = tfm.fast_exp2(torch.from_numpy(y)).numpy()
    assert _ulps(got, jfm.fast_exp2(jnp.asarray(y))) <= 1
    inner = np.abs(y) <= 30
    np.testing.assert_allclose(got[inner], np.exp2(y[inner].astype(
        np.float64)), rtol=1e-4)


def test_bit_tricks_need_float32():
    x = torch.ones(4, dtype=torch.bfloat16)
    for fn in (tfm.fast_log2, tfm.fast_exp2, tfm.fast_rcp):
        with pytest.raises(TypeError):
            fn(x)
