"""The port's numeric helpers against the JAX package: utils/ops,
color_space, the two fast-math helpers and the proxy resize.  Same numpy
inputs on both sides; tolerance 1e-6 (f32 elementwise math)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.ops import color_space as jcs
from exposure_tpu.ops import fastmath as jfm
from exposure_tpu.utils import ops as jops
from exposure_tpu_torch.core.serving import proxy_resize
from exposure_tpu_torch.ops import color_space as tcs
from exposure_tpu_torch.ops import fastmath as tfm
from exposure_tpu_torch.utils import ops as tops

TOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=tol)


def test_state_constants():
    for name in ('STATE_REWARD_DIM', 'STATE_STOPPED_DIM', 'STATE_STEP_DIM',
                 'STATE_DROPOUT_BEGIN'):
        assert getattr(tops, name) == getattr(jops, name)


@pytest.mark.parametrize('fn', ['lrelu', 'tanh01', 'rgb2lum'])
def test_elementwise(rng, fn):
    x = (rng.randn(4, 5, 6, 3) * 2).astype(np.float32)
    _close(getattr(tops, fn)(torch.from_numpy(x)),
           getattr(jops, fn)(jnp.asarray(x)))


@pytest.mark.parametrize('lo,hi,initial', [
    (-3.5, 3.5, 0), (0.9, 1.1, 1), (0.5, 2, None), (-1, 1, None)])
def test_tanh_range_bias(rng, lo, hi, initial):
    x = (rng.randn(64) * 2).astype(np.float32)
    _close(tops.tanh_range(lo, hi, initial)(torch.from_numpy(x)),
           jops.tanh_range(lo, hi, initial)(jnp.asarray(x)))


def test_lerp(rng):
    a, b, t = (rng.rand(3, 8).astype(np.float32) for _ in range(3))
    _close(tops.lerp(*map(torch.from_numpy, (a, b, t))),
           jops.lerp(*map(jnp.asarray, (a, b, t))))


def _hsv_inputs(rng):
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    x[0, 0, :4] = 0.5                      # exact gray
    x[0, 1, :4] = 0.0                      # black
    x[0, 2, 0] = (1.0, 1.0, 0.2)           # ties between max channels
    x[0, 2, 1] = (0.3, 0.9, 0.9)
    x[0, 2, 2] = (0.7, 0.1, 0.7)
    return x


def test_rgb_to_hsv(rng):
    x = _hsv_inputs(rng)
    _close(tcs.rgb_to_hsv(torch.from_numpy(x)),
           jcs.rgb_to_hsv(jnp.asarray(x)))


def test_hsv_to_rgb(rng):
    hsv = rng.rand(2, 16, 16, 3).astype(np.float32)
    hsv[0, 0, :6, 0] = np.arange(6) / 6.0   # sextant boundaries
    hsv[0, 1, 0] = (0.999999, 0.5, 0.5)
    _close(tcs.hsv_to_rgb(torch.from_numpy(hsv)),
           jcs.hsv_to_rgb(jnp.asarray(hsv)))


def test_fast_half_cos_pi(rng):
    x = np.concatenate([rng.rand(4096), [0.0, 0.5, 1.0]]).astype(np.float32)
    _close(tfm.fast_half_cos_pi(torch.from_numpy(x)),
           jfm.fast_half_cos_pi(jnp.asarray(x)))


def test_curve_relu(rng):
    x = (rng.rand(4096) * 1.4 - 0.2).astype(np.float32)
    knots = (0.5 + rng.rand(8) * 1.5).astype(np.float32)
    norm = np.float32(8.0 / knots.sum())
    got = tfm.curve_relu(torch.from_numpy(x),
                         [torch.tensor(k) for k in knots],
                         torch.tensor(norm))
    want = jfm.curve_relu(jnp.asarray(x), [jnp.float32(k) for k in knots],
                          jnp.float32(norm))
    _close(got, want)


@pytest.mark.parametrize('hw', [(512, 512), (64, 128), (100, 150)])
@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_proxy_resize_matches_jax(rng, hw, dtype):
    h, w = hw
    x = rng.rand(2, h, w, 3)
    if dtype == 'uint8':
        x = (x * 255).astype(np.uint8)
        src = jnp.asarray(x).astype(jnp.float32) * (1.0 / 255.0)
    else:
        x = x.astype(np.float32)
        src = jnp.asarray(x)
    want = jax.image.resize(src, (2, 64, 64, 3), method='linear')
    got = proxy_resize(torch.from_numpy(x), 64)
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    _close(got, want)
