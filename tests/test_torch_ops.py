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
from exposure_tpu_torch import kernels
from exposure_tpu_torch.core.serving import proxy_resize
from exposure_tpu_torch.ops import color_space as tcs
from exposure_tpu_torch.ops import fastmath as tfm
from exposure_tpu_torch.ops.proxy_resize import (
    LAST_ROW,
    SCALE_U8,
    band_rows,
    column_plan,
    resize_taps,
    row_schedule,
)
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


def _resize_inputs(rng, h, w, dtype):
    """A [2, h, w, 3] batch and its jax.image.resize to 64x64."""
    x = rng.rand(2, h, w, 3)
    if dtype == 'uint8':
        x = (x * 255).astype(np.uint8)
        src = jnp.asarray(x).astype(jnp.float32) * (1.0 / 255.0)
    else:
        x = x.astype(np.float32)
        src = jnp.asarray(x)
    return x, jax.image.resize(src, (2, 64, 64, 3), method='linear')


def _resize_by_schedule(images, size, band=None):
    """The plain separable sum that the proxy resize kernel computes, with
    its tables: the row pass by the schedule of ``band`` rows (default all
    of them), slot A and slot B and the hand-over at slot A's last row,
    then each output column's taps, in float32 in the kernel's order (each
    of its FMAs as a product and a sum)."""
    b, h, w, _ = images.shape
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x * SCALE_U8
    x = x.reshape(b, h, 3 * w)
    steps, offsets = row_schedule(*resize_taps(h, size), band or size)
    weights = steps[:, 1:3].copy().view(np.float32)
    rows = x.new_empty((b, size, 3 * w))
    for k in range(len(offsets) - 1):
        o = k * (band or size)
        slot_a, slot_b = torch.zeros_like(x[:, 0]), torch.zeros_like(x[:, 0])
        for s in range(offsets[k], offsets[k + 1]):
            v = x[:, int(steps[s, 0]) & (LAST_ROW - 1)]
            slot_a = slot_a + float(weights[s, 0]) * v
            slot_b = slot_b + float(weights[s, 1]) * v
            if steps[s, 0] < 0:
                rows[:, o] = slot_a
                slot_a, slot_b = slot_b, torch.zeros_like(slot_b)
                o += 1
    rows = rows.reshape(b, size, w, 3)
    first, count, col_w = resize_taps(w, size)
    out = x.new_zeros((b, size, size, 3))
    for q in range(size):
        for t in range(int(count[q])):
            out[:, :, q] += float(col_w[q, t]) * rows[:, :, first[q] + t]
    return out


@pytest.mark.parametrize('hw', [(512, 512), (756, 1008), (100, 150),
                                (37, 50)],
                         ids=['integer', 'non_integer', 'aspect', 'upscale'])
@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_proxy_resize_tables_match_jax(rng, hw, dtype):
    """The kernel's tap tables (float64, rounded to float32) and its row
    schedule, applied as the plain separable sum the kernel computes
    (``_resize_by_schedule``), against
    ``jax.image.resize(..., 'linear')``."""
    x, want = _resize_inputs(rng, *hw, dtype)
    got = _resize_by_schedule(torch.from_numpy(x), 64)
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize('hw', [(96, 80), (37, 50), (64, 64), (300, 20)])
def test_proxy_resize_bands_sum_alike(rng, hw):
    """Each output row sums its taps in the same order whatever the band a
    block owns: every band height gives the whole-proxy schedule's result
    bit for bit, upscales (rows read again) and a mixed aspect too, and each
    band flags exactly its output rows."""
    x, _ = _resize_inputs(rng, *hw, 'uint8')
    whole = _resize_by_schedule(torch.from_numpy(x), 64)
    for band in (1, 2, 3, 8, 63):
        assert torch.equal(
            _resize_by_schedule(torch.from_numpy(x), 64, band), whole), band
        steps, offsets = row_schedule(*resize_taps(hw[0], 64), band)
        flags = [int((steps[a:b, 0] < 0).sum())
                 for a, b in zip(offsets[:-1], offsets[1:])]
        assert flags == [min(band, 64 - o) for o in range(0, 64, band)]


def test_proxy_resize_taps_normalised():
    """Each output's taps: positive, summing to 1, inside the input, with
    a triangle's support: ``2 * scale`` taps when shrinking (about 94 and
    126 at 12 MP, 16 at 512 px) and at most 2 when enlarging."""
    for n_in, want in ((3024, 96), (4032, 128), (512, 16), (37, 2)):
        first, count, w = resize_taps(n_in, 64)
        assert first.min() >= 0 and (first + count).max() <= n_in
        assert count.max() <= want and (count >= 1).all()
        sums = [w[o, :count[o]].astype(np.float64).sum() for o in range(64)]
        np.testing.assert_allclose(sums, 1.0, rtol=0, atol=1e-6)
        assert all((w[o, :count[o]] > 0).all() for o in range(64))


@pytest.mark.parametrize('shape,itemsize', [
    ((32, 3024, 4032), 1), ((512, 512, 512), 1), ((2, 3024, 4032), 4),
    ((2, 37, 50), 1), ((2, 100, 150), 4)])
def test_proxy_resize_launch_plan(shape, itemsize):
    """The kernel's launch on 132 SMs: the slices split the output columns,
    each reads every chunk its taps touch and fits a block, and the blocks
    give the card ``FILL_THREADS`` threads an SM unless bands are single
    rows already."""
    from exposure_tpu_torch.ops import proxy_resize as pr
    b, h, w = shape
    plan = column_plan(w, 64, itemsize)
    sl = plan['slices']
    assert sl[0, 0] == 0 and sl[-1, 1] == 64
    assert (sl[1:, 0] == sl[:-1, 1]).all()
    per_chunk = 16 // itemsize
    first, count = plan['col_first'], plan['col_count']
    for q0, q1, k0, k1 in sl:
        assert k0 * per_chunk <= 3 * first[q0:q1].min()
        assert 3 * (first[q0:q1] + count[q0:q1]).max() <= k1 * per_chunk
        assert k1 - k0 <= plan['threads'] <= pr.MAX_THREADS
    assert plan['buf_floats'] == per_chunk * int((sl[:, 3] - sl[:, 2]).max())
    assert 2 * 4 * plan['buf_floats'] <= 227 * 1024
    band = band_rows(b, len(sl), plan['threads'], 64, 132)
    n_bands = len(row_schedule(*resize_taps(h, 64), band)[1]) - 1
    assert n_bands == -(-64 // band)
    blocks = b * len(sl) * n_bands
    assert band == 1 or blocks * plan['threads'] >= pr.FILL_THREADS * 132


def test_proxy_resize_tables_cached_by_shape_and_band(monkeypatch):
    """The device tables: one column plan a photo shape and dtype, one
    row schedule a band height (batch sizes that share a band share it),
    and the kernels' shared-memory opt-in once a device."""
    from types import SimpleNamespace
    from exposure_tpu_torch.ops import proxy_resize as pr
    monkeypatch.setattr(pr, '_SHAPES', {})
    monkeypatch.setattr(pr, '_PREPARED', set())
    uploads = []
    monkeypatch.setattr(pr, '_upload',
                        lambda arrays, device: uploads.append(sorted(arrays))
                        or dict(arrays))
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device: SimpleNamespace(
                            multi_processor_count=132))
    prepared = []
    lib = SimpleNamespace(name='proxy_resize', lib=SimpleNamespace(
        proxy_resize_prepare=lambda: prepared.append(1) or 0))
    dev = torch.device('cuda', 0)
    a = pr._device_tables(lib, 32, 3024, 4032, 64, torch.uint8, dev)
    b = pr._device_tables(lib, 33, 3024, 4032, 64, torch.uint8, dev)
    c = pr._device_tables(lib, 512, 3024, 4032, 64, torch.uint8, dev)
    pr._device_tables(lib, 32, 3024, 4032, 64, torch.float32, dev)
    assert a[0] is b[0] is c[0] and a[1] == b[1] != c[1]
    assert a[2] is b[2] and a[2] is not c[2]
    cols = ['col_count', 'col_first', 'col_w', 'slices']
    rows = ['band_off', 'steps']
    assert uploads == [cols, rows, rows, cols, rows]
    assert prepared == [1]


def test_proxy_resize_cpu_runs_the_plain_version(rng):
    from exposure_tpu_torch.ops import proxy_resize as pr
    x = torch.from_numpy((rng.rand(2, 40, 56, 3) * 255).astype(np.uint8))
    before = kernels.launch_counts()
    assert torch.equal(proxy_resize(x, 64),
                       pr.proxy_resize_reference(x, 64))
    assert kernels.launch_counts() == before
