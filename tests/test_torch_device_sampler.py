"""The port's device sampler against the JAX sampler, on the CPU.

``sample_batch`` on the JAX draws of a key, replayed in the port
(``utils/draws.py::ReplayedDraws``), for each path: crop and flip, flip
alone (the pack at the crop size), the antialiased resize (within 1e-6 of
``jax.image.resize``) and the pack taken as it is; batches equal otherwise.
The supervised layout (pairs as stacked channels) round-trips as in JAX,
and ``DataProvider.device_pack`` gives the JAX pack on the asked device.
"""

import jax
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from exposure_tpu.data import device_sampler as jds
from exposure_tpu.data.provider import DataProvider as JProvider
from exposure_tpu_torch.data import device_sampler as tds
from exposure_tpu_torch.data.provider import DataProvider as TProvider
from exposure_tpu_torch.utils.draws import ReplayedDraws

RESIZE_ATOL = 1e-6


@pytest.mark.parametrize('size,out,augment', [
    (80, 64, True),     # crop and flip
    (64, 64, True),     # flip only
    (80, 64, False),    # antialiased resize
    (64, 64, False)])   # as stored
def test_sample_batch_matches_jax(size, out, augment):
    rng = np.random.RandomState(size + out + augment)
    images = rng.rand(10, size, size, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jds.sample_batch(
        jds.DevicePack(images, out, augment), key, 12))
    draws = ReplayedDraws(H.sampler_draws(key, 12, images.shape,
                                          (out, augment)))
    got = tds.sample_batch(tds.DevicePack(torch.from_numpy(images), out,
                                          augment), draws, 12)
    assert draws.left() == 0
    assert got.shape == want.shape == (12, out, out, 3)
    if size != out and not augment:
        np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_paired_channels_round_trip():
    rng = np.random.RandomState(1)
    pairs = rng.rand(5, 2, 8, 8, 3).astype(np.float32)
    want = np.asarray(jds.paired_to_channels(pairs))
    got = tds.paired_to_channels(torch.from_numpy(pairs))
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(tds.channels_to_paired(got, 3),
                    jds.channels_to_paired(want, 3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tds.paired_to_channels(torch.zeros((5, 3, 8, 8, 3)))


@pytest.mark.parametrize('kw', [dict(augmentation=0.3, output_size=64),
                                dict(augmentation=0.0, output_size=-1,
                                     image_scaling=0.5)])
def test_device_pack_matches_jax(kw):
    data = np.random.RandomState(2).rand(6, 80, 80, 3).astype(np.float32)
    want = JProvider(data, **kw).device_pack()
    got = TProvider(data, **kw).device_pack('cpu')
    assert got.images.device.type == 'cpu'
    np.testing.assert_array_equal(got.images.numpy(), want.images)
    assert (got.output_size, got.augment) == (want.output_size,
                                              want.augment)
