"""The CUDA chain kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and ``nvcc``; without a device they skip.
They import neither JAX nor the rest of the test suite's fixtures, so a
GPU machine without JAX runs them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: f32 atol 3e-5 / rtol 1e-4 and u8 1 LSB, as
tests/test_pallas_chain.py; pixels past those are counted as outliers,
which the S+ hue discontinuity at (fast set: near) exact gray can
produce, and must stay below 1e-4 of the output."""

import numpy as np
import pytest
import torch

from exposure_tpu_torch.ops.dyn_chain import (
    apply_filter_chain_dynamic,
    apply_filter_chain_dynamic_reference,
)
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.utils.config import load_config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _outlier_fraction(got, want):
    if got.dtype == torch.uint8:
        bad = (got.int() - want.int()).abs() > 1
    else:
        bad = ~torch.isclose(got, want, atol=3e-5, rtol=1e-4)
    return float(bad.float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_kernel_matches_plain(cuda_device, config, fast, dtype):
    rng = np.random.RandomState(0)
    filters = build_filters(load_config(config))
    b, k = 4, 5
    x = rng.rand(b, 67, 131, 3).astype(np.float32)
    img = torch.from_numpy((x * 255).astype(np.uint8) if dtype == 'uint8'
                           else x).to(cuda_device)
    # ids past the bank are the identity
    ids = torch.from_numpy(rng.randint(0, len(filters) + 1, (k, b))
                           .astype(np.int32)).to(cuda_device)
    params = torch.from_numpy(
        (0.5 + rng.rand(k, b, 24)).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy(rng.randn(k, b, 6).astype(np.float32)).to(
        cuda_device) if filters[0].use_masking() else None
    before = apply_filter_chain_dynamic.launches
    got = apply_filter_chain_dynamic(img, ids, params, filters,
                                     mask_params=mask, fast_math=fast)
    assert apply_filter_chain_dynamic.launches == before + 1
    want = apply_filter_chain_dynamic_reference(
        img, ids, params, filters, mask_params=mask, fast_math=fast)
    torch.cuda.synchronize()
    assert got.dtype == img.dtype and got.shape == img.shape
    assert _outlier_fraction(got, want) <= 1e-4


@pytest.mark.cuda
def test_cuda_tensor_never_runs_the_plain_version(cuda_device):
    filters = build_filters(load_config('synthetic_explore'))
    img = torch.zeros((2, 8, 8, 3), device=cuda_device)
    ids = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    params = torch.zeros((1, 2, 24), device=cuda_device)
    before = apply_filter_chain_dynamic.launches
    apply_filter_chain_dynamic(img, ids, params, filters)
    assert apply_filter_chain_dynamic.launches == before + 1
    with pytest.raises(ValueError):   # not contiguous: raise, no fallback
        apply_filter_chain_dynamic(img.transpose(1, 2), ids, params, filters)
