"""The dynamic chain (the port of the TPU kernel ``_dyn_chain_kernel``)
against the JAX kernel run in interpret mode, as the JAX package's own
tests run it on the CPU.

On a CPU tensor ``apply_filter_chain_dynamic`` runs its plain PyTorch
version, which is what these tests exercise; the CUDA kernel is compared
with the same plain version on the card (tests/test_torch_cuda.py and
``chip_smoke.py``).  Tolerances as in tests/test_pallas_chain.py:
f32 atol 3e-5 / rtol 1e-4, u8 at most 1 LSB."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.ops.chain import apply_filter_chain as j_chain
from exposure_tpu.ops.filters import max_filter_parameters
from exposure_tpu.ops.pallas_chain import pallas_apply_filter_chain_dynamic
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch import kernels
from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.utils.config import load_config as t_load_config


def _banks(name):
    jcfg = j_load_config(name)
    return [f(jcfg) for f in jcfg.filters], build_filters(
        t_load_config(name))


def _trajectory(rng, filters, k, b):
    """Random (ids, packed regressed params) like a rollout emits."""
    ids = rng.randint(0, len(filters), (k, b)).astype(np.int32)
    params = np.zeros((k, b, max_filter_parameters(filters)), np.float32)
    for s in range(k):
        for i in range(b):
            f = filters[ids[s, i]]
            raw = rng.randn(1, f.get_num_filter_parameters()).astype(
                np.float32)
            params[s, i, :raw.shape[1]] = np.asarray(
                f.filter_param_regressor(jnp.asarray(raw))).reshape(-1)
    return ids, params


def _image(rng, b, h, w, dtype):
    x = rng.rand(b, h, w, 3) * 0.9
    return (x * 255).astype(np.uint8) if dtype == 'uint8' \
        else x.astype(np.float32)


def _opt(x, to):
    return None if x is None else to(x)


def _both(img, ids, params, jf, tf, fast, active=None, mask=None):
    want = pallas_apply_filter_chain_dynamic(
        jnp.asarray(img), jnp.asarray(ids), jnp.asarray(params), jf,
        active_steps=_opt(active, jnp.asarray),
        mask_params=_opt(mask, jnp.asarray), tile=(32, 128),
        interpret=True, fast_math=fast)
    got = apply_filter_chain_dynamic(
        torch.from_numpy(img), torch.from_numpy(ids),
        torch.from_numpy(params), tf,
        active_steps=_opt(active, torch.from_numpy),
        mask_params=_opt(mask, torch.from_numpy), fast_math=fast)
    return got.numpy(), np.asarray(want)


def _assert_match(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.uint8:
        lsb = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
        assert lsb <= 1, 'u8 chain off by %d LSB' % lsb
    else:
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize('config', ['test', 'masked'])
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_matches_jax_kernel(rng, config, fast, dtype):
    jf, tf = _banks(config)
    b, k = 2, 3
    img = _image(rng, b, 64, 128, dtype)
    ids, params = _trajectory(rng, jf, k, b)
    mask = None
    if jf[0].use_masking():
        max_m = max(f.get_num_mask_parameters() for f in jf)
        mask = rng.randn(k, b, max_m).astype(np.float32)
    _assert_match(*_both(img, ids, params, jf, tf, fast, mask=mask))


@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_odd_shape(rng, dtype):
    jf, tf = _banks('test')
    img = _image(rng, 1, 67, 131, dtype)
    ids, params = _trajectory(rng, jf, 5, 1)
    _assert_match(*_both(img, ids, params, jf, tf, fast=True))


def test_active_steps_and_identity(rng):
    jf, tf = _banks('test')
    img = _image(rng, 2, 64, 64, 'float32')
    ids, params = _trajectory(rng, jf, 5, 2)
    active = np.array([[1, 1], [1, 0], [0, 1], [0, 0], [0, 0]], np.float32)
    _assert_match(*_both(img, ids, params, jf, tf, False, active=active))
    # the branchless chain agrees on which steps were skipped
    want = j_chain(jnp.asarray(img), jnp.asarray(ids), jnp.asarray(params),
                   jf, active_steps=jnp.asarray(active))
    got = apply_filter_chain_dynamic(
        torch.from_numpy(img), torch.from_numpy(ids),
        torch.from_numpy(params), tf,
        active_steps=torch.from_numpy(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-4)
    # an all-identity trajectory returns the input unchanged
    ids0 = np.full_like(ids, len(tf))
    for x in (img, _image(rng, 2, 64, 64, 'uint8')):
        same = apply_filter_chain_dynamic(
            torch.from_numpy(x), torch.from_numpy(ids0),
            torch.from_numpy(params), tf)
        np.testing.assert_array_equal(same.numpy(), x)


def test_manufactured_gray_pixels(rng):
    """The S+ filter is discontinuous at exact gray, and overexposure
    followed by a saturating colour curve makes exactly-gray regions.  The
    fast set (2e-4 gray band) must agree with the exact branchless chain
    there, leaving at most a negligible fraction of band-edge pixels."""
    jf, tf = _banks('test')
    names = [type(f).__name__ for f in jf]
    e_id = names.index('ExposureFilter')
    c_id = names.index('ColorFilter')
    s_id = names.index('SaturationPlusFilter')
    img = _image(rng, 1, 64, 128, 'float32')
    ids = np.array([[e_id], [c_id], [e_id], [s_id]], np.int32)
    params = np.zeros((4, 1, max_filter_parameters(jf)), np.float32)
    params[0, :, 0] = 2.0 ** 3.0          # massive overexposure
    params[1, :, :24] = np.asarray(jf[c_id].filter_param_regressor(
        jnp.asarray(rng.randn(1, 24).astype(np.float32))))
    params[2, :, 0] = 0.6                  # back into range -> midtones
    params[3, :, 0] = 0.9                  # strong saturation boost
    exact = j_chain(jnp.asarray(img), jnp.asarray(ids), jnp.asarray(params),
                    jf)
    got = apply_filter_chain_dynamic(
        torch.from_numpy(img), torch.from_numpy(ids),
        torch.from_numpy(params), tf, fast_math=True).numpy()

    def u8(x):
        return np.round(np.clip(np.asarray(x), 0, 1) * 255.0)

    diff = np.abs(u8(got) - u8(exact))
    assert (diff > 1).mean() <= 1e-4, (diff.max(), (diff > 1).sum())


def test_cpu_tensors_never_count_as_launches(rng):
    _, tf = _banks('test')
    img = torch.from_numpy(_image(rng, 2, 16, 16, 'uint8'))
    ids = torch.zeros((5, 2), dtype=torch.int32)
    params = torch.zeros((5, 2, 24))
    before = kernels.launch_counts()
    apply_filter_chain_dynamic(img, ids, params, tf)
    apply_filter_chain_dynamic(img.float() / 255, ids, params, tf,
                               fast_math=True)
    assert kernels.launch_counts() == before


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    _, tf = _banks('test')
    ids = torch.zeros((2, 1), dtype=torch.int32)
    params = torch.zeros((2, 1, 24))
    with pytest.raises(TypeError):
        apply_filter_chain_dynamic(torch.zeros((1, 8, 8, 3),
                                               dtype=torch.float64),
                                   ids, params, tf)
    with pytest.raises(ValueError):
        apply_filter_chain_dynamic(torch.zeros((1, 8, 8, 4)), ids, params,
                                   tf)
    with pytest.raises(ValueError):
        apply_filter_chain_dynamic(torch.zeros((2, 8, 8, 3)), ids, params,
                                   tf)
    # a device with no kernel raises; nothing falls back to the CPU
    with pytest.raises(ValueError):
        apply_filter_chain_dynamic(
            torch.zeros((1, 8, 8, 3), device='meta'),
            ids.to('meta'), params.to('meta'), tf)
    _, mf = _banks('masked')
    with pytest.raises(ValueError):   # masking needs mask_params
        apply_filter_chain_dynamic(torch.zeros((1, 8, 8, 3)), ids, params,
                                   mf)


# chain_cost: the bound's inputs.  synthetic_explore bank (8 filters, 24
# parameters a row), K=3 steps on n=2 images of 4x8 pixels; id 8 is the
# identity.  u8 conversions cost 3 x 6 operations a pixel.
_COST_CASES = {
    'identity': ([[8, 8], [8, 8], [8, 8]], False, 0),
    'one_exposure_step': ([[0, 0], [8, 8], [8, 8]], False, 2 * 3),
    'one_tone_step_fast': ([[8, 8], [4, 4], [8, 8]], True,
                           2 * 3 * (3 * 8 + 4)),
    'one_tone_step_exact': ([[8, 8], [4, 4], [8, 8]], False,
                            2 * 3 * (5 * 8 + 1)),
    # image 0: E, G, T; image 1: identity, S+, C (fast set)
    'mixed_fast': ([[0, 8], [1, 3], [4, 7]], True,
                   3 + 12 + 84 + 46 + 84),
}


@pytest.mark.parametrize('case', sorted(_COST_CASES))
@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_chain_cost(case, dtype):
    from exposure_tpu_torch.ops.dyn_chain import chain_cost
    ids, fast, ops_per_pixel = _COST_CASES[case]
    tf = build_filters(t_load_config('synthetic_explore'))
    tdt = getattr(torch, dtype)
    cost = chain_cost(torch.tensor(ids, dtype=torch.int32), tf, 4, 8, tdt,
                      fast, False)
    pixels, item = 32, (1 if dtype == 'uint8' else 4)
    io = 2 * pixels * 3 * 6 if dtype == 'uint8' else 0
    assert cost['flops'] == ops_per_pixel * pixels + io
    # images in and out, [3, 2] int32 ids, [3, 2, 24] f32 params
    assert cost['bytes'] == 2 * 2 * pixels * 3 * item + 3 * 2 * 4 + \
        3 * 2 * 24 * 4


def test_chain_cost_masked():
    """Each masked step adds the mask blend (30 operations a pixel, the
    vignette excepted), and each pixel its grid position (6)."""
    from exposure_tpu_torch.ops.dyn_chain import chain_cost
    mf = build_filters(t_load_config('masked'))
    names = [type(f).__name__ for f in mf]
    ids = torch.tensor([[names.index('ExposureFilter')],
                        [names.index('VignetFilter')]], dtype=torch.int32)
    cost = chain_cost(ids, mf, 2, 2, torch.float32, True, True)
    assert cost['flops'] == 4 * ((3 + 30) + 17 + 6)
    assert cost['bytes'] == 2 * 4 * 3 * 4 + 2 * 4 + 2 * (24 + 6) * 4


@pytest.mark.parametrize('kernel,tool,ops', [
    ('mono_probe', 'bench_kernel_probe', 'MONO_OPS'),
    ('fastmath_probe', 'bench_fastmath', 'OPS'),
    ('bf16_probe', 'bench_bf16_probe', 'OPS'),
])
def test_probe_cost(kernel, tool, ops):
    """Every op of a probe tool has its count; a u8 value costs the op's
    count each step and its conversions, and moves 2 bytes."""
    import importlib
    from exposure_tpu_torch.ops.dyn_chain import PROBE_OPS, probe_cost
    names = getattr(importlib.import_module(
        'exposure_tpu_torch.tools.' + tool), ops)
    assert set(PROBE_OPS[kernel]) == set(names)
    for op, per_step in PROBE_OPS[kernel].items():
        assert probe_cost(kernel, op, 5, 10) == {
            'flops': 10 * (5 * per_step + 6), 'bytes': 20}


def test_plan_shared_memory_bound():
    """The kernels' per-step plans live in 48 KiB of shared memory: 32 steps
    of 8-knot curves fit, 400 do not, and the wrapper says so before any
    device is touched."""
    from exposure_tpu_torch.ops.dyn_chain import (
        MAX_STATIC_SMEM, check_plan_smem, plan_smem_bytes)
    tf = build_filters(t_load_config('synthetic_explore'))
    assert plan_smem_bytes(5, 8) == 5 * 4 * (1 + 33 + 6)
    check_plan_smem(32, tf)
    assert plan_smem_bytes(400, 8) > MAX_STATIC_SMEM
    with pytest.raises(ValueError, match='shared memory'):
        check_plan_smem(400, tf)
