"""The CUDA kernels against their plain PyTorch versions, on the card: the
chain kernels K1 (``dyn_chain``), K2 (``switch_chain``, f32 and bf16) and
K3 (``static_chain``), and the probes K4a-c (``csrc/probes.cu``).

These tests need a CUDA device and ``nvcc``; without a device they skip.
They import neither JAX nor the rest of the test suite's fixtures, so a
GPU machine without JAX runs them with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: f32 atol 3e-5 / rtol 1e-4 and u8 1 LSB, as
tests/test_pallas_chain.py; pixels past those are counted as outliers,
which the S+ hue discontinuity at (fast set: near) exact gray can
produce, and must stay below 1e-4 of the output.  K2 in bf16 is held to
the JAX bound against the f32 result (u8 max 8 LSB, mean below 2) on the
inputs tests/test_pallas_chain.py::test_bf16_compute_mode states it for,
and to the mean elsewhere (the maximum depends on the inputs: other seeds
of that shape reach 28 LSB in the bf16 semantics the JAX kernel shares,
and with the fast set's max-form curves the JAX kernel in bf16 is itself
up to 68 LSB off its f32 result) and, against its bf16
plain version, to at most 1e-3 of the values off by more than 1 LSB:
both round after every operation, but their f32 exp, pow and cos may
differ in the last bit, which moves a bf16 rounding now and then.

The chain kernels' edges: the generic knot count, image bases that are not
16-byte aligned (odd shapes, a storage offset), ragged runs, the masked
bank with every branch, K3's shuffled rows below ``n_active``, and K1, K2
and K3 equal bit for bit on one trajectory.

K2 in bf16 runs the same edges against its plain version, and the packed
bf16 operations it and K4c run are held to their scalar f32-then-round forms
over every pair of operands.

The probes: K4a, K4b and K4c in f32 within 1 LSB of their plain versions
(the CUDA library's powf, cospif, expf and logf may differ from torch's in the
last bit), K4c in bf16 with at most 1e-3 of the values more than 1 LSB
apart, and its bf16_cast and bf16_splat styles equal bit for bit.

Training: one outer step of the ``test`` config on the card against the
CPU from the same state and draws, within ``tools/train_check.py``'s
bounds; three iterations of ``Trainer`` on the card by default, restored
bit for bit from its checkpoint; a state on the card saved and restored on
the card and on the CPU.

Streaming: the bundle producer's uploads from pinned buffers equal the
host assembly, with at most ``slots + 2`` buffers a shape; a streaming run
of ``test`` on the card, equal to a second run from the same seed.

Data parallelism: the step under a world-size-1 ``nccl`` group equals the
step without one bit for bit (deterministic cuDNN, a control step); two
``gloo`` ranks sharing the card keep the same parameters over three
iterations of ``test``; ``nccl`` refuses two ranks on one card and names
``gloo``.

The fused dispatch: iterations captured in a CUDA graph and replayed equal
the eager ones bit for bit (resident and streaming u8, deterministic
cuDNN); a replay after ``manual_seed`` draws what the eager calls draw; a
capture that fails raises, and the runner never falls back to eager.

The card tools: ``bench_truth``'s dependency-serialized K2 chain within 1
LSB of the plain version at every link, and ``bench_upload``'s pinned
upload (the streaming trainer's) equal to its pageable one."""

import contextlib
import os

import numpy as np
import pytest
import torch

from exposure_tpu_torch import kernels
from exposure_tpu_torch.ops.dyn_chain import (
    apply_filter_chain_dynamic,
    apply_filter_chain_dynamic_reference,
)
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.ops.static_chain import (
    apply_filter_chain_static,
    apply_filter_chain_static_reference,
)
from exposure_tpu_torch.ops.switch_chain import (
    apply_filter_chain_switch,
    apply_filter_chain_switch_reference,
)
from exposure_tpu_torch.tools import bench_bf16_probe as bf16_probe
from exposure_tpu_torch.tools import bench_fastmath as fastmath_probe
from exposure_tpu_torch.tools import bench_kernel_probe as mono_probe
from exposure_tpu_torch.utils.config import load_config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _launched(key):
    """The kernel launches counted under ``key`` so far."""
    return kernels.launch_counts()[key]


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
    before = _launched('dyn_chain')
    got = apply_filter_chain_dynamic(img, ids, params, filters,
                                     mask_params=mask, fast_math=fast)
    assert _launched('dyn_chain') == before + 1
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
    before = _launched('dyn_chain')
    apply_filter_chain_dynamic(img, ids, params, filters)
    assert _launched('dyn_chain') == before + 1
    with pytest.raises(ValueError):   # not contiguous: raise, no fallback
        apply_filter_chain_dynamic(img.transpose(1, 2), ids, params, filters)


def _case(rng, config, dtype, device, b=4, k=5, h=67, w=131):
    filters = build_filters(load_config(config))
    x = rng.rand(b, h, w, 3).astype(np.float32)
    img = torch.from_numpy((x * 255).astype(np.uint8) if dtype == 'uint8'
                           else x).to(device)
    ids = torch.from_numpy(rng.randint(0, len(filters) + 1, (k, b))
                           .astype(np.int32)).to(device)
    params = torch.from_numpy(
        (0.5 + rng.rand(k, b, 24)).astype(np.float32)).to(device)
    mask = torch.from_numpy(rng.randn(k, b, 6).astype(np.float32)).to(
        device) if filters[0].use_masking() else None
    return filters, img, ids, params, mask


@pytest.mark.cuda
def test_dyn_chain_takes_more_images_than_a_grid(cuda_device):
    """B = 65536 images: past grid dimension y's 65535, so the launcher
    splits the batch."""
    rng = np.random.RandomState(3)
    filters, img, ids, params, _ = _case(rng, 'synthetic_explore', 'uint8',
                                         cuda_device, b=65536, h=8, w=8)
    before = _launched('dyn_chain')
    got = apply_filter_chain_dynamic(img, ids, params, filters,
                                     fast_math=True)
    assert _launched('dyn_chain') == before + 1
    want = apply_filter_chain_dynamic_reference(img, ids, params, filters,
                                                fast_math=True)
    torch.cuda.synchronize()
    assert _outlier_fraction(got, want) <= 1e-4
    assert torch.equal(got[-4:], apply_filter_chain_dynamic(
        img[-4:].contiguous(), ids[:, -4:].contiguous(),
        params[:, -4:].contiguous(), filters, fast_math=True))


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_switch_chain_f32_matches_plain(cuda_device, config, fast, dtype):
    rng = np.random.RandomState(1)
    filters, img, ids, params, mask = _case(rng, config, dtype, cuda_device)
    active = torch.from_numpy((rng.rand(5, 4) > 0.3).astype(np.float32)).to(
        cuda_device)
    before = _launched('switch_chain')
    got = apply_filter_chain_switch(img, ids, params, filters,
                                    active_steps=active, mask_params=mask,
                                    fast_math=fast)
    assert _launched('switch_chain') == before + 1
    want = apply_filter_chain_switch_reference(
        img, ids, params, filters, active_steps=active, mask_params=mask,
        fast_math=fast)
    torch.cuda.synchronize()
    assert got.dtype == img.dtype and got.shape == img.shape
    assert _outlier_fraction(got, want) <= 1e-4


def _regressed(rng, filters, ids):
    """Parameters a policy could emit: each step's filter regressor on
    normal raw outputs (the JAX bf16 bound is stated for these)."""
    ids = ids.cpu()
    params = torch.zeros(ids.shape + (24,))
    for fid, f in enumerate(filters):
        n = f.get_num_filter_parameters()
        raw = torch.from_numpy(rng.randn(ids.numel(), n).astype(np.float32))
        reg = f.filter_param_regressor(raw).reshape(ids.shape + (n,))
        params[..., :n] = torch.where((ids == fid)[..., None], reg,
                                      params[..., :n])
    return params


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
def test_switch_chain_bf16_matches_plain(cuda_device, config, fast):
    rng = np.random.RandomState(2)
    filters, img, ids, _, mask = _case(rng, config, 'uint8', cuda_device)
    params = _regressed(rng, filters, ids).to(cuda_device)
    kw = dict(mask_params=mask, fast_math=fast)
    got = apply_filter_chain_switch(img, ids, params, filters,
                                    compute_dtype=torch.bfloat16, **kw)
    want = apply_filter_chain_switch_reference(
        img, ids, params, filters, compute_dtype=torch.bfloat16, **kw)
    f32 = apply_filter_chain_switch(img, ids, params, filters, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8
    off = (got.int() - want.int()).abs()
    assert float((off > 1).float().mean()) <= 1e-3
    vs_f32 = (got.int() - f32.int()).abs()
    assert float(vs_f32.float().mean()) < 2.0


@pytest.mark.cuda
def test_switch_chain_bf16_jax_bound(cuda_device):
    """The inputs of tests/test_pallas_chain.py::test_bf16_compute_mode
    (numpy RandomState(0): the u8 batch, the ids, then each step's raw
    parameters), where the JAX kernel's bf16 result is within 8 LSB of
    its f32 one."""
    filters = build_filters(load_config('test'))
    rng = np.random.RandomState(0)
    img8 = (rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
    ids = rng.randint(0, len(filters), (5, 2)).astype(np.int32)
    params = np.zeros((5, 2, 24), np.float32)
    for s in range(5):
        for i in range(2):
            f = filters[ids[s, i]]
            n = f.get_num_filter_parameters()
            raw = torch.from_numpy(rng.randn(1, n).astype(np.float32))
            params[s, i, :n] = f.filter_param_regressor(raw).numpy()[0]
    args = [torch.from_numpy(x).to(cuda_device) for x in (img8, ids, params)]
    bf16 = apply_filter_chain_switch(*args, filters,
                                     compute_dtype=torch.bfloat16)
    f32 = apply_filter_chain_switch(*args, filters)
    torch.cuda.synchronize()
    diff = (bf16.int() - f32.int()).abs()
    assert int(diff.max()) <= 8 and float(diff.float().mean()) < 2.0


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_rows_and_n_active(cuda_device, config, dtype):
    """K2 and K3 with ``rows`` and ``n_active`` write exactly the active
    rows of ``out`` and leave the rest as they were."""
    rng = np.random.RandomState(4)
    filters, img, ids, params, mask = _case(rng, config, dtype, cuda_device,
                                            b=6)
    rows = torch.tensor([4, 1, 3, 0], dtype=torch.int32, device=cuda_device)
    sig = tuple(int(x) for x in ids[:, 0].tolist())
    for run, plain, lead, key in (
            (apply_filter_chain_switch, apply_filter_chain_switch_reference,
             (ids,), 'switch_chain'),
            (apply_filter_chain_static, apply_filter_chain_static_reference,
             (sig,), 'static_chain')):
        out = torch.zeros_like(img)
        before = _launched(key)
        run(img, *lead, params, filters, mask_params=mask, fast_math=True,
            rows=rows, out=out, n_active=3)
        assert _launched(key) == before + 1
        want = plain(img, *lead, params, filters, mask_params=mask,
                     fast_math=True, rows=rows, out=torch.zeros_like(img),
                     n_active=3)
        torch.cuda.synchronize()
        assert _outlier_fraction(out, want) <= 1e-4
        assert not out[[0, 2, 5]].any()   # rows not replayed stay zero


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_static_chain_matches_plain(cuda_device, config, fast, dtype):
    rng = np.random.RandomState(5)
    filters, img, _, params, mask = _case(rng, config, dtype, cuda_device)
    sig = tuple(int(x) for x in rng.randint(0, len(filters) + 1, 5))
    before = _launched('static_chain')
    got = apply_filter_chain_static(img, sig, params, filters,
                                    mask_params=mask, fast_math=fast,
                                    n_active=3)
    assert _launched('static_chain') == before + 1
    want = apply_filter_chain_static_reference(
        img, sig, params, filters, mask_params=mask, fast_math=fast,
        n_active=3)
    torch.cuda.synchronize()
    assert _outlier_fraction(got[:3], want[:3]) <= 1e-4


# The edges of the chain kernels' design (csrc/chain_branches.cuh): the
# generic knot count, image bases that are not 16-byte aligned, ragged runs,
# the masked bank, K3's shuffled rows, and one copy of the math.

def _chains(img, ids, params, filters, **kw):
    """K1, K2-f32 and K3 (on the signature of image 0, which ``ids`` must
    give every image) of one trajectory, each against its plain version."""
    sig = tuple(int(x) for x in ids[:, 0].tolist())
    runs = (
        (apply_filter_chain_dynamic, apply_filter_chain_dynamic_reference,
         (ids,), 'dyn_chain'),
        (apply_filter_chain_switch, apply_filter_chain_switch_reference,
         (ids,), 'switch_chain'),
        (apply_filter_chain_static, apply_filter_chain_static_reference,
         (sig,), 'static_chain'))
    outs = []
    for run, plain, lead, key in runs:
        before = _launched(key)
        got = run(img, *lead, params, filters, **kw)
        assert _launched(key) == before + 1
        want = plain(img, *lead, params, filters, **kw)
        torch.cuda.synchronize()
        assert got.dtype == img.dtype and got.shape == img.shape
        assert _outlier_fraction(got, want) <= 1e-4, run.__name__
        outs.append(got)
    return outs


def _one_signature(rng, filters, k, b, device):
    sig = rng.randint(0, len(filters) + 1, k).astype(np.int32)
    return torch.from_numpy(np.repeat(sig[:, None], b, axis=1)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_generic_curve_steps(cuda_device, config, fast, dtype):
    """A knot count other than 8 runs the generic instantiation (S = 0);
    every step is a curve (T or C)."""
    cfg = load_config(config)
    cfg.curve_steps = 5
    filters = build_filters(cfg)
    names = [type(f).__name__ for f in filters]
    rng = np.random.RandomState(6)
    _, img, _, params, mask = _case(rng, config, dtype, cuda_device)
    curves = [names.index('ToneFilter'), names.index('ColorFilter')]
    ids = torch.from_numpy(np.repeat(np.array(
        curves * 2 + curves[:1], np.int32)[:, None], 4, axis=1)).to(
            cuda_device)
    _chains(img, ids, params, filters, mask_params=mask, fast_math=fast)


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_unaligned_image_bases(cuda_device, config, dtype):
    """67x131 images (u8: each image's base at another offset mod 16) and
    a batch sliced off a larger one (a storage offset: input and output
    aligned differently, so every run takes the scalar path): the kernels
    hold to their plain versions and give the slice the bits they give
    the whole."""
    rng = np.random.RandomState(7)
    filters, img, _, params, mask = _case(rng, config, dtype, cuda_device,
                                          b=5)
    ids = _one_signature(rng, filters, 5, 5, cuda_device)
    kw = dict(mask_params=mask, fast_math=True)
    whole = _chains(img, ids, params, filters, **kw)
    sub = img[1:]
    assert sub.is_contiguous() and sub.storage_offset() > 0
    part = _chains(sub, ids[:, 1:].contiguous(), params[:, 1:].contiguous(),
                   filters, mask_params=None if mask is None else
                   mask[:, 1:].contiguous(), fast_math=True)
    for w, p in zip(whole, part):
        assert torch.equal(w[1:], p)


@pytest.mark.cuda
@pytest.mark.parametrize('hw', [(1, 1), (3, 5), (5, 7), (4, 4), (7, 9)],
                         ids=lambda s: '%dx%d' % s)
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_ragged_pixel_runs(cuda_device, hw, dtype):
    """Images smaller than a run of 16 pixels, or with a ragged last run."""
    rng = np.random.RandomState(8)
    filters, img, _, params, _ = _case(rng, 'synthetic_explore', dtype,
                                       cuda_device, b=3, h=hw[0], w=hw[1])
    ids = _one_signature(rng, filters, 5, 3, cuda_device)
    _chains(img, ids, params, filters, fast_math=True)


@pytest.mark.cuda
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_masked_bank_every_branch(cuda_device, fast, dtype):
    """The masked bank with every filter, the vignette included, in one
    trajectory on an odd shape."""
    rng = np.random.RandomState(9)
    k = len(build_filters(load_config('masked')))
    filters, img, _, params, mask = _case(rng, 'masked', dtype, cuda_device,
                                          b=2, k=k, h=45, w=77)
    ids = torch.arange(k, dtype=torch.int32, device=cuda_device)
    _chains(img, ids[:, None].repeat(1, 2).contiguous(), params, filters,
            mask_params=mask, fast_math=fast)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_static_chain_shuffled_rows(cuda_device, dtype):
    """K3 with ``rows`` in a shuffled order and ``n_active`` below the slot
    count: each active slot writes its own image, the others stay."""
    rng = np.random.RandomState(10)
    filters, img, _, params, _ = _case(rng, 'synthetic_explore', dtype,
                                       cuda_device, b=9)
    sig = tuple(int(x) for x in rng.randint(0, len(filters), 5))
    rows = torch.from_numpy(rng.permutation(9)[:7].astype(np.int32)).to(
        cuda_device)
    out = torch.zeros_like(img)
    apply_filter_chain_static(img, sig, params, filters, fast_math=True,
                              rows=rows, out=out, n_active=5)
    want = apply_filter_chain_static_reference(
        img, sig, params, filters, fast_math=True, rows=rows,
        out=torch.zeros_like(img), n_active=5)
    torch.cuda.synchronize()
    assert _outlier_fraction(out, want) <= 1e-4
    idle = sorted(set(range(9)) - set(rows[:5].tolist()))
    assert not out[idle].any()


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_k1_k2_k3_agree_bit_for_bit(cuda_device, config, fast, dtype):
    """One trajectory through K1, K2-f32 and K3: one copy of the math, so
    the three outputs are equal."""
    rng = np.random.RandomState(11)
    filters, img, _, params, mask = _case(rng, config, dtype, cuda_device)
    ids = _one_signature(rng, filters, 5, 4, cuda_device)
    k1, k2, k3 = _chains(img, ids, params, filters, mask_params=mask,
                         fast_math=fast)
    assert torch.equal(k1, k2) and torch.equal(k1, k3)


# K2 in bf16 on the same edges, against its plain version.

def _bf16_holds(img, ids, params, filters, **kw):
    """K2 in bf16 against its bf16 plain version: at most 1e-3 of the values
    more than 1 LSB (u8) or 2 bf16 ulps (f32) apart.  Returns the kernel's
    output."""
    before = kernels.launch_counts()
    got = apply_filter_chain_switch(img, ids, params, filters,
                                    compute_dtype=torch.bfloat16, **kw)
    assert kernels.launch_counts() - before == {'switch_chain': 1,
                                                'switch_chain_bf16': 1}
    if 'out' in kw:
        kw = dict(kw, out=torch.zeros_like(img))
    want = apply_filter_chain_switch_reference(
        img, ids, params, filters, compute_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert got.dtype == img.dtype and got.shape == img.shape
    if got.dtype == torch.uint8:
        off = (got.int() - want.int()).abs() > 1
    else:
        off = (got - want).abs() > 2.0 ** -7 * torch.clamp(want.abs(), min=1.0)
    assert float(off.float().mean()) <= 1e-3
    return got


def _bf16_case(rng, config, dtype, device, **shape):
    filters, img, ids, _, mask = _case(rng, config, dtype, device, **shape)
    return filters, img, ids, _regressed(rng, filters, ids).to(device), mask


@pytest.mark.cuda
def test_packed_bf16_ops_match_scalar_forms(cuda_device):
    """Every packed bf16 operation the kernels run gives the bits of its
    scalar f32-then-round form on all 2^32 operand pairs (a pair of NaNs
    aside); the native max and min, which no kernel runs, do not (a NaN
    second operand, zeros of opposite sign)."""
    counts = bf16_probe.check_packed_ops(cuda_device)
    assert set(counts) == set(bf16_probe.PACKED_OPS)
    for op in ('add', 'sub', 'mul', 'max', 'min', 'ge', 'le', 'gt', 'abs',
               'neg'):
        assert counts[op]['differ'] == 0, (op, counts[op])
        assert counts[op]['checked'] == (2 ** 16 if op in ('abs', 'neg')
                                         else 2 ** 32)
    for op in ('hmax', 'hmin'):
        assert counts[op]['differ'] > 0 and counts[op]['zero_sign'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_switch_bf16_generic_curve_steps(cuda_device, config, fast, dtype):
    cfg = load_config(config)
    cfg.curve_steps = 5
    filters = build_filters(cfg)
    names = [type(f).__name__ for f in filters]
    rng = np.random.RandomState(12)
    _, img, _, _, mask = _case(rng, config, dtype, cuda_device)
    curves = [names.index('ToneFilter'), names.index('ColorFilter')]
    ids = torch.from_numpy(np.repeat(np.array(
        curves * 2 + curves[:1], np.int32)[:, None], 4, axis=1)).to(
            cuda_device)
    params = _regressed(rng, filters, ids).to(cuda_device)
    _bf16_holds(img, ids, params, filters, mask_params=mask, fast_math=fast)


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['synthetic_explore', 'masked'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_switch_bf16_unaligned_image_bases(cuda_device, config, dtype):
    """Odd shapes and a storage offset (every run on the scalar path): the
    slice gets the bits the whole batch gets."""
    rng = np.random.RandomState(13)
    filters, img, ids, params, mask = _bf16_case(rng, config, dtype,
                                                 cuda_device, b=5)
    whole = _bf16_holds(img, ids, params, filters, mask_params=mask,
                        fast_math=True)
    sub = img[1:]
    assert sub.is_contiguous() and sub.storage_offset() > 0
    part = _bf16_holds(sub, ids[:, 1:].contiguous(),
                       params[:, 1:].contiguous(), filters,
                       mask_params=None if mask is None else
                       mask[:, 1:].contiguous(), fast_math=True)
    assert torch.equal(whole[1:], part)


@pytest.mark.cuda
@pytest.mark.parametrize('hw', [(1, 1), (3, 5), (5, 7), (4, 4), (7, 9)],
                         ids=lambda s: '%dx%d' % s)
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_switch_bf16_ragged_pixel_runs(cuda_device, hw, dtype):
    rng = np.random.RandomState(14)
    filters, img, ids, params, _ = _bf16_case(
        rng, 'synthetic_explore', dtype, cuda_device, b=3, h=hw[0], w=hw[1])
    _bf16_holds(img, ids, params, filters, fast_math=True)


@pytest.mark.cuda
@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_switch_bf16_masked_bank_every_branch(cuda_device, fast, dtype):
    rng = np.random.RandomState(15)
    k = len(build_filters(load_config('masked')))
    filters, img, _, _, mask = _case(rng, 'masked', dtype, cuda_device, b=2,
                                     k=k, h=45, w=77)
    ids = torch.arange(k, dtype=torch.int32, device=cuda_device)[:, None] \
        .repeat(1, 2).contiguous()
    params = _regressed(rng, filters, ids).to(cuda_device)
    _bf16_holds(img, ids, params, filters, mask_params=mask, fast_math=fast)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_switch_bf16_shuffled_rows(cuda_device, dtype):
    """``rows`` in a shuffled order and ``n_active`` below the slot count:
    each active slot writes its own image, the others stay."""
    rng = np.random.RandomState(16)
    filters, img, ids, params, _ = _bf16_case(rng, 'synthetic_explore', dtype,
                                              cuda_device, b=9)
    rows = torch.from_numpy(rng.permutation(9)[:7].astype(np.int32)).to(
        cuda_device)
    out = _bf16_holds(img, ids, params, filters, fast_math=True, rows=rows,
                      out=torch.zeros_like(img), n_active=5)
    idle = sorted(set(range(9)) - set(rows[:5].tolist()))
    assert not out[idle].any()


# [B, H, W] of the probe inputs: 16-byte chunks only, and a ragged end
PROBE_SIZES = {'small': (2, 64, 64), 'odd': (3, 37, 53)}


def _probe_input(cuda_device, shape):
    rng = np.random.RandomState(6)
    return torch.from_numpy((rng.rand(*shape) * 255).astype(np.uint8)).to(
        cuda_device)


def _max_lsb(got, want):
    assert got.dtype == torch.uint8 and got.shape == want.shape
    return int((got.int() - want.int()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('size', list(PROBE_SIZES))
def test_mono_probe_matches_plain(cuda_device, size):
    b, h, w = PROBE_SIZES[size]
    img = _probe_input(cuda_device, (b, h, w, 3))
    for op in mono_probe.MONO_OPS:
        for steps in (0, 1, 5):
            before = _launched('mono_probe')
            got = mono_probe.mono_chain(img, steps, op)
            assert _launched('mono_probe') == before + 1
            want = mono_probe.mono_chain_reference(img, steps, op)
            torch.cuda.synchronize()
            assert _max_lsb(got, want) <= 1, (op, steps)


@pytest.mark.cuda
@pytest.mark.parametrize('size', list(PROBE_SIZES))
def test_fastmath_probe_matches_plain(cuda_device, size):
    b, h, w = PROBE_SIZES[size]
    img = _probe_input(cuda_device, (b, 3, h, w))
    for op in fastmath_probe.OPS:
        before = _launched('fastmath_probe')
        got = fastmath_probe.run_op(img, op)
        assert _launched('fastmath_probe') == before + 1
        want = fastmath_probe.run_op_reference(img, op)
        torch.cuda.synchronize()
        assert _max_lsb(got, want) <= 1, op


@pytest.mark.cuda
@pytest.mark.parametrize('size', list(PROBE_SIZES))
def test_bf16_probe_matches_plain(cuda_device, size):
    b, h, w = PROBE_SIZES[size]
    img = _probe_input(cuda_device, (b, 1, h, w))
    for op in bf16_probe.OPS:
        outs = {}
        for style in bf16_probe.STYLES:
            before = _launched('bf16_probe')
            got = bf16_probe.run_probe(img, bf16_probe.PARAMS, op, style, 8)
            assert _launched('bf16_probe') == before + 1
            want = bf16_probe.run_probe_reference(img, bf16_probe.PARAMS, op,
                                                  style, 8)
            torch.cuda.synchronize()
            if style == 'f32':
                assert _max_lsb(got, want) <= 1, op
            else:
                off = (got.int() - want.int()).abs() > 1
                assert float(off.float().mean()) <= 1e-3, (op, style)
            outs[style] = got
        assert torch.equal(outs['bf16_cast'], outs['bf16_splat']), op


@pytest.mark.cuda
@pytest.mark.parametrize('length', [1, 15, 17, 4097, 16 * 1024 + 5,
                                    3 * 16 * 1024 + 16 * 255 + 9])
def test_bf16_probe_odd_lengths(cuda_device, length):
    """Odd byte counts: below a thread's 16 bytes, a ragged end in the first
    block and in later ones, and past a block's 4 KiB."""
    rng = np.random.RandomState(17)
    img = torch.from_numpy(rng.randint(0, 256, (1, 1, 1, length)).astype(
        np.uint8)).to(cuda_device)
    for op in bf16_probe.OPS:
        for style in bf16_probe.STYLES:
            got = bf16_probe.run_probe(img, bf16_probe.PARAMS, op, style, 8)
            want = bf16_probe.run_probe_reference(img, bf16_probe.PARAMS, op,
                                                  style, 8)
            torch.cuda.synchronize()
            assert _max_lsb(got, want) <= 1, (op, style)


@pytest.mark.cuda
def test_probes_refuse_unaligned_buffers(cuda_device):
    flat = torch.zeros(4097, dtype=torch.uint8, device=cuda_device)
    img = flat[1:].view(1, 1, 64, 64)     # 1 byte past an aligned start
    with pytest.raises(ValueError):
        bf16_probe.run_probe(img, bf16_probe.PARAMS, 'mul', 'f32', 1)


# -- evaluation on the card --------------------------------------------------

def _random_policy_evaluator(device, name='test', seed=0):
    """An evaluator of config ``name`` on seeded random weights, dropout
    off, so that the card and the CPU plan from the same numbers."""
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.models.networks import build_models
    cfg = load_config(name)
    cfg.dropout_keep_prob = 1.0
    cfg.name = name + '/none'
    torch.manual_seed(seed)
    _, policy, _, _ = build_models(cfg)
    return Evaluator(cfg, policy=policy, device=device)


def _seeded_photo(path, h, w, seed):
    from exposure_tpu_torch.utils.image_io import write_png
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
    img = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w] * 200 + \
        rng.randint(0, 40, (h, w, 3))
    write_png(path, img.astype(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['test', 'masked'])
def test_evaluator_replays_through_k1_and_matches_the_cpu(cuda_device,
                                                          config, tmp_path):
    """``eval_batched`` (f32 and u8) and ``eval`` step by step on the card:
    one K1 launch per resolution group and per applied step, no plain
    version reached, and the outputs equal the CPU evaluator's on the rows
    whose plans agree (f32 atol 3e-5 / rtol 1e-4 with at most 1e-4 of the
    values outside, u8 within 1 LSB)."""
    import exposure_tpu_torch.core.evaluator as tev
    import exposure_tpu_torch.ops.dyn_chain as dyn
    files = [str(tmp_path / n) for n in ('a.png', 'b.png', 'c.png')]
    _seeded_photo(files[0], 300, 452, 1)
    _seeded_photo(files[1], 131, 67, 2)
    _seeded_photo(files[2], 300, 452, 3)
    card = _random_policy_evaluator(cuda_device, config)
    cpu = _random_policy_evaluator('cpu', config)
    proxies = np.stack([tev.downsample_to_proxy(tev.load_linear_image(f))
                        for f in files])
    same = (card.plan_trajectory(proxies)[0].filter_ids.cpu() ==
            cpu.plan_trajectory(proxies)[0].filter_ids).all(dim=0).tolist()
    assert sum(same) >= 2, same
    saved = (dyn.apply_filter_chain_dynamic_reference,
             tev.apply_filter_chain, tev.apply_filter_step)

    def refuse(*a, **kw):
        raise AssertionError('the card path reached a plain version')

    for u8 in (False, True):
        want = cpu.eval_batched(files, output_dir=str(tmp_path / 'cpu'),
                                u8=u8)
        dyn.apply_filter_chain_dynamic_reference = refuse
        tev.apply_filter_chain = tev.apply_filter_step = refuse
        try:
            before = _launched('dyn_chain')
            got = card.eval_batched(files, output_dir=str(tmp_path / 'gpu'),
                                    u8=u8)
            assert _launched('dyn_chain') == before + 2
            if not u8:
                before = _launched('dyn_chain')
                steps = card.eval(files[:1], output_dir=str(tmp_path / 's'),
                                  step_by_step=True)[0]
                n = sum(s['applied'] for s in steps['debug'])
                assert _launched('dyn_chain') == before + n
        finally:
            (dyn.apply_filter_chain_dynamic_reference,
             tev.apply_filter_chain, tev.apply_filter_step) = saved
        for a, b in zip(got, want):
            assert a['file'] == b['file']
            if not same[files.index(a['file'])]:
                continue
            x, y = (torch.from_numpy(r['retouched']) for r in (a, b))
            if u8:
                x, y = ((t * 255).round().to(torch.uint8) for t in (x, y))
            assert _outlier_fraction(x, y) <= 1e-4
        if not u8 and same[0]:
            assert _outlier_fraction(
                torch.from_numpy(steps['retouched']),
                torch.from_numpy(want[0]['retouched'])) <= 1e-4


@pytest.mark.cuda
def test_edit_sequence_replays_through_k1(cuda_device):
    from exposure_tpu_torch.tools import edit_sequence
    filters = build_filters(load_config('masked'))
    rng = np.random.RandomState(4)
    names = [f.get_short_name() for f in filters]
    debug = []
    for i in range(4):
        fid = int(rng.randint(0, len(filters)))
        f = filters[fid]
        raw = torch.from_numpy(rng.randn(
            1, f.get_num_filter_parameters()).astype(np.float32))
        debug.append({
            'step': i, 'filter_id': fid, 'short_name': names[fid],
            'filter_parameters': f.filter_param_regressor(raw).numpy()[0],
            'mask_parameters': rng.randn(
                f.get_num_mask_parameters()).astype(np.float32),
            'applied': i != 2})
    image = (rng.rand(97, 131, 3) * 0.8).astype(np.float32)
    before = _launched('dyn_chain')
    got = edit_sequence.replay(image, debug, filters, device=cuda_device)
    assert _launched('dyn_chain') == before + 1
    want = edit_sequence.replay(image, debug, filters, device='cpu')
    assert _outlier_fraction(torch.from_numpy(got),
                             torch.from_numpy(want)) <= 1e-4


# -- training on the card ----------------------------------------------------

@pytest.mark.cuda
def test_outer_step_card_against_cpu(cuda_device):
    """One outer iteration (giters 2, citers 2) of the ``test`` config on
    the card against the CPU, from the same state and draws, within
    ``tools/train_check.py``'s bounds."""
    from exposure_tpu_torch.tools.train_check import card_against_cpu
    report = card_against_cpu(load_config('test'), cuda_device, giters=2,
                              citers=2)
    assert not report['failures'], report
    assert report['ids']['rows'] == 2 * load_config('test').batch_size


@pytest.mark.cuda
def test_trainer_runs_on_the_card(cuda_device, tmp_path):
    """Three iterations of the ``test`` config on the card by default:
    finite metrics, a checkpoint, and a restore equal bit for bit."""
    from exposure_tpu_torch.core.trainer import Trainer
    cfg = load_config('test')
    cfg.name = 'test/card'
    cfg.max_iter_step = 3
    trainer = Trainer(cfg, restore=True, model_root=str(tmp_path))
    assert trainer.device.type == 'cuda'
    metrics = trainer.train()
    trainer.close()
    assert np.isfinite(np.asarray(metrics)).all()
    assert all(v.device.type == 'cuda'
               for v in trainer.state.tensors().values())
    again = Trainer(cfg, restore=True, model_root=str(tmp_path))
    assert again.restore() == 4
    for k, v in trainer.state.tensors().items():
        got = again.state.tensors()[k]
        assert got.device.type == 'cuda' and torch.equal(got, v), k


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """A state on the card saved and restored into a template on the card:
    every tensor equal and on the card; the same file restores on the
    CPU."""
    from exposure_tpu_torch.core.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    cfg = load_config('test')
    nets = build_models(cfg)[1:]
    state = init_train_state(cfg, *nets, seed=1, device=cuda_device)
    state = state.replace(gen_params={k: v + 0.5 for k, v in
                                      state.gen_params.items()}, step=7)
    save_checkpoint(str(tmp_path), state, 7)
    template = init_train_state(cfg, *nets, seed=2, device=cuda_device)
    for device, like in ((cuda_device, template), ('cpu',
                                                     template.to('cpu'))):
        restored, step = restore_checkpoint(str(tmp_path), like)
        assert step == 7 and restored.step == 7
        for k, v in state.tensors().items():
            got = restored.tensors()[k]
            assert got.device.type == torch.device(device).type, k
            assert torch.equal(got.cpu(), v.cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'uint8'])
def test_bundle_feeder_uploads_from_pinned_buffers(cuda_device, tmp_path,
                                                   dtype):
    """The streaming producer on the card: each bundle lands on the device
    equal to the host assembly of the same provider seeds, the compute
    stream waits on its copy, the copy's events time it, and a shape keeps
    at most ``slots + 2`` pinned buffers however many bundles pass."""
    from exposure_tpu_torch.core.streaming import (
        BundleFeeder, assemble_stream)
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    from exposure_tpu_torch.data.synthetic import make_synthetic_pack
    raw, real = str(tmp_path / 'raw.npy'), str(tmp_path / 'real.npy')
    np.save(raw, make_synthetic_pack(12, 80, 'raw', 0))
    np.save(real, make_synthetic_pack(12, 64, 'retouched', 1))
    cfg = load_config('test')
    cfg.stream_dtype = dtype

    def providers():
        return (NativePackProvider(raw, 64, 0.3, seed=3),
                NativePackProvider(real, 64, 1.0, seed=4))
    keys = [(1, 0, 1), (0, 2, 1), (1, 2, 3)] * 4
    feeder = BundleFeeder(cfg, False, *providers(),
                          [('bundle', k) for k in keys], cuda_device,
                          slots=2)
    feeder.timings = []
    host = providers()
    try:
        for key in keys:
            got = feeder.next()
            want = assemble_stream(cfg, False, *host, *key)
            for a, b in zip(got, want):
                assert a.device.type == 'cuda' and a.dtype == (
                    torch.uint8 if dtype == 'uint8' else torch.float32)
                assert torch.equal(a.cpu(), torch.from_numpy(b))
        torch.cuda.synchronize()
        assert len(feeder.timings) == len(keys)
        for row in feeder.timings:
            start, done = row['copy']
            assert start.elapsed_time(done) >= 0
        assert max(feeder._count.values()) <= feeder.slots + 2
    finally:
        feeder.close()


@pytest.mark.cuda
def test_streaming_trainer_on_the_card(cuda_device, tmp_path):
    """A streaming run of ``test`` on the card by default: finite metrics,
    and the same parameters as a second run from the same seed."""
    import random
    from exposure_tpu_torch.core.trainer import Trainer
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    from exposure_tpu_torch.data.synthetic import make_synthetic_pack
    raw, real = str(tmp_path / 'raw.npy'), str(tmp_path / 'real.npy')
    np.save(raw, make_synthetic_pack(24, 80, 'raw', 0))
    np.save(real, make_synthetic_pack(24, 64, 'retouched', 1))
    states = []
    for run in ('a', 'b'):
        cfg = load_config('test')
        cfg.update(name='stream/' + run, max_iter_step=5, stream_data=True,
                   stream_iters_per_dispatch=3, stream_dtype='uint8')
        cfg.fake_data_provider = lambda: NativePackProvider(
            raw, 64, 0.3, seed=0)
        cfg.real_data_provider = lambda: NativePackProvider(
            real, 64, 0.0, seed=1)
        random.seed(0)
        torch.backends.cudnn.deterministic = True
        trainer = Trainer(cfg, model_root=str(tmp_path))
        try:
            metrics = trainer.train()
        finally:
            trainer.close()
            torch.backends.cudnn.deterministic = False
        assert np.isfinite(np.asarray(metrics)).all()
        assert trainer.pool.images.device.type == 'cuda'
        states.append(trainer.state.tensors())
    a, b = states
    assert all(torch.equal(a[k], b[k]) for k in a)


# --- data parallelism on the card (exposure_tpu_torch/parallel) -----------
@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['resident', 'streaming'])
def test_one_rank_nccl_step_is_the_no_group_step(cuda_device, tmp_path,
                                                 kind):
    """The step under a world-size-1 ``nccl`` group (its all-reduce runs,
    then divides by 1) equals the step without a mesh bit for bit, with a
    second step without a mesh as the control."""
    import torch_parallel_workers as W
    from exposure_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    rng = np.random.RandomState(3)
    cfg = load_config('test')
    b, p = cfg.batch_size, cfg.replay_memory_size
    states = np.zeros((p, cfg.num_state_dim), np.float32)
    states[::3, 1] = 1
    job = dict(kind=kind, knobs={}, giters=2, citers=2, seed=3,
               rates=(1e-3, 1e-3, 0.3), meta=(64, True),
               pool=(rng.rand(p, 64, 64, 3).astype(np.float32), states, None))
    job['data'] = (rng.rand(40, 80, 80, 3).astype(np.float32),
                   rng.rand(40, 64, 64, 3).astype(np.float32)) \
        if kind == 'resident' else (
            rng.rand(2, 2 * b + p, 64, 64, 3).astype(np.float32),
            rng.rand(2, b, 64, 64, 3).astype(np.float32))
    mesh = data_parallel_mesh(1, backend='nccl', device='cuda', rank=0,
                              init_file=str(tmp_path / 'rdv'))
    try:
        assert mesh.grouped and mesh.backend == 'nccl'
        with deterministic_algorithms():
            grouped = W.step_rank(mesh, job)
            alone = Mesh(0, 1, mesh.device, None)
            plain = [W.step_rank(alone, dict(job, use_mesh=False))
                     for _ in range(2)]
    finally:
        mesh.close()
    for other in (plain[1], grouped):
        assert other['metrics'] == plain[0]['metrics']
        for k, v in plain[0]['tensors'].items():
            np.testing.assert_array_equal(other['tensors'][k], v, err_msg=k)
        np.testing.assert_array_equal(other['pool'][0], plain[0]['pool'][0])


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(cuda_device, tmp_path):
    """Two ``gloo`` ranks over CUDA tensors on one card: three iterations
    of ``test``, the same parameters on both ranks bit for bit."""
    import torch_parallel_workers as W
    from exposure_tpu_torch.parallel.launch import spawn_ranks
    job = dict(knobs={}, runs=['shared'], last_iter=2, root=str(tmp_path),
               device='cuda')
    ranks = spawn_ranks(W.trainer_rank, 2, (job,), device='cuda',
                        backend='gloo', deadline_s=300,
                        rendezvous_dir=str(tmp_path))
    a, b = (r['shared'] for r in ranks)
    assert np.isfinite(np.asarray(a['metrics'])).all()
    for k, v in a['tensors'].items():
        np.testing.assert_array_equal(b['tensors'][k], v, err_msg=k)
    assert not np.array_equal(a['pool'], b['pool'])


@pytest.mark.cuda
def test_nccl_refuses_two_ranks_on_one_card(cuda_device, tmp_path):
    from exposure_tpu_torch.parallel.mesh import data_parallel_mesh
    if torch.cuda.device_count() > 1:
        pytest.skip('the machine has a card a rank')
    with pytest.raises(ValueError, match="backend='gloo'"):
        data_parallel_mesh(2, backend='nccl', device='cuda', rank=0,
                           init_file=str(tmp_path / 'rdv'))


# --- the fused N-iteration dispatch on the card (core/fused.py) ----------
@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['resident', 'stream_uint8'])
def test_captured_iterations_equal_the_eager_ones(cuda_device, tmp_path,
                                                  kind):
    """Iterations 1-4 of ``test`` through the fused step (the first run
    eagerly as the warm-up, then captured; 2-4 replayed) and through
    ``run_iteration``, from the same state and pool, under deterministic
    cuDNN: every state tensor, the counts, the pool and the metrics equal
    bit for bit."""
    import torch_parallel_workers as W
    from exposure_tpu_torch.core.trainer import Trainer
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    cfg = load_config('test')
    cfg.name = 'fused/' + kind
    if kind != 'resident':
        cfg.update(stream_data=True, stream_dtype='uint8')
    trainer = Trainer(cfg, restore=True, model_root=str(tmp_path))
    try:
        with deterministic_algorithms():
            if kind == 'resident':
                trainer.train(last_iter=0)
            else:
                trainer.state = trainer.state.replace(step=1)
                rng = np.random.RandomState(7)
                b, p = cfg.batch_size, cfg.replay_memory_size
                g = rng.randint(0, 256, (4, 1, 2 * b + p, 64, 64, 3))
                r = rng.randint(0, 256, (4, cfg.citers, b, 64, 64, 3))
                group = (1, 4, tuple(torch.from_numpy(x.astype(np.uint8)).to(
                    cuda_device) for x in (g, r)))
                trainer._stream_take = lambda it, n: group
            fused, plain = W.fused_and_plain(trainer, 1, 4)
    finally:
        trainer.close()
    runner = next(v for k, v in trainer._steps.items() if k[0] == 'fused')
    assert runner.graphs and runner.captures == 1 and runner.replays == 3
    assert W.differing(fused, plain) == []
    assert torch.isfinite(fused[2]).all()


@pytest.mark.cuda
def test_replay_after_manual_seed_draws_the_eager_draws(cuda_device):
    """A graph of a step's kinds of draw (uniform, randint, bernoulli,
    categorical) with its generator registered: each replay after
    ``manual_seed(s)`` draws what the eager calls draw after it."""
    from exposure_tpu_torch.utils.draws import Draws
    g = torch.Generator(device=cuda_device)
    logits = torch.zeros(16, device=cuda_device)

    def draw(draws, out):
        values = (draws.uniform('u', (64, 3)),
                  draws.randint('i', 1000, (32,)).float(),
                  draws.bernoulli('b', 0.3, (40,)).float(),
                  draws.categorical('c', logits, 24).float())
        for dst, src in zip(out, values):
            dst.copy_(src)

    out = [torch.zeros(s, device=cuda_device)
           for s in ((64, 3), (32,), (40,), (24,))]
    draws = Draws(g, cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draw(draws, out)            # the warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=side):
        draw(draws, out)
    for seed in (5, 11, 5):
        g.manual_seed(seed)
        graph.replay()
        got = [x.clone() for x in out]
        g.manual_seed(seed)
        want = [torch.zeros_like(x) for x in out]
        draw(draws, want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(got[0], out[0] * 0)


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda_device):
    """A body that waits on the device (a host read) cannot be captured:
    the runner raises, keeps no graph, and raises again on the next chunk;
    it never runs the chunk eagerly instead."""
    from exposure_tpu_torch.core.fused import FusedRunner
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import StepMetrics
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.draws import Draws
    cfg = load_config('test')
    state = init_train_state(cfg, *build_models(cfg)[1:],
                             device=cuda_device)
    pool = PoolState.create(torch.rand(4, 8, 8, 3, device=cuda_device),
                            cfg.num_state_dim)
    g = torch.Generator(device=cuda_device)
    calls = []

    def body(st, pl, data, draws, sc):
        calls.append(float(pl.images.sum()))     # a host read
        zero = torch.zeros((), device=cuda_device)
        return st, pl, StepMetrics(*[zero + sc.lr_g] * 7)

    import types
    runner = FusedRunner(
        body, lambda st, lr_g, lr_c, progress: [lr_g, lr_c, progress],
        lambda vec: types.SimpleNamespace(lr_g=vec[0]), 3, 0, 0,
        lambda it: Draws(g.manual_seed(it), cuda_device), g)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            runner.run(state, pool, (), [1, 2], [1e-3] * 2, [1e-3] * 2,
                       [0.1] * 2)
        assert runner.graph is None and runner.replays == 0
    assert len(calls) == 2      # each run's warm-up; each capture raised


def _test_runs(root, device='cpu'):
    """Two ``test`` runs checkpointed from initial states (seeds 0, 1)."""
    import os
    from exposure_tpu_torch.core.checkpoint import save_checkpoint
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    cfg = load_config('test')
    for seed, run in enumerate(('test/a', 'test/b')):
        state = init_train_state(cfg, *build_models(cfg)[1:], seed=seed)
        save_checkpoint(os.path.join(root, run), state, 5 + seed)
    return str(root)


@pytest.mark.cuda
def test_serving_tools_run_on_the_card(cuda_device, tmp_path, monkeypatch):
    """Each serving and streaming tool's ``main`` at a small size, on the
    card by default (no ``--device``)."""
    from exposure_tpu_torch.tools import (
        bench_dyn_probe,
        bench_serving_split,
        bench_stream_device,
        drive_refreeze,
        export_serving,
        probe_selected_plan,
        warmup_serving,
    )
    root = _test_runs(tmp_path / 'models')
    monkeypatch.chdir(tmp_path)
    run = ['--run', 'test/a', '--model-root', root]
    assert export_serving.main(run + ['--out', str(tmp_path / 'a.gz'),
                                      '--verify']) == 0
    rep = probe_selected_plan.main(run + ['--batch', '8', '--batches', '2'])
    assert rep['ids_total'] == 80
    before = _launched('dyn_chain')
    warm = warmup_serving.main(run + ['--batch', '4', '--res', '64',
                                      '--probes', '2', '--seeds', '2',
                                      '--decompose'])
    assert warm['budget_misses'] >= 0
    dyn = warmup_serving.main(run + ['--batch', '4', '--res', '64',
                                     '--seeds', '2', '--dynamic'])
    assert dyn['mode'] == 'dynamic'
    assert _launched('dyn_chain') > before
    split = bench_serving_split.main(run + ['--batch', '8', '--res', '64',
                                            '--runs', '2'])
    assert split['replay_grouped_ms'] > 0
    probe = bench_dyn_probe.main(['--batch', '16', '--res', '64'])
    assert probe['dyn_max_lsb'] <= 1 or probe['dyn_frac_above_1'] <= 1e-4
    assert drive_refreeze.main(['--run-a', 'test/a', '--run-b', 'test/b',
                                '--model-root', root, '--batch', '8',
                                '--res', '64', '--pre', '3', '--post', '12',
                                '--record', '2', '--recover', '2']) in (0, 1)
    stream = bench_stream_device.main(['--config', 'test', '--fuse', '2',
                                       '--disp', '2', '--warm', '1'])
    assert stream['captures'] == 1 and stream['replays'] > 0


@pytest.mark.cuda
def test_swap_remakes_the_bf16_plan(cuda_device):
    """``load_policy`` under ``bf16=True``: the plan equals a fresh bf16
    pipeline's on the new weights bit for bit; loading the weights into
    ``policy`` alone would go on planning with the old bf16 copy."""
    import copy
    from exposure_tpu_torch.core.serving import (
        RetouchPipeline,
        batch_generator,
    )
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    cfg = load_config('test')
    policies = []
    for seed in (0, 1):
        _, policy, critic, value = build_models(cfg)
        state = init_train_state(cfg, policy, critic, value, seed)
        policy.load_state_dict(state.gen_params)
        policies.append(policy)
    imgs = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                         device=cuda_device)
    pipe = RetouchPipeline(cfg, copy.deepcopy(policies[0]), bf16=True)
    fresh = RetouchPipeline(cfg, copy.deepcopy(policies[1]), bf16=True)
    pipe.load_policy(policies[1].state_dict(), run='b', step=1)
    with torch.no_grad(), deterministic_algorithms():
        got = pipe.plan(pipe.proxy(imgs), batch_generator(3, 0, cuda_device))
        want = fresh.plan(fresh.proxy(imgs),
                          batch_generator(3, 0, cuda_device))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(pipe(imgs, 3, device_out=True),
                       fresh(imgs, 3, device_out=True))


@pytest.mark.cuda
def test_runner_records_the_routes_it_ran(cuda_device):
    """``GroupedChainRunner.routes``: a warm-up's routes, then traffic's;
    a batch on a warmed route adds none."""
    from exposure_tpu_torch.ops.grouped_chain import GroupedChainRunner
    filters = build_filters(load_config('synthetic_explore'))
    runner = GroupedChainRunner(filters, fused_set_limit=0)
    sig_a, sig_b = (0, 1, 2, 3, 4), (4, 3, 2, 1, 0)
    shape = (24, 64, 64, 3)
    assert runner.warmup([(sig_a, 16), (sig_b, 8)], shape, torch.uint8, 5,
                         24, device=cuda_device) == 2
    ids = torch.tensor([sig_a] * 16 + [sig_b] * 8, dtype=torch.int32,
                       device=cuda_device).T.contiguous()
    img = torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda_device)
    params = torch.rand(5, 24, 24, device=cuda_device)
    runner(img, ids, params)
    assert runner.last_route['route'] == 'accumulate'
    assert len(runner.routes) == 2
    runner(img[:8], ids[:, 16:].contiguous(), params[:, 16:].contiguous())
    assert ('single', sig_b, 8, (64, 64), 'uint8') in runner.routes
    assert len(runner.routes) == 3


@pytest.mark.cuda
@pytest.mark.parametrize('config', ['test', 'synthetic_explore'])
def test_critic_scores_on_the_card_as_on_the_cpu(cuda_device, config):
    """``Evaluator.critic_logits``, which ``probe_critic_family`` and
    ``select_policy`` rank runs by: the card's logits (TF32 off) within
    1e-4 relative of the CPU's on the same train state and images."""
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    cfg = load_config(config)
    cfg.name = config + '/none'
    state = init_train_state(cfg, *build_models(cfg)[1:], 4)
    state = state.replace(crit_params={
        k: v * 1.01 + 1e-3 for k, v in state.crit_params.items()})
    imgs = np.random.RandomState(5).rand(64, 64, 64, 3).astype(np.float32)
    card = Evaluator(cfg, state=state, device=cuda_device)
    cpu = Evaluator(cfg, state=state, device='cpu')
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    # TF32 asked for around the call: critic_logits turns it off inside
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = card.critic_logits(imgs)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    want = cpu.critic_logits(imgs)
    assert got.shape == want.shape == (64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# -- serving as one program a batch (core/serving_graph.py) ----------------
SERVING_MODES = {
    'dynamic_selected_plan': {},
    'dynamic_bank_plan': dict(dynamic=True, selected_plan=False),
    'switch': dict(dynamic=False, grouped=False),
    'grouped': dict(grouped=True, fused_set_limit=0),
}


def _serving_pipes(cuda_device, mode, seed=3, **kw):
    """A graph pipeline and a per-call one on one random ``test`` policy,
    dropout on."""
    from exposure_tpu_torch.core.serving import RetouchPipeline
    from exposure_tpu_torch.models.networks import build_policy, init_like_flax
    cfg = load_config('test')
    policy = init_like_flax(build_policy(cfg, build_filters(cfg)),
                            torch.Generator().manual_seed(seed)).eval()
    return [RetouchPipeline(cfg, policy, device=cuda_device, graphs=g,
                            **SERVING_MODES[mode], **kw)
            for g in (True, False)]


def _serving_batches(cuda_device, n=3, b=8, h=64, w=96):
    g = torch.Generator(device=cuda_device).manual_seed(21)
    return [torch.randint(0, 256, (b, h, w, 3), generator=g,
                          dtype=torch.uint8, device=cuda_device)
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize('mode', sorted(SERVING_MODES))
def test_batch_graph_equals_the_per_call_path(cuda_device, mode):
    """Each mode with ``graphs=True`` (a non-grouped batch one replay, a
    grouped batch's plan one replay) against ``graphs=False``, bit for bit
    under deterministic algorithms, with a second per-call run as the
    control; one capture; the kernels' executions per batch equal the
    per-call path's launches (a capture's launches times its replays)."""
    from exposure_tpu_torch.core import serving_graph as sg
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    graph, eager = _serving_pipes(cuda_device, mode)
    batches = _serving_batches(cuda_device)
    counts = {}
    with deterministic_algorithms():
        graph.warmup(batches[0], probe_batches=1)
        outs = {}
        for tag, pipe in (('eager', eager), ('control', eager),
                          ('graph', graph)):
            before = sg.executions(kernels.launch_counts())
            outs[tag] = list(pipe.map_batches(batches, seed=5,
                                              device_out=True))
            torch.cuda.synchronize()
            counts[tag] = sg.executions(kernels.launch_counts()) - before
    for a, b, c in zip(outs['graph'], outs['eager'], outs['control']):
        assert torch.equal(b, c)
        assert torch.equal(a, b)
    assert counts['graph'] == counts['eager']
    assert sum(counts['graph'].values()) > 0
    assert graph.graph_report()['captures'] == 1
    if not graph.grouped:
        launches = list(graph.graph_report()[
            'launches_per_replay'].values())[0]
        assert {k: v * len(batches) for k, v in launches.items()} == \
            {k: v for k, v in counts['graph'].items() if v}


@pytest.mark.cuda
def test_batch_graph_replays_without_a_host_sync(cuda_device):
    """After the warm-up's capture, a stream of batches on the card (the
    input copies, the reseeds, the replays and the output copies) makes no
    host synchronisation: the sync debug mode raises on any."""
    graph, _ = _serving_pipes(cuda_device, 'dynamic_selected_plan')
    batches = _serving_batches(cuda_device, n=4)
    graph.warmup(batches[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        outs = list(graph.map_batches(batches, seed=1, device_out=True))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(outs) == 4 and graph.graph_report()['replays'] == 5


@pytest.mark.cuda
def test_release_frees_the_graph_pool(cuda_device):
    """A graph's pool holds the batch's f32 copy (201 MB at [64, 512, 512,
    3]), its static input and output (50 MB each): ``release`` gives it
    back.  What stays is less than the static output (cuBLAS keeps a
    workspace for each stream it ran on, the warm-up's side stream too)."""
    import gc
    graph, _ = _serving_pipes(cuda_device, 'dynamic_selected_plan')
    batch = _serving_batches(cuda_device, n=1, b=64, h=512, w=512)[0]
    mb = 2 ** 20
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = (torch.cuda.memory_allocated(),
                           torch.cuda.memory_reserved())
    graph(batch, device_out=True)
    torch.cuda.synchronize()
    live = torch.cuda.memory_reserved()
    assert live - reserved > 250 * mb
    graph.release()
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() - allocated < 50 * mb
    assert live - torch.cuda.memory_reserved() > 200 * mb


@pytest.mark.cuda
def test_evaluator_plan_graph_on_the_card(cuda_device):
    """The evaluator's plan as one replay a proxy shape equals its per-call
    plan bit for bit (deterministic algorithms), and leaves the caller's
    generator where the per-call plan leaves it."""
    import copy
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.serving import batch_generator
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    ev = _random_policy_evaluator(cuda_device)
    ev.cfg.dropout_keep_prob = 0.5
    evs = {g: Evaluator(ev.cfg, policy=copy.deepcopy(ev.policy),
                        device=cuda_device, graphs=g) for g in (True, False)}
    for e in evs.values():
        for m in (e.policy.shared_extractor, e.policy.selector_extractor):
            m.dropout_keep_prob = 0.5
    proxies = np.random.RandomState(2).rand(5, 64, 64, 3).astype(np.float32)
    plans = {}
    with deterministic_algorithms():
        for g, e in evs.items():
            gen = batch_generator(7, 0, cuda_device)
            plans[g] = [e.plan_trajectory(proxies, gen)[0]
                        for _ in range(2)] + [gen.get_state()]
    for a, b in zip(plans[True][:2], plans[False][:2]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(plans[True][2], plans[False][2])
    assert evs[True]._graphs.report()['captures'] == 1


@pytest.mark.cuda
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_load_policy_under_a_live_graph(cuda_device, bf16):
    """A swap after the capture: the next replay serves the new weights,
    bit for bit a fresh per-call pipeline on them, without a new
    capture."""
    import copy
    from exposure_tpu_torch.core.serving import RetouchPipeline
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    graph, _ = _serving_pipes(cuda_device, 'dynamic_selected_plan', seed=3,
                              bf16=bf16)
    other, _ = _serving_pipes(cuda_device, 'dynamic_selected_plan', seed=4)
    fresh = RetouchPipeline(graph.cfg, copy.deepcopy(other.policy),
                            device=cuda_device, bf16=bf16, graphs=False)
    batch = _serving_batches(cuda_device, n=1)[0]
    with deterministic_algorithms():
        before = graph(batch, 2, 0, device_out=True)
        graph.load_policy(other.policy.state_dict())
        got = graph(batch, 2, 0, device_out=True)
        want = fresh(batch, 2, 0, device_out=True)
    assert torch.equal(got, want) and not torch.equal(got, before)
    assert graph.graph_report()['captures'] == 1


@pytest.mark.cuda
def test_bench_truth_chain_against_plain(cuda_device):
    """``bench_truth``'s dependency-serialized K2 chain on the card (each
    call's u8 output the next call's input) against the same chain through
    the plain version: within 1 LSB at every link."""
    from exposure_tpu_torch.tools import bench_truth
    filters = build_filters(load_config('example'))
    img = bench_truth.images(4, 96)
    for name, mix in bench_truth.MIXES.items():
        ids, params = bench_truth.make_traj(filters, mix, 5, 4)
        x, want = img.to(cuda_device), img
        for _ in range(3):
            x = apply_filter_chain_switch(x, ids.to(cuda_device),
                                          params.to(cuda_device), filters)
            got = x.cpu()
            want = apply_filter_chain_switch_reference(want, ids, params,
                                                       filters)
            assert int((got.int() - want.int()).abs().max()) <= 1, name
            want = got     # the next link starts from the card's output
        _, last = bench_truth.serialized_time(
            apply_filter_chain_switch, img.to(cuda_device), 2,
            ids.to(cuda_device), params.to(cuda_device), filters)
        assert torch.equal(last.cpu(), got), name


@pytest.mark.cuda
@pytest.mark.parametrize('mb', [1, 27])
def test_bench_upload_pinned_bytes_equal_pageable(cuda_device, mb):
    from exposure_tpu_torch.core.streaming import host_buffers
    from exposure_tpu_torch.tools import bench_upload
    n = mb * (1 << 20) // 4
    host = np.random.RandomState(mb).rand(n).astype(np.float32)
    (buf,) = host_buffers(((n,),), torch.float32, True)
    assert buf.is_pinned()
    buf.numpy()[...] = host
    side = torch.cuda.Stream(cuda_device)
    pinned = bench_upload.pinned_upload(buf, cuda_device, side)
    pageable = bench_upload.pageable_upload(host, cuda_device)
    assert pinned.device.type == 'cuda' and torch.equal(pinned, pageable)
    assert np.array_equal(pinned.cpu().numpy(), host)


# -- one precision whatever the process's TF32 flags (utils/precision.py) --
ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'artifacts', 'serving', 'synthetic_explore--best.msgpack.gz')


@contextlib.contextmanager
def _process_tf32(on):
    """The process's TF32 flags set to ``on`` inside the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = (on, on)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize('selected_plan', [True, False],
                         ids=['selected_plan', 'bank_plan'])
def test_pipeline_plans_the_evaluators_ids_under_both_flags(cuda_device,
                                                            selected_plan):
    """The trained ``synthetic_explore`` artifact at full width, dropout
    off, on one seeded batch of its test data (B=64), under deterministic
    algorithms: with the process's TF32 flags on and then off, the
    pipeline's [K, B] ids, per call and as a graph, equal the
    ``Evaluator``'s plan ids; the pipeline's plan (ids, params, mask) and
    the Evaluator's trajectory are the same bits under either setting, and
    the bank plan's params are the Evaluator's (the same ``rollout``).  The
    selected plan advances the proxy through K1 with the exact branch set
    (``fast_math=False``), the filters the Evaluator's bank plan runs."""
    import random
    from exposure_tpu_torch.core.artifacts import (
        flax_to_state_dict,
        load_artifact,
    )
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.serving import (
        RetouchPipeline,
        batch_generator,
    )
    from exposure_tpu_torch.models.networks import build_policy
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    cfg = load_config('synthetic_explore')
    cfg.name = 'synthetic_explore/best'
    cfg.dropout_keep_prob = 1.0
    weights = flax_to_state_dict(load_artifact(ARTIFACT)['gen_params'])

    def policy():
        net = build_policy(cfg, build_filters(cfg))
        net.load_state_dict(weights)
        return net
    random.seed(0)
    base, _ = cfg.fake_data_provider_test().get_next_batch(64)
    imgs = torch.from_numpy((np.clip(base, 0, 1) * 255).astype(
        np.uint8)).to(cuda_device)
    plans, trajs = {}, {}
    for on in (True, False):
        with _process_tf32(on), deterministic_algorithms():
            ev = Evaluator(cfg, policy=policy(), device=cuda_device)
            for graphs in (True, False):
                pipe = RetouchPipeline(
                    cfg, policy(), device=cuda_device, dynamic=True,
                    selected_plan=selected_plan, fast_math=False,
                    graphs=graphs)
                proxy = pipe.proxy(imgs)
                if graphs:
                    plan = pipe._plan_for(imgs, 0, 0)
                else:
                    plan = pipe.plan(proxy, batch_generator(0, 0,
                                                            cuda_device))
                plans[on, graphs] = [t.cpu() for t in plan]
                pipe.release()
            traj, _ = ev.plan_trajectory(proxy)
            trajs[on] = [t.cpu() for t in traj]
    want = trajs[False]
    assert want[2].shape == (cfg.test_steps, 64)
    assert all(torch.equal(a, b) for a, b in zip(trajs[True], want))
    ref = plans[False, False]
    for key, plan in plans.items():
        assert torch.equal(plan[0], want[2]), (
            key, int((plan[0] != want[2]).sum()))
        assert all(torch.equal(a, b) for a, b in zip(plan, ref)), key
    if not selected_plan:
        assert torch.equal(ref[1], want[3])


@pytest.mark.cuda
def test_outer_step_bit_equal_under_both_flags(cuda_device):
    """One ``build_outer_step`` iteration (giters 1, citers 1) of
    ``synthetic_explore`` at full width under deterministic algorithms,
    with the process's TF32 flags on and then off, from the same state,
    pool, packs and draws: its metrics, every update's gradients and the
    new state equal bit for bit."""
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import build_outer_step
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.draws import Draws
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    cfg = load_config('synthetic_explore')
    cfg.name = 'synthetic_explore/none'
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, seed=0,
                             device=cuda_device)
    rng = np.random.RandomState(0)
    p = cfg.replay_memory_size
    pool_images = torch.from_numpy(rng.rand(p, 64, 64, 3).astype(
        np.float32)).to(cuda_device)
    packs = [torch.from_numpy(rng.rand(256, s, s, 3).astype(
        np.float32)).to(cuda_device) for s in (80, 64)]
    runs = {}
    for on in (True, False):
        taps = []
        step = build_outer_step(cfg, policy, critic, value, filters,
                                (64, True), (64, True), 1, 1, taps=taps)
        pool = PoolState.create(pool_images.clone(), cfg.num_state_dim)
        pool.states[::3, 1] = 1.0
        with _process_tf32(on), deterministic_algorithms():
            st, _, metrics = step(state, pool, *packs, Draws(
                torch.Generator(cuda_device).manual_seed(0), cuda_device),
                cfg.lr_g(1), cfg.lr_c(1), 1 / cfg.max_iter_step)
        grads = [(tree, k, v) for tap in taps for tree, g in tap.items()
                 if isinstance(g, dict) for k, v in g.items()]
        runs[on] = (torch.stack(list(metrics)), grads, st.tensors())
    (m_on, g_on, s_on), (m_off, g_off, s_off) = runs[True], runs[False]
    assert bool(torch.isfinite(m_off).all())
    assert torch.equal(m_on, m_off), (m_on, m_off)
    assert len(g_on) == len(g_off) > 0
    for (tree, k, a), (_, _, b) in zip(g_on, g_off):
        assert torch.equal(a, b), (tree, k)
    assert [k for k in s_off if not torch.equal(s_on[k], s_off[k])] == []


# -- the policy's convolutions in cuDNN's float32 layout (models/networks.py)
_LAYOUT_CONVERSIONS = ('nhwcToNchw', 'nchwToNhwc')


def _conv_layouts(policy):
    """The memory layouts in which the convolutions of ``policy``'s
    extractors get their inputs from now on, counted by a forward pre-hook
    on each: ``nchw``, ``channels_last`` or ``other``."""
    import collections
    seen = collections.Counter()

    def layout(module, args):
        x = args[0]
        seen['nchw' if x.is_contiguous() else 'channels_last'
             if x.is_contiguous(memory_format=torch.channels_last)
             else 'other'] += 1
    for fx in (policy.shared_extractor, policy.selector_extractor):
        for conv in fx.convs:
            conv.register_forward_pre_hook(layout)
    return seen


def _device_kernels(fn):
    """The names of the kernels ``fn`` ran on the card, by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _artifact_policy(cuda_device):
    from exposure_tpu_torch.core.artifacts import (
        flax_to_state_dict,
        load_artifact,
    )
    from exposure_tpu_torch.models.networks import build_policy
    cfg = load_config('synthetic_explore')
    cfg.dropout_keep_prob = 1.0
    policy = build_policy(cfg, build_filters(cfg))
    policy.load_state_dict(flax_to_state_dict(
        load_artifact(ARTIFACT)['gen_params']))
    return cfg, policy.to(cuda_device)


@pytest.mark.cuda
def test_float32_policy_runs_without_layout_conversions(cuda_device):
    """One float32 ``PolicyNet`` forward on the artifact's weights at
    ``[512, 64, 64, 14]``: no cuDNN layout conversion kernel runs, both
    extractors' convolutions take NCHW input, and heads and logits equal the
    permute-only formulation (channels-last memory, whose conversions are
    exact copies around the same float32 kernels) bit for bit."""
    from exposure_tpu_torch.utils.ops import lrelu
    from exposure_tpu_torch.utils.precision import tf32_off
    cfg, policy = _artifact_policy(cuda_device)
    x = torch.rand(512, 64, 64, 3 + cfg.num_state_dim, device=cuda_device,
                   generator=torch.Generator(cuda_device).manual_seed(23))

    def permute_only(fx):
        h = (x - 0.5).permute(0, 3, 1, 2)
        for conv in fx.convs:
            h = lrelu(conv(h))
        return h.permute(0, 2, 3, 1).reshape(x.shape[0], fx.output_dim)

    out = {}
    with torch.no_grad(), tf32_off():
        policy(x)                                  # cuDNN's first calls
        seen = _conv_layouts(policy)
        names = _device_kernels(lambda: out.setdefault('got', policy(x)))
        layouts = dict(seen)      # before the permute-only convolutions
        shared = permute_only(policy.shared_extractor)
        sel = permute_only(policy.selector_extractor)
        want = [fc2(lrelu(fc1(shared)))
                for fc1, fc2 in zip(policy.filter_fc1, policy.filter_fc2)]
        want.append(policy.selector_fc2(lrelu(policy.selector_fc1(sel))))
    assert names, 'the profiler saw no kernel on the card'
    assert [n for n in names if any(c in n for c in _LAYOUT_CONVERSIONS)] \
        == []
    assert layouts == {'nchw': len(policy.shared_extractor.convs) +
                       len(policy.selector_extractor.convs)}
    raw, logits = out['got']
    for got, ref in zip(raw + [logits], want):
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_captured_selected_plan_extractor_layout(cuda_device, bf16):
    """One captured selected-plan batch of 512 photos on the artifact:
    every convolution of the graph's extractors takes its input in the
    layout its dtype chooses (NCHW in float32, channels-last in the bf16
    plan; a pre-hook sees the warm-up and the capture), and a replay of
    the float32 batch runs no cuDNN layout conversion kernel."""
    from exposure_tpu_torch.core import serving_graph as sg
    from exposure_tpu_torch.core.serving import RetouchPipeline
    pipe = RetouchPipeline.from_artifact('synthetic_explore', ARTIFACT,
                                         device=cuda_device, bf16=bf16)
    g = torch.Generator(device=cuda_device).manual_seed(29)
    batch = torch.randint(0, 256, (512, 96, 128, 3), generator=g,
                          dtype=torch.uint8, device=cuda_device)
    seen = _conv_layouts(pipe._plan_policy)
    pipe.warmup(batch)
    torch.cuda.synchronize()
    before = sg.executions(kernels.launch_counts())
    names = _device_kernels(lambda: pipe(batch, 7, 0, device_out=True))
    after = sg.executions(kernels.launch_counts())
    assert pipe.graph_report()['captures'] == 1
    assert names, 'the profiler saw no kernel on the card'
    assert set(seen) == {'channels_last' if bf16 else 'nchw'}, seen
    assert after - before == {'dyn_chain': pipe.cfg.test_steps + 1,
                              'proxy_resize': 1}
    if not bf16:
        assert [n for n in names
                if any(c in n for c in _LAYOUT_CONVERSIONS)] == []
    pipe.release()
