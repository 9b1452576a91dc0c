"""The port's ``RetouchPipeline`` in every mode against the JAX pipeline,
mirroring tests/test_serving.py on the ``test`` config.

- Each mode plans with the same weights as the JAX pipeline (dropout
  keep 1.0 on both sides: the random streams differ) and must agree with
  it within 1 LSB (u8) on the rows whose plans agree: dynamic with the
  bank plan, switch, grouped, grouped with a frozen superset layout,
  auto-superset, and the branchless no-kernel path; masked serving too.
- bf16 plans give finite output of the input's shape and dtype.
- ``map_batches`` in the grouped modes is depth-invariant, equals the
  per-batch call, and stops early cleanly.
- The auto-superset state machine is driven through ``_ss_observe``, and
  a warmed replay equals an unwarmed one.

With ``use_kernels=True`` on the CPU every kernel runs its plain PyTorch
version."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.core.serving import RetouchPipeline as JPipeline
from exposure_tpu.models.networks import PolicyNet as JPolicyNet
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.core.artifacts import flax_to_state_dict
from exposure_tpu_torch.core.serving import RetouchPipeline as TPipeline
from exposure_tpu_torch.core.serving import batch_generator
from exposure_tpu_torch.models.networks import build_policy
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.utils.config import load_config as t_load_config


def _models(masking, seed, keep=1.0):
    jcfg = j_load_config('test').copy()
    jcfg.dropout_keep_prob = keep
    jcfg.masking = masking
    jfilters = [f(jcfg) for f in jcfg.filters]
    jpolicy = JPolicyNet(
        filter_output_dims=tuple(
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in jfilters),
        feature_extractor_dims=jcfg.feature_extractor_dims,
        base_channels=jcfg.base_channels, fc1_size=jcfg.fc1_size,
        dropout_keep_prob=keep)
    key = jax.random.PRNGKey(seed)
    gen_params = jpolicy.init({'params': key, 'dropout': key},
                              jnp.zeros((2, 64, 64, 3 + jcfg.num_state_dim)))
    tcfg = t_load_config('test')
    tcfg.dropout_keep_prob = keep
    tcfg.masking = masking
    policy = build_policy(tcfg, build_filters(tcfg))
    policy.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gen_params)))
    return types.SimpleNamespace(
        jcfg=jcfg, state=types.SimpleNamespace(gen_params=gen_params),
        tcfg=tcfg, policy=policy)


@pytest.fixture(scope='module')
def models():
    # these weights plan 4 signatures for the batch of _images(5), so
    # the grouped modes take their multi-group routes
    return _models(False, 6)


def _images(seed, b=4, h=64, w=128):
    return (np.random.RandomState(seed).rand(b, h, w, 3) * 255).astype(
        np.uint8)


def _j_bank_ids(m, imgs):
    """The JAX bank plan's ids for a u8 batch (what the JAX switch,
    grouped and bank-plan dynamic modes replay)."""
    pipe = JPipeline(m.jcfg, m.state, use_pallas=False)
    ids, _, _ = pipe._plan_for(jnp.asarray(imgs), jax.random.PRNGKey(0))
    return np.asarray(ids)


def _agree(got, want, same):
    assert same.sum() >= 2, 'plans agree on %d rows' % same.sum()
    lsb = np.abs(got[same].astype(np.int32) - want[same].astype(np.int32))
    assert lsb.max() <= 1, 'off by %d LSB' % lsb.max()


MODES = {
    'dynamic_bank_plan': dict(dynamic=True, selected_plan=False),
    'switch': dict(dynamic=False, grouped=False),
    'grouped': dict(grouped=True),
    'grouped_accumulate': dict(grouped=True, fused_set_limit=0),
    'grouped_superset': dict(grouped=True),
}
ROUTES = {'grouped': 'fused', 'grouped_accumulate': 'accumulate',
          'grouped_superset': 'superset'}


@pytest.fixture(scope='module')
def jax_switch_out(models):
    imgs = _images(5)
    pipe = JPipeline(models.jcfg, models.state, use_pallas=True,
                     interpret=True, dynamic=False, grouped=False)
    return imgs, np.asarray(pipe(imgs, seed=0)), _j_bank_ids(models, imgs)


@pytest.mark.parametrize('mode', sorted(MODES))
def test_mode_matches_jax_switch_pipeline(models, jax_switch_out, mode):
    imgs, want, j_ids = jax_switch_out
    pipe = TPipeline(models.tcfg, models.policy, use_kernels=True,
                     **MODES[mode], device='cpu')
    with torch.no_grad():
        t_ids = pipe.plan(pipe.proxy(torch.from_numpy(imgs)), None)[0]
    if mode == 'grouped_superset':
        # single-image groups never make a warm-up layout (they merge),
        # so freeze one by hand with one signature left out
        sigs = sorted({tuple(c) for c in t_ids.T.tolist()})
        pipe.freeze_superset([(sig, 8) for sig in sigs[:-1]])
    got = pipe(imgs, seed=0)
    assert got.dtype == np.uint8 and got.shape == imgs.shape
    _agree(got, want, (t_ids.numpy() == j_ids).all(axis=0))
    if pipe.grouped:
        assert pipe._runner.last_route['route'] == ROUTES[mode]
    if mode in ('grouped_accumulate', 'grouped_superset'):
        assert pipe._runner.last_route['merge'] == 8


def test_branchless_matches_jax_no_kernel_pipeline(models):
    """Without kernels both pipelines replay the bank plan through the
    branchless chain on the full-resolution float32 input."""
    imgs = _images(6)
    want = np.asarray(JPipeline(models.jcfg, models.state,
                                use_pallas=False)(imgs, seed=0))
    pipe = TPipeline(models.tcfg, models.policy, device='cpu')
    assert not (pipe.dynamic or pipe.grouped or pipe.use_kernels)
    got = pipe(imgs)
    with torch.no_grad():
        t_ids = pipe.plan(pipe.proxy(torch.from_numpy(imgs)), None)[0]
    _agree(got, want, (t_ids.numpy() == _j_bank_ids(models, imgs))
           .all(axis=0))
    f32 = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    out = pipe(f32)
    assert out.dtype == np.float32 and np.isfinite(out).all()


def test_masked_serving(models):
    m = _models(True, 3)
    imgs = _images(8, b=2)
    want = np.asarray(JPipeline(m.jcfg, m.state, use_pallas=False)(imgs))
    j_ids = _j_bank_ids(m, imgs)
    for kw in MODES.values():
        pipe = TPipeline(m.tcfg, m.policy, use_kernels=True, **kw,
                         device='cpu')
        assert pipe.masking
        got = pipe(imgs)
        with torch.no_grad():
            t_ids = pipe.plan(pipe.proxy(torch.from_numpy(imgs)), None)[0]
        same = (t_ids.numpy() == j_ids).all(axis=0)
        assert same.all()
        _agree(got, want, same)


def test_bf16_plan(models):
    imgs = _images(9, b=2)
    for kw in (dict(), dict(dynamic=True, selected_plan=False),
               dict(grouped=True)):
        pipe = TPipeline(models.tcfg, models.policy, use_kernels=True,
                         bf16=True, **kw, device='cpu')
        out = pipe(imgs)
        assert out.dtype == np.uint8 and out.shape == imgs.shape
        f32 = torch.from_numpy(imgs).float() / 255
        out_f = pipe(f32)
        assert out_f.dtype == np.float32 and np.isfinite(out_f).all()
        ids, params, _ = pipe.plan(pipe.proxy(f32), None)
        assert params.dtype == torch.float32 and ids.dtype == torch.int32


def test_mode_resolution(models):
    m = models
    assert TPipeline(m.tcfg, m.policy, use_kernels=True, device='cpu').dynamic
    p = TPipeline(m.tcfg, m.policy, use_kernels=True, auto_superset=True,
                  device='cpu')
    assert p.grouped and not p.dynamic and p._ss_auto
    p = TPipeline(m.tcfg, m.policy, use_kernels=True, grouped=False,
                  device='cpu')
    assert p.dynamic and p.selected_plan
    assert not TPipeline(m.tcfg, m.policy, grouped=True, device='cpu').grouped
    with pytest.raises(ValueError, match='exclusive'):
        TPipeline(m.tcfg, m.policy, dynamic=True, grouped=True, device='cpu')


def _dropout_pipe(**kw):
    """A torch-only pipeline with dropout on (keep 0.5)."""
    cfg = t_load_config('test')
    torch.manual_seed(0)
    return TPipeline(cfg, build_policy(cfg, build_filters(cfg)),
                     use_kernels=True, **kw, device='cpu')


def test_map_batches_depth_invariant_and_per_batch():
    pipe = _dropout_pipe(grouped=True, fused_set_limit=0)
    batches = [_images(10 + i, b=2) for i in range(5)]
    deep = list(pipe.map_batches(iter(batches), seed=3, depth=3))
    shallow = list(pipe.map_batches(iter(batches), seed=3, depth=1))
    assert len(deep) == len(shallow) == 5
    for i, (a, c) in enumerate(zip(deep, shallow)):
        assert a.dtype == np.uint8
        assert np.array_equal(a, c)
        assert np.array_equal(a, pipe(batches[i], 3, i))


def test_map_batches_early_close():
    pipe = _dropout_pipe(grouped=True)
    batches = [_images(20 + i, b=2) for i in range(5)]
    gen = pipe.map_batches(iter(batches), seed=1, depth=2)
    first = next(gen)
    assert first.shape == batches[0].shape
    gen.close()
    assert np.array_equal(first, pipe(batches[0], 1, 0))


def test_auto_superset_record_freeze_drift_logic(models):
    """Record 2 batches -> freeze with one bucket step of headroom ->
    drift past the threshold over a full window -> re-freeze (inline)."""
    pipe = TPipeline(models.tcfg, models.policy, use_kernels=True,
                     grouped=True, fused_set_limit=0, auto_superset=True,
                     auto_record_batches=2, auto_drift_window=3,
                     auto_drift_threshold=0.25, device='cpu')
    assert pipe._ss_auto
    k, b = models.tcfg.test_steps, 16
    ids_a = np.zeros((k, b), np.int32)
    ids_a[:, 10:] = 1
    pipe._ss_observe(ids_a)
    assert pipe._superset_layout is None
    pipe._ss_observe(ids_a)
    layout = dict(pipe._superset_layout)
    sig_a, sig_b = tuple([0] * k), tuple([1] * k)
    assert layout == {sig_a: 16, sig_b: 12}
    for _ in range(4):
        pipe._ss_observe(ids_a)
    assert pipe._ss_refreezes == 0
    ids_single = np.full((k, b), 3, np.int32)   # single signature: no drift
    for _ in range(4):
        pipe._ss_observe(ids_single)
    assert pipe._ss_refreezes == 0
    ids_c = np.full((k, b), 2, np.int32)
    ids_c[:, 10:] = 4
    for _ in range(3):
        pipe._ss_observe(ids_c)
    assert pipe._ss_refreezes == 1
    new_layout = dict(pipe._superset_layout)
    assert new_layout[tuple([2] * k)] >= 10
    rep = pipe.superset_report()
    assert rep['auto'] and rep['refreezes'] == 1
    assert rep['frozen_slots'] == len(new_layout)
    assert rep['refreeze_warm_pending'] is False


def _planted(pipe, imgs):
    """The batch's bank plan with the second half's first step moved to
    another filter: two signatures, whatever the random policy chose."""
    with torch.no_grad():
        ids, params, mask = pipe.plan(pipe.proxy(imgs),
                                      batch_generator(0, 1, 'cpu'))
    ids = ids.clone()
    half = ids.shape[1] // 2
    ids[0, half:] = (ids[0, half:] + 1) % len(pipe.filters)
    return ids, params, mask


def test_warmup_superset_and_auto_stream(models):
    """warmup(superset=True) freezes a layout (or one is frozen by hand
    when the probes plan one signature); replays then route through
    call_superset and equal the accumulate path on the same plan.  An
    auto-superset stream freezes mid-stream and equals the plain grouped
    stream."""
    imgs = torch.from_numpy(_images(30, b=16))
    pipe = TPipeline(models.tcfg, models.policy, use_kernels=True,
                     grouped=True, fused_set_limit=0, device='cpu')
    rep = pipe.warmup(imgs, probe_batches=2, seed=0, superset=True)
    assert rep['kind'] == 'grouped' and rep['superset'] is True
    for key in ('batch_shape', 'dtype', 'probe_batches', 'budget',
                'merge_sizes', 'single_signatures', 'fallback_batches',
                'programs_compiled', 'warmup_seconds'):
        assert key in rep
    ids, params, mask = _planted(pipe, imgs)
    if pipe._superset_layout is None:
        sig_a = tuple(ids[:, 0].tolist())
        sig_b = tuple(ids[:, -1].tolist())
        pipe.freeze_superset([(sig_a, 8), (sig_b, 8)])
    out = pipe.replay(imgs, ids, params, mask)
    assert pipe._runner.last_route['route'] == 'superset'
    plain = TPipeline(models.tcfg, models.policy, use_kernels=True,
                      grouped=True, fused_set_limit=0, device='cpu')
    want = plain.replay(imgs, ids, params, mask)
    assert plain._runner.last_route['route'] == 'accumulate'
    assert torch.equal(out, want)

    auto = TPipeline(models.tcfg, models.policy, use_kernels=True,
                     grouped=True, fused_set_limit=0, auto_superset=True,
                     auto_record_batches=2, device='cpu')
    outs_a = list(auto.map_batches([imgs] * 4, seed=0, depth=2))
    outs_p = list(plain.map_batches([imgs] * 4, seed=0, depth=2))
    assert auto._superset_layout is not None and auto._ss_refreezes == 0
    for a, p in zip(outs_a, outs_p):
        assert np.array_equal(a, p)


def test_warmup_reports_and_warmed_replay(models):
    m = models
    imgs = torch.from_numpy(_images(40, b=16))
    pipe = TPipeline(m.tcfg, m.policy, use_kernels=True, grouped=True,
                     fused_set_limit=0, device='cpu')
    rep = pipe.warmup(imgs, probe_batches=2, seed=0)
    assert rep['kind'] == 'grouped' and rep['programs_compiled'] >= 1
    cold = TPipeline(m.tcfg, m.policy, use_kernels=True, grouped=True,
                     fused_set_limit=0, device='cpu')
    ids, params, mask = _planted(pipe, imgs)
    assert torch.equal(pipe.replay(imgs, ids, params, mask),
                       cold.replay(imgs, ids, params, mask))
    sig = tuple([0] * m.tcfg.test_steps)
    rep = TPipeline(m.tcfg, m.policy, use_kernels=True, grouped=True,
                    fused_set_limit=0, device='cpu').warmup(
        imgs[:4], budget=[(sig, 8)])
    assert rep['probe_batches'] == 0 and rep['programs_compiled'] == 1
    rep_d = TPipeline(m.tcfg, m.policy, use_kernels=True,
                      device='cpu').warmup(imgs[:4])
    assert rep_d['kind'] == 'dynamic' and rep_d['programs_compiled'] == 1
    rep_s = TPipeline(m.tcfg, m.policy, use_kernels=True, dynamic=False,
                      grouped=False, device='cpu').warmup(imgs[:4])
    assert rep_s['kind'] == 'switch' and rep_s['programs_compiled'] == 1
