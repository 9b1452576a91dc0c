"""The planning slice of the port against the JAX package: ``pdf_sample``,
``agent_step`` (the 8-candidate bank step) and ``rollout``.

Same numpy inputs on both sides; the JAX and torch random streams differ,
so dropout is off (keep 1.0) and the selection noise is fed in.  Ids must
be equal; images, parameters, pdfs, surrogates and penalties agree within
1e-5 (f32 filter math differs by a few ulp between XLA and PyTorch)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.core.rollout import rollout as j_rollout
from exposure_tpu.models import agent as jagent
from exposure_tpu.models.networks import PolicyNet as JPolicyNet
from exposure_tpu.ops.sampling import pdf_sample as j_pdf_sample
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.core.artifacts import flax_to_state_dict
from exposure_tpu_torch.core.rollout import rollout as t_rollout
from exposure_tpu_torch.models import agent as tagent
from exposure_tpu_torch.models.networks import build_policy
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.ops.sampling import pdf_sample as t_pdf_sample
from exposure_tpu_torch.utils.config import load_config as t_load_config

TOL = 1e-5


def test_pdf_sample_matches_jax(rng):
    pdf = (rng.rand(64, 8) + 1e-3).astype(np.float32)
    pdf[3] = [0.25, 0.25, 0.5, 0, 0, 0, 0, 0]
    noise = rng.rand(64, 1).astype(np.float32)
    noise[:3] = [[0.0], [0.999999], [0.25]]   # 0 clamps to index 0
    got = t_pdf_sample(torch.from_numpy(pdf), torch.from_numpy(noise))
    want = j_pdf_sample(jnp.asarray(pdf), jnp.asarray(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == 0 and 0 <= int(got.min()) and int(got.max()) < 8


@pytest.fixture(scope='module', params=['test', 'masked'])
def models(request):
    """A random-init policy of the config on both sides, dropout off."""
    name = request.param
    jcfg = j_load_config(name).copy()
    jcfg.dropout_keep_prob = 1.0
    jfilters = [f(jcfg) for f in jcfg.filters]
    jpolicy = JPolicyNet(
        filter_output_dims=tuple(
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in jfilters),
        feature_extractor_dims=jcfg.feature_extractor_dims,
        base_channels=jcfg.base_channels, fc1_size=jcfg.fc1_size,
        dropout_keep_prob=1.0)
    key = jax.random.PRNGKey(1)
    gen_params = jpolicy.init({'params': key, 'dropout': key},
                              jnp.zeros((2, 64, 64, 3 + jcfg.num_state_dim)))
    tcfg = t_load_config(name)
    tcfg.dropout_keep_prob = 1.0
    tfilters = build_filters(tcfg)
    policy = build_policy(tcfg, tfilters)
    policy.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gen_params)))
    return types.SimpleNamespace(
        jcfg=jcfg, jfilters=jfilters, jpolicy=jpolicy, gen_params=gen_params,
        tcfg=tcfg, tfilters=tfilters, policy=policy.eval())


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=msg)


@pytest.mark.parametrize('is_train', [0, 1])
def test_agent_step_matches_jax(models, is_train):
    m = models
    rng = np.random.RandomState(2)
    b = 6
    img = (rng.rand(b, 64, 64, 3) * 0.9).astype(np.float32)
    hi = (rng.rand(b, 32, 48, 3) * 0.9).astype(np.float32)
    states = np.zeros((b, m.tcfg.num_state_dim), np.float32)
    states[:, 2] = rng.randint(0, 5, b)                    # step counter
    states[:, 3:] = rng.rand(b, len(m.tfilters)) > 0.5   # usage bits
    noise = rng.rand(b, 1).astype(np.float32)
    want = jagent.agent_step(
        m.jpolicy, m.gen_params, jnp.asarray(img), jnp.asarray(states),
        key=jax.random.PRNGKey(0), is_train=is_train, progress=0.3,
        cfg=m.jcfg, filters=m.jfilters, high_res=jnp.asarray(hi),
        selection_noise=jnp.asarray(noise))
    with torch.no_grad():
        got = tagent.agent_step(
            m.policy, torch.from_numpy(img), torch.from_numpy(states), None,
            is_train=is_train, progress=0.3, cfg=m.tcfg, filters=m.tfilters,
            high_res=torch.from_numpy(hi),
            selection_noise=torch.from_numpy(noise))
    assert got.selected_filter_id.dtype == torch.int32
    np.testing.assert_array_equal(got.selected_filter_id.numpy(),
                                  np.asarray(want.selected_filter_id))
    for field in ('image', 'new_states', 'surrogate', 'penalty',
                  'selected_params', 'selected_mask_params', 'pdf',
                  'entropy', 'high_res_output'):
        _close(getattr(got, field), getattr(want, field), field)
    for g, w in zip(got.all_params, want.all_params):
        _close(g, w, 'all_params')


def test_agent_step_tensor_is_train_blends(models):
    """``is_train`` as a tensor blends the sampled and argmax ids per the
    reference formula; a python 0 draws no noise and takes the argmax."""
    m = models
    rng = np.random.RandomState(3)
    img = torch.from_numpy((rng.rand(4, 64, 64, 3) * 0.9).astype(np.float32))
    st = tagent.initial_states(4, m.tcfg.num_state_dim)
    noise = torch.from_numpy(rng.rand(4, 1).astype(np.float32))
    with torch.no_grad():
        for flag in (0, 1):
            a = tagent.agent_step(m.policy, img, st, None,
                                  is_train=torch.tensor(flag), progress=1.0,
                                  cfg=m.tcfg, filters=m.tfilters,
                                  selection_noise=noise)
            b = tagent.agent_step(m.policy, img, st, None, is_train=flag,
                                  progress=1.0, cfg=m.tcfg,
                                  filters=m.tfilters, selection_noise=noise)
            assert torch.equal(a.selected_filter_id, b.selected_filter_id)
        g = torch.Generator().manual_seed(0)
        greedy = tagent.agent_step(m.policy, img, st, g, is_train=0,
                                   progress=1.0, cfg=m.tcfg,
                                   filters=m.tfilters)
    assert torch.equal(greedy.selected_filter_id,
                       torch.argmax(greedy.pdf, dim=1).to(torch.int32))
    # no selection noise was drawn at a python 0
    assert torch.equal(g.get_state(),
                       torch.Generator().manual_seed(0).get_state())


def test_agent_step_injection_and_respike(models):
    """The training knobs: forced (injected) actions carry a zero
    surrogate and stay in range; outside is_train or past
    replay_inject_until nothing is forced; the re-spike raises the entropy
    penalty at its centre.  The forced draws are the port's own random
    numbers, so they are checked by their contract, not against JAX."""
    m = models
    rng = np.random.RandomState(4)
    img = torch.from_numpy((rng.rand(8, 64, 64, 3) * 0.9).astype(np.float32))
    st = tagent.initial_states(8, m.tcfg.num_state_dim)
    noise = torch.full((8, 1), 0.999)   # samples the last filter
    base = dict(cfg=m.tcfg, filters=m.tfilters, selection_noise=noise)
    with torch.no_grad():
        plain = tagent.agent_step(m.policy, img, st, None, is_train=1,
                                  progress=0.5, **base)
        for mode in ('uniform', 'anti'):
            cfg = m.tcfg.copy()
            cfg.replay_inject_prob, cfg.replay_inject_mode = 1.0, mode
            cfg.replay_inject_until = 0.75
            kw = dict(base, cfg=cfg)
            g = torch.Generator().manual_seed(5)
            out = tagent.agent_step(m.policy, img, st, g, is_train=1,
                                    progress=0.5, **kw)
            assert torch.equal(out.surrogate, torch.zeros_like(out.surrogate))
            ids = out.selected_filter_id
            assert int(ids.min()) >= 0 and int(ids.max()) < len(m.tfilters)
            for is_train, progress in ((0, 0.5), (1, 0.9)):
                off = tagent.agent_step(m.policy, img, st,
                                        torch.Generator().manual_seed(5),
                                        is_train=is_train, progress=progress,
                                        **kw)
                assert bool((off.surrogate < 0).all())
        cfg = m.tcfg.copy()
        cfg.entropy_respike = 1.0
        spiked = tagent.agent_step(m.policy, img, st, None, is_train=1,
                                   progress=0.5, **dict(base, cfg=cfg))
    bonus = cfg.exploration_penalty * (
        -plain.entropy + np.log(len(m.tfilters)))
    _close(spiked.penalty - plain.penalty, bonus, 'respike')


def test_rollout_matches_jax(models):
    m = models
    rng = np.random.RandomState(5)
    img = (rng.rand(6, 64, 64, 3) * 0.9).astype(np.float32)
    want = j_rollout(m.jpolicy, m.gen_params, jnp.asarray(img),
                     jax.random.PRNGKey(0), cfg=m.jcfg, filters=m.jfilters,
                     is_train=0)
    with torch.no_grad():
        got = t_rollout(m.policy, torch.from_numpy(img), None, cfg=m.tcfg,
                        filters=m.tfilters, is_train=0)
    assert got.filter_ids.shape == (m.tcfg.test_steps, 6)
    np.testing.assert_array_equal(got.filter_ids.numpy(),
                                  np.asarray(want.filter_ids))
    for field in ('images', 'states', 'params', 'mask_params', 'pdfs',
                  'surrogates', 'final_image', 'final_state'):
        _close(getattr(got, field), getattr(want, field), field)
