"""The port's filter bank and branchless chain against the JAX package:
every filter's regressor, ``process`` and ``apply`` (both parameter forms,
with a high-resolution image) with masking on and off, and
``chain.apply_filter_chain``.  Same numpy inputs on both
sides; f32 tolerance 1e-5 (pow, exp, cos and the HSV round trip differ by
a few ulp between XLA and PyTorch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.ops.chain import apply_filter_chain as j_chain
from exposure_tpu.ops.filters import max_filter_parameters as j_max_p
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.ops.chain import apply_filter_chain as t_chain
from exposure_tpu_torch.ops.filters import _mask_grid, build_filters
from exposure_tpu_torch.ops.filters import \
    max_filter_parameters as t_max_p
from exposure_tpu_torch.utils.config import load_config as t_load_config

TOL = 1e-5


def _banks(name, masking=None):
    jcfg, tcfg = j_load_config(name), t_load_config(name)
    if masking is not None:
        jcfg = jcfg.copy()
        jcfg.masking = masking
        tcfg.masking = masking
    return [f(jcfg) for f in jcfg.filters], build_filters(tcfg)


def _close(got, want, tol=TOL, msg=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=msg)


@pytest.fixture(scope='module', params=[
    ('test', None), ('masked', None), ('masked', False)],
    ids=['unmasked', 'masked', 'masked-bank-unmasked'])
def banks(request):
    return _banks(*request.param)


def test_bank_matches(banks):
    jf, tf = banks
    assert [type(f).__name__ for f in jf] == [type(f).__name__ for f in tf]
    for a, b in zip(jf, tf):
        assert a.get_num_filter_parameters() == b.get_num_filter_parameters()
        assert a.get_num_mask_parameters() == b.get_num_mask_parameters()
        assert a.get_short_name() == b.get_short_name()
        assert a.use_masking() == b.use_masking()
    assert j_max_p(jf) == t_max_p(tf)


def test_regressors(rng, banks):
    for a, b in zip(*banks):
        raw = (rng.randn(6, a.get_num_filter_parameters()) * 2).astype(
            np.float32)
        _close(b.filter_param_regressor(torch.from_numpy(raw)),
               a.filter_param_regressor(jnp.asarray(raw)),
               msg=a.get_short_name())


def test_process_and_apply(rng, banks):
    img = (rng.rand(3, 16, 24, 3) * 1.1).astype(np.float32)
    for a, b in zip(*banks):
        raw = rng.randn(3, a.get_num_filter_parameters()).astype(np.float32)
        param = np.array(a.filter_param_regressor(jnp.asarray(raw)))
        _close(b.process(torch.from_numpy(img), torch.from_numpy(param)),
               a.process(jnp.asarray(img), jnp.asarray(param)),
               msg='process %s' % a.get_short_name())
        mp = rng.randn(3, a.get_num_mask_parameters()).astype(np.float32)
        want, _, _ = a.apply(jnp.asarray(img),
                             specified_parameter=jnp.asarray(param),
                             mask_parameters=jnp.asarray(mp))
        got, _, _ = b.apply(torch.from_numpy(img),
                            specified_parameter=torch.from_numpy(param),
                            mask_parameters=torch.from_numpy(mp))
        _close(got, want, msg='apply %s' % a.get_short_name())


@pytest.mark.parametrize('form', ['raw', 'specified'])
def test_apply_contract(rng, banks, form):
    """``Filter.apply`` takes raw or regressed parameters and an optional
    high-res image, and returns (low_res, high_res, params) as JAX does."""
    img = (rng.rand(3, 16, 24, 3) * 1.1).astype(np.float32)
    hi = (rng.rand(3, 32, 40, 3) * 1.1).astype(np.float32)
    for a, b in zip(*banks):
        raw = rng.randn(3, a.get_num_filter_parameters()).astype(np.float32)
        mp = rng.randn(3, a.get_num_mask_parameters()).astype(np.float32)
        if form == 'raw':
            jkw = dict(raw_parameters=jnp.asarray(raw))
            tkw = dict(raw_parameters=torch.from_numpy(raw))
        else:
            reg = np.array(a.filter_param_regressor(jnp.asarray(raw)))
            jkw = dict(specified_parameter=jnp.asarray(reg))
            tkw = dict(specified_parameter=torch.from_numpy(reg))
        masked = a.use_masking()
        want = a.apply(jnp.asarray(img), high_res=jnp.asarray(hi),
                       mask_parameters=jnp.asarray(mp) if masked else None,
                       **jkw)
        got = b.apply(torch.from_numpy(img), high_res=torch.from_numpy(hi),
                      mask_parameters=torch.from_numpy(mp) if masked
                      else None, **tkw)
        assert len(got) == 3
        for g, w, part in zip(got, want, ('low', 'high', 'params')):
            _close(g, w, msg='%s %s' % (part, a.get_short_name()))
        low, none_hi, _ = b.apply(torch.from_numpy(img),
                                  mask_parameters=torch.from_numpy(mp),
                                  **tkw)
        assert none_hi is None
        _close(low, want[0])
    with pytest.raises(ValueError):   # exactly one parameter form
        b.apply(torch.from_numpy(img))


@pytest.mark.parametrize('hw', [(16, 24), (24, 16), (7, 7)])
def test_mask_grid(hw):
    from exposure_tpu.ops.filters import _mask_grid as j_grid
    for g_t, g_j in zip(_mask_grid(*hw, torch.float32, 'cpu'),
                        j_grid(*hw, jnp.float32)):
        _close(g_t, g_j, tol=0)


def _trajectory(rng, filters, k, b):
    ids = rng.randint(0, len(filters), (k, b)).astype(np.int32)
    params = np.zeros((k, b, j_max_p(filters)), np.float32)
    for s in range(k):
        for i in range(b):
            f = filters[ids[s, i]]
            raw = rng.randn(1, f.get_num_filter_parameters()).astype(
                np.float32)
            params[s, i, :raw.shape[1]] = np.asarray(
                f.filter_param_regressor(jnp.asarray(raw))).reshape(-1)
    return ids, params


@pytest.mark.parametrize('with_active', [False, True])
def test_chain_matches_jax(rng, banks, with_active):
    jf, tf = banks
    b, k = 3, 4
    img = (rng.rand(b, 16, 24, 3) * 0.9).astype(np.float32)
    ids, params = _trajectory(rng, jf, k, b)
    masking = jf[0].use_masking()
    mask = rng.randn(k, b, 6).astype(np.float32) if masking else None
    active = (rng.rand(k, b) > 0.3).astype(np.float32) if with_active \
        else None

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(x)

    want = j_chain(j(img), j(ids), j(params), jf, active_steps=j(active),
                   mask_params=j(mask))
    got = t_chain(t(img), t(ids), t(params), tf, active_steps=t(active),
                  mask_params=t(mask))
    _close(got, want)
