"""The port's training state against the JAX package, on the CPU.

- Adam (``apply_lr_update``) against optax's ``scale_by_adam`` chain over
  three steps, the first at lr 0 (the iteration-0 warmup: the moments move,
  the parameters keep their bits): parameters, moments and counts within
  1e-6 relative (1e-9 absolute);
- ``clip_tree`` and the zero-debiased EMA against the JAX functions (equal,
  and 1e-6 relative);
- ``init_like_flax``: every conv and linear weight inside the Glorot bound
  that flax computes for the same kernel shape, filling it (the largest
  draw above 0.9 of the bound, the variance within 10% of bound^2 / 3),
  every bias zero; ``init_train_state`` repeatable from its seed.
"""

import jax.numpy as jnp
import numpy as np
import torch

import torch_train_helpers as H
from exposure_tpu.core import train_state as jts
from exposure_tpu_torch.core import train_state as tts
from exposure_tpu_torch.core.artifacts import (
    critic_state_dict_to_flax,
    state_dict_to_flax,
)
from exposure_tpu_torch.models.networks import build_models, init_like_flax

RTOL, ATOL = 1e-6, 1e-9


def _params(rng):
    return {'a': rng.randn(3, 4).astype(np.float32),
            'b': rng.randn(5).astype(np.float32) * 1e-3,
            'c': np.zeros((2, 2), np.float32)}


def test_adam_matches_optax_three_steps(rng):
    params = _params(rng)
    tx = jts.make_optimizer(0.5, 0.9)
    j_params, j_opt = dict(params), tx.init(params)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_opt = tts.AdamState.create(t_params)
    for lr in (0.0, 1e-3, 2e-4):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        grads['c'][0, 0] = 0.0          # a zero gradient
        j_params, j_opt = jts.apply_lr_update(tx, grads, j_opt, j_params,
                                              np.float32(lr))
        before = {k: v.clone() for k, v in t_params.items()}
        t_params, t_opt = tts.apply_lr_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, t_opt,
            t_params, lr)
        if lr == 0.0:
            for k in params:
                assert torch.equal(t_params[k], before[k]), k
        adam = j_opt[0]
        assert t_opt.count == int(adam.count)
        for k in params:
            np.testing.assert_allclose(t_params[k].numpy(),
                                       np.asarray(j_params[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
            np.testing.assert_allclose(t_opt.mu[k].numpy(),
                                       np.asarray(adam.mu[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
            np.testing.assert_allclose(t_opt.nu[k].numpy(),
                                       np.asarray(adam.nu[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def test_clip_tree_matches_jax(rng):
    tree = {'w': rng.randn(4, 5).astype(np.float32) * 0.02,
            'b': np.array([0.01, -0.01, 0.5], np.float32)}
    want = jts.clip_tree(tree, 0.01)
    got = tts.clip_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                        0.01)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_ema_debias_matches_jax():
    j, t = jts.EmaState.create(), tts.EmaState.create()
    assert float(t.value) == float(j.value) == 0.0
    for v in (0.3, -1.2, 0.05, 2.0):
        j, t = j.update(jnp.float32(v)), t.update(torch.tensor(v))
        assert t.count == int(j.count)
        np.testing.assert_allclose(float(t.biased), float(j.biased),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(t.value), float(j.value),
                                   rtol=RTOL)


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + '/')
        else:
            yield prefix + k, v


def test_glorot_bounds_and_zero_biases():
    jcfg, tcfg = H.configs('test')
    jm, jstate, _, _, _ = H.models(jcfg, tcfg)
    _, policy, critic, value = build_models(tcfg)
    g = torch.Generator().manual_seed(0)
    for module, to_flax, j_params in (
            (policy, state_dict_to_flax, jstate.gen_params),
            (critic, critic_state_dict_to_flax, jstate.crit_params),
            (value, critic_state_dict_to_flax, jstate.val_params)):
        init_like_flax(module, g)
        got = dict(_flat(to_flax(module.state_dict())))
        want = dict(_flat(H.host_tree(j_params)))
        assert set(got) == set(want)
        for name, w in got.items():
            assert w.shape == want[name].shape, name
            if name.endswith('bias'):
                assert not w.any(), name
                assert not want[name].any(), name
                continue
            receptive = int(np.prod(w.shape[:-2]))   # HWIO / [in, out]
            limit = np.sqrt(6.0 / (receptive * (w.shape[-2] +
                                                w.shape[-1])))
            for leaf in (w, want[name]):
                assert np.abs(leaf).max() <= limit, name
            if w.size >= 1000:
                assert np.abs(w).max() > 0.9 * limit, name
                np.testing.assert_allclose(w.var(), limit ** 2 / 3,
                                           rtol=0.1, err_msg=name)


def test_init_train_state_repeats_from_its_seed():
    _, tcfg = H.configs('test')
    nets = build_models(tcfg)[1:]
    a = tts.init_train_state(tcfg, *nets, seed=3).tensors()
    b = tts.init_train_state(tcfg, *nets, seed=3).tensors()
    c = tts.init_train_state(tcfg, *nets, seed=4).tensors()
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['gen_params/selector_fc1.weight'],
                           c['gen_params/selector_fc1.weight'])
    state = tts.init_train_state(tcfg, *nets, seed=3)
    assert (state.step, state.opt_g.count, state.ema.count) == (0, 0, 0)
    assert not any(v.any() for k, v in a.items() if '/mu/' in k)
