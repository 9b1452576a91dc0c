"""``critic_stats``, ``CriticNet`` and ``build_models`` of the port against
the JAX package on the CPU: the same numpy inputs, the flax weights carried
over by ``flax_critic_to_state_dict``; statistics and logits within 1e-5,
with and without ``states``, on 64 x 64 inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.core.trainer import build_models as j_build_models
from exposure_tpu.core.trainer import init_train_state
from exposure_tpu.models.networks import CriticNet as JCriticNet
from exposure_tpu.models.networks import critic_stats as j_critic_stats
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.core.artifacts import (
    flax_critic_to_state_dict,
    flax_to_state_dict,
)
from exposure_tpu_torch.models.networks import (
    CriticNet,
    PolicyNet,
    build_models,
    critic_stats,
)
from exposure_tpu_torch.utils.config import load_config as t_load_config

TOL = 1e-5


def _images(rng, b, size=64):
    # beyond [0, 1] on both sides: the statistics clip for the saturation
    return (rng.rand(b, size, size, 3) * 1.3 - 0.1).astype(np.float32)


@pytest.mark.parametrize('shape', [(4, 64, 64, 3), (2, 16, 24, 3)])
def test_critic_stats_match(rng, shape):
    img = (rng.rand(*shape) * 1.3 - 0.1).astype(np.float32)
    img[0] = 0.25                       # a flat gray image: variance 0
    got = critic_stats(torch.from_numpy(img))
    want = np.asarray(j_critic_stats(jnp.asarray(img)))
    assert got.shape == (shape[0], 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the population variance, as jnp.var
    lum = img[..., 0] * 0.27 + img[..., 1] * 0.67 + img[..., 2] * 0.06
    np.testing.assert_allclose(got[:, 1].numpy(),
                               lum.reshape(shape[0], -1).var(axis=1),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize('with_states', [False, True])
@pytest.mark.parametrize('base,fc1', [(16, 32), (32, 128)])
def test_critic_net_matches(rng, with_states, base, fc1):
    b, d = 3, 11
    img = _images(rng, b)
    states = rng.rand(b, d).astype(np.float32) if with_states else None
    jnet = JCriticNet(base, fc1)
    args = (jnp.asarray(img),) + ((jnp.asarray(states),) if with_states
                                  else ())
    params = jnet.init(jax.random.PRNGKey(1), *args)
    want = np.asarray(jnet.apply(params, *args))
    net = CriticNet(3 + (d if with_states else 0) + 3, base, fc1)
    missing = net.load_state_dict(flax_critic_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    assert not missing.missing_keys and not missing.unexpected_keys
    with torch.no_grad():
        got = net(torch.from_numpy(img),
                  torch.from_numpy(states) if with_states else None)
    assert got.shape == want.shape == (b, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_critic_net_refuses_what_it_was_not_built_for(rng):
    net = CriticNet(3 + 3, 16, 32)
    img = torch.from_numpy(_images(rng, 2))
    with pytest.raises(ValueError, match='input channels'):
        net(img, torch.zeros(2, 11))
    with pytest.raises(ValueError, match='expected 64x64'):
        net(torch.from_numpy(_images(rng, 2, 32)))
    with pytest.raises(ValueError, match='even sizes'):
        CriticNet(6, 16, 32, input_size=36)(
            torch.from_numpy(_images(rng, 2, 36)))
    with pytest.raises(KeyError, match='unexpected critic parameter'):
        flax_critic_to_state_dict({'params': {'Dense_2': {}}})


@pytest.mark.parametrize('name', ['test', 'masked'])
def test_build_models_matches(rng, name):
    """The four objects of the JAX ``build_models``; the critic and value
    nets take the JAX train state's weights and give its logits."""
    jcfg, tcfg = j_load_config(name), t_load_config(name)
    jfilters, jpolicy, jcritic, jvalue = j_build_models(jcfg)
    state, _ = init_train_state(jcfg, jpolicy, jcritic, jvalue, 4)
    filters, policy, critic, value = build_models(tcfg)
    assert [type(f).__name__ for f in filters] == \
        [type(f).__name__ for f in jfilters]
    assert isinstance(policy, PolicyNet)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    policy.load_state_dict(flax_to_state_dict(as_np(state.gen_params)))
    critic.load_state_dict(flax_critic_to_state_dict(
        as_np(state.crit_params)))
    value.load_state_dict(flax_critic_to_state_dict(
        as_np(state.val_params)))
    assert critic.in_channels == 6
    assert value.in_channels == 3 + tcfg.num_state_dim + 3
    img = _images(rng, 2)
    states = rng.rand(2, tcfg.num_state_dim).astype(np.float32)
    with torch.no_grad():
        got_c = critic(torch.from_numpy(img))
        got_v = value(torch.from_numpy(img), torch.from_numpy(states))
    np.testing.assert_allclose(
        got_c.numpy(), np.asarray(jcritic.apply(state.crit_params,
                                                jnp.asarray(img))),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        got_v.numpy(), np.asarray(jvalue.apply(
            state.val_params, jnp.asarray(img), jnp.asarray(states))),
        rtol=0, atol=TOL)
