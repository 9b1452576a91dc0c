"""The port's training losses against the JAX package, on the CPU.

- The repairs: every filter's ``apply`` and ``critic_stats`` differentiated
  on images holding exact 0, 1, knot values i/8 and gray pixels, against
  ``jax.grad`` (atol 1e-6): JAX splits the gradient of ``maximum``,
  ``minimum``, ``clip`` and ``max`` at ties, and so must the port.
- ``generator_value_loss`` (WGAN and LSGAN, TD on and off, supervised) and
  ``critic_loss`` (WGAN-GP, LSGAN): the loss value (rtol 1e-4) and every
  parameter's gradient (within 1e-4 of the largest gradient of its tree,
  rtol 1e-3) against ``jax.value_and_grad``, on the ``test`` config (base
  16, features 1024, fc 32) at batch 4, dropout off, the JAX selection
  noise and interpolation weights replayed (``utils/draws.py``);
- the partitioning: no critic-parameter gradient in the generator path,
  and the value net's gradient is that of ``v_loss`` alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core import losses as jl
from exposure_tpu.models.networks import critic_stats as j_critic_stats
from exposure_tpu_torch.core import losses as tl
from exposure_tpu_torch.core.artifacts import (
    flax_critic_to_state_dict,
    flax_to_state_dict,
)
from exposure_tpu_torch.models.networks import critic_stats as t_critic_stats
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.utils.draws import ReplayedDraws

pytestmark = pytest.mark.usefixtures('few_threads')

B = 4
GRAD_ATOL = 1e-6        # the repairs: gradients of single filters
LOSS_RTOL = 1e-4        # the WGAN loss is a difference of two means
TREE_REL, TREE_RTOL = 1e-4, 1e-3


def _tie_images(rng, n=3, h=8, w=16):
    """Images whose pixels sit on the ties: 0, 1, every knot i/8, 1e-3 (the
    gamma's floor), gray (r = g = b) and saturated pixels, and values
    beyond [0, 1]."""
    img = rng.rand(n, h, w, 3).astype(np.float32) * 1.2
    special = np.array([0.0, 1.0, 0.001] + [i / 8 for i in range(1, 8)],
                       np.float32)
    flat = img.reshape(-1, 3)
    picks = rng.randint(0, len(special), size=flat.shape)
    use = rng.rand(*flat.shape) < 0.5
    flat[use] = special[picks[use]]
    gray = rng.rand(flat.shape[0]) < 0.25
    flat[gray] = flat[gray][:, :1]
    return flat.reshape(img.shape)


@pytest.mark.parametrize('name', ['synthetic', 'masked'])
def test_filter_gradients_match_jax_at_ties(name, rng):
    jcfg, tcfg = H.configs(name)
    img = _tie_images(rng)
    for jfilter, tfilter in zip([f(jcfg) for f in jcfg.filters],
                                build_filters(tcfg)):
        n = jfilter.get_num_filter_parameters()
        m = jfilter.get_num_mask_parameters()
        raw = rng.randn(img.shape[0], n).astype(np.float32)
        raw_m = rng.randn(img.shape[0], m).astype(np.float32) \
            if jfilter.use_masking() else None
        weight = rng.randn(*img.shape).astype(np.float32)

        def j_loss(x, p, pm):
            out = jfilter.apply(x, raw_parameters=p, mask_parameters=pm)[0]
            return jnp.sum(out * weight)

        argnums = (0, 1, 2) if raw_m is not None else (0, 1)
        want = jax.grad(j_loss, argnums=argnums)(img, raw, raw_m)
        args = [torch.tensor(a, requires_grad=True)
                for a in (img, raw, raw_m) if a is not None]
        out = tfilter.apply(args[0], raw_parameters=args[1],
                            mask_parameters=args[2] if raw_m is not None
                            else None)[0]
        got = torch.autograd.grad((out * torch.from_numpy(weight)).sum(),
                                  args, allow_unused=True)
        for a, g, w in zip(args, got, want):
            g = torch.zeros_like(a) if g is None else g   # JAX: zeros
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=GRAD_ATOL, rtol=1e-5,
                                       err_msg=tfilter.get_short_name())


def test_critic_stats_gradient_splits_ties_as_jax(rng):
    img = _tie_images(rng, n=4, h=8, w=8)
    img[0, 0, 0] = (1.0, 1.0, 0.5)       # a tie of the channel max
    weight = rng.randn(4, 3).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(j_critic_stats(x) * weight))(img)
    x = torch.tensor(img, requires_grad=True)
    got, = torch.autograd.grad(
        (t_critic_stats(x) * torch.from_numpy(weight)).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=GRAD_ATOL, rtol=1e-5)
    # a one-pixel image [1, 1, 0.5]: the max's gradient is split 0.5/0.5
    one = np.array([[[[1.0, 1.0, 0.5]]]], np.float32)
    sat = lambda s: s[:, 2].sum()  # noqa: E731
    want = jax.grad(lambda v: sat(j_critic_stats(v)))(one)
    x = torch.tensor(one, requires_grad=True)
    got, = torch.autograd.grad(sat(t_critic_stats(x)), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got[0, 0, 0, 0] == got[0, 0, 0, 1] != 0


@pytest.fixture(scope='module')
def nets():
    jcfg, tcfg = H.configs('test', dropout_keep_prob=1.0)
    jm, jstate, _, tm, tstate = H.models(jcfg, tcfg)
    rng = np.random.RandomState(5)
    img = rng.rand(B, 64, 64, 3).astype(np.float32)
    gt = rng.rand(B, 64, 64, 3).astype(np.float32)
    states = np.zeros((B, jcfg.num_state_dim), np.float32)
    states[:, 2] = [0, 2, 4, 6]
    states[1, 4] = states[2, 5] = 1.0
    return jcfg, tcfg, jm, jstate, tm, tstate, img, gt, states


def _close_trees(got, want):
    """Each leaf within TREE_REL of the largest gradient of its tree."""
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    assert scale > 0
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   atol=TREE_REL * scale, rtol=TREE_RTOL,
                                   err_msg=k)


GV_CASES = {
    'w_td': dict(gan='w', use_TD=True),
    'w_no_td': dict(gan='w', use_TD=False),
    'ls_td': dict(gan='ls', use_TD=True),
    'supervised': dict(supervised=True, use_TD=True),
}


@pytest.mark.parametrize('case', sorted(GV_CASES))
def test_generator_value_loss_matches_jax(nets, case):
    jcfg, tcfg, jm, jstate, tm, tstate, img, gt, states = nets
    jcfg, tcfg = jcfg.copy(), tcfg.copy()
    for k, v in GV_CASES[case].items():
        jcfg[k] = tcfg[k] = v
    filters, policy, critic, value = jm
    key = jax.random.PRNGKey(11)
    truth = gt if jcfg.get('supervised') else None

    def j_loss(p):
        return jl.generator_value_loss(
            p, jstate.crit_params, policy, critic, value, img, states, key,
            jnp.int32(1), 0.3, jcfg, filters, ground_truth=truth)

    (j_total, j_aux), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))({'gen': jstate.gen_params,
                                'val': jstate.val_params})
    noise = jax.random.uniform(jax.random.split(key)[1], (B, 1))

    gen = {k: v.clone().requires_grad_(True)
           for k, v in tstate.gen_params.items()}
    val = {k: v.clone().requires_grad_(True)
           for k, v in tstate.val_params.items()}
    crit = {k: v.clone().requires_grad_(True)
            for k, v in tstate.crit_params.items()}
    draws = ReplayedDraws([('noise', torch.from_numpy(np.array(noise)))])
    total, aux = tl.generator_value_loss(
        {'gen': gen, 'val': val}, crit, tm[1], tm[2], tm[3],
        torch.from_numpy(img), torch.from_numpy(states), draws, 1, 0.3,
        tcfg, tm[0], ground_truth=None if truth is None
        else torch.from_numpy(truth))
    assert draws.left() == 0
    np.testing.assert_allclose(float(total.detach()), float(j_total),
                               rtol=LOSS_RTOL)
    for field in ('g_loss', 'v_loss', 'reward', 'q_value', 'advantage',
                  'fake_logit', 'new_images', 'new_states', 'pdf'):
        np.testing.assert_allclose(
            getattr(aux, field).numpy(), np.asarray(getattr(j_aux, field)),
            rtol=1e-4, atol=1e-5, err_msg=field)
    np.testing.assert_array_equal(aux.selected_filter_id.numpy(),
                                  np.asarray(j_aux.selected_filter_id))

    leaves = list(gen.values()) + list(val.values()) + list(crit.values())
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    n_gen, n_val = len(gen), len(val)
    t_gen = dict(zip(gen, grads[:n_gen]))
    t_val = dict(zip(val, grads[n_gen:n_gen + n_val]))
    _close_trees(t_gen, flax_to_state_dict(H.host_tree(j_grads['gen'])))
    _close_trees(t_val, flax_critic_to_state_dict(
        H.host_tree(j_grads['val'])))
    # partitioning: the critic's parameters get nothing in this path, and
    # the value net's gradient is that of v_loss alone
    assert all(g is None for g in grads[n_gen + n_val:])
    v_only = torch.mean((aux.q_value - tl.apply(
        tm[3], val, torch.from_numpy(img), torch.from_numpy(states))) ** 2)
    alone = torch.autograd.grad(v_only, list(val.values()))
    for k, a in zip(val, alone):
        np.testing.assert_allclose(t_val[k].numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize('gan', ['w', 'ls'])
def test_critic_loss_matches_jax(nets, gan):
    jcfg, tcfg, jm, jstate, tm, tstate, img, gt, _ = nets
    jcfg, tcfg = jcfg.copy(), tcfg.copy()
    jcfg.gan = tcfg.gan = gan
    critic = jm[2]
    key = jax.random.PRNGKey(4)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jl.critic_loss(p, critic, gt, img, key, jcfg),
        has_aux=True))(jstate.crit_params)
    alpha = jax.random.uniform(key, (B, 1, 1, 1))
    crit = {k: v.clone().requires_grad_(True)
            for k, v in tstate.crit_params.items()}
    loss, aux = tl.critic_loss(
        crit, tm[2], torch.from_numpy(gt), torch.from_numpy(img),
        ReplayedDraws([('alpha', torch.from_numpy(np.array(alpha)))]),
        tcfg)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=LOSS_RTOL)
    for field in CriticFields:
        np.testing.assert_allclose(float(getattr(aux, field)),
                                   float(getattr(j_aux, field)),
                                   rtol=1e-4, atol=1e-7, err_msg=field)
    grads = torch.autograd.grad(loss, list(crit.values()))
    _close_trees(dict(zip(crit, grads)),
                 flax_critic_to_state_dict(H.host_tree(j_grads)))


CriticFields = ('c_loss', 'emd', 'gradient_penalty', 'critic_gradient_norm',
                'c_average')
