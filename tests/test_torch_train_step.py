"""One outer training iteration of the port against the JAX
``build_outer_step`` on a 1-device mesh, on the CPU.

Both start from the same state (the JAX init, carried over by the
checkpoint map) and the same pool and packs; the port replays every draw
of the JAX step, reproduced from its key (``torch_train_helpers.py``), with
dropout off.  Tolerances:

- the metrics: rtol 1e-4 (atol 1e-6);
- the three parameter trees: within 3 lr of JAX (Adam's first steps move
  each parameter by about lr whatever its gradient's size, so a
  near-zero gradient of the other sign moves it 2 lr the other way;
  ``tests/test_torch_losses.py`` holds the gradients to rtol);
- Adam's moments: within 1e-4 of the largest of their tree (rtol 1e-3), the
  counts equal; the EMA: rtol 1e-4, its count equal;
- the pool: states equal, images within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core.replay import PoolState as JPool
from exposure_tpu.core.steps import build_outer_step as j_build_outer_step
from exposure_tpu.parallel.mesh import data_parallel_mesh
from exposure_tpu_torch.core.replay import PoolState as TPool
from exposure_tpu_torch.core.steps import build_outer_step

pytestmark = pytest.mark.usefixtures('few_threads')

B, P = 8, 16
LR = 1e-3
CASES = {
    # name: (knobs, giters, citers)
    'wgan': (dict(), 2, 2),
    'supervised': (dict(supervised=True), 1, 0),
}


def _inputs(supervised, num_state_dim):
    rng = np.random.RandomState(0)
    channels = 6 if supervised else 3
    fake = rng.rand(12, 80, 80, channels).astype(np.float32)
    real = rng.rand(12, 64, 64, 3).astype(np.float32)
    pool_img = rng.rand(P, 64, 64, 3).astype(np.float32)
    pool_gt = rng.rand(P, 64, 64, 3).astype(np.float32) if supervised \
        else None
    states = np.zeros((P, num_state_dim), np.float32)
    states[::3, 1] = 1
    states[::3, 2] = 5
    states[1::3, 2] = 2
    states[2::5, 2] = 7         # over-length records: the keep draw acts
    return fake, real, pool_img, pool_gt, states


@pytest.fixture(scope='module', params=sorted(CASES))
def stepped(request):
    knobs, giters, citers = CASES[request.param]
    jcfg, tcfg = H.configs('test', dropout_keep_prob=1.0, batch_size=B,
                           replay_memory_size=P, **knobs)
    jm, jstate, tx, tm, tstate = H.models(jcfg, tcfg)
    supervised = bool(knobs.get('supervised'))
    fake, real, pool_img, pool_gt, states = _inputs(supervised,
                                                     jcfg.num_state_dim)
    meta = (64, True)
    step = j_build_outer_step(jcfg, *jm[1:], jm[0], tx,
                              data_parallel_mesh(1), meta, meta, giters,
                              citers)
    key = jax.random.PRNGKey(3)
    j_out = step(jstate, JPool(images=jnp.asarray(pool_img),
                               states=jnp.asarray(states),
                               ground_truth=None if pool_gt is None
                               else jnp.asarray(pool_gt)),
                 jnp.asarray(fake), jnp.asarray(real), key,
                 jnp.float32(LR), jnp.float32(LR), jnp.float32(0.3))
    draws = H.JaxDraws(H.step_draws(key, jcfg, giters, citers, fake.shape,
                                    meta, real.shape, meta))
    t_step = build_outer_step(tcfg, *tm[1:], tm[0], meta, meta, giters,
                              citers)
    t_out = t_step(tstate, TPool(images=torch.from_numpy(pool_img),
                                 states=torch.from_numpy(states),
                                 ground_truth=None if pool_gt is None
                                 else torch.from_numpy(pool_gt)),
                   torch.from_numpy(fake), torch.from_numpy(real), draws,
                   LR, LR, 0.3)
    assert draws.left() == 0
    return tstate, j_out, t_out


def test_metrics_match(stepped):
    _, (_, _, j_m), (_, _, t_m) = stepped
    for field, want in j_m._asdict().items():
        got = float(getattr(t_m, field))
        if np.isnan(float(want)):       # a phase that ran no update
            assert np.isnan(got), field
            continue
        np.testing.assert_allclose(got, float(want), rtol=1e-4, atol=1e-6,
                                   err_msg=field)


def test_parameters_within_three_lr(stepped):
    t0, (j_state, _, _), (t_state, _, _) = stepped
    want = H.to_torch_state(j_state, t0)
    for tree in ('gen_params', 'val_params', 'crit_params'):
        worst = max(H.tree_max_abs(getattr(t_state, tree),
                                   getattr(want, tree)).values())
        assert worst <= 3 * LR, (tree, worst / LR)


def test_adam_and_ema_match(stepped):
    t0, (j_state, _, _), (t_state, _, _) = stepped
    want = H.to_torch_state(j_state, t0)
    for opt in ('opt_g', 'opt_v', 'opt_c'):
        a, b = getattr(t_state, opt), getattr(want, opt)
        assert a.count == b.count, opt
        for moment in ('mu', 'nu'):
            ma, mb = getattr(a, moment), getattr(b, moment)
            scale = max(float(v.abs().max()) for v in mb.values())
            for k in mb:
                np.testing.assert_allclose(
                    ma[k].numpy(), mb[k].numpy(), rtol=1e-3,
                    atol=1e-4 * scale, err_msg='%s %s %s' % (opt, moment, k))
    assert t_state.ema.count == want.ema.count
    np.testing.assert_allclose(float(t_state.ema.biased),
                               float(want.ema.biased), rtol=1e-4, atol=1e-9)


def test_pool_matches_slot_for_slot(stepped):
    _, (_, j_pool, _), (_, t_pool, _) = stepped
    np.testing.assert_array_equal(t_pool.states.numpy(),
                                  np.asarray(j_pool.states))
    np.testing.assert_allclose(t_pool.images.numpy(),
                               np.asarray(j_pool.images), atol=1e-5)
    if j_pool.ground_truth is not None:
        np.testing.assert_array_equal(t_pool.ground_truth.numpy(),
                                      np.asarray(j_pool.ground_truth))


def test_supervised_refuses_critic_updates():
    _, tcfg = H.configs('test', supervised=True)
    with pytest.raises(ValueError, match='supervised'):
        build_outer_step(tcfg, None, None, None, None, (64, True),
                         (64, True), 1, 2)
