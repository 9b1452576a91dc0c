"""The port's ``Trainer`` against the JAX ``Trainer`` over the first
iterations of the ``test`` config's schedule, on the CPU: iteration 0 (the
warmup at lr 0, then the critic burst) and plain iterations at the
schedule's learning rates, so that what builds up over iterations (Adam's
moments and counts, the EMA, the pool's ageing, the learning-rate
schedule, the phase keys) is held to JAX, and not one outer step alone.

Both trainers start from the JAX trainer's state, pool and packs (its
mesh of one device).  The
port replays the draws of each JAX iteration, reproduced from its phase
keys (``fold_in(fold_in(PRNGKey(seed + 1), it), 0)`` for the generator
phase, ``1`` for the critic phase), with dropout off.  Tolerances:

- every metric of every iteration (the EMD path, the rewards, the losses):
  rtol 1e-3 (atol 1e-5);
- Adam's moments: within 1e-3 of the largest of their tree (rtol 1e-2),
  the counts equal; the EMA: rtol 1e-3, its count equal;
- the parameters: within 3 lr of JAX;
- the pool: states equal, images within 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core.trainer import Trainer as JTrainer
from exposure_tpu_torch.core.replay import PoolState as TPool
from exposure_tpu_torch.core.trainer import Trainer

pytestmark = pytest.mark.usefixtures('few_threads')

LAST_ITER = 3


def _capture(trainer, process, rows, record_of):
    def recorder(*args):
        rows.append(record_of(*args))
        return process(*args)
    trainer._process_record = recorder


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    jcfg, tcfg = H.configs('test', dropout_keep_prob=1.0,
                           max_iter_step=LAST_ITER)
    jcfg.name = tcfg.name = 'test/schedule'
    jt = JTrainer(jcfg, num_devices=1,
                  model_root=str(tmp_path_factory.mktemp('jax')))
    tt = Trainer(tcfg, model_root=str(tmp_path_factory.mktemp('torch')),
                 device='cpu')
    tt.state = H.to_torch_state(jt.state, tt.state)
    tt.pool = TPool(images=_t(jt.pool.images), states=_t(jt.pool.states))
    tt.fake_images, tt.real_images = _t(jt.fake_images), _t(jt.real_images)
    assert (tt.fake_meta, tt.real_meta) == (jt.fake_meta, jt.real_meta)
    start = tt.state

    base = jax.random.PRNGKey(jcfg.get('seed', 0) + 1)

    def iteration_draws(it, generator):
        giters, citers = tt.schedule(it)[:2]
        key = jax.random.fold_in(base, it)
        shapes = (tuple(tt.fake_images.shape), tt.fake_meta,
                  tuple(tt.real_images.shape), tt.real_meta)
        return H.JaxDraws(
            H.step_draws(jax.random.fold_in(key, 0), jcfg, giters, 0,
                         *shapes) +
            H.step_draws(jax.random.fold_in(key, 1), jcfg, 0, citers,
                         *shapes))
    tt.iteration_draws = iteration_draws

    j_rows, t_rows = [], []
    _capture(jt, jt._process_record, j_rows,
             lambda record, books: (record[0], record[3]))
    _capture(tt, tt._process_record, t_rows,
             lambda it, citers, metrics, books: (it, metrics))
    jt.train()
    tt.train()
    tt.close()          # the tees close in the reverse order of opening
    jt.tee.close()
    return start, jt, tt, j_rows, t_rows


def test_metric_paths_match(trained):
    _, _, _, j_rows, t_rows = trained
    assert [it for it, _ in j_rows] == list(range(LAST_ITER + 1))
    assert [it for it, _ in t_rows] == list(range(LAST_ITER + 1))
    for (it, want), (_, got) in zip(j_rows, t_rows):
        for field, value in want._asdict().items():
            np.testing.assert_allclose(
                float(getattr(got, field)), float(value), rtol=1e-3,
                atol=1e-5, err_msg='iteration %d, %s' % (it, field))


def test_states_match_after_the_schedule(trained):
    start, jt, tt, _, _ = trained
    want = H.to_torch_state(jt.state, start)
    got = tt.state
    assert int(got.step) == int(jt.state.step) == LAST_ITER + 1
    for opt in ('opt_g', 'opt_v', 'opt_c'):
        a, b = getattr(got, opt), getattr(want, opt)
        assert a.count == b.count, opt
        for moment in ('mu', 'nu'):
            ma, mb = getattr(a, moment), getattr(b, moment)
            scale = max(float(v.abs().max()) for v in mb.values())
            for k in mb:
                np.testing.assert_allclose(
                    ma[k].numpy(), mb[k].numpy(), rtol=1e-2,
                    atol=1e-3 * scale, err_msg='%s %s %s' % (opt, moment, k))
    assert got.ema.count == want.ema.count
    np.testing.assert_allclose(float(got.ema.biased),
                               float(want.ema.biased), rtol=1e-3)
    cfg = tt.cfg
    for tree, lr in (('gen_params', cfg.lr_g(1)),
                     ('val_params', cfg.lr_g(1) * cfg.value_lr_mul),
                     ('crit_params', cfg.lr_c(0))):
        worst = max(H.tree_max_abs(getattr(got, tree),
                                   getattr(want, tree)).values())
        assert worst <= 3 * lr, (tree, worst / lr)


def test_pools_match_slot_for_slot(trained):
    _, jt, tt, _, _ = trained
    np.testing.assert_array_equal(tt.pool.states.numpy(),
                                  np.asarray(jt.pool.states))
    np.testing.assert_allclose(tt.pool.images.numpy(),
                               np.asarray(jt.pool.images), atol=1e-4)
