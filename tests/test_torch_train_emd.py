"""The port's ``Trainer`` against the JAX ``Trainer`` through iteration 11
of ``synthetic_explore`` at full width, with ``critic_initialization`` cut
to 2 as the card's training phases cut it, on the CPU.

The card read the EMD (the critic's Wasserstein estimate) at 98-139 by
iterations 11-21 of its runs, and the question was whether the port's
training is at fault there.  Here both trainers start from the JAX
trainer's state, pool and packs, the port replays the draws of each JAX
iteration (its phase keys, as ``tests/test_torch_train_schedule.py``
does), with dropout off, and every metric of every iteration is held to
JAX within that test's tolerance: rtol 1e-3, atol 1e-5.  What was found:
JAX reads 122.995 after iteration 0's critic burst and 251.559 at
iteration 11, and the port the same to within 3e-5 relative.  The card's
runs train with dropout on and on the port's own draws, so their 98-139
is not compared with 251.559 here: the parity of the paths is the check.

It trains about 360 updates at B=64 in each package: about 50 minutes on 8
CPU cores, so it is marked slow and runs outside the tier-1 command.
"""

import jax
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from exposure_tpu.core.trainer import Trainer as JTrainer
from exposure_tpu_torch.core.replay import PoolState as TPool
from exposure_tpu_torch.core.trainer import Trainer

pytestmark = pytest.mark.slow

CONFIG = 'synthetic_explore'
LAST_ITER = 11
CRITIC_INIT = 2


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    jcfg, tcfg = H.configs(CONFIG, dropout_keep_prob=1.0,
                           max_iter_step=LAST_ITER,
                           critic_initialization=CRITIC_INIT,
                           iters_per_dispatch=1, dispatch_pipeline_depth=0)
    jcfg.name = tcfg.name = CONFIG + '/emd'
    jt = JTrainer(jcfg, num_devices=1,
                  model_root=str(tmp_path_factory.mktemp('jax')))
    tt = Trainer(tcfg, model_root=str(tmp_path_factory.mktemp('torch')),
                 device='cpu')
    tt.state = H.to_torch_state(jt.state, tt.state)
    tt.pool = TPool(images=_t(jt.pool.images), states=_t(jt.pool.states))
    tt.fake_images, tt.real_images = _t(jt.fake_images), _t(jt.real_images)
    assert (tt.fake_meta, tt.real_meta) == (jt.fake_meta, jt.real_meta)
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
    j_process, t_process = jt._process_record, tt._process_record

    def j_record(record, books):
        j_rows.append((record[0], record[3]))
        return j_process(record, books)

    def t_record(it, citers, metrics, books):
        t_rows.append((it, metrics))
        return t_process(it, citers, metrics, books)
    jt._process_record, tt._process_record = j_record, t_record
    jt.train()
    tt.train()
    tt.close()          # the tees close in the reverse order of opening
    jt.tee.close()
    return j_rows, t_rows


def test_metric_paths_match_through_iteration_11(trained):
    j_rows, t_rows = trained
    assert [it for it, _ in j_rows] == list(range(LAST_ITER + 1))
    assert [it for it, _ in t_rows] == list(range(LAST_ITER + 1))
    for (it, want), (_, got) in zip(j_rows, t_rows):
        for field, value in want._asdict().items():
            np.testing.assert_allclose(
                float(getattr(got, field)), float(value), rtol=1e-3,
                atol=1e-5, err_msg='iteration %d, %s' % (it, field))

