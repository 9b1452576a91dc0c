"""The port's resident outer step on two ranks (two spawned ``gloo``
processes, ``parallel/launch.py``) against the JAX ``build_outer_step`` on
a 2-device mesh, on the CPU.

``test`` at batch 4 and pool 8, giters 2 and citers 2, dropout off; both
sides start from the JAX init (the ranks get it as a flax state dict) and
the same packs and pool, each rank its shards (``P(DATA_AXIS)``: rank r
rows ``[r * n / 2, (r + 1) * n / 2)``).  Each rank replays the JAX step's
draws of its device (the step key folded with the axis index, the local
batch 2 and pool 4; the terminated draws as their Gumbel noise).
Tolerances as ``tests/test_torch_train_step.py``: the metrics (averaged
over the ranks as JAX's ``pmean`` does) rtol 1e-4, the parameters within 3
lr, Adam's moments, each rank's pool against its shard of the JAX pool; and
the ranks' parameters and moments equal bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_workers as W
import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core.replay import PoolState as JPool
from exposure_tpu.core.steps import build_outer_step as j_build_outer_step
from exposure_tpu.parallel.mesh import data_parallel_mesh
from exposure_tpu_torch.parallel.launch import spawn_ranks

pytestmark = pytest.mark.usefixtures('few_threads')

WORLD = 2
B, P = 4, 8
LR = 1e-3
GITERS, CITERS = 2, 2
META = (64, True)


def _inputs(num_state_dim):
    rng = np.random.RandomState(0)
    fake = rng.rand(12, 80, 80, 3).astype(np.float32)
    real = rng.rand(12, 64, 64, 3).astype(np.float32)
    pool_img = rng.rand(P, 64, 64, 3).astype(np.float32)
    states = np.zeros((P, num_state_dim), np.float32)
    states[::3, 1] = 1
    states[::3, 2] = 5
    states[1::3, 2] = 2
    states[2::5, 2] = 7         # over-length records: the keep draw acts
    return fake, real, pool_img, states


@pytest.fixture(scope='module')
def stepped(tmp_path_factory):
    knobs = dict(dropout_keep_prob=1.0, batch_size=B, replay_memory_size=P)
    jcfg, tcfg = H.configs('test', **knobs)
    jm, jstate, tx, tm, tstate = H.models(jcfg, tcfg)
    fake, real, pool_img, states = _inputs(jcfg.num_state_dim)
    step = j_build_outer_step(jcfg, *jm[1:], jm[0], tx,
                              data_parallel_mesh(WORLD), META, META, GITERS,
                              CITERS)
    key = jax.random.PRNGKey(3)
    j_out = step(jstate, JPool(images=jnp.asarray(pool_img),
                               states=jnp.asarray(states)),
                 jnp.asarray(fake), jnp.asarray(real), key,
                 jnp.float32(LR), jnp.float32(LR), jnp.float32(0.3))
    local = lambda x: (x.shape[0] // WORLD,) + x.shape[1:]  # noqa: E731
    draws = [H.numpy_draws(H.step_draws(
        key, jcfg, GITERS, CITERS, local(fake), META, local(real), META,
        axis=r, batch=B // WORLD, pool=P // WORLD, gumbel=True))
        for r in range(WORLD)]
    from flax import serialization
    job = dict(kind='resident', knobs=knobs, giters=GITERS, citers=CITERS,
               meta=META, rates=(LR, LR, 0.3), data=(fake, real),
               pool=(pool_img, states, None), draws=draws,
               state=serialization.to_state_dict(H.host_tree(jstate)))
    ranks = spawn_ranks(W.step_rank, WORLD, (job,), device='cpu', threads=2,
                        deadline_s=120,
                        rendezvous_dir=str(tmp_path_factory.mktemp('rdv')))
    return tstate, j_out, ranks


def test_metrics_match(stepped):
    _, (_, _, j_m), ranks = stepped
    H.check_rank_metrics(j_m, ranks)


def test_parameters_and_adam_match(stepped):
    t0, (j_state, _, _), ranks = stepped
    H.check_rank_states(t0, j_state, ranks, LR)


def test_each_rank_holds_its_shard_of_the_jax_pool(stepped):
    _, (_, j_pool, _), ranks = stepped
    H.check_rank_pools(j_pool, ranks)


def test_ranks_hold_the_same_state_bit_for_bit(stepped):
    H.check_ranks_equal(stepped[2])
