"""The port's streaming outer step on two ranks (two spawned ``gloo``
processes) against the JAX ``build_streaming_outer_step`` on a 2-device
mesh, on the CPU: one bundle in float32 and in uint8, giters 1 and citers
2 (``tests/test_torch_parallel_paired.py``: the supervised bundle).  One
generator update: the metrics of a second one are taken at parameters that
Adam's first step moves up to 2 lr apart on the two sides (the sign of a
near-zero gradient), which moves its losses by about 1e-3 of themselves at
these sizes, on one device as on two.  Each rank is given its
``P(None, DATA_AXIS)`` shard of the bundle (rank r: rows
``[r * n / 2, (r + 1) * n / 2)`` of axis 1) and of the pool, and replays
the JAX draws of its device.  Tolerances as
``tests/test_torch_parallel_step.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_workers as W
import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core.replay import PoolState as JPool
from exposure_tpu.core.steps import (
    build_streaming_outer_step as j_build_streaming_outer_step,
)
from exposure_tpu.parallel.mesh import data_parallel_mesh
from exposure_tpu_torch.parallel.launch import spawn_ranks

pytestmark = pytest.mark.usefixtures('few_threads')

WORLD = 2
B, P = 4, 8
LR = 1e-3
CASES = {
    # name: (knobs, giters, citers, bundle dtype)
    'f32': (dict(), 1, 2, np.float32),
    'u8': (dict(), 1, 2, np.uint8),
    'paired': (dict(supervised=True), 1, 0, np.float32),
}
HERE = ('f32', 'u8')


def stream_draws(key, cfg, giters, citers, axis, b, p):
    """Every draw of device ``axis``'s share of one JAX streaming step, in
    the port's order: per generator update ``split(k, 3)`` (rank, the agent
    step's noise, keep), per critic update ``split(k, 2)`` (terminated as
    its Gumbel noise, alpha)."""
    key = jax.random.fold_in(key, axis)
    out = []
    for k in jax.random.split(jax.random.fold_in(key, 1), giters):
        k_sel, k_step, k_keep = jax.random.split(k, 3)
        out.append(('rank', H._t(jax.random.uniform(k_sel, (p,)))))
        _, k_noise = jax.random.split(k_step)
        out.append(('noise', H._t(jax.random.uniform(k_noise, (b, 1)))))
        out.append(('keep', H._t(jax.random.bernoulli(
            k_keep, cfg.over_length_keep_prob, (b,)))))
    for k in (jax.random.split(jax.random.fold_in(key, 2), citers)
              if citers else []):
        k_fake, k_gp = jax.random.split(k, 2)
        out.append(('terminated', H.gumbel_draw(k_fake, b, p)))
        out.append(('alpha', H._t(jax.random.uniform(k_gp, (b, 1, 1, 1)))))
    return out


def _bundle(supervised, giters, citers, dtype, num_state_dim):
    rng = np.random.RandomState(0)
    channels = 6 if supervised else 3
    g = rng.rand(giters, 2 * B + P, 64, 64, channels)
    r = rng.rand(citers, B, 64, 64, 3)
    if dtype == np.uint8:
        g, r = (np.round(x * 255).astype(np.uint8) for x in (g, r))
    else:
        g, r = g.astype(np.float32), r.astype(np.float32)
    pool_img = rng.rand(P, 64, 64, 3).astype(np.float32)
    pool_gt = rng.rand(P, 64, 64, 3).astype(np.float32) if supervised \
        else None
    states = np.zeros((P, num_state_dim), np.float32)
    states[::3, 1] = 1
    states[::3, 2] = 5
    states[1::3, 2] = 2
    states[2::5, 2] = 7
    return g, r, pool_img, pool_gt, states


def run_case(name, rdv_dir):
    """The JAX step and the two ranks' on case ``name``: ``(the port's
    template state, the JAX step's outputs, the ranks' results)``."""
    knobs, giters, citers, dtype = CASES[name]
    knobs = dict(knobs, dropout_keep_prob=1.0, batch_size=B,
                 replay_memory_size=P)
    jcfg, tcfg = H.configs('test', **knobs)
    jm, jstate, tx, tm, tstate = H.models(jcfg, tcfg)
    supervised = bool(knobs.get('supervised'))
    g, r, pool_img, pool_gt, states = _bundle(supervised, giters, citers,
                                              dtype, jcfg.num_state_dim)
    step = j_build_streaming_outer_step(jcfg, *jm[1:], jm[0], tx,
                                        data_parallel_mesh(WORLD), giters,
                                        citers)
    key = jax.random.PRNGKey(5)
    rates = (LR, LR, 0.3)
    j_out = step(jstate, JPool(
        images=jnp.asarray(pool_img), states=jnp.asarray(states),
        ground_truth=None if pool_gt is None else jnp.asarray(pool_gt)),
        jnp.asarray(g), jnp.asarray(r), key,
        *[jnp.float32(x) for x in rates])
    draws = [H.numpy_draws(stream_draws(key, jcfg, giters, citers, axis,
                                      B // WORLD, P // WORLD))
             for axis in range(WORLD)]
    from flax import serialization
    job = dict(kind='streaming', knobs=knobs, giters=giters, citers=citers,
               rates=rates, data=(g, r), pool=(pool_img, states, pool_gt),
               draws=draws,
               state=serialization.to_state_dict(H.host_tree(jstate)))
    ranks = spawn_ranks(W.step_rank, WORLD, (job,), device='cpu', threads=2,
                        deadline_s=120, rendezvous_dir=rdv_dir)
    return tstate, j_out, ranks


@pytest.fixture(scope='module', params=HERE)
def stepped(request, tmp_path_factory):
    return run_case(request.param, str(tmp_path_factory.mktemp('rdv')))


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
