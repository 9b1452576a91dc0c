"""Resume and checkpoints under two ranks on the CPU (two spawned ``gloo``
processes), after ``__graft_entry__.py::dryrun_multichip``'s resume: rank 0
saves a checkpoint of a two-rank state, both ranks restore it onto a
template from another seed, and the next step from it equals the step from
the saved state bit for bit; the checkpoint loads in the JAX
``restore_checkpoint``, and a JAX checkpoint restores on both ranks, equal
to the JAX state."""

import numpy as np
import pytest

import torch_parallel_workers as W
import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core.checkpoint import restore_checkpoint as j_restore
from exposure_tpu.core.checkpoint import save_checkpoint as j_save
from exposure_tpu_torch.core.checkpoint import state_from_flax
from exposure_tpu_torch.parallel.launch import spawn_ranks

pytestmark = pytest.mark.usefixtures('few_threads')

WORLD = 2


@pytest.fixture(scope='module')
def resumed(tmp_path_factory):
    root = tmp_path_factory.mktemp('resume')
    jcfg, tcfg = H.configs('test', batch_size=4, replay_memory_size=8)
    jm, jstate, tx, tm, tstate = H.models(jcfg, tcfg, seed=5)
    jax_dir = root / 'jax'
    j_save(str(jax_dir), jstate, 9)
    rng = np.random.RandomState(1)
    states = np.zeros((8, tcfg.num_state_dim), np.float32)
    states[::2, 1] = 1
    job = dict(knobs=dict(batch_size=4, replay_memory_size=8), giters=1,
               citers=2, rates=(1e-3, 1e-3, 0.3),
               data=(rng.rand(6, 80, 80, 3).astype(np.float32),
                     rng.rand(6, 64, 64, 3).astype(np.float32)),
               pool=(rng.rand(8, 64, 64, 3).astype(np.float32), states,
                     None),
               dir=str(root / 'port'), jax_dir=str(jax_dir))
    ranks = spawn_ranks(W.resume_rank, WORLD, (job,), device='cpu',
                        threads=2, deadline_s=120,
                        rendezvous_dir=str(root))
    return ranks, (jm, jstate, tx), tstate, job


def test_resume_under_two_ranks_is_bit_identical(resumed):
    ranks, _, _, _ = resumed
    assert all(r['equal'] for r in ranks)
    assert ranks[0]['digest'] == ranks[1]['digest']


def test_two_rank_checkpoint_loads_in_jax(resumed):
    ranks, (jm, jstate, tx), tstate, job = resumed
    from exposure_tpu.core.trainer import init_train_state
    jcfg, _ = H.configs('test', batch_size=4, replay_memory_size=8)
    template, _ = init_train_state(jcfg, *jm[1:], seed=1)
    restored, step = j_restore(job['dir'], template)
    assert step == 5
    got = H.to_torch_state(restored, tstate)
    want = state_from_flax(ranks[0]['saved'], tstate)
    a, b = got.tensors(), want.tensors()
    for k in b:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    assert got.opt_g.count == want.opt_g.count == 1
    assert got.opt_c.count == want.opt_c.count == 2


def test_a_jax_checkpoint_restores_on_both_ranks(resumed):
    ranks, (_, jstate, _), tstate, _ = resumed
    want = H.to_torch_state(jstate, tstate).tensors()
    for rank in ranks:
        got = state_from_flax(rank['from_jax'], tstate).tensors()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
