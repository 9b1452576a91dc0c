"""The port's streaming outer step on two ranks against the JAX
``build_streaming_outer_step`` on a 2-device mesh, on the CPU, in
supervised mode: each crop of the bundle carries its paired ground truth
as three more channels, and the pool its ground truth, both split by rank
(giters 1, citers 0; the cases and tolerances of
``tests/test_torch_parallel_stream.py``)."""

import pytest

import torch_train_helpers as H
from test_torch_parallel_stream import LR, run_case
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures('few_threads')


@pytest.fixture(scope='module')
def stepped(tmp_path_factory):
    return run_case('paired', str(tmp_path_factory.mktemp('rdv')))


def test_metrics_match(stepped):
    _, (_, _, j_m), ranks = stepped
    H.check_rank_metrics(j_m, ranks)


def test_parameters_and_adam_match(stepped):
    t0, (j_state, _, _), ranks = stepped
    H.check_rank_states(t0, j_state, ranks, LR)


def test_each_rank_holds_its_shard_of_the_jax_pool_and_ground_truth(
        stepped):
    _, (_, j_pool, _), ranks = stepped
    assert j_pool.ground_truth is not None
    H.check_rank_pools(j_pool, ranks)


def test_ranks_hold_the_same_state_bit_for_bit(stepped):
    H.check_ranks_equal(stepped[2])
