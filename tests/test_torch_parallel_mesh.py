"""The port's data-parallel mesh (``exposure_tpu_torch/parallel``) against
the JAX package's, and a world of one, on the CPU:

- ``local_batch_size`` and its refusal, against the JAX helper on a JAX
  mesh of the same size;
- ``pad_to_devices`` against the JAX ``Trainer._pad_to_devices`` (called
  unbound on a stub, as ``__graft_entry__.py`` calls it) for a row count
  whose remainder by the world is 0, 1 and world - 1;
- a world of one: the resident and the streaming step with a one-rank mesh
  (without a group in this process, and as a spawned one-rank ``gloo``
  group, whose all-reduce then runs) equal the step without a mesh bit for
  bit; a 3-iteration ``Trainer`` with ``num_devices=1`` equals one with
  ``num_devices=None``;
- the refusals: more than one device without a group, ``nccl`` without
  a card or for two ranks on one card; a world whose rank hangs is
  killed at its deadline, and raises.
"""

import random
import types

import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core.trainer import Trainer as JTrainer
from exposure_tpu.parallel.mesh import data_parallel_mesh as j_mesh
from exposure_tpu.parallel.mesh import local_batch_size as j_local_batch
from exposure_tpu_torch.core.trainer import Trainer
from exposure_tpu_torch.parallel import launch
from exposure_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    data_parallel_mesh,
    local_batch_size,
    pad_to_devices,
)
from exposure_tpu_torch.utils.config import load_config

pytestmark = pytest.mark.usefixtures('few_threads')


@pytest.mark.parametrize('world', [1, 2, 4])
def test_local_batch_size_as_jax(world):
    jm = j_mesh(world)
    mesh = types.SimpleNamespace(shape={DATA_AXIS: world})
    for batch in (8, 16, 64):
        assert local_batch_size(batch, mesh) == j_local_batch(batch, jm) \
            == batch // world
    if world > 1:
        with pytest.raises(AssertionError):
            j_local_batch(4 * world + 1, jm)
        with pytest.raises(ValueError, match='not divisible by %d' % world):
            local_batch_size(4 * world + 1, mesh)
        with pytest.raises(ValueError, match='not divisible'):
            local_batch_size(4 * world + 1, world)


@pytest.mark.parametrize('world', [2, 3, 4])
@pytest.mark.parametrize('rem', ['0', '1', 'w-1'])
def test_pad_to_devices_as_jax(world, rem):
    n = 3 * world + {'0': 0, '1': 1, 'w-1': world - 1}[rem]
    x = np.random.RandomState(n).rand(n, 5, 4, 3).astype(np.float32)
    want = np.asarray(JTrainer._pad_to_devices(
        types.SimpleNamespace(n_dev=world), x))
    got = pad_to_devices(x, world)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] % world == 0
    t = pad_to_devices(torch.from_numpy(x), world)
    np.testing.assert_array_equal(t.numpy(), want)


def _step_job(kind, seed=3):
    rng = np.random.RandomState(seed)
    b, p = 8, 16
    knobs = dict(dropout_keep_prob=1.0, batch_size=b, replay_memory_size=p)
    states = np.zeros((p, load_config('test').num_state_dim), np.float32)
    states[::3, 1] = 1
    states[::3, 2] = 5
    job = dict(kind=kind, knobs=knobs, giters=2, citers=2, seed=seed,
               rates=(1e-3, 1e-3, 0.3),
               pool=(rng.rand(p, 64, 64, 3).astype(np.float32), states, None))
    if kind == 'resident':
        job.update(meta=(64, True), data=(
            rng.rand(12, 80, 80, 3).astype(np.float32),
            rng.rand(12, 64, 64, 3).astype(np.float32)))
    else:
        job['data'] = (rng.rand(2, 2 * b + p, 64, 64, 3).astype(np.float32),
                       rng.rand(2, b, 64, 64, 3).astype(np.float32))
    return job


def _equal(a, b):
    assert a['metrics'] == b['metrics']
    assert a['tensors'].keys() == b['tensors'].keys()
    for k in a['tensors']:
        np.testing.assert_array_equal(a['tensors'][k], b['tensors'][k],
                                      err_msg=k)
    for x, y in zip(a['pool'], b['pool']):
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('kind', ['resident', 'streaming'])
def test_world_of_one_is_the_one_device_step(kind, tmp_path):
    job = _step_job(kind)
    one = data_parallel_mesh(1, device='cpu')
    assert one.world == 1 and not one.grouped
    plain = W.step_rank(one, dict(job, use_mesh=False))
    _equal(W.step_rank(one, job), plain)
    # a one-rank gloo group: the all-reduce runs and divides by 1
    grouped, = launch.spawn_ranks(W.step_rank, 1, (job,), device='cpu',
                                  threads=torch.get_num_threads(),
                                  deadline_s=120,
                                  rendezvous_dir=str(tmp_path))
    _equal(grouped, plain)


def test_trainer_num_devices_one_is_none(tmp_path):
    runs = []
    for n in (None, 1):
        cfg = load_config('test')
        cfg.name = 'one/%s' % n
        random.seed(0)      # the providers draw from it
        trainer = Trainer(cfg, num_devices=n, model_root=str(tmp_path),
                          device='cpu')
        try:
            trainer.train(last_iter=2)
        finally:
            trainer.close()
        assert trainer.world == 1 and trainer.mesh.backend is None
        runs.append(trainer)
    a, b = (t.state.tensors() for t in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(runs[0].pool.images, runs[1].pool.images)


def test_refusals(tmp_path):
    with pytest.raises(ValueError, match='needs a process group'):
        data_parallel_mesh(2, device='cpu')
    cfg = load_config('test')
    with pytest.raises(ValueError, match='needs a process group'):
        Trainer(cfg, num_devices=2, model_root=str(tmp_path), device='cpu')
    with pytest.raises(ValueError, match='nccl needs CUDA'):
        data_parallel_mesh(2, backend='nccl', device='cpu', rank=0,
                           init_file=str(tmp_path / 'never'))


def _nccl_two_ranks(monkeypatch, tmp_path):
    """``nccl`` for two ranks where one card is all there is."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    return data_parallel_mesh(2, backend='nccl', device='cuda:0', rank=0,
                              init_file=str(tmp_path / 'rdv'))


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="backend='gloo'"):
        _nccl_two_ranks(monkeypatch, tmp_path)


def test_a_hung_world_fails_at_its_deadline(tmp_path):
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match='did not finish'):
        launch.spawn_ranks(W.hang, 2, device='cpu', deadline_s=10, threads=1,
                           rendezvous_dir=str(tmp_path))
    assert time.monotonic() - t0 < 40


def test_a_rank_that_does_not_exit_fails_and_prints_its_stack(tmp_path,
                                                              capfd):
    """Every result is in, then the ranks do not exit: the world fails
    after its exit grace, and each rank has printed where it stopped."""
    with pytest.raises(TimeoutError, match='did not exit within 6 s'):
        launch.spawn_ranks(W.hang_on_exit, 2, device='cpu', deadline_s=60,
                           threads=1, rendezvous_dir=str(tmp_path),
                           exit_grace_s=6)
    err = capfd.readouterr().err
    assert err.count('most recent call first') >= 2, err
    assert 'in _run_finalizers' in err, err
