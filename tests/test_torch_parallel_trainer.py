"""Training under two ranks on the CPU (two spawned ``gloo`` processes;
resume and checkpoints: ``tests/test_torch_parallel_resume.py``):

- ``Trainer(num_devices=2)``, 3 iterations of ``test``, resident and
  streaming: finite metrics, the ranks' states equal bit for bit, only rank
  0 wrote (one ``metrics.jsonl``, one ``log.txt``, its checkpoints), two
  runs from one seed equal (each rank seeds ``random`` apart first: the
  trainer seeds the providers alike);
- ``train_torch.py --num-devices 2 --device cpu`` spawns two ranks (a run
  cut to 2 iterations through the trainer's ``last_iter``), and
  ``--num-devices 3`` refuses the ``test`` config's batch of 16.
"""

import numpy as np
import pytest

import torch_parallel_workers as W
import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu_torch.parallel.launch import spawn_ranks
from exposure_tpu_torch.utils.config import load_config

pytestmark = pytest.mark.usefixtures('few_threads')

WORLD = 2


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp('trainers')
    out = {}
    for kind, knobs in (('resident', {}),
                        ('streaming', dict(stream_data=True,
                                           stream_iters_per_dispatch=2))):
        job = dict(knobs=knobs, runs=[kind + '_a', kind + '_b'],
                   last_iter=2, root=str(root))
        out[kind] = spawn_ranks(W.trainer_rank, WORLD, (job,), device='cpu',
                                threads=2, deadline_s=150,
                                rendezvous_dir=str(root))
    return root, out


@pytest.mark.parametrize('kind', ['resident', 'streaming'])
def test_trainer_on_two_ranks(trained, kind):
    root, out = trained
    ranks = out[kind]
    for rank in ranks:
        for run in (kind + '_a', kind + '_b'):
            r = rank[run]
            assert r['streaming'] == (kind == 'streaming')
            assert np.isfinite(np.asarray(r['metrics'])).all()
            assert r['step'] == 3
    for run in (kind + '_a', kind + '_b'):
        H.check_ranks_equal([{'tensors': rank[run]['tensors'],
                              'metrics': rank[run]['metrics']}
                             for rank in ranks])
    # two runs from one seed
    H.check_ranks_equal([{'tensors': ranks[0][run]['tensors'],
                          'metrics': ranks[0][run]['metrics']}
                         for run in (kind + '_a', kind + '_b')])
    # the ranks hold different shards of the pool
    assert not np.array_equal(ranks[0][kind + '_a']['pool'],
                              ranks[1][kind + '_a']['pool'])
    files = W.listing(str(root / 'parallel' / (kind + '_a')))
    assert files.count('metrics.jsonl') == 1 and files.count('log.txt') == 1
    assert [f for f in files if f.startswith('model.ckpt')] == [
        'model.ckpt-2.msgpack']
    lines = open(root / 'parallel' / (kind + '_a') /
                 'metrics.jsonl').read().splitlines()
    assert len(lines) == 1          # iteration 0, written once


def test_train_torch_spawns_ranks(tmp_path, monkeypatch):
    import train_torch
    monkeypatch.chdir(tmp_path)
    train_torch.main(['test', 'two', '--num-devices', '2', '--device', 'cpu'],
                     last_iter=1, deadline_s=120, threads=2)
    run = tmp_path / 'models' / 'test' / 'two'
    files = W.listing(str(run))
    assert 'metrics.jsonl' in files and 'log.txt' in files
    assert 'model.ckpt-2.msgpack' in files
    log = (run / 'log.txt').read_text()
    assert '2-rank data-parallel world (gloo)' in log
    assert load_config('test').batch_size % 3
    with pytest.raises(ValueError, match='not divisible by 3'):
        train_torch.main(['test', 'three', '--num-devices', '3', '--device',
                          'cpu'])
    assert not (tmp_path / 'models' / 'test' / 'three').exists()
