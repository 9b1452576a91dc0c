"""The port's Trainer and ``train_torch.py`` on the CPU, on the ``test``
config.

- The run layout of ``tests/test_e2e.py``: checkpoints, ``log.txt``,
  ``metrics.jsonl``, the scripts backup, the visualization grids;
- iteration 0 (the warmup at lr 0 and the critic burst): the generator and
  value parameters keep their bits, Adam counts the updates, the critic
  moves; every metric finite;
- resume: the newest checkpoint restores every tensor bit for bit, and
  training goes on from it; the NaN guard dumps the state and raises;
- the schedule, ``is_special_iteration`` and ``pool_health_warning``
  against the JAX trainer; supervised mode trains no critic;
- the entry script trains, checkpoints and resumes; the card is the
  default device; ``profile_dir`` traces the JAX trainer's window of
  iterations.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import train_torch
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core import trainer as jtrainer
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.core import trainer as ttrainer
from exposure_tpu_torch.core.steps import StepMetrics
from exposure_tpu_torch.core.trainer import Trainer
from exposure_tpu_torch.data.synthetic import PairedSyntheticDataProvider
from exposure_tpu_torch.utils import trace
from exposure_tpu_torch.utils.config import load_config

pytestmark = pytest.mark.usefixtures('few_threads')


def _cfg(name='test/smoke', **knobs):
    cfg = load_config('test')
    cfg.name = name
    cfg.update(knobs)
    return cfg


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp('models')
    cfg = _cfg(max_iter_step=3, write_image_interval=2)
    trainer = Trainer(cfg, model_root=str(root), device='cpu')
    metrics = trainer.train()
    trainer.close()
    return cfg, trainer, root, metrics


def test_training_writes_the_run_layout(trained):
    cfg, trainer, root, metrics = trained
    run_dir = os.path.join(str(root), 'test', 'smoke')
    assert trainer.latest_checkpoint() == 4
    assert sorted(p for p in os.listdir(run_dir) if 'ckpt' in p) == \
        ['model.ckpt-2.msgpack', 'model.ckpt-4.msgpack']
    with open(os.path.join(run_dir, 'log.txt')) as f:
        log = f.read()
    assert 'it     0,' in log and '# checkpoint saved:' in log
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    assert [r['step'] for r in rows] == [0]
    assert {'g_loss', 'emd', 'pool_term_frac', 'ms_per_iter'} <= set(rows[0])
    assert os.path.exists(os.path.join(run_dir, 'scripts', 'config_test.py'))
    assert os.path.exists(os.path.join(run_dir, 'scripts', 'config.py'))
    assert sorted(os.listdir(trainer.image_dir)) == ['000000.png',
                                                     '000002.png']
    assert np.isfinite(np.asarray(metrics)).all()
    assert metrics.pool_terminated_frac > 0
    assert trainer.state.step == 4


def test_iteration_zero_moves_only_the_moments_and_the_critic(tmp_path):
    trainer = Trainer(_cfg(), restore=True, model_root=str(tmp_path),
                      device='cpu')
    init = {k: v.clone() for k, v in trainer.state.tensors().items()}
    _, metrics = trainer.run_iteration(0, torch.Generator())
    trainer.close()
    assert all(torch.isfinite(m) for m in metrics)
    state, cfg = trainer.state, trainer.cfg
    for tree in ('gen_params', 'val_params'):
        for k, v in getattr(state, tree).items():
            assert torch.equal(v, init['%s/%s' % (tree, k)]), k
    assert state.opt_g.count == state.opt_v.count == cfg.warmup_giters
    assert state.opt_c.count == state.ema.count == cfg.critic_burst
    assert any(not torch.equal(v, init['crit_params/' + k])
               for k, v in state.crit_params.items())
    assert trainer.pool.terminated_mask().any()


def test_resume_restores_every_tensor_and_goes_on(trained):
    cfg, trainer, root, _ = trained
    again = Trainer(cfg, restore=True, model_root=str(root), device='cpu')
    assert again.restore() == 4 and again.state.step == 4
    want, got = trainer.state.tensors(), again.state.tensors()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for opt in ('opt_g', 'opt_v', 'opt_c'):
        assert getattr(again.state, opt).count == \
            getattr(trainer.state, opt).count
    assert again.state.ema.count == trainer.state.ema.count
    again.cfg.max_iter_step = 4
    metrics = again.train()
    again.close()
    assert again.state.step == 5 and np.isfinite(np.asarray(metrics)).all()


def test_visualization_grid(trained):
    _, trainer, _, _ = trained
    path = trainer.visualize(7)
    assert path.endswith('000007.png') and os.path.getsize(path) > 0


def test_nan_guard_dumps_and_raises(tmp_path, monkeypatch):
    trainer = Trainer(_cfg(max_iter_step=2), restore=True,
                      model_root=str(tmp_path), device='cpu')

    def poisoned(it, generator):
        nan = torch.tensor(float('nan'))
        return 0, StepMetrics(*([nan] + [torch.tensor(0.0)] * 6))

    monkeypatch.setattr(trainer, 'run_iteration', poisoned)
    with pytest.raises(FloatingPointError, match='non-finite'):
        trainer.train()
    trainer.close()
    assert os.path.exists(os.path.join(trainer.dir, 'model.ckpt-0.msgpack'))


def test_schedule_and_helpers_match_the_jax_trainer():
    cfg, jcfg = load_config('synthetic_explore'), j_load_config(
        'synthetic_explore')
    host = types.SimpleNamespace(cfg=cfg, supervised=False)
    for it in (0, 1, 9, 10, 11, 499, 500, 501, 1000):
        giters, citers, lr_g, lr_c = Trainer.schedule(host, it)
        burst = it < jcfg.critic_initialization or it % 500 == 0
        assert giters == (jcfg.get('warmup_giters', 100) if it == 0
                          else jcfg.giters)
        assert citers == (jcfg.get('critic_burst', 100) if burst
                          else jcfg.citers)
        assert lr_g == (0.0 if it == 0 else jcfg.lr_g(it))
        assert lr_c == jcfg.lr_c(it)
        for supervised in (False, True):
            assert ttrainer.is_special_iteration(it, cfg, supervised) == \
                jtrainer.is_special_iteration(it, jcfg, supervised)
    for args in ((5, False, 0.0), (5, True, 0.0), (0, False, 0.0),
                 (5, False, 0.25)):
        assert (ttrainer.pool_health_warning(*args) is None) == \
            (jtrainer.pool_health_warning(*args) is None)


def test_supervised_trains_no_critic(tmp_path):
    cfg = _cfg('test/paired', max_iter_step=1, supervised=True,
               critic_burst=0)
    cfg.fake_data_provider = lambda: PairedSyntheticDataProvider(
        n=64, size=80, seed=0, output_size=64, augmentation=0.3,
        default_batch_size=cfg.batch_size)
    trainer = Trainer(cfg, restore=True, model_root=str(tmp_path),
                      device='cpu')
    init = {k: v.clone() for k, v in trainer.state.crit_params.items()}
    metrics = trainer.train()
    trainer.close()
    assert trainer.pool.ground_truth is not None
    assert trainer.state.opt_c.count == 0
    assert all(torch.equal(v, init[k])
               for k, v in trainer.state.crit_params.items())
    assert np.isfinite(np.asarray(metrics)).all()


def test_entry_script_trains_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)

    def short(steps):
        def load(config):
            cfg = load_config(config)
            cfg.max_iter_step = steps
            return cfg
        monkeypatch.setattr(train_torch, 'load_config', load)

    short(2)
    train_torch.main(['test', 'cli', '--device', 'cpu'])
    run = tmp_path / 'models' / 'test' / 'cli'
    assert (run / 'model.ckpt-2.msgpack').exists()
    short(3)
    train_torch.main(['test', 'cli', '--device', 'cpu', '--resume'])
    assert '# restored checkpoint at step 2' in capsys.readouterr().out
    assert (run / 'model.ckpt-4.msgpack').exists()


def test_card_by_default_and_refusals(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Trainer(_cfg(), restore=True)
    # more than one device needs the process group of its ranks
    # (tests/test_torch_parallel_*.py train under two)
    with pytest.raises(ValueError, match='needs a process group'):
        Trainer(_cfg(), restore=True, num_devices=2, device='cpu')


def test_profile_dir_traces_the_window(tmp_path, monkeypatch):
    """``cfg.profile_dir``: the iterations ``PROFILE_START``..
    ``PROFILE_STOP`` (20-30, as the JAX trainer's; 1-1 here) traced with
    ``torch.profiler`` into the directory, stopped when ``train``
    returns."""
    assert (ttrainer.PROFILE_START, ttrainer.PROFILE_STOP) == (20, 30)
    events = _profiled(tmp_path, monkeypatch)
    assert any('conv' in str(e.get('name', '')) for e in events)


def _profiled(tmp_path, monkeypatch, **knobs):
    """The events of the trace a trainer with ``profile_dir`` writes over
    iteration 1 of 2 (the program's tracing restored afterwards)."""
    monkeypatch.setattr(ttrainer, 'PROFILE_START', 1)
    monkeypatch.setattr(ttrainer, 'PROFILE_STOP', 1)
    monkeypatch.setattr(trace, '_on', trace.enabled())
    prof = tmp_path / 'trace'
    trainer = Trainer(_cfg(profile_dir=str(prof), **knobs),
                      model_root=str(tmp_path), device='cpu')
    try:
        assert trace.enabled()
        trainer.train(last_iter=2)
        assert trainer._prof is None and trainer._prof_done
    finally:
        trainer.close()
    traces = [f for f in os.listdir(prof) if f.endswith('.pt.trace.json')]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        return json.load(f)['traceEvents']


def test_profile_dir_trace_carries_the_program_ranges(tmp_path, monkeypatch):
    """A trainer with ``profile_dir`` turns the program's tracing on, so a
    fused dispatch in the traced window leaves its ``exposure.fused.*``
    host ranges in the trace."""
    events = _profiled(tmp_path, monkeypatch, iters_per_dispatch=2,
                       checkpoint_interval=100)
    names = {str(e.get('name', '')) for e in events}
    assert {'exposure.fused.run', 'exposure.fused.table',
            'exposure.fused.draws', 'exposure.fused.metrics'} <= names
