"""The port's ``diagnose_diversity``, ``validate_parity`` and
``ablate_w_usage`` end to end against the JAX tools, on the CPU at the
``test`` widths:

- ``diagnose_diversity.analyze``, dropout off: the argmax and gray-shift
  sections equal the JAX ones (the rounded ``pdf_top1`` values equal), the
  sampling section checked on its properties (the generators' streams are
  not JAX's);
- ``validate_parity.run_seed``, dropout off, ``random`` seeded alike before
  the quality report: ``--skip-trained`` on a JAX checkpoint gives the JAX
  record (quality, trajectories and tail within 1e-4), and a 2-iteration
  training gives the JAX record's keys, finite values and a checkpoint of
  its final state, which ``--skip-trained`` scores alike;
- ``ablate_w_usage``: the config it builds equals the one the JAX ``main``
  builds (its ``Trainer`` stubbed), the cast providers' data bit for bit,
  and a 2-iteration run at the ``test`` widths without ``C``, whose report
  ``--skip-trained`` repeats.
"""

import json
import math
import os
import random
import re
import sys

import numpy as np
import pytest

import torch_train_helpers as H
from torch_train_helpers import dropout_off, few_threads  # noqa: F401
from exposure_tpu.tools import ablate_w_usage as j_aw
from exposure_tpu.tools import diagnose_diversity as j_dd
from exposure_tpu.tools import validate_parity as j_vp
from exposure_tpu_torch.tools import ablate_w_usage as t_aw
from exposure_tpu_torch.tools import diagnose_diversity as t_dd
from exposure_tpu_torch.tools import validate_parity as t_vp

pytestmark = pytest.mark.usefixtures('few_threads')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDED = 1e-4 + 1e-9       # one unit of the reports' 4-decimal rounding


@pytest.mark.parametrize('seed', [0, 1])
def test_analyze_equals_jax(seed):
    from exposure_tpu.core.evaluator import Evaluator as JEvaluator
    from exposure_tpu_torch.core.evaluator import Evaluator
    jcfg, tcfg = H.configs('test', dropout_keep_prob=1.0)
    jcfg.name = tcfg.name = 'test/none'
    jm, jstate, _, tm, tstate = H.models(jcfg, tcfg, seed)
    jev = JEvaluator(jcfg, state=jstate)
    tev = Evaluator(tcfg, state=tstate, device='cpu')
    inputs = np.random.RandomState(seed).rand(16, 64, 64, 3).astype(
        np.float32)
    inputs[:4] = np.clip(inputs[:4] * np.asarray([1.3, 1.0, 0.7],
                                                 np.float32), 0, 1)  # casts
    want = j_dd.analyze(jcfg, jev, inputs, keys=3)
    got = t_dd.analyze(tcfg, tev, inputs, keys=3)
    assert sorted(got) == sorted(want)
    assert got['argmax'] == want['argmax']
    assert got['gray_shift_ablation'] == want['gray_shift_ablation']
    samp = got['sampling']
    assert sorted(samp) == sorted(want['sampling'])
    assert 1 / 32 <= samp['distinct_frac'] <= 1.0
    assert 0.0 <= samp['entropy_bits'] <= math.log2(32) + 1e-9


def _record_close(got, want):
    assert sorted(got) == sorted(want)
    for key in ('seed', 'run', 'iters', 'trajectories', 'final_emd',
                'final_g_loss'):
        assert got[key] == want[key], key
    assert sorted(got['quality']) == sorted(want['quality'])
    for key, v in want['quality'].items():
        np.testing.assert_allclose(got['quality'][key], v, rtol=0,
                                   atol=ROUNDED, err_msg=key)


def test_run_seed_skip_trained_equals_jax(tmp_path, monkeypatch,
                                          dropout_off):
    import exposure_tpu.tools.quality_report as j_quality
    from exposure_tpu.core.checkpoint import save_checkpoint
    # a run the JAX package checkpointed (an initial state from seed 0,
    # its step 0, in a file named 5) with a planted metrics.jsonl
    run = os.path.join(str(tmp_path), 'test', 'parity-seed0')
    jcfg = H.j_load_config('test')
    state, _ = H.j_init_train_state(jcfg, *H.j_build_models(jcfg)[1:], 0)
    save_checkpoint(run, state, 5)
    with open(os.path.join(run, 'metrics.jsonl'), 'w') as f:
        f.write(json.dumps({'step': 10, 'emd': 21.5, 'g_loss': -0.6}) + '\n')
    real = j_quality.quality_report

    def seeded(cfg, *args, seed=0, **kw):
        random.seed(seed)       # as the port's run_seed seeds it
        return real(cfg, *args, seed=seed, **kw)
    monkeypatch.setattr(j_quality, 'quality_report', seeded)
    want = j_vp.run_seed('test', 0, 2, 32, skip_trained=True,
                         model_root=str(tmp_path))
    got = t_vp.run_seed('test', 0, 2, 32, skip_trained=True,
                        model_root=str(tmp_path), device='cpu')
    _record_close(got, want)
    assert got['iters'] == 0 and got['final_emd'] == 21.5

    # a 2-iteration training: the JAX record's keys, finite values, and
    # its final state checkpointed, which --skip-trained scores alike
    trained = t_vp.run_seed('test', 1, 2, 32, model_root=str(tmp_path),
                            device='cpu')
    assert sorted(trained) == sorted(want)
    assert sorted(trained['quality']) == sorted(want['quality'])
    assert sorted(trained['trajectories']) == sorted(want['trajectories'])
    assert trained['iters'] == 3
    values = [trained['final_emd'], trained['final_g_loss']] + [
        x for v in trained['quality'].values()
        for x in np.atleast_1d(v)]
    assert np.isfinite(values).all()
    assert 'model.ckpt-3.msgpack' in os.listdir(
        os.path.join(str(tmp_path), 'test', 'parity-seed1'))
    again = t_vp.run_seed('test', 1, 2, 32, skip_trained=True,
                          model_root=str(tmp_path), device='cpu')
    _record_close(dict(again, train_minutes=trained['train_minutes']),
                  trained)


ABLATIONS = [
    [],
    ['--drop-filters', 'C'],
    ['--drop-filters', 'C', 'Ct', 'BW', '--cast', '0.2'],
    ['--color-curve-range', '0.99', '1.01'],
    ['--inject', '0.15'],
    ['--inject', '0.1', '--inject-mode', 'anti', '--drop-filters', 'W'],
]
INJECT_DEFAULTS = {'replay_inject_prob': 0.0, 'replay_inject_until': 1.0,
                   'replay_inject_mode': 'uniform'}


class _Built(Exception):
    pass


def _jax_ablation_config(monkeypatch, flags):
    """The config the JAX ``main`` builds from ``flags``: its ``Trainer``
    stubbed to capture it and stop."""
    import exposure_tpu.core.trainer as j_trainer
    seen = {}

    def stub(cfg, *args, **kw):
        seen['cfg'] = cfg
        raise _Built()
    monkeypatch.setattr(j_trainer, 'Trainer', stub)
    monkeypatch.setattr(sys, 'argv', ['ablate_w_usage'] + flags)
    with pytest.raises(_Built):
        j_aw.main()
    return seen['cfg']


@pytest.mark.parametrize('flags', ABLATIONS,
                         ids=lambda f: ' '.join(f) or 'defaults')
def test_ablation_config_equals_jax(flags, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    jcfg = _jax_ablation_config(monkeypatch, flags + ['--iters', '7'])
    tcfg = t_aw.build_config(t_aw.parser().parse_args(
        flags + ['--iters', '7']))
    assert list(tcfg.filters) == [f.__name__ for f in jcfg.filters]
    for key in ('name', 'num_state_dim', 'max_iter_step',
                'write_image_interval'):
        assert tcfg[key] == jcfg[key], key
    assert tuple(tcfg.color_curve_range) == tuple(jcfg.color_curve_range)
    for key, default in INJECT_DEFAULTS.items():
        assert tcfg[key] == jcfg.get(key, default), key
    assert os.listdir(tmp_path) == []


def test_ablation_cast_providers_equal_jax(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    flags = ['--n', '8', '--cast', '0.3']
    jcfg = _jax_ablation_config(monkeypatch, flags)
    tcfg = t_aw.build_config(t_aw.parser().parse_args(flags))
    for make in ('fake_data_provider', 'fake_data_provider_test'):
        random.seed(1)
        want = jcfg[make]()
        random.seed(1)
        got = tcfg[make]()
        np.testing.assert_array_equal(got.data, want.data)
        assert (got.augmentation, got.output_size) == \
            (want.augmentation, tuple(want.output_size))
        # the batches: the same crops; the test provider's 80 -> 64 resize
        # is numpy's bilinear against the JAX provider's cv2.resize
        # (within 1e-5, tests/test_torch_eval_tools.py)
        random.seed(2)
        j_batch = want.get_next_batch(8)[0]
        random.seed(2)
        np.testing.assert_allclose(got.get_next_batch(8)[0], j_batch,
                                   rtol=0, atol=1e-5)


def test_ablation_runs_at_test_widths(tmp_path, monkeypatch):
    import exposure_tpu_torch.utils.config as tconf
    real = tconf.load_config
    src = open(os.path.join(REPO, 'exposure_tpu', 'tools',
                            'ablate_w_usage.py')).read()
    block = src[src.index('report = {'):src.index('print(json.dumps')]
    want_keys = set(re.findall(r"'(\w+)':", block)) | \
        {'argmax', 'sampling', 'gray_shift_ablation'}
    # 'synthetic' at the test widths (the providers are the tool's own)
    monkeypatch.setattr(tconf, 'load_config',
                        lambda name: real('test' if name == 'synthetic'
                                          else name))
    flags = ['--iters', '2', '--n', '8', '--drop-filters', 'C',
             '--model-root', str(tmp_path), '--device', 'cpu']
    rep = t_aw.main(flags)
    assert set(rep) == want_keys
    assert rep['iters'] == 3 and rep['dropped_filters'] == ['C']
    usage = rep['argmax']['filter_usage_frac']
    assert 'C' not in usage and len(usage) == 7
    for cast in rep['gray_shift_ablation'].values():
        assert all(0.0 <= v <= 1.0 for v in cast.values())
    assert os.path.isdir(os.path.join(str(tmp_path), 'synthetic',
                                      'cast-ablation-noC'))
    again = t_aw.main(flags + ['--skip-trained'])
    assert again['iters'] == rep['iters']
    assert again['argmax'] == rep['argmax']
