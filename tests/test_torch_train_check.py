"""``tools/train_check.py`` on the CPU, on the ``test`` config: the CPU
held against itself passes with every reading 0, and a second run whose
updates are planted wrong fails.  Both plants stay within the 3-lr bound
on the parameters, which Adam's first step cannot exceed: the moments
against the CPU's and Adam replayed on the gradients taken catch them."""

import pytest

from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu_torch.core import steps
from exposure_tpu_torch.tools.train_check import card_against_cpu
from exposure_tpu_torch.utils.config import load_config

pytestmark = pytest.mark.usefixtures('few_threads')

UPDATES = 3     # giters 1 (the generator's and the value net's) + citers 1


def test_the_cpu_against_itself_passes():
    report = card_against_cpu(load_config('test'), 'cpu')
    assert report['failures'] == []
    readings = [report[k][n] for k in ('grad_frac', 'moment_frac', 'replay',
                                       'param_lrs') for n in report[k]]
    assert len(readings) == 3 + 6 + (6 + 3) + 3
    assert max(readings) == 0.0
    assert report['ids']['differing'] == 0
    assert report['pool']['states_equal']


PLANTS = {
    # the update taken, the parameters left as they were
    'skipped': lambda grads, opt, params, lr, b1, b2, bc, update: (
        params, update(grads, opt, params, lr, b1, b2, bc=bc)[1]),
    # the gradient doubled on its way into Adam
    'doubled': lambda grads, opt, params, lr, b1, b2, bc, update: update(
        {k: 2 * g for k, g in grads.items()}, opt, params, lr, b1, b2,
        bc=bc),
}


@pytest.mark.parametrize('plant', sorted(PLANTS))
def test_a_wrong_update_fails(plant, monkeypatch):
    update, calls = steps.apply_lr_update, []

    def planted(grads, opt, params, lr, b1, b2, bc=None):
        calls.append(lr)
        if len(calls) <= UPDATES:       # the first run is the reference
            return update(grads, opt, params, lr, b1, b2, bc=bc)
        return PLANTS[plant](grads, opt, params, lr, b1, b2, bc, update)

    monkeypatch.setattr(steps, 'apply_lr_update', planted)
    report = card_against_cpu(load_config('test'), 'cpu')
    assert len(calls) == 2 * UPDATES
    assert max(report['param_lrs'].values()) <= 3.0
    assert any('off Adam replayed' in f for f in report['failures'])
    if plant == 'doubled':
        assert any(f.startswith('opt_c mu') for f in report['failures'])


@pytest.mark.parametrize('stream', ['float32', 'uint8'])
def test_the_streaming_step_against_itself_passes(stream):
    report = card_against_cpu(load_config('test'), 'cpu', stream=stream)
    assert report['failures'] == []
    assert max(report['grad_frac'].values()) == 0.0
    assert report['pool']['states_equal']


def test_a_wrong_streaming_update_fails(monkeypatch):
    update, calls = steps.apply_lr_update, []

    def planted(grads, opt, params, lr, b1, b2, bc=None):
        calls.append(lr)
        if len(calls) <= UPDATES:
            return update(grads, opt, params, lr, b1, b2, bc=bc)
        return PLANTS['skipped'](grads, opt, params, lr, b1, b2, bc, update)

    monkeypatch.setattr(steps, 'apply_lr_update', planted)
    report = card_against_cpu(load_config('test'), 'cpu', stream='uint8')
    assert len(calls) == 2 * UPDATES
    assert any('off Adam replayed' in f for f in report['failures'])
