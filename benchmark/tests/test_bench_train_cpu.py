"""The training cell end to end on the CPU on the ``test`` widths: the
fused chunks' first iterations equal the frozen reference's; a state left
unchanged, half the batch left out, or an answer altered is not correct.
The TF32 control needs the card (TF32 exists only there)."""

import pytest
import torch

from benchmark.tests.helpers import run_cell, train_spec


def test_training_run_is_correct():
    line = run_cell(train_spec(), seconds=0.5)
    assert line['correct'], line['check']
    assert set(line['metrics']) == {'train_ms_per_iter', 'setup_s'}
    assert line['check']['loss_gap']['value'] <= 1e-6


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch', 'altered'])
def test_broken_training_is_not_correct(fault):
    line = run_cell(train_spec(), extra=['--fault', fault])
    assert not line['correct'], (fault, line['check'])


@pytest.mark.cuda
def test_tf32_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip('TF32 exists only on the card')
    from benchmark import run
    spec = run.load_cell('example-train-fused-b64')
    spec['traffic'].update(pack_n=256)
    line = run.main(['--workload', spec['name'], '--seed', '3000000007',
                     '--seconds', '1', '--trace', '0', '--control'],
                    spec=spec)
    assert not line['correct'], line['check']
