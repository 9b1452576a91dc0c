"""The serving cell end to end on the CPU at a small size: correct as the
program stands; not correct with the timed path broken underneath, nor
with the program's lower-precision plan (the control) in its place."""

import json

import pytest

from benchmark.tests.helpers import run_cell, serve_spec


def test_serving_run_is_correct(capsys):
    line = run_cell(serve_spec())
    assert line['correct'], line['check']
    assert line['attempted'] == 6 and line['failed'] == 0
    assert set(line['metrics']) == {'serve_images_per_s',
                                    'serve_batch_p95_ms', 'setup_s'}
    assert list(line)[-1] == 'check'
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2].startswith('check out_over_1lsb')
    assert err[-1].startswith('check out_lsb_p9999')


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch', 'altered'])
def test_broken_serving_is_not_correct(fault):
    line = run_cell(serve_spec(), extra=['--fault', fault])
    assert not line['correct'], (fault, line['check'])
    assert line['failed'] > 0


def test_bf16_plan_control_is_not_correct():
    line = run_cell(serve_spec(), extra=['--control'])
    assert not line['correct'], line['check']


@pytest.mark.parametrize('control', [False, True])
def test_bf16_traffic_runs_through_the_pipeline(tmp_path, control):
    """A mix whose ``pipeline`` asks for the bf16 plan is a data file alone:
    it reaches ``RetouchPipeline`` (with ``--control`` too), and the f32
    reference reads its plan as it reads the control's."""
    spec = serve_spec()
    mix = dict(spec['traffic'],
               pipeline=dict(spec['traffic']['pipeline'], bf16=True))
    path = tmp_path / 'photos-bf16.json'
    path.write_text(json.dumps(mix))
    spec['traffic'] = json.loads(path.read_text())
    line = run_cell(spec, extra=['--control'] if control else [])
    assert set(line['metrics']) == {'serve_images_per_s',
                                    'serve_batch_p95_ms', 'setup_s'}
    assert not line['correct'], line['check']
