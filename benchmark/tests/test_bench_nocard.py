"""Without a card the command exits non-zero and prints no result; so does
a directory that holds the benchmark alone, without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.lib.common import BENCH, ROOT


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload',
         'explore-dyn-512px-b512', '--seed', '3000000001', '--seconds', '1',
         '--trace', '0'], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError('a result was printed: %s' % line)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    out = _run(ROOT)
    assert out.returncode != 0
    assert 'no CUDA device' in out.stderr
    _no_result(out)


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('.cache', '.scratch',
                                                  '__pycache__'))
    env = dict(os.environ, PYTHONPATH='')
    out = _run(tmp_path, env)
    assert out.returncode != 0
    assert 'not in this checkout' in out.stderr
    _no_result(out)
