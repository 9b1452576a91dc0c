"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``cuda`` marker of the tests that need a card,
which skip without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA device (skips without one)')
