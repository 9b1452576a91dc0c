"""What every cell shares: where the checkout and its caches are, the files
found by name, the card's checks, and the run's result line.

Nothing here imports torch at module level: ``run.py`` sets the cache
directories first, and the CPU tests import this module freely."""

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]     # benchmark/
ROOT = BENCH.parent                             # the checkout
CACHE = BENCH / '.cache'                        # fixed, inside the checkout

# Top-level module names no run may hold once its window has closed:
# JAX, its libraries, and the JAX package the port was made from.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'exposure_tpu')


# (step, host clock) of run.py's steps before the driver's set-up
MARKS = []


def mark(step):
    MARKS.append((step, time.perf_counter()))


class BenchError(RuntimeError):
    """A run that cannot give a result: printed, exit code 2."""


def set_environment(environ=None):
    """Point every build and kernel cache into the checkout, at fixed
    paths, keep JAX out of libraries that would load it, and put the
    checkout on ``sys.path`` so the program imports from it."""
    env = os.environ if environ is None else environ
    env['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
    env['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
    env['USE_FLAX'] = '0'
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def load_json(kind, name):
    """``benchmark/<kind>/<name>.json``: a workload, traffic mix or
    configuration, found by its name."""
    if not name or '/' in name or name.startswith('.'):
        raise BenchError('bad %s name %r' % (kind, name))
    path = BENCH / kind / ('%s.json' % name)
    if not path.is_file():
        raise BenchError('no %s named %r (%s)' % (kind, name, path))
    with open(path) as f:
        return json.load(f)


def bench_spec():
    """``BENCHMARK.json`` at the checkout's root."""
    path = ROOT / 'BENCHMARK.json'
    if not path.is_file():
        raise BenchError('no BENCHMARK.json at %s' % ROOT)
    with open(path) as f:
        return json.load(f)


def cell_metrics(spec, cell, trace):
    """The names of the metrics ``cell`` reports: its ``end_to_end`` ones
    with ``trace`` 0, its ``per_layer`` ones with ``trace`` 1.  A metric
    with a ``workloads`` key names its cells; a per-layer one without it
    goes with every cell that reports the end-to-end metric it moves."""
    e2e = [m['name'] for m in spec['end_to_end']
           if cell in m.get('workloads', [cell])]
    if not trace:
        return e2e
    return [m['name'] for m in spec['per_layer']
            if cell in m.get('workloads', [cell] if m['moves'] in e2e
                             else [])]


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name, taken whole, is one of
    ``FORBIDDEN`` (``exposure_tpu_torch`` is not ``exposure_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in list(modules)
                  if n.split('.', 1)[0] in FORBIDDEN)


def require_cards(chips):
    """Raise unless torch sees at least ``chips`` CUDA devices."""
    import torch
    mark('torch')
    if not torch.cuda.is_available():
        raise BenchError('no CUDA device: the benchmark runs on the card '
                         'only')
    if torch.cuda.device_count() < chips:
        raise BenchError('the cell needs %d CUDA devices, %d found'
                         % (chips, torch.cuda.device_count()))


def power_limit():
    """The cards' names and power limits as ``nvidia-smi`` reads them, or
    a note that it could not."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return 'nvidia-smi unavailable (%s)' % e
    return out.stdout.strip().replace('\n', '; ') or out.stderr.strip()


def device_record(chips, memory_peak_bytes, busy_s=None, window_s=None):
    """The result's ``device`` object."""
    import torch
    rec = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
           'count': int(chips), 'memory_peak_bytes': int(memory_peak_bytes)}
    if busy_s is not None:
        rec['busy_s'] = float(busy_s)
        rec['window_s'] = float(window_s)
    return rec


def percentile(values, q):
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError('no values')
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


class Check:
    """The numbers that decide ``correct``, each beside its limit: a number
    passes at or below its limit.  ``failed`` counts the answers judged
    wrong; ``attempted`` those judged."""

    def __init__(self):
        self.items = []     # (name, value, limit)
        self.attempted = 0
        self.failed = 0
        self.notes = []

    def add(self, name, value, limit):
        self.items.append((name, float(value), float(limit)))

    @property
    def correct(self):
        return bool(self.items) and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.items)

    def record(self):
        return {name: {'value': value, 'limit': limit}
                for name, value, limit in self.items}

    def lines(self):
        return ['check %s %.6g limit %.6g %s'
                % (name, value, limit, 'ok' if value <= limit else 'FAILED')
                for name, value, limit in self.items]


def result_line(check, metrics, device, breakdown=None):
    """The last line of standard output: the keys the driver reads, with
    the compared numbers under ``check``, last."""
    line = {'correct': check.correct, 'attempted': int(check.attempted),
            'failed': int(check.failed), 'metrics': metrics,
            'device': device}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['check'] = check.record()
    return line
