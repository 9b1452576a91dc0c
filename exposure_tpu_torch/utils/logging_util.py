"""Observability helpers: stdout tee + scalar metric logging (a copy of
``exposure_tpu/utils/logging_util.py``, which has no JAX in it but cannot
be imported without importing the JAX package).

The reference duplicates stdout/stderr into the run dir and smooths
console stats with a median window; the scalar writer emits JSONL."""

import json
import os
import sys
import time


class Tee:
    """Duplicate stdout+stderr into a log file (reference util.py:246-268)."""

    def __init__(self, name, mode='a'):
        self.file = open(name, mode)
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def close(self):
        sys.stdout = self.stdout
        sys.stderr = self.stderr
        self.file.close()

    def write(self, data):
        self.file.write(data)
        self.stdout.write(data)
        self.file.flush()
        self.stdout.flush()

    def flush(self):
        self.file.flush()


class MetricLogger:
    """Append-only JSONL scalar logger with wall-clock stamps."""

    def __init__(self, path):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        self.path = path
        self._f = open(path, 'a')
        self._t0 = time.time()

    def log(self, step, **scalars):
        rec = {'step': int(step), 't': round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + '\n')
        self._f.flush()

    def close(self):
        self._f.close()


class MedianWindow:
    """Sliding median smoother (reference cfg.median_filter_size,
    net.py:376-378)."""

    def __init__(self, size=101):
        self.size = size
        self.values = []

    def add(self, v):
        self.values.append(float(v))
        self.values = self.values[-self.size:]

    def median(self):
        if not self.values:
            return float('nan')
        s = sorted(self.values)
        return s[len(s) // 2]
