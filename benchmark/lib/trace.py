"""A traced stretch of a run under ``torch.profiler``: the device's
activities (kernels, copies, fills) as named intervals, the harness's own
host ranges (``bench.*``, opened with ``span``), and what the per-layer
readers and the result's ``breakdown`` take from them.

Times are seconds on the profiler's clock, device and host alike."""

import contextlib

from benchmark.lib.window import busy_seconds, idle_gaps

HOST_PREFIX = 'bench.'


@contextlib.contextmanager
def span(name):
    """A host range the trace keeps (``bench.<name>``)."""
    import torch
    with torch.profiler.record_function(HOST_PREFIX + name):
        yield


class Trace:
    """``device``: ``[(name, start, end)]`` sorted by start; ``host``: the
    ``bench.*`` ranges, ``[(name, start, end)]``; ``units``: the batches or
    iterations the traced stretch ran."""

    def __init__(self, device, host, units):
        self.device = sorted(device, key=lambda x: (x[1], x[2]))
        self.host = sorted(host, key=lambda x: (x[1], x[2]))
        self.units = units

    @property
    def start(self):
        return self.device[0][1]

    @property
    def end(self):
        return max(e for _, _, e in self.device)

    @property
    def window_s(self):
        return self.end - self.start

    @property
    def busy_s(self):
        return busy_seconds([(s, e) for _, s, e in self.device])

    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s

    def host_at(self, t):
        """The innermost ``bench.*`` range open at ``t``, or ``other``."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and (best is None or s >= best[1]):
                best = (name, s, e)
        return best[0][len(HOST_PREFIX):] if best else 'other'

    def breakdown(self, top=10):
        """``{'device_ops': [[name, seconds]], 'idle_gaps': [[host range,
        seconds]]}``: the device operations that took most time in all,
        and the longest idle gaps, each named by the host range open when
        it began."""
        by_name = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = idle_gaps([(s, e) for _, s, e in self.device], self.start,
                         self.end)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {'device_ops': [[n[:160], float(t)] for n, t in ops],
                'idle_gaps': [[self.host_at(s), float(e - s)]
                              for s, e in gaps]}


def _is_device(event):
    import torch
    return event.device_type == torch.autograd.DeviceType.CUDA


def profile(fn, units):
    """Run ``fn()`` (which does ``units`` batches or iterations and ends
    with the device idle) under ``torch.profiler`` and return its
    ``Trace``."""
    import sys
    import time
    import torch
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    device, host = [], []
    for ev in prof.events():
        s = ev.time_range.start / 1e6
        e = ev.time_range.end / 1e6
        if _is_device(ev):
            # the profiler mirrors each host range onto the device's
            # timeline; only the device's own activities count
            if not ev.name.startswith(HOST_PREFIX):
                device.append((ev.name, s, e))
        elif ev.name.startswith(HOST_PREFIX):
            host.append((ev.name, s, e))
    if not device:
        from benchmark.lib.common import BenchError
        raise BenchError('the profiler saw no device activity')
    print('# trace: %d device activities; profiled %.1f s, read %.1f s'
          % (len(device), t1 - t0, time.perf_counter() - t1),
          file=sys.stderr)
    return Trace(device, host, units)
