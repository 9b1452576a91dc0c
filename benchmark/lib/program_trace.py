"""The program's own tracing read by the harness.

``exposure_tpu_torch/utils/trace.py`` (when the program has it) stamps
device regions, ``[(name, 'enter' | 'exit', ns)]`` in the order the stamps
ran, and opens host ranges ``exposure.<name>`` under ``torch.profiler``.
Here are the harness's own readings of them: the stamps folded into device
seconds a region (``fold``), and a traced stretch that keeps the program's
host ranges beside the harness's ``bench.*`` ones, leaves the profiler's
device copies of both out of the device's activities, and names each idle
gap of the device by the innermost range of either that is open when it
begins (``profile``).  Nothing here imports the program: the stamps come as
data.

The drivers do not turn the program's tracing on (``PERF.md`` §7 names the
edits they need).  Until they do,

    python3 -m benchmark.lib.program_trace --workload <cell> --seed <n>
        --seconds <s>

runs a cell's ``--trace 1`` path as ``run.py`` does, with the program's
tracing turned on before the program is built, its stamps emptied before
the traced stretch and read after it, and this module's ``profile`` in
place of ``lib/trace.py``'s.  It prints ``run.py``'s result line, then a
line ``{"program_trace": {...}}`` with ``READINGS``, the traced stretch's
ms a unit, the stamps read and dropped, and the idle gaps named.  It exits
2 on a program without ``utils/trace.py``."""

import json
import sys

from benchmark.lib import trace as harness
from benchmark.lib.window import busy_seconds

PROGRAM_PREFIX = 'exposure.'
HOST_PREFIXES = (harness.HOST_PREFIX, PROGRAM_PREFIX)

# metric name -> (device region or host range, its name): device ms or host
# ms a traced batch or iteration
READINGS = {
    'serve.resize_region_ms': ('region', 'serve.resize'),
    'serve.plan_region_ms': ('region', 'serve.plan'),
    'serve.replay_region_ms': ('region', 'serve.replay'),
    'serve.submit_host_ms': ('range', 'serve.call'),
    'train.generator_region_ms': ('region', 'train.generator'),
    'train.critic_region_ms': ('region', 'train.critic'),
    'train.adam_region_ms': ('region', 'train.adam'),
    'train.dispatch_host_ms': ('range', 'fused.run'),
}


def fold(stamps):
    """``{name: (seconds, regions)}`` of ``[(name, 'enter' | 'exit',
    ns)]`` in the order they ran.  Regions of one name may repeat and may
    nest inside others; one nested inside another of its own name counts
    once, as the outer one.  An exit with no enter open, and an enter never
    closed, count nothing."""
    open_at, out = {}, {}
    for name, kind, ns in stamps:
        depth, t0 = open_at.get(name, (0, None))
        if kind == 'enter':
            open_at[name] = (depth + 1, ns if depth == 0 else t0)
        elif depth:
            open_at[name] = (depth - 1, t0)
            if depth == 1:
                s, n = out.get(name, (0.0, 0))
                out[name] = (s + (ns - t0) / 1e9, n + 1)
    return out


def _is_device(event):
    import torch
    return event.device_type == torch.autograd.DeviceType.CUDA


def split_events(events):
    """``(device, host)`` intervals ``[(name, start s, end s)]`` of a
    profile's events: the device's own activities, without the ranges the
    profiler mirrors onto its timeline, and the host ranges of the harness
    and of the program."""
    device, host = [], []
    for ev in events:
        item = (ev.name, ev.time_range.start / 1e6, ev.time_range.end / 1e6)
        mirrored = ev.name.startswith(HOST_PREFIXES) or \
            getattr(ev, 'is_user_annotation', False)
        if _is_device(ev):
            if not mirrored:
                device.append(item)
        elif ev.name.startswith(HOST_PREFIXES):
            host.append(item)
    return device, host


class ProgramTrace(harness.Trace):
    """``lib/trace.py``'s ``Trace`` whose host ranges hold the program's
    ``exposure.*`` beside the harness's ``bench.*``."""

    def host_at(self, t):
        """The innermost range open at ``t``: a harness range by its name
        (``wait``), a program range by its full name
        (``exposure.fused.replay``); ``other`` where none is."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and (best is None or s >= best[1]):
                best = (name, s, e)
        if best is None:
            return 'other'
        if best[0].startswith(harness.HOST_PREFIX):
            return best[0][len(harness.HOST_PREFIX):]
        return best[0]

    def host_seconds(self, name):
        """The union of the program's host ranges ``exposure.<name>``."""
        return busy_seconds([(s, e) for n, s, e in self.host
                             if n == PROGRAM_PREFIX + name])


def profile(fn, units):
    """``lib/trace.py::profile`` with the program's ranges kept: run
    ``fn()`` (``units`` batches or iterations, ending with the device
    idle) under ``torch.profiler``; returns its ``ProgramTrace``."""
    import torch
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device, host = split_events(prof.events())
    if not device:
        from benchmark.lib.common import BenchError
        raise BenchError('the profiler saw no device activity')
    return ProgramTrace(device, host, units)


def readings(stamps, trace):
    """``READINGS`` that the stamps and the trace hold, ms a unit."""
    regions = fold(stamps)
    out = {}
    for metric, (kind, name) in READINGS.items():
        if kind == 'region' and name in regions:
            out[metric] = 1e3 * regions[name][0] / trace.units
        elif kind == 'range':
            s = trace.host_seconds(name)
            if s > 0:
                out[metric] = 1e3 * s / trace.units
    return out


def main(argv=None):
    import importlib.util
    from benchmark import run
    from benchmark.lib.common import BenchError
    if importlib.util.find_spec('exposure_tpu_torch') is None or \
            importlib.util.find_spec('exposure_tpu_torch.utils.trace') is None:
        raise BenchError('the program has no utils/trace.py')
    from exposure_tpu_torch.utils import trace as program
    from benchmark.drivers import serve, train
    box = {}

    def traced(fn, units):
        program.reset()
        box['trace'] = profile(fn, units)
        box['stamps'] = program.stamps()
        box['dropped'] = program.dropped()
        return box['trace']

    serve.profile = train.profile = traced
    program.enable()
    argv = list(sys.argv[1:] if argv is None else argv) + ['--trace', '1']
    line = run.main(argv)
    t = box['trace']
    out = dict(readings(box['stamps'], t))
    out.update(ms_per_unit=1e3 * t.window_s / t.units, units=t.units,
               stamps=len(box['stamps']), dropped=box['dropped'],
               idle_gaps=t.breakdown()['idle_gaps'])
    print(json.dumps({'program_trace': out}), flush=True)
    return line, out


if __name__ == '__main__':
    from benchmark.lib.common import BenchError
    try:
        main()
    except BenchError as e:
        print('benchmark: %s' % e, file=sys.stderr)
        sys.exit(2)
