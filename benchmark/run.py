#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control]

The cell is ``benchmark/workloads/<cell>.json``: its configuration
(``configs/<config>.json``), traffic (``traffic/<traffic>.json``), driver
(``drivers/<driver>.py``), chips and limits.  With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics in ``BENCHMARK.json``;
with ``--trace 1`` its per-layer metrics, each read by
``metrics/<metric>.py`` from a profiled stretch after the window.  Every
run ends by holding a sample of what the window produced to the plain
reference (``reference/``); the numbers compared, each beside its limit,
are the last lines on standard error and the ``check`` key of the result.

``--control`` puts the lower-precision control in the program's place (the
bf16 plan for serving, the reference with TF32 on for training), and
``--fault`` a planted fault (a state returned unchanged, half the batch
left out, an answer altered); both run on one card (the reference alone,
for the training cells): the readings that set the upper end of each
limit.  The benchmark's own runs never pass either.

Exit codes: 0 with a result line; 2 when the run cannot give one (no card,
too few cards, a file or the program missing, JAX loaded), printing no
result."""

import time

STARTED = time.perf_counter()

import argparse   # noqa: E402
import importlib   # noqa: E402
import importlib.util   # noqa: E402
import json   # noqa: E402
import sys   # noqa: E402
from pathlib import Path   # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lib import common   # noqa: E402


def load_cell(name):
    """The cell's workload file with its configuration and traffic."""
    spec = common.load_json('workloads', name)
    spec['name'] = name
    spec['config'] = common.load_json('configs', spec['config'])
    spec['traffic'] = common.load_json('traffic', spec['traffic'])
    return spec


def load_module(kind, name):
    """``benchmark/<kind>/<name>.py`` as a module (metric names hold
    dots, so they are loaded by path)."""
    path = common.BENCH / kind / ('%s.py' % name)
    if not path.is_file():
        raise common.BenchError('no %s reader %r (%s)' % (kind, name, path))
    spec = importlib.util.spec_from_file_location(
        'benchmark_%s_%s' % (kind, name.replace('.', '_')), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_driver(name):
    """``benchmark/drivers/<name>.py``, imported by its module name (a
    driver's functions may go to spawned processes, which import them)."""
    if not (common.BENCH / 'drivers' / ('%s.py' % name)).is_file():
        raise common.BenchError('no driver %r' % name)
    return importlib.import_module('benchmark.drivers.' + name)


def per_layer(names, ctx):
    """``{name: value}`` of each reader that found something to read."""
    out = {}
    for name in names:
        value = load_module('metrics', name).read(ctx)
        if value is not None:
            out[name] = float(value)
    return out


def main(argv=None, device='cuda', spec=None):
    """Run the cell; ``device`` and ``spec`` (a cell already loaded, with
    its sizes) are for the CPU tests."""
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--fault', choices=('unchanged', 'half_batch',
                                        'altered'))
    args = ap.parse_args(argv)
    del common.MARKS[:]
    common.mark('imports')
    common.set_environment()
    bench = common.bench_spec()
    spec = spec or load_cell(args.workload)
    if importlib.util.find_spec('exposure_tpu_torch') is None:
        raise common.BenchError('the program (exposure_tpu_torch) is not in '
                                'this checkout')
    if device == 'cuda':
        # the control and the faults run the reference alone, on one card
        common.require_cards(1 if args.control or args.fault
                             else spec['chips'])
        common.mark('cards')
        print('# %s' % common.power_limit(), file=sys.stderr)
        common.mark('nvidia-smi')
    driver = load_driver(spec['driver'])
    common.mark('driver')
    check, e2e, ctx, dev, traced = driver.run(
        spec, args.seed, args.seconds, args.trace, STARTED, device=device,
        chips=spec['chips'], control=args.control, fault=args.fault)
    names = common.cell_metrics(bench, args.workload, args.trace)
    units = {m['name']: m['unit']
             for m in bench['end_to_end'] + bench['per_layer']}
    if args.trace:
        values = per_layer(names, ctx)
    else:
        values = {n: e2e[n] for n in names if n in e2e}
    metrics = {n: {'value': v, 'unit': units[n]} for n, v in values.items()}
    loaded = common.forbidden_modules()
    if loaded:
        raise common.BenchError('the run loaded %s' % ', '.join(loaded))
    if device == 'cuda':
        record = common.device_record(
            spec['chips'], dev['memory_peak_bytes'],
            traced.busy_s if traced else None,
            traced.window_s if traced else None)
    else:
        record = {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                  'memory_peak_bytes': 0}
    line = common.result_line(check, metrics, record,
                              traced.breakdown() if traced else None)
    for note in check.notes:
        print('# ' + note, file=sys.stderr)
    for text in check.lines():
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    try:
        main()
    except common.BenchError as e:
        print('benchmark: %s' % e, file=sys.stderr)
        sys.exit(2)
