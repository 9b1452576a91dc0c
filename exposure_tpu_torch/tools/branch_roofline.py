"""Per-branch operation counts against measured ms (torch counterpart of
``exposure_tpu/tools/branch_roofline.py``).

The count side: every planar branch of the ``example`` bank
(``ops/dyn_chain.py::planar_branches``, the math the chain kernels run, in
the exact or the fast set) runs once on one (8, 128) f32 tile a channel
under a ``TorchDispatchMode`` that counts the aten operations it dispatches
(``count_ops``).  As the JAX tool does, an operation whose tensor inputs are
all 0-d is skipped (a per-step scalar, which the kernels compute once a
block), and views, reshapes, dtype casts and constant fills (``ones_like``
and the like: a constant on the card) are free.  A clamp with both bounds
counts 2 (a max and a min, as JAX's clip traces), every other operation 1,
so that the count reads in the convention of ``ops/dyn_chain.py::
branch_ops`` (an FMA 2, a library transcendental 1).  Each branch's
traced count stands beside ``branch_ops``, the hand count that
``chain_cost`` and so every K1-K3 bound is built on; ``differences`` lists
the branches where the two disagree.

The measured side: each row of the per-filter table that the port's
``bench_filters`` times through K3 on the card (K-step chains of one
filter, [B, H, W] u8), converted from images a second to ms a batch.  The
achieved rate of a branch is

    rate = steps * ops_per_step * B * H * W / ms

set beside two references: the T branch's own rate, the calibration of the
JAX tool (max, mul and add only, the largest count), and the float32 rate
of the H100 that ``tools.bound_ms`` divides by.

Report keys, against the JAX tool's: ``vpu_slots_per_step`` ->
``ops_per_step`` (unweighted: the JAX tool weighted div, exp2, log2, pow
and cos by their TPU lowering lengths), ``achieved_Tslots_per_s`` ->
``achieved_Tops_per_s``, ``vs_issue_bound`` -> ``vs_calibration``,
``calibration.achieved_slots_per_sec`` -> ``achieved_ops_per_sec``; new:
``hand_ops_per_step`` (``branch_ops``), ``vs_peak``, ``peak``,
``differences``, ``device`` and ``timing`` (the table's).

By default the table is measured on the card (``bench_filters.per_filter``
at its defaults, the set that the counts are of).  ``--bench FILE`` reads a
report that the port's ``bench_filters`` wrote on a CUDA card instead (no
card needed then); any other file, the JAX package's TPU record
``FILTER_BENCH.json`` among them, is refused.  Nothing is written unless
``--out`` names a file.

Usage:
  python -m exposure_tpu_torch.tools.branch_roofline [--exact]
      [--bench BENCH_FILTERS_REPORT.json] [--out FILE]
"""

import argparse
import json
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from exposure_tpu_torch.ops.dyn_chain import branch_ops, planar_branches
from exposure_tpu_torch.ops.filters import build_filters, max_filter_parameters
from exposure_tpu_torch.tools import H100_F32_OPS_PER_S, tool_device
from exposure_tpu_torch.utils.config import load_config

# aten operations that cost nothing on a tile: views, reshapes, dtype casts
# and constant fills
FREE = frozenset(('view', '_unsafe_view', 'reshape', 'expand', 'squeeze',
                  'unsqueeze', '_to_copy', 'ones_like', 'zeros_like',
                  'full_like'))


class _OpCounter(TorchDispatchMode):

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.names = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        tensors = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        if name not in FREE and any(t.dim() > 0 for t in tensors):
            bounds = args[1:3] if name == 'clamp' else ()
            self.ops += max(1, sum(v is not None for v in bounds))
            self.names[name] = self.names.get(name, 0) + 1
        return func(*args, **kwargs)


def count_ops(fn, n_args=3):
    """``(ops, {aten name: calls})`` of ``fn(r, g, b)`` on (8, 128) f32
    planes."""
    tiles = [torch.full((8, 128), 0.5) for _ in range(n_args)]
    with _OpCounter() as counter:
        fn(*tiles)
    return counter.ops, counter.names


def branch_counts(fast):
    """``{short name: {'ops_per_step', 'hand_ops_per_step',
    'primitives'}}`` of the ``example`` bank's branches."""
    filters = build_filters(load_config('example'))
    steps = int(filters[0].cfg.curve_steps)
    max_p = max_filter_parameters(filters)
    # the per-step scalars, 0-d as the kernels' per-block plan values
    p = [torch.tensor(0.3 + 0.1 * j) for j in range(max_p)]
    gx = gy = torch.zeros((1, 1))
    counts = {}
    for f, branch in zip(filters, planar_branches(filters, fast_math=fast)):
        ops, names = count_ops(
            lambda r, g, b, branch=branch: branch(r, g, b, p, gx, gy))
        counts[f.get_short_name()] = {
            'ops_per_step': ops,
            'hand_ops_per_step': branch_ops(type(f).__name__, fast, steps),
            'primitives': names}
    return counts


def check_bench(bench, fast, source):
    """Raise ``ValueError`` naming why, unless ``bench`` is a per-filter
    table that the port's ``bench_filters`` measured on a CUDA card in the
    branch set ``fast``."""
    if 'device' not in bench:
        raise ValueError('%s names no device: a TPU record, not a report of '
                         'the port\'s bench_filters on a CUDA card' % source)
    if bench.get('metric') != 'per_filter_images_per_sec' or \
            'per_filter' not in bench:
        raise ValueError('%s is not a bench_filters report (no '
                         'per_filter_images_per_sec table)' % source)
    if bench.get('timing') != 'cuda_events_median' or \
            bench['device'] == 'cpu':
        raise ValueError('%s was not measured on a CUDA card (device %r, '
                         'timing %r)' % (source, bench['device'],
                                         bench.get('timing')))
    want = 'static_switchless' + ('_fast' if fast else '')
    if bench.get('kernel') != want:
        raise ValueError('%s times kernel %r; these counts are of %r (%s)'
                         % (source, bench.get('kernel'), want,
                            'pass --exact' if fast else 'drop --exact'))


def roofline(fast, bench):
    """The report: ``branch_counts(fast)`` with each branch's ms and rates
    from ``bench`` (a ``bench_filters`` report, ``check_bench``), or the
    counts alone when ``bench`` is None."""
    counts = branch_counts(fast)
    result = {
        'description': 'aten operations a pixel runs in one step of each '
                       'branch (traced on (8,128) f32 tiles; a clamp with '
                       'both bounds 2, every other operation 1; views, '
                       'casts and constant fills free) beside branch_ops, '
                       'the hand count behind the chain kernels\' bounds.',
        'fast_math': fast,
        'branches': counts,
        'differences': {
            name: {'traced': row['ops_per_step'],
                   'hand': row['hand_ops_per_step'],
                   'traced_minus_hand': row['ops_per_step'] -
                   row['hand_ops_per_step']}
            for name, row in counts.items()
            if row['ops_per_step'] != row['hand_ops_per_step']},
    }
    if bench is None:
        return result
    shape = bench['shape']
    steps = bench['steps']
    px = float(shape[0] * shape[1] * shape[2])
    ms = {name: shape[0] / img_s * 1e3
          for name, img_s in bench['per_filter'].items()}
    result.update(device=bench['device'], timing=bench['timing'],
                  shape=shape, steps=steps, kernel=bench['kernel'])
    result['peak'] = {'ops_per_sec': H100_F32_OPS_PER_S,
                      'source': 'tools.H100_F32_OPS_PER_S, the float32 '
                                'rate tools.bound_ms divides by'}
    calibration = None
    if 'T' in ms and 'T' in counts:
        calibration = (steps * counts['T']['ops_per_step'] * px /
                       (ms['T'] * 1e-3))
        result['calibration'] = {
            'branch': 'T',
            'achieved_ops_per_sec': round(calibration / 1e12, 4),
            'unit': 'T ops/s',
            'note': 'T = plain max/mul/add only, the largest count: its '
                    'achieved rate is the empirical issue bound',
        }
    for name, row in counts.items():
        if name not in ms:
            continue
        rate = steps * row['ops_per_step'] * px / (ms[name] * 1e-3)
        row['measured_ms_5step'] = round(ms[name], 4)
        row['achieved_Tops_per_s'] = round(rate / 1e12, 4)
        row['vs_peak'] = round(rate / H100_F32_OPS_PER_S, 4)
        if calibration:
            row['vs_calibration'] = round(rate / calibration, 3)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--exact', action='store_true',
                    help='count the exact (non-fast-math) branches')
    ap.add_argument('--bench', default=None,
                    help='a bench_filters report of the port, measured on '
                         'a CUDA card (default: measure it now)')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    fast = not args.exact
    if args.bench is None:
        from exposure_tpu_torch.tools.bench_filters import per_filter
        device = tool_device()
        bench = per_filter(fast=fast, device=device,
                           say=lambda s: print(s, file=sys.stderr))
    else:
        with open(args.bench) as f:
            bench = json.load(f)
        try:
            check_bench(bench, fast, args.bench)
        except ValueError as e:
            sys.exit('refused: %s' % e)
    result = roofline(fast, bench)
    print(json.dumps(result, indent=1))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
        print('# wrote %s' % args.out)


if __name__ == '__main__':
    main()
