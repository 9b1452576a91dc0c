"""Cells shrunk to sizes a CPU test run holds, run through ``run.main``
on the host (the kernels' plain versions), with the timed path broken
underneath where a test asks."""

import torch

from benchmark import run

SEED = 2 ** 31 + 4242      # larger than 32 signed bits hold


def serve_spec():
    spec = run.load_cell('explore-dyn-512px-b512')
    spec['traffic'].update(batch=4, height=96, width=128, distinct=2,
                           warm_batches=1, check_batches=2, check_images=3,
                           trace_batches=2)
    spec['traffic']['pipeline'] = {'dynamic': True, 'use_kernels': True}
    return spec


def train_spec():
    """The training cell on the ``test`` widths."""
    from exposure_tpu_torch.utils.config import load_config
    spec = run.load_cell('example-train-fused-b64')
    c = load_config('test')
    spec['config'] = dict(spec['config'], program_config='test', config={
        k: (list(v) if isinstance(v, tuple) else v)
        for k, v in c.items() if not callable(v) and k != 'name'})
    spec['traffic'].update(pack_n=64, chunk=2, trace_chunk=1,
                           phase_iters=2)
    return spec


def run_cell(spec, seconds=1.0, extra=(), seed=SEED):
    torch.set_num_threads(2)
    argv = ['--workload', spec['name'], '--seed', str(seed), '--seconds',
            str(seconds), '--trace', '0'] + list(extra)
    return run.main(argv, device='cpu', spec=spec)
