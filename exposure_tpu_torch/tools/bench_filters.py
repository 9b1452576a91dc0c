"""Per-filter cost table of the chain kernels (torch counterpart of
``exposure_tpu/tools/bench_filters.py``).

Times a K-step chain of each single filter of the ``example`` bank through
the static kernel K3 (``apply_filter_chain_static`` with signature
``(fid,) * K``, what the grouped serving path runs), each the median of
event-timed calls (``tools.median_seconds``).  This is the per-branch cost
table that a redesign of the chain kernels starts from.  On the card a
switch on a block-uniform id runs only the selected branch, so the switch
kernel's step costs its own row here, not the sum of the rows as it did on
the TPU.

Usage: python -m exposure_tpu_torch.tools.bench_filters [--batch 256]
       [--res 512] [--steps 5] [--f32] [--fast] [--cpu]
"""

import argparse
import json

import numpy as np
import torch

from exposure_tpu_torch.ops.filters import build_filters, max_filter_parameters
from exposure_tpu_torch.ops.static_chain import apply_filter_chain_static
from exposure_tpu_torch.tools import (
    device_name,
    median_seconds,
    timing_name,
    tool_device,
)
from exposure_tpu_torch.utils.config import load_config


def slope_time(fn, *args, **kwargs):
    """Seconds per call of ``fn(*args, **kwargs)``: the median of
    event-timed calls (``tools.median_seconds``) on the first argument's
    device.  It keeps the JAX tool's name and signature, so that the two
    packages' tools read alike; it no longer takes a slope (see
    ``tools``)."""
    return median_seconds(lambda: fn(*args, **kwargs), args[0].device)


def per_filter(batch=256, res=512, steps=5, f32=False, fast=False,
               device='cuda', say=print):
    """The JAX tool's JSON report: images/s of each filter's K-step chain
    and the sum of the rows' ms."""
    filters = build_filters(load_config('example'))
    max_p = max_filter_parameters(filters)
    rng = np.random.RandomState(0)

    b, k = batch, steps
    imgf = rng.rand(b, res, res, 3).astype(np.float32) * 0.9
    img = torch.from_numpy(imgf if f32 else
                           (imgf * 255).round().astype(np.uint8)).to(device)

    results = {}
    total_ms = 0.0
    for fid, f in enumerate(filters):
        n = f.get_num_filter_parameters()
        raw = rng.randn(b, n).astype(np.float32) * 0.3
        reg = f.filter_param_regressor(torch.from_numpy(raw)).numpy()
        params = np.zeros((k, b, max_p), np.float32)
        params[:, :, :n] = reg.reshape(1, b, n)
        params = torch.from_numpy(params).to(device)
        dt = slope_time(apply_filter_chain_static, img, (fid,) * k, params,
                        filters, fast_math=fast)
        results[f.get_short_name()] = b / dt
        total_ms += dt * 1e3
        say('  %-3s %12.1f img/s  (%.4f ms/batch, %d steps)'
            % (f.get_short_name(), b / dt, dt * 1e3, k))
    return {
        'metric': 'per_filter_images_per_sec',
        'shape': [b, res, res],
        'steps': k,
        'dtype': 'f32' if f32 else 'u8',
        'kernel': 'static_switchless' + ('_fast' if fast else ''),
        'timing': timing_name(device),
        'device': device_name(device),
        'per_filter': results,
        'sum_all_branches_ms': total_ms,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch', type=int, default=256)
    parser.add_argument('--res', type=int, default=512)
    parser.add_argument('--steps', type=int, default=5)
    parser.add_argument('--f32', action='store_true')
    parser.add_argument('--cpu', action='store_true',
                        help='the plain versions on the CPU')
    parser.add_argument('--fast', action='store_true',
                        help='the serving-default fast branch set '
                             '(poly-cos + relu curves)')
    args = parser.parse_args()
    device = tool_device(args.cpu)
    print(json.dumps(per_filter(args.batch, args.res, args.steps, args.f32,
                                args.fast, device)))


if __name__ == '__main__':
    main()
