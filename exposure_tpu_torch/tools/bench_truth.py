"""Ground-truth serving measurement: dependency-serialized timing (torch
counterpart of ``exposure_tpu/tools/bench_truth.py``).

Every call's input is the previous call's output (a u8 chain: same shape
and dtype), so no call can start before the one before it has ended, and
the host clock from the first timed call to a synchronize after the last,
divided by the calls, is the time a call takes in that order
(``serialized_time``; the report's ``timing`` names that clock).  A null
program and a dependent copy on the same shapes separate the per-call
overhead and the memory rate from the filter math.

Reported lines:
  null_call_ms        per-call overhead: ``x + 1.0`` on an (8, 128) f32
                      tensor, chained
  memcpy_ms           ``x + 1`` on the [B, res, res, 3] u8 buffer, chained
  memcpy_gbps         2 x its bytes (read + write) over ``memcpy_ms``, in
                      units of 2^30 bytes a second: the JAX tool's formula
                      (GiB/s under a "gbps" name), kept so that the two
                      read alike
  chain_<mix>_ms      the switch kernel K2 (``ops/switch_chain.py::
  chain_<mix>_img_s   apply_filter_chain_switch``: f32 math, exact set, no
                      mask) on a K-step trajectory of the ``example`` bank
                      for a cheap mix (all E), a trained-like mix (E, G,
                      Ct, S+, T round robin) and the three heavy branches.

The mixes are block-uniform (every image of a step has the same id), so on
the card K2 runs one branch a step: ``heavy_all_G``, ``heavy_all_Sp`` and
``heavy_all_C`` are the per-branch times of the switch kernel, not the
sum of every branch as the TPU kernel's switch cost.  ``--cpu`` runs the
plain version (``apply_filter_chain_switch_reference``) on the host.

Usage: python -m exposure_tpu_torch.tools.bench_truth [--batch 256]
       [--res 512] [--steps 5] [--iters 20] [--cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

from exposure_tpu_torch.ops.filters import build_filters, max_filter_parameters
from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
from exposure_tpu_torch.tools import device_name, tool_device
from exposure_tpu_torch.utils.config import load_config

MIXES = {
    'cheap_all_E': ['E'],
    'trained_EGCtSpT': ['E', 'G', 'Ct', 'S+', 'T'],
    'heavy_all_G': ['G'],
    'heavy_all_Sp': ['S+'],
    'heavy_all_C': ['C'],
}


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def serialized_time(fn, x, iters, *args):
    """``(seconds per call, last output)`` of x_{i+1} = fn(x_i, *args):
    one warm-up call, then ``iters`` calls timed on the host clock from the
    first to a synchronize after the last."""
    x = fn(x, *args)
    _sync(x.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        x = fn(x, *args)
    _sync(x.device)
    return (time.perf_counter() - t0) / iters, x


def make_traj(filters, mix, k, b):
    """[K, B] int32 ids cycling through ``mix`` (short names) step by step
    and [K, B, P] float32 parameters regressed from ``RandomState(0)``
    draws, as the JAX tool makes them."""
    max_p = max_filter_parameters(filters)
    rng = np.random.RandomState(0)
    names = [f.get_short_name() for f in filters]
    ids = np.zeros((k, b), np.int32)
    for s in range(k):
        ids[s, :] = names.index(mix[s % len(mix)])
    params = np.zeros((k, b, max_p), np.float32)
    for s in range(k):
        f = filters[ids[s, 0]]
        n = f.get_num_filter_parameters()
        raw = rng.randn(b, n).astype(np.float32) * 0.3
        params[s, :, :n] = f.filter_param_regressor(
            torch.from_numpy(raw)).numpy()
    return torch.from_numpy(ids), torch.from_numpy(params)


def images(b, res):
    """The JAX tool's [B, res, res, 3] u8 input, from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(
        (rng.rand(b, res, res, 3) * 200 + 20).astype(np.uint8))


def report(batch=256, res=512, steps=5, iters=20, device='cuda',
           outputs=None):
    """The JAX tool's report.  ``outputs``, a dict, receives each line's
    last chained output by line name (``null``, ``memcpy`` or the mix)."""
    b, k = batch, steps
    filters = build_filters(load_config('example'))
    img = images(b, res).to(device)
    out = {'batch': b, 'res': res, 'steps': k,
           'device': device_name(device),
           'timing': 'host_clock_serialized_to_synchronize'}
    keep = outputs if outputs is not None else {}

    tiny = torch.zeros((8, 128), dtype=torch.float32, device=device)
    dt, keep['null'] = serialized_time(lambda x: x + 1.0, tiny, iters)
    out['null_call_ms'] = round(dt * 1e3, 4)

    dt, keep['memcpy'] = serialized_time(lambda x: x + 1, img, iters)
    nbytes = img.numel() * 2   # read + write
    out['memcpy_ms'] = round(dt * 1e3, 4)
    out['memcpy_gbps'] = round(nbytes / dt / (1 << 30), 2)

    for name, mix in MIXES.items():
        ids, params = make_traj(filters, mix, k, b)
        dt, keep[name] = serialized_time(
            apply_filter_chain_switch, img, iters, ids.to(device),
            params.to(device), filters)
        out['chain_%s_ms' % name] = round(dt * 1e3, 4)
        out['chain_%s_img_s' % name] = round(b / dt, 2)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch', type=int, default=256)
    parser.add_argument('--res', type=int, default=512)
    parser.add_argument('--steps', type=int, default=5)
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--cpu', action='store_true',
                        help='the plain version on the CPU')
    args = parser.parse_args()
    device = tool_device(args.cpu)
    print(json.dumps(report(args.batch, args.res, args.steps, args.iters,
                            device)))


if __name__ == '__main__':
    main()
