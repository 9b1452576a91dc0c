"""Cost of the library math against the polynomial and bit-trick math of
``ops/fastmath.py`` for the expensive per-pixel filter primitives (pow,
cos, divide, the 8-knot curve), on the card (torch counterpart of
``exposure_tpu/tools/bench_fastmath.py``).

Each op of ``OPS`` runs as K4b (``csrc/probes.cu``): 5 steps of the op on
every value of a [B, 3, 512, 512] u8 batch.  The kernel's ops call the
device functions the chain kernels run (``csrc/chain_branches.cuh``,
``csrc/fastmath.cuh``), and are built without ``--use_fast_math``: the
"builtin" rows are the CUDA library's ``powf``, ``cospif``, IEEE divide,
``exp2f(g * log2f(x))`` and ``expf(g * logf(x))``.  ``OPS`` below is the
plain PyTorch version of each op.

Usage: python -m exposure_tpu_torch.tools.bench_fastmath [--batch 256]
       [--res 512] [--only pow,cos]
"""

import argparse
import json
import math

import numpy as np
import torch

from exposure_tpu_torch.ops import fastmath as fm
from exposure_tpu_torch.tools import (
    dequantize,
    device_name,
    launch_probe,
    median_seconds,
    quantize,
    timing_name,
    tool_device,
)

STEPS = 5


def serialized_time(fn, x0):
    """Seconds per call of ``fn(x0)``: the median of event-timed runs of 4
    calls back to back (``tools.median_seconds``), under the JAX tool's name
    and signature, so that the two packages' tools read alike."""
    return median_seconds(lambda: fn(x0), x0.device, calls=4)


# ---- candidate per-channel ops (applied 5x to each value) ----------------

def op_copy(c):
    return c


def op_pow_builtin(c):
    return torch.pow(torch.clamp(c, min=0.001), 0.7)


def op_pow_fast(c):
    return fm.fast_pow(torch.clamp(c, min=0.001), 0.7)


def op_pow_exp2log2(c):
    # the same function as the builtin on positive inputs
    return torch.exp2(0.7 * torch.log2(torch.clamp(c, min=0.001)))


def op_pow_explog(c):
    return torch.exp(0.7 * torch.log(torch.clamp(c, min=0.001)))


def op_cos_builtin(c):
    return -torch.cos(math.pi * torch.clamp(c, 0.0, 1.0)) * 0.5 + 0.5


def op_cos_fast(c):
    return fm.fast_half_cos_pi(torch.clamp(c, 0.0, 1.0))


def op_div_builtin(c):
    return 0.5 / (c + 1e-6)


def op_div_fast(c):
    return 0.5 * fm.fast_rcp(c + 1e-6)


_T = [1.1, 0.9, 1.3, 0.7, 1.2, 0.8, 1.05, 0.95]


def op_curve_clip(c):
    total = c * 0
    for i in range(8):
        total = total + torch.clamp(c - i / 8.0, 0.0, 1.0 / 8.0) * _T[i]
    return total * (8.0 / sum(_T))


def op_curve_relu(c):
    return fm.curve_relu(c, _T, 8.0 / sum(_T))


# in K4b's op-code order (csrc/probes.cu, enum FastMathOp)
OPS = {
    'copy': op_copy,
    'pow_builtin': op_pow_builtin,
    'pow_fast': op_pow_fast,
    'pow_exp2log2': op_pow_exp2log2,
    'pow_explog': op_pow_explog,
    'cos_builtin': op_cos_builtin,
    'cos_fast': op_cos_fast,
    'div_builtin': op_div_builtin,
    'div_fast': op_div_fast,
    'curve_clip': op_curve_clip,
    'curve_relu': op_curve_relu,
}


def _check(img, op):
    if op not in OPS:
        raise ValueError('op must be one of %s, got %r' % (list(OPS), op))
    if img.dim() != 4 or img.shape[1] != 3 or img.dtype != torch.uint8:
        raise ValueError('img must be planar [B, 3, H, W] uint8, got %s %s'
                         % (tuple(img.shape), img.dtype))


def run_op_reference(img, op):
    """Plain PyTorch version of K4b, on any device."""
    _check(img, op)
    x = dequantize(img)
    for _ in range(STEPS):
        x = OPS[op](x)
    return quantize(x)


def run_op(img, op):
    """5 x the op named ``op`` on planar [B, 3, H, W] u8, returning u8.  A
    CPU tensor runs the plain version; a CUDA tensor launches K4b or
    raises."""
    _check(img, op)
    if img.device.type == 'cpu':
        return run_op_reference(img, op)
    out = launch_probe('fastmath_probe_launch', img, list(OPS).index(op),
                       STEPS)
    run_op.launches += 1
    return out


# Kernel launches by run_op (CPU calls do not count).
run_op.launches = 0


def accuracy(device):
    """The JAX tool's accuracy checks against float64 numpy, on the plain
    fastmath ops run on ``device``."""
    x = np.linspace(1e-3, 1.2, 4097, dtype=np.float32)
    xt = torch.from_numpy(x).to(device)
    x64 = x.astype(np.float64)

    def run(op):
        return OPS[op](xt).cpu().numpy()

    return {
        'pow_err': float(np.abs(run('pow_fast') -
                                np.maximum(x, 0.001).astype(np.float64) **
                                0.7).max()),
        'cos_err': float(np.abs(run('cos_fast') - (
            -np.cos(np.pi * np.clip(x, 0, 1)) * 0.5 + 0.5)).max()),
        'div_err': float(np.abs(run('div_fast') - 0.5 / (x64 + 1e-6)).max()),
        'curve_err': float(np.abs(run('curve_relu') -
                                  run('curve_clip')).max()),
    }


def make_input(batch, res):
    """The tool's seeded planar [batch, 3, res, res] u8 input."""
    rng = np.random.RandomState(0)
    return torch.from_numpy((rng.rand(batch, 3, res, res) * 200 + 20).astype(
        np.uint8))


def report(batch=256, res=512, only=None, device='cuda', say=print):
    """Per-op kernel ms (``<op>_ms``) and the accuracy checks."""
    img = make_input(batch, res).to(device)
    out = {}
    subs = only.split(',') if only else None
    for name in OPS:
        if subs and not any(s in name for s in subs):
            continue
        dt = serialized_time(lambda x, o=name: run_op(x, o), img)
        out[name + '_ms'] = dt * 1e3
        say('%-14s %9.4f ms/batch' % (name, dt * 1e3))
    out.update(accuracy(device))
    out['device'] = device_name(device)
    out['timing'] = timing_name(device)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch', type=int, default=256)
    parser.add_argument('--res', type=int, default=512)
    parser.add_argument('--only', default=None,
                        help='comma-separated op-name substrings to run')
    args = parser.parse_args()
    device = tool_device()
    print(json.dumps(report(args.batch, args.res, args.only, device)))


if __name__ == '__main__':
    main()
