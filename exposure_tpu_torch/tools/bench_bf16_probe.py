"""f32 against bf16 pixel math for single ops with scalar parameters, on
the card (torch counterpart of ``exposure_tpu/tools/bench_bf16_probe.py``).

K4c (``csrc/probes.cu``) runs ``steps`` x one op (``mul``, ``pow``, ``cos``
or ``curve``) on a [B, 1, H, W] u8 batch, with the scalar parameters
(0.8, 1.3) in one of three styles:

  f32        -- f32 pixel math;
  bf16_cast  -- bf16 pixels; each scalar parameter rounded to bf16 once,
                before the loop;
  bf16_splat -- bf16 pixels; each parameter rounded to bf16 where the
                vector op uses it.

In bf16 every add, subtract and multiply rounds its result and every
constant is rounded first (the semantics of a JAX bf16 computation with
weakly typed constants); u8 is dequantized in f32 and rounded to bf16.
On the TPU the two bf16 styles differed in whether Mosaic could compile
scalar bf16 arithmetic; on the card they are the same numbers, bit for bit.
The JAX probe caught a failed compile and reported ``ok: False``; here a
failed build or launch raises, so ``ok`` is always true in a record.

Usage: python -m exposure_tpu_torch.tools.bench_bf16_probe [--batch 64]
       [--res 512] [--steps 8]
"""

import argparse
import json

import numpy as np
import torch

from exposure_tpu_torch.ops import fastmath as fm
from exposure_tpu_torch.tools import (
    dequantize,
    device_name,
    launch_probe,
    median_seconds,
    quantize,
    tool_device,
)

# K4c's op and style codes (csrc/probes.cu, enums ScalarOp and Style)
OPS = ('mul', 'pow', 'cos', 'curve')
STYLES = ('f32', 'bf16_cast', 'bf16_splat')
PARAMS = (0.8, 1.3)


def _check(img, op, style):
    if op not in OPS or style not in STYLES:
        raise ValueError('op must be in %s and style in %s, got %r, %r'
                         % (OPS, STYLES, op, style))
    if img.dim() != 4 or img.shape[1] != 1 or img.dtype != torch.uint8:
        raise ValueError('img must be [B, 1, H, W] uint8, got %s %s'
                         % (tuple(img.shape), img.dtype))


def run_probe_reference(img, params, op, style, steps):
    """Plain PyTorch version of K4c, on any device."""
    _check(img, op, style)
    compute = torch.float32 if style == 'f32' else torch.bfloat16
    x = dequantize(img).to(compute)
    p0, p1 = torch.as_tensor(params, dtype=torch.float32,
                             device=img.device).unbind()

    def cast(s):
        if style == 'f32':
            return s
        if style == 'bf16_cast':
            return s.to(torch.bfloat16)
        return s.expand(x.shape).to(torch.bfloat16)

    for _ in range(steps):
        if op == 'pow':
            x = torch.pow(torch.clamp(x, min=fm.const(0.001, x)), cast(p0))
        elif op == 'cos':
            clum = fm.fast_half_cos_pi(torch.clamp(x, 0.0, 1.0))
            x = x + (clum - x) * cast(p0)
        elif op == 'curve':
            # the knots' sum and norm in f32, each cast where it is used
            knots = [p0, p1, p0, p1, p0, p1, p0, p1]
            norm = 8.0 / (sum(knots) + 1e-30)
            x = fm.curve_relu(x, [cast(k) for k in knots], cast(norm))
        else:
            x = x * cast(p0)
    return quantize(x)


def run_probe(img, params, op, style, steps):
    """``steps`` x ``op`` with the two scalar ``params`` in ``style`` on
    [B, 1, H, W] u8, returning u8.  A CPU tensor runs the plain version; a
    CUDA tensor launches K4c or raises."""
    _check(img, op, style)
    if img.device.type == 'cpu':
        return run_probe_reference(img, params, op, style, steps)
    p0, p1 = (float(v) for v in torch.as_tensor(params, dtype=torch.float32))
    return launch_probe('bf16_probe', img, OPS.index(op),
                        STYLES.index(style), int(steps), p0, p1)


# The packed bf16 operations of csrc/fastmath.cuh, in the order of
# csrc/probes.cu's enum PackedOp: max and min are the comparison-and-select
# forms the kernels run, hmax and hmin the native instructions.
PACKED_OPS = ('add', 'sub', 'mul', 'max', 'min', 'ge', 'le', 'gt', 'hmax',
              'hmin', 'abs', 'neg')
PACKED_COUNTS = ('differ', 'zero_sign', 'nan_payload')


def check_packed_ops(device='cuda'):
    """Hold each packed bf16 operation of ``csrc/fastmath.cuh`` to its
    scalar f32-then-round form on the card, over all 2^32 pairs of bf16 bit
    patterns (abs and neg over all 2^16 patterns).

    Returns ``{op: {'checked', 'differ', 'zero_sign', 'nan_payload'}}``:
    the results checked, those whose bits differ (a pair of NaNs aside),
    those among them where both forms give a zero (of opposite signs), and
    the excluded pairs of NaNs with different bits.  There is no plain
    version: the check is of the card's instructions."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError('the packed operations exist only on the card, '
                         'got device %s' % device)
    counts = torch.zeros(len(PACKED_OPS) * len(PACKED_COUNTS),
                         dtype=torch.int64, device=device)
    from exposure_tpu_torch import kernels
    kernels.launch(kernels.probes_kernel(), 'packed_bf16_check', device,
                   counts.data_ptr())
    table = counts.view(len(PACKED_OPS), len(PACKED_COUNTS)).tolist()
    return {op: dict(zip(PACKED_COUNTS, row),
                     checked=2 ** 16 if op in ('abs', 'neg') else 2 ** 32)
            for op, row in zip(PACKED_OPS, table)}


def make_input(batch, res):
    """The tool's seeded [batch, 1, res, res] u8 input."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randint(0, 255, (batch, 1, res, res),
                                        np.uint8))


def probe(op, style, batch, res, steps, device='cuda'):
    """The JAX record ``{'op', 'style', 'ok', 'ms'}`` of one op and style
    on a seeded [batch, 1, res, res] u8 input."""
    img = make_input(batch, res).to(device)
    ms = median_seconds(lambda: run_probe(img, PARAMS, op, style, steps),
                        device, calls=4) * 1e3
    return {'op': op, 'style': style, 'ok': True, 'ms': ms}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--res', type=int, default=512)
    ap.add_argument('--steps', type=int, default=8)
    args = ap.parse_args()
    device = tool_device()
    print('# bf16 probe: backend=cuda device=%s' % device_name(device))
    for op in OPS:
        for style in STYLES:
            print(json.dumps(probe(op, style, args.batch, args.res,
                                   args.steps, device)))


if __name__ == '__main__':
    main()
