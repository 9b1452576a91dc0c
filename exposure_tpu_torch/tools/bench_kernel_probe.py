"""Kernel cost isolation probe (torch counterpart of
``exposure_tpu/tools/bench_kernel_probe.py``).

Separates the chain's cost into the u8 round trip, single-op math, the
switch kernel and the branchless chain, on identical inputs:

A. K4a, the switchless single-op kernel (``csrc/probes.cu``): copy with 0
   steps (the u8 round trip with no math: the memory floor), E with 1 and
   5 steps, G with 5;
B. K2 (``apply_filter_chain_switch``) with all-E ids at K=1 and K=5;
C. the branchless plain chain (``ops/chain.py::apply_filter_chain``) in
   f32, 5 steps, all E;
D. K2 on the same f32 input.

``--sass`` adds what the compiler made of the 0-step copy kernel, its
instructions by opcode (``cuobjdump -sass`` of the built library): one
``LDG.E.128`` and one ``STG.E.128`` a thread, and the u8 conversions on the
f32 pipe (``PRMT``, ``FADD``, ``FMUL``; a conversion instruction would read
``I2F`` or ``F2I``).

Usage: python -m exposure_tpu_torch.tools.bench_kernel_probe [--batch 256]
       [--res 512] [--iters 20] [--sass]
"""

import argparse
import json
import os
import re
import subprocess

import numpy as np
import torch

from exposure_tpu_torch import kernels
from exposure_tpu_torch.ops.chain import apply_filter_chain
from exposure_tpu_torch.ops.filters import build_filters, max_filter_parameters
from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
from exposure_tpu_torch.tools import (
    dequantize,
    device_name,
    launch_probe,
    median_seconds,
    quantize,
    timing_name,
    tool_device,
)
from exposure_tpu_torch.utils.config import load_config

# K4a's op codes (csrc/probes.cu, enum MonoOp)
MONO_OPS = ('copy', 'E', 'G')


def serialized_time(fn, x, iters, *args):
    """Seconds per call of ``fn(x, *args)`` over about ``iters`` calls: the
    median of 3 event-timed runs of ``iters // 3`` calls back to back
    (``tools.median_seconds``), so that the host's work before a launch
    overlaps the call before it, as the JAX tool's slope between a short
    and a long run cancelled its fixed costs.  The calls run in order on
    one stream, so the JAX tool's chaining of each output into the next
    call is not needed; its name and signature are kept, so that the two
    packages' tools read alike."""
    return median_seconds(lambda: fn(x, *args), x.device, runs=3,
                          calls=max(1, iters // 3))


def _check(img, op):
    if op not in MONO_OPS:
        raise ValueError('op must be one of %s, got %r' % (MONO_OPS, op))
    if img.dim() != 4 or img.shape[-1] != 3 or img.dtype != torch.uint8:
        raise ValueError('img must be [B, H, W, 3] uint8, got %s %s'
                         % (tuple(img.shape), img.dtype))


def mono_chain_reference(img, steps, op):
    """Plain PyTorch version of K4a, on any device."""
    _check(img, op)
    x = dequantize(img)
    for _ in range(steps):
        if op == 'E':
            x = x * 1.5
        elif op == 'G':
            x = torch.pow(torch.clamp(x, min=0.001), 0.8)
    return quantize(x)


def mono_chain(img, steps, op):
    """``steps`` x ``op`` (copy, E: x 1.5, G: pow(max(x, 1e-3), 0.8)) on
    [B, H, W, 3] u8, returning u8.  The JAX tool transposes to planar for
    the TPU's layout; the op acts on each value alone, so the kernel runs
    on NHWC directly.  A CPU tensor runs the plain version; a CUDA tensor
    launches K4a or raises."""
    _check(img, op)
    if img.device.type == 'cpu':
        return mono_chain_reference(img, steps, op)
    return launch_probe('mono_probe', img, MONO_OPS.index(op), int(steps))


def make_input(batch, res):
    """The tool's seeded [batch, res, res, 3] u8 input."""
    rng = np.random.RandomState(0)
    return torch.from_numpy((rng.rand(batch, res, res, 3) * 200 + 20).astype(
        np.uint8))


# section A: (report key, steps, op)
SECTION_A = (('pallas_copy_0step', 0, 'copy'),
             ('pallas_E_1step', 1, 'E'),
             ('pallas_E_5step', 5, 'E'),
             ('pallas_G_5step', 5, 'G'))


# an instruction line of ``cuobjdump -sass``: /*0040*/  [@P0] OPCODE.MOD ...
_SASS_LINE = re.compile(
    r'/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_.]*)')
# what the mangled name of probe_kernel<Mono<kMonoCopy>> contains
COPY_KERNEL = ('probe_kernel', 'MonoILi0E')


def sass_opcodes(path, name_parts=COPY_KERNEL):
    """``{opcode: count}`` over the instructions of the functions of the
    library ``path`` whose mangled names contain every one of
    ``name_parts``, from ``cuobjdump -sass`` (the CUDA toolkit's, beside
    nvcc)."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), 'cuobjdump')
    text = subprocess.run([tool, '-sass', path], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if 'Function :' in line:
            inside = all(part in line for part in name_parts)
        elif inside:
            found = _SASS_LINE.search(line)
            if found:
                counts[found.group(1)] = counts.get(found.group(1), 0) + 1
    return counts


def report(batch=256, res=512, iters=20, device='cuda'):
    """The JAX tool's report, sections A-D, timed on ``device``."""
    b = batch
    filters = build_filters(load_config('example'))
    img8 = make_input(b, res).to(device)
    out = {'batch': b, 'res': res}

    # A. the switchless probe kernel
    for name, steps, op in SECTION_A:
        dt = serialized_time(mono_chain, img8, iters, steps, op)
        out[name + '_ms'] = dt * 1e3

    # B. the switch kernel, 1 and 5 steps, all-E ids
    max_p = max_filter_parameters(filters)
    for k in (1, 5):
        ids = torch.zeros((k, b), dtype=torch.int32, device=device)
        params = torch.zeros((k, b, max_p), device=device)
        params[:, :, 0] = 0.5
        dt = serialized_time(apply_filter_chain_switch, img8, iters, ids,
                             params, filters)
        out['switch_E_%dstep_ms' % k] = dt * 1e3

    # C. the branchless plain chain, f32 I/O, 5 steps all-E
    imgf = img8.to(torch.float32) / 255.0
    ids = torch.zeros((5, b), dtype=torch.int32, device=device)
    params = torch.zeros((5, b, max_p), device=device)
    params[:, :, 0] = 0.5
    dt = serialized_time(apply_filter_chain, imgf, iters, ids, params,
                         filters)
    out['jnp_chain_5step_f32_ms'] = dt * 1e3

    # D. the f32 switch kernel, apples to apples with C
    dt = serialized_time(apply_filter_chain_switch, imgf, iters, ids, params,
                         filters)
    out['switch_E_5step_f32_ms'] = dt * 1e3
    out['device'] = device_name(device)
    out['timing'] = timing_name(device)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch', type=int, default=256)
    parser.add_argument('--res', type=int, default=512)
    parser.add_argument('--iters', type=int, default=20)
    parser.add_argument('--sass', action='store_true')
    args = parser.parse_args()
    device = tool_device()
    out = report(args.batch, args.res, args.iters, device)
    if args.sass:
        out['copy_kernel_sass'] = sass_opcodes(kernels.probes_kernel().path)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
