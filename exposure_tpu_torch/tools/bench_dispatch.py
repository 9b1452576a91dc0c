"""Host cost of the launch primitives (torch counterpart of
``exposure_tpu/tools/bench_dispatch.py``).

Times, on the host clock, the median and the maximum of 20 calls (after 2
warm-up calls) of each primitive a serving or training loop pays per
batch or chunk.  Each JAX primitive maps to its PyTorch counterpart:

  eager_asarray_small_ms     ``jnp.asarray`` of 100 float32 ->
                             ``torch.as_tensor(small, device=...)`` and a
                             synchronize
  eager_float32_scalar_ms    ``jnp.float32(1.5)`` ->
                             ``torch.tensor(1.5, device=...)`` and a
                             synchronize
  eager_fold_in_ms           ``jax.random.fold_in`` -> the port's per-batch
                             reseed: the ``BatchGraph`` generator seeded
                             with ``core/serving.py::batch_seed`` (a
                             ``manual_seed`` on a device generator; no
                             device work)
  jit_dispatch_send_ms       a jitted no-op -> a one-kernel program
                             (``x + 1.0`` on 100 float32) captured as a CUDA
                             graph (``core/serving_graph.py::BatchGraph``,
                             as the port runs a compiled program) and
                             replayed, without a synchronize
  jit_dispatch_roundtrip_ms  the same replay, its output fetched by
                             ``.cpu()``
  jit_dispatch_np_args_ms    the numpy array copied into the graph's static
                             input, then the replay
  fetch_16mb_ms              ``big.cpu()`` of a 16 MB float32 tensor on the
                             device (8 calls)

Each value is ``[median, max]`` in ms.

Usage: python -m exposure_tpu_torch.tools.bench_dispatch
"""

import json
import time

import numpy as np
import torch

from exposure_tpu_torch.core.serving import batch_seed
from exposure_tpu_torch.core.serving_graph import BatchGraph
from exposure_tpu_torch.tools import device_name, tool_device


def timed(fn, n=20, warmup=2):
    """``(median, max)`` ms of ``fn()`` over ``n`` calls after ``warmup``,
    on the host clock."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1000)
    return round(float(np.median(ts)), 4), round(float(np.max(ts)), 3)


def report(device='cuda'):
    device = torch.device(device)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    out = {'device': device_name(device), 'timing': 'host_clock_median_max'}
    small = np.zeros((100,), np.float32)

    def asarray():
        torch.as_tensor(small, device=device)
        sync()

    def scalar():
        torch.tensor(1.5, device=device)
        sync()

    out['eager_asarray_small_ms'] = timed(asarray)
    out['eager_float32_scalar_ms'] = timed(scalar)

    noop = BatchGraph(lambda x, generator: x + 1.0,
                      torch.zeros((100,), dtype=torch.float32), device)
    noop.input.zero_()
    noop.run(noop.input, 0)      # the warm-up and capture
    sync()
    out['eager_fold_in_ms'] = timed(
        lambda: noop.generator.manual_seed(batch_seed(0, 7)))
    out['jit_dispatch_send_ms'] = timed(lambda: noop.run(noop.input, 0))
    out['jit_dispatch_roundtrip_ms'] = timed(
        lambda: noop.run(noop.input, 0).cpu())
    host = torch.from_numpy(small)
    out['jit_dispatch_np_args_ms'] = timed(lambda: noop.run(host, 0))
    noop.release()

    big = torch.zeros((4 * 1024 * 1024,), dtype=torch.float32,
                      device=device)   # 16 MB
    sync()
    out['fetch_16mb_ms'] = timed(lambda: big.cpu(), n=8)
    return out


def main():
    device = tool_device()
    print(json.dumps(report(device)))


if __name__ == '__main__':
    main()
