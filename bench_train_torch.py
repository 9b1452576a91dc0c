#!/usr/bin/env python3
"""Training throughput of the PyTorch/CUDA port (the counterpart of
``bench_train.py``): the steady-state outer iteration of ``example`` at full
width (1 generator+value update and 5 critic WGAN-GP updates at batch 64,
the reference's cadence) with the packs and the replay pool on the card.

    python3 bench_train_torch.py [--iters 30] [--pack-n 2048] [--cpu]

The packs are procedural (``data/synthetic.py::make_synthetic_pack``): fake
``(pack_n, 80, 'raw', 0)``, real ``(pack_n, 64, 'retouched', 1)`` and the
pool from ``(replay_memory_size, 80, 'raw', 2)`` cropped to its central
64x64.  The step is ``core/steps.py::build_outer_step`` with the device
sampler, learning rates 1e-5 / 5e-5, progress ``i / 20000``.  Every draw
comes from one ``torch.Generator`` seeded 0 (``bench_train.py`` folds a JAX
key, a stream torch cannot reproduce).

Timing: ``compile_s`` is the first call on the host clock up to a
synchronize.  Nothing is compiled on the card, so it is the first call's
cuDNN and cuBLAS set-up and the kernels' first loads.  Then two warm-up
calls, and CUDA events around ``n_big - n_small`` chained calls (state and
pool feed the next call; ``n_small = max(iters // 6, 2)``, ``n_big =
iters``, at least one call), the least of two rounds.  ``--cpu`` runs on
the host clock, for the tests; without it the script needs a GPU.

One JSON line with ``bench_train.py``'s keys.  ``vs_baseline`` is 300 ms
over the iteration's ms: 300 ms is the reference implementation's outer
iteration on a GTX 1080 Ti (``BASELINE.md``).
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

LR_G, LR_C = 1e-5, 5e-5
BASELINE_MS = 300.0     # the reference's iteration, GTX 1080 Ti


def make_packs(cfg, pack_n):
    """``(fake, real, pool_images)`` numpy packs, as ``bench_train.py``
    makes them."""
    from exposure_tpu_torch.data.synthetic import make_synthetic_pack
    return (make_synthetic_pack(pack_n, 80, 'raw', 0),
            make_synthetic_pack(pack_n, 64, 'retouched', 1),
            make_synthetic_pack(cfg.replay_memory_size, 80, 'raw', 2)
            [:, 8:72, 8:72])


def main(argv=None, config='example'):
    """Run the benchmark on ``config`` (``example``; the tests pass a
    narrow one) and print its line; returns the line."""
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import build_outer_step
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.tools import device_name, median_seconds, \
        tool_device
    from exposure_tpu_torch.utils.config import load_config
    from exposure_tpu_torch.utils.draws import Draws
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iters', type=int, default=30)
    ap.add_argument('--pack-n', type=int, default=2048)
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args(argv)
    device = tool_device(args.cpu)
    print('# bench_train: %s' % device_name(device), file=sys.stderr)
    cfg = load_config(config)
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, 0, device=device)
    for net in (policy, critic, value):
        net.to(device)
    fake, real, pool_images = (
        torch.from_numpy(np.ascontiguousarray(x)).to(device)
        for x in make_packs(cfg, args.pack_n))
    pool = PoolState.create(pool_images, cfg.num_state_dim)
    step = build_outer_step(cfg, policy, critic, value, filters,
                            fake_meta=(64, True), real_meta=(64, True),
                            giters=cfg.giters, citers=cfg.citers)
    draws = Draws(torch.Generator(device=device).manual_seed(0), device)
    cuda = device.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    t_c = time.perf_counter()
    state, pool, metrics = step(state, pool, fake, real, draws, LR_G, LR_C,
                                0.0)
    sync()
    compile_s = time.perf_counter() - t_c

    i = 0

    def run(n):
        nonlocal state, pool, metrics, i
        for _ in range(n):
            state, pool, metrics = step(state, pool, fake, real, draws, LR_G,
                                        LR_C, i / 20000)
            i += 1

    run(2)
    n_small, n_big = max(args.iters // 6, 2), args.iters
    calls = max(n_big - n_small, 1)
    ms_per_iter = 1000 * min(median_seconds(lambda: run(calls), device,
                                            runs=1, warmup=0)
                             for _ in range(2)) / calls
    projected_min = ms_per_iter * 20001 / 1000 / 60
    state, pool, metrics = step(state, pool, fake, real, draws, LR_G, LR_C,
                                0.5)
    line = {
        'metric': 'train_outer_iter_ms',
        'value': round(ms_per_iter, 2),
        'unit': 'ms/iter (1 G+V step + %d critic steps, batch %d)' %
                (cfg.citers, cfg.batch_size),
        'vs_baseline': round(BASELINE_MS / ms_per_iter, 2),
        'projected_20k_iters_min': round(projected_min, 2),
        'compile_s': round(compile_s, 1),
        'g_loss': float(metrics.g_loss),
        'emd': float(metrics.emd),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
