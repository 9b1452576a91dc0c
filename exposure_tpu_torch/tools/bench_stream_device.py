"""The fused streaming step's device time without its upload (the port of
``exposure_tpu/tools/bench_stream_device.py``).

``example`` at full width: a random pool, two stacked bundles uploaded
once (``[fuse, giters, 2B + P, 64, 64, 3]`` and ``[fuse, citers, B, 64,
64, 3]`` float32), and the port's ``build_streaming_fused_step`` (one
plain iteration captured as a CUDA graph and replayed, ``core/fused.py``)
chained over the bundles in turn, the state and pool carried through.
The first dispatch holds the warm-up and the capture; ``--warm`` more run
untimed; then each of ``--disp`` dispatches is timed with CUDA events.
``stream_fused_device_ms_per_iter`` is the median dispatch's ms over
``--fuse``; ``ms_per_dispatch`` the median dispatch's.

    python -m exposure_tpu_torch.tools.bench_stream_device [--fuse 10] \
        [--disp 12] [--warm 3] [--config example] [--device cpu]

On the CPU (``--device cpu``) the fused body runs eagerly and the times
are the host clock's; ``--config test`` keeps that small.
"""

import argparse
import json
import statistics
import time

import numpy as np
import torch


def build(cfg, device, fuse, seed=0):
    """``(step, state, pool, bundles)`` for ``cfg`` on ``device``."""
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import build_streaming_fused_step
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.core.trainer import iteration_seed
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.draws import Draws
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, seed, device=device)
    for net in (policy, critic, value):
        net.to(device)
    b, p = cfg.batch_size, cfg.replay_memory_size
    chunk = 2 * b + p
    rng = np.random.RandomState(seed)

    def up(shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
            device)
    pool = PoolState.create(up((p, 64, 64, 3)), cfg.num_state_dim)
    generator = torch.Generator(device=device)

    def draws_for(it):
        generator.manual_seed(iteration_seed(seed, it))
        return Draws(generator, device)
    step = build_streaming_fused_step(cfg, policy, critic, value, filters,
                                      cfg.giters, cfg.citers, draws_for,
                                      generator)
    bundles = [(up((fuse, cfg.giters, chunk, 64, 64, 3)),
                up((fuse, cfg.citers, b, 64, 64, 3))) for _ in range(2)]
    return step, state, pool, bundles


def bench(cfg, device, fuse=10, disp=12, warm=3):
    from exposure_tpu_torch.tools import timing_name
    step, state, pool, bundles = build(cfg, device, fuse)
    cuda = torch.device(device).type == 'cuda'

    def dispatch(st, pl, i):
        its = np.arange(i * fuse, (i + 1) * fuse)
        return step.run(st, pl, bundles[i % 2], its.tolist(),
                        [1e-5] * fuse, [5e-5] * fuse,
                        (its / 20000).astype(np.float32).tolist())

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    state, pool, m = dispatch(state, pool, 0)
    float(m[-1, 0])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(warm):
        state, pool, m = dispatch(state, pool, 1 + i)
    sync()
    warm_s = time.perf_counter() - t0
    times = []
    t0 = time.perf_counter()
    for i in range(disp):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, pool, m = dispatch(state, pool, 1 + warm + i)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t1 = time.perf_counter()
            state, pool, m = dispatch(state, pool, 1 + warm + i)
            times.append(1e3 * (time.perf_counter() - t1))
    full_s = time.perf_counter() - t0
    if not bool(torch.isfinite(m).all()):
        raise AssertionError('non-finite metrics after the dispatches')
    per_disp = statistics.median(times)
    return {
        'metric': 'stream_fused_device_ms_per_iter',
        'value': per_disp / fuse,
        'ms_per_dispatch': per_disp,
        'ms_per_dispatch_all': times,
        'fuse': fuse, 'first_dispatch_s': first_s,
        'warm_s': warm_s, 'full_s': full_s,
        'captures': step.captures, 'replays': step.replays,
        'timing': timing_name(device),
    }


def main(argv=None):
    from exposure_tpu_torch.tools import entry_device
    from exposure_tpu_torch.utils.config import load_config
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--fuse', type=int, default=10)
    ap.add_argument('--disp', type=int, default=12)
    ap.add_argument('--warm', type=int, default=3)
    ap.add_argument('--config', default='example')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    cfg = load_config(args.config)
    out = dict(bench(cfg, device, args.fuse, args.disp, args.warm),
               config=args.config)
    print('# first dispatch (warm-up and capture): %.2f s'
          % out['first_dispatch_s'])
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
