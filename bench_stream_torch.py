#!/usr/bin/env python3
"""Streaming-training benchmark of the PyTorch/CUDA port: train from a
multi-GB on-disk pack (the counterpart of ``bench_stream.py``).

    python3 bench_stream_torch.py [--pack-gb 4] [--iters 100]
        [--pack-dir data/bench_packs] [--config example] [--fuse 1] [--u8]
        [--legacy-assembly] [--debug] [--slots 2] [--keep-pack] [--cpu]

A procedural float32 pack of ``--pack-gb`` gigabytes (80x80 crops' source)
and one of up to 1 GB (64x64) are written to ``--pack-dir`` through a
memmap, bit for bit ``bench_stream.py``'s (``make_disk_pack``).  The
port's native host loader (``native/hostloader.cpp``, built by g++ when
missing) samples each training bundle from them through
``data/native_provider.py::NativePackProvider`` (seeds 1 and 2,
augmentation 0.3 and 1.0): one ``sample_into`` call a stream, or with
``--legacy-assembly`` one provider batch at a time.  ``--u8`` assembles
uint8 bundles (quantized at assembly, dequantized in the step).  A producer
thread (``utils/prefetch.py::AsyncPrefetcher``, ``--slots`` bundles ahead)
fills a pinned host buffer and enqueues its copy to the card on a side
stream; the compute stream waits on the copy's event, as
``core/streaming.py`` does.  The step is
``core/steps.py::build_streaming_outer_step`` or, for ``--fuse`` above 1,
``build_streaming_fused_step`` (one plain iteration captured as a CUDA
graph and replayed ``--fuse`` times a dispatch) on ``[fuse, giters, ...]``
/ ``[fuse, citers, ...]`` bundles.  The packs are deleted afterwards
unless ``--keep-pack``.

Timing: this line includes the host, so it reads the host clock up to a
``torch.cuda.synchronize()`` after each dispatch; ms an iteration is the
larger of the dispatches' median and the whole loop's wall time, divided
by ``--fuse``.  ``median_host_assembly_ms`` runs from the buffer's
allocation to the upload's enqueue, in the producer.  ``compile_s`` is the
first dispatch (on the card the first calls' set-up and, fused, the
warm-up and capture).  ``vs_baseline`` is 300 ms, the reference's
iteration on a GTX 1080 Ti (``BASELINE.md``), over the line's ms.
``--cpu`` runs on the host, for the tests.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

LR_G, LR_C = 1e-5, 5e-5
BASELINE_MS = 300.0     # the reference's iteration, GTX 1080 Ti
CROP = 64


def make_disk_pack(path, gigabytes, size=80, seed=0, chunk=1024):
    """Procedural float32 [N, size, size, 3] pack written in chunks via a
    memmap — multi-GB without holding it in RAM."""
    bytes_per = size * size * 3 * 4
    n = max(int(gigabytes * (1 << 30) // bytes_per), chunk)
    if os.path.exists(path):
        try:
            hdr = np.lib.format.open_memmap(path, mode='r')
            if hdr.shape[0] == n and hdr.shape[1] == size:
                del hdr
                return path, n
            del hdr
        except Exception:
            pass
    print('# generating %.1f GB pack (%d images) at %s' %
          (n * bytes_per / (1 << 30), n, path), file=sys.stderr)
    arr = np.lib.format.open_memmap(path, mode='w+', dtype=np.float32,
                                    shape=(n, size, size, 3))
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        k = e - s
        # smooth gradients + noise: cheap but non-constant content
        phase = rng.rand(k, 1, 1, 3).astype(np.float32)
        freq = 1 + rng.rand(k, 1, 1, 3).astype(np.float32) * 3
        base = 0.5 + 0.4 * np.sin(
            2 * np.pi * (freq * (xx + yy)[None, :, :, None] + phase))
        noise = rng.rand(k, size, size, 3).astype(np.float32) * 0.05
        arr[s:e] = np.clip(base * 0.5 + noise, 0.0, 1.0)
    arr.flush()
    del arr
    return path, n


def make_packs(pack_dir, pack_gb, chunk=1024):
    """The two packs in ``pack_dir`` (written when missing or of another
    size): ``(fake path, its images, real path)``, the fake pack of
    ``pack_gb`` GB of 80x80 sources, the real one of up to 1 GB of 64x64."""
    fake_path, n_fake = make_disk_pack(
        os.path.join(pack_dir, 'stream_fake_%.1fgb.npy' % pack_gb), pack_gb,
        chunk=chunk)
    real_path, _ = make_disk_pack(
        os.path.join(pack_dir, 'stream_real_1gb.npy'), min(pack_gb, 1.0),
        size=CROP, seed=7, chunk=chunk)
    return fake_path, n_fake, real_path


def assemble_bundle(fake_provider, real_provider, g_fresh, real,
                    legacy=False):
    """Fill one bundle in place, as ``bench_stream.py``'s ``assemble``
    does: ``g_fresh`` [fuse * giters, 2B + P, 64, 64, 3] and ``real``
    [fuse * citers, B, 64, 64, 3], float32 or uint8, C-contiguous.  One
    native ``sample_into`` call a stream, or with ``legacy`` a provider batch
    at a time, quantized ``clip(x, 0, 1) * 255 + 0.5`` for uint8."""
    if legacy:
        def q(x):
            return (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8) \
                if g_fresh.dtype == np.uint8 else x
        for i in range(g_fresh.shape[0]):
            g_fresh[i] = q(fake_provider.get_next_batch(g_fresh.shape[1])[0])
        real[...] = q(np.stack([real_provider.get_next_batch(real.shape[1])[0]
                                for _ in range(real.shape[0])]))
    else:
        fake_provider.sample_into(g_fresh.reshape((-1,) + g_fresh.shape[2:]))
        real_provider.sample_into(real.reshape((-1,) + real.shape[2:]))
    return g_fresh, real


def upload(bufs, device, side):
    """Copy host ``bufs`` to ``device``: on the card from pinned memory,
    non-blocking on the ``side`` stream, into tensors allocated there.
    Returns ``(tensors, the copy's event or None)``."""
    if device.type != 'cuda':
        return tuple(x.clone() for x in bufs), None
    with torch.cuda.stream(side):
        out = tuple(torch.empty(x.shape, dtype=x.dtype, device=device)
                    for x in bufs)
        for dst, src in zip(out, bufs):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return out, done


def _metric(metrics, name):
    """The last iteration's ``name`` from a step's ``StepMetrics`` or a
    fused step's [N, 7] rows."""
    from exposure_tpu_torch.core.steps import StepMetrics
    if torch.is_tensor(metrics):
        return float(metrics[-1, StepMetrics._fields.index(name)])
    return float(getattr(metrics, name))


def main(argv=None, chunk=1024):
    """Run the benchmark and print its line; returns the line.
    ``chunk``: the rows ``make_disk_pack`` writes at a time and its least
    pack (the tests pass a small one)."""
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import (
        build_streaming_fused_step,
        build_streaming_outer_step,
    )
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.core.trainer import iteration_seed
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.native.build import build
    from exposure_tpu_torch.tools import device_name, tool_device
    from exposure_tpu_torch.utils.config import load_config
    from exposure_tpu_torch.utils.draws import Draws
    from exposure_tpu_torch.utils.prefetch import AsyncPrefetcher
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--pack-gb', type=float, default=4.0)
    ap.add_argument('--iters', type=int, default=100)
    ap.add_argument('--pack-dir', default='data/bench_packs')
    ap.add_argument('--config', default='example')
    ap.add_argument('--fuse', type=int, default=1)
    ap.add_argument('--slots', type=int, default=2)
    for flag in ('--u8', '--legacy-assembly', '--debug', '--keep-pack',
                 '--cpu'):
        ap.add_argument(flag, action='store_true')
    args = ap.parse_args(argv)
    device = tool_device(args.cpu)
    print('# bench_stream: %s' % device_name(device), file=sys.stderr)
    cuda = device.type == 'cuda'
    os.makedirs(args.pack_dir, exist_ok=True)
    build()     # the host loader, when its library is missing

    pack_gb, fuse = args.pack_gb, args.fuse
    fake_path, n_fake, real_path = make_packs(args.pack_dir, pack_gb, chunk)

    cfg = load_config(args.config)
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, 0, device=device)
    for net in (policy, critic, value):
        net.to(device)
    fake_provider = NativePackProvider(fake_path, output_size=CROP,
                                       augmentation=0.3, seed=1)
    real_provider = NativePackProvider(real_path, output_size=CROP,
                                       augmentation=1.0, seed=2)
    pool = PoolState.create(torch.from_numpy(fake_provider.get_next_batch(
        cfg.replay_memory_size)[0]).to(device), cfg.num_state_dim)

    giters, citers = cfg.giters, cfg.citers
    generator = torch.Generator(device=device)

    def draws_for(it):
        generator.manual_seed(iteration_seed(0, it))
        return Draws(generator, device)

    if fuse > 1:
        step = build_streaming_fused_step(cfg, policy, critic, value, filters,
                                          giters, citers, draws_for,
                                          generator)
    else:
        step = build_streaming_outer_step(cfg, policy, critic, value,
                                          filters, giters, citers)

    b, p = cfg.batch_size, cfg.replay_memory_size
    chunk_rows = 2 * b + p
    legacy, debug = args.legacy_assembly, args.debug
    bdt = np.uint8 if args.u8 else np.float32
    tdt = torch.uint8 if args.u8 else torch.float32
    shapes = ((fuse * giters, chunk_rows, CROP, CROP, 3),
              (fuse * citers, b, CROP, CROP, 3))
    side = torch.cuda.Stream(device) if cuda else None
    assembly_times = []

    def assemble():
        t0 = time.perf_counter()
        bufs = tuple(torch.empty(s, dtype=tdt, pin_memory=cuda)
                     for s in shapes)
        assemble_bundle(fake_provider, real_provider,
                        *(x.numpy() for x in bufs), legacy=legacy)
        t_np = time.perf_counter()
        out = upload(bufs, device, side)
        t_enq = time.perf_counter()
        assembly_times.append(1000 * (t_enq - t0))
        if debug:
            if out[1] is not None:
                out[1].synchronize()
            print('# assemble: numpy %.0f ms, upload enq %.0f ms, '
                  'upload done +%.0f ms' %
                  (1000 * (t_np - t0), 1000 * (t_enq - t_np),
                   1000 * (time.perf_counter() - t_enq)), file=sys.stderr,
                  flush=True)
        return out

    prefetcher = AsyncPrefetcher(assemble, slots=args.slots)

    def next_bundle():
        (g_fresh, real), done = prefetcher.get_next()
        if done is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            for x in (g_fresh, real):
                x.record_stream(compute)
        if fuse > 1:
            g_fresh = g_fresh.reshape((fuse, giters) + g_fresh.shape[1:])
            real = real.reshape((fuse, citers) + real.shape[1:])
        return g_fresh, real

    def dispatch(st, pl, g_fresh, real, i):
        if fuse > 1:
            its = np.arange(i * fuse, (i + 1) * fuse)
            return step.run(st, pl, (g_fresh, real), its.tolist(),
                            [LR_G] * fuse, [LR_C] * fuse,
                            (its / 20000).astype(np.float32).tolist())
        return step(st, pl, g_fresh, real, draws_for(i), LR_G, LR_C,
                    i / 20000)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    try:
        t_c = time.perf_counter()
        state, pool, metrics = dispatch(state, pool, *next_bundle(), 0)
        sync()
        compile_s = time.perf_counter() - t_c

        n_disp = max(args.iters // fuse, 1)
        times = []
        t_loop = time.perf_counter()
        for i in range(n_disp):
            t0 = time.perf_counter()
            g_fresh, real = next_bundle()
            t_get = time.perf_counter()
            state, pool, metrics = dispatch(state, pool, g_fresh, real,
                                            i + 1)
            t_disp = time.perf_counter()
            sync()
            t_blk = time.perf_counter()
            times.append(1000 * (t_blk - t0) / fuse)
            if debug:
                print('# disp %d: get %.0f ms, call %.0f ms, block %.0f ms'
                      % (i, 1000 * (t_get - t0), 1000 * (t_disp - t_get),
                         1000 * (t_blk - t_disp)), file=sys.stderr,
                      flush=True)
        wall_ms = 1000 * (time.perf_counter() - t_loop) / (n_disp * fuse)
    finally:
        prefetcher.stop()

    ms = max(statistics.median(times), wall_ms)
    bytes_per_iter = ((giters * chunk_rows + citers * b) * CROP * CROP * 3
                      * np.dtype(bdt).itemsize)
    bundle_bytes = fuse * bytes_per_iter
    assembly_ms = statistics.median(assembly_times)
    line = {
        'metric': 'stream_train_outer_iter_ms',
        'value': round(ms, 2),
        'unit': 'ms/iter (streamed from %.1f GB on-disk pack%s)' % (
            pack_gb, ', fused x%d' % fuse if fuse > 1 else ''),
        'vs_baseline': round(BASELINE_MS / ms, 2),
        'pack_images': n_fake,
        'iters_per_dispatch': fuse,
        'bundle_dtype': str(np.dtype(bdt)),
        'median_host_assembly_ms': round(assembly_ms, 2),
        'host_assembly_gb_per_s': round(
            bundle_bytes / (assembly_ms / 1000) / (1 << 30), 2),
        'wall_ms_per_iter': round(wall_ms, 2),
        'projected_20k_iters_min': round(ms * 20001 / 1000 / 60, 2),
        'compile_s': round(compile_s, 1),
        'g_loss': _metric(metrics, 'g_loss'),
        'emd': _metric(metrics, 'emd'),
    }
    print(json.dumps(line), flush=True)
    if not args.keep_pack:
        fake_provider.close()
        real_provider.close()
        os.remove(fake_path)
        os.remove(real_path)
    return line


if __name__ == '__main__':
    main()
