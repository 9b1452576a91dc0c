"""What bounds streaming training's input on this host: the native host
loader's crop/flip bundle assembly rate (``hl_sample_crops``,
``exposure_tpu_torch/native/hostloader.cpp``) against the host's memcpy
bandwidth, with an OpenMP thread-scaling curve (each thread count runs in
a fresh subprocess, so that libgomp reads ``OMP_NUM_THREADS`` when it
loads).  A copy of ``exposure_tpu/tools/bench_host_assembly.py`` on the
port's loader; host only, no device.

Usage:
  python -m exposure_tpu_torch.tools.bench_host_assembly \\
      [--pack-gb 1] [--threads 1 2 4] [--out REPORT.json]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def make_pack(path, gigabytes, size=80, seed=0, chunk=2048):
    """A float32 [n, size, size, 3] ``.npy`` of about ``gigabytes`` GiB
    (at least one image), written ``chunk`` images at a time, kept when one
    of that shape is there."""
    bytes_per = size * size * 3 * 4
    n = max(int(gigabytes * (1 << 30) // bytes_per), 1)
    if os.path.exists(path):
        try:
            hdr = np.lib.format.open_memmap(path, mode='r')
            ok = hdr.shape[0] == n and hdr.shape[1] == size
            del hdr
            if ok:
                return path, n
        except (ValueError, OSError):
            pass
    arr = np.lib.format.open_memmap(path, mode='w+', dtype=np.float32,
                                    shape=(n, size, size, 3))
    rng = np.random.RandomState(seed)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        arr[s:e] = rng.rand(e - s, size, size, 3).astype(np.float32)
    arr.flush()
    del arr
    return path, n


def measure_assembly(pack_path, bundle_images, out_size, reps):
    """Runs in the child process: time bundle fills, ``(best, median)``
    seconds."""
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    prov = NativePackProvider(pack_path, output_size=out_size,
                              augmentation=0.3, seed=3)
    dest = np.empty((bundle_images, out_size, out_size, 3), np.float32)
    prov.sample_into(dest)  # warm: fault in pack pages, touch dest
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        prov.sample_into(dest)
        times.append(time.perf_counter() - t0)
    prov.close()
    return min(times), float(np.median(times))


def measure_memcpy(nbytes, reps=5):
    src = np.random.rand(nbytes // 8).astype(np.float64)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--pack-gb', type=float, default=1.0)
    ap.add_argument('--threads', type=int, nargs='+', default=[1, 2, 4])
    ap.add_argument('--reps', type=int, default=12)
    ap.add_argument('--bundle-images', type=int, default=576,
                    help='images per bundle; default = one flagship '
                         'outer iteration (giters*(2B+P) + citers*B '
                         '= 256 + 320 at B=64, P=128)')
    ap.add_argument('--out-size', type=int, default=64)
    ap.add_argument('--pack-dir', default='data/bench_packs')
    ap.add_argument('--out', default=None)
    ap.add_argument('--child', action='store_true',
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    os.makedirs(args.pack_dir, exist_ok=True)
    pack_path, n = make_pack(
        os.path.join(args.pack_dir, 'assembly_%.1fgb.npy' % args.pack_gb),
        args.pack_gb)

    if args.child:
        best, med = measure_assembly(pack_path, args.bundle_images,
                                     args.out_size, args.reps)
        print(json.dumps({'best_s': best, 'median_s': med}))
        return None

    from exposure_tpu_torch.native.build import build
    build()     # once, before the children load it
    bundle_bytes = args.bundle_images * args.out_size ** 2 * 3 * 4
    curve = {}
    for t in args.threads:
        env = dict(os.environ, OMP_NUM_THREADS=str(t))
        proc = subprocess.run(
            [sys.executable, '-m',
             'exposure_tpu_torch.tools.bench_host_assembly', '--child',
             '--pack-gb', str(args.pack_gb),
             '--bundle-images', str(args.bundle_images),
             '--out-size', str(args.out_size),
             '--reps', str(args.reps), '--pack-dir', args.pack_dir],
            env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError('the child with %d threads failed:\n%s'
                               % (t, proc.stderr[-2000:]))
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        curve[t] = {
            'assembly_ms': r['median_s'] * 1000,
            'gb_per_s': bundle_bytes / r['median_s'] / (1 << 30),
        }
        print('OMP_NUM_THREADS=%d: %.3f ms/bundle (%.2f GB/s)'
              % (t, r['median_s'] * 1000, curve[t]['gb_per_s']),
              flush=True)

    memcpy_s = measure_memcpy(bundle_bytes)
    report = {
        'host_cpus': os.cpu_count() or 1,
        'bundle_images': args.bundle_images,
        'bundle_mb': bundle_bytes / (1 << 20),
        'pack_images': n,
        'memcpy_ms': memcpy_s * 1000,
        'memcpy_gb_per_s': bundle_bytes / memcpy_s / (1 << 30),
        'threads': curve,
    }
    t1 = curve.get(1, next(iter(curve.values())))
    report['assembly_vs_memcpy'] = t1['assembly_ms'] / report['memcpy_ms']
    print(json.dumps(report))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
        print('# wrote', args.out)
    return report


if __name__ == '__main__':
    main()
