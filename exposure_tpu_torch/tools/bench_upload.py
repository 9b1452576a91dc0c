"""Host-to-device upload bandwidth (torch counterpart of
``exposure_tpu/tools/bench_upload.py``).

For each size, ``reps`` times, a fresh host array of random float32 is
made, then the timed region uploads it and forces completion with a strided
sum fetched by ``.item()`` (a tiny fetch, so that the fetch's bandwidth
does not pollute the number), on the host clock; the median of the reps
is the line.

  pageable   ``torch.from_numpy(host).to(device)``: the JAX tool's
             ``device_put`` of a numpy array (``median_s``, ``mb_per_s``,
             ``all_s`` at the size's top level)
  pinned     the streaming trainer's upload (``core/streaming.py``): the
             array filled into a page-locked buffer (``host_buffers``,
             untimed, as the producer thread fills it), then copied with
             ``non_blocking=True`` on a side stream that the compute stream
             waits on (``upload``); the same three keys under ``pinned``

Usage: python -m exposure_tpu_torch.tools.bench_upload [--mb 1 27 270]
       [--reps 5]
"""

import argparse
import json
import time

import numpy as np
import torch

from exposure_tpu_torch.core.streaming import host_buffers, upload
from exposure_tpu_torch.tools import device_name, tool_device


def _done(d):
    """Force the upload's completion: a strided sum, fetched."""
    return float(d[:: max(d.numel() // 64, 1)].sum().item())


def pageable_upload(host, device):
    """``host`` (numpy) on ``device``, through a pageable copy."""
    d = torch.from_numpy(host).to(device)
    _done(d)
    return d


def pinned_upload(buf, device, side):
    """``buf`` (a page-locked tensor) on ``device``, copied on ``side`` as
    the streaming trainer copies a bundle."""
    (d,), _ = upload((buf,), device, side)
    _done(d)
    return d


def _line(times, mb):
    med = float(np.median(times))
    return {'median_s': round(med, 6), 'mb_per_s': round(mb / med, 2),
            'all_s': [round(t, 6) for t in times]}


def report(mbs=(1, 27, 270), reps=5, device='cuda', say=print):
    device = torch.device(device)
    cuda = device.type == 'cuda'
    side = torch.cuda.Stream(device) if cuda else None
    torch.zeros(8, device=device).sum().item()    # warm the device up
    out = {'device': device_name(device),
           'timing': 'host_clock_median_to_fetch'}
    for mb in mbs:
        n = mb * (1 << 20) // 4
        (buf,) = host_buffers(((n,),), torch.float32, cuda)
        pageable, pinned = [], []
        for _ in range(reps):
            host = np.random.rand(n).astype(np.float32)
            t0 = time.perf_counter()
            pageable_upload(host, device)
            pageable.append(time.perf_counter() - t0)
            buf.numpy()[...] = host
            t0 = time.perf_counter()
            pinned_upload(buf, device, side)
            pinned.append(time.perf_counter() - t0)
        out[mb] = dict(_line(pageable, mb), pinned=_line(pinned, mb))
        say('%d MB: %s' % (mb, out[mb]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--mb', type=int, nargs='+', default=[1, 27, 270])
    ap.add_argument('--reps', type=int, default=5)
    args = ap.parse_args()
    device = tool_device()
    print('# device:', device_name(device), flush=True)
    print(json.dumps(report(args.mb, args.reps, device,
                            say=lambda s: print(s, flush=True))))


if __name__ == '__main__':
    main()
