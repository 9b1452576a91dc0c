"""The proxy resize: a batch of photos ``[B, H, W, 3]`` (uint8 or float32)
to its ``[B, S, S, 3]`` float32 proxy, scaled to [0, 1] and resized by the
antialiased linear filter of ``jax.image.resize(..., 'linear')``.

``proxy_resize`` on a CUDA tensor launches the hand-written kernel
``csrc/proxy_resize.cu`` once: it reads the NHWC batch once and writes the
NHWC proxy, with nothing converted, permuted or copied around it.  On a CPU
tensor it runs the plain version, ``proxy_resize_reference`` (torch's
antialiased ``F.interpolate``), which is also the tests' oracle.  No JAX
kernel is replaced: the JAX package resizes with ``jax.image.resize``.

The kernel reads tap tables that the host computes in float64 and rounds
to float32 (``resize_taps``: each output index's first tap, tap count and
normalised weights, as ``benchmark/reference/serve.py::resize_matrix``
defines them), the column slices (``column_plan``) and a schedule of each
band's input rows (``row_schedule``; the band height from the batch,
``band_rows``).  They depend on the shapes alone, are built at a shape's
first call (before any graph captures it) and cached on the device, keyed
by the photo's shape and dtype, the schedules by band height, so a replay
launches the kernel alone: no upload, fill, allocation or host sync.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from exposure_tpu_torch import kernels

MAX_THREADS = 512       # kMaxThreads in the kernel: a block's threads
SLICE_CHUNKS = 512      # 16-byte chunks of a row a column slice aims at
FILL_THREADS = 512      # threads an SM is given before bands stop halving
LAST_ROW = 1 << 31      # kLastRow: the schedule's flag on slot A's last row
SCALE_U8 = 1.0 / 255.0

_SHAPES = {}      # (h, w, size, dtype, device) -> the shape's tables
_PREPARED = set()  # devices whose kernels may take > 48 KB


def proxy_resize_reference(images, size):
    """Plain PyTorch version: scale to [0, 1], then torch's antialiased
    bilinear ``F.interpolate`` (equal to ``jax.image.resize(...,
    'linear')``), on any device."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x * SCALE_U8
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode='bilinear', antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1).contiguous()


def resize_taps(n_in, n_out):
    """``(first [n_out] int32, count [n_out] int32, weights [n_out, taps]
    float32)`` of the antialiased linear resize from ``n_in`` to ``n_out``:
    a triangle widened by ``max(scale, 1)``, each output's weights
    normalised in float64, then rounded; ``weights[o, t]`` is the weight of
    input ``first[o] + t`` (0 past ``count[o]``)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centers = (np.arange(n_out, dtype=np.float64) + 0.5) * scale
    pos = np.arange(n_in, dtype=np.float64) + 0.5
    w = np.clip(1.0 - np.abs(pos[None, :] - centers[:, None]) / support,
                0.0, None)
    w /= w.sum(axis=1, keepdims=True)
    nonzero = w > 0
    first = nonzero.argmax(axis=1)
    last = n_in - 1 - nonzero[:, ::-1].argmax(axis=1)
    count = last - first + 1
    weights = np.zeros((n_out, int(count.max())), np.float32)
    for o in range(n_out):
        weights[o, :count[o]] = w[o, first[o]:last[o] + 1]
    return first.astype(np.int32), count.astype(np.int32), weights


def row_schedule(first, count, weights, band):
    """The row pass of each band of ``band`` output rows: ``(steps [N, 4]
    int32, offsets [n_bands + 1] int32)``.  A step is one input row read
    into the two slots, ``(row | LAST_ROW on slot A's last row, weight A,
    weight B, 0)`` with the weights' float32 bits: slot A holds the output
    row being finished, slot B the next one of the band.  Rows come in
    order, each once where no row lies under more than two outputs (every
    downscale); an upscale lists a row again with weight 0 for the slot that
    already holds it, and every output row has its one flagged step."""
    first = np.asarray(first, np.int64)
    last = first + np.asarray(count, np.int64) - 1
    if np.any(np.diff(first) < 0) or np.any(np.diff(last) < 0):
        raise ValueError('the supports must move forward')
    n_out = len(first)
    rows, wa, wb, offsets = [], [], [], [0]
    for o0 in range(0, n_out, band):
        o1 = min(o0 + band, n_out)
        done = first[o0] - 1          # the last row slot A's output holds
        for o in range(o0, o1):
            nxt = o + 1 < o1
            # at least slot A's last row, which hands the row over
            start = min(done + 1, last[o])
            if nxt:
                start = min(start, first[o + 1])
            for y in range(start, last[o] + 1):
                rows.append(y | (LAST_ROW if y == last[o] else 0))
                wa.append(weights[o, y - first[o]] if y > done else 0.0)
                wb.append(weights[o + 1, y - first[o + 1]]
                          if nxt and first[o + 1] <= y <= last[o + 1]
                          else 0.0)
            if nxt:
                done = min(last[o], last[o + 1]) if last[o] >= first[o + 1] \
                    else first[o + 1] - 1
        offsets.append(len(rows))
    steps = np.zeros((len(rows), 4), np.int32)
    steps[:, 0] = np.asarray(rows, np.int64).astype(np.uint32).view(np.int32)
    steps[:, 1] = np.asarray(wa, np.float32).view(np.int32)
    steps[:, 2] = np.asarray(wb, np.float32).view(np.int32)
    return steps, np.asarray(offsets, np.int32)


def _slices(first, count, size, n_slices, per_chunk):
    """``[n_slices, 4]`` int32: each slice's output columns ``[q0, q1)`` and
    the 16-byte chunks ``[k0, k1)`` of a row that their taps read."""
    out = np.zeros((n_slices, 4), np.int32)
    for j in range(n_slices):
        q0, q1 = j * size // n_slices, (j + 1) * size // n_slices
        e0 = 3 * int(first[q0])
        e1 = 3 * int(first[q1 - 1] + count[q1 - 1])
        out[j] = (q0, q1, e0 // per_chunk, -(-e1 // per_chunk))
    return out


def column_plan(w, size, itemsize):
    """The column pass of rows ``w`` wide of ``itemsize``-byte elements: a
    dict of the column slices (``slices``), the column taps (``col_first``,
    ``col_count``, ``col_w``), the block's ``threads`` and ``buf_floats``
    (one finished row of the widest slice).  Slices aim at
    ``SLICE_CHUNKS`` chunks of a row and fit ``MAX_THREADS``."""
    per_chunk = 16 // itemsize
    col_first, col_count, col_w = resize_taps(w, size)
    n_chunks = -(-3 * w // per_chunk)
    n_slices = min(size, max(1, round(n_chunks / SLICE_CHUNKS)))
    while True:
        slices = _slices(col_first, col_count, size, n_slices, per_chunk)
        widest = int((slices[:, 3] - slices[:, 2]).max())
        if widest <= MAX_THREADS or n_slices == size:
            break
        n_slices += 1
    if widest > MAX_THREADS:
        raise ValueError('a %d-wide row to %d columns needs more than %d '
                         'threads a block' % (w, size, MAX_THREADS))
    return {'slices': slices, 'col_first': col_first,
            'col_count': col_count, 'col_w': col_w,
            'threads': 32 * -(-widest // 32),
            'buf_floats': widest * per_chunk}


def band_rows(batch, n_slices, threads, size, n_sm):
    """The output rows a block owns: halved from the whole proxy until the
    batch's blocks give each of the ``n_sm`` SMs ``FILL_THREADS``
    threads."""
    band = size
    while band > 1 and batch * n_slices * math.ceil(size / band) * \
            threads < FILL_THREADS * n_sm:
        band = -(-band // 2)
    return band


def _upload(arrays, device):
    """numpy arrays as tensors on ``device``: the uploads leave pinned
    buffers without a sync of the stream, and an event waits for them
    before the first launch reads them."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError('the proxy resize of a new shape is being '
                           'captured: call it once outside the capture')
    out = {name: torch.from_numpy(np.ascontiguousarray(arr)).pin_memory()
           .to(device, non_blocking=True) for name, arr in arrays.items()}
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return out


def _device_tables(library, batch, h, w, size, dtype, device):
    """The tables of one call on ``device``: the shape's column plan and
    row taps, built once a shape, and the row schedule of the batch's band
    height, built once a band.  A device's first shape lets the kernel
    take more than 48 KB of shared memory (``proxy_resize_prepare``)."""
    key = (h, w, size, dtype, device)
    shape = _SHAPES.get(key)
    if shape is None:
        if device not in _PREPARED:
            kernels.check(library, library.lib.proxy_resize_prepare(),
                          'proxy_resize_prepare')
            _PREPARED.add(device)
        plan = column_plan(w, size, dtype.itemsize)
        shape = dict(plan, **_upload(
            {k: v for k, v in plan.items() if isinstance(v, np.ndarray)},
            device))
        shape.update(row_taps=resize_taps(h, size), bands={}, schedules={})
        _SHAPES[key] = shape
    band = shape['bands'].get(batch)
    if band is None:
        band = band_rows(
            batch, len(shape['slices']), shape['threads'], size,
            torch.cuda.get_device_properties(device).multi_processor_count)
        shape['bands'][batch] = band
    if band not in shape['schedules']:
        steps, band_off = row_schedule(*shape['row_taps'], band)
        shape['schedules'][band] = _upload(
            {'steps': steps, 'band_off': band_off}, device)
    return shape, band, shape['schedules'][band]


def proxy_resize(images, size):
    """``[B, H, W, 3]`` uint8 or float32 -> ``[B, size, size, 3]`` float32
    proxy: scaled to [0, 1], then the antialiased linear resize.  A CPU
    tensor runs the plain version; a CUDA tensor (contiguous) launches the
    kernel once or raises."""
    if images.device.type == 'cpu':
        return proxy_resize_reference(images, size)
    if images.device.type != 'cuda':
        raise ValueError('no proxy resize kernel for device %s'
                         % images.device)
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError('images must be uint8 or float32, got %s'
                        % images.dtype)
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError('images must be [B, H, W, 3], got %s'
                         % list(images.shape))
    if not images.is_contiguous():
        raise ValueError('images must be contiguous')
    batch, h, w, _ = images.shape
    out = torch.empty((batch, size, size, 3), dtype=torch.float32,
                      device=images.device)
    if batch == 0:
        return out
    vec = (3 * w * images.element_size()) % 16 == 0 and \
        images.data_ptr() % 16 == 0
    library = kernels.proxy_resize_kernel()
    with torch.cuda.device(images.device):
        t, band, rows = _device_tables(library, batch, h, w, size,
                                       images.dtype, images.device)
    kernels.launch(
        library, 'proxy_resize', images.device,
        images.data_ptr(), out.data_ptr(), rows['steps'].data_ptr(),
        rows['band_off'].data_ptr(), t['slices'].data_ptr(),
        t['col_first'].data_ptr(), t['col_count'].data_ptr(),
        t['col_w'].data_ptr(), t['col_w'].shape[1], batch, h, w, size,
        band, len(rows['band_off']) - 1, len(t['slices']),
        t['threads'], t['buf_floats'],
        int(images.dtype == torch.uint8), int(vec), count=('proxy_resize',))
    return out
