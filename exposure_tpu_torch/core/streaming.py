"""Streaming training's data: host-assembled bundles of fresh crops, made
by one producer thread in the schedule's order and uploaded to the card
from pinned memory on a side stream.

``assemble_stream`` is ``exposure_tpu/core/trainer.py::_assemble_stream``
(the same provider calls in the same order, so the same bundle and the
same provider seeds afterwards): one native ``sample_into`` call fills the
whole fresh-crop bundle, and the Python loop serves the other providers.

``BundleFeeder`` differs from the JAX trainer by design.  The JAX trainer
keeps one ``AsyncPrefetcher`` thread a bundle shape, each ``slots`` bundles
ahead, and a plain iteration takes bundles of two shapes: two threads then
advance the same provider seeds, and the crops an iteration trains on
depend on thread timing.  Here one producer makes every bundle, in the
order the schedule uses them (the trainer hands it that order), so a
streaming run is a function of its seed.

On the card a bundle is filled into a pinned host buffer, copied to the
device with ``non_blocking=True`` on a side stream, and the compute stream
waits on the copy's event; the buffer goes back to the producer only after
that event has completed (the producer waits on it), so a buffer is never
refilled while its copy is in flight.  Each bundle shape has at most
``slots + 2`` buffers: ``slots`` ready, one being filled, one whose copy may
be in flight.  On the CPU the bundle is copied out of its buffer.

Under a data-parallel mesh (``parallel/mesh.py``) each rank's producer
assembles the whole bundle on the shared seeds, exactly as one device
does, then keeps the rank's shard along axis 1 (``P(None, DATA_AXIS)``)
in its pinned buffer: the upload is ``1 / world`` of the bundle, the host
assembly that of the whole one.  The ranks check that their first bundles
agree (a digest).
"""

import queue
import threading
import time

import numpy as np
import torch

from exposure_tpu_torch.parallel.mesh import digest
from exposure_tpu_torch.utils.prefetch import AsyncPrefetcher


def _quantize(x):
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def bundle_shapes(cfg, supervised, giters, citers, n_iters=1):
    """The shapes of one bundle: fresh crops ``[giters * n_iters, 2B + P,
    S, S, C or 2C]`` and real batches ``[citers * n_iters, B, S, S, C]``
    (before the ``[n_iters, ...]`` reshape of a chunk)."""
    b, p = cfg.batch_size, cfg.replay_memory_size
    s, c = cfg.source_img_size, cfg.real_img_channels
    return ((giters * n_iters, 2 * b + p, s, s, 2 * c if supervised else c),
            (citers * n_iters, b, s, s, c))


def stream_dtype(cfg):
    """``np.uint8`` when ``cfg.stream_dtype`` is ``'uint8'``, else
    ``np.float32``."""
    name = str(cfg.get('stream_dtype', 'float32'))
    if name not in ('float32', 'uint8'):
        raise ValueError('stream_dtype must be float32 or uint8, got %r'
                         % name)
    return np.uint8 if name == 'uint8' else np.float32


def assemble_stream(cfg, supervised, fake_provider, real_provider, giters,
                    citers, n_iters=1, out=None):
    """The host bundle of one streaming call: ``(g_fresh, real)`` numpy
    arrays, ``[giters, ...]``/``[citers, ...]`` or, for ``n_iters > 1``,
    ``[n_iters, giters, ...]``/``[n_iters, citers, ...]``, in
    ``stream_dtype(cfg)``.  ``out``: the two arrays to fill (C-contiguous,
    of ``bundle_shapes``' sizes); new arrays when None."""
    n = n_iters
    g_shape, r_shape = bundle_shapes(cfg, supervised, giters, citers, n)
    giters, citers = g_shape[0], r_shape[0]
    b = cfg.batch_size
    c = cfg.real_img_channels
    dt = stream_dtype(cfg)
    u8 = dt == np.uint8
    if out is None:
        out = np.empty(g_shape, dt), np.empty(r_shape, dt)
    g_fresh, real = out
    if g_fresh.shape != g_shape or real.shape != r_shape or \
            g_fresh.dtype != dt or real.dtype != dt:
        raise ValueError('bundle buffers %s %s %s %s, want %s %s of %s'
                         % (g_fresh.shape, g_fresh.dtype, real.shape,
                            real.dtype, g_shape, r_shape, np.dtype(dt)))

    def q(x):
        return _quantize(x) if u8 else x

    if not supervised and hasattr(fake_provider, 'sample_into'):
        # one native call fills the whole [giters * chunk, S, S, C] bundle
        # in its final layout (a call for 0 rows too: it advances the seed)
        fake_provider.sample_into(
            g_fresh.reshape((-1,) + g_fresh.shape[2:]))
    else:
        for i in range(giters):
            batch = fake_provider.get_next_batch(g_shape[1])[0]
            if supervised:
                # a paired provider yields [n, 2, S, S, C]
                g_fresh[i, ..., :c] = q(batch[:, 0])
                g_fresh[i, ..., c:] = q(batch[:, 1])
            else:
                g_fresh[i] = q(batch)
    if citers > 0 and hasattr(real_provider, 'sample_into'):
        real_provider.sample_into(real.reshape((-1,) + real.shape[2:]))
    elif citers > 0:
        real[...] = q(np.stack([real_provider.get_next_batch(b)[0]
                                for _ in range(citers)]))
    if n > 1:
        g_fresh = g_fresh.reshape((n, giters // n) + g_fresh.shape[1:])
        real = real.reshape((n, citers // n) + real.shape[1:])
    return g_fresh, real


def host_buffers(shapes, dtype, pinned):
    """New host tensors of ``shapes`` and ``dtype``, page-locked when
    ``pinned`` (the buffers a bundle is filled into)."""
    return tuple(torch.empty(s, dtype=dtype, pin_memory=pinned)
                 for s in shapes)


def upload(bufs, device, side, record=None):
    """``(tensors on device, copy event)``: on the card ``bufs`` (pinned)
    are copied with ``non_blocking=True`` on the ``side`` stream, into
    tensors allocated there first (so that the copy's events time the copy
    alone), and the compute stream waits on the copy's event, which the
    caller waits on before it refills ``bufs``.  On the CPU the tensors are
    copies and the event None.  ``record``, a dict, receives the CUDA events
    ``copy`` (start and end on the side stream) and ``wait`` (around the
    compute stream's wait)."""
    device = torch.device(device)
    if device.type != 'cuda':
        return tuple(x.clone() for x in bufs), None
    compute = torch.cuda.current_stream(device)
    timed = record is not None
    done = torch.cuda.Event(enable_timing=timed)
    with torch.cuda.stream(side):
        out = tuple(torch.empty(x.shape, dtype=x.dtype, device=device)
                    for x in bufs)
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        for dst, src in zip(out, bufs):
            dst.copy_(src, non_blocking=True)
        done.record()
    if timed:
        waits = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        waits[0].record(compute)
    compute.wait_event(done)
    if timed:
        waits[1].record(compute)
        record.update(copy=(start, done), wait=tuple(waits))
    for x in out:
        x.record_stream(compute)
    return out, done


class BundleFeeder:
    """One producer thread that turns the items of ``plan`` into what the
    trainer consumes, in order: an item ``('bundle', (giters, citers,
    n_iters))`` becomes that bundle's two tensors on ``device``, an item
    ``('call', fn)`` the result of ``fn()`` made in the producer thread
    (for other uses of the providers, such as the visualization's
    batches).  ``next()`` returns the next item's result.

    ``mesh``: a data-parallel ``Mesh`` whose rank's shard of each bundle
    along axis 1 is the tensors handed out (None: the whole bundle).

    ``timings``: set it to a list to have each bundle append ``{'key',
    'assembly_s'}`` (host clock, in the producer) and, on the card, the
    CUDA events ``copy`` (start and end on the side stream) and ``wait``
    (around the compute stream's wait on the copy)."""

    def __init__(self, cfg, supervised, fake_provider, real_provider, plan,
                 device, slots=2, mesh=None):
        self.cfg = cfg
        self.supervised = supervised
        self.fake_provider = fake_provider
        self.real_provider = real_provider
        self.device = torch.device(device)
        self.cuda = self.device.type == 'cuda'
        self.slots = max(int(slots), 1)
        self.dtype = torch.uint8 if stream_dtype(cfg) == np.uint8 \
            else torch.float32
        self.timings = None
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self._full = {}             # bundle key -> whole-bundle host arrays
        self._digest = None         # the first bundle's, until checked
        self._plan = iter(plan)
        # the producer's: bundle key -> free buffer pairs, buffers made
        self._free, self._count = {}, {}
        # (copy event or None, key, buffers) the consumer is done with
        self._returned = queue.Queue()
        self._halt = threading.Event()
        self._side = torch.cuda.Stream(self.device) if self.cuda else None
        self._prefetcher = None

    # --- the producer thread ---------------------------------------------
    def _buffers(self, key):
        """A free pair of host buffers for bundle ``key``: a new one while
        the shape has fewer than ``slots + 2``, else the next one whose
        upload has completed."""
        while True:
            free = self._free.setdefault(key, [])
            if free:
                return free.pop()
            if self._count.get(key, 0) < self.slots + 2:
                self._count[key] = self._count.get(key, 0) + 1
                shapes = bundle_shapes(self.cfg, self.supervised, *key)
                if self.mesh is not None:
                    shapes = tuple(s[:1] + (s[1] // self.mesh.world,) + s[2:]
                                   for s in shapes)
                return host_buffers(shapes, self.dtype, self.cuda)
            try:
                event, done, bufs = self._returned.get(timeout=0.1)
            except queue.Empty:
                if self._halt.is_set():
                    raise RuntimeError('the bundle feeder was closed')
                continue
            if event is not None:
                event.synchronize()     # the copy out of it has completed
            self._free.setdefault(done, []).append(bufs)

    def _produce(self):
        kind, what = next(self._plan)
        if kind == 'call':
            return kind, what()
        t0 = time.perf_counter()
        bufs = self._buffers(what)
        if self.mesh is None:
            assemble_stream(self.cfg, self.supervised, self.fake_provider,
                            self.real_provider, *what,
                            out=tuple(x.numpy() for x in bufs))
            return kind, (what, bufs, time.perf_counter() - t0, None)
        if what not in self._full:
            shapes = bundle_shapes(self.cfg, self.supervised, *what)
            self._full[what] = tuple(np.empty(s, stream_dtype(self.cfg))
                                     for s in shapes)
        full = self._full[what]
        assemble_stream(self.cfg, self.supervised, self.fake_provider,
                        self.real_provider, *what, out=full)
        for dst, src in zip(bufs, full):
            np.copyto(dst.numpy(), self.mesh.shard(src, axis=1))
        check = None
        if self._digest is None:
            check = self._digest = digest(*full)
        return kind, (what, bufs, time.perf_counter() - t0, check)

    # --- the consumer ----------------------------------------------------
    def next(self):
        """The next item's result: a bundle as ``(g_fresh, real)`` tensors
        on the device (``[giters, ...]``/``[citers, ...]``, or with the
        ``[n_iters]`` axis first for ``n_iters > 1``), or a call's
        result."""
        if self._prefetcher is None:
            self._prefetcher = AsyncPrefetcher(self._produce,
                                               slots=self.slots)
        kind, value = self._prefetcher.get_next()
        if kind == 'call':
            return value
        key, bufs, assembly_s, check = value
        if check is not None and not self.mesh.all_equal(check):
            raise RuntimeError('the ranks assembled different bundles: '
                               'seed the providers alike on every rank')
        record = None if self.timings is None else {
            'key': key, 'assembly_s': assembly_s}
        out, done = upload(bufs, self.device, self._side, record)
        self._returned.put((done, key, bufs))
        if record is not None:
            self.timings.append(record)
        n = key[2]
        if n > 1:
            out = tuple(x.reshape((n, x.shape[0] // n) + x.shape[1:])
                        for x in out)
        return out

    def close(self):
        """Stop the producer."""
        self._halt.set()
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None
