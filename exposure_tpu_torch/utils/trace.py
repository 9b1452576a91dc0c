"""The program's own tracing: host ranges and device regions at its layer
boundaries, off by default.

- ``span(name)``: a host range, ``torch.profiler.record_function(
  'exposure.' + name)``.  A profiler that traces the card puts it on the
  clock it gives the device's activities, so an idle gap of the device
  lines up with what the host was doing.
- ``region(name, device)``: a device span on the device's current
  stream.  On the card a one-thread stamp kernel (``csrc/trace_stamp.cu``)
  runs on entry and on exit; it writes ``(code, %globaltimer)`` into the
  next slot of a ring on the device, and counts a stamp that finds the
  ring full instead of writing it.  A region opened while a CUDA graph is
  being captured is recorded into the graph, so every replay stamps again
  with no host work.  On the CPU a region stamps ``time.perf_counter_ns()``
  into a host list of the same capacity.
- ``reset()`` empties the rings (on the current stream) and the host list;
  ``stamps()`` synchronizes and returns ``[(name, 'enter' | 'exit', ns)]``
  in device order, device by device, then the host's; ``dropped()`` the
  stamps that found no slot.

``enable()`` turns tracing on for the process (``EXPOSURE_TPU_TORCH_TRACE=1``
does so at import, for a program one did not write).  Off, ``span`` and
``region`` return one shared no-op context after one test: a graph
captured then holds no stamp node, and a process that never turns tracing
on never builds the stamp library.  On, the first region on a card builds
the library (``kernels/__init__.py``) and makes that card's ring, which
never moves afterwards, since captured graphs hold its address: so the
first region on a card must open outside a capture (the serving and
training graphs run their body eagerly before they capture it).  A graph
captured with tracing on keeps stamping after ``enable(False)``.
"""

import contextlib
import os
import time

import torch

PREFIX = 'exposure.'
CAPACITY = 1 << 16      # stamps a ring (or the host list) holds

_NULL = contextlib.nullcontext()
_on = os.environ.get('EXPOSURE_TPU_TORCH_TRACE', '') == '1'
_codes = {}             # region name -> even code (enter; exit is code + 1)
_names = []             # code // 2 -> region name
_rings = {}             # CUDA device index -> (ring [CAPACITY, 2], count)
_host = []              # (code, ns) stamped on the CPU
_host_dropped = 0


def enable(on=True):
    """Turn tracing on (or off) for the process; returns whether it was
    on."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled():
    return _on


def span(name):
    """A host range ``exposure.<name>`` while tracing is on."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def region(name, device):
    """A device span ``name`` on ``device``'s current stream (the host's
    clock for a CPU device) while tracing is on."""
    if not _on:
        return _NULL
    code = _codes.get(name)
    if code is None:
        code = _codes[name] = 2 * len(_names)
        _names.append(name)
    return _region(code, torch.device(device))


@contextlib.contextmanager
def _region(code, device):
    # no ``finally``: a body that raises inside a capture has invalidated
    # it, and a stamp launched there would hide the body's error; the
    # region then stays open, which the readings skip
    _stamp(code, device)
    yield
    _stamp(code + 1, device)


def _stamp(code, device):
    global _host_dropped
    if device.type != 'cuda':
        if len(_host) < CAPACITY:
            _host.append((code, time.perf_counter_ns()))
        else:
            _host_dropped += 1
        return
    ring, count = _ring(device)
    from exposure_tpu_torch.kernels import trace_stamp_library
    lib = trace_stamp_library()
    with torch.cuda.device(ring.device):
        err = lib.trace_stamp_launch(
            ring.data_ptr(), count.data_ptr(), ring.shape[0], code,
            torch.cuda.current_stream(ring.device).cuda_stream)
    if err != 0:
        raise RuntimeError('trace_stamp_launch failed: %s'
                           % lib.trace_stamp_error_string(err).decode())


def _ring(device):
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    found = _rings.get(index)
    if found is None:
        with torch.cuda.device(index):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    'the first traced region on cuda:%d opened inside a '
                    'graph capture: open one before capturing, so that the '
                    'ring is made outside it' % index)
            found = (torch.zeros((CAPACITY, 2), dtype=torch.int64,
                                 device=index),
                     torch.zeros(1, dtype=torch.int64, device=index))
            torch.cuda.synchronize(index)
        _rings[index] = found
    return found


def reset():
    """Empty every ring (its count zeroed on the current stream, after
    the work queued there) and the host list."""
    global _host_dropped
    for index, (_, count) in _rings.items():
        with torch.cuda.device(index):
            count.zero_()
    del _host[:]
    _host_dropped = 0


def _named(rows):
    return [(_names[c // 2], 'exit' if c % 2 else 'enter', ns)
            for c, ns in rows]


def _read():
    """``[(rows, stamps made)]`` of every ring, then of the host list."""
    out = []
    for index, (ring, count) in sorted(_rings.items()):
        torch.cuda.synchronize(index)
        n = int(count.item())
        out.append((ring[:min(n, ring.shape[0])].tolist(), n))
    out.append((list(_host), len(_host) + _host_dropped))
    return out


def stamps():
    """``[(name, 'enter' | 'exit', ns)]`` since the last ``reset``: each
    card's ring in the order its stamps ran, then the host's."""
    return [s for rows, _ in _read() for s in _named(rows)]


def dropped():
    """The stamps since the last ``reset`` that found their ring full."""
    return sum(n - len(rows) for rows, n in _read())
