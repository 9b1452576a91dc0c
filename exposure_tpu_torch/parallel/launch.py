"""Run a function on every rank of a data-parallel world of spawned
processes, on one machine.

``spawn_ranks(fn, world, args)`` starts ``world`` processes (``spawn``:
each starts from a fresh import), joins them by a ``file://`` rendezvous
in a directory of its own, calls ``fn(mesh, *args)`` on each rank and
returns their results in rank order.  A rank that raises, exits or outlives
``deadline_s`` fails the whole world: the others are killed and
``RuntimeError`` (``TimeoutError`` for the deadline) names it, so that a
hung rendezvous or collective never outlasts its caller's clock.  Each
child checks at its end that nothing it ran imported JAX.
"""

import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import torch.multiprocessing as mp

from exposure_tpu_torch.parallel.mesh import (
    RENDEZVOUS_TIMEOUT_S,
    data_parallel_mesh,
)


def _child(rank, world, fn, args, device, backend, init_file, threads,
           results):
    import torch
    if threads:
        torch.set_num_threads(threads)
    mesh = None
    try:
        mesh = data_parallel_mesh(world, backend=backend, device=device,
                                  rank=rank, init_file=init_file,
                                  timeout_s=RENDEZVOUS_TIMEOUT_S)
        out = fn(mesh, *args)
        if 'jax' in sys.modules:
            raise RuntimeError('rank %d imported jax' % rank)
        results.put(('ok', rank, out))
    except BaseException:
        results.put(('error', rank, traceback.format_exc()))
        raise
    finally:
        if mesh is not None:
            mesh.close()


def spawn_ranks(fn, world, args=(), device='cuda', backend=None,
                deadline_s=600, threads=None, rendezvous_dir=None):
    """``[fn(mesh, *args) for each rank]`` of a world of ``world``
    spawned processes (``fn`` and ``args`` are pickled: a module-level
    function).  ``device``/``backend``: as ``data_parallel_mesh``.
    ``deadline_s``: the seconds the world may take (None: no limit);
    ``threads``: torch threads a child; ``rendezvous_dir``: where the
    rendezvous file goes (a new temp dir when None)."""
    ctx = mp.get_context('spawn')
    own_dir = rendezvous_dir is None
    rdir = tempfile.mkdtemp(prefix='rendezvous-') if own_dir \
        else rendezvous_dir
    init_file = os.path.join(rdir, 'rendezvous-%d-%d' % (os.getpid(),
                                                         time.time_ns()))
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(
        r, world, fn, args, device, backend, init_file, threads, results),
        daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, error = {}, None
    end = time.monotonic() + (float('inf') if deadline_s is None
                              else deadline_s)
    try:
        while len(out) < world and error is None:
            try:
                kind, rank, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    # a rank that died without a word (killed, or its
                    # report still in the pipe): one more look, then fail
                    try:
                        kind, rank, value = results.get(timeout=2)
                    except queue.Empty:
                        error = 'rank %d exited with code %d' % (
                            dead[0], procs[dead[0]].exitcode)
                        break
                elif time.monotonic() > end:
                    raise TimeoutError(
                        'ranks %s did not finish within %d s' % (
                            sorted(set(range(world)) - set(out)),
                            deadline_s))
                else:
                    continue
            if kind == 'ok':
                out[rank] = value
            else:
                error = 'rank %d failed:\n%s' % (rank, value)
        if error is not None:
            raise RuntimeError(error)
        for p in procs:
            p.join(timeout=min(max(end - time.monotonic(), 1), 600))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError('ranks %s did not exit' % alive)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError('ranks exited with codes %s' % bad)
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        if own_dir:
            shutil.rmtree(rdir, ignore_errors=True)
