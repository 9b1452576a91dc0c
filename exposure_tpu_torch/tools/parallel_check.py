"""Data-parallel training checks at full width on the card, for
``chip_smoke.py::phase_parallel``.

- ``step_equality(mesh, cfg)``: the resident and the streaming step under
  ``mesh`` (a world-size-1 group, whose all-reduce runs) against the step
  without a mesh, twice (a control), from the same state, data and draws,
  with cuDNN's and torch's deterministic algorithms; returns the names of
  the tensors that differ (none, when the group changes nothing).
- ``TrainerRun``: a ``Trainer(num_devices=world)`` run driven one
  iteration at a time, so that a caller can interleave it with other work:
  each iteration timed with CUDA events, its parameters digested and the
  digests compared across the ranks, its metrics kept; at the end a resume
  (a fresh trainer restores the newest checkpoint, equal to the live state
  bit for bit, takes the live pool shard, since the pool is not
  checkpointed, and runs the next iteration, as the live trainer does,
  with deterministic algorithms: equal bit for bit), the all-reduce's
  time for the generator and the critic update's buckets, and the peak
  memory.
- ``trainer_rank(mesh, job)``: a whole ``TrainerRun`` on a spawned rank
  (``parallel/launch.py``).
- The fused dispatch's checks (``core/fused.py``), for
  ``chip_smoke.py::phase_fused`` and ``--world``: ``Rows`` keeps what a
  trainer's bookkeeping reads, ``reset`` puts a trainer back at a snapshot,
  ``dispatch`` runs a chunk fused or plain, ``outcome`` and ``differing``
  compare two runs, ``bit_runs`` runs plain and fused from a snapshot and
  ``resume_check`` resumes from the pipelined run's checkpoint;
  ``fused_rank(mesh, job)`` is the fused run against the plain one on a
  rank of a world.
"""

import contextlib
import os
import random

import numpy as np
import torch

from exposure_tpu_torch.parallel.mesh import digest
from exposure_tpu_torch.utils.ops import deterministic_algorithms


def _differing(a, b):
    (sa, pa, ma), (sb, pb, mb) = a, b
    ta, tb = sa.tensors(), sb.tensors()
    out = [k for k in ta if not torch.equal(ta[k], tb[k])]
    if not torch.equal(pa.images, pb.images) or \
            not torch.equal(pa.states, pb.states):
        out.append('pool')
    if not torch.equal(torch.stack(list(ma)), torch.stack(list(mb))):
        out.append('metrics')
    return out


def step_equality(mesh, cfg, seed=0, pack_rows=256):
    """The resident and the streaming step of ``cfg`` (its giters and
    citers) under ``mesh`` and without a mesh, on one device.  Returns
    ``{path: (differing under the mesh, differing in the control)}``."""
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import (
        build_outer_step,
        build_streaming_outer_step,
    )
    from exposure_tpu_torch.core.streaming import bundle_shapes
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.draws import Draws
    from exposure_tpu_torch.utils.precision import tf32_off
    dev = mesh.device
    nets = build_models(cfg)
    state = init_train_state(cfg, *nets[1:], seed=seed, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    s = cfg.source_img_size
    fake = torch.rand((pack_rows, 80, 80, 3), generator=g, device=dev)
    real = torch.rand((pack_rows, s, s, 3), generator=g, device=dev)
    pool_images = torch.rand((cfg.replay_memory_size, s, s, 3),
                             generator=g, device=dev)
    g_shape, r_shape = bundle_shapes(cfg, False, cfg.giters, cfg.citers)
    bundle = (torch.rand(g_shape, generator=g, device=dev),
              torch.rand(r_shape, generator=g, device=dev))
    rates = (cfg.lr_g(1), cfg.lr_c(1), 1 / cfg.max_iter_step)
    out = {}
    for path in ('resident', 'streaming'):
        runs = []
        for step_mesh in (mesh, None, None):
            if path == 'resident':
                step = build_outer_step(cfg, *nets[1:], nets[0], (s, True),
                                        (s, True), cfg.giters, cfg.citers,
                                        mesh=step_mesh)
                data = (fake, real)
            else:
                step = build_streaming_outer_step(
                    cfg, *nets[1:], nets[0], cfg.giters, cfg.citers,
                    mesh=step_mesh)
                data = bundle
            pool = PoolState.create(pool_images.clone(), cfg.num_state_dim)
            draws = Draws(torch.Generator(device=dev).manual_seed(seed), dev)
            with tf32_off(), deterministic_algorithms():
                runs.append(step(state, pool, *data, draws, *rates))
        out[path] = (_differing(runs[0], runs[1]),
                     _differing(runs[1], runs[2]))
    return out


def bucket_bytes(state):
    """The bytes of a generator update's and a critic update's all-reduce:
    the gradients (generator and value, or critic) and three float32
    metrics."""
    def numel(tree):
        return sum(v.numel() for v in tree.values())
    return (4 * (numel(state.gen_params) + numel(state.val_params) + 3),
            4 * (numel(state.crit_params) + 3))


class TrainerRun:
    """A ``Trainer`` of ``job['config']`` with ``job['knobs']`` on this
    rank of ``mesh``, run one iteration at a time; its providers are made
    in the working directory ``job['root']`` (where they find their data),
    its run goes under ``job['model_root']`` (an absolute path)."""

    def __init__(self, mesh, job):
        from exposure_tpu_torch.core.trainer import Trainer
        from exposure_tpu_torch.utils.config import load_config
        self.mesh, self.job = mesh, job
        self.cuda = mesh.device.type == 'cuda'
        cfg = load_config(job['config'])
        cfg.update(job['knobs'])
        cfg.name = job['name']
        self.cfg = cfg
        if self.cuda:
            torch.cuda.init()   # a spawned rank's allocator, for its stats
            torch.cuda.reset_peak_memory_stats(mesh.device)
        with contextlib.chdir(job['root']):
            random.seed(job.get('seed', 0))
            self.trainer = Trainer(cfg, num_devices=mesh.world,
                                   model_root=job['model_root'],
                                   device=str(mesh.device))
        self.iters = {}         # it -> ms (CUDA events; host clock on CPU)
        self.peaks = {}         # it -> the peak so far, GiB
        self.init_gib = torch.cuda.memory_allocated(mesh.device) / 2 ** 30 \
            if self.cuda else None
        self.metrics = {}
        self.digests_equal = []
        self.model_root = job['model_root']

    def _digest(self):
        st = self.trainer.state
        return digest(*[t for tree in (st.gen_params, st.val_params,
                                       st.crit_params)
                        for _, t in sorted(tree.items())])

    def run(self, first, last):
        """Iterations ``first``..``last``, each timed, its parameters'
        digest compared across the ranks."""
        import time
        for it in range(first, last + 1):
            if self.trainer.state.step != it:
                raise RuntimeError('trainer at iteration %d, asked for %d'
                                   % (self.trainer.state.step, it))
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            m = self.trainer.train(last_iter=it)
            if self.cuda:
                end.record()
                end.synchronize()
                self.iters[it] = start.elapsed_time(end)
                self.peaks[it] = torch.cuda.max_memory_allocated(
                    self.mesh.device) / 2 ** 30
            else:
                self.iters[it] = 1e3 * (time.perf_counter() - t0)
            self.metrics[it] = [float(v) for v in m]
            self.digests_equal.append(self.mesh.all_equal(self._digest()))

    def _allreduce_ms(self, n_bytes, runs=7):
        """Median ms of ``mesh.pmean`` on a float32 bucket of ``n_bytes``,
        the ranks lined up by a barrier before each."""
        import time
        flat = torch.ones(n_bytes // 4, device=self.mesh.device)
        times = []
        for i in range(runs + 2):
            self.mesh.barrier()
            if self.cuda:
                torch.cuda.synchronize(self.mesh.device)
            t0 = time.perf_counter()
            self.mesh.pmean(flat)
            if self.cuda:
                torch.cuda.synchronize(self.mesh.device)
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    def finish(self):
        """The resume check, the all-reduce timings, the peak memory;
        closes the trainer.  Returns the run's findings."""
        from exposure_tpu_torch.core.replay import PoolState
        from exposure_tpu_torch.core.trainer import Trainer
        trainer, cfg = self.trainer, self.cfg
        try:
            peak = torch.cuda.max_memory_allocated(self.mesh.device) \
                if self.cuda else None
            step = trainer.latest_checkpoint()
            with contextlib.chdir(self.job['root']):
                random.seed(self.job.get('seed', 0))
                resumed = Trainer(cfg, restore=True,
                                  num_devices=self.mesh.world,
                                  model_root=self.model_root,
                                  device=str(self.mesh.device))
            try:
                resumed.restore(step)
                live = trainer.state.tensors()
                back = resumed.state.tensors()
                restored_equal = step == trainer.state.step and all(
                    torch.equal(live[k], back[k]) for k in live)
                pool = trainer.pool
                resumed.pool = PoolState(
                    images=pool.images.clone(), states=pool.states.clone(),
                    ground_truth=None if pool.ground_truth is None
                    else pool.ground_truth.clone())
                it = trainer.state.step
                with deterministic_algorithms():
                    trainer.train(last_iter=it)
                    resumed.train(last_iter=it)
                a, b = trainer.state.tensors(), resumed.state.tensors()
                resume_equal = restored_equal and all(
                    torch.equal(a[k], b[k]) for k in a) and \
                    torch.equal(trainer.pool.images, resumed.pool.images)
            finally:
                resumed.close()
            g_bytes, c_bytes = bucket_bytes(trainer.state)
            out = {
                'rank': self.mesh.rank, 'world': self.mesh.world,
                'backend': self.mesh.backend,
                'iteration_ms': self.iters, 'metrics': self.metrics,
                'params_equal_every_iteration': all(self.digests_equal),
                'iterations_compared': len(self.digests_equal),
                'resume_step': step,
                'resume_equal': self.mesh.all_true(resume_equal),
                'peak_memory_gib': None if peak is None else peak / 2 ** 30,
                # allocated after the trainer's init (packs, state, pool),
                # and the peak so far after each iteration
                'init_memory_gib': self.init_gib,
                'peak_memory_gib_by_iteration': self.peaks,
                'allreduce_bytes': {'generator_update': g_bytes,
                                    'critic_update': c_bytes},
            }
            if self.mesh.grouped:
                out['allreduce_ms'] = {
                    'generator_update': self._allreduce_ms(g_bytes),
                    'critic_update': self._allreduce_ms(c_bytes)}
            run_dir = os.path.join(self.model_root, cfg.name)
            out['metrics_files'] = sum(
                f == 'metrics.jsonl' for _, _, files in os.walk(run_dir)
                for f in files) if self.mesh.rank == 0 else None
            return out
        finally:
            trainer.close()


def trainer_rank(mesh, job):
    """A ``TrainerRun`` through iterations 0..``job['last_iter']`` on a
    spawned rank, then ``finish``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = TrainerRun(mesh, job)
    run.run(0, job['last_iter'])
    return run.finish()


class Rows:
    """Every iteration's metrics a trainer's bookkeeping reads (floats),
    and the state and pool of the records it processes, by the record's
    last iteration."""

    def __init__(self, trainer):
        self.metrics, self.records = {}, {}
        record, chunk = trainer._process_record, trainer._process_chunk

        def kept(it, citers, metrics, books):
            self.metrics[it] = [float(v) for v in metrics]
            return record(it, citers, metrics, books)

        def chunk_kept(rec, books):
            self.records[rec.it0 + rec.chunk - 1] = (rec.state, rec.pool)
            return chunk(rec, books)
        trainer._process_record = kept
        trainer._process_chunk = chunk_kept


def reset(trainer, snap, n_fuse, depth):
    """``trainer`` back at the snapshot ``(state, pool)``, dispatching
    ``n_fuse`` iterations a chunk with its bookkeeping ``depth`` behind; a
    streaming trainer's producer restarts on fresh providers, so that every
    run from the snapshot trains on the same bundles."""
    from exposure_tpu_torch.core.fused import clone_pool
    trainer.state, trainer.pool = snap[0].clone(), clone_pool(snap[1])
    trainer.n_fuse, trainer.depth = n_fuse, depth
    if trainer.streaming:
        trainer._close_stream()
        for name in ('fake_provider', 'real_provider'):
            getattr(trainer, name).close()
        trainer.fake_provider = trainer.cfg.fake_data_provider()
        trainer.real_provider = trainer.cfg.real_data_provider()


def outcome(trainer, rows, first, last):
    """``(state, pool, metrics)`` of ``trainer`` after iterations
    ``first .. last``, cloned."""
    from exposure_tpu_torch.core.fused import clone_pool
    return (trainer.state.clone(), clone_pool(trainer.pool),
            torch.tensor([rows.metrics[it] for it in range(first, last + 1)]))


def differing(a, b):
    """What differs between two ``(state, pool, metrics)``: tensor paths,
    ``counts`` (Adam's, the EMA's, the step), ``pool``, ``metrics``."""
    ta, tb = a[0].tensors(), b[0].tensors()
    out = [k for k in tb if not torch.equal(ta[k], tb[k])]

    def counts(st):
        return (st.opt_g.count, st.opt_v.count, st.opt_c.count, st.ema.count,
                st.step)
    if counts(a[0]) != counts(b[0]):
        out.append('counts')
    if not (torch.equal(a[1].images, b[1].images) and
            torch.equal(a[1].states, b[1].states)):
        out.append('pool')
    if not torch.equal(a[2], b[2]):
        out.append('metrics')
    return out


def dispatch(trainer, kind, first, n):
    """Iterations ``first .. first + n - 1`` as one fused chunk or as ``n``
    plain iterations (the trainer's dispatch alone, no bookkeeping)."""
    if kind == 'fused':
        trainer._run_fused(first, n)
        return
    for it in range(first, first + n):
        trainer.run_iteration(it, trainer._generator)


def _param_digest(state):
    return digest(*[t for tree in (state.gen_params, state.val_params,
                                   state.crit_params)
                    for _, t in sorted(tree.items())])


def bit_runs(trainer, snap, chunk, first, last, runs=('plain', 'fused')):
    """From the snapshot, under deterministic algorithms, each of ``runs``
    through iteration ``last``: ``plain`` and ``control`` one iteration a
    dispatch with the bookkeeping at once, ``fused`` chunks of ``chunk``
    with the bookkeeping 2 chunks behind (last, so that its records and
    checkpoints are the newest).  Returns each run's ``outcome`` from
    ``first`` and the ``Rows``."""
    rows = Rows(trainer)
    outs = {}
    with deterministic_algorithms():
        for run in runs:
            fused = run == 'fused'
            reset(trainer, snap, chunk if fused else 1, 2 if fused else 0)
            rows.metrics.clear()
            trainer.train(last_iter=last)
            outs[run] = outcome(trainer, rows, first, last)
    return outs, rows


def resume_check(again, record, fused, ckpt, first, last):
    """``again``, a fresh trainer made with ``restore=True`` in the fused
    run's directory: checkpoint ``ckpt`` restored against ``record``, the
    ``(state, pool)`` the pipelined run kept at iteration ``ckpt - 1``;
    then, on the record's pool (the pool is not checkpointed), resumed
    through ``last`` under deterministic algorithms against the fused
    run's ``outcome`` ``fused`` (from ``first``).  Returns ``(step,
    restored differing, resumed differing)``."""
    step = again.restore(ckpt)
    restored = differing((again.state, record[1], fused[2]),
                         (record[0], record[1], fused[2]))
    again.pool = record[1]
    rows = Rows(again)
    with deterministic_algorithms():
        again.train(last_iter=last)
    resumed = differing(outcome(again, rows, ckpt, last),
                        (fused[0], fused[1], fused[2][ckpt - first:]))
    return step, restored, resumed


def fused_rank(mesh, job):
    """``job['config']`` with ``job['knobs']`` on this rank of ``mesh``
    (a world-size-1 group in the caller's process, or a spawned rank):
    the special iterations ``0 .. first - 1`` plain; then from their state
    and pool (``job['first']`` on), a chunk of ``job['chunk']`` iterations
    fused and one plain, untimed (the capture), then a chunk a turn fused
    and plain in ``job['turns']``, ms per plain iteration (CUDA events;
    the host clock on the CPU); then ``bit_runs`` through
    ``job['last_iter']``, plain and fused, the parameters' digest compared
    across the ranks after every fused chunk; and ``resume_check`` of the
    checkpoint the pipelined fused run wrote at
    ``knobs['checkpoint_interval']``.  Returns what differs (fused against
    plain, restored and resumed against the fused run's record), whether
    the ranks agreed and the times."""
    import time
    from exposure_tpu_torch.core.trainer import Trainer
    from exposure_tpu_torch.utils.config import load_config
    cuda = mesh.device.type == 'cuda'
    chunk, first, last = job['chunk'], job['first'], job['last_iter']
    cfg = load_config(job['config'])
    cfg.update(job['knobs'])
    cfg.name = job['name']
    ckpt = cfg.checkpoint_interval

    def trainer_of(**kw):
        with contextlib.chdir(job['root']):
            random.seed(job.get('seed', 0))
            return Trainer(cfg, num_devices=mesh.world,
                           model_root=job['model_root'],
                           device=str(mesh.device), **kw)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = trainer_of()
    try:
        trainer.train(last_iter=first - 1)
        snap = (trainer.state.clone(), trainer.pool)
        for kind in ('fused', 'plain'):
            # untimed: the capture, and the first calls of cuDNN and nccl
            reset(trainer, snap, chunk, 0)
            dispatch(trainer, kind, first, chunk)
        ms = {'fused': [], 'plain': []}
        for kind in job['turns']:
            reset(trainer, snap, chunk, 0)
            if cuda:
                torch.cuda.synchronize(mesh.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            dispatch(trainer, kind, first, chunk)
            if cuda:
                end.record()
                end.synchronize()
                ms[kind].append(start.elapsed_time(end) / chunk)
            else:
                ms[kind].append(1e3 * (time.perf_counter() - t0) / chunk)
        # the bits, with a graph captured under deterministic algorithms
        trainer._steps = {k: v for k, v in trainer._steps.items()
                          if k[0] != 'fused'}
        digests = []
        run_fused = trainer._run_fused

        def digested(it, n):
            # the parameters right after each fused chunk (a host sync
            # there, which moves no bit)
            out = run_fused(it, n)
            digests.append(_param_digest(trainer.state))
            return out
        trainer._run_fused = digested
        outs, rows = bit_runs(trainer, snap, chunk, first, last)
        record = rows.records[ckpt - 1]
        equal_across = mesh.all_equal(b''.join(digests))
        runner = trainer._runner(cfg.giters, cfg.citers)
        captures, replays = runner.captures, runner.replays
        del runner
    finally:
        trainer.close()
    again = trainer_of(restore=True)
    try:
        step, restored, resumed = resume_check(again, record, outs['fused'],
                                               ckpt, first, last)
    finally:
        again.close()
    return {
        'rank': mesh.rank, 'world': mesh.world, 'backend': mesh.backend,
        'ms_per_plain_iteration': ms,
        'fused_vs_plain_differing': differing(outs['fused'], outs['plain']),
        'chunks_compared': len(digests),
        'params_equal_every_chunk': equal_across,
        'resume_step': step, 'restored_differing': restored,
        'resumed_differing': resumed,
        'tensors_compared': len(outs['fused'][0].tensors()),
        'captures': captures, 'replays': replays,
    }
