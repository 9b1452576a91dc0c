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
    from exposure_tpu_torch.utils.ops import tf32_off
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
