"""The Trainer: owns the models, the train state, the device data and the
loop (torch counterpart of ``exposure_tpu/core/trainer.py``).

Same run layout (``<model_root>/<config>/<run>/`` with a scripts backup,
``log.txt``, ``metrics.jsonl``, the images dir and periodic checkpoints in
the JAX file format) and the same schedule: iteration 0 runs
``warmup_giters`` generator updates at lr 0 (they fill the pool with
terminated records and move only Adam's moments), iterations before
``critic_initialization`` and every 500th run ``critic_burst`` critic
updates, the others ``giters``/``citers``, at ``lr_g(it)``/``lr_c(it)``.

Differences from the JAX trainer, each by design:

- ``iters_per_dispatch`` above 1 runs stretches of plain iterations
  (``plan_fused_chunk``) through the fused step (``core/fused.py``): on the
  card one plain iteration captured as a CUDA graph and replayed a chunk's
  worth of times, where the JAX trainer scans N iterations in one program;
  bit for bit the iterations run one by one, as the JAX fused step is.
  Special iterations (the warmup, the critic bursts) run eagerly, one a
  dispatch, as in JAX.  A ``gloo`` group on the card cannot be captured,
  so a trainer there with ``iters_per_dispatch`` above 1 raises.
- Streaming plans its bundles with ``stream_iters_per_dispatch`` as the
  JAX trainer does, and replays a bundle's chunk through the fused step
  when ``iters_per_dispatch`` is above 1 (the JAX trainer always fuses
  it); otherwise its iterations run one plain step at a time on slices of
  the bundle.
- Bookkeeping is deferred by ``dispatch_pipeline_depth`` dispatches, as in
  JAX; checkpoints and the grid go to two background lanes.  Every
  checkpoint is written, in order (the JAX trainer drops a boundary while a
  save is in flight), so the files do not depend on timing; under ranks
  rank 0 writes on the loop's thread, then the barrier.  The grid is drawn
  by a copy of the trainer with networks of its own.
- Randomness: a ``torch.Generator`` on the device, reseeded every iteration
  from ``(seed + 1, iteration)`` as the JAX loop folds the iteration into
  ``PRNGKey(seed + 1)``, so a resumed run draws what an uninterrupted one
  would have.  The streams differ from JAX's (``utils/draws.py``).
- ``stream_data=True`` keeps no packs on the device: the fresh crops of
  every update come in bundles assembled on the host (the native loader,
  ``core/streaming.py``), float32 or uint8 (``stream_dtype``), planned in
  chunks of ``stream_iters_per_dispatch`` plain iterations (default 10)
  with the JAX ``plan_fused_chunk``, one assembly a chunk.  One
  producer thread makes the bundles in the schedule's order, up to
  ``prefetch_slots`` (default 2) ahead, where the JAX trainer keeps a
  thread a bundle shape; the visualization's batches are made in that
  order too, so a streaming run is a function of its seed.
- Data parallelism: ``num_devices=N`` trains as rank r of a world of N
  processes, one a GPU (``parallel/mesh.py``; the JAX trainer's one
  process over an N-device mesh).  Parameters and optimizer state are
  replicated; rank r keeps rows ``[r * n / N, (r + 1) * n / N)`` of each
  device pack (padded to a multiple of N by wrapping rows around), of the
  replay pool and of its paired ground truth, and of every streaming
  bundle along axis 1, as ``P(DATA_AXIS)`` places them.  Every rank draws
  the full pool and bundles from the providers, which draw from the global
  ``random`` module: each rank seeds it with the config's seed, and the
  ranks check that the pool batch and the first bundle agree (a digest).
  Each rank's draws come from (seed, iteration, rank); rank 0 draws the
  one-device run's.  Rank 0 alone writes the scripts backup, the log,
  ``metrics.jsonl``, checkpoints, dumps and the grid (drawn from the
  gathered pool), with a barrier after each checkpoint; every rank
  restores.  The steps average gradients and metrics over the ranks
  (``core/steps.py``).
- ``profile_dir``: rank 0 traces iterations ``PROFILE_START``..
  ``PROFILE_STOP`` with ``torch.profiler`` into it (TensorBoard's format,
  as ``jax.profiler``'s trace), stopped on leaving ``train``.
"""

import collections
import concurrent.futures
import copy
import os
import random
import shutil
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from exposure_tpu_torch.core.checkpoint import (
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)
from exposure_tpu_torch.core.fused import FusedRunner, clone_pool
from exposure_tpu_torch.core.losses import apply
from exposure_tpu_torch.core.replay import PoolState
from exposure_tpu_torch.core.rollout import rollout
from exposure_tpu_torch.core.steps import (
    StepMetrics,
    build_fused_iterations_step,
    build_outer_step,
    build_streaming_fused_step,
    build_streaming_outer_step,
    step_scalars,
    with_critic,
)
from exposure_tpu_torch.core.streaming import BundleFeeder
from exposure_tpu_torch.core.train_state import TrainState, init_train_state
from exposure_tpu_torch.models.networks import build_models
from exposure_tpu_torch.parallel.mesh import (
    data_parallel_mesh,
    digest,
    local_batch_size,
    pad_to_devices,
)
from exposure_tpu_torch.utils.draws import Draws
from exposure_tpu_torch.utils.image_io import make_image_grid, write_image
from exposure_tpu_torch.utils.logging_util import MedianWindow, MetricLogger, Tee
from exposure_tpu_torch.utils.precision import tf32_off

_REALTIME_VIS_FAILED = [False]
_ITERATION_STRIDE = 1 << 32   # seeds (seed + 1) * stride + iteration
_RANK_STRIDE = 0x9E3779B97F4A7C15   # odd: ranks' seeds never collide
# the iterations the profiler traces when the config names a profile_dir
# (the JAX trainer's window)
PROFILE_START = 20
PROFILE_STOP = 30


def _show_realtime(img, title):
    """Live visualization window; degrades to a one-time notice on a
    machine without a display or without cv2."""
    if _REALTIME_VIS_FAILED[0]:
        return
    try:
        import cv2
        bgr = (np.clip(img[..., ::-1], 0, 1) * 255).astype(np.uint8)
        cv2.imshow(title, bgr)
        cv2.waitKey(1)
    except Exception as e:
        _REALTIME_VIS_FAILED[0] = True
        print('# realtime_vis unavailable (%s); continuing headless' % e)


def is_special_iteration(i, cfg, supervised):
    """Iterations with their own schedule: the iteration-0 warmup and the
    critic bursts at initialization and every 500 iterations."""
    if i == 0:
        return True
    if supervised:
        return False
    return cfg.gan == 'w' and (i < cfg.critic_initialization or
                               i % 500 == 0)


def pool_health_warning(citers, supervised, terminated_frac):
    """The silent failure where the critic trains while the pool holds no
    terminated record: ``sample_terminated`` then hands it slot 0 over and
    over (the reference hard-asserts instead)."""
    if citers > 0 and not supervised and terminated_frac <= 0:
        return ('critic phase ran with ZERO terminated records in the '
                'replay pool; critic batches fell back to an unterminated '
                'record — check the warmup schedule (the reference '
                'asserts here)')
    return None


def plan_fused_chunk(it, cfg, n_fuse, supervised):
    """How many consecutive iterations from ``it`` one fused dispatch or
    one streaming bundle serves
    (``exposure_tpu/core/trainer.py::plan_fused_chunk``): 1 for a special
    iteration, else the largest c <= n_fuse such that [it, it + c) holds no
    special iteration and ends on a checkpoint iteration ((j + 1) %
    checkpoint_interval == 0) or a visualization iteration (j %
    write_image_interval == 0) if it holds one."""
    def special(i):
        return is_special_iteration(i, cfg, supervised)

    if n_fuse <= 1 or special(it):
        return 1
    end = min(it + n_fuse - 1, cfg.max_iter_step)
    ckpt = cfg.get('checkpoint_interval', 500)
    wii = cfg.get('write_image_interval', 0)
    for j in range(it, end + 1):
        if j > it and special(j):
            return j - it
        if (j + 1) % ckpt == 0 and j < end:
            return j - it + 1              # end ON the checkpoint iter
        if wii and j % wii == 0 and j < end:
            return j - it + 1              # end ON the viz iter
    return end - it + 1


class ChunkRecord(NamedTuple):
    """One dispatch's record, waiting for its bookkeeping: iterations
    ``it0 .. it0 + chunk - 1``, their critic updates an iteration, their
    metrics on the device (``[chunk, 7]``), the state and pool at the
    chunk's end, the host seconds since the dispatch before, and the
    grid's batches when the chunk ends on a visualization iteration."""

    it0: int
    chunk: int
    citers: int
    metrics: torch.Tensor
    state: TrainState
    pool: PoolState
    viz: Optional[tuple]
    interval: float


def iteration_seed(seed, it, rank=0):
    """The generator seed of iteration ``it`` under config seed ``seed`` on
    rank ``rank`` (rank 0's is the one-device run's)."""
    return ((int(seed) + 1) * _ITERATION_STRIDE + int(it) +
            int(rank) * _RANK_STRIDE) % (1 << 63)


class Trainer:
    """Training of one run, ``<model_root>/<cfg.name>``, on ``device``:
    ``train()`` runs the schedule, ``restore()`` resumes from a checkpoint.
    ``restore=True`` leaves the scripts backup and the log tee out, as the
    JAX trainer does.  ``num_devices``: the world size, None or 1 for one
    device; more joins the process group this process belongs to (formed by
    ``torchrun`` or ``parallel/launch.py``), which must be that size."""

    def __init__(self, cfg, restore=False, num_devices=None,
                 model_root='models', device='cuda'):
        self.cfg = cfg
        if cfg.gan not in ('w', 'ls'):
            raise ValueError('gan must be w or ls, got %r' % (cfg.gan,))
        if torch.device(device).type == 'cuda' and \
                not torch.cuda.is_available():
            raise RuntimeError(
                'Trainer runs on the card by default and no CUDA device is '
                'available; pass device=\'cpu\' to train on the host')
        self.mesh = data_parallel_mesh(num_devices, device=device)
        self.device = self.mesh.device
        self._print_lock = threading.Lock()
        self.n_fuse = int(cfg.get('iters_per_dispatch', 1))
        self.depth = max(0, int(cfg.get('dispatch_pipeline_depth', 2)))
        if self.n_fuse > 1:
            self.mesh.check_capturable()
        self.rank, self.world = self.mesh.rank, self.mesh.world
        if self.world > 1:
            local_batch_size(cfg.replay_memory_size, self.mesh)
            local_batch_size(cfg.batch_size, self.mesh)
        self.supervised = bool(cfg.get('supervised', False))
        self.dir = os.path.join(model_root, cfg.name)
        safe = cfg.name.replace('/', '-')
        self.image_dir = os.path.join(self.dir, 'images-' + safe)
        self.dump_dir = os.path.join(self.dir, 'dump-' + safe)
        self.tee = None
        if self.rank == 0:
            for d in (self.dir, self.image_dir, self.dump_dir):
                os.makedirs(d, exist_ok=True)
            if not restore:
                self.backup_scripts()
                self.tee = Tee(os.path.join(self.dir, 'log.txt'))
        if self.world > 1:
            self._say('# exposure_tpu_torch: %d-rank data-parallel world '
                      '(%s), training on %s' % (self.world, self.mesh.backend,
                                                self.device))
            # the providers draw from the global random module: alike on
            # every rank, so that each rank's shard is of the same batch
            random.seed(cfg.get('seed', 0))
        else:
            print('# exposure_tpu_torch: training on %s' % self.device)

        self.filters, self.policy, self.critic, self.value = \
            build_models(cfg)
        self.state = init_train_state(cfg, self.policy, self.critic,
                                      self.value, cfg.get('seed', 0),
                                      self.device)

        self.fake_provider = cfg.fake_data_provider()
        self.real_provider = cfg.real_data_provider()
        self.streaming = bool(cfg.get('stream_data', False))
        self.feeder, self._stream = None, None
        # a list to collect each bundle's assembly, upload and wait times
        # (``BundleFeeder.timings``), or None
        self.stream_timings = None
        if self.streaming:
            # host-assembled bundles a step (core/streaming.py)
            self.fake_images = self.real_images = None
            self.fake_meta = self.real_meta = None
        else:
            fake_pack = self._device_pack(self.fake_provider)
            real_pack = self._device_pack(self.real_provider)
            self.fake_meta = (fake_pack.output_size, fake_pack.augment)
            self.real_meta = (real_pack.output_size, real_pack.augment)
            self.fake_images, self.real_images = fake_pack.images, \
                real_pack.images

        pool_batch, _ = self.fake_provider.get_next_batch(
            cfg.replay_memory_size)
        if self.world > 1:
            self._check_alike('pool batch', digest(pool_batch))
            pool_batch = self.mesh.shard(np.asarray(pool_batch))
        pool_gt = None
        if self.supervised:
            # a paired provider yields [P, 2, S, S, C] (input, ground truth)
            pool_batch, pool_gt = pool_batch[:, 0], self._as_tensor(
                pool_batch[:, 1])
        self.pool = PoolState.create(self._as_tensor(pool_batch),
                                     cfg.num_state_dim, pool_gt)

        self._steps = {}
        # every iteration reseeds it (iteration_seed); a fused step's graph
        # holds it
        self._generator = torch.Generator(device=self.device)
        self._stream_group = self._stream_next = None
        self._logger = MetricLogger(os.path.join(
            self.dir, 'metrics.jsonl')) if self.rank == 0 else None
        self._metrics_last = None
        self._books = None
        self._lanes, self._futures, self._viz_self = None, [], None
        self._prof, self._prof_done = None, False

    def close(self):
        """Stop the streaming producer and the profiler, close the metrics
        file, stop teeing stdout into the log, free the fused runners' CUDA
        graphs and leave a process group the trainer
        formed."""
        self._close_stream()
        self._stop_profile()
        if self._logger is not None:
            self._logger.close()
            self._logger = None
        if self.tee is not None:
            self.tee.close()
            self.tee = None
        # a graph that captured an nccl all-reduce must go before its group
        for step in self._steps.values():
            if isinstance(step, FusedRunner):
                step.release()
        self.mesh.close()

    def _say(self, *args):
        """``print`` on rank 0, a line at a time (the lanes print too)."""
        if self.rank == 0:
            with self._print_lock:
                print(*args)

    def _check_alike(self, what, value):
        """Raise unless every rank drew the same ``what`` (its digest)."""
        if not self.mesh.all_equal(value):
            raise RuntimeError(
                'the ranks drew different %s: seed the providers alike on '
                'every rank' % what)

    def _device_pack(self, provider):
        """``provider``'s device pack: rank r's rows of it padded to a
        multiple of the world size, on this rank's device."""
        if self.world == 1:
            return provider.device_pack(self.device)
        pack = provider.device_pack('cpu')
        rows = self.mesh.shard(pad_to_devices(pack.images, self.world))
        return pack._replace(images=rows.to(self.device))

    def backup_scripts(self):
        """Snapshot the configs into the run dir, so that runs describe
        themselves: the JAX config modules found where the JAX trainer
        looks, and the port's config table."""
        script_dir = os.path.join(self.dir, 'scripts')
        os.makedirs(script_dir, exist_ok=True)
        from exposure_tpu_torch.utils import config
        candidates = [config.__file__]
        src = self.cfg.get('config_path', None)
        if src:
            candidates.append(src)
        here = os.getcwd()
        for d in (here, os.path.join(here, 'configs')):
            if os.path.isdir(d):
                for fn in os.listdir(d):
                    if fn.startswith('config_') and fn.endswith('.py'):
                        candidates.append(os.path.join(d, fn))
        for path in candidates:
            try:
                shutil.copy(path, script_dir)
            except (OSError, shutil.SameFileError):
                pass

    # ------------------------------------------------------------------
    def _get_step(self, giters, citers):
        key = (giters, citers)
        if key not in self._steps:
            if self.streaming:
                self._steps[key] = build_streaming_outer_step(
                    self.cfg, self.policy, self.critic, self.value,
                    self.filters, giters, citers, mesh=self.mesh)
            else:
                self._steps[key] = build_outer_step(
                    self.cfg, self.policy, self.critic, self.value,
                    self.filters, self.fake_meta, self.real_meta, giters,
                    citers, mesh=self.mesh)
        return self._steps[key]

    def _runner(self, giters, citers):
        """The fused step of ``(giters, citers)`` for this trainer's data
        path (``core/fused.py``), built once: one captured graph a runner,
        keyed as the JAX trainer keys its fused steps, with the path and
        the bundle's dtype (a chunk's metrics are a fresh buffer each)."""
        key = ('fused', giters, citers,
               'stream' if self.streaming else 'resident',
               str(self.cfg.get('stream_dtype', 'float32'))
               if self.streaming else None)
        if key not in self._steps:
            def draws_for(it):
                return self.iteration_draws(it, self._generator)
            cfg, nets = self.cfg, (self.policy, self.critic, self.value,
                                   self.filters)
            if self.streaming:
                self._steps[key] = build_streaming_fused_step(
                    cfg, *nets, giters, citers, draws_for, self._generator,
                    self.mesh)
            else:
                self._steps[key] = build_fused_iterations_step(
                    cfg, *nets, self.fake_meta, self.real_meta, giters,
                    citers, draws_for, self._generator, self.mesh)
        return self._steps[key]

    # --- streaming -----------------------------------------------------
    def stream_schedule(self, start):
        """The streaming run's bundles from iteration ``start`` on:
        ``(it, chunk, keys)`` for each group of iterations, ``keys`` the
        ``(giters, citers, n_iters)`` of its bundles in the order they are
        used.  A chunk of plain iterations takes one bundle.  Another
        iteration takes, as the JAX trainer dispatches it, its generator
        updates in bundles of the config's ``giters`` (the warmup:
        ``warmup_giters // giters`` of them), then its critic updates in
        bundles of the config's ``citers`` (a burst: ``critic_burst //
        citers``)."""
        cfg = self.cfg
        n_fuse = int(cfg.get('stream_iters_per_dispatch', 10))
        it = start
        while it <= cfg.max_iter_step:
            chunk = plan_fused_chunk(it, cfg, n_fuse, self.supervised)
            if chunk > 1:
                citers = 0 if self.supervised else cfg.citers
                keys = [(cfg.giters, citers, chunk)]
            else:
                n_g, n_c = self._stream_bundle_counts(*self.schedule(it)[:2])
                keys = [(cfg.giters, 0, 1)] * n_g + [(0, cfg.citers, 1)] * n_c
            yield it, chunk, keys
            it += chunk

    def _stream_bundle_counts(self, giters, citers):
        """The generator and critic bundles of a streaming iteration with
        ``giters`` and ``citers`` updates outside a chunk: bundles of the
        config's ``giters`` and ``citers``, at least one of each phase
        that runs, as the JAX trainer dispatches them."""
        cfg = self.cfg
        return (max(giters // cfg.giters, 1),
                max(citers // cfg.citers, 1) if citers > 0 else 0)

    def _stream_items(self, start):
        """What the producer makes, in the order it is used: each bundle,
        and after a group of iterations with a visualization its
        batches."""
        wii = self.cfg.get('write_image_interval', 0)
        for it, chunk, keys in self.stream_schedule(start):
            for key in keys:
                yield 'bundle', key
            for j in range(it, it + chunk):
                if wii and j % wii == 0:
                    yield 'call', self._viz_batches

    def _stream_groups(self, start):
        """For each group of iterations from ``start``: ``(it, chunk,
        bundles)``.  A chunk of plain iterations has its one bundle ``(g,
        r)``, the ``[chunk]`` axis first; another iteration (generator
        bundles, critic bundles), iterators of ``(g_fresh, real)`` taken
        from the producer when the step needs them."""
        feeder = self.feeder
        for it, chunk, keys in self.stream_schedule(start):
            if chunk > 1:
                yield it, chunk, feeder.next()
                continue
            n_g = sum(1 for k in keys if k[1] == 0)
            yield it, 1, ((feeder.next() for _ in range(n_g)),
                          (feeder.next() for _ in range(len(keys) - n_g)))

    def _stream_take(self, it, n):
        """The stream's group holding iteration ``it``, whose iterations
        ``it .. it + n - 1`` the caller takes; the producer restarts at
        ``it`` when the stream expects another iteration (a restore)."""
        if self._stream is None or it != self._stream_next:
            self._close_stream()
            self.feeder = BundleFeeder(
                self.cfg, self.supervised, self.fake_provider,
                self.real_provider, self._stream_items(it), self.device,
                slots=self.cfg.get('prefetch_slots', 2), mesh=self.mesh)
            self.feeder.timings = self.stream_timings
            self._stream = self._stream_groups(it)
        group = self._stream_group
        if group is None or it >= group[0] + group[1]:
            group = self._stream_group = next(self._stream)
        self._stream_next = it + n
        return group

    def _close_stream(self):
        if self.feeder is not None:
            self.feeder.close()
        self.feeder, self._stream, self._stream_group = None, None, None
        self._stream_next = None

    def schedule(self, it):
        """``(giters, citers, lr_g, lr_c)`` of iteration ``it``."""
        cfg = self.cfg
        if self.supervised:
            citers = 0      # no critic in supervised mode
        elif cfg.gan == 'w' and (it < cfg.critic_initialization or
                                 it % 500 == 0):
            citers = cfg.get('critic_burst', 100)
        else:
            citers = cfg.citers
        giters = cfg.get('warmup_giters', 100) if it == 0 else cfg.giters
        lr_g = 0.0 if it == 0 else cfg.lr_g(it)
        return giters, citers, lr_g, cfg.lr_c(it)

    def iteration_draws(self, it, generator):
        """The ``Draws`` of iteration ``it``: ``generator`` reseeded for it.
        Both phases draw from it, the generator's first."""
        generator.manual_seed(iteration_seed(self.cfg.get('seed', 0), it,
                                             self.rank))
        return Draws(generator, self.device)

    def run_iteration(self, it, generator):
        """One outer iteration: the generator phase, then the critic phase
        (each its own step, as the JAX loop dispatches them), with the
        generator reseeded for ``it`` and the schedule's scalars copied to
        the device in one piece.  Returns ``(citers, StepMetrics)`` and
        advances ``self.state``/``self.pool``."""
        giters, citers, lr_g, lr_c = self.schedule(it)
        draws = self.iteration_draws(it, generator)
        n_g, n_c = giters, citers
        if self.streaming:      # the updates its bundles hold
            n_g, n_c = self._stream_bundle_counts(giters, citers)
            n_g, n_c = n_g * self.cfg.giters, n_c * self.cfg.citers
        sc = step_scalars(self.cfg, self.state, n_g, n_c, lr_g, lr_c,
                          it / self.cfg.max_iter_step, self.device)
        if self.streaming:
            return self._run_streaming(it, draws, citers, sc)
        data = (self.fake_images, self.real_images)
        self.state, self.pool, metrics = self._get_step(giters, 0)(
            self.state, self.pool, *data, draws, scalars=sc)
        if citers > 0:
            self.state, self.pool, c_metrics = self._get_step(0, citers)(
                self.state, self.pool, *data, draws, scalars=sc)
            metrics = with_critic(metrics, c_metrics)
        self.state = self.state.replace(step=it + 1)
        return citers, metrics

    def _run_streaming(self, it, draws, citers, sc):
        """``run_iteration`` on the stream: a step for each bundle, the
        generator's then the critic's, the metrics of the last of each (as
        the JAX trainer's streaming dispatches give them); each step takes
        the scalars of its own updates."""
        it0, chunk, bundles = self._stream_take(it, 1)
        if chunk > 1:
            g, r = bundles
            j = it - it0
            g_bundles = [(g[j], r[j][:0])]
            c_bundles = [(g[j][:0], r[j])] if r.shape[1] else []
        else:
            g_bundles, c_bundles = bundles
        metrics, g_done, c_done = None, 0, 0
        for g_fresh, real in g_bundles:
            self.state, self.pool, metrics = self._get_step(
                g_fresh.shape[0], 0)(self.state, self.pool, g_fresh, real,
                                     draws, scalars=sc.after(g_done, 0))
            g_done += g_fresh.shape[0]
        for g_fresh, real in c_bundles:
            self.state, self.pool, c_metrics = self._get_step(
                0, real.shape[0])(self.state, self.pool, g_fresh, real,
                                  draws, scalars=sc.after(g_done, c_done))
            c_done += real.shape[0]
            metrics = with_critic(metrics, c_metrics)
        self.state = self.state.replace(step=it + 1)
        return citers, metrics

    # --- the fused chunks ----------------------------------------------
    def _plan(self, it, end):
        """How many iterations from ``it`` the next dispatch runs: a fused
        chunk when ``iters_per_dispatch`` is above 1 (resident: the JAX
        ``plan_fused_chunk`` of it; streaming: the rest of the bundle's
        chunk, planned with ``stream_iters_per_dispatch``), cut at
        ``end``; else 1."""
        if self.n_fuse <= 1:
            return 1
        if self.streaming:
            it0, chunk, _ = self._stream_take(it, 0)
            return min(it0 + chunk, end + 1) - it
        return min(plan_fused_chunk(it, self.cfg, self.n_fuse,
                                    self.supervised), end - it + 1)

    def _run_fused(self, it, chunk):
        """Iterations ``it .. it + chunk - 1``, plain, through the fused
        step (``core/fused.py``): resident on the packs, streaming on the
        slices of the bundle's chunk.  Returns ``(citers, metrics [chunk,
        7])`` and advances ``self.state``/``self.pool`` (the step's static
        buffers)."""
        cfg = self.cfg
        citers = 0 if self.supervised else cfg.citers
        runner = self._runner(cfg.giters, citers)
        if runner.graph is None and self.device.type == 'cuda':
            self._reap(wait=True)   # no lane job on the card while capturing
        iters = list(range(it, it + chunk))
        if self.streaming:
            it0, _, (g, r) = self._stream_take(it, chunk)
            data = (g[it - it0:it - it0 + chunk], r[it - it0:it - it0 + chunk])
        else:
            data = (self.fake_images, self.real_images)
        self.state, self.pool, metrics = runner.run(
            self.state, self.pool, data, iters, [cfg.lr_g(j) for j in iters],
            [cfg.lr_c(j) for j in iters],
            [j / cfg.max_iter_step for j in iters])
        self.state = self.state.replace(step=it + chunk)
        return citers, metrics

    # --- the loop ------------------------------------------------------
    def train(self, last_iter=None):
        """Run iterations ``state.step`` .. ``max_iter_step`` (or
        ``last_iter``, when it comes first: the schedule stays the full
        run's); returns the last iteration's metrics (floats).

        Each dispatch (a fused chunk or one iteration) leaves a record
        whose bookkeeping waits until ``dispatch_pipeline_depth`` later
        dispatches are queued, so that the metric read, the loop's one
        host synchronisation, overlaps the card's work; checkpoints and the
        grid are written on background lanes, from the chunk-end state and
        pool the record holds (cloned where the fused step's buffers would
        be overwritten), so they are what unpipelined bookkeeping
        writes."""
        cfg = self.cfg
        end = cfg.max_iter_step if last_iter is None else min(
            last_iter, cfg.max_iter_step)
        if self._books is None:     # kept across calls of one Trainer
            self._books = {
                'g': MedianWindow(cfg.median_filter_size),
                'v': MedianWindow(cfg.median_filter_size),
                'emd': MedianWindow(cfg.median_filter_size),
                'start_t': time.time(), 'start_iter': self.state.step,
                'timed_iters': 0, 'timed_secs': 0.0, 'first_skipped': False,
                'ms': 0.0}
        books = self._books
        books['last_t'] = time.time()
        pending = collections.deque()
        lanes = {'ckpt': concurrent.futures.ThreadPoolExecutor(1),
                 'viz': concurrent.futures.ThreadPoolExecutor(1)}
        self._lanes = lanes
        try:
            it = self.state.step
            while it <= end:
                self._profile(it)
                chunk = self._plan(it, end)
                if chunk > 1:
                    citers, metrics = self._run_fused(it, chunk)
                else:
                    citers, metrics = self.run_iteration(
                        it, self._generator)
                    metrics = torch.stack(list(metrics))[None]
                now = time.time()
                pending.append(ChunkRecord(
                    it, chunk, citers, metrics,
                    *self._kept(it, chunk), now - books['last_t']))
                books['last_t'] = now
                while len(pending) > self.depth:
                    self._process_chunk(pending.popleft(), books)
                self._reap()
                it += chunk
            while pending:
                self._process_chunk(pending.popleft(), books)
        finally:
            self._lanes = None
            for lane in lanes.values():
                lane.shutdown(wait=True)
            self._stop_profile()
        self._reap(wait=True)
        return self._metrics_last

    def _kept(self, it, chunk):
        """What a record keeps of the dispatch of ``it .. it + chunk - 1``:
        the state and the pool at its end, cloned when they are the fused
        step's buffers and a checkpoint or the grid will read them, and the
        grid's batches, drawn now (a streaming producer makes them in the
        schedule's order)."""
        cfg = self.cfg
        wii = cfg.get('write_image_interval', 0)
        viz = None
        if wii and any(j % wii == 0 for j in range(it, it + chunk)):
            viz = self.feeder.next() if self.streaming \
                else self._viz_batches()
        state, pool = self.state, self.pool
        ckpt = (it + chunk) % cfg.get('checkpoint_interval', 500) == 0
        if chunk > 1 and (ckpt or viz is not None):
            state, pool = state.clone(), clone_pool(pool)
        return state, pool, viz

    def _lane(self, name, fn, *args):
        """Run ``fn(*args)`` on the background lane ``name`` (``ckpt`` or
        ``viz``, one worker each, in order) inside ``train``; at once
        outside it."""
        if self._lanes is None:
            fn(*args)
            return
        self._futures.append(self._lanes[name].submit(fn, *args))

    def _reap(self, wait=False):
        """Raise the error of a lane job that failed; with ``wait``, wait
        for every job first."""
        for f in list(self._futures):
            if wait or f.done():
                self._futures.remove(f)
                f.result()

    def _profile(self, it):
        """Rank 0 traces iterations ``PROFILE_START``..``PROFILE_STOP`` into
        ``cfg.profile_dir`` (once a trainer), as the JAX trainer does."""
        profile_dir = self.cfg.get('profile_dir', None)
        if not profile_dir or self.rank != 0 or self._prof_done:
            return
        if self._prof is None and it >= PROFILE_START:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    profile_dir))
            self._prof.start()
            self._say('# profiling iterations %d-%d into %s'
                      % (it, PROFILE_STOP, profile_dir))
        elif self._prof is not None and it > PROFILE_STOP:
            self._stop_profile()

    def _stop_profile(self):
        """Stop the trace, which writes it."""
        if self._prof is not None:
            prof, self._prof = self._prof, None
            self._prof_done = True
            prof.stop()

    def _process_chunk(self, rec, books):
        """Bookkeeping of one dispatch: the metric read (one host sync),
        the NaN guard naming the chunk's iterations, the wall ms an
        iteration (the chunks' intervals, the first left out), each
        iteration's record, then a checkpoint (every
        ``checkpoint_interval``) and the grid (every
        ``write_image_interval``) at the chunk's end, from the record's
        state and pool."""
        cfg = self.cfg
        it_end = rec.it0 + rec.chunk - 1
        rows = rec.metrics.cpu().tolist()
        self._metrics_last = StepMetrics(*rows[-1])
        if not np.isfinite(np.asarray(rows)).all():
            # the metrics are averaged: every rank stops here.  After a
            # fused chunk that is not the last one dispatched, its state is
            # the fused step's buffers, up to ``dispatch_pipeline_depth``
            # chunks on
            dump = save_checkpoint(self.dir, rec.state, it_end, keep=10) \
                if self.rank == 0 else 'rank 0'
            raise FloatingPointError(
                'non-finite training metrics in iterations [%d, %d]: %s '
                '(state dumped at %s)' % (rec.it0, it_end, rows, dump))
        if books['first_skipped']:
            books['timed_iters'] += rec.chunk
            books['timed_secs'] += rec.interval
        else:
            books['first_skipped'] = True
        books['ms'] = 1000.0 * books['timed_secs'] / max(
            books['timed_iters'], 1)
        for i, row in enumerate(rows):
            self._process_record(rec.it0 + i, rec.citers, StepMetrics(*row),
                                 books)
        if (it_end + 1) % cfg.get('checkpoint_interval', 500) == 0:
            # keep=2: the newest file can hold the update that diverged
            # before the guard saw it; the one before is a good restore
            if self.world > 1:
                # the barrier follows the write, on this thread
                if self.rank == 0:
                    self._save(rec.state, it_end + 1)
                self.mesh.barrier()
            else:
                self._lane('ckpt', self._save, rec.state, it_end + 1)
        if rec.viz is not None:
            raw, real_imgs = rec.viz
            pool = self._gathered_pool(rec.pool)
            if self.rank == 0:
                self._lane('viz', self._draw, it_end, rec.state, pool, raw,
                           real_imgs)

    def _process_record(self, it, citers, m, books):
        """Bookkeeping of one iteration's metrics (floats): the log line and
        ``metrics.jsonl`` every 10th iteration, a summary every 100th."""
        cfg = self.cfg
        ms = books['ms']
        if it % 10 == 0:
            warn = pool_health_warning(citers, self.supervised,
                                       m.pool_terminated_frac)
            if warn:
                self._say('# WARNING (it %d): %s' % (it, warn))
            books['g'].add(m.g_loss)
            books['v'].add(m.v_loss)
            books['emd'].add(m.emd)
            self._say('it%6d,%5.0f ms/it, g_loss=%.2f, v_loss=%.2f, EMD=%.3f, '
                      'cgn=%.2f' % (it, ms, books['g'].median(),
                                    books['v'].median(),
                                    books['emd'].median(),
                                    m.critic_gradient_norm))
            if self._logger is not None:
                self._logger.log(
                    it, g_loss=m.g_loss, v_loss=m.v_loss, emd=m.emd,
                    cgn=m.critic_gradient_norm, reward=m.reward,
                    pool_avg_traj=m.pool_avg_trajectory,
                    pool_term_frac=m.pool_terminated_frac, ms_per_iter=ms)
        if it % 100 == 0:
            elapsed = time.time() - books['start_t']
            eta = elapsed / (it - books['start_iter'] + 1) / 3600 * (
                cfg.max_iter_step - it)
            self._say('#--------------------------------------------')
            self._say('# Task: %s  ela. %.2f min  ETA: %.1f h'
                      % (cfg.name, elapsed / 60.0, eta))
            self._say('# Replay pool: avg. traj. %.2f, terminated %.0f%%'
                      % (m.pool_avg_trajectory, 100 * m.pool_terminated_frac))

    def _save(self, state, step):
        path = save_checkpoint(self.dir, state, step, keep=2)
        self._say('# checkpoint saved:', path)

    def _draw(self, it, state, pool, raw, real_imgs):
        """The grid of iteration ``it``, on the viz lane: drawn by a copy
        of this trainer with networks of its own (``functional_call`` puts
        the parameters it is given into the module for the call, so two
        threads must not share one)."""
        if self._viz_self is None:
            view = copy.copy(self)
            view.policy, view.critic, view.value = copy.deepcopy(
                (self.policy, self.critic, self.value))
            self._viz_self = view
        try:
            self._viz_self.visualize(it, state=state, pool=pool, raw=raw,
                                     real_imgs=real_imgs)
        except Exception as e:  # viz must never kill training
            self._say('# visualization failed:', e)

    def _gathered_pool(self, pool):
        """The pool the grid shows: the first rows of the global pool, as
        the JAX trainer's gathered pool gives them (rank 0; None on the
        others)."""
        if self.world == 1:
            return pool
        n = min(self.cfg.num_samples, 16)
        rows = self.mesh.gather_rows(pool.images[:n])
        return None if rows is None else PoolState.create(
            rows[:n], self.cfg.num_state_dim)

    # ------------------------------------------------------------------
    def restore(self, ckpt=None):
        """Every rank restores checkpoint ``ckpt`` (the newest: None)."""
        self.state, step = restore_checkpoint(self.dir, self.state, ckpt)
        self._say('# restored checkpoint at step', step)
        return step

    def latest_checkpoint(self):
        return latest_checkpoint_step(self.dir)

    # ------------------------------------------------------------------
    def _policy(self, state):
        params = state.gen_params
        return lambda x, g: apply(self.policy, params, x, g)

    def _as_tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    @torch.no_grad()
    def run_rollout(self, images, generator=None, is_train=None,
                    num_steps=None, state=None):
        """A K-step rollout (``core/rollout.py::rollout``) of a host batch
        with the current policy weights."""
        cfg = self.cfg
        if is_train is None:
            is_train = int(cfg.test_random_walk)
        state = self.state if state is None else state
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return rollout(self._policy(state), self._as_tensor(images),
                       generator, cfg=cfg, filters=self.filters,
                       is_train=is_train,
                       num_steps=num_steps or cfg.test_steps)

    @torch.no_grad()
    @tf32_off()
    def critic_scores(self, images, state=None):
        """Critic logits of a host batch, centred by the EMA of the mean
        logit."""
        state = self.state if state is None else state
        logits = apply(self.critic, state.crit_params,
                       self._as_tensor(images))[:, 0]
        return (logits - state.ema.value).cpu().numpy()

    @torch.no_grad()
    @tf32_off()
    def state_values(self, images, states, state=None):
        """V(s) of host batches."""
        state = self.state if state is None else state
        return apply(self.value, state.val_params, self._as_tensor(images),
                     self._as_tensor(states))[:, 0].cpu().numpy()

    @tf32_off()
    def critic_gradients(self, images, state=None):
        """Per-pixel d(critic logit)/d(image), display-scaled: ``10 * grad
        + 0.5`` clipped to [0, 1]."""
        state = self.state if state is None else state
        x = self._as_tensor(images).requires_grad_(True)
        grads, = torch.autograd.grad(
            apply(self.critic, state.crit_params, x).sum(), x)
        return np.clip(10.0 * grads.cpu().numpy() + 0.5, 0, 1)

    def _viz_batches(self):
        n = min(self.cfg.num_samples, 16)
        raw, _ = self.fake_provider.get_next_batch(n)
        if self.supervised:
            raw = raw[:, 0]
        real_imgs, _ = self.real_provider.get_next_batch(n)
        return raw, real_imgs

    def visualize(self, it, state=None, pool=None, raw=None,
                  real_imgs=None):
        """Write the visualization grid ``<images dir>/<it>.png``: rollout
        trajectories with per-step decision and operation panels on top;
        pool, generated and real samples with critic-score stamps below."""
        from exposure_tpu_torch.utils.viz import (
            draw_mask_panel,
            draw_score,
            draw_step_panels,
            draw_value_reward_score,
        )
        cfg = self.cfg
        state = self.state if state is None else state
        pool = self.pool if pool is None else pool
        n = min(cfg.num_samples, 16)
        if raw is None or real_imgs is None:
            raw, real_imgs = self._viz_batches()
        traj = self.run_rollout(
            raw, generator=torch.Generator(device=self.device).manual_seed(
                int(it)), state=state)
        steps = traj.images.cpu().numpy()           # [K, n, S, S, C]
        k_steps = steps.shape[0]
        flat = steps.reshape((-1,) + steps.shape[2:])

        def score(x):
            return self.critic_scores(x, state) if len(x) else \
                np.zeros((0,), np.float32)

        grad_imgs = self.critic_gradients(flat, state).reshape(steps.shape)
        scores = score(flat).reshape((k_steps, -1))
        values = self.state_values(
            flat, traj.states.reshape(-1, cfg.num_state_dim).cpu().numpy(),
            state).reshape((k_steps, -1))
        in_scores = score(raw)

        ids = traj.filter_ids.cpu().numpy()
        pdfs = traj.pdfs.cpu().numpy()
        params = traj.params.cpu().numpy()
        mask_params = traj.mask_params.cpu().numpy()
        rows = []
        for b in range(min(n, 4)):
            img_row = [np.asarray(raw[b])]
            for k in range(k_steps):
                prev = in_scores[b] if k == 0 else scores[k - 1, b]
                reward = (scores[k, b] - prev) * cfg.critic_logit_multiplier
                img_row.append(draw_value_reward_score(
                    steps[k, b], values[k, b], reward, scores[k, b],
                    cfg.gan))
            blank = np.ones_like(img_row[0])
            grad_row = [blank] + [grad_imgs[k, b] for k in range(k_steps)]
            dec_row, op_row = [blank], [blank]
            mask_row = [blank] if cfg.masking else None
            for k in range(k_steps):
                fid = int(ids[k, b])
                nparam = self.filters[fid].get_num_filter_parameters()
                dbg = {'pdf': pdfs[k, b], 'filter_id': fid,
                       'filter_parameters': params[k, b][:nparam]}
                dec, op = draw_step_panels(self.filters, dbg,
                                           size=img_row[0].shape[0])
                dec_row.append(dec)
                op_row.append(op)
                if mask_row is not None:
                    step_input = np.asarray(raw[b]) if k == 0 \
                        else steps[k - 1, b]
                    mask_row.append(draw_mask_panel(
                        self.filters[fid], step_input, mask_params[k, b]))

            def hcat(row):
                return np.hstack([np.pad(r, ((1, 1), (1, 1), (0, 0)),
                                         constant_values=1.0) for r in row])
            panel_rows = [hcat(img_row), hcat(grad_row), hcat(dec_row),
                          hcat(op_row)]
            if mask_row is not None:
                panel_rows.append(hcat(mask_row))
            rows.append(np.vstack(panel_rows))
        upper = np.vstack(rows)

        pool_imgs = pool.images[:n].cpu().numpy()
        final = steps[-1]
        per_row = 8

        def grid(x):
            x = np.asarray(x)[:per_row * (len(x) // per_row)]
            if len(x) == 0:
                return None
            if cfg.vis_draw_critic_scores:
                x = np.stack([draw_score(im, s, cfg.gan)
                              for im, s in zip(x, score(x))])
            return make_image_grid(x, per_row=per_row)

        lower = np.vstack([g for g in (grid(pool_imgs), grid(final),
                                       grid(real_imgs)) if g is not None])
        w = max(upper.shape[1], lower.shape[1])

        def padw(x):
            return np.pad(x, ((0, 0), (0, w - x.shape[1]), (0, 0)),
                          constant_values=1.0)
        img = np.vstack([padw(upper), np.ones((8, w, 3), np.float32),
                         padw(lower)])
        path = os.path.join(self.image_dir, '%06d.png' % it)
        write_image(path, np.clip(img, 0, 1))
        if cfg.get('realtime_vis', False):
            _show_realtime(img, 'exposure_tpu_torch: ' + cfg.name)
        return path
