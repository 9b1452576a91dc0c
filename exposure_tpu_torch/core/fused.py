"""The fused N-iteration training dispatch (torch counterpart of
``exposure_tpu/core/steps.py::build_fused_iterations_step`` and
``build_streaming_fused_step``).

The JAX trainer compiles N plain outer iterations into one ``lax.scan``
dispatch, bit for bit the iterations dispatched one by one.  Here a chunk
is a CUDA graph of ONE plain outer iteration (the generator step, then the
critic step, as ``Trainer.run_iteration`` dispatches them, all-reduces
included under ``nccl``), replayed N times back to back: one launch a
replay where the eager iteration makes thousands.

Why one iteration and not N: iteration ``it`` draws from a generator
reseeded from ``(seed, it, rank)`` (``core/trainer.py::iteration_seed``),
which is how a resumed run and each rank draw what an uninterrupted run
draws.  The graph is captured with the generator registered
(``CUDAGraph.register_generator_state``), and a replay reads the
generator's seed and offset when it starts, so ``manual_seed`` before
replay i makes it draw what the eager iteration ``it + i`` draws.

What a graph would freeze, and where it went:

- the learning rates, the progress and every update's Adam bias
  corrections: one static device vector (``steps.StepScalars``), filled
  before each replay from the chunk's rows, which the host forms in
  float32 and copies to the device once a chunk;
- Adam's and the EMA's counts: host ints, advanced here by ``giters`` and
  ``citers`` a replay;
- the state and the pool: static buffers, which the captured body
  overwrites at its end (``copy_`` inside the graph); after a chunk the
  caller's state and pool are these buffers, so a caller that keeps one
  across chunks clones it;
- a streaming bundle: static input buffers, filled from the chunk's slice
  i before replay i (u8 bundles are dequantized inside the body);
- the metrics: a static row, copied into the chunk's ``[N, 7]`` after each
  replay (a fresh tensor a chunk, so a deferred read is never overwritten).

On the card the first chunk of a runner runs its first iteration eagerly
on a side stream (the warm-up, which lets cuBLAS, cuDNN and NCCL set up
outside the capture, and is a real iteration of the chunk), then captures
the next one; a capture that fails raises, and nothing falls back to the
eager step.  On the CPU the same static-buffer body runs eagerly, iteration
after iteration.

With tracing on (``utils/trace.py``) a chunk is the host range
``fused.run``, holding ``fused.table`` (the scalars' copy), and per
iteration ``fused.draws`` (the reseed and the scalars' row),
``fused.capture`` or ``fused.replay``, and ``fused.metrics``; the body's
device regions are ``core/steps.py``'s.
"""

import dataclasses

import torch

from exposure_tpu_torch.core.replay import PoolState
from exposure_tpu_torch.core.train_state import EmaState
from exposure_tpu_torch.utils import trace


def to_device(rows, device):
    """A float32 tensor of ``rows`` on ``device``: on the card copied from
    pinned memory without a wait."""
    host = torch.tensor(rows, dtype=torch.float32)
    device = torch.device(device)
    if device.type != 'cuda':
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _pool_tensors(pool):
    return [pool.images, pool.states] + (
        [] if pool.ground_truth is None else [pool.ground_truth])


def clone_pool(pool):
    """A copy of ``pool`` with every tensor cloned."""
    return PoolState(images=pool.images.clone(), states=pool.states.clone(),
                     ground_truth=None if pool.ground_truth is None
                     else pool.ground_truth.clone())


def advanced(state, g_updates, c_updates):
    """``state`` with Adam's counts moved on by ``g_updates`` generator
    (and value) and ``c_updates`` critic updates, and the EMA's by the
    critic's."""
    def adam(opt, n):
        return dataclasses.replace(opt, count=opt.count + n)
    return state.replace(opt_g=adam(state.opt_g, g_updates),
                         opt_v=adam(state.opt_v, g_updates),
                         opt_c=adam(state.opt_c, c_updates),
                         ema=EmaState(state.ema.biased,
                                      state.ema.count + c_updates))


def _with_counts(state, counts):
    """``state``'s tensors with ``counts``' Adam and EMA counts and step."""
    def adam(opt, like):
        return dataclasses.replace(opt, count=like.count)
    return state.replace(opt_g=adam(state.opt_g, counts.opt_g),
                         opt_v=adam(state.opt_v, counts.opt_v),
                         opt_c=adam(state.opt_c, counts.opt_c),
                         ema=EmaState(state.ema.biased, counts.ema.count),
                         step=counts.step)


class FusedRunner:
    """N plain outer iterations of fixed ``(giters, citers)`` on static
    buffers: replayed as a CUDA graph on the card, run eagerly on the CPU.

    ``body(state, pool, data, draws, scalars) -> (state, pool,
    StepMetrics)`` is one plain iteration; ``row(state, lr_g, lr_c,
    progress)`` the host values of its ``StepScalars`` (``width`` of them)
    from ``state``'s counts, and ``scalars(vec)`` views a device vector of
    them; ``draws_for(it)`` reseeds
    ``generator`` for iteration ``it`` and returns its ``Draws`` (on the
    card they must draw from ``generator``, the one the graph holds).
    ``stacked``: the data is a streaming bundle, one slice an iteration;
    otherwise the same tensors (the packs) every iteration.  ``mesh``: the
    ranks the body averages over, which must allow a capture on the card
    (``Mesh.check_capturable``)."""

    def __init__(self, body, row, scalars, width, giters, citers, draws_for,
                 generator=None, stacked=False, mesh=None):
        self.body, self.row, self.scalars = body, row, scalars
        self.width, self.giters, self.citers = width, giters, citers
        self.draws_for, self.generator = draws_for, generator
        self.stacked, self.mesh = stacked, mesh
        self.device = None
        self.graph = None
        self.captures = 0       # graphs captured (one a runner)
        self.replays = 0        # iterations run as a replay
        self._state = self._pool = self._data = None

    @property
    def graphs(self):
        return self.device is not None and self.device.type == 'cuda'

    # --- the static buffers ------------------------------------------------
    def _load(self, state, pool, data):
        """Make ``state``, ``pool`` and the resident ``data`` the static
        buffers' contents (copied where they are other tensors)."""
        if self._state is None:
            self.device = pool.images.device
            if self.graphs:
                if self.generator is None or \
                        self.generator.device.type != 'cuda':
                    raise ValueError('a fused step on the card needs the '
                                     'CUDA generator its draws come from')
                if self.mesh is not None:
                    self.mesh.check_capturable()
            self._state, self._pool = state.clone(), clone_pool(pool)
            self._vec = torch.zeros(self.width, dtype=torch.float32,
                                    device=self.device)
            self._metrics = torch.zeros(7, dtype=torch.float32,
                                        device=self.device)
            if self.stacked:
                self._data = tuple(torch.empty_like(x[0]) for x in data)
            else:
                self._data = tuple(data)
            return
        self._copy_in(state, pool)
        if not self.stacked and any(a is not b
                                    for a, b in zip(data, self._data)):
            if self.graph is not None:
                raise ValueError('the graph was captured on other packs')
            self._data = tuple(data)

    def _store(self, state, pool, metrics):
        """The body's new state, pool and metrics into the static
        buffers (inside the graph on the card)."""
        self._copy_in(state, pool)
        self._metrics.copy_(torch.stack(list(metrics)))

    def _copy_in(self, state, pool):
        """Copy ``state``'s and ``pool``'s tensors into the static ones,
        path by path, where they are other tensors."""
        src = state.tensors()
        pairs = [(src[k], dst) for k, dst in self._state.tensors().items()]
        pairs += list(zip(_pool_tensors(pool), _pool_tensors(self._pool)))
        for a, b in pairs:
            if a is not b:
                b.copy_(a)

    def _iterate(self, draws):
        state, pool, metrics = self.body(self._state, self._pool, self._data,
                                         draws, self.scalars(self._vec))
        self._store(state, pool, metrics)

    # --- the graph ---------------------------------------------------------
    def _warm_up_and_capture(self, draws):
        """Run this iteration eagerly on a side stream, then capture the
        body with the generator registered.  Raises if the capture
        fails."""
        if draws.generator is not self.generator:
            raise ValueError('the graph draws from the runner\'s generator; '
                             'draws_for handed another')
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._iterate(draws)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        # thread_local: the streaming producer's thread may wait on its own
        # copies' events while this thread captures
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode='thread_local'):
            self._iterate(draws)
        self.graph = graph
        self.captures += 1

    def release(self):
        """Free the captured graph (a later chunk captures anew); the
        counts stay."""
        self.graph = None

    # --- a chunk -----------------------------------------------------------
    def run(self, state, pool, data, iters, lr_gs, lr_cs, progresses):
        """Iterations ``iters`` at their learning rates and progresses from
        ``state`` and ``pool``; ``data``: the packs ``(fake, real)``, or a
        streaming bundle ``(g_fresh [N, giters, ...], real [N, citers,
        ...])``.  Returns ``(state, pool, metrics [N, 7])``: the state and
        pool are the static buffers, the metrics one row an iteration in
        ``StepMetrics``' order."""
        with trace.span('fused.run'):
            n = len(iters)
            self._load(state, pool, data)
            counts, rows = state, []
            for i in range(n):
                rows.append(self.row(counts, lr_gs[i], lr_cs[i],
                                     progresses[i]))
                counts = advanced(counts, self.giters, self.citers)
            with trace.span('fused.table'):
                table = to_device(rows, self.device)
            metrics = torch.empty((n, 7), dtype=torch.float32,
                                  device=self.device)
            for i, it in enumerate(iters):
                with trace.span('fused.draws'):
                    draws = self.draws_for(int(it))
                    self._vec.copy_(table[i])
                if self.stacked:
                    for dst, src in zip(self._data, data):
                        dst.copy_(src[i])
                if not self.graphs:
                    self._iterate(draws)
                elif self.graph is None:
                    with trace.span('fused.capture'):
                        self._warm_up_and_capture(draws)
                else:
                    with trace.span('fused.replay'):
                        self.graph.replay()
                    self.replays += 1
                with trace.span('fused.metrics'):
                    metrics[i].copy_(self._metrics)
            done = _with_counts(self._state, counts)
            return done, self._pool, metrics
