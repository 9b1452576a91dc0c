"""Serving: the batch retouching pipeline (torch counterpart of
``exposure_tpu/core/serving.py``).

Per batch: scale the [B, H, W, 3] images to [0, 1] and resize them to the
64x64 proxy (``proxy``), plan a 5-step trajectory on the proxy with the
policy (``plan``), then replay the [K, B] ids and [K, B, P] params on the
full-resolution batch (``replay``).  uint8 input gives uint8 output;
float32 input is the linear [0, 1] domain.

The pipeline runs on the card (``device='cuda'``) unless the caller asks
for the CPU (``device='cpu'``, as the tests do); without a GPU the default
raises rather than serving on the host.

Modes, resolved from the constructor's knobs as the JAX pipeline resolves
them (``use_kernels`` stands for its ``use_pallas`` and defaults to
whether the device is a GPU):

- dynamic (the default with kernels): one replay launch of the dynamic
  chain (K1) for any action mix; with ``selected_plan`` (its default) the
  plan advances the proxy through the selected branch only
  (``serve_rollout``), otherwise through the 8-candidate bank
  (``rollout``, the training formulation);
- switch (``dynamic=False, grouped=False``): the bank plan replayed
  through the switch chain (K2);
- grouped (``grouped=True``): the bank plan replayed by
  ``GroupedChainRunner``, one static-chain (K3) launch per signature group
  and K2 for merges and fallbacks; ``warmup(superset=True)`` or
  ``freeze_superset`` freeze a (signature, bucket) layout, and
  ``auto_superset`` records, freezes and re-freezes one from the traffic;
- without kernels: the bank plan replayed by the branchless chain on the
  full-resolution float32 input.

With ``use_kernels=True`` on the CPU every mode runs its kernels' plain
versions.  ``bf16`` runs the plan in bfloat16 (a bfloat16 copy of the
policy, the proxy cast); the replay parameters are cast back to float32.

Dropout stays on at serving, as in the reference: each batch draws it from
a ``torch.Generator`` on the device seeded from (seed, batch index), so a
batch's output is a function of its images, the seed and its index, in
every mode.

One program a batch (``graphs``, on by default on the card): a dynamic or
switch batch (proxy, plan and replay; the JAX ``_single_jit``) and a
grouped batch's plan (the JAX ``_plan_for``) are each captured once per
input shape and dtype as a CUDA graph and replayed
(``core/serving_graph.py``), bit for bit the per-call path, which
``graphs=False`` keeps.  The grouped replay stays per call: it groups the
ids on the host, as in JAX.  A graph's outputs are overwritten by its next
replay, so the pipeline hands out copies.  At most ``MAX_GRAPHS`` graphs
are kept (``release()`` frees them).

Tracing (``utils/trace.py``, off by default): the three parts are the
device regions ``serve.resize``, ``serve.plan`` and ``serve.replay`` in
every mode, so a batch graph captured with tracing on stamps them at every
replay; a call is the host range ``serve.call`` and its hand-out
``serve.deliver`` (the graph's own ranges: ``core/serving_graph.py``).

>>> pipe = RetouchPipeline.from_artifact(
...     'synthetic_explore',
...     'artifacts/serving/synthetic_explore--best.msgpack.gz')
>>> out_u8 = pipe(images_u8)           # [B, H, W, 3] uint8 numpy array
>>> on_card = pipe(images_u8, device_out=True)   # the tensor, no copy
>>> cpu = RetouchPipeline.from_artifact(
...     'synthetic_explore',
...     'artifacts/serving/synthetic_explore--best.msgpack.gz',
...     device='cpu')                  # the plain versions, on the host
"""

import collections
import copy
import time

import numpy as np
import torch
import torch.nn.functional as F

from exposure_tpu_torch.core.artifacts import (
    flax_to_state_dict,
    load_artifact,
    restore_for_serving,
)
from exposure_tpu_torch.core.rollout import rollout, serve_rollout
from exposure_tpu_torch.core.serving_graph import GraphCache
from exposure_tpu_torch.models.networks import build_policy
from exposure_tpu_torch.ops.chain import apply_filter_chain
from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
from exposure_tpu_torch.ops.filters import build_filters, max_filter_parameters
from exposure_tpu_torch.ops.grouped_chain import GroupedChainRunner, bucket_size
from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
from exposure_tpu_torch.utils import trace
from exposure_tpu_torch.utils.config import load_config

# Distinct batches of one seed get distinct dropout streams; the stride is
# a large odd number so (seed, index) pairs do not collide in practice.
_SEED_STRIDE = 0x9E3779B1

# Graphs a pipeline keeps.  Each one's pool holds, at B=512 of 512x512 u8,
# the static input and output (0.4 GB each), the f32 copy of the batch that
# the resize reads (1.61 GB) and the proxy's activations: a few GB a graph,
# so a handful of shapes stays a small share of the card.
MAX_GRAPHS = 4


def batch_seed(seed, index):
    """The dropout seed of batch ``index`` under ``seed``."""
    return (int(seed) * _SEED_STRIDE + int(index)) % (2 ** 63)


def batch_generator(seed, index, device):
    """The dropout generator of batch ``index`` under ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(batch_seed(seed, index))
    return g


def proxy_resize(images, size):
    """[B, H, W, 3] uint8 or float32 -> [B, size, size, 3] float32 proxy:
    scale to [0, 1], then antialiased bilinear resize (matches
    ``jax.image.resize(..., 'linear')``)."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x * (1.0 / 255.0)
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode='bilinear', antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1).contiguous()


def _deliver(out, device_out):
    """A replay's output as the caller asked for it: the device tensor, or
    a numpy array on the host."""
    with trace.span('serve.deliver'):
        return out if device_out else out.cpu().numpy()


def _deliver_static(out, device_out):
    """A graph's output, which its next replay overwrites, as the caller
    asked for it: a copy on the device, or a numpy array on the host."""
    with trace.span('serve.deliver'):
        return out.clone() if device_out else \
            out.to('cpu', copy=True).numpy()


class RetouchPipeline:

    def __init__(self, cfg, policy, device='cuda', run=None, step=None,
                 use_kernels=None, bf16=False, grouped=None, fast_math=True,
                 fused_set_limit=None, dynamic=None, selected_plan=None,
                 auto_superset=False, auto_record_batches=8,
                 auto_drift_window=8, auto_drift_threshold=1.0 / 16.0,
                 graphs=None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                'RetouchPipeline runs on the card by default and no CUDA '
                'device is available; pass device=\'cpu\' to serve the '
                'plain versions on the host')
        self.filters = build_filters(cfg)
        self.policy = policy.to(self.device).eval()
        self.masking = bool(cfg.masking)
        self.run, self.step = run, step   # where the weights came from
        if use_kernels is None:
            use_kernels = self.device.type == 'cuda'
        self.use_kernels = bool(use_kernels)
        self.bf16 = bool(bf16)
        self._plan_policy = self._bf16_copy() if self.bf16 else self.policy
        self.fast_math = fast_math
        if dynamic and grouped:
            raise ValueError('dynamic and grouped are exclusive modes')
        if dynamic is None:
            dynamic = self.use_kernels and not bool(grouped) \
                and not bool(auto_superset)
        self.dynamic = bool(dynamic) and self.use_kernels
        if grouped is None:
            grouped = self.use_kernels and not self.dynamic
        self.grouped = bool(grouped) and self.use_kernels \
            and not self.dynamic
        if selected_plan is None:
            selected_plan = self.dynamic
        self.selected_plan = bool(selected_plan) and self.dynamic
        runner_kw = {}
        if fused_set_limit is not None:
            runner_kw['fused_set_limit'] = fused_set_limit
        self._runner = GroupedChainRunner(
            self.filters, fast_math=fast_math, **runner_kw) \
            if self.grouped else None
        # frozen (signature, bucket) layout for call_superset replay
        self._superset_layout = None
        # auto superset: record the traffic's (signature, count) stats for
        # auto_record_batches batches, freeze a layout from them, then
        # watch the fraction of rows each batch sends to the K2 merge
        # (missing signature or slot overflow); when its mean over
        # auto_drift_window batches passes auto_drift_threshold, re-freeze
        # from the stats gathered since the last freeze
        self._ss_auto = bool(auto_superset) and self.grouped
        self._ss_record_batches = int(auto_record_batches)
        self._ss_window = int(auto_drift_window)
        self._ss_threshold = float(auto_drift_threshold)
        self._ss_stats = {}
        self._ss_seen = 0
        self._ss_refreezes = 0
        self._ss_drift = collections.deque(maxlen=self._ss_window)
        # one program a batch: on by default on the card (FusedRunner's
        # rule); graphs=False is the per-call path
        self.graphs = self.device.type == 'cuda' if graphs is None \
            else bool(graphs)
        self._graphs = GraphCache(MAX_GRAPHS)

    def _bf16_copy(self):
        return copy.deepcopy(self.policy).to(torch.bfloat16)

    def load_policy(self, state_dict, run=None, step=None):
        """Serve other weights from the next batch on, the counterpart of
        assigning the JAX pipeline's ``state``: ``state_dict`` (a
        ``PolicyNet``'s) is copied into ``policy``'s tensors, and with
        ``bf16`` into the plan's bfloat16 copy (rounded as the constructor's
        ``.to(torch.bfloat16)`` rounds), in place: the captured graphs read
        those tensors, so they serve the new weights without a new capture.
        The mode, the superset layout and the auto-superset statistics
        stay, so a policy with another action mix drifts from the frozen
        layout and re-freezes it."""
        self.policy.load_state_dict(state_dict)
        if self.bf16:
            self._plan_policy.load_state_dict(self.policy.state_dict())
        self.run, self.step = run, step

    def release(self):
        """Free the captured graphs and their pools (a later batch
        captures anew)."""
        self._graphs.release()

    def graph_report(self):
        """The cached graphs' captures, replays, capture seconds and kernel
        launches a replay (``core/serving_graph.py::GraphCache.report``)."""
        return self._graphs.report()

    @classmethod
    def from_artifact(cls, config_name, path, device='cuda', **kwargs):
        """A pipeline serving the generator of a JAX serving artifact;
        ``kwargs`` are the mode knobs of the constructor."""
        cfg = load_config(config_name)
        policy = build_policy(cfg, build_filters(cfg))
        payload = load_artifact(path)
        policy.load_state_dict(flax_to_state_dict(payload['gen_params']))
        return cls(cfg, policy, device=device, run=payload.get('run'),
                   step=payload.get('step'), **kwargs)

    @classmethod
    def from_run(cls, cfg, model_root='models', ckpt=None, device='cuda',
                 **kwargs):
        """A pipeline serving the generator of training run ``cfg.name``
        (``<config>/<run>``): its checkpoint (step ``ckpt``, or the newest),
        or its serving artifact when there is no checkpoint
        (``core/artifacts.py::restore_for_serving``)."""
        state_dict, step, _ = restore_for_serving(cfg.name, model_root, ckpt)
        policy = build_policy(cfg, build_filters(cfg))
        policy.load_state_dict(state_dict)
        return cls(cfg, policy, device=device, run=cfg.name, step=step,
                   **kwargs)

    # -- superset layout: freeze, and the auto record/freeze/re-freeze ----
    def freeze_superset(self, layout):
        """Freeze a (signature, bucket) slot layout: every later grouped
        replay routes through ``GroupedChainRunner.call_superset``.
        ``layout`` is an iterable of ``(signature tuple, bucket int)``."""
        if not self.grouped:
            raise ValueError('superset replay requires grouped mode')
        self._superset_layout = tuple(
            (tuple(int(x) for x in sig), int(size))
            for sig, size in sorted(layout))

    @staticmethod
    def _sig_counts(idh):
        """Per-signature image counts of a host [K, B] ids array."""
        cols = np.ascontiguousarray(idh.astype(np.int64, copy=False).T)
        uniq, counts = np.unique(cols, axis=0, return_counts=True)
        return {tuple(int(x) for x in uniq[g]): int(counts[g])
                for g in range(len(uniq))}

    def _ss_uncovered(self, counts, batch):
        """Fraction of this batch's rows the frozen layout cannot place
        (missing signature, or overflow past the slot's bucket): the rows
        that go to the K2 merge."""
        if len(counts) == 1:
            # a single-signature batch takes the whole-batch K3 call and
            # never touches the layout: no merge, nothing to re-freeze for
            return 0.0
        slot = dict(self._superset_layout)
        miss = sum(n if sig not in slot else max(0, n - slot[sig])
                   for sig, n in counts.items())
        return miss / float(batch)

    def _ss_layout_from_stats(self):
        # one full bucket step of headroom above the observed per-signature
        # maximum, as warmup(superset=True): a padded slot costs nothing,
        # an overflowing image goes to the merge
        return tuple(sorted(
            (sig, bucket_size(bucket_size(n_max) + 1))
            for sig, n_max in self._ss_stats.items()))

    def _ss_apply_layout(self, layout, refreeze=False):
        self.freeze_superset(layout)
        self._ss_stats = {}
        self._ss_seen = 0
        self._ss_drift.clear()
        if refreeze:
            self._ss_refreezes += 1

    def _ss_observe(self, idh):
        """Feed one batch's host ids to the auto-superset state machine.
        A re-freeze is applied at once: the JAX pipeline warmed the new
        layout's program on a side thread to hide a remote compile, and
        there is nothing to compile here."""
        counts = self._sig_counts(idh)
        for sig, n in counts.items():
            if self._ss_stats.get(sig, 0) < n:
                self._ss_stats[sig] = n
        self._ss_seen += 1
        if self._superset_layout is None:
            if self._ss_seen >= self._ss_record_batches:
                self._ss_apply_layout(self._ss_layout_from_stats())
            return
        self._ss_drift.append(self._ss_uncovered(counts, idh.shape[1]))
        if (len(self._ss_drift) == self._ss_window and
                sum(self._ss_drift) / self._ss_window > self._ss_threshold):
            self._ss_apply_layout(self._ss_layout_from_stats(),
                                  refreeze=True)

    def superset_report(self):
        """Auto-superset state for logging and benchmarks."""
        return {
            'auto': self._ss_auto,
            'frozen_slots': (None if self._superset_layout is None
                             else len(self._superset_layout)),
            'layout': (None if self._superset_layout is None else
                       [[list(sig), size]
                        for sig, size in self._superset_layout]),
            'batches_since_freeze': self._ss_seen,
            'refreezes': self._ss_refreezes,
            'refreeze_warm_pending': False,
            'drift_mean': (round(sum(self._ss_drift) /
                                 len(self._ss_drift), 4)
                           if self._ss_drift else None),
        }

    # -- the three parts of a batch --------------------------------------
    @staticmethod
    def _as_tensor(images):
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images))
        if images.dtype not in (torch.uint8, torch.float32):
            raise TypeError('images must be uint8 or float32, got %s'
                            % images.dtype)
        return images

    def _to_device(self, images):
        return self._as_tensor(images).to(self.device).contiguous()

    def proxy(self, images):
        with trace.region('serve.resize', self.device):
            return proxy_resize(images, self.cfg.source_img_size)

    @torch.no_grad()
    def plan(self, proxy, generator):
        """-> (ids [K, B] int32, params [K, B, max_p] f32,
        mask [K, B, max_m] f32): the selected-branch plan in the dynamic
        selected-plan mode, the bank plan otherwise."""
        with trace.region('serve.plan', self.device):
            if self.bf16:
                proxy = proxy.to(torch.bfloat16)
            if self.selected_plan:
                ids, params, mask = serve_rollout(
                    self._plan_policy, proxy, generator, cfg=self.cfg,
                    filters=self.filters, fast_math=self.fast_math)
            else:
                traj = rollout(self._plan_policy, proxy, generator,
                               cfg=self.cfg, filters=self.filters,
                               is_train=0)
                ids, params, mask = traj.filter_ids, traj.params, \
                    traj.mask_params
            return ids, params.to(torch.float32), mask.to(torch.float32)

    def replay(self, images, ids, params, mask, ids_host=None):
        """The plan on the full-resolution batch, through the mode's
        replay.  ``ids_host``: the grouped modes' host copy of ``ids``
        (copied here, waiting for the plan, when not given)."""
        mask = mask if self.masking else None
        with trace.region('serve.replay', self.device):
            if self.dynamic:
                return apply_filter_chain_dynamic(
                    images, ids, params, self.filters, mask_params=mask,
                    fast_math=self.fast_math)
            if self.grouped:
                return self._replay(images, ids, params, mask, ids_host)
            if self.use_kernels:
                return apply_filter_chain_switch(
                    images, ids, params, self.filters, mask_params=mask,
                    fast_math=self.fast_math)
            src = images.to(torch.float32)
            if images.dtype == torch.uint8:
                src = src * (1.0 / 255.0)
            out = apply_filter_chain(src, ids, params, self.filters,
                                     mask_params=mask)
            if images.dtype == torch.uint8:
                out = torch.round(torch.clamp(out, 0, 1) * 255).to(
                    torch.uint8)
            return out

    def _replay(self, images, ids, params, mask, ids_host):
        if ids_host is None:
            ids_host = ids.cpu().numpy()
        if self._ss_auto:
            self._ss_observe(ids_host)
        if self._superset_layout is not None:
            return self._runner.call_superset(
                images, ids_host, params, self._superset_layout,
                mask_params=mask, ids_device=ids)
        return self._runner(images, ids, params, mask_params=mask,
                            ids_host=ids_host)

    # -- one program a batch ---------------------------------------------
    def _batch(self, images, generator):
        """A dynamic or switch batch: proxy, plan and replay (the JAX
        ``_build``)."""
        return self.replay(images, *self.plan(self.proxy(images), generator))

    def _planned(self, images, generator):
        """A grouped batch's plan on its proxy (the JAX ``_plan``)."""
        return self.plan(self.proxy(images), generator)

    def _graph(self, body, images):
        return self._graphs.get(
            (body.__name__, tuple(images.shape), images.dtype), body, images,
            self.device)

    def _single(self, images, seed, index):
        """A non-grouped batch as one replay of its shape's graph (the JAX
        ``_single_jit``); host images are uploaded straight into the
        graph's input.  Returns the graph's output."""
        images = self._as_tensor(images)
        return self._graph(self._batch, images).run(
            images, batch_seed(seed, index))

    def _plan_for(self, images, seed, index):
        """A grouped batch's plan as one replay of its shape's graph:
        the graph's (ids, params, mask), which its next replay
        overwrites."""
        return self._graph(self._planned, images).run(
            images, batch_seed(seed, index))

    def _plan_batch(self, images, seed, index):
        """The plan of a batch on the device, as a replay or per call."""
        if self.graphs:
            return self._plan_for(images, seed, index)
        return self.plan(self.proxy(images),
                         batch_generator(seed, index, self.device))

    @torch.no_grad()
    def __call__(self, images, seed=0, index=0, device_out=False):
        """Retouch one [B, H, W, 3] batch, drawing dropout from the stream
        of (seed, index).  Returns a numpy array on the host, as the JAX
        pipeline does; ``device_out=True`` returns a tensor on the
        pipeline's device (without waiting for the device), so the caller
        decides when and what to transfer."""
        with trace.span('serve.call'):
            if self.graphs and not self.grouped:
                return _deliver_static(self._single(images, seed, index),
                                       device_out)
            images = self._to_device(images)
            ids, params, mask = self._plan_batch(images, seed, index)
            return _deliver(self.replay(images, ids, params, mask),
                            device_out)

    def _ids_to_host(self, ids):
        """Start the copy of a plan's ids to the host: (host tensor, event
        to wait on, or None on the CPU)."""
        if ids.device.type != 'cuda':
            return ids, None
        host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        host.copy_(ids, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @torch.no_grad()
    def map_batches(self, batches, seed=0, depth=8, device_out=False):
        """Retouch a stream of batches in order; batch i uses the dropout
        stream of (seed, i).  Yields numpy arrays on the host unless
        ``device_out=True`` (tensors on the pipeline's device: only then
        does the stream never wait for the device).

        The dynamic, switch and branchless modes never wait for the
        device: each batch's work is queued behind the last.  The grouped
        modes need each plan's ids on the host to group them, so plans run
        up to ``2 * depth`` batches ahead of replay; each plan's [K, B] ids
        are copied to pinned host memory without blocking, an event is
        recorded after the copy, and a batch's replay waits on its event
        only (with ``graphs``, a copy of the plan graph's outputs waits).
        ``depth`` changes when work is queued, never the output."""
        if not self.grouped:
            for i, images in enumerate(batches):
                yield self(images, seed, i, device_out=device_out)
            return
        it = iter(batches)
        pending = collections.deque()  # (images, plan, (host ids, event))
        i = 0
        try:
            while True:
                while len(pending) < 2 * depth:
                    try:
                        images = self._to_device(next(it))
                    except StopIteration:
                        break
                    plan = self._plan_batch(images, seed, i)
                    if self.graphs:
                        plan = tuple(t.clone() for t in plan)
                    i += 1
                    pending.append((images, plan, self._ids_to_host(plan[0])))
                if not pending:
                    return
                images, (ids, params, mask), (host, event) = \
                    pending.popleft()
                if event is not None:
                    event.synchronize()
                yield _deliver(self.replay(images, ids, params, mask,
                                           ids_host=host.numpy()),
                               device_out)
        finally:
            pending.clear()

    @torch.no_grad()
    def warmup(self, probe_images, probe_batches=6, seed=0, budget=None,
               superset=False):
        """Run the serving routes once ahead of traffic, and report them.

        ``probe_images``: one representative [B, H, W, 3] batch at the
        shape and dtype traffic will use.  For the grouped modes the
        signature budget is recorded, not guessed: ``probe_batches`` plans
        (the dropout streams of (seed, 0), (seed, 1), ...) are grouped as
        a replay groups them (``GroupedChainRunner.program_plan``) and the
        routes they touch are run once on padded-only rows; with
        ``superset=True`` the per-signature maximum bucket, one bucket
        step up, is frozen as the superset layout.  ``budget`` (a list of
        ``(signature, bucket)`` pairs) skips the probing.  There is no
        program to compile per route, so ``programs_compiled`` counts the
        routes the warm-up added to the runner's record of the distinct
        routes it has run (``GroupedChainRunner.routes``).  With
        ``graphs`` it also captures the plan's graph at this shape.

        The dynamic and switch modes run one batch: with ``graphs`` that
        captures the batch's graph, and ``programs_compiled`` counts the
        graphs this warm-up captured, with ``capture_seconds`` their
        warm-up and capture; per call it is 1, as in JAX.  Returns a
        JSON-able report with the keys of the JAX pipeline's."""
        t0 = time.time()
        images = self._to_device(probe_images)
        report = {'batch_shape': list(images.shape),
                  'dtype': str(images.dtype).replace('torch.', '')}
        if not self.grouped:
            before = self._graphs.report()
            self(images, seed, 0, device_out=True)
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            after = self._graphs.report()
            captured = after['captures'] - before['captures']
            report.update(kind='dynamic' if self.dynamic else 'switch',
                          programs_compiled=captured if self.graphs else 1,
                          captures=captured,
                          capture_seconds=after['capture_s'] -
                          before['capture_s'],
                          warmup_seconds=round(time.time() - t0, 1))
            return report

        runner = self._runner
        sig_budget, merge_sizes, singles = set(), set(), {}
        n_fallback = 0
        num_steps = self.cfg.test_steps
        max_p = max_filter_parameters(self.filters)
        mask_p = max(f.get_num_mask_parameters() for f in self.filters) \
            if self.masking else 1
        if self.graphs:
            self._plan_for(images, seed, 0)
        if budget is not None:
            sig_budget = {(tuple(sig), int(bucket)) for sig, bucket in budget}
        else:
            proxy = self.proxy(images)
            for i in range(probe_batches):
                ids, _, _ = self.plan(
                    proxy, batch_generator(seed, i, self.device))
                plan = runner.program_plan(ids.cpu().numpy())
                if plan['kind'] == 'groups':
                    sig_budget.update(plan['big'])
                    if plan['merge'] is not None:
                        merge_sizes.add(plan['merge'])
                elif plan['kind'] == 'single':
                    singles[plan['sig']] = plan['single_size']
                else:
                    n_fallback += 1
        shape_kw = dict(img_shape=images.shape, dtype=images.dtype,
                        num_steps=num_steps, max_p=max_p, mask_p=mask_p,
                        merge_sizes=sorted(merge_sizes), device=self.device)
        if superset:
            per_sig = {}
            for sig, bucket in sig_budget:
                per_sig[sig] = max(per_sig.get(sig, 0), bucket)
            layout = tuple(sorted((sig, bucket_size(b_max + 1))
                                  for sig, b_max in per_sig.items()))
            n = 0
            if layout:   # else the probes saw only single signatures
                n = runner.warmup_superset(layout, **shape_kw)
                self.freeze_superset(layout)
        else:
            n = runner.warmup(sorted(sig_budget), **shape_kw)
        for sig in sorted(singles):
            zp = torch.zeros((num_steps, images.shape[0], max_p),
                             device=self.device)
            zm = torch.zeros((num_steps, images.shape[0], mask_p),
                             device=self.device)
            runner._static(images, sig, zp, zm, None)
            key = ('single', sig, images.shape[0]) + runner._at(
                images.shape, images.dtype)
            n += key not in runner.routes
            runner.routes.add(key)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        report.update(
            kind='grouped',
            superset=bool(superset),
            probe_batches=0 if budget is not None else probe_batches,
            budget=sorted([list(sig), int(bucket)]
                          for sig, bucket in sig_budget),
            merge_sizes=sorted(merge_sizes),
            single_signatures=len(singles),
            fallback_batches=n_fallback,
            programs_compiled=int(n),
            warmup_seconds=round(time.time() - t0, 1))
        return report
