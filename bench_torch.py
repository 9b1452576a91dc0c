#!/usr/bin/env python3
"""Serving throughput of the PyTorch/CUDA port: 5-step filter-chain
inference at 512x512 (the counterpart of ``bench.py``).

Per batch: scale the [B, 512, 512, 3] images to [0, 1] and resize them to
the 64x64 proxy, plan 5 steps on the proxy with the policy, then replay the
recorded chains on the full-resolution batch through the port's kernels.

    python3 bench_torch.py [--batch 512] [--run <config>/<run>] [--depth 8]
        [--switch | --grouped | --stream [--superset] | --dyn [--bank-plan]
         | --no-pallas] [--bf16] [--f32] [--exact] [--cpu]

Lines (one JSON line each, the headline last):

- driver mode (no mode flag and no ``--run``): when a trained run is found
  (the first of ``CANDIDATES`` with a checkpoint under ``models/`` or an
  in-repo serving artifact), five lines in this order: the untrained switch
  line; the trained grouped line; the trained stream line with the bf16
  plan; the same with ``--superset``; the trained dynamic line with the
  bf16 plan (the headline).  Without a trained run, the untrained switch
  line alone;
- ``--switch``: the bank plan (``core/rollout.py::rollout``) and the switch
  chain (K2) on the full-resolution batch, one CUDA graph a call;
- ``--grouped``: the bank plan as one CUDA graph a call, then
  ``GroupedChainRunner`` (K3 a signature group, K2 for merges);
- ``--stream``: ``RetouchPipeline(grouped=True, fused_set_limit=0)`` over a
  stream of batches (``map_batches``, plans ``2 * depth`` batches ahead);
  ``--superset`` first freezes a (signature, bucket) layout from probe
  plans (``warmup(superset=True)``);
- ``--dyn``: ``RetouchPipeline(dynamic=True)`` over a stream: the
  selected-branch plan and the replay through the dynamic chain (K1), one
  CUDA graph a batch; ``--bank-plan`` plans with the bank instead;
- ``--no-pallas``: the bank plan, then the branchless chain
  (``ops/chain.py``) on the full-resolution float32 batch, rounded to u8:
  the kernel-free control line.  The plain chain runs only under this flag.

``--bf16`` plans in bfloat16 (the proxy and a bfloat16 copy of the
policy); ``--f32`` serves float32 images instead of u8; ``--exact`` replays
with the exact branch set instead of the fast one.  ``--cpu`` runs the
kernels' plain versions on the host, for the tests; without it the script
needs a GPU and exits non-zero when there is none.

Inputs: untrained, ``numpy.random.default_rng(0)`` uniform in [0, 0.8)
(``bench.py`` draws from ``jax.random.uniform``, a stream torch cannot
reproduce, so the two scripts' untrained images differ); trained, the
config's test provider after ``random.seed(0)`` (it draws from the global
``random``), clipped to [0, 1] and resized linearly to 512x512.  Both become
u8 by ``(x * 255)`` truncated, as ``bench.py`` does.  Every call plans with
the same dropout seed, so every call makes the same trajectories (dropout
stays on, as at serving).

Timing, on the card with CUDA events: a step line (switch, grouped,
branchless) times ``CALLS`` calls back to back, ``RERUNS`` times
(``tools.median_seconds`` with one run each, after two warm-up calls); a
stream line records events around ``map_batches`` over ``CALLS`` batches,
``RERUNS`` times, after a warm-up of ``N_SMALL + CALLS + 2 * depth``
batches on the same seeds, so every route and graph a timed batch takes is
built first.  images/s is B over the seconds a batch.

Each line has ``bench.py``'s metric name and keys, less ``vs_baseline``:
that ratio was to a throughput target set per TPU chip, which says nothing
of this card.  ``value`` is the median of the reruns, ``value_min`` and
``value_max`` their spread.
"""

import argparse
import copy
import json
import random
import statistics
import sys

import numpy as np
import torch

RERUNS = 3      # timings a line: the median is the value, with the spread
CALLS = 30      # calls a step timing, batches a stream timing
N_SMALL = 10    # with CALLS and 2 * depth, the batches a stream warm-up runs
SEED = 0        # the inputs' seed and every call's dropout seed
# the trained runs driver mode looks for, in bench.py's order
CANDIDATES = ('synthetic_explore/best',
              'synthetic_explore/parity-seed2',
              'synthetic_explore/parity-seed0',
              'synthetic/final-r4',
              'synthetic/final-r3', 'synthetic/final-r2',
              'synthetic/parity-seed0',
              'synthetic_wide/parity-seed0')
METRIC = '512px_images_per_sec_5step_inference'


def _config(run):
    from exposure_tpu_torch.utils.config import load_config
    if run:
        cfg = load_config(run.split('/', 1)[0])
        cfg.name = run
    else:
        cfg = load_config('example')
    return cfg


def _policy(cfg, run, device):
    """``(filters, policy)``: ``run``'s trained weights, or without a run
    the policy ``init_train_state`` makes from seed 0."""
    from exposure_tpu_torch.models.networks import build_policy, \
        init_like_flax
    from exposure_tpu_torch.ops.filters import build_filters
    filters = build_filters(cfg)
    policy = build_policy(cfg, filters)
    if run:
        from exposure_tpu_torch.core.artifacts import restore_for_serving
        state_dict, step, source = restore_for_serving(run)
        policy.load_state_dict(state_dict)
        print('# bench: restored %s at step %d (%s)' % (run, step, source),
              file=sys.stderr)
    else:
        init_like_flax(policy, torch.Generator().manual_seed(SEED))
    return filters, policy.to(device).eval()


def inputs(cfg, batch, res, u8, run, device):
    """The benchmark batch on ``device``: the trained run's test inputs or
    seeded noise (module docstring), u8 by truncation unless ``u8`` is
    false."""
    from exposure_tpu_torch.core.serving import proxy_resize
    if run:
        random.seed(SEED)
        base, _ = cfg.fake_data_provider_test().get_next_batch(batch)
        imgs = proxy_resize(torch.from_numpy(
            np.clip(base, 0.0, 1.0).astype(np.float32)).to(device), res)
    else:
        imgs = torch.from_numpy(np.random.default_rng(SEED).random(
            (batch, res, res, 3), np.float32) * np.float32(0.8)).to(device)
    if u8:
        imgs = (imgs * 255).to(torch.uint8)
    return imgs


def build_pipeline(batch, res, mode='grouped', u8=True, run=None,
                   bf16=False, fast_math=True, device='cuda'):
    """One batch of ``mode`` (``grouped``, ``switch`` or ``jnp``, the
    branchless line) as ``bench.py``'s ``build_pipeline`` builds it: the
    bank plan on the proxy, then the mode's replay.  Where ``bench.py`` jits
    the whole batch (switch, jnp) or the plan (grouped), the port captures
    it as a ``core/serving_graph.py::BatchGraph`` (on the CPU the same body
    runs eagerly).  Returns ``(step_fn, imgs, seed)``: ``step_fn(imgs,
    seed)`` is the output of the batch ``imgs`` (the graph's input buffer)
    with dropout drawn from ``seed``; a graph's next call overwrites it."""
    from exposure_tpu_torch.core.rollout import rollout
    from exposure_tpu_torch.core.serving import proxy_resize
    from exposure_tpu_torch.core.serving_graph import BatchGraph
    from exposure_tpu_torch.ops.chain import apply_filter_chain
    from exposure_tpu_torch.ops.grouped_chain import GroupedChainRunner
    from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch

    cfg = _config(run)
    filters, policy = _policy(cfg, run, device)
    plan_policy = copy.deepcopy(policy).to(torch.bfloat16) if bf16 \
        else policy

    def masks(mask):
        return mask if cfg.masking else None

    @torch.no_grad()
    def plan(images, generator):
        proxy = proxy_resize(images, cfg.source_img_size)
        if bf16:
            proxy = proxy.to(torch.bfloat16)
        traj = rollout(plan_policy, proxy, generator, cfg=cfg,
                       filters=filters, is_train=0)
        return (traj.filter_ids, traj.params.to(torch.float32),
                traj.mask_params.to(torch.float32))

    @torch.no_grad()
    def switch(images, generator):
        ids, params, mask = plan(images, generator)
        return apply_filter_chain_switch(images, ids, params, filters,
                                         mask_params=masks(mask),
                                         fast_math=fast_math)

    @torch.no_grad()
    def branchless(images, generator):
        ids, params, mask = plan(images, generator)
        src = images.to(torch.float32) * (1.0 / 255.0) if u8 else images
        out = apply_filter_chain(src, ids, params, filters,
                                 mask_params=masks(mask))
        if u8:
            out = torch.round(torch.clamp(out, 0, 1) * 255).to(torch.uint8)
        return out

    imgs = inputs(cfg, batch, res, u8, run, device)
    body = {'grouped': plan, 'switch': switch, 'jnp': branchless}[mode]
    graph = BatchGraph(body, imgs, device)
    graph.input.copy_(imgs)
    if mode == 'grouped':
        runner = GroupedChainRunner(filters, fast_math=fast_math)

        @torch.no_grad()
        def step_fn(images, seed):
            ids, params, mask = graph.run(images, seed)
            return runner(images, ids, params, mask_params=masks(mask))
    else:
        step_fn = graph.run
    return step_fn, graph.input, SEED


def bench_stream(batch, res, u8=True, run=None, bf16=False,
                 fast_math=True, depth=8, superset=False, dynamic=False,
                 selected_plan=None, device='cuda', batches=CALLS):
    """``RetouchPipeline.map_batches`` over a stream of ``batches`` batches
    (``bench.py``'s ``bench_stream``): the dynamic pipeline (``dynamic``) or
    the grouped one with ``fused_set_limit=0``.  Every span restarts the
    dropout seeds at batch 0; the warm-up runs the longest span first (and,
    with ``superset``, freezes the layout from that many probe plans).
    Returns ``(images/s of each rerun, routes or graphs built)``: the grouped
    runner's distinct routes, or the dynamic pipeline's graph captures."""
    from exposure_tpu_torch.core.serving import RetouchPipeline
    from exposure_tpu_torch.tools import median_seconds

    cfg = _config(run)
    _, policy = _policy(cfg, run, device)
    mode = dict(dynamic=True, selected_plan=selected_plan) if dynamic \
        else dict(grouped=True, fused_set_limit=0)
    pipe = RetouchPipeline(cfg, policy, device=device, run=run,
                           use_kernels=True, bf16=bf16, fast_math=fast_math,
                           **mode)
    imgs = inputs(cfg, batch, res, u8, run, device)

    def run_n(n):
        for _ in pipe.map_batches((imgs for _ in range(n)), seed=SEED,
                                  depth=depth, device_out=True):
            pass

    warm = N_SMALL + batches + 2 * depth
    try:
        if superset:
            report = pipe.warmup(imgs, probe_batches=warm, seed=SEED,
                                 superset=True)
            print('# superset: %d slots, %d programs in %.1f s'
                  % (len(report.get('budget', [])),
                     report['programs_compiled'], report['warmup_seconds']),
                  file=sys.stderr)
        run_n(warm)
        values = [batch * batches / median_seconds(
            lambda: run_n(batches), device, runs=1, warmup=0)
            for _ in range(RERUNS)]
        built = len(pipe._runner.routes) if pipe._runner is not None \
            else pipe.graph_report()['captures']
    finally:
        pipe.release()
    return values, built


def step_seconds(fn, device, calls=CALLS):
    """``RERUNS`` timings of ``fn()``, each the seconds a call over
    ``calls`` calls back to back (``tools.median_seconds`` with one run),
    after two warm-up calls."""
    from exposure_tpu_torch.tools import median_seconds
    return [median_seconds(fn, device, runs=1, warmup=0 if i else 2,
                           calls=calls) for i in range(RERUNS)]


def measure(mode, batch, res, u8, run, bf16, fast_math, depth=8,
            superset=False, bank_plan=False, device='cuda', calls=CALLS):
    """One line: ``(images/s of each rerun, metric name)``.  ``mode`` is
    ``switch``, ``grouped``, ``jnp``, ``stream`` or ``dyn``; ``bank_plan``
    counts in the dynamic mode only; ``calls``: the calls or batches a
    timing."""
    bank_plan = bank_plan and mode == 'dyn'
    if mode in ('stream', 'dyn'):
        values, built = bench_stream(
            batch, res, u8=u8, run=run, bf16=bf16, fast_math=fast_math,
            depth=depth, superset=superset, dynamic=(mode == 'dyn'),
            selected_plan=False if bank_plan else None, device=device,
            batches=calls)
        print('# %s: depth=%d kernel_variants=%d' % (mode, depth, built),
              file=sys.stderr)
    else:
        step_fn, imgs, seed = build_pipeline(batch, res, mode, u8, run=run,
                                             bf16=bf16, fast_math=fast_math,
                                             device=device)
        values = [batch / s for s in step_seconds(
            lambda: step_fn(imgs, seed), device, calls)]
    tags = ('' if not u8 else '_u8io') + ('_bf16' if bf16 else '') + \
        ('_trained' if run else '') + \
        ('' if mode == 'switch' else '_' + mode) + \
        ('_superset' if superset else '') + \
        ('_bankplan' if bank_plan else '')
    return values, METRIC + tags


def emit(values, metric):
    """One JSON line: the median of the reruns as ``value``, and their
    spread."""
    vals = sorted(float(v) for v in values)
    print(json.dumps({
        'metric': metric,
        'value': round(statistics.median(vals), 2),
        'unit': 'images/sec',
        'n_reruns': len(vals),
        'value_min': round(vals[0], 2),
        'value_max': round(vals[-1], 2),
    }), flush=True)


def main(argv=None):
    from exposure_tpu_torch.tools import device_name, tool_device
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--run', default=None, help='<config>/<run>')
    ap.add_argument('--depth', type=int, default=8)
    for flag in ('--switch', '--grouped', '--stream', '--superset', '--dyn',
                 '--bank-plan', '--no-pallas', '--bf16', '--f32', '--exact',
                 '--cpu'):
        ap.add_argument(flag, action='store_true')
    args = ap.parse_args(argv)
    device = tool_device(args.cpu)
    print('# bench: %s' % device_name(device), file=sys.stderr)
    batch, res, run = args.batch, 512, args.run
    stream, bf16 = args.stream, args.bf16
    driver_mode = run is None and not (args.switch or args.no_pallas or
                                       args.grouped or stream or args.dyn)
    if driver_mode:
        from exposure_tpu_torch.core.artifacts import has_trained_params
        for cand in CANDIDATES:
            if has_trained_params(cand):
                run, stream, bf16 = cand, True, True
                print('# bench: defaulting to the trained stream headline '
                      '(%s); pass --switch for the untrained switch line'
                      % cand, file=sys.stderr)
                break
    if args.no_pallas:
        mode = 'jnp'
    elif args.dyn:
        mode = 'dyn'
    elif stream:
        mode = 'stream'
    elif args.grouped:
        mode = 'grouped'
    else:
        mode = 'switch'
    u8 = not args.f32
    fast_math = not args.exact
    kw = dict(depth=args.depth, device=device)

    if driver_mode and run is not None:
        for m, r, b, ss in (('switch', None, False, False),
                            ('grouped', run, False, False),
                            ('stream', run, True, False),
                            ('stream', run, True, True),
                            ('dyn', run, True, False)):
            emit(*measure(m, batch, res, u8, r, b, fast_math, superset=ss,
                          **kw))
        return
    emit(*measure(mode, batch, res, u8, run, bf16, fast_math,
                  superset=args.superset, bank_plan=args.bank_plan, **kw))


if __name__ == '__main__':
    main()
