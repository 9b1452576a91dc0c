"""Cold start and warm-up of serving on the card (the port of
``exposure_tpu/tools/warmup_serving.py``).

Cold here is the first batch of a fresh pipeline in a fresh process: the
seconds from building the pipeline (``RetouchPipeline.from_run``) to the
end of its first batch, uploaded from the host.  They hold the CUDA
context, the policy's upload, loading the kernel libraries from
``exposure_tpu_torch/build`` (and building them when it is empty) and
cuDNN's first calls.  Warm is a later batch with a dropout stream the
warm-up never saw.  Each latency is the host clock around one call that
ends in ``torch.cuda.synchronize()``.

The grouped pipeline (``grouped=True, fused_set_limit=0``, bf16 plan) is
warmed by ``RetouchPipeline.warmup``: ``--probes`` plans are grouped as a
replay groups them and each route they touch is run once.  Nothing is
compiled per route on the card, so ``programs_compiled`` counts the routes
the warm-up ran, ``programs_after_traffic`` the distinct routes the runner
has run after the timed batches (``GroupedChainRunner.routes``) and
``budget_misses`` the difference: routes traffic took that the warm-up
missed.  ``--superset`` freezes the recorded budget into one layout.
``--decompose`` times the first fresh batch's parts: the plan's dispatch,
its ids to the host, the replay's dispatch and the completion.
``--dynamic`` measures the dynamic selected-plan default instead
(``from_run(cfg, bf16=True)``), which has one route for any action mix.
On the card its cold first batch includes capturing the batch's CUDA graph
(its eager warm-up run and the capture), reported alone as ``capture_s``;
later batches are one replay each.  On the CPU nothing is captured
(``capture_s`` 0).

    python -m exposure_tpu_torch.tools.warmup_serving \
        --run synthetic_explore/best [--batch 512] [--res 512] \
        [--probes 6] [--seeds 3] [--skip-cold] [--superset] [--decompose] \
        [--dynamic] [--out PATH] [--device cpu]

The report is printed, and written only where ``--out`` asks.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def first_batch_latency(pipe, images, seed):
    """Host-clock seconds of one ``pipe`` call on ``images`` under
    ``seed``, to the end of the device's work."""
    t0 = time.perf_counter()
    pipe(images, seed=seed, device_out=True)
    _sync(pipe.device)
    return time.perf_counter() - t0


def cold_first_batch(build, images_host, seed):
    """``(pipeline, seconds)``: a pipeline from ``build()`` and its first
    batch, the host images uploaded inside the timing."""
    t0 = time.perf_counter()
    pipe = build()
    pipe(images_host, seed=seed, device_out=True)
    _sync(pipe.device)
    return pipe, time.perf_counter() - t0


def decompose(pipe, images, seed=50):
    """The first fresh batch's parts, each on the host clock: the plan's
    dispatch, its ids to the host (which waits for the plan), the replay's
    dispatch and the completion; and the routes the runner ran lazily."""
    from exposure_tpu_torch.core.serving import batch_generator
    out = {}
    before = len(pipe._runner.routes)
    t0 = time.perf_counter()
    pipe(images, seed=0, device_out=True)    # the warm-up's probe batch
    _sync(pipe.device)
    out['reexec_probe_batch_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids, params, mask = pipe.plan(pipe.proxy(images),
                                  batch_generator(seed, 0, pipe.device))
    out['plan_dispatch_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_host = ids.cpu().numpy()
    out['ids_fetch_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.replay(images, ids, params, mask, ids_host=ids_host)
    out['replay_dispatch_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _sync(pipe.device)
    out['completion_force_s'] = time.perf_counter() - t0
    out['lazily_compiled_programs'] = len(pipe._runner.routes) - before
    return out


def main(argv=None):
    from exposure_tpu_torch.core.serving import RetouchPipeline
    from exposure_tpu_torch.tools import entry_device
    from exposure_tpu_torch.utils.config import load_config
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--run', required=True,
                    help='<config>/<run> trained checkpoint or artifact')
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--res', type=int, default=512)
    ap.add_argument('--probes', type=int, default=6)
    ap.add_argument('--seeds', type=int, default=3,
                    help='live batches to time after the first (each a '
                         'new dropout stream, so a new signature set)')
    ap.add_argument('--skip-cold', action='store_true')
    ap.add_argument('--superset', action='store_true',
                    help='freeze the recorded budget into one superset '
                         'layout (GroupedChainRunner.call_superset)')
    ap.add_argument('--decompose', action='store_true',
                    help='time the parts of the first fresh batch after '
                         'the warm-up')
    ap.add_argument('--dynamic', action='store_true',
                    help='measure the dynamic selected-plan default '
                         'instead: one route for any action mix')
    ap.add_argument('--out', default=None,
                    help='also write the report here (default: print only)')
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = entry_device(args.device)

    from exposure_tpu_torch.core.artifacts import has_trained_params
    if not has_trained_params(args.run, args.model_root):
        sys.exit('run %s not found (no checkpoint under %s, no serving '
                 'artifact)' % (args.run, args.model_root))
    cfg = load_config(args.run.split('/', 1)[0])
    cfg.name = args.run
    rng = np.random.RandomState(0)
    images_host = (rng.rand(args.batch, args.res, args.res, 3) *
                   255).astype(np.uint8)
    report = {'run': args.run, 'batch': args.batch, 'res': args.res}

    def from_run(**kw):
        # use_kernels: the card's modes on the CPU too (plain versions)
        return RetouchPipeline.from_run(cfg, model_root=args.model_root,
                                        device=device, bf16=True,
                                        use_kernels=True, **kw)

    def finish(report, printed):
        if args.out:
            with open(args.out, 'w') as f:
                json.dump(report, f, indent=1)
            print('# wrote', args.out, file=sys.stderr)
        print(json.dumps(printed))
        return report

    if args.dynamic:
        report['mode'] = 'dynamic'
        pipe, cold = cold_first_batch(from_run, images_host, 100)
        if not pipe.dynamic:
            raise AssertionError('expected the dynamic default on %s'
                                 % device)
        report['cold_first_batch_s'] = cold
        report['capture_s'] = pipe.graph_report()['capture_s']
        print('# dynamic cold first batch: %.3f s (capture %.3f s)'
              % (cold, report['capture_s']), file=sys.stderr)
        images = torch.from_numpy(images_host).to(device)
        lats = []
        for s in range(args.seeds):
            lats.append(first_batch_latency(pipe, images, 200 + s))
            print('# dynamic batch %d (fresh dropout stream): %.4f s'
                  % (s, lats[-1]), file=sys.stderr)
        report['warm_next_batches_s'] = lats
        return finish(report, report)

    def build():
        # the grouped stream-serving configuration: per-(signature, bucket)
        # routes only (fused_set_limit=0)
        return from_run(grouped=True, fused_set_limit=0)

    if not args.skip_cold:
        _, cold = cold_first_batch(build, images_host, 100)
        report['cold_first_batch_s'] = cold
        print('# cold first batch: %.3f s' % cold, file=sys.stderr)
    images = torch.from_numpy(images_host).to(device)
    pipe = build()
    wrep = pipe.warmup(images, probe_batches=args.probes, seed=0,
                       superset=args.superset)
    report['warmup'] = wrep
    print('# warmup: %d routes in %.1f s' % (wrep['programs_compiled'],
                                              wrep['warmup_seconds']),
          file=sys.stderr)
    if args.decompose:
        report['first_batch_decomposition'] = decompose(pipe, images)
        print('# decomposition: %s'
              % json.dumps(report['first_batch_decomposition']),
              file=sys.stderr)
    lats = []
    for s in range(args.seeds):
        # dropout streams the probes never saw: the routes they reuse come
        # from the (signature, bucket) budget, not from the probes' own sets
        lats.append(first_batch_latency(pipe, images, 100 + s))
        print('# warm batch %d: %.4f s' % (s, lats[-1]), file=sys.stderr)
    report['warm_first_batch_s'] = lats[0]
    report['warm_next_batches_s'] = lats[1:]
    n_after = len(pipe._runner.routes)
    report['programs_after_traffic'] = n_after
    report['budget_misses'] = n_after - wrep['programs_compiled']
    return finish(report, dict(
        {k: v for k, v in report.items() if k != 'warmup'},
        programs_compiled=wrep['programs_compiled']))


if __name__ == '__main__':
    main()
