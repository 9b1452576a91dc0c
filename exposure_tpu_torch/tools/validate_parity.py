"""Quality-parity validation runbook (the port of
``exposure_tpu/tools/validate_parity.py``).

Executes the full reference workflow — train the flagship architecture,
retouch the held-out inputs, score the 3-stat histogram-intersection
metric (luminance / contrast / saturation) against the target set — for N
seeds, and records everything the quality claim rests on:

- all three intersection stats, before and after retouching, per seed;
- trajectory statistics: steps applied, filter-usage histogram, fraction
  of distinct filter sequences (policy diversity);
- the training metrics tail (final EMD, g_loss).

``--config synthetic`` (default) runs the flagship architecture on the
procedural stand-in; ``--config example`` needs the FiveK tree under the
working directory.

Usage:
  python -m exposure_tpu_torch.tools.validate_parity \\
      [--config synthetic] [--seeds 0 1 2] [--iters 20000] \\
      [--n-eval 256] [--out PATH] [--skip-trained] [--model-root models] \\
      [--device cpu]

``--skip-trained`` reuses existing ``<config>/parity-seed<k>`` runs
(restores the latest checkpoint instead of training).  The report is
printed, and written only where ``--out`` asks.  A trained run's final
state is checkpointed beside the schedule's checkpoints (the JAX tool
leaves only those, so its ``--skip-trained`` restores an earlier state than
the one it scored, and none at all after ``--iters`` shorter than the
config's ``checkpoint_interval``).

Differences from the JAX tool: the dropout stream of a seed's plans is
``core/serving.py::batch_generator(seed, 0, device)`` (the JAX tool's
``PRNGKey(seed)``), and the global ``random`` module, which the data
providers draw from, is seeded with the run's seed before the quality
report, so that a run scored twice (trained, then ``--skip-trained``) is
scored on the same inputs and targets.
"""

import argparse
import json
import os
import random
import time

import numpy as np


def trajectory_stats(cfg, ev, inputs, seed=0):
    """Filter usage, applied-step and diversity statistics on a batch."""
    from exposure_tpu_torch.core.serving import batch_generator
    traj, applied = ev.plan_trajectory(
        inputs, batch_generator(seed, 0, ev.device))
    ids = traj.filter_ids.cpu().numpy()  # [K, B]
    k, b = ids.shape
    active = np.asarray(ev.active_mask(traj)) > 0
    usage = np.zeros(len(ev.filters), np.int64)
    for f in range(len(ev.filters)):
        usage[f] = int(((ids == f) & active).sum())
    sequences = set()
    for i in range(b):
        sequences.add(tuple(ids[:applied[i], i].tolist()))
    short_names = [f.get_short_name() for f in ev.filters]
    return {
        'avg_steps_applied': round(float(np.mean(applied)), 3),
        'filter_usage': {short_names[f]: int(usage[f])
                         for f in range(len(usage))},
        'distinct_sequences_frac': round(len(sequences) / b, 4),
    }


def run_seed(config_name, seed, iters, n_eval, skip_trained=False,
             model_root='models', device='cuda'):
    from exposure_tpu_torch.core.checkpoint import save_checkpoint
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.trainer import Trainer
    from exposure_tpu_torch.tools.quality_report import quality_report
    from exposure_tpu_torch.utils.config import load_config

    cfg = load_config(config_name)
    cfg.seed = seed
    cfg.name = '%s/parity-seed%d' % (config_name, seed)
    cfg.max_iter_step = iters
    # keep the host's bookkeeping out of the hot loop
    cfg.write_image_interval = max(cfg.write_image_interval, 2000)

    t0 = time.time()
    run_dir = os.path.join(model_root, cfg.name)
    if skip_trained and os.path.isdir(run_dir):
        trainer = Trainer(cfg, restore=True, model_root=model_root,
                          device=device)
        trainer.restore()
        print('# seed %d: reusing existing run at step %d'
              % (seed, int(trainer.state.step)))
    else:
        trainer = Trainer(cfg, restore=False, model_root=model_root,
                          device=device)
        trainer.train()
        # the final state too, which the schedule checkpoints only on a
        # checkpoint_interval boundary: --skip-trained and the other probes
        # restore what was trained and scored
        save_checkpoint(trainer.dir, trainer.state, trainer.state.step,
                        keep=2)
    try:
        train_minutes = (time.time() - t0) / 60.0

        random.seed(seed)
        report = quality_report(cfg, n=n_eval, model_root=model_root,
                                seed=seed, state=trainer.state,
                                device=device)

        ev = Evaluator(cfg, model_root=model_root, state=trainer.state,
                       device=device)
        fake_test = cfg.fake_data_provider_test()
        inputs, _ = fake_test.get_next_batch(n_eval)
        tstats = trajectory_stats(cfg, ev, inputs, seed=seed)
        iters_done = int(trainer.state.step)
    finally:
        trainer.close()

    metrics_path = os.path.join(run_dir, 'metrics.jsonl')
    tail = {}
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            lines = f.readlines()
        if lines:
            last = json.loads(lines[-1])
            tail = {'final_emd': round(last.get('emd', float('nan')), 3),
                    'final_g_loss': round(last.get('g_loss',
                                                   float('nan')), 3)}
    return {
        'seed': seed,
        'run': cfg.name,
        'iters': iters_done,
        'train_minutes': round(train_minutes, 1),
        'quality': report,
        'trajectories': tstats,
        **tail,
    }


def summarize(results):
    """Mean +- std of the 3-stat intersections across seeds."""
    stats = ['luminance', 'contrast', 'saturation']

    def agg(key):
        arr = np.asarray([r['quality'][key] for r in results],
                         np.float64)  # [seeds, 3]
        return {stats[i]: {'mean': round(float(arr[:, i].mean()), 4),
                           'std': round(float(arr[:, i].std()), 4)}
                for i in range(3)}

    avg_after = [r['quality']['avg_after'] for r in results]
    avg_before = [r['quality']['avg_before'] for r in results]
    return {
        'seeds': len(results),
        'intersection_before': agg('intersection_before'),
        'intersection_after': agg('intersection_after'),
        'avg_before_mean': round(float(np.mean(avg_before)), 4),
        'avg_after_mean': round(float(np.mean(avg_after)), 4),
        'avg_after_std': round(float(np.std(avg_after)), 4),
    }


def main(argv=None):
    from exposure_tpu_torch.tools import entry_device
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', default='synthetic')
    parser.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    parser.add_argument('--iters', type=int, default=20000)
    parser.add_argument('--n-eval', type=int, default=256)
    parser.add_argument('--out', default=None,
                        help='also write the report here (default: print '
                             'only)')
    parser.add_argument('--skip-trained', action='store_true')
    parser.add_argument('--model-root', default='models')
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    device = entry_device(args.device)

    results = []
    for seed in args.seeds:
        print('#=== parity run: config=%s seed=%d iters=%d'
              % (args.config, seed, args.iters))
        r = run_seed(args.config, seed, args.iters, args.n_eval,
                     skip_trained=args.skip_trained,
                     model_root=args.model_root, device=device)
        print(json.dumps(r))
        results.append(r)
        # checkpoint the report incrementally: long runs may be
        # interrupted
        if args.out:
            with open(args.out, 'w') as f:
                json.dump({'config': args.config,
                           'runs': results,
                           'summary': summarize(results)}, f, indent=1)
    if args.out:
        print('# wrote', args.out)
    print(json.dumps(summarize(results)))
    return {'config': args.config, 'runs': results,
            'summary': summarize(results)}


if __name__ == '__main__':
    main()
