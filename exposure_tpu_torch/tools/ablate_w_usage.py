"""W-usage ablation: is near-zero White-Balance usage data-driven?  (The
port of ``exposure_tpu/tools/ablate_w_usage.py``.)

Trained synthetic policies rarely pick the White-Balance filter (W), even
when eval inputs are artificially color-casted, but the default
procedural training data is perfectly color-balanced (``data/synthetic.py``
'raw' style), so W has nothing to earn reward on DURING TRAINING.  The
reference's W filter earns its keep on real RAW captures with illuminant
casts.

This tool closes the loop: train the SAME flagship architecture on
cast-augmented synthetic data (per-image random channel scales,
luminance-renormalized; ``make_synthetic_pack(cast=...)``) against the
same balanced target set, then measure W usage on casted eval inputs
(``diagnose_diversity.analyze``).  W usage appearing here shows the
near-zero usage on the default data is a property of the data, not a
policy/selector defect.

Usage:
  python -m exposure_tpu_torch.tools.ablate_w_usage \\
      [--cast 0.35] [--iters 20000] [--n 256] [--drop-filters C ...] \\
      [--color-curve-range LO HI] [--inject P] [--inject-mode anti] \\
      [--skip-trained] [--model-root models] [--out PATH] [--device cpu]

The run is ``<model-root>/synthetic/cast-ablation`` with the suffixes of
the flags (``-noC``, ``-c0.99_1.01``, ``-inj0.1``).  The report is printed,
and written only where ``--out`` asks.  The config's filters are the JAX
class names (``utils/config.py``), so ``--drop-filters`` maps each name to
its filter's ``short_name`` (``ops/filters.py``).  As in
``diagnose_diversity``, the global ``random`` module is seeded with 0
before the test provider draws, so that a run's report is a function of
its flags and its weights.
"""

import argparse
import json
import os
import random
import time


def build_config(args):
    """The ``synthetic`` config with the ablation's bank, knobs, run name
    and cast providers, as the JAX ``main`` builds it."""
    from exposure_tpu_torch.data.synthetic import SyntheticDataProvider
    from exposure_tpu_torch.ops.filters import FILTER_CLASSES
    from exposure_tpu_torch.utils.config import load_config

    cfg = load_config('synthetic')
    cfg.name = 'synthetic/cast-ablation'
    cfg.max_iter_step = args.iters
    if args.drop_filters:
        drop = set(args.drop_filters)
        cfg.filters = tuple(f for f in cfg.filters
                            if FILTER_CLASSES[f].short_name not in drop)
        # the agent state layout carries one usage slot per filter
        # (num_state_dim = 3 + len(filters))
        cfg.num_state_dim = 3 + len(cfg.filters)
        cfg.name += '-no' + ''.join(sorted(drop))
    if args.color_curve_range is not None:
        lo, hi = args.color_curve_range
        cfg.color_curve_range = (lo, hi)
        cfg.name += '-c%g_%g' % (lo, hi)
    if args.inject > 0.0:
        cfg.replay_inject_prob = args.inject
        cfg.replay_inject_until = 0.9
        cfg.replay_inject_mode = args.inject_mode
        cfg.name += '-inj%s%g' % (
            'a' if args.inject_mode == 'anti' else '', args.inject)
    cfg.write_image_interval = 2000
    cast = args.cast
    cfg.fake_data_provider = lambda: SyntheticDataProvider(
        n=2048, size=80, style='raw', seed=0, cast=cast,
        output_size=64, augmentation=0.3,
        default_batch_size=cfg.batch_size)
    cfg.fake_data_provider_test = lambda: SyntheticDataProvider(
        n=args.n, size=80, style='raw', seed=1, cast=cast,
        output_size=64, augmentation=0.0,
        default_batch_size=cfg.batch_size)
    return cfg


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cast', type=float, default=0.35)
    ap.add_argument('--iters', type=int, default=20000)
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--skip-trained', action='store_true')
    ap.add_argument('--drop-filters', nargs='*', default=[],
                    help='short names (e.g. C Ct BW) to REMOVE from the '
                         'bank: with the per-channel Color curve gone, '
                         'W becomes the only cast corrector, isolating '
                         'whether the policy CAN learn it')
    ap.add_argument('--color-curve-range', nargs=2, type=float,
                    default=None, metavar=('LO', 'HI'),
                    help='shrink the C curve\'s per-knot gain range '
                         '(reference default 0.90 1.10) WITHOUT removing '
                         'the filter: the soft version of --drop-filters '
                         'C; a range too narrow to absorb the injected '
                         'cast separates "W is redundant given C" from '
                         '"W head is broken"')
    ap.add_argument('--inject', type=float, default=0.0,
                    help='replay_inject_prob for the run (off-policy '
                         'forced draws into the replay pool)')
    ap.add_argument('--inject-mode', choices=('uniform', 'anti'),
                    default='uniform',
                    help='anti: force from q ~ 1/(pdf+c): the policy\'s '
                         'LEAST-picked filters get forced most '
                         '(models/agent.py)')
    ap.add_argument('--out', default=None,
                    help='also write the report here (default: print only)')
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu')
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    from exposure_tpu_torch.core.checkpoint import save_checkpoint
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.trainer import Trainer
    from exposure_tpu_torch.tools import entry_device
    from exposure_tpu_torch.tools.diagnose_diversity import analyze

    device = entry_device(args.device)
    cfg = build_config(args)

    t0 = time.time()
    run_dir = os.path.join(args.model_root, cfg.name)
    if args.skip_trained and os.path.isdir(run_dir):
        trainer = Trainer(cfg, restore=True, model_root=args.model_root,
                          device=device)
        trainer.restore()
        print('# reusing existing run at step %d'
              % int(trainer.state.step))
    else:
        trainer = Trainer(cfg, restore=False, model_root=args.model_root,
                          device=device)
        trainer.train()
        # the final state too (validate_parity.run_seed says why)
        save_checkpoint(trainer.dir, trainer.state, trainer.state.step,
                        keep=2)
    try:
        train_minutes = (time.time() - t0) / 60.0

        ev = Evaluator(cfg, model_root=args.model_root, state=trainer.state,
                       device=device)
        random.seed(0)
        inputs, _ = cfg.fake_data_provider_test().get_next_batch(args.n)
        report = {
            'cast': args.cast,
            'color_curve_range': list(cfg.color_curve_range),
            'dropped_filters': sorted(args.drop_filters),
            'inject': args.inject,
            'inject_mode': args.inject_mode if args.inject > 0 else None,
            'iters': int(trainer.state.step),
            'train_minutes': round(train_minutes, 1),
            **analyze(cfg, ev, inputs, keys=4),
        }
    finally:
        trainer.close()
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
        print('# wrote', args.out)
    return report


if __name__ == '__main__':
    main()
