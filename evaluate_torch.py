#!/usr/bin/env python3
"""Retouch photos with a trained model through the PyTorch/CUDA port:
``python3 evaluate_torch.py <config> <run-name> <image files...>``.

The counterpart of ``evaluate.py``, with the same arguments plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain versions on the
host).  ``evaluate.py`` reloads the config snapshot a training run backs up
under ``models/<config>/<run>/scripts/``; that snapshot is a Python module
of the JAX package, which the port does not import, so the port reads its
own table (``exposure_tpu_torch/utils/config.py``) and says so when a
snapshot exists.

As the JAX evaluator does, it restores the run's whole train state (the
checkpoint's generator, critic, value net and their Adam moments onto a
state initialised from the config's seed, or the artifact's generator
beside an untrained critic), though only the policy retouches: a checkpoint
whose critic or optimizer tree differs from the config fails to restore.

Writes, per input, ``<name>.linear.png``, ``.input_tone_mapped.png``,
``.intermediateNN.png`` (step by step), ``.retouched.png``, ``.steps.png``
and ``<name>_debug.pkl`` into ``--output-dir``; with ``--batched`` the
first two and ``.retouched.png``."""

import argparse
import os
import sys

from exposure_tpu_torch.utils.config import load_config


def evaluate(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('config')
    parser.add_argument('model_name')
    parser.add_argument('images', nargs='+')
    parser.add_argument('--ckpt', type=int, default=None,
                        help='checkpoint step (default: latest)')
    parser.add_argument('--output-dir', default='./outputs')
    parser.add_argument('--no-step-by-step', action='store_true')
    parser.add_argument('--batched', action='store_true',
                        help='batch inputs by resolution (one rollout + '
                             'one chain replay per resolution group)')
    parser.add_argument('--u8', action='store_true',
                        help='with --batched: replay in uint8 (fastest; '
                             'trades sub-1/255 shadow precision)')
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)

    snapshot = os.path.join('models', args.config, args.model_name,
                            'scripts', 'config_%s.py' % args.config)
    if os.path.exists(snapshot):
        print('Note: the config snapshot %s is a module of the JAX package; '
              'reading the port\'s own table entry %r instead'
              % (snapshot, args.config))
    cfg = load_config(args.config)
    cfg.name = args.config + '/' + args.model_name

    from exposure_tpu_torch.core.evaluator import Evaluator
    ev = Evaluator(cfg, ckpt=args.ckpt, device=args.device)
    if args.batched:
        ev.eval_batched(spec_files=args.images,
                        output_dir=args.output_dir, u8=args.u8)
    else:
        ev.eval(spec_files=args.images, output_dir=args.output_dir,
                step_by_step=not args.no_step_by_step)


if __name__ == '__main__':
    if len(sys.argv) < 4:
        print('Usage: python3 evaluate_torch.py [config] [model name] '
              '[image files ...]')
        sys.exit(-1)
    evaluate()
