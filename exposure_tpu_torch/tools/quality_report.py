"""Quantitative quality report for a trained run (torch counterpart of
``exposure_tpu/tools/quality_report.py``).

Retouches a batch of held-out inputs with the trained policy and reports
the histogram-intersection metric between output and target distributions,
before and after retouching: the "did training actually move the
distribution toward the artist" check.  The inputs and targets come from
the config's ``fake_data_provider_test`` and ``real_data_provider``; the
outputs are the planned trajectories' final proxies, on the card unless
``device='cpu'`` is asked for.

Usage: python -m exposure_tpu_torch.tools.quality_report <config> <run-name>
       [--n 256] [--ckpt STEP] [--device cpu]
"""

import argparse
import json

import numpy as np

from exposure_tpu_torch.core.evaluator import Evaluator
from exposure_tpu_torch.core.serving import batch_generator
from exposure_tpu_torch.tools.histogram_intersection import compare_image_sets
from exposure_tpu_torch.utils.config import load_config


def quality_report(cfg, n=256, ckpt=None, model_root='models', seed=0,
                   policy=None, device='cuda'):
    fake_test = cfg.fake_data_provider_test()
    supervised = bool(cfg.get('supervised', False))
    if supervised:
        # paired provider: [B, 2, S, S, C] (input, ground truth); score
        # against the pixel-aligned ground truth set
        pairs, _ = fake_test.get_next_batch(n)
        inputs, targets = pairs[:, 0], pairs[:, 1]
    else:
        real = cfg.real_data_provider()
        inputs, _ = fake_test.get_next_batch(n)
        targets, _ = real.get_next_batch(n)

    ev = Evaluator(cfg, model_root=model_root, ckpt=ckpt, policy=policy,
                   device=device)
    traj, applied = ev.plan_trajectory(
        inputs, batch_generator(seed, 0, ev.device))
    outputs = traj.final_image.cpu().numpy()

    before = compare_image_sets(np.clip(inputs, 0, 1),
                                np.clip(targets, 0, 1))
    after = compare_image_sets(np.clip(outputs, 0, 1),
                               np.clip(targets, 0, 1))
    report = {
        'n': n,
        'intersection_before': [round(float(x), 4) for x in before],
        'intersection_after': [round(float(x), 4) for x in after],
        'avg_before': round(float(np.mean(before)), 4),
        'avg_after': round(float(np.mean(after)), 4),
        'avg_steps_applied': round(float(np.mean(applied)), 2),
    }
    if supervised:
        report['mse_before'] = round(float(
            np.mean((np.clip(inputs, 0, 1) - targets) ** 2)), 5)
        report['mse_after'] = round(float(
            np.mean((np.clip(outputs, 0, 1) - targets) ** 2)), 5)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('config')
    parser.add_argument('run_name')
    parser.add_argument('--n', type=int, default=256)
    parser.add_argument('--ckpt', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    cfg.name = args.config + '/' + args.run_name
    print(json.dumps(quality_report(cfg, n=args.n, ckpt=args.ckpt,
                                    device=args.device)))


if __name__ == '__main__':
    main()
