"""Diagnose trajectory diversity: WHY does a trained policy emit few
distinct filter sequences?  (The port of
``exposure_tpu/tools/diagnose_diversity.py``.)

The reference's stated test-time diversity mechanism is always-on dropout
perturbing the selector, with ARGMAX selection at test, so low diversity
can mean (a) dropout noise not reaching the selector, (b) a policy
confident enough that argmax is dropout-stable (legitimate), or (c) a
data distribution where unused filters are genuinely useless.

This tool separates those:

1. **Dropout sensitivity**: plan the SAME inputs under different dropout
   streams (argmax mode).  ``key_flip_frac`` = fraction of images whose
   sequence changes across streams.  >0 proves dropout reaches the
   selector; ~0 would indicate (a).
2. **Policy confidence**: mean/min top-1 probability of the post-mixing
   action pdf per step.  Top-1 near 1-eps explains argmax stability
   as (b), not a bug.
3. **Sampling ceiling**: distinct sequences when SAMPLING from the pdf
   (is_train=1), the diversity the pdf itself supports.
4. **Gray-shift ablation** for (c): color-cast the eval inputs
   (channel scales) and measure White-Balance usage.  A policy that
   picks W on casted inputs but not on the procedural set shows the
   LOW W USAGE IS DATA-DRIVEN, not a collapse.

Usage:
  python -m exposure_tpu_torch.tools.diagnose_diversity \\
      --run synthetic/parity-seed0 [--n 256] [--keys 4] [--out PATH] \\
      [--model-root models] [--device cpu]

``--run`` names a run under ``--model-root`` (``validate_parity`` trains
``<config>/parity-seed<k>``) or one with an in-repo serving artifact.  The
report is printed; with ``--out`` it is appended to that file's list.

Differences from the JAX tool: each JAX key is a ``torch.Generator`` on the
evaluator's device seeded with the same number (1000+k for argmax, 2000+k
for sampling, 7 for the casts), and the global ``random`` module, which
the test provider draws from, is seeded with 0 first, so that a run's
report is a function of its flags and weights.
"""

import argparse
import collections
import json
import math
import os
import random

import numpy as np
import torch


def sequences_of(ids, applied):
    """Per-image applied-step filter-id tuples."""
    k, b = ids.shape
    return [tuple(ids[:applied[i], i].tolist()) for i in range(b)]


def seq_entropy_bits(seqs):
    counts = collections.Counter(seqs)
    n = sum(counts.values())
    return -sum(c / n * math.log2(c / n) for c in counts.values())


def analyze(cfg, ev, inputs, keys=4, n_sample_keys=2, generator=None):
    """The report's four sections for ``inputs`` ([B, S, S, 3]) under the
    evaluator's policy.  ``generator(seed)`` makes each plan's dropout (and
    sampling) stream in place of a JAX ``PRNGKey(seed)``: by default a
    generator on the evaluator's device seeded with ``seed``."""
    from exposure_tpu_torch.core.rollout import rollout

    filters = ev.filters
    short = [f.get_short_name() for f in filters]
    generator = generator or (
        lambda seed: torch.Generator(device=ev.device).manual_seed(seed))

    @torch.no_grad()
    def plan(im, seed, it):
        traj = rollout(ev.policy, im, generator(seed), cfg=cfg,
                       filters=filters, is_train=it)
        return traj.filter_ids.cpu().numpy(), traj.pdfs.cpu().numpy()

    imgs = torch.as_tensor(np.asarray(inputs, np.float32)).to(ev.device)
    report = {}

    # 1+2: argmax under different dropout keys
    per_key = []
    pdf_top1 = []
    usage_tot = np.zeros(len(filters), np.int64)
    for ki in range(keys):
        ids, pdfs = plan(imgs, 1000 + ki, 0)
        k, b = ids.shape
        applied = np.full((b,), k, np.int32)
        seqs = sequences_of(ids, applied)
        per_key.append(seqs)
        pdf_top1.append(pdfs.max(axis=2))  # pdfs: [K, B, F]
        for f in range(len(filters)):
            usage_tot[f] += int((ids == f).sum())
    b = len(per_key[0])
    flips = 0
    for i in range(b):
        if len({sk[i] for sk in per_key}) > 1:
            flips += 1
    union = set()
    for sk in per_key:
        union.update(sk)
    top1 = np.concatenate([t.reshape(-1) for t in pdf_top1])
    report['argmax'] = {
        'keys': keys,
        'distinct_frac_per_key': round(
            np.mean([len(set(sk)) / b for sk in per_key]), 4),
        'distinct_union': len(union),
        'key_flip_frac': round(flips / b, 4),
        'pdf_top1_mean': round(float(top1.mean()), 4),
        'pdf_top1_p05': round(float(np.percentile(top1, 5)), 4),
        'filter_usage_frac': {short[f]: round(float(
            usage_tot[f] / usage_tot.sum()), 4)
            for f in range(len(filters))},
    }

    # 3: sampling-mode ceiling
    samp_seqs = []
    for ki in range(n_sample_keys):
        ids, _ = plan(imgs, 2000 + ki, 1)
        k, b2 = ids.shape
        samp_seqs.extend(sequences_of(ids, np.full((b2,), k, np.int32)))
    report['sampling'] = {
        'distinct_frac': round(len(set(samp_seqs)) / len(samp_seqs), 4),
        'entropy_bits': round(seq_entropy_bits(samp_seqs), 3),
    }

    # 4: gray-shift ablation: does a color cast summon W?
    w_idx = [f for f, flt in enumerate(filters)
             if type(flt).__name__ == 'ImprovedWhiteBalanceFilter']
    ablations = {}
    for name, scale in (('neutral', (1.0, 1.0, 1.0)),
                        ('warm_cast', (1.35, 1.0, 0.65)),
                        ('cool_cast', (0.65, 1.0, 1.35))):
        cast = torch.clamp(imgs * torch.tensor(scale, device=imgs.device),
                           0.0, 1.0)
        ids, _ = plan(cast, 7, 0)
        w_frac = float(np.isin(ids, w_idx).mean()) if w_idx else 0.0
        per_image_w = float(np.isin(ids, w_idx).any(axis=0).mean()) \
            if w_idx else 0.0
        ablations[name] = {
            'w_step_frac': round(w_frac, 4),
            'images_using_w_frac': round(per_image_w, 4),
        }
    report['gray_shift_ablation'] = ablations
    return report


def main(argv=None):
    from exposure_tpu_torch.tools import entry_device
    ap = argparse.ArgumentParser()
    ap.add_argument('--run', default='synthetic/parity-seed0')
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--keys', type=int, default=4)
    ap.add_argument('--out', default=None)
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    device = entry_device(args.device)

    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.tools import require_trained
    from exposure_tpu_torch.utils.config import load_config

    config_name, _ = args.run.split('/', 1)
    require_trained(args.run, args.model_root)
    cfg = load_config(config_name)
    cfg.name = args.run
    ev = Evaluator(cfg, model_root=args.model_root, device=device)
    random.seed(0)
    prov = cfg.fake_data_provider_test()
    inputs, _ = prov.get_next_batch(args.n)

    report = {'run': args.run, 'n': args.n,
              **analyze(cfg, ev, inputs, keys=args.keys)}
    print(json.dumps(report, indent=1))
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                data = json.load(f)
            existing = data if isinstance(data, list) else [data]
        existing.append(report)
        with open(args.out, 'w') as f:
            json.dump(existing, f, indent=1)
        print('# wrote', args.out)
    return report


if __name__ == '__main__':
    main()
