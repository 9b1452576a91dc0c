"""Critic-side probe of the Ct/C policy-family bimodality (the port of
``exposure_tpu/tools/probe_critic_family.py``).

Seeds of the same config can converge to two reward-equivalent families:
gentle per-channel curves (C, high contrast-intersection) against uniform
aggressive cosine contrast (Ct, low).  The question is WHERE the signal
that would separate them dies:

  (a) the trained CRITIC cannot tell the families' outputs apart
      (capacity / gradient-penalty Lipschitz budget spent on the
      dominant luminance axis), or
  (b) the critic CAN tell (it scores the other family's outputs as
      more real than its own policy's) and the GENERATOR never found
      the better family (RL exploration / local optimum).

This tool measures it directly.  For each run it restores the full train
state, retouches the SAME held-out inputs with its policy (64 px, the
critic's native resolution; on the card one K1 launch a run), then scores
every run's outputs plus the real targets and the raw inputs with EVERY
run's critic (higher Wasserstein logit = more real, ``core/losses.py``
``critic_loss``).  It also records the per-patch statistics of each
family's actual outputs against the targets (4x4 luminance-patch std by
mean bin; dark-patch fraction).

Usage:
  python -m exposure_tpu_torch.tools.probe_critic_family \\
      --runs synthetic_tex/parity-seed0 synthetic_tex/parity-seed2 \\
      [--n 256] [--model-root models] [--out PATH] [--device cpu]

The report is printed, and written only where ``--out`` asks.
Differences from the JAX tool: the plans' dropout stream is
``core/serving.py::batch_generator(0, 0, device)`` (the JAX tool's
``PRNGKey(0)``), and the global ``random`` module, which the providers
draw from, is seeded with 0 before the inputs and targets are drawn.
"""

import argparse
import json
import random

import numpy as np

LUM_W = np.asarray([0.27, 0.67, 0.06], np.float32)


def consensus_ranking(matrix, out_names):
    """Rank candidate output sets by mean rank across ALL critics.

    ``matrix`` maps critic name -> {candidate name: {'mean': logit}};
    rank 1 = scored most real by that critic.  Returns (ranking,
    mean_rank) with the ranking most-real-first.  Within a same-config seed
    pool the JAX records found this reproduces the ground-truth
    histogram-intersection ordering: an unsupervised model selector
    needing no targets at selection time.
    """
    mean_rank = {n: 0.0 for n in out_names}
    for row in matrix.values():
        ordered = sorted(out_names, key=lambda n: -row[n]['mean'])
        for rank, n in enumerate(ordered, 1):
            mean_rank[n] += rank / len(matrix)
    ranking = sorted(out_names, key=lambda n: mean_rank[n])
    return ranking, mean_rank


def family_separation(matrix, out_names, anchor='inputs'):
    """Median per-critic RELATIVE output spread: the abstain statistic.

    The consensus ranking separates policy FAMILIES but can be
    anti-correlated with quality inside one family.  What distinguishes
    the two regimes is the ABSOLUTE scale of the critics' preferences: on
    a family-split pool each critic's spread across candidate outputs is a
    sizeable fraction of its own output-vs-raw-inputs gap; inside one
    family the residual preferences are far smaller relative to the same
    gap.  So: for every critic compute ``(max - min over candidate
    outputs) / (mean(outputs) - score(anchor))`` and take the MEDIAN over
    critics (robust to one noisy critic).  Returns (median_ratio,
    per_critic_ratios); callers abstain below ``ABSTAIN_THRESHOLD``.

    ``anchor`` names a matrix column scored on the UNRETOUCHED inputs,
    available at selection time with no targets, which is the whole point
    of unsupervised selection.
    """
    ratios = {}
    for critic, row in matrix.items():
        if anchor not in row:
            continue
        outs = [row[n]['mean'] for n in out_names]
        spread = max(outs) - min(outs)
        gap = sum(outs) / len(outs) - row[anchor]['mean']
        ratios[critic] = spread / max(gap, 1e-9)
    if not ratios:
        return None, {}
    vals = sorted(ratios.values())
    mid = len(vals) // 2
    median = vals[mid] if len(vals) % 2 else \
        0.5 * (vals[mid - 1] + vals[mid])
    return median, ratios


# below this median relative spread the pool shows no family split and
# the consensus ordering is noise (see family_separation docstring)
ABSTAIN_THRESHOLD = 0.10


def patch_profile(images, patch=4):
    """Median 4x4 luminance-patch std per patch-mean bin + dark-patch
    fraction: the per-patch statistics that separate an over-contrasted
    output from an artist-style target."""
    lum = (np.asarray(images, np.float32) * LUM_W).sum(-1)
    n, h, w = lum.shape
    hp, wp = h // patch, w // patch
    p = lum[:, :hp * patch, :wp * patch].reshape(
        n, hp, patch, wp, patch).transpose(0, 1, 3, 2, 4).reshape(
        -1, patch * patch)
    m, s = p.mean(-1), p.std(-1)
    prof = {}
    for lo, hi in ((0.0, 0.1), (0.4, 0.6), (0.7, 0.8), (0.8, 0.9),
                   (0.9, 1.01)):
        sel = (m >= lo) & (m < hi)
        prof['%.1f-%.1f' % (lo, hi)] = {
            'frac': round(float(sel.mean()), 4),
            'med_std': round(float(np.median(s[sel])), 4)
            if sel.any() else None,
        }
    prof['flat_frac'] = round(float((s < 2e-3).mean()), 4)
    return prof


def score_row(ev, candidates):
    """``ev``'s critic on every candidate set: ``{name: {'mean', 'std'}}``
    of the logits, rounded as the JAX tool rounds them."""
    row = {}
    for name, imgs in candidates.items():
        logits = ev.critic_logits(imgs)
        row[name] = {'mean': round(float(logits.mean()), 4),
                     'std': round(float(logits.std()), 4)}
    return row


def main(argv=None):
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.serving import batch_generator
    from exposure_tpu_torch.tools import entry_device, require_trained
    from exposure_tpu_torch.tools.validate_parity import trajectory_stats
    from exposure_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument('--runs', nargs='+', required=True,
                    help='<config>/<run> entries (same config family)')
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--out', default=None,
                    help='also write the report here (default: print only)')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    for run in args.runs:
        require_trained(run, args.model_root)

    random.seed(0)
    cfg0 = load_config(args.runs[0].split('/', 1)[0])
    inputs, _ = cfg0.fake_data_provider_test().get_next_batch(args.n)
    inputs = np.clip(inputs, 0.0, 1.0).astype(np.float32)
    targets, _ = cfg0.real_data_provider().get_next_batch(args.n)
    targets = np.clip(targets, 0.0, 1.0).astype(np.float32)

    evs, outputs, labels = [], [], []
    for run in args.runs:
        config_name, _ = run.split('/', 1)
        cfg = load_config(config_name)
        cfg.name = run
        ev = Evaluator(cfg, model_root=args.model_root, device=device)
        traj, _ = ev.plan_trajectory(inputs,
                                     batch_generator(0, 0, ev.device))
        out = np.clip(ev.retouch(inputs, traj), 0.0, 1.0)
        stats = trajectory_stats(cfg, ev, inputs)
        evs.append(ev)
        outputs.append(out)
        labels.append(stats['filter_usage'])
        print('# %s usage: %s' % (run, stats['filter_usage']))

    candidates = {'targets': targets, 'inputs': inputs}
    for run, out in zip(args.runs, outputs):
        candidates['out:' + run] = out

    # score matrix: every run's critic on every candidate set
    matrix = {}
    for run, ev in zip(args.runs, evs):
        row = score_row(ev, candidates)
        matrix['critic:' + run] = row
        own = row['out:' + run]['mean']
        others = {n: v['mean'] for n, v in row.items()
                  if n.startswith('out:') and n != 'out:' + run}
        print('# critic %s: targets %.3f | own out %.3f | others %s'
              % (run, row['targets']['mean'], own,
                 {k.split('/')[-1]: v for k, v in others.items()}))

    out_names = ['out:' + r for r in args.runs]
    consensus, mean_rank = consensus_ranking(matrix, out_names)
    print('# consensus ranking (most real first): %s'
          % [n.split('/')[-1] for n in consensus])

    profiles = {name: patch_profile(imgs)
                for name, imgs in candidates.items()}

    result = {
        'runs': args.runs,
        'n_eval': args.n,
        'filter_usage': dict(zip(args.runs, labels)),
        'critic_score_matrix': matrix,
        'consensus_ranking': consensus,
        'consensus_mean_rank': {n: round(v, 3)
                                for n, v in mean_rank.items()},
        'patch_profiles': profiles,
        'reading': 'higher critic logit = more real (critic_loss '
                   'minimizes mean(fake)-mean(real)); if a critic '
                   'scores another family ABOVE its own policy '
                   'output, the generator failed to find that '
                   'family (exploration), not the critic to see it',
    }
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
        print('# wrote %s' % args.out)
    else:
        print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
