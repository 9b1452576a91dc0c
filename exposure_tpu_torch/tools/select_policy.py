"""Unsupervised model selection by critic consensus (the port of
``exposure_tpu/tools/select_policy.py``).

The JAX package's quality campaigns found (CRITIC_PROBE.json,
CRITIC_PROBE_EXPLORE.json) that ranking N trained seeds by the MEAN RANK
their outputs receive across all N runs' critics reproduced the
ground-truth histogram-intersection quality ordering within a same-config
pool: the WGAN critics collectively know which policy is best, even though
no single run's reward told its generator so.  That turns the "train N
seeds, keep the best" workflow into an unsupervised one: no retouched
targets are needed at selection time, only the candidate checkpoints.

SCOPE: the consensus signal separates POLICY FAMILIES; it flags seeds
locked into the inferior Ct-everywhere optimum.  On a pool where all seeds
land in the SAME family the fine within-family ordering is NOT recovered
(SELECT.json).  Use consensus to reject locked-in seeds; use ``--truth`` +
``--promote-by truth`` when a target set exists and candidates are within
one family.

ABSTAIN: the tool DETECTS which regime a pool is in without targets: the
median per-critic output spread relative to each critic's own
output-vs-raw-inputs gap (``probe_critic_family.family_separation``).
Below ``ABSTAIN_THRESHOLD`` the verdict is ``abstain``: consensus declares
no winner.

COMP2 FALLBACK: when consensus abstains, the tool falls back to the
``comp2`` target-free WITHIN-family discriminant, the rank-mean of
(-final_emd, -Ct-usage), validated retrospectively on the recorded
campaign pools (SELECT_R5.json; ``tools/validate_selector.py``).  Both
signals are free at selection time: ``final_emd`` is the critic's
real/fake Wasserstein gap from the run's own metrics.jsonl, and Ct-usage
is counted from the trajectories this tool already plans on the held-out
inputs.  ``--promote`` therefore always has a target-free winner:
consensus when the pool splits by family, comp2 within one.

This tool runs that selection end to end:

1. restore every candidate run's full train state;
2. retouch the SAME held-out inputs with each policy (critic-native
   64 px resolution; on the card one K1 launch a run);
3. score every candidate's outputs with every candidate's critic;
4. rank by consensus (``probe_critic_family.consensus_ranking``) and
   report the winner; ``--promote NAME`` symlinks
   ``<model-root>/<config>/NAME`` at the winning run (a relative link
   within that directory) so that the CLIs (``evaluate_torch.py``, the
   tools' ``--run``) can address it stably.  A file or directory that is
   not a symlink is never replaced.

Usage:
  python -m exposure_tpu_torch.tools.select_policy \\
      --config synthetic_explore --runs parity-seed0 parity-seed1 ... \\
      [--n 256] [--model-root models] [--out PATH] [--promote best] \\
      [--truth PARITY.json] [--promote-by consensus|truth|comp2] \\
      [--device cpu]

The report is printed, and written only where ``--out`` asks.
Differences from the JAX tool: the plans' dropout stream is
``core/serving.py::batch_generator(0, 0, device)`` (the JAX tool's
``PRNGKey(0)``), and the global ``random`` module, which the test provider
draws from, is seeded with 0 before the inputs are drawn.
"""

import argparse
import json
import os
import random

import numpy as np

from exposure_tpu_torch.tools.probe_critic_family import (
    ABSTAIN_THRESHOLD,
    consensus_ranking,
    family_separation,
    score_row,
)
from exposure_tpu_torch.tools.validate_selector import rankdata


def comp2_scores(runs, ct_usage, final_emd):
    """Rank-mean of (-final_emd, -Ct-usage); higher = pick first.

    The shipped within-family selector (SELECT_R5.json): the two
    components fail on DISJOINT pools (emd tracks convergence quality,
    Ct-usage the Ct-everywhere lock-in), so the rank-mean covers both.
    """
    n = len(runs)
    mean = np.zeros(n)
    for sig in (np.array([-final_emd[r] for r in runs]),
                np.array([-float(ct_usage[r]) for r in runs])):
        mean += (n + 1) - rankdata(sig)  # rank 1 = best
    return {r: -float(mean[i]) / 2.0 for i, r in enumerate(runs)}


def score_matrix(runs, evs, outputs):
    """Every run's critic on every run's outputs -> nested mean/std."""
    return {'critic:' + run: score_row(ev, outputs)
            for run, ev in zip(runs, evs)}


def main(argv=None):
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.serving import batch_generator
    from exposure_tpu_torch.tools import entry_device, require_trained
    from exposure_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--runs', nargs='+', required=True,
                    help='run names under <model-root>/<config>/')
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--out', default=None,
                    help='also write the report here (default: print only)')
    ap.add_argument('--promote', default=None,
                    help='symlink <model-root>/<config>/<PROMOTE> -> winner')
    ap.add_argument('--truth', default=None,
                    help='a validate_parity JSON covering the same runs: '
                         'cross-check the consensus ranking against the '
                         'measured quality ordering (Spearman)')
    ap.add_argument('--promote-by', choices=('consensus', 'truth', 'comp2'),
                    default='consensus',
                    help='which winner --promote points at (truth '
                         'requires --truth; consensus falls back to '
                         'comp2 automatically on abstain; comp2 forces '
                         'the within-family discriminant)')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    if args.promote_by == 'truth' and not args.truth:
        ap.error('--promote-by truth requires --truth')
    device = entry_device(args.device)
    for run in args.runs:
        require_trained('%s/%s' % (args.config, run), args.model_root)

    random.seed(0)
    cfg0 = load_config(args.config)
    inputs, _ = cfg0.fake_data_provider_test().get_next_batch(args.n)
    inputs = np.clip(inputs, 0.0, 1.0).astype(np.float32)

    # the raw inputs are the anchor for the abstain statistic: each
    # critic's output-vs-input gap calibrates the scale of its
    # preferences (family_separation docstring)
    evs, outputs = [], {'inputs': inputs}
    ct_usage, final_emd = {}, {}
    for run in args.runs:
        cfg = load_config(args.config)
        cfg.name = '%s/%s' % (args.config, run)
        ev = Evaluator(cfg, model_root=args.model_root, device=device)
        traj, _ = ev.plan_trajectory(inputs,
                                     batch_generator(0, 0, ev.device))
        outputs['out:' + run] = np.clip(ev.retouch(inputs, traj), 0.0, 1.0)
        evs.append(ev)
        # comp2 signals (free at selection time): Ct usage on the
        # held-out plan, final critic EMD from the run's own metrics
        ids = traj.filter_ids.cpu().numpy()
        active = np.asarray(ev.active_mask(traj)) > 0
        short = [f.get_short_name() for f in ev.filters]
        ct = short.index('Ct') if 'Ct' in short else None
        ct_usage[run] = (int(((ids == ct) & active).sum())
                         if ct is not None else 0)
        mpath = os.path.join(args.model_root, cfg.name, 'metrics.jsonl')
        final_emd[run] = float('nan')
        if os.path.exists(mpath):
            with open(mpath) as f:
                lines = f.readlines()
            if lines:
                final_emd[run] = float(
                    json.loads(lines[-1]).get('emd', float('nan')))

    matrix = score_matrix(args.runs, evs, outputs)
    out_names = ['out:' + r for r in args.runs]
    ranking, mean_rank = consensus_ranking(matrix, out_names)
    winner = ranking[0][len('out:'):]
    separation, sep_per_critic = family_separation(matrix, out_names)
    abstain = separation is not None and separation < ABSTAIN_THRESHOLD
    print('# consensus ranking (most real first): %s'
          % [n[len('out:'):] for n in ranking])
    print('# family separation: %.3f (abstain threshold %.2f)'
          % (separation, ABSTAIN_THRESHOLD))
    comp2 = comp2_scores(args.runs, ct_usage, final_emd)
    comp2_ranking = sorted(args.runs, key=lambda r: -comp2[r])
    comp2_winner = comp2_ranking[0]
    if abstain:
        print('# verdict: ABSTAIN: pool shows no family split; '
              'within-family ordering is not recoverable by critic '
              'consensus (SELECT.json).')
        print('# comp2 fallback (rank-mean of -emd, -Ct-usage; '
              'SELECT_R5.json): %s -> winner %s/%s'
              % (comp2_ranking, args.config, comp2_winner))
    else:
        print('# winner: %s/%s' % (args.config, winner))

    result = {
        'config': args.config,
        'runs': args.runs,
        'n_eval': args.n,
        'critic_score_matrix': matrix,
        'consensus_ranking': ranking,
        'consensus_mean_rank': {n: round(v, 3)
                                for n, v in mean_rank.items()},
        'family_separation': round(separation, 4),
        'family_separation_per_critic': {
            c: round(v, 4) for c, v in sep_per_critic.items()},
        'abstain_threshold': ABSTAIN_THRESHOLD,
        'verdict': 'abstain' if abstain else 'rank',
        'winner': comp2_winner if abstain else winner,
        'winner_by': 'comp2' if abstain else 'consensus',
        'comp2': {
            'ranking': comp2_ranking,
            'scores': {r: round(comp2[r], 3) for r in args.runs},
            'ct_usage': ct_usage,
            'final_emd': {r: round(final_emd[r], 3) for r in args.runs},
        },
    }

    if args.truth:
        with open(args.truth) as f:
            truth = json.load(f)
        entries = truth['runs'] if isinstance(truth, dict) else truth
        quality = {e['run'].split('/', 1)[1]: e['quality']['avg_after']
                   for e in entries
                   if e['run'].split('/', 1)[0] == args.config}
        common = [r for r in args.runs if r in quality]
        if len(common) >= 2:
            cons = np.argsort(np.argsort(
                [mean_rank['out:' + r] for r in common]))
            true = np.argsort(np.argsort(
                [-quality[r] for r in common]))
            rho = float(np.corrcoef(cons, true)[0, 1])
            result['truth_quality'] = {r: quality[r] for r in common}
            result['spearman_vs_truth'] = round(rho, 4)
            result['truth_winner'] = max(common, key=lambda r: quality[r])
            print('# consensus vs measured quality: Spearman %.3f '
                  '(truth winner: %s)' % (rho, result['truth_winner']))

    if args.promote:
        if args.promote_by == 'truth':
            if 'truth_winner' not in result:
                raise SystemExit('--promote-by truth: no overlapping '
                                 'runs found in %s' % args.truth)
            target = result['truth_winner']
        elif args.promote_by == 'comp2' or abstain:
            if abstain and args.promote_by == 'consensus':
                print('# abstain: family separation %.3f < %.2f: '
                      'promoting the comp2 fallback winner'
                      % (separation, ABSTAIN_THRESHOLD))
            target = comp2_winner
            result['winner_by'] = 'comp2'
        else:
            target = winner  # relative: same directory level
        link = os.path.join(args.model_root, args.config, args.promote)
        if os.path.islink(link):
            os.unlink(link)
        elif os.path.exists(link):
            raise SystemExit('refusing to replace non-symlink %s' % link)
        os.symlink(target, link)
        result['promoted'] = link
        print('# promoted: %s -> %s' % (link, target))

    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
        print('# wrote %s' % args.out)
    else:
        print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
