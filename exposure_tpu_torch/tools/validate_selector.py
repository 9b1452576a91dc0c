"""Retrospective validation of TARGET-FREE within-family selectors (the
port of ``exposure_tpu/tools/validate_selector.py``; pure numpy, so the
same code as the JAX tool but for the defaults below).

Problem (VERDICT r4, weak #1 / next #1): critic-consensus selection
(select_policy.py) correctly ABSTAINS on within-family pools — but the
shipped reliability workflow ("train N seeds with injection, keep the
best") then has no way to pick the 0.71-class seeds over the 0.55-class
seeds without ground-truth targets.  The reference sidesteps this by
shipping ONE author-selected pretrained model chosen WITH held-out
targets (reference README.md "pretrained models", .gitmodules:1-3); a
target-free replacement needs a discriminant that is free at selection
time.

This tool validates candidate discriminants RETROSPECTIVELY against
every recorded quality campaign (PARITY_*.json), each of which carries,
per seed, both the free signals and the ground-truth 3-stat
histogram-intersection score:

- ``neg_emd``   : -final_emd — the critic's real/fake Wasserstein gap at
                  convergence (metrics.jsonl ``emd``; no targets).
- ``neg_ct``    : -Ct filter usage on held-out inputs (the DIVERSITY.md
                  addendum measured Ct-usage rank-predicting contrast
                  intersection at Spearman -1.0 on the explore pool);
                  computable live from planned trajectories.
- ``neg_gloss`` : -final generator loss (control; expected weak).
- ``div``       : distinct_sequences_frac (control).
- ``comp2``     : rank-mean of ``neg_emd`` and ``neg_ct`` — the shipped
                  composite.  The two components fail on DISJOINT pools
                  (emd works where the pool splits on convergence
                  quality, Ct-usage where it splits on the
                  Ct-everywhere lock-in), so their rank-mean covers
                  both failure modes.

Per pool it reports each selector's Spearman rank correlation vs
measured ``quality.avg_after``, the top-1 hit, and the REGRET
(best avg_after minus the selected seed's avg_after) — regret is the
deployment-relevant number: a selector can have middling rho yet zero
regret if it always avoids the bad seeds.

Usage:
  python -m exposure_tpu_torch.tools.validate_selector [--out PATH]
      [--pools PARITY_*.json ...] [--min-n 4]

The pools default to the ``PARITY_*.json`` records in the working
directory, which it only reads; the report is printed, and written only
where ``--out`` asks (the JAX tool's default, ``SELECT_R5.json``, is a
record of the JAX package).

The winning selector is wired into select_policy.py as the
within-family fallback ranking used when consensus abstains.
"""

import argparse
import glob
import json

import numpy as np


def rankdata(x):
    """Average-rank (ties shared), ascending — scipy-free."""
    x = np.asarray(x, dtype=np.float64)
    order = np.argsort(x, kind='mergesort')
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def spearman(a, b):
    ra, rb = rankdata(a), rankdata(b)
    if ra.std() == 0 or rb.std() == 0:
        return 0.0
    return float(np.corrcoef(ra, rb)[0, 1])


# selector -> function(run_record) -> score (higher = pick first)
SELECTORS = {
    'neg_emd': lambda r: -r['final_emd'],
    'neg_ct': lambda r: -r['trajectories']['filter_usage'].get('Ct', 0),
    'neg_gloss': lambda r: -r['final_g_loss'],
    'div': lambda r: r['trajectories']['distinct_sequences_frac'],
}


def composite_rank_mean(records, keys, weights=None):
    """(Weighted) rank-mean composite: average each selector's rank."""
    n = len(records)
    mean = np.zeros(n)
    weights = weights or [1.0] * len(keys)
    for k, w in zip(keys, weights):
        scores = np.array([SELECTORS[k](r) for r in records])
        # rank 1 = highest score
        mean += w * ((n + 1) - rankdata(scores))
    return -mean / sum(weights)  # higher = better


# the SHIPPED selector is comp2; the others are recorded alternates.
# comp3gl scored better retrospectively (6/8 pools >=0.6, 4 top-1) but
# its third signal (-g_loss) is noise alone (mean rho 0.04) with no
# mechanism story — with only 8 pools that improvement is as likely
# selection luck as signal, so it ships as an alternate pending the
# pre-registered prospective test on the inject15 n=5 pool.
COMPOSITES = {
    'comp2': (['neg_emd', 'neg_ct'], None),
    'comp3gl': (['neg_emd', 'neg_ct', 'neg_gloss'], None),
    'emd1ct2': (['neg_emd', 'neg_ct'], [1.0, 2.0]),
}


def eval_pool(name, records, selector_scores):
    truth = np.array([r['quality']['avg_after'] for r in records])
    best = float(truth.max())
    out = {}
    for sel, scores in selector_scores.items():
        scores = np.asarray(scores, dtype=np.float64)
        pick = int(np.argmax(scores))
        out[sel] = {
            'spearman': round(spearman(scores, truth), 4),
            'picked_seed': records[pick].get('seed', pick),
            'picked_quality': round(float(truth[pick]), 4),
            'regret': round(best - float(truth[pick]), 4),
            'top1': bool(truth[pick] == best),
        }
    return {'n': len(records), 'best_quality': round(best, 4),
            'worst_quality': round(float(truth.min()), 4),
            'selectors': out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--pools', nargs='*', default=None)
    ap.add_argument('--min-n', type=int, default=3)
    ap.add_argument('--out', default=None,
                    help='also write the report here (default: print only)')
    args = ap.parse_args(argv)

    paths = args.pools or sorted(glob.glob('PARITY_*.json'))
    pools = {}
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        runs = d.get('runs') if isinstance(d, dict) else d
        if not runs or not isinstance(runs, list):
            continue
        runs = [r for r in runs
                if 'final_emd' in r and 'quality' in r
                and 'trajectories' in r]
        if len(runs) >= args.min_n:
            pools[p] = runs

    all_keys = list(SELECTORS) + list(COMPOSITES)
    result = {'shipped': 'comp2', 'pools': {}, 'aggregate': {}}
    for name, records in sorted(pools.items()):
        sel_scores = {k: [SELECTORS[k](r) for r in records]
                      for k in SELECTORS}
        for cname, (keys, w) in COMPOSITES.items():
            sel_scores[cname] = composite_rank_mean(records, keys, w)
        result['pools'][name] = eval_pool(name, records, sel_scores)

    for sel in all_keys:
        rows = [result['pools'][p]['selectors'][sel]
                for p in result['pools']]
        rhos = [r['spearman'] for r in rows]
        result['aggregate'][sel] = {
            'pools': len(rows),
            'mean_spearman': round(float(np.mean(rhos)), 4),
            'min_spearman': round(float(np.min(rhos)), 4),
            'pools_ge_0.6': int(sum(r >= 0.6 for r in rhos)),
            'top1_hits': int(sum(r['top1'] for r in rows)),
            'mean_regret': round(float(np.mean(
                [r['regret'] for r in rows])), 4),
            'max_regret': round(float(np.max(
                [r['regret'] for r in rows])), 4),
        }

    print('%-10s %6s %6s %7s %5s %7s %7s' %
          ('selector', 'meanR', 'minR', '>=0.6', 'top1', 'meanRg',
           'maxRg'))
    for sel in all_keys:
        a = result['aggregate'][sel]
        print('%-10s %6.3f %6.3f %4d/%-2d %5d %7.3f %7.3f' %
              (sel, a['mean_spearman'], a['min_spearman'],
               a['pools_ge_0.6'], a['pools'], a['top1_hits'],
               a['mean_regret'], a['max_regret']))
    print()
    for p in result['pools']:
        row = result['pools'][p]
        print('%-28s n=%d best=%.3f worst=%.3f comp2: rho=%+.2f '
              'pick=%.3f regret=%.3f' %
              (p, row['n'], row['best_quality'], row['worst_quality'],
               row['selectors']['comp2']['spearman'],
               row['selectors']['comp2']['picked_quality'],
               row['selectors']['comp2']['regret']))

    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
        print('# wrote %s' % args.out)
    else:
        print(json.dumps(result))
    return result


if __name__ == '__main__':
    main()
