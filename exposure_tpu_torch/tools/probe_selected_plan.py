"""How often the selected-branch serving plan picks the bank plan's
filters (the port of ``exposure_tpu/tools/probe_selected_plan.py``).

``core/rollout.py::serve_rollout``, the dynamic mode's default plan,
advances the 64px proxy through K1 on the selected branch only, where the
training formulation (``rollout``) blends all 8 candidates of the bank.
The proxies differ by the kernel's tolerance against the plain filters,
which can flip an argmax at a near-tie; this probe counts how often it
does on a trained policy, per step and overall.  Both plans of a batch
draw their dropout from generators seeded alike (``100 + s`` for batch
``s``), so a difference is the plan's, not the draw's.

    python -m exposure_tpu_torch.tools.probe_selected_plan \
        [--run synthetic_explore/best] [--batch 512] [--batches 4] \
        [--f32] [--out PATH] [--device cpu]

The plan runs in bfloat16 unless ``--f32`` (as the JAX tool's); the report
is printed, and written only where ``--out`` asks.
"""

import argparse
import copy
import json
import sys

import numpy as np
import torch

SEED_BASE = 100


def plans(cfg, filters, policy, proxy, seed):
    """The bank plan's and the selected plan's [K, B] filter ids (numpy)
    on ``proxy`` under ``policy``, each plan under a fresh generator
    seeded with ``seed``."""
    from exposure_tpu_torch.core.rollout import rollout, serve_rollout

    def gen():
        return torch.Generator(device=proxy.device).manual_seed(seed)
    with torch.no_grad():
        bank = rollout(policy, proxy, gen(), cfg=cfg, filters=filters,
                       is_train=0).filter_ids
        selected = serve_rollout(policy, proxy, gen(), cfg=cfg,
                                 filters=filters, fast_math=True)[0]
    return bank.cpu().numpy(), selected.cpu().numpy()


def probe(cfg, filters, policy, proxy, seeds, bf16=True):
    """The agreement of the selected plan's [K, B] ids with the bank
    plan's on ``proxy`` ([B, S, S, 3] float32), one pair of ``plans`` a
    seed in ``seeds``.  Returns the JAX tool's report keys but ``run``."""
    if bf16:
        policy = copy.deepcopy(policy).to(torch.bfloat16)
        proxy = proxy.to(torch.bfloat16)
    batch = proxy.shape[0]
    agree = tot = 0
    per_step = None
    for seed in seeds:
        a, b = plans(cfg, filters, policy, proxy, seed)
        if per_step is None:
            per_step = np.zeros(a.shape[0], np.int64)
        per_step += (a == b).sum(axis=1)
        agree += int((a == b).sum())
        tot += a.size
    return {
        'batch': batch, 'batches': len(seeds), 'bf16': bool(bf16),
        'ids_total': int(tot), 'ids_agree': int(agree),
        'agreement': round(agree / tot, 6),
        'per_step_agreement': [round(float(x) / (batch * len(seeds)), 6)
                               for x in per_step],
    }


def main(argv=None):
    from exposure_tpu_torch.tools import entry_device, served_policy
    from exposure_tpu_torch.tools.export_serving import provider_proxy
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--run', default='synthetic_explore/best')
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--batches', type=int, default=4)
    ap.add_argument('--f32', action='store_true',
                    help='compare the f32 plans instead of the serving '
                         'default bf16 plans')
    ap.add_argument('--out', default=None,
                    help='also write the report here (default: print only)')
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    cfg, filters, policy, step, src = served_policy(
        args.run, args.model_root, device)
    print('# restored %s at step %d (%s)' % (args.run, step, src),
          file=sys.stderr)
    proxy = provider_proxy(cfg, device, args.batch)
    report = dict({'run': args.run}, **probe(
        cfg, filters, policy, proxy,
        [SEED_BASE + s for s in range(args.batches)], bf16=not args.f32))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
        print('# wrote %s' % args.out, file=sys.stderr)
    print(json.dumps(report))
    return report


if __name__ == '__main__':
    main()
