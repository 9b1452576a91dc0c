"""Make the auto-superset re-freeze fire under a policy swap (the port of
``exposure_tpu/tools/drive_refreeze.py``).

A pipeline with ``auto_superset=True`` and the bf16 plan serves ``--pre``
batches under policy A, which records the traffic's signatures and
freezes a (signature, bucket) layout; then it swaps to policy B
(``RetouchPipeline.load_policy``, which also remakes the plan's bfloat16
copy) and serves ``--post`` batches.  B picks another action mix, so the
rows that the frozen layout cannot place (the K2 merge's) drift past the
threshold and the pipeline re-freezes from B's statistics.  Then
``--recover`` batches run under the new layout.  It records each batch's
wall time (host clock to the device's end), the frozen slots, the drift
and the re-freezes, and the steady medians before, after and recovered.

The port's re-freeze is inline: the pipeline applies it in the batch that
crosses the threshold, since no program is compiled for a new layout on
the card (the JAX pipeline warmed it on a side thread).  So
``warm_pending`` is always false, and ``--max-wait`` is kept as a flag
alone: the drive has no wait loop.  Run B must be of run A's config.  The drive exits 1
when no re-freeze fired, with the drift it saw; the threshold is never
lowered to make one fire.

    python -m exposure_tpu_torch.tools.drive_refreeze \
        --run-a synthetic_explore/best --run-b synthetic_inject15/best \
        [--batch 256] [--res 512] [--pre 24] [--post 60] [--record 8] \
        [--max-wait 2400] [--recover 20] [--out PATH] [--model-root models] \
        [--device cpu]

The report is printed, and written only where ``--out`` asks.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch


def traffic(cfg, batch, res, device):
    """``batch`` images of the config's test provider, clipped, resized to
    ``res`` and quantized to u8 (truncated), on ``device``."""
    from exposure_tpu_torch.core.serving import proxy_resize
    base, _ = cfg.fake_data_provider_test().get_next_batch(batch)
    base = np.clip(np.asarray(base, np.float32), 0.0, 1.0)
    imgs = proxy_resize(torch.from_numpy(base).to(device), res)
    return (imgs * 255).to(torch.uint8)


def _steady(rows):
    """Median wall of the last 10 batches of a span."""
    w = [r['wall_s'] for r in rows][-10:]
    return float(np.median(w)) if w else None


def drive(pipe, imgs, policy_b, run_b, step_b, pre, post, recover,
          log=print):
    """Serve ``pre`` batches, swap to ``policy_b``, serve ``post``, then
    ``recover`` batches when a re-freeze fired (no wait between: the
    re-freeze is inline).  Returns ``(trace, refreeze_seen_at)``."""
    trace = []
    seen = [None]

    def one(i, phase):
        t0 = time.perf_counter()
        pipe(imgs, seed=i, device_out=True)
        if pipe.device.type == 'cuda':
            torch.cuda.synchronize(pipe.device)
        dt = time.perf_counter() - t0
        rep = pipe.superset_report()
        trace.append({'batch': i, 'phase': phase, 'wall_s': dt,
                      'frozen_slots': rep['frozen_slots'],
                      'drift_mean': rep['drift_mean'],
                      'refreezes': rep['refreezes'],
                      'warm_pending': rep['refreeze_warm_pending']})
        if rep['refreezes'] >= 1 and seen[0] is None:
            seen[0] = i
            log('# RE-FREEZE observed at batch %d' % i)
        if i % 10 == 0:
            log('# batch %3d [%s] %.4fs slots=%s drift=%s refreezes=%d'
                % (i, phase, dt, rep['frozen_slots'], rep['drift_mean'],
                   rep['refreezes']))

    for i in range(pre):
        one(i, 'A')
    log('# swapping to %s at batch %d' % (run_b, pre))
    pipe.load_policy(policy_b.state_dict(), run=run_b, step=step_b)
    for i in range(pre, pre + post):
        one(i, 'B')
    i = pre + post
    if seen[0] is not None:
        for _ in range(recover):
            one(i, 'R')
            i += 1
    return trace, seen[0]


def report(args, trace, seen, final):
    rows = {p: [r for r in trace if r['phase'] == p] for p in 'ABR'}
    steady = {p: _steady(rows[p]) for p in 'ABR'}

    def rate(p):
        return args.batch / steady[p] if steady[p] else None
    return {
        'run_a': args.run_a, 'run_b': args.run_b,
        'batch': args.batch, 'res': args.res,
        'auto_record_batches': args.record,
        'refreezes': final['refreezes'],
        'refreeze_first_seen_batch': seen,
        'swap_batch': args.pre,
        'steady_wall_A_s': steady['A'], 'steady_wall_B_s': steady['B'],
        'steady_imgs_per_s_A': rate('A'), 'steady_imgs_per_s_B': rate('B'),
        'steady_wall_recovered_s': steady['R'],
        'steady_imgs_per_s_recovered': rate('R'),
        'max_wall_after_swap_s': max((r['wall_s'] for r in rows['B']),
                                     default=0.0),
        'refreeze_inline': True,
        'final_report': final,
        'trace': trace,
    }


def run(argv=None):
    """What ``main`` does: returns ``(exit code, report, the pipeline
    after the drive, policy B, the traffic)``."""
    from exposure_tpu_torch.core.serving import RetouchPipeline
    from exposure_tpu_torch.tools import entry_device, served_policy
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--run-a', default='synthetic_explore/best')
    ap.add_argument('--run-b', default='synthetic_inject15/best')
    ap.add_argument('--batch', type=int, default=256)
    ap.add_argument('--res', type=int, default=512)
    ap.add_argument('--pre', type=int, default=24,
                    help='batches under policy A (freeze, steady state)')
    ap.add_argument('--post', type=int, default=60,
                    help='batches under policy B (drift, re-freeze)')
    ap.add_argument('--record', type=int, default=8)
    ap.add_argument('--max-wait', type=int, default=2400,
                    help='extra batches while a re-freeze waits on its '
                         'warm-up (the JAX flag, unused: the re-freeze is '
                         'inline)')
    ap.add_argument('--recover', type=int, default=20,
                    help='batches measured under the re-frozen layout')
    ap.add_argument('--out', default=None,
                    help='also write the report here (default: print only)')
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    if args.run_a.split('/', 1)[0] != args.run_b.split('/', 1)[0]:
        sys.exit('run B (%s) must be of run A\'s config (%s)'
                 % (args.run_b, args.run_a))
    cfg, _, policy_a, step_a, src_a = served_policy(
        args.run_a, args.model_root, device)
    _, _, policy_b, step_b, src_b = served_policy(
        args.run_b, args.model_root, device)
    for run, step, src in ((args.run_a, step_a, src_a),
                           (args.run_b, step_b, src_b)):
        print('# restored %s at step %d (%s)' % (run, step, src),
              file=sys.stderr)
    imgs = traffic(cfg, args.batch, args.res, device)
    pipe = RetouchPipeline(cfg, policy_a, device=device, run=args.run_a,
                           step=step_a, bf16=True, auto_superset=True,
                           auto_record_batches=args.record,
                           use_kernels=True)
    trace, seen = drive(pipe, imgs, policy_b, args.run_b, step_b, args.pre,
                        args.post, args.recover,
                        log=lambda m: print(m, file=sys.stderr))
    result = report(args, trace, seen, pipe.superset_report())
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
        print('# wrote %s' % args.out, file=sys.stderr)
    print(json.dumps({k: v for k, v in result.items() if k != 'trace'},
                     indent=1))
    code = 0
    if result['refreezes'] < 1:
        print('# no re-freeze: the drift after the swap (last mean %s) did '
              'not pass the threshold %s' % (
                  result['final_report']['drift_mean'],
                  pipe._ss_threshold), file=sys.stderr)
        code = 1
    return code, result, pipe, policy_b, imgs


def main(argv=None):
    return run(argv)[0]


if __name__ == '__main__':
    raise SystemExit(main())
