"""Export a trained run's policy as a serving artifact (the port of
``exposure_tpu/tools/export_serving.py``).

    python -m exposure_tpu_torch.tools.export_serving --run <config>/<run> \
        [--out PATH] [--verify] [--dtype float32|float16] \
        [--model-root models] [--device cpu]

Restores the run's newest checkpoint (``core/checkpoint.py``, which reads
either package's files) and writes the generator-only artifact
(``core/artifacts.py``; float32 by default, which restores bit for bit).
With ``--verify`` it restores the artifact into a fresh template state,
checks every leaf and the step against the checkpoint, prints the worst
``|f32 - f16|``, then plans 32 images of the config's
``fake_data_provider_test`` with the bank rollout (``is_train=0``) on both
parameter sets, each under a generator seeded alike, and prints the
fraction of filter ids that differ: 0 at float32, a few near-tie argmax
decisions at float16.  Above 0.02 it exits 1, as the JAX tool does.

It never writes over a file: without ``--out`` it writes to the run's
``artifact_path`` under ``artifacts/serving/`` only when no file is there,
and otherwise asks for ``--out``.  The plan runs on the card unless
``--device cpu`` is asked for.
"""

import argparse
import os
import sys

import numpy as np
import torch

MISMATCH_LIMIT = 0.02
VERIFY_BATCH = 32
VERIFY_SEED = 0


def _load(run, model_root, device):
    """``(cfg, filters, nets, state, step)`` of the run's newest
    checkpoint."""
    from exposure_tpu_torch.core.checkpoint import restore_checkpoint
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.config import load_config
    cfg = load_config(run.split('/', 1)[0])
    cfg.name = run
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, seed=0,
                             device=device)
    state, step = restore_checkpoint(os.path.join(model_root, run), state)
    return cfg, filters, (policy, critic, value), state, step


def plan_ids(cfg, filters, policy, gen_params, proxy, seed=VERIFY_SEED):
    """The bank plan's [K, B] filter ids of ``proxy`` under the generator
    parameters ``gen_params``, dropout drawn from a generator seeded
    ``seed``."""
    from exposure_tpu_torch.core.rollout import rollout
    policy.load_state_dict(gen_params)
    policy = policy.to(proxy.device).eval()
    g = torch.Generator(device=proxy.device).manual_seed(seed)
    with torch.no_grad():
        return rollout(policy, proxy, g, cfg=cfg, filters=filters,
                       is_train=0).filter_ids.cpu().numpy()


def provider_proxy(cfg, device, batch=VERIFY_BATCH):
    """``batch`` images of the config's test provider, clipped and resized
    to the proxy, on ``device``."""
    from exposure_tpu_torch.core.serving import proxy_resize
    base, _ = cfg.fake_data_provider_test().get_next_batch(batch)
    base = np.clip(np.asarray(base, np.float32), 0.0, 1.0)
    if base.ndim == 5:
        base = base[:, 0]
    return proxy_resize(torch.from_numpy(np.ascontiguousarray(base))
                        .to(device), cfg.source_img_size)


def verify(cfg, filters, nets, state, step, path, device):
    """The round trip of ``--verify``: returns ``(report, exit code)``."""
    from exposure_tpu_torch.core.artifacts import restore_serving_artifact
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    _, policy, critic, value = build_models(cfg)
    template = init_train_state(cfg, policy, critic, value, seed=0,
                                device=device)
    restored, rstep = restore_serving_artifact(path, template)
    if rstep != step:
        raise AssertionError('artifact step %d, checkpoint step %d'
                             % (rstep, step))
    src, dst = state.gen_params, restored.gen_params
    if sorted(src) != sorted(dst):
        raise AssertionError('artifact leaves %s differ from the '
                             'checkpoint\'s' % sorted(set(src) ^ set(dst)))
    worst = max(float((src[k].float() - dst[k]).abs().max()) for k in src)
    print('# verify: %d leaves, worst |f32 - f16| = %.3e'
          % (len(src), worst))
    proxy = provider_proxy(cfg, device)
    ids_a = plan_ids(cfg, filters, nets[0], src, proxy)
    ids_b = plan_ids(cfg, filters, nets[0], dst, proxy)
    differ = int((ids_a != ids_b).sum())
    mism = differ / float(ids_a.size)
    print('# verify: filter-id decision mismatch %.4f (%d/%d)'
          % (mism, differ, ids_a.size))
    report = {'step': step, 'leaves': len(src), 'worst_abs': worst,
              'mismatch': mism,
              'ids_differ': differ, 'ids_total': int(ids_a.size)}
    if mism > MISMATCH_LIMIT:
        print('# WARNING: f16 artifact shifts >2%% of decisions',
              file=sys.stderr)
        return report, 1
    return report, 0


def run(argv=None):
    """What ``main`` does: returns ``(exit code, --verify's report or
    None)``."""
    from exposure_tpu_torch.core.artifacts import (
        artifact_path,
        export_serving_artifact,
    )
    from exposure_tpu_torch.tools import entry_device
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--run', required=True,
                    help='<config>/<run> under --model-root')
    ap.add_argument('--out', default=None,
                    help='where to write (default: the run\'s artifact '
                         'path, only when no file is there)')
    ap.add_argument('--verify', action='store_true')
    ap.add_argument('--model-root', default='models')
    ap.add_argument('--dtype', default='float32',
                    choices=('float32', 'float16'),
                    help='float32 (default): bit-exact restore; '
                         'float16: half the size, a few near-tie argmax '
                         'decisions flip')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = entry_device(args.device)

    out = args.out
    if out is None:
        out = artifact_path(args.run)
        if os.path.exists(out):
            sys.exit('%s exists: pass --out to write the artifact elsewhere '
                     '(this tool never writes over a file unasked)' % out)
    cfg, filters, nets, state, step = _load(args.run, args.model_root,
                                            device)
    path = export_serving_artifact(args.run, state, step, out,
                                   dtype=args.dtype)
    print('# exported %s (step %d) -> %s (%.1f MB)'
          % (args.run, step, path, os.path.getsize(path) / 1e6))
    if args.verify:
        report, code = verify(cfg, filters, nets, state, step, path, device)
        return code, report
    return 0, None


def main(argv=None):
    return run(argv)[0]


if __name__ == '__main__':
    raise SystemExit(main())
