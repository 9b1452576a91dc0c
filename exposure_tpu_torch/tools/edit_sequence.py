"""White-box sequence editing: modify one step of a recorded retouch
and replay it at full resolution (torch counterpart of
``exposure_tpu/tools/edit_sequence.py``).

Every edit of the white-box approach is a named operation with human-
meaningful parameters, so a user can disagree with one step ("half the
exposure boost, keep everything else") and get exactly that.

Workflow (one command):

  python -m exposure_tpu_torch.tools.edit_sequence \
      --config synthetic_explore --debug outputs/photo.png_debug.pkl \
      --image photo.png --step 0 --scale 0.5 \
      --out-dir outputs/edit

reads the per-step debug pickle an evaluation wrote (filter ids +
regressed parameters; either package's), applies the requested parameter
edit to one step, and replays both the original and the edited sequence on
the full-resolution linear image: one launch of the dynamic chain kernel
(K1) on the card, which raises if it cannot launch, and the branchless
chain on the CPU (``--device cpu``).  It saves ``before.png`` /
``after.png`` plus an ``edit.json`` operation table.

Edits operate on the regressed parameter values, the same numbers the
steps figure and the TikZ export show (e.g. ExposureFilter param 0 is
the gain in stops):

  --scale S          multiply every parameter of the step by S
  --set I=V [I=V..]  set parameter I of the step to V
  --drop             skip the step entirely (identity)
"""

import argparse
import json
import os
import pickle

import numpy as np


def load_debug(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def pack_trajectory(debug, filters):
    """Rebuild the packed [K, 1, ...] arrays the chain replay consumes
    from a per-step debug list (``Evaluator.eval``)."""
    from exposure_tpu_torch.ops.filters import max_filter_parameters

    max_p = max_filter_parameters(filters)
    max_m = max(f.get_num_mask_parameters() for f in filters)
    k = len(debug)
    ids = np.zeros((k, 1), np.int32)
    params = np.zeros((k, 1, max_p), np.float32)
    masks = np.zeros((k, 1, max(max_m, 1)), np.float32)
    active = np.zeros((k, 1), np.float32)
    for i, step in enumerate(debug):
        ids[i, 0] = step['filter_id']
        fp = np.asarray(step['filter_parameters'], np.float32)
        params[i, 0, :fp.shape[0]] = fp
        # unmasked runs' debug pickles may omit mask_parameters
        mp = np.asarray(step.get('mask_parameters', ()), np.float32)
        if mp.size:
            masks[i, 0, :mp.shape[0]] = mp
        active[i, 0] = 1.0 if step['applied'] else 0.0
    return ids, params, masks, active


def apply_edit(debug, step, scale=None, sets=(), drop=False):
    """Return (edited debug list, human-readable edit record)."""
    edited = [dict(s) for s in debug]
    target = edited[step]
    before = np.asarray(target['filter_parameters'],
                        np.float32).copy()
    record = {'step': step, 'filter': target.get('short_name', '?'),
              'params_before': before.tolist()}
    if drop:
        target['applied'] = False
        record['edit'] = 'drop'
        return edited, record
    after = before.copy()
    if scale is not None:
        after *= scale
        record['edit'] = 'scale %g' % scale
    for spec in sets:
        idx, val = spec.split('=')
        after[int(idx)] = float(val)
        record.setdefault('edit', '')
        record['edit'] = (record['edit'] + ' set %s' % spec).strip()
    target['filter_parameters'] = after
    record['params_after'] = after.tolist()
    return edited, record


def replay(image, debug, filters, device='cuda'):
    """Full-res replay of a debug list -> float32 [H, W, 3] in [0, 1]:
    through K1 on a CUDA device (the exact branch set, as the evaluator's
    replay), through the branchless chain on the CPU."""
    import torch

    from exposure_tpu_torch.ops.chain import apply_filter_chain
    from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic

    device = torch.device(device)
    ids, params, masks, active = (
        torch.from_numpy(a).to(device)
        for a in pack_trajectory(debug, filters))
    img = torch.from_numpy(np.ascontiguousarray(image[None],
                                                np.float32)).to(device)
    masking = any(f.use_masking() for f in filters)
    mask = masks if masking else None
    with torch.no_grad():
        if device.type == 'cpu':
            out = apply_filter_chain(img, ids, params, filters,
                                     active_steps=active, mask_params=mask)
        else:
            out = apply_filter_chain_dynamic(
                img, ids, params, filters, active_steps=active,
                mask_params=mask, fast_math=False)
    return np.clip(out[0].cpu().numpy().astype(np.float32), 0.0, 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--debug', required=True,
                    help='per-step debug pickle from an evaluation')
    ap.add_argument('--image', required=True,
                    help='the original input photo (re-linearized '
                         'exactly as the evaluation did)')
    ap.add_argument('--step', type=int, required=True,
                    help='which recorded step to edit (0-based)')
    ap.add_argument('--scale', type=float, default=None)
    ap.add_argument('--set', dest='sets', action='append', default=[],
                    metavar='I=V')
    ap.add_argument('--drop', action='store_true')
    ap.add_argument('--out-dir', default='./outputs/edit')
    ap.add_argument('--device', default='cuda',
                    help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    if args.scale is None and not args.sets and not args.drop:
        ap.error('nothing to do: pass --scale, --set, or --drop')

    from exposure_tpu_torch.core.evaluator import load_linear_image
    from exposure_tpu_torch.ops.filters import build_filters
    from exposure_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    filters = build_filters(cfg)
    debug = load_debug(args.debug)
    image = load_linear_image(args.image)

    edited, record = apply_edit(debug, args.step, scale=args.scale,
                                sets=args.sets, drop=args.drop)
    before = replay(image, debug, filters, device=args.device)
    after = replay(image, edited, filters, device=args.device)

    os.makedirs(args.out_dir, exist_ok=True)
    from exposure_tpu_torch.utils.image_io import write_image
    write_image(os.path.join(args.out_dir, 'before.png'), before)
    write_image(os.path.join(args.out_dir, 'after.png'), after)
    record['sequence'] = [
        {'step': s['step'], 'filter': s.get('short_name', '?'),
         'applied': bool(s['applied']),
         'params': np.asarray(s['filter_parameters']).tolist()}
        for s in edited]
    record['mean_abs_change'] = round(
        float(np.abs(after - before).mean()), 6)
    with open(os.path.join(args.out_dir, 'edit.json'), 'w') as f:
        json.dump(record, f, indent=1)
    print('# edited step %d (%s): %s' % (args.step, record['filter'],
                                         record['edit']))
    print('# mean |after - before| = %.5f' % record['mean_abs_change'])
    print('# wrote %s/{before,after}.png + edit.json' % args.out_dir)
    return record


if __name__ == '__main__':
    main()
