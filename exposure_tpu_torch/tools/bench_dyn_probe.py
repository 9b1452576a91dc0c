"""K1 against K2 and the grouped runner on a planted mix (the port of
``exposure_tpu/tools/bench_dyn_probe.py``, a script there; ``main`` here).

``example``'s filters, B=256 512x512 u8 images, K=5 steps, six planted
signatures assigned at random to the images: a trained-like mix.  The ids
and params are drawn from ``RandomState(0)`` in the JAX script's order
(the images, the six signatures, the assignment, then each step's and
image's raw params through its filter's regressor), so they are the JAX
script's, value for value.  It prints:

- K1 (the dynamic chain, fast math) against the branchless chain on the
  host's reference path, rounded to u8: the largest LSB difference and
  the fraction of values more than 1 LSB off;
- K1's ms a batch; K2's (the switch chain); the grouped runner's
  (``fused_set_limit=0``: K3 a group and K2 merges, host grouping
  included);
- ``dyn(switch)``, ``dyn(tree)`` and the ``batch_chunk`` sweep as null:
  they are grid knobs of K1's Mosaic lowering on the TPU (its
  ``dispatch=`` and ``batch_chunk=``), and the CUDA kernel has no
  counterpart to them.

Times are CUDA events (``tools.median_seconds``, 4 calls back to back).

    python -m exposure_tpu_torch.tools.bench_dyn_probe [--batch 256] \
        [--res 512] [--device cpu]
"""

import argparse
import json

import numpy as np
import torch

CONFIG = 'example'
B, H, W, K = 256, 512, 512, 5
N_SIGNATURES = 6
IMAGE_ROWS = 16     # images drawn at a time (the same stream as one draw)
PLAIN_ROWS = 32     # images the branchless reference holds at a time
UNPORTED = ('a grid knob of the Mosaic lowering of K1 on the TPU '
            '(dispatch= / batch_chunk=); the CUDA K1 has no counterpart')


def planted(filters, b=B, h=H, w=W, k=K, seed=0):
    """``(img [b, h, w, 3] u8, ids [k, b] int32, params [k, b, max_p]
    f32)`` drawn from ``RandomState(seed)`` as the JAX script draws
    them."""
    from exposure_tpu_torch.ops.filters import max_filter_parameters
    rng = np.random.RandomState(seed)
    img = np.concatenate([
        (rng.rand(min(IMAGE_ROWS, b - i), h, w, 3) * 255).astype(np.uint8)
        for i in range(0, b, IMAGE_ROWS)])
    sig_pool = [rng.randint(0, len(filters), k)
                for _ in range(N_SIGNATURES)]
    assign = rng.randint(0, N_SIGNATURES, b)
    ids = np.stack([sig_pool[a] for a in assign], axis=1).astype(np.int32)
    params = np.zeros((k, b, max_filter_parameters(filters)), np.float32)
    with torch.no_grad():
        for s in range(k):
            for i in range(b):
                f = filters[ids[s, i]]
                n = f.get_num_filter_parameters()
                raw = rng.randn(1, n).astype(np.float32)
                params[s, i, :n] = f.filter_param_regressor(
                    torch.from_numpy(raw)).numpy().reshape(-1)
    return img, ids, params


def branchless_u8(img, ids, params, filters, rows=PLAIN_ROWS):
    """The branchless chain on u8 ``img``, rounded to u8, ``rows`` images
    at a time."""
    from exposure_tpu_torch.ops.chain import apply_filter_chain
    out = []
    for i in range(0, img.shape[0], rows):
        part = slice(i, i + rows)
        ref = apply_filter_chain(img[part].to(torch.float32) / 255.0,
                                 ids[:, part], params[:, part], filters)
        out.append(torch.round(torch.clamp(ref, 0, 1) * 255)
                   .to(torch.uint8))
    return torch.cat(out)


def run(filters, img, ids, params, device, runs=7):
    """The probe's numbers on tensors on ``device``."""
    from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
    from exposure_tpu_torch.ops.grouped_chain import GroupedChainRunner
    from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
    from exposure_tpu_torch.tools import median_seconds
    b = img.shape[0]

    def ms(fn):
        return 1e3 * median_seconds(fn, device, runs=runs, calls=4)
    out = {}
    with torch.no_grad():
        dyn = apply_filter_chain_dynamic(img, ids, params, filters,
                                         fast_math=True)
        err = (dyn.to(torch.int64) -
               branchless_u8(img, ids, params, filters).to(torch.int64)).abs()
        out['dyn_max_lsb'] = int(err.max())
        out['dyn_frac_above_1'] = float((err > 1).double().mean())
        print('dyn on-device max LSB err (fast_math=True): %d  frac>1: %.2e'
              % (out['dyn_max_lsb'], out['dyn_frac_above_1']))
        out['dyn_ms'] = ms(lambda: apply_filter_chain_dynamic(
            img, ids, params, filters, fast_math=True))
        print('dyn(when)  : %.4f ms/batch  -> %.0f img/s (kernel only)'
              % (out['dyn_ms'], b / out['dyn_ms'] * 1e3))
        for name in ('dyn_switch', 'dyn_tree'):
            out[name + '_ms'] = None
            print('%-11s: null (%s)' % (name.replace('_', '(') + ')',
                                        UNPORTED))
        out['switch_ms'] = ms(lambda: apply_filter_chain_switch(
            img, ids, params, filters, fast_math=True))
        print('switch: %.4f ms/batch  -> %.0f img/s'
              % (out['switch_ms'], b / out['switch_ms'] * 1e3))
        runner = GroupedChainRunner(filters, fast_math=True,
                                    fused_set_limit=0)
        out['grouped_ms'] = ms(lambda: runner(img, ids, params))
        print('grouped(sync): %.4f ms/batch -> %.0f img/s (incl host '
              'grouping)' % (out['grouped_ms'], b / out['grouped_ms'] * 1e3))
        out['grouped_last_route'] = runner.last_route['route']
        out['dyn_chunk_ms'] = {str(c): None for c in (16, 32, 64)}
        print('dyn(when,chunk=16|32|64): null (%s)' % UNPORTED)
    out['null_reason'] = UNPORTED
    return out


def main(argv=None):
    from exposure_tpu_torch.ops.filters import build_filters
    from exposure_tpu_torch.tools import device_name, entry_device
    from exposure_tpu_torch.utils.config import load_config
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=B)
    ap.add_argument('--res', type=int, default=H)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    filters = build_filters(load_config(CONFIG))
    img, ids, params = planted(filters, args.batch, args.res, args.res)
    report = run(filters, torch.from_numpy(img).to(device),
                 torch.from_numpy(ids).to(device),
                 torch.from_numpy(params).to(device), device)
    report.update(config=CONFIG, shape=[args.batch, args.res, args.res, 3],
                  steps=K, signatures=N_SIGNATURES,
                  device=device_name(device))
    print(json.dumps(report))
    return report


if __name__ == '__main__':
    main()
