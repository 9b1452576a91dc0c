"""Verification of the CUDA chain kernels on the card (torch counterpart
of ``exposure_tpu/tools/verify_kernel.py``).

The CPU tests hold the kernels' plain versions to the JAX package; this
tool holds the compiled kernels on the card to the branchless chain
(``ops/chain.py::apply_filter_chain``, every filter applied and selected
per image), across resolutions (64, 512 and sizes that fill no
block evenly), dtypes (f32 and the u8 serving path), masking (unmasked,
6-parameter masks, the elliptical vignette, inactive steps), the exact and
fast branch sets, and the three replay routes: K2
(``apply_filter_chain_switch``), the grouped runner (K3 and its K2 merges,
``GroupedChainRunner``) and K1 (``apply_filter_chain_dynamic``).  The 24
cases and the numpy draws are the JAX tool's, in its order, so one seed
gives the same inputs in both packages.

The branchless chain runs on the CPU, where the JAX tool ran it on the
device.  Its exact S+ is discontinuous at gray, and a trajectory that
saturates every channel (``fast_u8_512``'s first image: Ct, E +2.7, C, E,
S+) leaves a plateau of pixels whose chroma is decided by the last bit of
each channel's curve normalisation.  The card's reductions round that bit
otherwise than the CPU's, and a reference computed on the card moved 21%
of that case's values across the discontinuity; on the CPU, where the
tests hold it to JAX, the chain keeps the plateau gray.

Usage:
  python -m exposure_tpu_torch.tools.verify_kernel [--out KERNELCHECK.json]
                                                   [--cpu] [--seed 0]

``--cpu`` runs the plain versions on the CPU (the JAX tool's interpret
mode has no counterpart).  Exit code 0 iff every case passes (f32
max-abs-diff <= 1e-4, u8 <= 2 LSB).
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from exposure_tpu_torch.ops.chain import apply_filter_chain
from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
from exposure_tpu_torch.ops.filters import (
    VignetFilter,
    build_filters,
    max_filter_parameters,
)
from exposure_tpu_torch.ops.grouped_chain import GroupedChainRunner
from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
from exposure_tpu_torch.tools import device_name, tool_device
from exposure_tpu_torch.utils.config import load_config

F32_TOL = 1e-4
U8_TOL = 2  # LSB


def random_trajectory(rng, filters, k, b):
    """Random (ids, packed regressed params) like a rollout would emit, as
    [K, B] int32 and [K, B, P] float32 CPU tensors."""
    max_p = max_filter_parameters(filters)
    ids = rng.randint(0, len(filters), (k, b)).astype(np.int32)
    params = np.zeros((k, b, max_p), np.float32)
    for s in range(k):
        for i in range(b):
            f = filters[ids[s, i]]
            n = f.get_num_filter_parameters()
            raw = rng.randn(1, n).astype(np.float32)
            reg = f.filter_param_regressor(torch.from_numpy(raw)).numpy()
            params[s, i, :n] = reg.reshape(-1)
    return torch.from_numpy(ids), torch.from_numpy(params)


def _replay(filters, grouped, dynamic, fast_math, ids, params, active_steps,
            mask_params):
    if grouped:
        runner = GroupedChainRunner(filters, fast_math=fast_math)
        return lambda im: runner(im, ids, params, active_steps=active_steps,
                                 mask_params=mask_params)
    chain = apply_filter_chain_dynamic if dynamic \
        else apply_filter_chain_switch
    return lambda im: chain(im, ids, params, filters,
                            active_steps=active_steps,
                            mask_params=mask_params, fast_math=fast_math)


def draw_case(rng, filters, shape, steps, masked=False, active=False):
    """A case's inputs, drawn from ``rng`` in the JAX tool's order: the f32
    image [B, H, W, 3] (numpy), then ids, params, mask params and the
    active-step mask (CPU tensors, or None)."""
    b, h, w = shape
    imgf = rng.rand(b, h, w, 3).astype(np.float32) * 0.9
    ids, params = random_trajectory(rng, filters, steps, b)
    mask_params = None
    if masked:
        max_mask = max(f.get_num_mask_parameters() for f in filters)
        mask_params = torch.from_numpy(
            rng.randn(steps, b, max_mask).astype(np.float32))
    active_steps = None
    if active:
        act = np.ones((steps, b), np.float32)
        act[steps // 2:] = 0.0
        active_steps = torch.from_numpy(act)
    return imgf, ids, params, mask_params, active_steps


def judge(diffs, tol, outlier_span, ids, filters, fast_math):
    """Whether ``diffs`` (|replay - chain|, [B, H, W, 3]) pass: all within
    ``tol``, or for the fast set the attributed S+ rule."""
    if not fast_math:
        return bool(diffs.max() <= tol)
    # S+ (HSV) is discontinuous at exact gray, and chains that saturate
    # every channel make exactly-gray pixels; any difference between two
    # implementations can move such a pixel across the discontinuity,
    # within a bounded span (~s2*v).  The fast set pins a 2e-4 relative
    # gray band, which keeps the manufactured case consistent, but pixels
    # at the band's edge stay set-valued.  The exemption is attributed:
    # only images whose trajectory holds S+ may have such pixels (at most
    # 1e-4 of them, within the span); every other image is held to the
    # normal tolerance.
    sat_ids = [i for i, f in enumerate(filters)
               if type(f).__name__ == 'SaturationPlusFilter']
    has_sat = np.isin(np.asarray(ids), sat_ids).any(axis=0)  # [B]
    plain = diffs[~has_sat]
    satd = diffs[has_sat]
    plain_ok = plain.size == 0 or bool(plain.max() <= tol)
    sat_ok = satd.size == 0 or (
        bool((satd > tol).mean() <= 1e-4) and
        bool(satd.max() <= outlier_span))
    return plain_ok and sat_ok


def run_case(name, rng, filters, shape, steps, dtype='f32', masked=False,
             active=False, grouped=False, fast_math=False, dynamic=False,
             device='cuda'):
    imgf, ids, params, mask_params, active_steps = draw_case(
        rng, filters, shape, steps, masked, active)

    def chain(im):   # on the CPU, see the module docstring
        return apply_filter_chain(
            torch.from_numpy(im), ids, params, filters,
            active_steps=active_steps, mask_params=mask_params).numpy()

    replay = _replay(filters, grouped, dynamic, fast_math,
                     *(None if t is None else t.to(device) for t in (
                         ids, params, active_steps, mask_params)))

    t0 = time.time()
    if dtype == 'u8':
        img8 = (imgf * 255).round().astype(np.uint8)
        got = replay(torch.from_numpy(img8).to(device)).cpu().numpy()
        assert got.dtype == np.uint8, got.dtype
        # the u8 path dequantizes its own input; the expectation is the
        # chain of the dequantized image
        expected = chain(img8.astype(np.float32) / 255.0)
        expected_q = np.round(np.clip(expected, 0, 1) * 255.0)
        diffs = np.abs(got.astype(np.int64) - expected_q.astype(np.int64))
        tol = U8_TOL
        outlier_span = 64          # bounded by the S+ hue span s2*v
    else:
        expected = chain(imgf)
        got = replay(torch.from_numpy(imgf).to(device)).cpu().numpy()
        diffs = np.abs(got - expected)
        tol = F32_TOL
        outlier_span = 0.25
    diff = float(diffs.max())
    outlier_frac = float((diffs > tol).mean())
    ok = judge(diffs, tol, outlier_span, ids, filters, fast_math)
    ok = ok and bool(np.isfinite(got.astype(np.float64)).all())
    return {
        'case': name,
        'shape': list(shape),
        'steps': steps,
        'dtype': dtype,
        'masked': masked,
        'active_mask': active,
        'fast_math': fast_math,
        'max_abs_diff': diff,
        'outlier_frac': outlier_frac,
        'tol': tol,
        'ok': ok,
        'seconds': round(time.time() - t0, 2),
    }


def cases():
    """The JAX tool's 24 cases: (name, bank, shape, steps, dtype, masked,
    active[, grouped[, fast[, dynamic]]]), bank one of 'plain', 'masked'
    and 'vignette'."""
    return [
        ('f32_64', 'plain', (4, 64, 64), 5, 'f32', False, False),
        ('f32_512', 'plain', (2, 512, 512), 5, 'f32', False, False),
        ('f32_odd_96x160', 'plain', (2, 96, 160), 5, 'f32', False, False),
        ('f32_odd_300x200', 'plain', (1, 300, 200), 5, 'f32', False, False),
        ('f32_active_steps', 'plain', (2, 64, 64), 5, 'f32', False, True),
        ('u8_512', 'plain', (2, 512, 512), 5, 'u8', False, False),
        ('u8_odd_200x300', 'plain', (1, 200, 300), 5, 'u8', False, False),
        ('masked_64x128', 'masked', (2, 64, 128), 3, 'f32', True, False),
        ('masked_odd_96x128', 'masked', (1, 96, 128), 3, 'f32', True,
         False),
        ('vignette_96x128', 'vignette', (1, 96, 128), 3, 'f32', True,
         False),
        # the signature-grouped serving path
        ('grouped_u8_512', 'plain', (4, 512, 512), 5, 'u8', False, False,
         True),
        ('grouped_masked', 'masked', (2, 64, 128), 3, 'f32', True, False,
         True),
        # the fast branch set (the serving default)
        ('fast_f32_512', 'plain', (2, 512, 512), 5, 'f32', False, False,
         False, True),
        ('fast_u8_512', 'plain', (2, 512, 512), 5, 'u8', False, False,
         False, True),
        ('fast_grouped_u8', 'plain', (4, 512, 512), 5, 'u8', False, False,
         True, True),
        # masking x fast x u8 x grouped: the S+ gray band meets the mask
        # blend, under the same attributed criterion
        ('fast_masked', 'masked', (2, 64, 128), 3, 'f32', True, False,
         False, True),
        ('grouped_masked_u8', 'masked', (2, 128, 256), 3, 'u8', True, False,
         True, False),
        ('fast_grouped_masked_u8', 'masked', (2, 128, 256), 3, 'u8', True,
         False, True, True),
        # the dynamic kernel K1 (per-image ids, selected branch only)
        ('dyn_u8_512', 'plain', (2, 512, 512), 5, 'u8', False, False, False,
         False, True),
        ('dyn_f32_odd_96x160', 'plain', (2, 96, 160), 5, 'f32', False,
         False, False, False, True),
        ('dyn_active_steps', 'plain', (2, 64, 64), 5, 'f32', False, True,
         False, False, True),
        ('fast_dyn_u8_512', 'plain', (2, 512, 512), 5, 'u8', False, False,
         False, True, True),
        ('dyn_masked', 'masked', (2, 64, 128), 3, 'f32', True, False, False,
         False, True),
        ('fast_dyn_masked_u8', 'masked', (2, 128, 256), 3, 'u8', True,
         False, False, True, True),
    ]


def banks():
    """The ``example`` bank, its masked twin, and the masked one with the
    vignette appended."""
    cfg = load_config('example')
    mcfg = cfg.copy()
    mcfg.masking = True
    masked = build_filters(mcfg)
    return {'plain': build_filters(cfg), 'masked': masked,
            'vignette': masked + [VignetFilter(mcfg)]}


def verify(seed=0, device='cuda', say=print):
    rng = np.random.RandomState(seed)
    bank = banks()
    results = []
    for case in cases():
        name, flt, shape, steps, dtype, masked, active = case[:7]
        grouped = case[7] if len(case) > 7 else False
        fast = case[8] if len(case) > 8 else False
        dynamic = case[9] if len(case) > 9 else False
        r = run_case(name, rng, bank[flt], shape, steps, dtype=dtype,
                     masked=masked, active=active, grouped=grouped,
                     fast_math=fast, dynamic=dynamic, device=device)
        say('  %-22s %-12s diff=%.3g tol=%g %s (%.1fs)' %
            (r['case'], 'x'.join(map(str, r['shape'])), r['max_abs_diff'],
             r['tol'], 'OK' if r['ok'] else 'FAIL', r['seconds']))
        results.append(r)
    device = torch.device(device)
    return {
        'backend': device.type,
        'device': device_name(device),
        'n_devices': torch.cuda.device_count() if device.type == 'cuda'
        else 1,
        'torch_version': torch.__version__,
        'cases': results,
        'ok': all(r['ok'] for r in results),
    }


def summary(report):
    """The JAX tool's one-line summary of a report."""
    def worst(dtype, fast):
        vals = [r['max_abs_diff'] for r in report['cases']
                if r['dtype'] == dtype and r['fast_math'] == fast]
        return max(vals) if vals else None

    return {
        'kernel_check_ok': report['ok'],
        'device': report['device'],
        'worst_f32': worst('f32', False),
        'worst_u8_lsb': worst('u8', False),
        # fast cases pass on (outlier_frac, bounded span): the S+ hue
        # discontinuity makes a handful of band-edge pixels set-valued
        'worst_fast_u8_lsb': worst('u8', True),
        'worst_fast_outlier_frac': max(
            (r['outlier_frac'] for r in report['cases']
             if r['fast_math']), default=None),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=None,
                        help='write the JSON report here')
    parser.add_argument('--cpu', action='store_true',
                        help='the plain versions on the CPU')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    device = tool_device(args.cpu)
    print('# verify_kernel: backend=%s device=%s'
          % (device.type, device_name(device)))
    report = verify(seed=args.seed, device=device)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(report, f, indent=1)
        print('# wrote', args.out)
    print(json.dumps(summary(report)))
    sys.exit(0 if report['ok'] else 1)


if __name__ == '__main__':
    main()
