#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``exposure_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, one line each (a failing phase exits non-zero):

1. card: require CUDA, print the card's name and power limit, turn TF32 off
   for convolutions and matmuls (it can flip near-tie argmax decisions);
2. build: compile the hand-written CUDA kernel from
   ``exposure_tpu_torch/csrc``;
3. K1: the dynamic filter-chain kernel against its plain PyTorch version
   on the card, over the chain cases of the JAX package's kernel checks
   (f32 and u8, odd shapes, inactive steps, the all-identity trajectory,
   exact and fast branch sets, the masked bank) and at the two shapes the
   serving path gives it, where it also times the kernel (median of 7
   runs after warm-up) and the plain version (median of 5) with CUDA
   events;
4. main path: the trained ``synthetic_explore`` policy served from the
   in-repo artifact at full width on B=512 batches of seeded 512x512 u8
   images through ``RetouchPipeline.map_batches``, dropout on; checks the
   output, the K1 launch count (6 per batch: 5 proxy steps + 1 replay),
   the replay against the plain version, and the whole path against the
   CPU pipeline (the plain version throughout) on a small input; prints
   img/s and its split across resize, plan and replay.

The line before the last is a JSON summary of every kernel; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join('artifacts', 'serving',
                        'synthetic_explore--best.msgpack.gz')
SEED = 0
BATCH = 512          # bench.py's default serving batch
RES = 512
MAIN_BATCHES = 4
F32_ATOL, F32_RTOL = 3e-5, 1e-4    # as tests/test_pallas_chain.py
MAX_OUTLIER_FRAC = 1e-4            # fast S+ gray band, see dyn_chain.py


def fail(msg):
    print('FAIL: %s' % msg, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, runs=7, warmup=2):
    """Median milliseconds of ``fn()`` between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: no GPU to drive')
    if not os.path.isdir(os.path.join(REPO, 'exposure_tpu_torch')):
        fail('exposure_tpu_torch/ is not beside chip_smoke.py')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail('nvidia-smi failed: %s' % smi.stderr.strip())
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say('card: %s | torch %s cuda %s | devices %d | TF32 off: '
        'cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s'
        % (torch.cuda.get_device_name(0), torch.__version__,
           torch.version.cuda, torch.cuda.device_count(),
           torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32))
    return card


def phase_build():
    from exposure_tpu_torch.kernels import dyn_chain_kernel
    t0 = time.perf_counter()
    lib = dyn_chain_kernel()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    say('build: dyn_chain nvcc %.1f s (load %.1f s) %s'
        % (lib.build_seconds, time.perf_counter() - t0, lib.path))
    for ln in ptxas:
        say('  ptxas: %s' % ln)


def _trajectory(g, filters, k, b, device):
    """Random ids in [0, len(filters)) and regressed params per step."""
    import torch
    from exposure_tpu_torch.ops.filters import max_filter_parameters
    ids = torch.randint(0, len(filters), (k, b), generator=g,
                        dtype=torch.int32)
    params = torch.zeros((k, b, max_filter_parameters(filters)))
    for fid, f in enumerate(filters):
        n = f.get_num_filter_parameters()
        raw = torch.randn((k, b, n), generator=g)
        reg = f.filter_param_regressor(raw.reshape(-1, n)).reshape(k, b, n)
        sel = (ids == fid)[..., None]
        params[..., :n] = torch.where(sel, reg, params[..., :n])
    return ids.to(device), params.to(device)


def _compare(got, want):
    """(max error, outlier fraction): f32 in [0, 1] units, u8 in LSB."""
    import torch
    if got.dtype == torch.uint8:
        diff = (got.int() - want.int()).abs()
        return int(diff.max()), float((diff > 1).float().mean())
    bad = ~torch.isclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    return float((got - want).abs().max()), float(bad.float().mean())


def phase_k1():
    import torch
    from exposure_tpu_torch.ops.dyn_chain import (
        apply_filter_chain_dynamic, apply_filter_chain_dynamic_reference)
    from exposure_tpu_torch.ops.filters import build_filters
    from exposure_tpu_torch.utils.config import load_config
    dev = torch.device('cuda')
    banks = {name: build_filters(load_config(name))
             for name in ('synthetic_explore', 'masked')}
    # name, bank, B, H, W, K, dtype, fast, variant
    cases = [
        ('f32_64', 'synthetic_explore', 4, 64, 64, 5, 'f32', False, None),
        ('f32_512', 'synthetic_explore', 2, 512, 512, 5, 'f32', False, None),
        ('f32_odd_67x131', 'synthetic_explore', 3, 67, 131, 5, 'f32', False,
         None),
        ('u8_512', 'synthetic_explore', 2, 512, 512, 5, 'u8', False, None),
        ('u8_odd_131x67', 'synthetic_explore', 3, 131, 67, 5, 'u8', False,
         None),
        ('f32_active_steps', 'synthetic_explore', 4, 64, 96, 5, 'f32', False,
         'active'),
        ('f32_all_identity', 'synthetic_explore', 2, 64, 64, 5, 'f32', False,
         'identity'),
        ('u8_all_identity', 'synthetic_explore', 2, 64, 64, 5, 'u8', True,
         'identity'),
        ('fast_f32_64', 'synthetic_explore', 4, 64, 64, 5, 'f32', True, None),
        ('fast_u8_512', 'synthetic_explore', 2, 512, 512, 5, 'u8', True,
         None),
        ('fast_u8_odd_67x131', 'synthetic_explore', 3, 67, 131, 5, 'u8',
         True, None),
        ('masked_f32_64x128', 'masked', 2, 64, 128, 3, 'f32', False, None),
        ('masked_f32_odd_96x131', 'masked', 2, 96, 131, 3, 'f32', False,
         None),
        ('masked_fast_u8_128x64', 'masked', 2, 128, 64, 3, 'u8', True, None),
        ('masked_fast_f32_active', 'masked', 2, 64, 128, 4, 'f32', True,
         'active'),
        # the two shapes the serving path gives the kernel
        ('proxy_f32_512x64x64_k1', 'synthetic_explore', BATCH, 64, 64, 1,
         'f32', True, 'timed'),
        ('replay_u8_512x512x512_k5', 'synthetic_explore', BATCH, RES, RES, 5,
         'u8', True, 'timed'),
    ]
    g = torch.Generator().manual_seed(SEED)
    worst = {'f32': 0.0, 'u8': 0}
    timing = {}
    for name, bank, b, h, w, k, dt, fast, variant in cases:
        filters = banks[bank]
        ids, params = _trajectory(g, filters, k, b, dev)
        x = torch.rand((b, h, w, 3), generator=g) * 1.05
        img = (x * 255).round().clamp(0, 255).to(torch.uint8) \
            if dt == 'u8' else x
        img = img.to(dev)
        kw = {'fast_math': fast}
        if filters[0].use_masking():
            kw['mask_params'] = torch.randn((k, b, 6), generator=g).to(dev)
        if variant == 'active':
            kw['active_steps'] = (torch.rand((k, b), generator=g) > 0.4
                                  ).float().to(dev)
        if variant == 'identity':
            ids = torch.full_like(ids, len(filters))
        before = apply_filter_chain_dynamic.launches
        got = apply_filter_chain_dynamic(img, ids, params, filters, **kw)
        torch.cuda.synchronize()
        if apply_filter_chain_dynamic.launches != before + 1:
            fail('K1 %s: the wrapper did not launch the kernel' % name)
        want = apply_filter_chain_dynamic_reference(img, ids, params,
                                                    filters, **kw)
        err, outliers = _compare(got, want)
        if variant == 'identity' and not torch.equal(got, img):
            fail('K1 %s: identity trajectory changed the image' % name)
        limit = 1 if dt == 'u8' else F32_ATOL
        if fast:
            ok = outliers <= MAX_OUTLIER_FRAC
        else:
            ok = outliers == 0.0
        line = ('K1 %-26s %-5s %-4s B=%d %dx%d K=%d  max_%s=%s '
                'outlier_frac=%.2e' % (
                    name, 'fast' if fast else 'exact', dt, b, h, w, k,
                    'lsb' if dt == 'u8' else 'abs_err',
                    err if dt == 'u8' else '%.3e' % err, outliers))
        if variant == 'timed':
            ms = cuda_ms(lambda: apply_filter_chain_dynamic(
                img, ids, params, filters, **kw))
            plain = cuda_ms(lambda: apply_filter_chain_dynamic_reference(
                img, ids, params, filters, **kw), runs=5, warmup=1)
            timing[name] = (ms, plain)
            line += '  kernel %.4f ms  plain %.4f ms' % (ms, plain)
        say(line + ('' if ok else '  FAIL (tolerance %s, outliers <= %g)'
                    % (limit, MAX_OUTLIER_FRAC if fast else 0)))
        if not ok:
            fail('K1 %s disagrees with its plain version' % name)
        worst[dt] = max(worst[dt], err)
    return worst, timing


def _images(rng, b, h, w):
    """Seeded u8 images with smooth colour fields and texture, so the
    policy sees varied exposure and colour."""
    import numpy as np
    coarse = rng.random((b, 8, 8, 3), dtype=np.float32)
    scale = rng.random((b, 1, 1, 1), dtype=np.float32) * 1.2 + 0.1
    field = np.repeat(np.repeat(coarse * scale, h // 8, axis=1), w // 8,
                      axis=2)
    noise = rng.integers(-12, 13, size=(b, h, w, 3), dtype=np.int16)
    img = np.clip(field * 255.0, 0, 255).astype(np.int16) + noise
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_main_path():
    import numpy as np
    import torch
    from exposure_tpu_torch.core.serving import (
        RetouchPipeline, batch_generator)
    from exposure_tpu_torch.ops.dyn_chain import (
        apply_filter_chain_dynamic, apply_filter_chain_dynamic_reference)
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    pipe = RetouchPipeline.from_artifact('synthetic_explore',
                                         os.path.join(REPO, ARTIFACT),
                                         device=dev)
    say('main: loaded %s step %s (%s) in %.1f s; dropout keep %.2f'
        % (pipe.run, pipe.step, ARTIFACT, time.perf_counter() - t0,
           pipe.cfg.dropout_keep_prob))
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(_images(rng, BATCH, RES, RES)).to(dev)
               for _ in range(MAIN_BATCHES)]
    torch.cuda.synchronize()

    apply_filter_chain_dynamic.launches = 0
    outs = list(pipe.map_batches(batches, seed=SEED))
    torch.cuda.synchronize()
    launches = apply_filter_chain_dynamic.launches
    steps = pipe.cfg.test_steps
    if launches != (steps + 1) * MAIN_BATCHES:
        fail('main path launched K1 %d times over %d batches, expected %d'
             % (launches, MAIN_BATCHES, (steps + 1) * MAIN_BATCHES))
    for i, out in enumerate(outs):
        if out.shape != batches[i].shape or out.dtype != torch.uint8 or \
                out.device.type != 'cuda':
            fail('main path output %d: %s %s on %s' % (
                i, tuple(out.shape), out.dtype, out.device))
    changed = float((outs[0] != batches[0]).float().mean())
    say('main: %d batches of [%d, %d, %d, 3] u8 -> u8 on %s; K1 launches '
        '%d (%d per batch); %.3f of output values differ from the input'
        % (MAIN_BATCHES, BATCH, RES, RES, outs[0].device, launches,
           launches // MAIN_BATCHES, changed))

    # the plan of batch 0 again; its replay of 16 images against the plain
    # version on the same plan
    with torch.no_grad():
        ids, params, mask = pipe.plan(pipe.proxy(batches[0]),
                                      batch_generator(SEED, 0, dev))
    sub = slice(0, 16)
    got = pipe.replay(batches[0][sub].contiguous(), ids[:, sub],
                      params[:, sub], mask[:, sub])
    want = apply_filter_chain_dynamic_reference(
        batches[0][sub], ids[:, sub], params[:, sub].float(), pipe.filters,
        fast_math=True)
    lsb, outliers = _compare(got, want)
    same_as_served = bool(torch.equal(got, outs[0][sub]))
    counts = torch.bincount(ids.flatten().long(),
                            minlength=len(pipe.filters)).tolist()
    say('main: replay of 16 images vs plain: max_lsb=%d outlier_frac=%.2e; '
        'replanned batch equals the served one: %s; filter use over the '
        'plan %s' % (lsb, outliers, same_as_served,
                     dict(zip([f.get_short_name() for f in pipe.filters],
                              counts))))
    if outliers > MAX_OUTLIER_FRAC:
        fail('main path replay disagrees with the plain version')

    # throughput: inputs already on the device, CUDA events; any host
    # synchronisation inside map_batches raises (sync debug mode 'error')
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode('error')
    try:
        start.record()
        for _ in pipe.map_batches(batches, seed=SEED + 1):
            pass
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.synchronize()
    total_ms = start.elapsed_time(end)
    img_s = MAIN_BATCHES * BATCH / (total_ms / 1e3)
    img = batches[0]
    proxy = pipe.proxy(img)
    with torch.no_grad():
        plan = pipe.plan(proxy, batch_generator(SEED, 0, dev))
    resize_ms = cuda_ms(lambda: pipe.proxy(img), runs=5)
    with torch.no_grad():
        plan_ms = cuda_ms(lambda: pipe.plan(
            proxy, batch_generator(SEED, 0, dev)), runs=5)
    replay_ms = cuda_ms(lambda: pipe.replay(img, *plan), runs=5)
    say('main: %.1f img/s (%d x %d images of %dx%d u8, inputs already on '
        'the device, no host sync, CUDA events over map_batches: %.2f '
        'ms/batch); split '
        'per batch (median of 5): resize %.3f ms, plan %.3f ms, '
        'replay %.3f ms' % (img_s, MAIN_BATCHES, BATCH, RES, RES,
                            total_ms / MAIN_BATCHES, resize_ms, plan_ms,
                            replay_ms))
    return launches, img_s


def phase_small_reference():
    """The whole path on the card against the CPU pipeline, which runs the
    plain version throughout, on a small input with dropout off (the two
    devices draw different random bits)."""
    import numpy as np
    import torch
    from exposure_tpu_torch.core.serving import RetouchPipeline
    pipes = {}
    for dev in ('cpu', 'cuda'):
        pipe = RetouchPipeline.from_artifact(
            'synthetic_explore', os.path.join(REPO, ARTIFACT), device=dev)
        pipe.policy.shared_extractor.dropout_keep_prob = 1.0
        pipe.policy.selector_extractor.dropout_keep_prob = 1.0
        pipes[dev] = pipe
    imgs = torch.from_numpy(_images(np.random.default_rng(SEED + 7), 8, 64,
                                    128))
    plans, outs = {}, {}
    for dev, pipe in pipes.items():
        with torch.no_grad():
            plans[dev] = pipe.plan(pipe.proxy(imgs.to(dev)), None)[0].cpu()
        outs[dev] = pipe(imgs).cpu()
    same = (plans['cpu'] == plans['cuda']).all(dim=0)
    if int(same.sum()) < 4:
        fail('small input: CPU and GPU plans agree on %d of 8 rows'
             % int(same.sum()))
    lsb = int((outs['cpu'][same].int() - outs['cuda'][same].int()).abs()
              .max())
    say('small: GPU pipeline vs CPU pipeline on [8, 64, 128, 3] u8, '
        'dropout off: plans agree on %d/8 rows, max_lsb on those %d'
        % (int(same.sum()), lsb))
    if lsb > 1:
        fail('small input: GPU output off the CPU reference by %d LSB' % lsb)


def main():
    import torch
    card = phase_card()
    sys.path.insert(0, REPO)
    phase_build()
    worst, timing = phase_k1()
    phase_small_reference()
    launches, _ = phase_main_path()
    ms, plain_ms = timing['replay_u8_512x512x512_k5']
    say(json.dumps({'kernels': [{
        'name': 'dyn_chain',
        'route': 'cuda',
        'source': 'exposure_tpu_torch/csrc/dyn_chain.cu',
        'replaces': 'exposure_tpu/ops/pallas_chain.py:479',
        'launches': launches,
        'max_abs_err': worst['f32'],
        'max_lsb_u8': worst['u8'],
        'ms': ms,
        'plain_ms': plain_ms,
        'shape': '[%d, %d, %d, 3] u8, K=5' % (BATCH, RES, RES),
        'card': card,
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
