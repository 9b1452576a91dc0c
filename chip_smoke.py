#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``exposure_tpu_torch``) once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns PARENT_CHECKOUT   # A/B of two checkouts
    python3 chip_smoke.py --turns PARENT_CHECKOUT --kernels   # kernels alone
    python3 chip_smoke.py --world 4      # training on 4 nccl ranks, 4 cards

Phases, one line or a few each (a failing phase exits non-zero):

1. card: require CUDA, print the card's name and power limit, turn TF32 off
   for convolutions and matmuls (it can flip near-tie argmax decisions);
2. build: compile the four CUDA kernel libraries from
   ``exposure_tpu_torch/csrc`` (the three chain kernels and the probes) at
   once, one nvcc each; each chain kernel variant's registers, stack frame
   and spills from ptxas (K2's bf16 variants too), the probes' ptxas lines;
   then bf16_ops: the packed bf16 operations that K2's bf16 path and K4c run
   (``csrc/fastmath.cuh``) against their scalar f32-then-round forms over all
   2^32 pairs of operands, with the counts of differing results printed (any
   in an operation a kernel runs fails the run);
3. K1: the dynamic filter-chain kernel against its plain PyTorch version
   over the chain cases of the JAX package's kernel checks (f32 and u8,
   odd shapes, inactive steps, the all-identity trajectory, exact and fast
   branch sets, the masked bank) and at the two shapes the serving path
   gives it, where it also times the kernel (median of 7 timings of 4
   calls back to back, after warm-up) and the plain version (median of 5
   calls) with CUDA events;
4. K2: the switch-chain kernel against its plain version over the same
   kinds of case plus ``rows`` with ``n_active`` below the slot count, in
   f32 and in bf16, timed at [512, 512, 512, 3] u8 K=5 in both;
5. K3: the static-chain kernel against its plain version over the same
   kinds of case (rows below ``n_active``, ``rows`` scatter), timed at
   [512, 512, 512, 3] u8 K=5 on one signature;
6. probes: K4a (3 ops x steps 0, 1, 5), K4b (its 11 ops) and K4c (4 ops x
   3 styles, 8 steps) against their plain versions on a small and an odd
   size (a byte count that is not a multiple of 16), and K4c's bf16_cast
   against bf16_splat bit for bit;
7. probe tools: the port's bench_kernel_probe (K4a, and K2 beside the
   branchless chain), bench_fastmath (K4b) and bench_bf16_probe (K4c) at
   their JAX tools' default shapes, each printing its JSON report; then
   each timed case's kernel output held to its plain version on the timed
   input with the tolerances of phase 6 (and K4c's bf16_cast against
   bf16_splat), and the plain version timed there; the u8 round trip's
   bandwidth from K4a's copy;
8. tools: the port's verify_kernel (K1, K2 and the grouped K3 route against
   the branchless chain, its 24 cases must pass) and bench_filters at
   B=256 u8, with the fast branch set and without;
9. small: the whole dynamic path on the card against the CPU pipeline
   (the plain versions throughout) on a small input;
9b. evaluate: the PNG codec writes the evaluation inputs (the three sample
   inputs and two seeded images at odd sizes) and reads them back byte for
   byte; K1 against its plain version at the evaluator's shapes (B=1 f32 at
   each size, the u8 group of three, stopped rows, exact set), timed at
   [1, 512, 512, 3] f32 K=5; ``Evaluator`` on the trained artifact:
   ``eval_batched`` in f32 and u8 and ``eval`` step by step, their files
   decoded, their K1 launches counted (one per resolution group, one per
   applied step) and no plain version reached; step by step against the
   one-launch replay; u8 within 1 LSB of f32 on the u8 grid; the card
   against the CPU evaluator with dropout off; ``quality_report`` (n=256)
   and ``edit_sequence``; the plan, replay and PNG milliseconds per image;
9c. train: one outer iteration of ``synthetic_explore`` at full width on
   the card against the same iteration on the CPU, from the same state and
   draws (``tools/train_check.py``: metrics rtol 1e-4, gradients, Adam's
   moments, Adam replayed on the CPU on the card's gradients, parameters
   within 3 lr, selected ids, pool slots); ``Trainer.train()`` through
   iterations 0-11 of the config's schedule in a temp dir (the warmup at lr
   0 keeps the generator and value bits, finite metrics, the critic moves,
   the log, ``metrics.jsonl`` and two checkpoints), with ms per generator
   update, per critic update (burst and plain) and per plain iteration
   (CUDA events), peak memory, the host syncs the sync debug mode flags and
   where, and one more plain iteration under ``torch.profiler`` (device
   busy time, kernel launches); a fresh Trainer restores the newest
   checkpoint bit for bit and trains one more iteration; the trained state
   is exported and served through ``RetouchPipeline.from_run`` on a B=64
   batch of 512x512 u8 (6 K1 launches counted by stage, no plain version)
   and held within 1 LSB of the CPU pipeline on a small input;
9d. data: the native host loader built by g++ from
   ``exposure_tpu_torch/native/hostloader.cpp``; the FiveK layout at the
   dataset's size in a temp dir, made from seeds (a 20,000 x 80x80x3 f32
   ``image_raw.npy``, ``meta_raw.pkl``, folds of 2,000 / 2,000 / 500 ids,
   5,000 artist PNGs, a few 16-bit TIFFs read back equal and run through
   ``preprocess_raw_aug``); ``example``'s three providers in it (8,000 /
   2,000 / 8,000 crops, the seconds each); the loader on the card's host
   (one seed one batch, u8 the f32 crops quantized, crops the pack windows
   the draws name, the assembly rate of a plain iteration's bundles and of
   a chunk of 10 against a numpy copy); ``example`` at full width trained
   through iterations 0-11 (``critic_initialization`` cut to 2) resident
   (device packs 614.4 and 393.2 MB) and streaming from the packs in f32
   and u8, with ms per update and per plain iteration (CUDA events), host
   assembly, upload and wait ms per bundle, the host syncs of the plain
   iterations' steps (none), peak memory; the u8 step equal to the f32
   step on its dequantized bundle; one streaming step on the card against
   the CPU (``tools/train_check.py``, ``stream='uint8'``); the
   streaming-trained state served through K1 (6 launches). Its numbers
   are the JSON line ``{"data": ...}`` before the kernels line;
9e. parallel (``parallel/``, in the FiveK tree of 9d): (a) a world-size-1
   ``nccl`` group, under which ``example``'s resident and streaming step
   at full width equal the step without a group bit for bit
   (deterministic cuDNN, a control step), and a world-1 ``Trainer`` of
   ``example`` through iterations 0-6, then (b), then 7-11; (b) two
   spawned ranks sharing the card over ``gloo`` with CUDA tensors, the
   same run at B=64 as 32 + 32 and pool 128 as 64 + 64: the parameters'
   digests equal across the ranks after every iteration, finite metrics,
   one ``metrics.jsonl``, a resume bit for bit, the all-reduce's ms for
   each update's bucket, peak memory a rank; (c) ``dryrun_multigpu(2)``:
   two ranks' resident and streaming steps, resume, the pad path, and the
   trained artifact serving [512, 512, 512, 3] u8 K=5 as 256 + 256 through
   K2, K1 and K3, within 2 LSB of the plain chain and 1 LSB of one
   process's pipeline. Its numbers are the JSON line
   ``{"parallel": ...}``, and K1-K3's launches in (c) their kernels rows'
   ``launches_parallel_serve``.  Phases 9c-9e train with
   ``iters_per_dispatch`` 1 and their bookkeeping at once, so that their
   numbers keep the plain dispatch's meaning;
9f. fused (``core/fused.py``, in the FiveK tree of 9d): ``example`` at full
   width, ``critic_initialization`` 2, chunks of 10 (iterations 2-11 and
   12-21) from the state after the special iterations: ms per plain
   iteration fused (one iteration captured as a CUDA graph, replayed) and
   plain, 10 iterations a turn in turns, CUDA events and the host clock;
   device kernels, host launch calls and the idle share a plain iteration
   under ``torch.profiler``; the host syncs the sync debug mode flags in
   each dispatch (none); peak memory; then, under deterministic cuDNN,
   the fused run (bookkeeping 2 chunks behind), the plain run and a second
   plain run (the control) equal bit for bit (every state tensor, the
   counts, the pool, every metric), resident and streaming u8; the
   checkpoint at 12 that the pipelined record wrote (chunk 12-21 had already
   overwritten the buffers) restored bit for bit into a fresh Trainer,
   which resumed there equals the run not stopped; a world-size-1 ``nccl``
   group (its all-reduce captured) equal to none; the fused trainer goes
   on through 23 and its checkpoint 24 is served through K1
   (``launches_fused_serve``). Its numbers are the JSON line
   ``{"fused": ...}``;
10. main path: the trained ``synthetic_explore`` policy served from the
   in-repo artifact at full width on B=512 batches of seeded 512x512 u8
   images through ``RetouchPipeline.map_batches`` (dynamic, selected
   plan), dropout on; checks the output, the K1 launch count, read around
   each plan and each replay (6 per batch: 5 proxy steps in the plan + 1
   replay), the replay against the plain version, no
   host sync, and prints img/s and its split across resize, plan and
   replay;
11. modes: the same artifact and batches through the dynamic mode with the
   bank plan, the switch mode, the grouped mode, the grouped mode with
   ``warmup(superset=True)`` and the auto-superset mode
   (``auto_record_batches=2``): each mode's output agrees with the
   dynamic bank-plan output within 1 LSB, each prints its launches per
   kernel per batch, its host syncs (none in the dynamic and switch
   modes, where any raises; in the grouped modes a batch waits only on
   the event after its ids' copy), img/s and the split;
12. planted mix: one full-width batch with a planted 6-signature plan
   with small groups, replayed through ``call_superset``
   (slot overflow, a missing signature, an empty slot, the K2 merge) and
   through the accumulate route (``merge_below``), against K1;
13. bf16 plan: the served plan in bfloat16 against the f32 plan.

Every kernel count is set to 0 just before a path is driven (the serving
modes, and the tools, which are the probes' path) and read just after;
the comparisons with the plain versions do not count.  The line
before the last is a JSON summary of every kernel: launches, error, time
beside its plain version's, its H100 bound (``ops/dyn_chain.py::chain_cost``
for the chains, ``probe_cost`` for the probes; ``tools.bound_ms``) and the
time of the PyTorch call that computes the same function, where one does
(``Tensor.copy_`` for the probes' 0-step copy; no single call computes a
filter chain); K2's bf16 kernel has an entry of its own, and each probe
entry lists its timed cases one by one under ``cases``.  The last line is
``{"ok": true, "device": {...}}``.

``--turns PARENT`` runs the main path and the five modes of another
checkout (``PARENT``, e.g. ``git archive`` of the parent commit) and of
this one in turns, parent, change, change, parent, and compares the two
trees' main-path outputs value by value, and their kernels' outputs: one
step of every branch of both banks through K1 and through K2 in bf16, K2 in
f32 and bf16 on every case of phase 4, and every probe case.  A kernel
output with a value that differs from the parent's fails the run, unless
``TURNS_MAY_DIFFER`` names it.  Each turn also times every kernel, so the two
trees' kernel times come from one card.
``--kernels`` leaves the served path out (one turn a tree).
``--world N``, on a machine of N cards, trains ``example`` on N ``nccl``
ranks, one a card, against world 1 in turns (phase 9e's (b) over NVLink)
and prints the ``{"world": ...}`` line.
"""

import json
import os
import re
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join('artifacts', 'serving',
                        'synthetic_explore--best.msgpack.gz')
DEVICE = 'cuda'
SEED = 0
BATCH = 512          # bench.py's default serving batch
RES = 512
MAIN_BATCHES = 4
STREAM_PASSES = 3    # timed passes over the batches, for a spread
F32_ATOL, F32_RTOL = 3e-5, 1e-4    # as tests/test_pallas_chain.py
MAX_OUTLIER_FRAC = 1e-4            # fast S+ gray band, see dyn_chain.py
# K2 in bf16: against the f32 result, the JAX bound (max 8 LSB, mean below
# 2) on the inputs the JAX test states it for (its seeded u8 [2, 64, 128,
# 3] batch and 5-step trajectory, exact set:
# tests/test_pallas_chain.py::test_bf16_compute_mode), and the mean bound
# on every case: the maximum depends on the inputs (other seeds of the
# same shape reach 28 LSB in the bf16 semantics the JAX kernel and the
# plain version share), f32 input is rounded to bf16 on load, and the fast
# set's max-form curves cancel large terms; against its bf16 plain version,
# at most 1e-3 of the
# values more than 1 LSB (u8) or 2 bf16 ulps (f32) apart: both round after
# every operation, but their f32 exp, pow and cos may differ in the last
# bit
BF16_MAX_LSB, BF16_MEAN_LSB = 8, 2.0
BF16_PLAIN_FRAC = 1e-3
BF16_PLAN_STEP1 = 0.9              # step-1 ids agreeing with the f32 plan
# The probes: [B, H, W] of the checks (16-byte chunks only, and a ragged
# end), and the JAX tools' default shapes for the timings
PROBE_SIZES = {'small': (2, 64, 64), 'odd': (3, 37, 53)}
PROBE_BATCH, BF16_PROBE_BATCH, BF16_PROBE_STEPS = 256, 64, 8
PROBE_ITERS = 7      # bench_kernel_probe's timed calls (its CLI default: 20)
PLAIN_RUNS = 3       # timed runs of the probes' plain versions
KERNEL_CALLS = 4     # calls back to back in a timing (a kernel's, and
                     # Tensor.copy_'s beside it): device time
# kernel outputs of --turns (names of _kernel_outputs, by prefix) that a
# deliberate change of the numbers lets differ from the parent's; any other
# differing value fails the turns
TURNS_MAY_DIFFER = ()
# K4c in bf16 against its plain version, as K2-bf16
PROBE_BF16_FRAC = 1e-3
CHAIN_LIBS = ('dyn_chain', 'static_chain', 'switch_chain')
_VARIANT = re.compile(
    r'(dyn_chain_kernel|static_chain_kernel|switch_chain_f32|'
    r'switch_chain_bf16)I([hf])Lb([01])ELb([01])E(?:Li(\d+)E)?')


def fail(msg):
    print('FAIL: %s' % msg, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, runs=7, warmup=2, calls=1):
    """Median milliseconds of ``fn()`` between CUDA events
    (``exposure_tpu_torch.tools.median_seconds``, of the checkout this
    process imports: with ``calls`` above 1 a timing spans that many calls
    back to back after one more call queued before the first event)."""
    from exposure_tpu_torch.tools import median_seconds
    return 1e3 * median_seconds(fn, DEVICE, runs=runs, warmup=warmup,
                                calls=calls)


def _on_card(fn):
    """The keyword that keeps the output of a pipeline's ``__call__`` or
    ``map_batches`` on the card, so that no timing or count gains a copy to
    the host; none for a ``--serve`` checkout from before ``device_out``,
    whose pipeline returns device tensors always."""
    import inspect
    if 'device_out' in inspect.signature(fn).parameters:
        return {'device_out': True}
    return {}


def wrappers():
    """The six kernel wrappers, whose ``launches`` count the kernel
    launches they make."""
    from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
    from exposure_tpu_torch.ops.static_chain import apply_filter_chain_static
    from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
    from exposure_tpu_torch.tools.bench_bf16_probe import run_probe
    from exposure_tpu_torch.tools.bench_fastmath import run_op
    from exposure_tpu_torch.tools.bench_kernel_probe import mono_chain
    return {'dyn_chain': apply_filter_chain_dynamic,
            'switch_chain': apply_filter_chain_switch,
            'static_chain': apply_filter_chain_static,
            'mono_probe': mono_chain,
            'fastmath_probe': run_op,
            'bf16_probe': run_probe}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0
    wrappers()['switch_chain'].launches_bf16 = 0


def read_counts():
    """Launches by wrapper; ``switch_chain_bf16`` is the part of
    ``switch_chain``'s that ran the bf16 kernel."""
    counts = {name: fn.launches for name, fn in wrappers().items()}
    counts['switch_chain_bf16'] = wrappers()['switch_chain'].launches_bf16
    return counts


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


def ptxas_variants(log):
    """``{variant: {registers, stack, spill_stores, spill_loads}}`` of the
    chain kernels from ptxas -v output; a variant reads as
    ``kernel<type,set,mask,S>``, S the compiled knot count (0: generic)."""
    rows, name, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r'Function properties for (\S+)', ln)
        if m:
            v = _VARIANT.search(m.group(1))
            name = None if v is None else '%s<%s,%s,%s%s>' % (
                v.group(1), 'u8' if v.group(2) == 'h' else 'f32',
                'fast' if v.group(3) == '1' else 'exact',
                'masked' if v.group(4) == '1' else 'unmasked',
                '' if v.group(5) is None else ',S=%s' % v.group(5))
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', ln)
        if m and name:
            props = dict(zip(('stack', 'spill_stores', 'spill_loads'),
                             map(int, m.groups())))
            continue
        m = re.search(r'Used (\d+) registers', ln)
        if m and name and props is not None:
            rows[name] = dict(props, registers=int(m.group(1)))
            name = props = None
    return rows


def phase_build():
    """Build the four libraries at once; print each chain kernel variant's
    registers, stack frame and spills.  Returns ``{library: variants}``."""
    from exposure_tpu_torch.kernels import build_all
    t0 = time.perf_counter()
    libs = build_all()
    say('build: %d libraries in %.1f s (one nvcc each, all at once)'
        % (len(libs), time.perf_counter() - t0))
    variants = {}
    for name, lib in libs.items():
        say('build: %s nvcc %.1f s %s' % (name, lib.build_seconds, lib.path))
        if name not in CHAIN_LIBS:
            for ln in lib.build_log.splitlines():
                if 'registers' in ln or 'spill' in ln:
                    say('  ptxas: %s' % ln.strip())
            continue
        variants[name] = ptxas_variants(lib.build_log)
        for v, p in sorted(variants[name].items()):
            say('  ptxas: %-44s %3d registers, %3d bytes stack frame, %d/%d '
                'bytes spill stores/loads' % (v, p['registers'], p['stack'],
                                              p['spill_stores'],
                                              p['spill_loads']))
    return variants


def _bound(cost):
    """``chain_cost``'s dict with the H100 bound it gives."""
    from exposure_tpu_torch.tools import bound_ms
    ms, by = bound_ms(cost['flops'], cost['bytes'])
    return dict(cost, bound_ms=ms, bound_by=by)


def _chain_bound(ids, filters, img, fast):
    """The bound of a chain over ``img`` with the [K, n] ids it runs."""
    from exposure_tpu_torch.ops.dyn_chain import chain_cost
    masked = any(f.use_masking() for f in filters)
    return _bound(chain_cost(ids, filters, img.shape[1], img.shape[2],
                             img.dtype, fast, masked))


def _trajectory(g, filters, k, b, device, ids=None):
    """Random ids in [0, len(filters)) (or the given [K, B] ids) and
    regressed params per step."""
    import torch
    from exposure_tpu_torch.ops.filters import max_filter_parameters
    if ids is None:
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


def _ok(fast, outliers):
    return outliers <= MAX_OUTLIER_FRAC if fast else outliers == 0.0


def _case_inputs(g, filters, b, h, w, k, dt, variant, dev, ids=None):
    import torch
    ids, params = _trajectory(g, filters, k, b, dev, ids)
    x = torch.rand((b, h, w, 3), generator=g) * 1.05
    img = (x * 255).round().clamp(0, 255).to(torch.uint8) \
        if dt == 'u8' else x
    kw = {}
    if filters[0].use_masking():
        kw['mask_params'] = torch.randn((k, b, 6), generator=g).to(dev)
    if variant == 'active':
        kw['active_steps'] = (torch.rand((k, b), generator=g) > 0.4
                              ).float().to(dev)
    if variant == 'identity':
        ids = torch.full_like(ids, len(filters))
    return img.to(dev), ids, params, kw


def _jax_bf16_inputs(filters, dev):
    """The inputs of tests/test_pallas_chain.py::test_bf16_compute_mode:
    numpy RandomState(0) draws the u8 batch, then the ids, then each
    step's raw parameters, in that test's order."""
    import numpy as np
    import torch
    from exposure_tpu_torch.ops.filters import max_filter_parameters
    rng = np.random.RandomState(0)
    img8 = (rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
    ids = rng.randint(0, len(filters), (5, 2)).astype(np.int32)
    params = np.zeros((5, 2, max_filter_parameters(filters)), np.float32)
    for s in range(5):
        for i in range(2):
            f = filters[ids[s, i]]
            n = f.get_num_filter_parameters()
            raw = torch.from_numpy(rng.randn(1, n).astype(np.float32))
            params[s, i, :n] = f.filter_param_regressor(raw).numpy()[0]
    return (torch.from_numpy(img8).to(dev), torch.from_numpy(ids).to(dev),
            torch.from_numpy(params).to(dev))


def _banks():
    from exposure_tpu_torch.ops.filters import build_filters
    from exposure_tpu_torch.utils.config import load_config
    return {name: build_filters(load_config(name))
            for name in ('synthetic_explore', 'masked')}


# name, bank, B, H, W, K, dtype, fast, variant: the chain cases of the JAX
# package's kernel checks
CHAIN_CASES = [
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
    ('fast_u8_512', 'synthetic_explore', 2, 512, 512, 5, 'u8', True, None),
    ('fast_u8_odd_67x131', 'synthetic_explore', 3, 67, 131, 5, 'u8', True,
     None),
    ('masked_f32_64x128', 'masked', 2, 64, 128, 3, 'f32', False, None),
    ('masked_f32_odd_96x131', 'masked', 2, 96, 131, 3, 'f32', False, None),
    ('masked_fast_u8_128x64', 'masked', 2, 128, 64, 3, 'u8', True, None),
    ('masked_fast_f32_active', 'masked', 2, 64, 128, 4, 'f32', True,
     'active'),
]
BF16_JAX_CASE = ('bf16_jax_test_u8_64x128', 'synthetic_explore', 2, 64, 128,
                 5, 'u8', False, 'jax')
ROWS_CASES = [
    ('rows_fast_u8', 'synthetic_explore', 6, 64, 96, 5, 'u8', True, 'rows'),
    ('rows_masked_f32', 'masked', 6, 96, 64, 3, 'f32', False, 'rows'),
]
REPLAY_CASE = ('replay_u8_512x512x512_k5', 'synthetic_explore', BATCH, RES,
               RES, 5, 'u8', True, 'timed')
PROXY_CASE = ('proxy_f32_512x64x64_k1', 'synthetic_explore', BATCH, 64, 64,
              1, 'f32', True, 'timed')


# the packed operations the kernels run (csrc/fastmath.cuh): none may
# differ from its scalar form; hmax and hmin, the native max.bf16x2 and
# min.bf16x2, are counted beside them and run in no kernel
PACKED_OPS_USED = ('add', 'sub', 'mul', 'max', 'min', 'ge', 'le', 'gt', 'abs',
                   'neg')


def phase_bf16_ops():
    """The packed bf16 operations against their scalar f32-then-round forms
    over every pair of bf16 bit patterns; returns the counts."""
    import torch
    from exposure_tpu_torch.tools.bench_bf16_probe import check_packed_ops
    counts = check_packed_ops(DEVICE)
    ms = cuda_ms(lambda: check_packed_ops(DEVICE), runs=1, warmup=0)
    torch.cuda.synchronize()
    for op, c in counts.items():
        say('bf16_ops %-5s checked %d results: %d differ from the scalar '
            'form (%d of them zeros of opposite sign); excluded: %d pairs of '
            'NaNs with different bits' % (op, c['checked'], c['differ'],
                                          c['zero_sign'], c['nan_payload']))
    say('bf16_ops: all 2^32 operand pairs in %.1f ms' % ms)
    bad = {op: counts[op]['differ'] for op in PACKED_OPS_USED
           if counts[op]['differ']}
    if bad:
        fail('packed bf16 operations differ from their scalar forms: %s'
             % bad)
    return counts


def phase_k1():
    import torch
    from exposure_tpu_torch.ops.dyn_chain import (
        apply_filter_chain_dynamic, apply_filter_chain_dynamic_reference)
    dev = torch.device(DEVICE)
    banks = _banks()
    # the two shapes the serving path gives the kernel
    cases = CHAIN_CASES + [PROXY_CASE, REPLAY_CASE]
    g = torch.Generator().manual_seed(SEED)
    worst = {'f32': 0.0, 'u8': 0}
    timing, errors = {}, {}
    for name, bank, b, h, w, k, dt, fast, variant in cases:
        filters = banks[bank]
        img, ids, params, kw = _case_inputs(g, filters, b, h, w, k, dt,
                                            variant, dev)
        kw['fast_math'] = fast
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
        ok = _ok(fast, outliers)
        line = ('K1 %-26s %-5s %-4s B=%d %dx%d K=%d  max_%s=%s '
                'outlier_frac=%.2e' % (
                    name, 'fast' if fast else 'exact', dt, b, h, w, k,
                    'lsb' if dt == 'u8' else 'abs_err',
                    err if dt == 'u8' else '%.3e' % err, outliers))
        if variant == 'timed':
            ms = cuda_ms(lambda: apply_filter_chain_dynamic(
                img, ids, params, filters, **kw), calls=KERNEL_CALLS)
            plain = cuda_ms(lambda: apply_filter_chain_dynamic_reference(
                img, ids, params, filters, **kw), runs=5, warmup=1)
            bound = _chain_bound(ids, filters, img, fast)
            timing[name] = (ms, plain, bound)
            line += '  kernel %.4f ms  plain %.4f ms  bound %.4f ms (%s)' % (
                ms, plain, bound['bound_ms'], bound['bound_by'])
        say(line + ('' if ok else '  FAIL (tolerance %s, outliers <= %g)'
                    % (1 if dt == 'u8' else F32_ATOL,
                       MAX_OUTLIER_FRAC if fast else 0)))
        if not ok:
            fail('K1 %s disagrees with its plain version' % name)
        worst[dt] = max(worst[dt], err)
        errors[name] = err
    return worst, timing, errors


def _as_u8(x):
    import torch
    if x.dtype == torch.uint8:
        return x.int()
    return torch.round(torch.clamp(x.float(), 0, 1) * 255).int()


def _bf16_vs_plain(got, want):
    """Fraction of values more than 1 LSB (u8) or 2 bf16 ulps (f32)
    apart."""
    import torch
    if got.dtype == torch.uint8:
        return float(((got.int() - want.int()).abs() > 1).float().mean())
    tol = 2.0 ** -7 * torch.clamp(want.abs(), min=1.0)
    return float(((got - want).abs() > tol).float().mean())


def _k2_cases(dev):
    """The switch-chain cases, seeded: ``(case, filters, img, ids, params,
    kw)`` with ``case`` the tuple of CHAIN_CASES' layout and ``kw`` the
    keyword arguments but ``compute_dtype`` (and ``out``, which a ``rows``
    case needs zeroed for each call)."""
    import torch
    banks = _banks()
    g = torch.Generator().manual_seed(SEED + 2)
    for case in CHAIN_CASES + ROWS_CASES + [BF16_JAX_CASE, REPLAY_CASE]:
        _, bank, b, h, w, k, dt, fast, variant = case
        filters = banks[bank]
        img, ids, params, kw = _case_inputs(g, filters, b, h, w, k, dt,
                                            variant, dev)
        if variant == 'jax':
            img, ids, params = _jax_bf16_inputs(filters, dev)
        kw['fast_math'] = fast
        if variant == 'rows':
            rows = torch.randperm(b, generator=g)[:b - 1].to(
                torch.int32).to(dev)
            kw.update(rows=rows, n_active=b - 2)
        yield case, filters, img, ids, params, kw


def phase_k2():
    import torch
    from exposure_tpu_torch.ops.switch_chain import (
        apply_filter_chain_switch, apply_filter_chain_switch_reference)
    dev = torch.device(DEVICE)
    worst = {'f32': 0.0, 'u8': 0, 'bf16_vs_f32_lsb': 0,
             'bf16_vs_plain_frac': 0.0, 'bf16_vs_plain_f32': 0.0,
             'bf16_vs_plain_u8': 0}
    timing = {}
    for case, filters, img, ids, params, kw in _k2_cases(dev):
        name, _, b, h, w, k, dt, fast, variant = case
        results = {}
        for cdt in (torch.float32, torch.bfloat16):
            ck = dict(kw, compute_dtype=cdt)
            if variant == 'rows':
                ck['out'] = torch.zeros_like(img)
            before = read_counts()
            got = apply_filter_chain_switch(img, ids, params, filters, **ck)
            torch.cuda.synchronize()
            after = read_counts()
            if after['switch_chain'] != before['switch_chain'] + 1 or \
                    after['switch_chain_bf16'] - before['switch_chain_bf16'] \
                    != int(cdt == torch.bfloat16):
                fail('K2 %s: the wrapper did not launch the kernel' % name)
            if variant == 'rows':
                ck['out'] = torch.zeros_like(img)
            want = apply_filter_chain_switch_reference(img, ids, params,
                                                       filters, **ck)
            results[cdt] = (got, want)
        got, want = results[torch.float32]
        err, outliers = _compare(got, want)
        ok = _ok(fast, outliers)
        if variant == 'identity' and not torch.equal(got, img):
            fail('K2 %s: identity trajectory changed the image' % name)
        if variant == 'rows':
            skipped = [i for i in range(b)
                       if i not in kw['rows'][:kw['n_active']].tolist()]
            if got[skipped].any():
                fail('K2 %s: rows past n_active were written' % name)
        got16, want16 = results[torch.bfloat16]
        plain_frac = _bf16_vs_plain(got16, want16)
        key16 = 'bf16_vs_plain_' + dt
        worst[key16] = max(worst[key16], _compare(got16, want16)[0])
        vs_f32 = (_as_u8(got16) - _as_u8(got)).abs()
        if variant == 'rows':   # only the replayed rows
            active = kw['rows'][:kw['n_active']].long()
            vs_f32 = vs_f32[active]
        lsb16, mean16 = int(vs_f32.max()), float(vs_f32.float().mean())
        jax_case = variant == 'jax'
        ok16 = plain_frac <= BF16_PLAIN_FRAC and mean16 < BF16_MEAN_LSB \
            and (not jax_case or lsb16 <= BF16_MAX_LSB)
        line = ('K2 %-26s %-5s %-4s B=%d %dx%d K=%d  f32: max_%s=%s '
                'outlier_frac=%.2e  bf16: vs_plain_frac=%.2e vs_f32 '
                'max_lsb=%d mean_lsb=%.4f' % (
                    name, 'fast' if fast else 'exact', dt, b, h, w, k,
                    'lsb' if dt == 'u8' else 'abs_err',
                    err if dt == 'u8' else '%.3e' % err, outliers,
                    plain_frac, lsb16, mean16))
        if variant == 'timed':
            for cdt, tag in ((torch.float32, 'f32'),
                             (torch.bfloat16, 'bf16')):
                ck = dict(kw, compute_dtype=cdt)
                ms = cuda_ms(lambda: apply_filter_chain_switch(
                    img, ids, params, filters, **ck), calls=KERNEL_CALLS)
                plain = cuda_ms(lambda: apply_filter_chain_switch_reference(
                    img, ids, params, filters, **ck), runs=5, warmup=1)
                # one bound for both compute types: the bf16 path may not
                # fuse a multiply into an add, so packed bf16 (two values an
                # instruction, no FMA) has the f32 rate (an FMA counted 2)
                bound = _chain_bound(ids, filters, img, fast)
                timing[tag] = (ms, plain, bound)
                line += '  %s kernel %.4f ms plain %.4f ms bound %.4f ms' % (
                    tag, ms, plain, bound['bound_ms'])
        say(line + ('' if ok and ok16 else '  FAIL'))
        if not ok:
            fail('K2 %s (f32) disagrees with its plain version' % name)
        if not ok16:
            fail('K2 %s (bf16) is outside its bounds' % name)
        worst[dt] = max(worst[dt], err)
        worst['bf16_vs_plain_frac'] = max(worst['bf16_vs_plain_frac'],
                                          plain_frac)
        if jax_case:
            worst['bf16_vs_f32_lsb'] = max(worst['bf16_vs_f32_lsb'], lsb16)
    return worst, timing


def _signature_of(filters, names):
    return tuple([type(f).__name__ for f in filters].index(n) for n in names)


SERVED_SIGNATURE = ('ExposureFilter', 'GammaFilter', 'SaturationPlusFilter',
                    'ToneFilter', 'ContrastFilter')


def phase_k3():
    import torch
    from exposure_tpu_torch.ops.static_chain import (
        apply_filter_chain_static, apply_filter_chain_static_reference)
    dev = torch.device(DEVICE)
    banks = _banks()
    g = torch.Generator().manual_seed(SEED + 3)
    worst = {'f32': 0.0, 'u8': 0}
    timing = {}
    cases = [c for c in CHAIN_CASES if c[8] != 'active'] + ROWS_CASES + [
        ('n_active_u8', 'synthetic_explore', 5, 64, 96, 5, 'u8', False,
         'n_active'),
        REPLAY_CASE]
    for name, bank, b, h, w, k, dt, fast, variant in cases:
        filters = banks[bank]
        if variant == 'timed':
            sig = _signature_of(filters, SERVED_SIGNATURE)
        elif variant == 'identity':
            sig = (len(filters),) * k
        else:
            sig = tuple(int(x) for x in torch.randint(
                0, len(filters) + 1, (k,), generator=g))
        ids = torch.tensor(sig, dtype=torch.int32)[:, None].repeat(1, b)
        img, _, params, kw = _case_inputs(g, filters, b, h, w, k, dt,
                                          variant, dev, ids=ids)
        kw['fast_math'] = fast
        n_active = b
        if variant == 'rows':
            rows = torch.randperm(b, generator=g)[:b - 1].to(
                torch.int32).to(dev)
            n_active = b - 2
            kw.update(rows=rows, n_active=n_active)
        elif variant == 'n_active':
            n_active = b - 2
            kw['n_active'] = n_active
        out_kw = {'out': torch.zeros_like(img)} if variant == 'rows' else {}
        before = apply_filter_chain_static.launches
        got = apply_filter_chain_static(img, sig, params, filters, **kw,
                                        **out_kw)
        torch.cuda.synchronize()
        if apply_filter_chain_static.launches != before + 1:
            fail('K3 %s: the wrapper did not launch the kernel' % name)
        if variant == 'rows':
            out_kw = {'out': torch.zeros_like(img)}
        want = apply_filter_chain_static_reference(img, sig, params, filters,
                                                   **kw, **out_kw)
        if variant == 'n_active':   # rows past n_active are unspecified
            got, want = got[:n_active], want[:n_active]
        err, outliers = _compare(got, want)
        ok = _ok(fast, outliers)
        if variant == 'identity' and not torch.equal(got, img):
            fail('K3 %s: identity signature changed the image' % name)
        line = ('K3 %-26s %-5s %-4s B=%d %dx%d K=%d sig=%s n_active=%d  '
                'max_%s=%s outlier_frac=%.2e' % (
                    name, 'fast' if fast else 'exact', dt, b, h, w, k,
                    ''.join(str(s) for s in sig), n_active,
                    'lsb' if dt == 'u8' else 'abs_err',
                    err if dt == 'u8' else '%.3e' % err, outliers))
        if variant == 'timed':
            ms = cuda_ms(lambda: apply_filter_chain_static(
                img, sig, params, filters, **kw), calls=KERNEL_CALLS)
            plain = cuda_ms(lambda: apply_filter_chain_static_reference(
                img, sig, params, filters, **kw), runs=5, warmup=1)
            bound = _chain_bound(ids, filters, img, fast)
            timing['replay'] = (ms, plain, bound)
            line += '  kernel %.4f ms  plain %.4f ms  bound %.4f ms (%s)' % (
                ms, plain, bound['bound_ms'], bound['bound_by'])
        say(line + ('' if ok else '  FAIL'))
        if not ok:
            fail('K3 %s disagrees with its plain version' % name)
        worst[dt] = max(worst[dt], err)
    return worst, timing


def _launch_checked(name, fn, *args):
    """``fn(*args)`` on the card, failing unless the wrapper ``name``
    launched its kernel exactly once."""
    import torch
    wrapper = wrappers()[name]
    before = wrapper.launches
    got = fn(*args)
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        fail('%s: the wrapper did not launch the kernel' % name)
    return got


def _lsb(got, want):
    return int((got.int() - want.int()).abs().max())


def _probe_worst():
    return {'mono_probe': 0, 'fastmath_probe': 0, 'bf16_probe': 0,
            'bf16_probe_bf16_lsb': 0, 'bf16_probe_frac_off': 0.0}


def _hold_probe(worst, name, key, got, want):
    """Hold the probe kernel ``name``'s output ``got`` on case ``key`` to
    its plain version's ``want``: at most 1 LSB apart, or for K4c's bf16
    styles at most ``PROBE_BF16_FRAC`` of the values more than 1 LSB apart.
    Folds the case into ``worst`` and returns ``(max_lsb, frac_off)``."""
    lsb = _lsb(got, want)
    frac = float(((got.int() - want.int()).abs() > 1).float().mean())
    if name == 'bf16_probe' and not key.endswith('/f32'):
        worst['bf16_probe_bf16_lsb'] = max(worst['bf16_probe_bf16_lsb'], lsb)
        worst['bf16_probe_frac_off'] = max(worst['bf16_probe_frac_off'], frac)
        ok = frac <= PROBE_BF16_FRAC
    else:
        worst[name] = max(worst[name], lsb)
        ok = lsb <= 1
    if not ok:
        fail('%s %s disagrees with its plain version: max %d LSB, %g of the '
             'values more than 1 LSB apart' % (name, key, lsb, frac))
    return lsb, frac


def phase_probes():
    """K4a, K4b and K4c against their plain versions on a small and an odd
    size; returns the largest LSB difference of each kernel."""
    import numpy as np
    import torch
    from exposure_tpu_torch.tools import bench_bf16_probe as k4c
    from exposure_tpu_torch.tools import bench_fastmath as k4b
    from exposure_tpu_torch.tools import bench_kernel_probe as k4a
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(SEED + 4)
    worst = _probe_worst()

    def u8(*shape):
        return torch.from_numpy((rng.rand(*shape) * 255).astype(
            np.uint8)).to(dev)

    for size, (b, h, w) in PROBE_SIZES.items():
        nhwc, planar, mono = u8(b, h, w, 3), u8(b, 3, h, w), u8(b, 1, h, w)
        lsb = {}
        for op in k4a.MONO_OPS:
            for steps in (0, 1, 5):
                key = '%s%d' % (op, steps)
                got = _launch_checked('mono_probe', k4a.mono_chain, nhwc,
                                      steps, op)
                lsb[key], _ = _hold_probe(
                    worst, 'mono_probe', key, got,
                    k4a.mono_chain_reference(nhwc, steps, op))
        say('K4a %-5s [%d, %d, %d, 3] u8 (%d bytes, %d past a 16-byte '
            'chunk): max_lsb by op and steps %s' % (
                size, b, h, w, nhwc.numel(), nhwc.numel() % 16, lsb))
        lsb = {}
        for op in k4b.OPS:
            got = _launch_checked('fastmath_probe', k4b.run_op, planar, op)
            lsb[op], _ = _hold_probe(worst, 'fastmath_probe', op, got,
                                     k4b.run_op_reference(planar, op))
        say('K4b %-5s [%d, 3, %d, %d] u8 (%d bytes, %d past a 16-byte '
            'chunk): max_lsb by op %s' % (size, b, h, w, planar.numel(),
                                          planar.numel() % 16, lsb))
        lsb, frac = {}, {}
        for op in k4c.OPS:
            outs = {}
            for style in k4c.STYLES:
                args = (mono, k4c.PARAMS, op, style, BF16_PROBE_STEPS)
                key = '%s/%s' % (op, style)
                outs[style] = _launch_checked('bf16_probe', k4c.run_probe,
                                              *args)
                lsb[key], frac[key] = _hold_probe(
                    worst, 'bf16_probe', key, outs[style],
                    k4c.run_probe_reference(*args))
            if not torch.equal(outs['bf16_cast'], outs['bf16_splat']):
                fail('K4c %s: bf16_cast and bf16_splat differ' % op)
        say('K4c %-5s [%d, 1, %d, %d] u8 (%d bytes, %d past a 16-byte '
            'chunk) %d steps: max_lsb by op/style %s; bf16 fraction more '
            'than 1 LSB off %s; bf16_cast == bf16_splat bit for bit' % (
                size, b, h, w, mono.numel(), mono.numel() % 16,
                BF16_PROBE_STEPS, lsb,
                {k: v for k, v in frac.items() if '/bf16' in k}))
    return worst


def phase_probe_tools():
    """The tools that drive the probes, at the JAX tools' default shapes,
    with the counts set to 0 before and read after; then each timed case's
    kernel output held to its plain version on the timed input, and the
    plain version timed there.  Returns the counts, ``{kernel: {case: (ms,
    plain_ms)}}``, the largest differences at these shapes and the u8
    round trip's GB/s."""
    import torch
    from exposure_tpu_torch.tools import bench_bf16_probe as k4c
    from exposure_tpu_torch.tools import bench_fastmath as k4b
    from exposure_tpu_torch.tools import bench_kernel_probe as k4a
    dev = torch.device(DEVICE)

    reset_counts()
    rep_a = k4a.report(PROBE_BATCH, RES, iters=PROBE_ITERS, device=dev)
    say('bench_kernel_probe: ' + json.dumps(rep_a))
    rep_b = k4b.report(PROBE_BATCH, RES, device=dev,
                       say=lambda ln: say('  bench_fastmath ' + ln))
    say('bench_fastmath: ' + json.dumps(rep_b))
    rep_c = []
    for op in k4c.OPS:
        for style in k4c.STYLES:
            rep_c.append(k4c.probe(op, style, BF16_PROBE_BATCH, RES,
                                   BF16_PROBE_STEPS, dev))
            say('bench_bf16_probe: ' + json.dumps(rep_c[-1]))
    torch.cuda.synchronize()
    counts = read_counts()
    for name in ('mono_probe', 'fastmath_probe', 'bf16_probe',
                 'switch_chain'):
        if not counts[name]:
            fail('the probe tools did not launch %s: %s' % (name, counts))
    say('probe tools: launches %s' % {k: v for k, v in counts.items() if v})

    from exposure_tpu_torch.ops.dyn_chain import probe_cost
    worst = _probe_worst()
    lsb = {'mono_probe': {}, 'fastmath_probe': {}, 'bf16_probe': {}}
    timing = {'mono_probe': {}, 'fastmath_probe': {}, 'bf16_probe': {}}

    def hold(name, key, ms, wrapper, reference, *args, op, steps):
        img = args[0]
        got = _launch_checked(name, wrapper, *args)
        lsb[name][key], _ = _hold_probe(worst, name, key, got,
                                        reference(*args))
        library = None
        if op == 'copy':   # the one probe op with a PyTorch call
            # Tensor.copy_ and the kernel on the same tensors, calls back to
            # back (device time alone), and both one call a timing, where
            # the events also enclose the host's work before the launch
            library = cuda_ms(lambda: got.copy_(img), calls=KERNEL_CALLS)
            copies[name] = {
                'kernel_ms': cuda_ms(lambda: wrapper(*args),
                                     calls=KERNEL_CALLS),
                'copy__ms': library,
                'kernel_one_call_ms': cuda_ms(lambda: wrapper(*args)),
                'copy__one_call_ms': cuda_ms(lambda: got.copy_(img))}
        del got
        bound = _bound(probe_cost(name, op, steps, img.numel()))
        timing[name][key] = (ms, cuda_ms(lambda: reference(*args),
                                         runs=PLAIN_RUNS, warmup=1),
                             bound, library)

    copies = {}
    img = k4a.make_input(PROBE_BATCH, RES).to(dev)
    for key, steps, op in k4a.SECTION_A:
        hold('mono_probe', key, rep_a[key + '_ms'], k4a.mono_chain,
             k4a.mono_chain_reference, img, steps, op, op=op, steps=steps)
    img = k4b.make_input(PROBE_BATCH, RES).to(dev)
    for op in k4b.OPS:
        hold('fastmath_probe', op, rep_b[op + '_ms'], k4b.run_op,
             k4b.run_op_reference, img, op, op=op, steps=k4b.STEPS)
    img = k4c.make_input(BF16_PROBE_BATCH, RES).to(dev)
    for r in rep_c:
        hold('bf16_probe', '%s/%s' % (r['op'], r['style']), r['ms'],
             k4c.run_probe, k4c.run_probe_reference, img, k4c.PARAMS,
             r['op'], r['style'], BF16_PROBE_STEPS, op=r['op'],
             steps=BF16_PROBE_STEPS)
    for op in k4c.OPS:
        cast, splat = (_launch_checked('bf16_probe', k4c.run_probe, img,
                                       k4c.PARAMS, op, style,
                                       BF16_PROBE_STEPS)
                       for style in ('bf16_cast', 'bf16_splat'))
        if not torch.equal(cast, splat):
            fail('K4c %s at the tool shape: bf16_cast and bf16_splat differ'
                 % op)
    del img
    say('K4c at the tool shape: bf16_cast == bf16_splat bit for bit')
    for name, rows in timing.items():
        say('%s at the tool shape: max_lsb by case %s' % (name, lsb[name]))
        say('%s kernel / plain / bound (by) / library ms: %s' % (name, {
            k: '%.4f / %.4f / %.4f (%s) / %s' % (
                v[0], v[1], v[2]['bound_ms'], v[2]['bound_by'],
                'none' if v[3] is None else '%.4f' % v[3])
            for k, v in rows.items()}))
    for name, c in copies.items():
        say('%s 0-step copy against Tensor.copy_ on the same tensors: kernel '
            '%.4f ms, copy_ %.4f ms (%.3fx; %d calls back to back a timing); '
            'one call a timing: kernel %.4f ms, copy_ %.4f ms' % (
                name, c['kernel_ms'], c['copy__ms'],
                c['kernel_ms'] / c['copy__ms'], KERNEL_CALLS,
                c['kernel_one_call_ms'], c['copy__one_call_ms']))
    copy_ms = rep_a['pallas_copy_0step_ms']
    nbytes = 2 * PROBE_BATCH * RES * RES * 3
    say('u8 round trip (K4a copy, 0 steps, [%d, %d, %d, 3]): %d bytes read '
        'and written in %.4f ms = %.1f GB/s' % (
            PROBE_BATCH, RES, RES, nbytes, copy_ms, nbytes / copy_ms / 1e6))
    return counts, timing, worst, nbytes / copy_ms / 1e6, copies


def phase_tools():
    """verify_kernel (all 24 cases must pass) and bench_filters at B=256
    u8, with the fast set and without, with the counts set to 0 before and
    read after.  Returns the counts and the two per-filter tables."""
    import torch
    from exposure_tpu_torch.tools import bench_filters, verify_kernel
    dev = torch.device(DEVICE)
    reset_counts()
    report = verify_kernel.verify(seed=SEED, device=dev,
                                  say=lambda ln: say('verify_kernel' + ln))
    say('verify_kernel: ' + json.dumps(verify_kernel.summary(report)))
    if not report['ok'] or len(report['cases']) != 24:
        fail('verify_kernel: %d of %d cases pass' % (
            sum(r['ok'] for r in report['cases']), len(report['cases'])))
    tables = {}
    for fast in (False, True):
        tag = 'bench_filters%s' % (' --fast' if fast else '')
        tables[fast] = bench_filters.per_filter(
            PROBE_BATCH, RES, 5, fast=fast, device=dev,
            say=lambda ln, t=tag: say(t + ln))
        say('%s: %s' % (tag, json.dumps(tables[fast])))
    torch.cuda.synchronize()
    counts = read_counts()
    for name in ('dyn_chain', 'switch_chain', 'static_chain'):
        if not counts[name]:
            fail('the tools did not launch %s: %s' % (name, counts))
    say('tools: launches %s' % {k: v for k, v in counts.items() if v})
    return counts, tables


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


def _pipeline(dev, **kw):
    from exposure_tpu_torch.core.serving import RetouchPipeline
    return RetouchPipeline.from_artifact(
        'synthetic_explore', os.path.join(REPO, ARTIFACT), device=dev, **kw)


def _split(pipe, img, dev):
    """Median ms of resize, plan and replay of one batch, alone."""
    import torch
    from exposure_tpu_torch.core.serving import batch_generator
    proxy = pipe.proxy(img)
    with torch.no_grad():
        plan = pipe.plan(proxy, batch_generator(SEED, 0, dev))
        ids_host = plan[0].cpu().numpy() if pipe.grouped else None
        resize_ms = cuda_ms(lambda: pipe.proxy(img), runs=5)
        plan_ms = cuda_ms(lambda: pipe.plan(
            proxy, batch_generator(SEED, 0, dev)), runs=5)
        replay_ms = cuda_ms(lambda: pipe.replay(img, *plan,
                                                ids_host=ids_host), runs=5)
    return resize_ms, plan_ms, replay_ms


def _timed_stream(pipe, batches, trap):
    """ms of each of STREAM_PASSES passes over map_batches (CUDA events,
    inputs on the device, seeds SEED + 1, SEED + 2, ...) and the host
    synchronisations counted per pass.  ``trap``: any sync raises."""
    import torch
    times, syncs = [], 0
    for n in range(STREAM_PASSES):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('error' if trap else 'warn')
            try:
                start.record()
                for _ in pipe.map_batches(batches, seed=SEED + 1 + n,
                                          **_on_card(pipe.map_batches)):
                    pass
                end.record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        end.synchronize()
        times.append(start.elapsed_time(end))
        syncs += sum('synchroniz' in str(w.message) for w in caught)
    return times, syncs / STREAM_PASSES


def _rate(times):
    """img/s of the median pass, and of the slowest and fastest."""
    per = [MAIN_BATCHES * BATCH / (t / 1e3) for t in times]
    return sorted(per)[len(per) // 2], min(per), max(per)


def _count_k1_by_stage(pipe):
    """Wrap ``pipe.plan`` and ``pipe.replay`` so that the K1 launches made
    inside each call add to the returned ``{'plan': n, 'replay': n}``."""
    from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
    stages = {'plan': 0, 'replay': 0}
    for stage in stages:
        def counted(*args, _fn=getattr(pipe, stage), _stage=stage, **kw):
            before = apply_filter_chain_dynamic.launches
            try:
                return _fn(*args, **kw)
            finally:
                stages[_stage] += apply_filter_chain_dynamic.launches - before
        setattr(pipe, stage, counted)
    return stages


def phase_main_path(batches):
    """The served path; returns K1's launches in it, ``{'proxy': n,
    'replay': n}`` (the plan's steps on the proxy, and the replay), img/s
    and the outputs."""
    import torch
    from exposure_tpu_torch.core.serving import batch_generator
    from exposure_tpu_torch.ops.dyn_chain import (
        apply_filter_chain_dynamic_reference)
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    pipe = _pipeline(dev)
    if not (pipe.dynamic and pipe.selected_plan):
        fail('the default GPU pipeline is not dynamic with the selected plan')
    say('main: loaded %s step %s (%s) in %.1f s; dropout keep %.2f'
        % (pipe.run, pipe.step, ARTIFACT, time.perf_counter() - t0,
           pipe.cfg.dropout_keep_prob))

    stages = _count_k1_by_stage(pipe)
    reset_counts()
    outs = list(pipe.map_batches(batches, seed=SEED,
                                 **_on_card(pipe.map_batches)))
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts['dyn_chain']
    by_stage = {'proxy': stages['plan'], 'replay': stages['replay']}
    del pipe.plan, pipe.replay     # the timed runs below go unwrapped
    steps = pipe.cfg.test_steps
    if by_stage != {'proxy': steps * MAIN_BATCHES, 'replay': MAIN_BATCHES} \
            or launches != sum(by_stage.values()) or \
            counts['switch_chain'] or counts['static_chain']:
        fail('main path launched %s over %d batches (K1: %s by stage), '
             'expected K1 %d times on the proxy and %d on the replay'
             % (counts, MAIN_BATCHES, by_stage, steps * MAIN_BATCHES,
                MAIN_BATCHES))
    for i, out in enumerate(outs):
        if out.shape != batches[i].shape or out.dtype != torch.uint8 or \
                out.device.type != torch.device(DEVICE).type:
            fail('main path output %d: %s %s on %s' % (
                i, tuple(out.shape), out.dtype, out.device))
    changed = float((outs[0] != batches[0]).float().mean())
    say('main: %d batches of [%d, %d, %d, 3] u8 -> u8 on %s; K1 launches '
        '%d (%d per batch: %d on the proxy in the plan, %d replay); %.3f of '
        'output values differ from the input'
        % (MAIN_BATCHES, BATCH, RES, RES, outs[0].device, launches,
           launches // MAIN_BATCHES, by_stage['proxy'] // MAIN_BATCHES,
           by_stage['replay'] // MAIN_BATCHES, changed))

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
    times, _ = _timed_stream(pipe, batches, trap=True)
    img_s, lo, hi = _rate(times)
    resize_ms, plan_ms, replay_ms = _split(pipe, batches[0], dev)
    say('main: %.1f img/s, median of %d passes (min %.1f, max %.1f; %d x '
        '%d images of %dx%d u8, inputs already on the device, no host '
        'sync, CUDA events over map_batches: %.2f ms/batch); split '
        'per batch (median of 5): resize %.3f ms, plan %.3f ms, '
        'replay %.3f ms' % (img_s, STREAM_PASSES, lo, hi, MAIN_BATCHES,
                            BATCH, RES, RES,
                            1e3 * BATCH / img_s,
                            resize_ms, plan_ms, replay_ms))
    return by_stage, img_s, outs


MODES = [
    ('dynamic_bank_plan', dict(dynamic=True, selected_plan=False)),
    ('switch', dict(dynamic=False, grouped=False)),
    ('grouped', dict(grouped=True)),
    ('grouped_superset', dict(grouped=True)),
    ('auto_superset', dict(auto_superset=True, auto_record_batches=2)),
]
# the kernel each mode must launch, and those it must not
MODE_KERNELS = {
    'dynamic_bank_plan': ('dyn_chain', ('switch_chain', 'static_chain')),
    'switch': ('switch_chain', ('dyn_chain', 'static_chain')),
    'grouped': ('static_chain', ('dyn_chain',)),
    'grouped_superset': ('static_chain', ('dyn_chain',)),
    'auto_superset': ('static_chain', ('dyn_chain',)),
}


def phase_modes(batches):
    """Every other serving mode on the trained artifact at full width;
    returns the launches per kernel summed over the modes' runs."""
    import torch
    dev = torch.device(DEVICE)
    totals = {name: 0 for name in read_counts()}
    ref = None
    rows = []
    for mode, kw in MODES:
        pipe = _pipeline(dev, **kw)
        extra = ''
        if mode == 'grouped_superset':
            rep = pipe.warmup(batches[0], probe_batches=2, seed=SEED,
                              superset=True)
            if pipe._superset_layout is None:
                fail('superset warm-up froze no layout: %s' % rep)
            extra = ' layout %d slots %s' % (
                len(pipe._superset_layout),
                [size for _, size in pipe._superset_layout])
        reset_counts()
        if pipe.grouped:
            pipe._runner.launches.clear()
        outs = list(pipe.map_batches(batches, seed=SEED,
                                     **_on_card(pipe.map_batches)))
        torch.cuda.synchronize()
        counts = read_counts()
        must, must_not = MODE_KERNELS[mode]
        if counts[must] == 0 or any(counts[k] for k in must_not):
            fail('mode %s launched %s' % (mode, counts))
        for name in totals:
            totals[name] += counts[name]
        if ref is None:
            ref = outs
        diff = [(o.int() - r.int()).abs() for o, r in zip(outs, ref)]
        max_lsb = max(int(d.max()) for d in diff)
        n_diff = sum(int((d > 0).sum()) for d in diff)
        if max_lsb > 1:
            fail('mode %s is %d LSB off the dynamic bank-plan output'
                 % (mode, max_lsb))
        if pipe.grouped:
            extra += ' last route %s' % pipe._runner.last_route
            if pipe._ss_auto:
                extra += ' auto-superset %s' % {
                    k: v for k, v in pipe.superset_report().items()
                    if k != 'layout'}
        times, syncs = _timed_stream(pipe, batches, trap=not pipe.grouped)
        img_s, lo, hi = _rate(times)
        resize_ms, plan_ms, replay_ms = _split(pipe, batches[0], dev)
        per_batch = {k: v / MAIN_BATCHES for k, v in counts.items() if v}
        say('mode %-18s launches per batch %s; vs dynamic bank plan: max_lsb'
            '=%d, %d of %d values differ; %.1f img/s, median of %d passes '
            '(min %.1f, max %.1f; %.2f ms/batch; host syncs flagged by the '
            'sync debug mode: %.2f per batch, %s); split: resize %.3f ms, '
            'plan %.3f ms, replay %.3f ms;%s' % (
                mode, per_batch, max_lsb, n_diff, ref[0].numel() * len(ref),
                img_s, STREAM_PASSES, lo, hi, 1e3 / img_s * BATCH,
                syncs / MAIN_BATCHES,
                'any would raise' if not pipe.grouped else
                'the wait on the ids event is not one of them', resize_ms,
                plan_ms, replay_ms, extra))
        rows.append((mode, img_s))
        del outs, pipe
    return totals, rows


def phase_planted(batch):
    """One full-width batch with a planted 6-signature plan (regressed
    random parameters): call_superset through slot overflow, two missing
    signatures, an empty slot and the K2 merge; the accumulate route
    through merge_below; both against K1 on the same plan."""
    import torch
    from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
    dev = torch.device(DEVICE)
    pipe = _pipeline(dev, grouped=True, fused_set_limit=0)
    k, nf = pipe.cfg.test_steps, len(pipe.filters)
    sigs = [tuple((s + j) % nf for j in range(k)) for s in range(7)]
    sizes = [300, 150, 40, 10, 7, 5]        # sums to 512
    cols = [sigs[i] for i, n in enumerate(sizes) for _ in range(n)]
    g = torch.Generator().manual_seed(SEED + 9)
    perm = torch.randperm(BATCH, generator=g)
    ids_host = torch.tensor([cols[i] for i in perm.tolist()],
                            dtype=torch.int32).T.contiguous()
    ids, params = _trajectory(g, pipe.filters, k, BATCH, dev, ids=ids_host)
    want = apply_filter_chain_dynamic(batch, ids, params, pipe.filters,
                                      fast_math=True)
    # sigs[0] overflows its bucket, sigs[4] and sigs[5] are missing, and
    # sigs[6] holds an empty slot
    layout = [(sigs[0], 256), (sigs[1], 192), (sigs[2], 48), (sigs[3], 12),
              (sigs[6], 8)]
    runner = pipe._runner
    lines = []
    for route in ('superset', 'accumulate'):
        reset_counts()
        runner.launches.clear()
        if route == 'superset':
            got = runner.call_superset(batch, ids_host.numpy(), params,
                                       layout, ids_device=ids)
        else:
            got = runner(batch, ids, params, ids_host=ids_host.numpy())
        torch.cuda.synchronize()
        counts = read_counts()
        lsb = int((got.int() - want.int()).abs().max())
        n_diff = int((got != want).sum())
        last = runner.last_route
        lines.append('planted %-10s %s launches %s, max_lsb=%d vs K1, %d '
                     'values differ' % (route, last, {
                         k2: v for k2, v in counts.items() if v}, lsb,
                         n_diff))
        if lsb > 1 or last['route'] != route or not last['merge'] or \
                not counts['static_chain'] or not counts['switch_chain']:
            for ln in lines:
                say(ln)
            fail('planted mix through %s' % route)
        if route == 'superset' and (last['filled_slots'] != 4 or
                                    last['merged_rows'] != 44 + 12):
            fail('planted superset routing: %s' % last)
    for ln in lines:
        say(ln)


def phase_bf16_plan(batches):
    import torch
    from exposure_tpu_torch.core.serving import batch_generator
    dev = torch.device(DEVICE)
    f32 = _pipeline(dev)
    b16 = _pipeline(dev, bf16=True)
    step1 = total = 0.0
    for i, img in enumerate(batches):
        with torch.no_grad():
            a = f32.plan(f32.proxy(img), batch_generator(SEED, i, dev))[0]
            b = b16.plan(b16.proxy(img), batch_generator(SEED, i, dev))[0]
        step1 += float((a[0] == b[0]).float().mean())
        total += float((a == b).all(dim=0).float().mean())
    step1 /= len(batches)
    total /= len(batches)
    out = b16(batches[0], SEED, 0, device_out=True)
    torch.cuda.synchronize()
    say('bf16 plan: step-1 ids agree with the f32 plan on %.4f of the '
        'images, all 5 steps on %.4f (%d batches of %d); bf16-planned '
        'output %s %s' % (step1, total, len(batches), BATCH,
                          tuple(out.shape), out.dtype))
    if step1 < BF16_PLAN_STEP1:
        fail('bf16 plan: step-1 agreement %.4f below %.2f'
             % (step1, BF16_PLAN_STEP1))
    return step1, total


def _small_against_cpu(make, what):
    """The pipeline ``make(dev)`` gives on the card against the one it
    gives on the CPU, which runs the plain versions throughout, on a small
    input with dropout off (the two devices draw different random bits).
    Fails unless their plans agree on at least 4 of the 8 rows and the
    outputs of those rows are within 1 LSB; returns ``(rows agreeing,
    max_lsb)``."""
    import numpy as np
    import torch
    pipes = {}
    for dev in ('cpu', DEVICE):
        pipe = make(dev)
        pipe.policy.shared_extractor.dropout_keep_prob = 1.0
        pipe.policy.selector_extractor.dropout_keep_prob = 1.0
        pipes[dev] = pipe
    imgs = torch.from_numpy(_images(np.random.default_rng(SEED + 7), 8, 64,
                                    128))
    plans, outs = {}, {}
    for dev, pipe in pipes.items():
        with torch.no_grad():
            plans[dev] = pipe.plan(pipe.proxy(imgs.to(dev)), None)[0].cpu()
        outs[dev] = torch.from_numpy(pipe(imgs))
    same = (plans['cpu'] == plans[DEVICE]).all(dim=0)
    if int(same.sum()) < 4:
        fail('%s: CPU and GPU plans agree on %d of 8 rows'
             % (what, int(same.sum())))
    lsb = int((outs['cpu'][same].int() - outs[DEVICE][same].int()).abs()
              .max())
    if lsb > 1:
        fail('%s: GPU output off the CPU reference by %d LSB' % (what, lsb))
    return int(same.sum()), lsb


def phase_small_reference():
    """The whole dynamic path on the card against the CPU pipeline on a
    small input (``_small_against_cpu``)."""
    same, lsb = _small_against_cpu(
        lambda dev: _pipeline(dev, use_kernels=True), 'small input')
    say('small: GPU pipeline vs CPU pipeline on [8, 64, 128, 3] u8, '
        'dropout off: plans agree on %d/8 rows, max_lsb on those %d'
        % (same, lsb))


EVAL_ODD_SIZES = ((300, 452), (640, 333))    # H x W of the two seeded files
EVAL_TIMED = ('eval_f32_1x512x512_k5', 'synthetic_explore', 1, RES, RES, 5,
              'f32', False, 'timed')
# K1 at the shapes evaluation gives it: B=1 f32 at each file size (exact
# set, K=5 and the K=1 of a step-by-step replay), the u8 group of three, and
# rows stopped early ('stopped': inactive steps after a row's stop)
EVAL_K1_CASES = [
    EVAL_TIMED,
    ('eval_f32_1x300x452_k5', 'synthetic_explore', 1, 300, 452, 5, 'f32',
     False, None),
    ('eval_f32_1x640x333_k5', 'synthetic_explore', 1, 640, 333, 5, 'f32',
     False, None),
    ('eval_f32_1x640x333_k1', 'synthetic_explore', 1, 640, 333, 1, 'f32',
     False, None),
    ('eval_u8_3x512x512_stopped', 'synthetic_explore', 3, RES, RES, 5, 'u8',
     False, 'stopped'),
    ('eval_f32_1x300x452_stopped', 'synthetic_explore', 1, 300, 452, 5,
     'f32', False, 'stopped'),
]
EVAL_ARTIFACTS = ('.linear.png', '.input_tone_mapped.png', '.retouched.png')
EVAL_STEP_ARTIFACTS = EVAL_ARTIFACTS + ('.steps.png', '_debug.pkl')


def _eval_inputs(tmp):
    """The evaluation inputs, written with the port's PNG writer and read
    back (any differing byte fails): the three sample inputs and two seeded
    images at odd sizes.  Returns the files and the read and write
    milliseconds per 512x512 image (host clock, the median of the
    three)."""
    import statistics
    import numpy as np
    from exposure_tpu_torch.utils.image_io import read_png, write_png
    rng = np.random.default_rng(SEED + 21)
    arrays, read_ms = [], []
    for i in range(3):
        t0 = time.perf_counter()
        arrays.append(read_png(os.path.join(
            REPO, 'docs', 'sample_inputs', 'masked%d.png' % i)))
        read_ms.append(1e3 * (time.perf_counter() - t0))
    for h, w in EVAL_ODD_SIZES:
        big = _images(rng, 1, 8 * (h // 8 + 1), 8 * (w // 8 + 1))[0]
        arrays.append(np.ascontiguousarray(big[:h, :w]))
    files, write_ms = [], []
    for i, arr in enumerate(arrays):
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            fail('evaluate: input %d decodes to %s %s' % (i, arr.dtype,
                                                          arr.shape))
        files.append(os.path.join(tmp, 'input%d_%dx%d.png' % (
            i, arr.shape[0], arr.shape[1])))
        t0 = time.perf_counter()
        write_png(files[-1], arr)
        write_ms.append(1e3 * (time.perf_counter() - t0))
        back = read_png(files[-1])
        if back.shape != arr.shape or back.dtype != arr.dtype or \
                not np.array_equal(back, arr):
            fail('evaluate: %s does not read back as written' % files[-1])
    say('evaluate: wrote and read back %d PNG files byte for byte: %s'
        % (len(files), [os.path.basename(f) for f in files]))
    return (files, statistics.median(read_ms),
            statistics.median(write_ms[:3]))


def _eval_k1_cases():
    """K1 against its plain version at the evaluator's shapes, and its
    time at [1, 512, 512, 3] f32 K=5 beside the plain version's and the
    bound.  Returns (worst errors by dtype, (ms, plain ms, bound))."""
    import torch
    from exposure_tpu_torch.ops.dyn_chain import (
        apply_filter_chain_dynamic, apply_filter_chain_dynamic_reference)
    dev = torch.device(DEVICE)
    banks = _banks()
    g = torch.Generator().manual_seed(SEED + 22)
    worst, timed = {'f32': 0.0, 'u8': 0}, None
    for name, bank, b, h, w, k, dt, fast, variant in EVAL_K1_CASES:
        filters = banks[bank]
        img, ids, params, kw = _case_inputs(g, filters, b, h, w, k, dt,
                                            variant, dev)
        kw['fast_math'] = fast
        if variant == 'stopped':
            active = torch.ones((k, b))
            active[2:, b - 1] = 0.0     # the last row stops after step 2
            kw['active_steps'] = active.to(dev)
        before = apply_filter_chain_dynamic.launches
        got = apply_filter_chain_dynamic(img, ids, params, filters, **kw)
        torch.cuda.synchronize()
        if apply_filter_chain_dynamic.launches != before + 1:
            fail('K1 %s: the wrapper did not launch the kernel' % name)
        want = apply_filter_chain_dynamic_reference(img, ids, params,
                                                    filters, **kw)
        err, outliers = _compare(got, want)
        line = ('evaluate: K1 %-28s exact %-3s B=%d %dx%d K=%d  max_%s=%s '
                'outlier_frac=%.2e' % (
                    name, dt, b, h, w, k,
                    'lsb' if dt == 'u8' else 'abs_err',
                    err if dt == 'u8' else '%.3e' % err, outliers))
        if variant == 'timed':
            ms = cuda_ms(lambda: apply_filter_chain_dynamic(
                img, ids, params, filters, **kw), calls=KERNEL_CALLS)
            plain = cuda_ms(lambda: apply_filter_chain_dynamic_reference(
                img, ids, params, filters, **kw), runs=5, warmup=1)
            bound = _chain_bound(ids, filters, img, fast)
            timed = (ms, plain, bound)
            line += '  kernel %.4f ms  plain %.4f ms  bound %.4f ms (%s)' % (
                ms, plain, bound['bound_ms'], bound['bound_by'])
        say(line)
        if not _ok(fast, outliers):
            fail('K1 %s disagrees with its plain version' % name)
        worst[dt] = max(worst[dt], err)
    return worst, timed


class _NoPlainVersions:
    """While active, reaching a plain version of the chain from a card
    path (the evaluator's, serving's) fails the run: K1's plain version,
    and the branchless chain and step the CPU evaluator and the CPU
    pipeline replay with."""

    def __enter__(self):
        from exposure_tpu_torch.core import evaluator, serving
        from exposure_tpu_torch.ops import dyn_chain
        self.saved = [
            (dyn_chain, 'apply_filter_chain_dynamic_reference'),
            (evaluator, 'apply_filter_chain'),
            (evaluator, 'apply_filter_step'),
            (serving, 'apply_filter_chain')]
        self.saved = [(m, n, getattr(m, n)) for m, n in self.saved]
        for module, name, _ in self.saved:
            setattr(module, name, lambda *a, _n=name, **kw: fail(
                'the card path reached the plain version %s' % _n))

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def _decoded(path, shape):
    from exposure_tpu_torch.utils.image_io import read_png
    if not os.path.exists(path):
        fail('evaluate: %s was not written' % path)
    img = read_png(path)
    if shape is not None and img.shape != shape:
        fail('evaluate: %s decodes to %s, expected %s' % (path, img.shape,
                                                          shape))
    return img


def phase_evaluate():
    """Evaluation on the card: the PNG codec's round trip, K1 at the
    evaluator's shapes, ``Evaluator`` on the trained artifact
    (``eval_batched`` in f32 and u8, ``eval`` step by step) with its files
    and K1 launches checked, the card against the CPU with dropout off,
    ``quality_report`` and ``edit_sequence``.  Returns what the summary
    line reports of it."""
    import contextlib
    import random
    import tempfile
    import numpy as np
    import torch
    from exposure_tpu_torch.core.evaluator import (
        Evaluator, downsample_to_proxy, load_linear_image)
    from exposure_tpu_torch.core.serving import batch_generator
    from exposure_tpu_torch.tools import edit_sequence, quality_report
    from exposure_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()

    def config(keep=None):
        cfg = load_config('synthetic_explore')
        cfg.name = 'synthetic_explore/best'
        if keep is not None:
            cfg.dropout_keep_prob = keep
        return cfg

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(REPO):
        files, read_ms, write_ms = _eval_inputs(tmp)
        k1_worst, k1_timed = _eval_k1_cases()
        models = os.path.join(tmp, 'models')    # no checkpoint: the artifact
        ev = Evaluator(config(), model_root=models, device=DEVICE)

        # the entry points, with the counts set to 0 before and read after
        reset_counts()
        outs = {}
        with _NoPlainVersions():
            for tag, u8 in (('f32', False), ('u8', True)):
                outs[tag] = os.path.join(tmp, 'out_' + tag)
                before = read_counts()['dyn_chain']
                res = ev.eval_batched(files, output_dir=outs[tag], seed=SEED,
                                      u8=u8)
                groups = 1 + len(EVAL_ODD_SIZES)
                if read_counts()['dyn_chain'] - before != groups:
                    fail('evaluate: eval_batched(u8=%s) launched K1 %d times '
                         'for %d resolution groups' % (
                             u8, read_counts()['dyn_chain'] - before, groups))
                for r in res:
                    if not np.isfinite(r['retouched']).all() or \
                            r['retouched'].dtype != np.float32:
                        fail('evaluate: %s retouched is not finite float32'
                             % r['file'])
            ev.seconds.clear()      # time a second, warm pass
            ev.eval_batched(files, output_dir=outs['f32'], seed=SEED)
            per_image = {k: 1e3 * v / len(files)
                         for k, v in ev.seconds.items()}
            before = read_counts()['dyn_chain']
            outs['steps'] = os.path.join(tmp, 'out_steps')
            step_res = ev.eval(files[:1], output_dir=outs['steps'],
                               step_by_step=True, seed=SEED)[0]
            n_applied = sum(s['applied'] for s in step_res['debug'])
            if read_counts()['dyn_chain'] - before != n_applied:
                fail('evaluate: step by step launched K1 %d times for %d '
                     'applied steps' % (read_counts()['dyn_chain'] - before,
                                        n_applied))
        torch.cuda.synchronize()
        counts = read_counts()
        if counts['switch_chain'] or counts['static_chain']:
            fail('evaluate launched %s' % counts)

        # every file of the artifact set exists and decodes
        for tag in ('f32', 'u8'):
            for f in files:
                shape = _decoded(f, None).shape
                for suffix in EVAL_ARTIFACTS:
                    _decoded(os.path.join(
                        outs[tag], os.path.basename(f) + suffix), shape)
        base = os.path.join(outs['steps'], os.path.basename(files[0]))
        for suffix in EVAL_STEP_ARTIFACTS:
            if suffix.endswith('.png'):
                _decoded(base + suffix,
                         None if suffix == '.steps.png' else (RES, RES, 3))
        for i in range(n_applied - 1):
            _decoded(base + '.intermediate%02d.png' % i, (RES, RES, 3))
        debug = edit_sequence.load_debug(base + '_debug.pkl')
        if [s['filter_id'] for s in debug] != \
                [s['filter_id'] for s in step_res['debug']]:
            fail('evaluate: the debug pickle does not hold the decisions')

        # step by step (K=1 launches) against the one-launch replay of the
        # recorded decisions
        image = load_linear_image(files[0])
        one = edit_sequence.replay(image, debug, ev.filters, device=DEVICE)
        err, outliers = _compare(
            torch.from_numpy(np.clip(step_res['retouched'], 0, 1)),
            torch.from_numpy(one))
        say('evaluate: eval(step_by_step=True) on %s: %d applied steps, %d '
            'K1 launches of K=1; against the one-launch replay max_abs_err='
            '%.3e outlier_frac=%.2e' % (os.path.basename(files[0]),
                                        n_applied, n_applied, err, outliers))
        if outliers > 0.0:
            fail('evaluate: step by step disagrees with the one-launch '
                 'replay')

        # u8 within 1 LSB of the f32 replay of the quantized input, on one
        # plan (dropout on)
        images = [load_linear_image(f) for f in files]
        proxies = np.stack([downsample_to_proxy(im, 64) for im in images])
        traj, applied = ev.plan_trajectory(
            proxies, batch_generator(SEED, 0, ev.device))
        with _NoPlainVersions():
            got_u8 = ev.replay_images(images, traj, u8=True)
            grid = [(np.clip(im, 0, 1) * 255.0 + 0.5).astype(np.uint8)
                    .astype(np.float32) / 255.0 for im in images]
            ref = ev.replay_images(grid, traj)
        lsb = [np.abs(np.round(np.clip(r, 0, 1) * 255) - np.round(g * 255))
               for r, g in zip(ref, got_u8)]
        u8_max = max(float(d.max()) for d in lsb)
        u8_frac = max(float((d > 1).mean()) for d in lsb)
        say('evaluate: u8 replay against the f32 replay of the quantized '
            'input, %d files, steps applied %s: max_lsb=%d, at most %.2e of '
            'a file\'s values more than 1 LSB off' % (
                len(files), applied.tolist(), u8_max, u8_frac))
        if u8_frac > MAX_OUTLIER_FRAC:
            fail('evaluate: u8 is not within 1 LSB of f32 on the u8 grid')
        eval_launches = read_counts()['dyn_chain']

        # the card against the CPU, dropout off
        plans, res = {}, {}
        for dev in ('cpu', DEVICE):
            e = Evaluator(config(keep=1.0), model_root=models, device=dev)
            plans[dev] = e.plan_trajectory(proxies)[0].filter_ids.cpu()
            for tag, u8 in (('f32', False), ('u8', True)):
                res[dev, tag] = e.eval_batched(
                    files, output_dir=os.path.join(tmp, 'cmp_%s_%s' % (
                        dev, tag)), seed=SEED, u8=u8)
        same = (plans['cpu'] == plans[DEVICE]).all(dim=0).tolist()
        if sum(same) * 2 < len(files):
            fail('evaluate: CPU and GPU plans agree on %d of %d files'
                 % (sum(same), len(files)))
        worst = {'f32': 0.0, 'u8': 0.0}
        for a, b in zip(res['cpu', 'f32'], res[DEVICE, 'f32']):
            # eval_batched lists its results by resolution group
            if not same[files.index(a['file'])]:
                continue
            err, outliers = _compare(torch.from_numpy(b['retouched']),
                                     torch.from_numpy(a['retouched']))
            worst['f32'] = max(worst['f32'], err)
            if outliers > MAX_OUTLIER_FRAC:
                fail('evaluate: %s f32 on the card is off the CPU: max %.3e, '
                     'outliers %.2e' % (a['file'], err, outliers))
        for a, b in zip(res['cpu', 'u8'], res[DEVICE, 'u8']):
            if not same[files.index(a['file'])]:
                continue
            d = np.abs(np.round(a['retouched'] * 255) -
                       np.round(b['retouched'] * 255))
            worst['u8'] = max(worst['u8'], float(d.max()))
            if (d > 1).mean() > MAX_OUTLIER_FRAC:
                fail('evaluate: %s u8 on the card is %d LSB off the CPU'
                     % (a['file'], d.max()))
        say('evaluate: card against CPU, dropout off: plans agree on %d/%d '
            'files; on those f32 max_abs_err=%.3e (outliers <= %g), u8 '
            'max_lsb=%d' % (sum(same), len(files), worst['f32'],
                            MAX_OUTLIER_FRAC, worst['u8']))

        # the white-box tools (the providers draw from the global random
        # module)
        random.seed(SEED)
        quality = quality_report.quality_report(
            config(), n=256, model_root=models, seed=SEED, device=DEVICE)
        say('evaluate: quality_report %s' % json.dumps(quality))
        if not quality['avg_after'] > quality['avg_before']:
            fail('evaluate: retouching did not move the outputs toward the '
                 'targets: %s' % quality)
        before = read_counts()['dyn_chain']
        with _NoPlainVersions():
            record = edit_sequence.main([
                '--config', 'synthetic_explore', '--debug',
                base + '_debug.pkl', '--image', files[0], '--step', '0',
                '--scale', '0.5', '--out-dir', os.path.join(tmp, 'edit'),
                '--device', DEVICE])
        if read_counts()['dyn_chain'] - before != 2:
            fail('evaluate: edit_sequence launched K1 %d times, expected 2'
                 % (read_counts()['dyn_chain'] - before))
        say('evaluate: edit_sequence %s' % json.dumps(record))
        for name in ('before.png', 'after.png'):
            _decoded(os.path.join(tmp, 'edit', name), (RES, RES, 3))
        if not record['mean_abs_change'] > 0:
            fail('evaluate: the edit changed nothing')
        eval_launches += 2

    ms, plain, bound = k1_timed
    say('evaluate: K1 launches %d on the evaluation path (eval_batched f32 '
        'and u8, eval step by step, the u8 check, edit_sequence; the '
        'comparisons apart); K1 at [1, %d, %d, 3] f32 K=5 exact %.4f ms '
        '(plain %.4f, bound %.4f by %s)' % (
            eval_launches, RES, RES, ms, plain, bound['bound_ms'],
            bound['bound_by']))
    say('evaluate: ms per image, eval_batched of %d files in f32, second '
        'pass, host clock: plan %.3f, replay %.3f, PNG read %.3f, PNG write '
        '%.3f (3 files an image); PNG codec alone on a 512x512 image: read '
        '%.3f, write %.3f' % (
            len(files), per_image['plan'], per_image['replay'],
            per_image['read'], per_image['write'], read_ms, write_ms))
    say('evaluate: avg_before %.4f avg_after %.4f (%.1f s)' % (
        quality['avg_before'], quality['avg_after'],
        time.perf_counter() - t_phase))
    return {'launches': eval_launches, 'timed': k1_timed, 'worst': k1_worst,
            'per_image_ms': per_image, 'png_read_ms': read_ms,
            'png_write_ms': write_ms, 'quality': quality}


TRAIN_CONFIG = 'synthetic_explore'
TRAIN_LAST_ITER = 11        # iterations 0-11 of the full run's schedule
TRAIN_CKPT_INTERVAL = 6     # checkpoints at 6 and 12
TRAIN_BUDGET_S = 90         # over it, cut critic_initialization (PERF.md)
TRAIN_SERVE_BATCH = 64


def _timed_trainer(trainer, caught):
    """Time ``trainer``'s steps and iterations with CUDA events, and count
    the host synchronisations that the sync debug mode flags inside each
    iteration (``caught['warnings']``: the list of caught warnings while
    the mode warns).  Returns ``{'phases': [((giters, citers), start,
    end)], 'iters': [(it, start, end, syncs)], 'metrics': [(it,
    floats)], 'sync_sites': {'file:line'}}``."""
    import torch
    record = {'phases': [], 'iters': [], 'metrics': [],
              'sync_sites': set()}
    get_step = trainer._get_step
    run_iteration = trainer.run_iteration
    process = trainer._process_record

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed_step(giters, citers):
        step = get_step(giters, citers)

        def run(*args, **kw):
            start, end = events()
            start.record()
            out = step(*args, **kw)
            end.record()
            record['phases'].append(((giters, citers), start, end))
            return out
        return run

    def flagged():
        return ['%s:%d' % (os.path.relpath(w.filename, REPO), w.lineno)
                for w in caught.get('warnings', ())
                if 'synchroniz' in str(w.message)]

    def timed_iteration(it, generator):
        start, end = events()
        before = len(flagged())
        start.record()
        out = run_iteration(it, generator)
        end.record()
        sites = flagged()[before:]
        record['iters'].append((it, start, end, len(sites)))
        record['sync_sites'].update(sites)
        return out

    def kept(it, citers, metrics, books):
        record['metrics'].append((it, [float(v) for v in metrics]))
        return process(it, citers, metrics, books)

    timed_iteration.__wrapped__ = run_iteration
    trainer._get_step = timed_step
    trainer.run_iteration = timed_iteration
    trainer._process_record = kept
    return record


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float('nan')


def _train_check():
    """One outer iteration, the card against the CPU."""
    from exposure_tpu_torch.tools import train_check as check
    from exposure_tpu_torch.utils.config import load_config
    t0 = time.perf_counter()
    report = check.card_against_cpu(load_config(TRAIN_CONFIG), DEVICE,
                                    giters=1, citers=1, seed=SEED)
    say('train: card against CPU, one outer iteration (giters 1, citers 1, '
        '%s at full width, dropout off, TF32 off, the CPU\'s draws '
        'replayed; %.1f s): metrics [card, CPU] %s' % (
            TRAIN_CONFIG, time.perf_counter() - t0,
            json.dumps(report['metrics'])))
    say('train: worst gradient difference over the largest gradient %s '
        '(bound %g); Adam\'s moments against the CPU\'s, over their largest '
        '%s (mu %g, nu %g); the card against Adam replayed on the CPU on its '
        'gradients, in ulps, %s (bound %g); '
        'worst parameter difference in lr %s (bound %g); selected ids %s; '
        'pool %s' % (
            json.dumps(report['grad_frac']), check.GRAD_FRAC,
            json.dumps(report['moment_frac']), check.GRAD_FRAC,
            2 * check.GRAD_FRAC, json.dumps(report['replay']),
            check.REPLAY_ULPS,
            json.dumps(report['param_lrs']), check.PARAM_LRS,
            json.dumps(report['ids']), json.dumps(report['pool'])))
    if report['failures']:
        fail('train: the card is off the CPU: %s' % report['failures'])
    return report


def _profile_iteration(trainer, it):
    """One more plain iteration ``it`` under ``torch.profiler``, then the
    trainer put back as it was: ``(wall ms, device-busy ms, kernel
    launches, the five kernels of most device time)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    saved = trainer.state, trainer.pool
    generator = torch.Generator(device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_iteration.__wrapped__(it, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trainer.state, trainer.pool = saved
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return 1e3 * wall, busy, len(kernels), top


def _train_run(cfg, tmp):
    """``Trainer.train()`` through iterations 0..TRAIN_LAST_ITER with the
    checks of iteration 0, the timings and the host syncs of the plain
    iterations.  Returns ``(trainer, numbers)``."""
    import random
    import numpy as np
    import torch
    from exposure_tpu_torch.core.trainer import Trainer
    random.seed(SEED)           # the providers draw from ``random``
    t0 = time.perf_counter()
    trainer = Trainer(cfg, model_root=tmp, device=DEVICE)
    init_s = time.perf_counter() - t0
    caught = {}
    record = _timed_trainer(trainer, caught)
    try:
        init = {k: v.clone() for k, v in trainer.state.tensors().items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train(last_iter=0)
        state = trainer.state
        for tree in ('gen_params', 'val_params'):
            for k, v in getattr(state, tree).items():
                if not torch.equal(v, init['%s/%s' % (tree, k)]):
                    fail('train: iteration 0 (lr 0) moved %s %s' % (tree, k))
        counts = (state.opt_g.count, state.opt_v.count, state.opt_c.count)
        if counts != (cfg.warmup_giters,) * 2 + (cfg.critic_burst,):
            fail('train: Adam counts after iteration 0: %s' % (counts,))
        term0 = trainer._metrics_last.pool_terminated_frac
        if not term0 > 0:
            fail('train: no terminated record in the pool after the warmup')
        trainer.train(last_iter=cfg.critic_initialization - 1)
        with warnings.catch_warnings(record=True) as flagged:
            warnings.simplefilter('always')
            caught['warnings'] = flagged
            torch.cuda.set_sync_debug_mode('warn')
            try:
                trainer.train(last_iter=TRAIN_LAST_ITER)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                caught.clear()
            all_syncs = sum('synchroniz' in str(w.message) for w in flagged)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        profiled = _profile_iteration(trainer, TRAIN_LAST_ITER + 1)
    finally:
        trainer.close()
    metrics = dict(record['metrics'])
    bad = {it: m for it, m in metrics.items()
           if not np.isfinite(m).all()}
    if sorted(metrics) != list(range(TRAIN_LAST_ITER + 1)) or bad:
        fail('train: metrics of iterations %s, non-finite %s'
             % (sorted(metrics), bad))
    moved = [k for k, v in trainer.state.crit_params.items()
             if not torch.equal(v, init['crit_params/' + k])]
    if not moved:
        fail('train: the critic parameters did not move')

    def ms(key):
        return [s.elapsed_time(e) for k, s, e in record['phases']
                if k == key]
    plain = [it for it in range(TRAIN_LAST_ITER + 1)
             if it >= cfg.critic_initialization and it % 500]
    iters = {it: (s.elapsed_time(e), n) for it, s, e, n in record['iters']}
    numbers = {
        'g_update_ms': _median(ms((cfg.giters, 0))) / cfg.giters,
        'g_update_warmup_ms': _median(ms((cfg.warmup_giters, 0))) /
        cfg.warmup_giters,
        'c_update_ms': _median(ms((0, cfg.citers))) / cfg.citers,
        'c_update_burst_ms': _median(ms((0, cfg.critic_burst))) /
        cfg.critic_burst,
        'plain_iteration_ms': _median([iters[it][0] for it in plain]),
        'plain_iteration_syncs': [iters[it][1] for it in plain],
        'step_sync_sites': sorted(record['sync_sites']),
        'plain_bookkeeping_syncs': all_syncs - sum(
            iters[it][1] for it in plain),
        'plain_iterations': plain,
        'peak_memory_gib': peak / 2 ** 30,
        'profiled_iteration': {
            'wall_ms': profiled[0], 'device_busy_ms': profiled[1],
            'idle_share': 1 - profiled[1] / profiled[0],
            'kernel_launches': profiled[2], 'top_kernels_ms': profiled[3]},
        'init_s': init_s, 'train_s': train_s,
        'emd': metrics[TRAIN_LAST_ITER][2],
        'reward': metrics[TRAIN_LAST_ITER][4],
        'pool_terminated_frac_after_warmup': term0,
        'critic_tensors_moved': len(moved),
    }
    return trainer, numbers


def _resume(cfg, tmp, trained):
    """A fresh Trainer restores the newest checkpoint: every tensor equal
    bit for bit to the trained state, then one more iteration."""
    import numpy as np
    import torch
    from exposure_tpu_torch.core.trainer import Trainer
    again = Trainer(cfg, restore=True, model_root=tmp, device=DEVICE)
    try:
        step = again.restore()
        want, got = trained.state.tensors(), again.state.tensors()
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        same_counts = all(
            getattr(again.state, o).count == getattr(trained.state, o).count
            for o in ('opt_g', 'opt_v', 'opt_c')) and \
            again.state.ema.count == trained.state.ema.count
        if step != trained.state.step or differ or not same_counts or \
                set(got) != set(want):
            fail('train: the restored state differs: step %d of %d, %d '
                 'tensors differ (%s), counts equal %s' % (
                     step, trained.state.step, len(differ), differ[:3],
                     same_counts))
        metrics = again.train(last_iter=step)
    finally:
        again.close()
    if not np.isfinite(np.asarray(metrics)).all() or \
            again.state.step != step + 1:
        fail('train: the iteration after the restore: %s' % (metrics,))
    say('train: resume: checkpoint %d restored into a fresh Trainer, %d '
        'tensors equal bit for bit, Adam and EMA counts equal; iteration %d '
        'after it: EMD %.4f, reward %.4f' % (step, len(want), step,
                                             metrics.emd, metrics.reward))
    return step


def _serve_trained(cfg, tmp, trained, phase='train'):
    """Export the trained state, serve the run through
    ``RetouchPipeline.from_run`` on one B=TRAIN_SERVE_BATCH batch of
    512x512 u8 (dynamic, selected plan): K1's launches by stage, no plain
    version, the artifact's weights equal to the served ones, the card
    within 1 LSB of the CPU pipeline on a small input."""
    import numpy as np
    import torch
    from exposure_tpu_torch.core.artifacts import (
        export_serving_artifact, flax_to_state_dict, load_artifact)
    from exposure_tpu_torch.core.serving import RetouchPipeline
    path = export_serving_artifact(cfg.name, trained.state,
                                   trained.state.step,
                                   path=os.path.join(tmp, 'artifact.gz'))
    exported = flax_to_state_dict(load_artifact(path)['gen_params'])
    pipe = RetouchPipeline.from_run(cfg, model_root=tmp, device=DEVICE)
    served = pipe.policy.state_dict()
    if pipe.step != trained.state.step or any(
            not torch.equal(served[k].cpu(), exported[k]) for k in exported):
        fail('%s: from_run serves step %s, the export holds step %d or '
             'other weights' % (phase, pipe.step, trained.state.step))
    if not (pipe.dynamic and pipe.selected_plan):
        fail('%s: the pipeline is not dynamic with the selected plan'
             % phase)
    batch = torch.from_numpy(_images(np.random.default_rng(SEED + 11),
                                     TRAIN_SERVE_BATCH, RES, RES)).to(DEVICE)
    stages = _count_k1_by_stage(pipe)
    reset_counts()
    with _NoPlainVersions():
        out = pipe(batch, SEED, 0, device_out=True)
    torch.cuda.synchronize()
    counts = read_counts()
    by_stage = {'proxy': stages['plan'], 'replay': stages['replay']}
    steps = pipe.cfg.test_steps
    if by_stage != {'proxy': steps, 'replay': 1} or \
            counts['dyn_chain'] != steps + 1 or counts['switch_chain'] or \
            counts['static_chain']:
        fail('%s: serving the trained policy launched %s (K1 by stage %s)'
             % (phase, counts, by_stage))
    if out.shape != batch.shape or out.dtype != torch.uint8:
        fail('%s: served %s %s' % (phase, tuple(out.shape), out.dtype))

    same, lsb = _small_against_cpu(
        lambda dev: RetouchPipeline.from_run(cfg, model_root=tmp, device=dev,
                                             use_kernels=True),
        '%s: the trained policy served' % phase)
    say('%s: served step %d through from_run on [%d, %d, %d, 3] u8: K1 '
        'launches %d (%d on the proxy in the plan, %d replay), no plain '
        'version; the exported artifact holds the served weights bit for '
        'bit; small input against the CPU pipeline, dropout off: plans agree '
        'on %d/8 rows, max_lsb %d' % (
            phase, pipe.step, TRAIN_SERVE_BATCH, RES, RES,
            counts['dyn_chain'],
            by_stage['proxy'], by_stage['replay'], same, lsb))
    return counts['dyn_chain']


def phase_train():
    """Training on the card: one outer iteration against the CPU; the
    Trainer at full width through iterations 0-11, timed; resume; the
    trained policy exported and served through K1.  Returns what the
    summary line reports of it."""
    import contextlib
    import tempfile
    from exposure_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()
    report = _train_check()
    cfg = load_config(TRAIN_CONFIG)
    cfg.name = TRAIN_CONFIG + '/smoke'
    cfg.checkpoint_interval = TRAIN_CKPT_INTERVAL
    # the plain dispatch with its bookkeeping at once, as this phase has
    # timed it since it began (phase_fused times the fused one)
    cfg.update(iters_per_dispatch=1, dispatch_pipeline_depth=0)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(REPO):
        trainer, numbers = _train_run(cfg, tmp)
        run = os.path.join(tmp, cfg.name)
        with open(os.path.join(run, 'log.txt')) as f:
            log = f.read()
        with open(os.path.join(run, 'metrics.jsonl')) as f:
            rows = [json.loads(line)['step'] for line in f]
        ckpts = sorted((p for p in os.listdir(run) if p.endswith('.msgpack')),
                       key=lambda p: int(re.findall(r'\d+', p)[0]))
        want_ckpts = ['model.ckpt-%d.msgpack' % s for s in (6, 12)]
        if 'it     0,' not in log or 'it    10,' not in log or \
                rows != [0, 10] or ckpts != want_ckpts:
            fail('train: run layout: log lines %s, metrics.jsonl steps %s, '
                 'checkpoints %s' % ('it    10,' in log, rows, ckpts))
        say('train: %s (B=%d, pool %d, %d filters, conv channels from %d, '
            '%d-d features, fc %d; iters_per_dispatch 1, bookkeeping at '
            'once), iterations 0-%d of the schedule (warmup %d at lr 0, '
            'critic bursts of %d through iteration %d, then giters %d '
            'citers %d), checkpoint every %d: '
            'init %.1f s, training %.1f s; every metric finite; iteration 0 '
            'kept the generator and value bits, Adam counts %d/%d/%d; pool '
            'terminated %.4f after the warmup; %d critic tensors moved; '
            'log lines, metrics.jsonl steps %s, checkpoints %s' % (
                TRAIN_CONFIG, cfg.batch_size, cfg.replay_memory_size,
                len(cfg.filters), cfg.base_channels,
                cfg.feature_extractor_dims, cfg.fc1_size,
                TRAIN_LAST_ITER, cfg.warmup_giters, cfg.critic_burst,
                cfg.critic_initialization - 1, cfg.giters, cfg.citers,
                cfg.checkpoint_interval, numbers['init_s'],
                numbers['train_s'], cfg.warmup_giters, cfg.warmup_giters,
                cfg.critic_burst, numbers['pool_terminated_frac_after_warmup'],
                numbers['critic_tensors_moved'], rows, ckpts))
        say('train: ms per generator update %.4f (warmup %.4f), per critic '
            'update %.4f (burst %.4f), per plain outer iteration %.4f '
            '(iterations %s; CUDA events, medians); peak memory %.3f GiB; '
            'host syncs flagged by the sync debug mode in each plain '
            'iteration\'s steps %s (at %s), in its bookkeeping %d over the '
            '%d (the metric read, and the checkpoint at 12); EMD %.4f and '
            'reward %.4f at iteration %d' % (
                numbers['g_update_ms'], numbers['g_update_warmup_ms'],
                numbers['c_update_ms'], numbers['c_update_burst_ms'],
                numbers['plain_iteration_ms'], numbers['plain_iterations'],
                numbers['peak_memory_gib'], numbers['plain_iteration_syncs'],
                ', '.join(numbers['step_sync_sites']) or 'nowhere',
                numbers['plain_bookkeeping_syncs'],
                len(numbers['plain_iterations']), numbers['emd'],
                numbers['reward'], TRAIN_LAST_ITER))
        say('train: one more plain iteration under torch.profiler (the '
            'trainer put back after it): %s' % json.dumps(
                numbers['profiled_iteration']))
        _resume(cfg, tmp, trainer)
        numbers['launches_serve'] = _serve_trained(cfg, tmp, trainer)
    numbers['phase_s'] = time.perf_counter() - t_phase
    numbers['check'] = report
    say('train: phase %.1f s (budget %d s)' % (numbers['phase_s'],
                                               TRAIN_BUDGET_S))
    return numbers


DATA_BUDGET_S = 150
DATA_PACK_ROWS = 20000      # 5,000 FiveK ids x 4 crops of 80x80
DATA_FOLDS = {'FiveK_train_first2k.txt': 2000,
              'FiveK_train_second2k.txt': 2000, 'FiveK_test.txt': 500,
              'FiveK_test_AMT.txt': 100}
DATA_ARTIST_HW = (88, 84)   # the artist PNGs' size: centre 84x84, kept 80
DATA_TIFFS = 6
DATA_CRITIC_INIT = 2        # cut from 10: bursts at iterations 0-1 only
DATA_LAST_ITER = 21         # iterations 0-21: the bursts, two chunks
DATA_CKPT_INTERVAL = 22     # a checkpoint at 22; the chunks 2-11, 12-21


def _write_tiff(path, arr, rows_per_strip=16):
    """A baseline TIFF (little-endian, deflate, strips) of a uint16
    [H, W, 3] array: the Lightroom exports' format, without imageio."""
    import struct
    import zlib
    h, w, c = arr.shape
    strips = [zlib.compress(arr[top:top + rows_per_strip].astype('<u2')
                            .tobytes()) for top in range(0, h,
                                                         rows_per_strip)]
    offsets = [8 + sum(len(s) for s in strips[:k])
               for k in range(len(strips))]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [16] * c), (259, 3, [8]),
            (262, 3, [2]), (273, 4, offsets), (277, 3, [c]),
            (278, 4, [rows_per_strip]),
            (279, 4, [len(s) for s in strips]), (284, 3, [1])]
    ifd_at = 8 + sum(len(s) for s in strips)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, extra = b'', b''
    for tag, kind, values in tags:
        packed = struct.pack('<' + ('H' if kind == 3 else 'I') * len(values),
                             *values)
        if len(packed) <= 4:
            field = packed.ljust(4, b'\0')
        else:
            field = struct.pack('<I', extra_at + len(extra))
            extra += packed
        entries += struct.pack('<HHI', tag, kind, len(values)) + field
    with open(path, 'wb') as f:
        f.write(b'II' + struct.pack('<HI', 42, ifd_at) + b''.join(strips) +
                struct.pack('<H', len(tags)) + entries +
                struct.pack('<I', 0) + extra)


def _fivek_tree(root):
    """The FiveK layout at the dataset's size, made from seeds: the RAW pack
    (written in chunks of ``make_synthetic_pack``, on 8 threads), its
    ``meta_raw.pkl``, the fold files, 5,000 artist PNGs (the port's codec)
    and a few 16-bit TIFF exports, those read back equal and run through
    ``preprocess_raw_aug``.  Returns what it printed."""
    import pickle
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from exposure_tpu_torch.data import fivek
    from exposure_tpu_torch.data.synthetic import make_synthetic_pack
    from exposure_tpu_torch.utils.image_io import read_tiff, write_png
    t0 = time.perf_counter()
    batched = os.path.join(root, fivek.BATCHED_DIR)
    os.makedirs(batched)
    pack = np.lib.format.open_memmap(
        os.path.join(batched, 'image_raw.npy'), mode='w+', dtype=np.float32,
        shape=(DATA_PACK_ROWS, 80, 80, 3))
    chunk = 500

    def raw_chunk(k):
        pack[k * chunk:(k + 1) * chunk] = make_synthetic_pack(
            chunk, 80, 'raw', SEED + 100 + k)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(raw_chunk, range(DATA_PACK_ROWS // chunk)))
    pack.flush()
    del pack
    ids = DATA_PACK_ROWS // fivek.AUGMENTATION_FACTOR
    with open(os.path.join(batched, 'meta_raw.pkl'), 'wb') as f:
        pickle.dump({'filenames': ['a%04d.tif' % (i + 1)
                                   for i in range(ids)]}, f, protocol=-1)
    pack_s = time.perf_counter() - t0

    folds = os.path.join(root, 'data', 'folds')
    os.makedirs(folds)
    perm = np.random.RandomState(SEED).permutation(ids) + 1
    start = 0
    for name, n in DATA_FOLDS.items():
        if name == 'FiveK_test_AMT.txt':
            chosen = perm[4000:4000 + n]       # a part of the test fold
        else:
            chosen = perm[start:start + n]
            start += n
        with open(os.path.join(folds, name), 'w') as f:
            f.write('# FiveK ids, made from seed %d\n' % SEED)
            f.write(''.join('%d\n' % i for i in chosen))

    t0 = time.perf_counter()
    artists = os.path.join(root, 'data', 'artists', 'FiveK_C')
    os.makedirs(artists)
    h, w = DATA_ARTIST_HW

    def artist_chunk(k):
        imgs = make_synthetic_pack(chunk, h, 'retouched', SEED + 200 + k)
        for i, img in enumerate(imgs):
            write_png(os.path.join(artists, 'a%04d.png' % (k * chunk + i + 1)),
                      (np.clip(img[:, :w], 0, 1) * 255 + 0.5)
                      .astype(np.uint8))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(artist_chunk, range(ids // chunk)))
    artist_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    source = os.path.join(root, fivek.SOURCE_DIR)
    os.makedirs(source)
    rng = np.random.RandomState(SEED + 3)
    for i in range(DATA_TIFFS):
        img = (rng.rand(96 + 24 * i, 200, 3) * 65535).astype(np.uint16)
        path = os.path.join(source, 'a%04d.tif' % (i + 1))
        _write_tiff(path, img)
        back = read_tiff(path)
        if back.dtype != np.uint16 or not np.array_equal(back, img):
            fail('data: the TIFF %s read back %s %s, not as written'
                 % (path, back.dtype, back.shape))
    import random
    random.seed(SEED)
    raw = fivek.preprocess_raw_aug(source, os.path.join(root, 'tiff_pack'))
    with open(os.path.join(root, 'tiff_pack', 'meta_raw.pkl'), 'rb') as f:
        meta = pickle.load(f)
    if raw.shape != (4 * DATA_TIFFS, 80, 80, 3) or \
            not np.isfinite(raw).all() or raw.min() < 0 or raw.max() > 1 or \
            len(meta['filenames']) != DATA_TIFFS:
        fail('data: preprocess_raw_aug gave %s in [%s, %s], %d names'
             % (raw.shape, raw.min(), raw.max(), len(meta['filenames'])))
    tiff_s = time.perf_counter() - t0
    say('data: the FiveK layout in %s: image_raw.npy [%d, 80, 80, 3] f32 '
        '(%.3f GB, make_synthetic_pack in chunks of %d on 8 threads, no '
        'row tiled) and meta_raw.pkl in %.1f s; folds %s; %d artist PNGs of '
        '%dx%d u8 (make_synthetic_pack retouched, the port\'s PNG codec) '
        'in %.1f s; %d 16-bit TIFFs (deflate, strips) written, read back '
        'equal and through preprocess_raw_aug to [%d, 80, 80, 3] in %.1f s'
        % (root, DATA_PACK_ROWS, DATA_PACK_ROWS * 80 * 80 * 3 * 4 / 1e9,
           chunk, pack_s, json.dumps(DATA_FOLDS), ids, h, w, artist_s,
           DATA_TIFFS, len(raw), tiff_s))
    return {'pack_s': pack_s, 'artist_s': artist_s, 'tiff_s': tiff_s}


def _splitmix64(state):
    """``hostloader.cpp``'s splitmix64 step on a Python int: (new state,
    draw)."""
    mask = (1 << 64) - 1
    state = (state + 0x9e3779b97f4a7c15) & mask
    z = state
    z = ((z ^ (z >> 30)) * 0xbf58476d1ce4e5b9) & mask
    z = ((z ^ (z >> 27)) * 0x94d049bb133111eb) & mask
    return state, z ^ (z >> 31)


def _loader_checks(raw_path, target_path, cfg):
    """The native loader on the card's host: same seed, same crops; u8 the
    f32 crops quantized; crops 0-3 the subwindows or flips of the pack that
    the draws name (splitmix64 here in Python); the assembly rate of one
    plain iteration's bundles and of a chunk of 10 against a numpy copy of
    the same bytes."""
    import numpy as np
    from exposure_tpu_torch.core.streaming import (
        assemble_stream,
        bundle_shapes,
    )
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    from exposure_tpu_torch.native import NativePack
    pack = NativePack(raw_path)
    data = np.load(raw_path, mmap_mode='r')
    seed = 12345
    a = pack.sample(64, 64, augment=True, seed=seed)
    if not np.array_equal(a, pack.sample(64, 64, augment=True, seed=seed)):
        fail('data: one seed gave two crop batches')
    u8 = pack.sample_into(np.empty(a.shape, np.uint8), augment=True,
                          seed=seed)
    if not np.array_equal(u8, (np.clip(a, 0, 1) * np.float32(255) +
                               np.float32(0.5)).astype(np.uint8)):
        fail('data: the u8 crops are not the f32 crops quantized')
    n, hh, ww, _ = pack.shape
    for i in range(4):
        state = seed ^ ((0x5851f42d4c957f2d * (i + 1)) & ((1 << 64) - 1))
        state, z = _splitmix64(state)
        idx = z % n
        state, z = _splitmix64(state)
        sx = z % (hh - 64 + 1)
        state, z = _splitmix64(state)
        sy = z % (ww - 64 + 1)
        state, z = _splitmix64(state)
        want = data[idx, sx:sx + 64, sy:sy + 64]
        if z & 1:
            want = want[:, ::-1]
        if not np.array_equal(a[i], want):
            fail('data: crop %d is not image %d at (%d, %d), flip %d'
                 % (i, idx, sx, sy, z & 1))
    pack.close()

    def providers():
        return (NativePackProvider(raw_path, 64, 0.3, seed=SEED),
                NativePackProvider(target_path, 64, 1.0, seed=SEED + 1))
    rates = {}
    for dtype in ('float32', 'uint8'):
        cfg.stream_dtype = dtype
        fake, real = providers()
        for name, keys in (('plain_iteration', [(cfg.giters, 0, 1),
                                                (0, cfg.citers, 1)]),
                           ('chunk_of_10', [(cfg.giters, cfg.citers, 10)])):
            dt = np.uint8 if dtype == 'uint8' else np.float32
            bufs = [tuple(np.empty(s, dt) for s in bundle_shapes(
                cfg, False, *key)) for key in keys]
            nbytes = sum(x.nbytes for pair in bufs for x in pair)
            times, copies = [], []
            copy_src = np.ones(nbytes, np.uint8)
            copy_dst = np.empty_like(copy_src)
            for _ in range(5):
                t0 = time.perf_counter()
                for key, out in zip(keys, bufs):
                    assemble_stream(cfg, False, fake, real, *key, out=out)
                times.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                np.copyto(copy_dst, copy_src)
                copies.append(time.perf_counter() - t0)
            rates['%s_%s' % (name, dtype)] = {
                'mb': nbytes / 1e6, 'assembly_ms': 1e3 * _median(times),
                'assembly_gb_s': nbytes / _median(times) / 1e9,
                'numpy_copy_gb_s': nbytes / _median(copies) / 1e9}
        fake.close()
        real.close()
    cfg.stream_dtype = 'float32'
    say('data: loader on the card\'s host: one seed, one crop batch; u8 the '
        'f32 crops quantized; crops 0-3 the pack windows the draws name; '
        'assembly (median of 5, host clock) against a numpy copy of the '
        'same bytes: %s' % json.dumps(rates))
    return rates


def _data_trainer(cfg, tmp, tag, stream_dtype=None, paths=None):
    """A Trainer of ``cfg``, resident or streaming in ``stream_dtype`` from
    the packs ``paths``, trained alone through its special iterations
    (0 .. critic_initialization - 1), timed by ``_timed_trainer``.  Returns
    ``(trainer, run)``: ``run`` holds the record, the init seconds and the
    memory the trainer took (its own peak over the init and those
    iterations, above what was allocated before it)."""
    import random
    import torch
    from exposure_tpu_torch.core.trainer import Trainer
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    cfg = cfg.copy()
    cfg.name = 'example/' + tag
    if stream_dtype:
        cfg.update(stream_data=True, stream_dtype=stream_dtype)
        cfg.fake_data_provider = lambda: NativePackProvider(
            paths[0], output_size=64, augmentation=0.3, seed=SEED)
        cfg.real_data_provider = lambda: NativePackProvider(
            paths[1], output_size=64, augmentation=1.0, seed=SEED + 1)
    random.seed(SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, model_root=tmp, device=DEVICE)
    run = {'tag': tag, 'init_s': time.perf_counter() - t0, 'caught': {},
           'stream': bool(stream_dtype), 'transient': 0}
    run['record'] = _timed_trainer(trainer, run['caught'])
    if stream_dtype:
        trainer.stream_timings = []
    t0 = time.perf_counter()
    trainer.train(last_iter=cfg.critic_initialization - 1)
    torch.cuda.synchronize()
    run['specials_s'] = time.perf_counter() - t0
    run['peak'] = torch.cuda.max_memory_allocated() - base
    return trainer, run


def _interleaved(trainers, runs, plain):
    """The plain iterations of every trainer in turns, one iteration each
    in turn, so that the host's drift reaches them alike, under the sync
    debug mode ('warn'); each iteration's transient memory (its peak above
    what was allocated before it) is kept."""
    import torch
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter('always')
        for run in runs:
            run['caught']['warnings'] = flagged
        torch.cuda.set_sync_debug_mode('warn')
        try:
            for it in plain:
                for trainer, run in zip(trainers, runs):
                    before = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    trainer.train(last_iter=it)
                    run['transient'] = max(
                        run['transient'],
                        torch.cuda.max_memory_allocated() - before)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for run in runs:
                run['caught'].clear()
    torch.cuda.synchronize()


def _data_numbers(trainer, run, plain):
    """What a data-phase run reports: finite metrics of every iteration,
    ms per update and per plain iteration (CUDA events), host syncs in the
    plain iterations' steps, memory; for streaming the assembly, upload
    and wait per bundle by shape."""
    import numpy as np
    cfg, record, tag = trainer.cfg, run['record'], run['tag']
    metrics = dict(record['metrics'])
    bad = {it: m for it, m in metrics.items() if not np.isfinite(m).all()}
    if sorted(metrics) != list(range(DATA_LAST_ITER + 1)) or bad:
        fail('data: %s: metrics of iterations %s, non-finite %s'
             % (tag, sorted(metrics), bad))
    iters = {it: (s.elapsed_time(e), n) for it, s, e, n in record['iters']}

    def ms(key):
        return [s.elapsed_time(e) for k, s, e in record['phases']
                if k == key]
    numbers = {
        'init_s': run['init_s'], 'specials_s': run['specials_s'],
        'g_update_ms': _median(ms((cfg.giters, 0))) / cfg.giters,
        'c_update_ms': _median(ms((0, cfg.citers))) / cfg.citers,
        'plain_iteration_ms': _median([iters[it][0] for it in plain]),
        'plain_iteration_ms_all': [iters[it][0] for it in plain],
        'plain_iteration_syncs': [iters[it][1] for it in plain],
        'step_sync_sites': sorted(record['sync_sites']),
        # its own peak over the init and iterations 0-1 (packs, state,
        # the warmup and the bursts), and the most a plain iteration took
        # above what was allocated before it
        'peak_memory_gib': run['peak'] / 2 ** 30,
        'plain_transient_gib': run['transient'] / 2 ** 30,
        'emd': metrics[DATA_LAST_ITER][2],
    }
    if run['stream']:
        timings = trainer.stream_timings
        numbers['bundles'] = len(timings)
        if any('copy' not in t for t in timings):
            fail('data: %s: a bundle went to the card without its copy '
                 'events' % tag)

        def event_ms(rows, name):
            return _median([s.elapsed_time(e) for s, e in
                            (r[name] for r in rows)])
        by_key = {}
        for t in timings:
            by_key.setdefault(str(t['key']), []).append(t)
        numbers['per_bundle'] = {
            key: {'count': len(rows),
                  'assembly_ms': 1e3 * _median([r['assembly_s']
                                                for r in rows]),
                  'upload_ms': event_ms(rows, 'copy'),
                  'wait_ms': event_ms(rows, 'wait')}
            for key, rows in by_key.items()}
    return numbers


def _u8_first_step(cfg, paths):
    """The streaming step at full width on the card: on the first u8
    bundle of a run, on that bundle dequantized on the host, and on that
    again (a control), from the same state, pool and draws, with cuDNN's
    and torch's deterministic algorithms (cuDNN's default algorithms add in
    an order that can differ from call to call): the device's dequantization
    equal to the host's, and every tensor of the steps equal bit for bit.
    Returns the number of state tensors compared."""
    import random
    import numpy as np
    import torch
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import (
        build_streaming_outer_step,
        dequant_stream,
    )
    from exposure_tpu_torch.core.streaming import assemble_stream
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.draws import Draws
    from exposure_tpu_torch.utils.ops import deterministic_algorithms, tf32_off
    cfg = cfg.copy()
    cfg.stream_dtype = 'uint8'
    nets = build_models(cfg)
    state = init_train_state(cfg, *nets[1:], seed=SEED, device=DEVICE)
    fake = NativePackProvider(paths[0], 64, 0.3, seed=SEED)
    real = NativePackProvider(paths[1], 64, 1.0, seed=SEED + 1)
    random.seed(SEED)
    pool_images = torch.from_numpy(fake.get_next_batch(
        cfg.replay_memory_size)[0]).to(DEVICE)
    g, r = assemble_stream(cfg, False, fake, real, cfg.giters, cfg.citers)
    fake.close()
    real.close()
    inv = np.float32(1.0 / 255.0)
    host = (g.astype(np.float32) * inv, r.astype(np.float32) * inv)
    for u8, f32 in zip((g, r), host):
        on_card = dequant_stream(torch.from_numpy(u8).to(DEVICE)).cpu()
        if not torch.equal(on_card, torch.from_numpy(f32)):
            fail('data: the card\'s dequantization differs from the host\'s')
    step = build_streaming_outer_step(cfg, *nets[1:], nets[0], cfg.giters,
                                      cfg.citers)
    outs = []
    with tf32_off(), deterministic_algorithms():
        for gb, rb in ((g, r), host, host):
            pool = PoolState.create(pool_images.clone(), cfg.num_state_dim)
            draws = Draws(torch.Generator(DEVICE).manual_seed(SEED), DEVICE)
            outs.append(step(state, pool, torch.from_numpy(gb).to(DEVICE),
                             torch.from_numpy(rb).to(DEVICE), draws,
                             cfg.lr_g(1), cfg.lr_c(1), 1 / cfg.max_iter_step))

    def differing(x, y):
        a, b = x[0].tensors(), y[0].tensors()
        out = [k for k in a if not torch.equal(a[k], b[k])]
        if not torch.equal(x[1].images, y[1].images):
            out.append('pool')
        if not torch.equal(torch.stack(list(x[2])), torch.stack(list(y[2]))):
            out.append('metrics')
        return out
    control, u8 = differing(outs[1], outs[2]), differing(outs[0], outs[1])
    if control or u8:
        fail('data: the u8 step against the f32 step on its dequantized '
             'bundle: %d differ (%s); the f32 step against itself, the '
             'control: %d differ (%s)' % (len(u8), u8[:3], len(control),
                                          control[:3]))
    return len(outs[0][0].tensors())


def phase_data(root):
    """The data path and streaming training: the host loader built by g++;
    the FiveK layout at the dataset's size in ``root`` (``phase_parallel``
    trains in it too); ``example``'s three providers in it; the loader on
    the card's host; ``example`` at full width trained resident and
    streaming (f32, u8); one streaming step on the card against the CPU;
    the streaming-trained state served through K1.  Returns what the
    summary lines report of it."""
    import contextlib
    import numpy as np
    from exposure_tpu_torch.data.fivek import FiveKDataProvider
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    from exposure_tpu_torch.native import build as native_build
    from exposure_tpu_torch.tools import train_check as check
    from exposure_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()
    lib = native_build.build()
    say('data: host loader %s built by g++ %s in %.2f s'
        % (os.path.relpath(lib.path, REPO), ' '.join(native_build.GXX_FLAGS),
           lib.build_seconds))
    numbers = {'build_s': lib.build_seconds}
    with contextlib.chdir(root):
        numbers['tree'] = _fivek_tree(root)
        cfg = load_config('example')
        # the plain dispatch, bookkeeping at once (phase_fused: the fused)
        cfg.update(critic_initialization=DATA_CRITIC_INIT,
                   checkpoint_interval=DATA_CKPT_INTERVAL,
                   iters_per_dispatch=1, dispatch_pipeline_depth=0)
        FiveKDataProvider._raw_image_pack = None
        loads, sizes = {}, {}
        for knob in ('fake_data_provider', 'fake_data_provider_test',
                     'real_data_provider'):
            t0 = time.perf_counter()
            prov = cfg[knob]()
            loads[knob] = time.perf_counter() - t0
            sizes[knob] = prov.num_images
            if knob == 'real_data_provider':
                target = os.path.join(root, 'target.npy')
                np.save(target, prov.data)
        want = {'fake_data_provider': 8000, 'fake_data_provider_test': 2000,
                'real_data_provider': 8000}
        if sizes != want:
            fail('data: the example providers hold %s crops, want %s'
                 % (sizes, want))
        raw_path = os.path.join(root, 'data', 'fivek_dataset',
                                'sup_batched80aug_daylight', 'image_raw.npy')
        numbers['loader'] = _loader_checks(raw_path, target, cfg.copy())

        models = os.path.join(root, 'models')
        paths = (raw_path, target)
        trainers, runs = [], []
        for tag, dtype in (('resident', None), ('stream_float32', 'float32'),
                           ('stream_uint8', 'uint8')):
            trainer, run = _data_trainer(cfg, models, tag, dtype, paths)
            trainers.append(trainer)
            runs.append(run)
        plain = list(range(cfg.critic_initialization, DATA_LAST_ITER + 1))
        try:
            _interleaved(trainers, runs, plain)
        finally:
            for trainer in trainers[::-1]:     # each tees the one before
                trainer.close()
        rows = {run['tag']: _data_numbers(trainer, run, plain)
                for trainer, run in zip(trainers, runs)}
        resident, trainer = trainers[0], trainers[2]
        packs = {'fake': resident.fake_images.nbytes,
                 'real': resident.real_images.nbytes}
        if packs != {'fake': 614400000, 'real': 393216000}:
            fail('data: device packs %s bytes' % packs)
        say('data: example\'s providers in the tree: %s crops, loaded in %s '
            's; the resident Trainer\'s device packs %.1f MB (FiveK 2k_train) '
            'and %.1f MB (FiveK_C 2k_target) on the card (predicted 614.4 '
            'and 393.2)' % (json.dumps(sizes), json.dumps(loads),
                            packs['fake'] / 1e6, packs['real'] / 1e6))
        numbers['provider_load_s'] = loads
        numbers['device_pack_bytes'] = packs
        numbers['resident'] = rows['resident']
        numbers['stream'] = {k: rows['stream_' + k]
                             for k in ('float32', 'uint8')}
        for tag, row in rows.items():
            say('data: %s: %s' % (tag, json.dumps(row)))
        base = rows['resident']['plain_iteration_ms']
        say('data: ms per plain iteration (iterations %d-%d of the three '
            'trainers in turns, iters_per_dispatch 1, medians, CUDA '
            'events): resident %.4f, '
            'streaming f32 %.4f (%+.2f%%), u8 %.4f (%+.2f%%); paired '
            'differences, median: f32 %+.4f ms, u8 %+.4f ms' % (
                plain[0], plain[-1], base,
                rows['stream_float32']['plain_iteration_ms'],
                100 * (rows['stream_float32']['plain_iteration_ms'] / base
                       - 1),
                rows['stream_uint8']['plain_iteration_ms'],
                100 * (rows['stream_uint8']['plain_iteration_ms'] / base
                       - 1),
                _median([a - b for a, b in zip(
                    rows['stream_float32']['plain_iteration_ms_all'],
                    rows['resident']['plain_iteration_ms_all'])]),
                _median([a - b for a, b in zip(
                    rows['stream_uint8']['plain_iteration_ms_all'],
                    rows['resident']['plain_iteration_ms_all'])])))
        syncs = [row['plain_iteration_syncs'] for row in rows.values()]
        if any(any(s) for s in syncs):
            fail('data: host syncs in the plain iterations\' steps: %s (at '
                 '%s)' % (syncs, [row['step_sync_sites']
                                  for row in rows.values()]))
        numbers['u8_step_tensors_equal'] = _u8_first_step(cfg, paths)
        say('data: the streaming step at full width on the card on a u8 '
            'bundle and on it dequantized on the host (the card\'s '
            'dequantization equal to the host\'s; deterministic cuDNN, a '
            'second f32 step as the control): %d state tensors, the pool '
            'and the metrics equal bit for bit'
            % numbers['u8_step_tensors_equal'])
        t0 = time.perf_counter()
        stream_cfg = cfg.copy()
        stream_cfg.fake_data_provider = lambda: NativePackProvider(
            raw_path, 64, 0.3, seed=SEED)
        stream_cfg.real_data_provider = lambda: NativePackProvider(
            target, 64, 1.0, seed=SEED + 1)
        report = check.card_against_cpu(stream_cfg, DEVICE, giters=1,
                                        citers=1, seed=SEED, stream='uint8')
        say('data: one streaming step (u8 bundle, giters 1, citers 1, '
            'example at full width) on the card against the CPU, %.1f s: '
            'metrics %s; gradients over the largest %s (bound %g); moments '
            '%s; Adam replayed, ulps %s (bound %g); parameters in lr %s '
            '(bound %g); ids %s; pool %s' % (
                time.perf_counter() - t0, json.dumps(report['metrics']),
                json.dumps(report['grad_frac']), check.GRAD_FRAC,
                json.dumps(report['moment_frac']),
                json.dumps(report['replay']), check.REPLAY_ULPS,
                json.dumps(report['param_lrs']), check.PARAM_LRS,
                json.dumps(report['ids']), json.dumps(report['pool'])))
        if report['failures']:
            fail('data: the streaming step on the card is off the CPU: %s'
                 % report['failures'])
        numbers['check'] = report
        stream_run = cfg.copy()
        stream_run.name = trainer.cfg.name
        numbers['launches_serve'] = _serve_trained(stream_run, models,
                                                   trainer, 'data')
        FiveKDataProvider._raw_image_pack = None
    numbers['phase_s'] = time.perf_counter() - t_phase
    say('data: phase %.1f s (budget %d s)' % (numbers['phase_s'],
                                              DATA_BUDGET_S))
    return numbers


PARALLEL_BUDGET_S = 150
PARALLEL_CONFIG = 'example'
PARALLEL_ONE_BACKEND = 'nccl'   # the world-size-1 group's
PARALLEL_WORLD = 2              # ranks sharing the one card, over gloo
PARALLEL_LAST_ITER = 11         # iterations 0-11, as phase_data's specials
PARALLEL_CKPT_INTERVAL = 6      # checkpoints at 6 and 12: the resume's
PARALLEL_DEADLINE_S = 300       # a spawned world's, then it is killed


def _release():
    """Free this process's cached card memory (``empty_cache``) before
    spawned ranks share the card with it (the earlier phases leave tens of
    GiB cached)."""
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _worlds_in_turns(root, work, mesh, world, backend, tag):
    """``example``'s ``TrainerRun`` (``tools/parallel_check.py``) on
    ``mesh``, a world-size-1 group in this process, through iterations 0-6;
    then a spawned world of ``world`` ranks over ``backend`` through
    iterations 0-11; then world 1's 7-11, so that both worlds' plain
    iterations come in turns.  Fails unless every rank's metrics are finite,
    every resume is bit for bit, the ranks' parameters agree after every
    iteration and rank 0 alone wrote ``metrics.jsonl``.  Returns ``(world
    1's findings, each rank's, the spawned world's seconds)``."""
    import numpy as np
    from exposure_tpu_torch.data.fivek import FiveKDataProvider
    from exposure_tpu_torch.parallel.launch import spawn_ranks
    from exposure_tpu_torch.tools import parallel_check as pc
    job = dict(config=PARALLEL_CONFIG, root=root, seed=SEED,
               last_iter=PARALLEL_LAST_ITER,
               knobs=dict(critic_initialization=DATA_CRITIC_INIT,
                          checkpoint_interval=PARALLEL_CKPT_INTERVAL,
                          # the plain dispatch: gloo's all-reduce goes
                          # through the host and cannot be captured
                          iters_per_dispatch=1, dispatch_pipeline_depth=0))
    FiveKDataProvider._raw_image_pack = None
    one = pc.TrainerRun(mesh, dict(job, name='%s/world_1' % PARALLEL_CONFIG,
                                   model_root=os.path.join(work, 'one')))
    one.run(0, 6)
    FiveKDataProvider._raw_image_pack = None
    _release()
    t0 = time.perf_counter()
    ranks = spawn_ranks(pc.trainer_rank, world, (dict(
        job, name='%s/world_%d' % (PARALLEL_CONFIG, world),
        model_root=os.path.join(work, 'many')),), device=DEVICE,
        backend=backend, deadline_s=PARALLEL_DEADLINE_S, rendezvous_dir=work)
    seconds = time.perf_counter() - t0
    one.run(7, PARALLEL_LAST_ITER)
    one = one.finish()
    FiveKDataProvider._raw_image_pack = None
    for label, runs in (('world 1', [one]), ('world %d' % world, ranks)):
        for run in runs:
            bad = {it: m for it, m in run['metrics'].items()
                   if not np.isfinite(m).all()}
            if bad or sorted(run['metrics']) != list(
                    range(PARALLEL_LAST_ITER + 1)):
                fail('%s: %s rank %d: metrics of iterations %s, non-finite '
                     '%s' % (tag, label, run['rank'],
                             sorted(run['metrics']), bad))
            if not run['resume_equal']:
                fail('%s: %s: the resumed run differs from the one not '
                     'stopped' % (tag, label))
    if not all(r['params_equal_every_iteration'] for r in ranks):
        fail('%s: the ranks\' parameters differ after an iteration' % tag)
    if ranks[0]['metrics_files'] != 1 or any(
            r['metrics'] != ranks[0]['metrics'] for r in ranks):
        fail('%s: rank 0 wrote %s metrics.jsonl; the ranks\' metrics agree: '
             '%s' % (tag, ranks[0]['metrics_files'], all(
                 r['metrics'] == ranks[0]['metrics'] for r in ranks)))
    return one, ranks, seconds


def _plain_ms(run):
    return [run['iteration_ms'][it]
            for it in range(DATA_CRITIC_INIT, PARALLEL_LAST_ITER + 1)]


def _world_numbers(one, ranks, world, backend):
    """What the ``parallel`` and ``world`` lines report of a world-1 run
    and a world's ranks."""
    key = 'world_%d_%s' % (world, backend)
    return {
        'config': PARALLEL_CONFIG,
        'plain_iteration_ms': {
            'world_1_%s' % PARALLEL_ONE_BACKEND: _median(_plain_ms(one)),
            key: _median([_median(_plain_ms(r)) for r in ranks])},
        'plain_iteration_ms_all': {'world_1': _plain_ms(one),
                                   key + '_by_rank': [_plain_ms(r)
                                                      for r in ranks]},
        'allreduce_ms': {'world_1': one['allreduce_ms'],
                         key: [r['allreduce_ms'] for r in ranks]},
        'allreduce_bytes': ranks[0]['allreduce_bytes'],
        'peak_memory_gib': {'world_1': one['peak_memory_gib'],
                            key + '_by_rank': [r['peak_memory_gib']
                                               for r in ranks]},
        # allocated after the trainer's init, the peak after each iteration
        'memory_gib_by_iteration': {
            label: {'init': run['init_memory_gib'],
                    'peak': run['peak_memory_gib_by_iteration']}
            for label, run in (('world_1', one), (key + '_rank_0',
                                                  ranks[0]))},
        'params_equal_iterations': ranks[0]['iterations_compared'],
        'resume_step': ranks[0]['resume_step'],
        'emd_%d' % PARALLEL_LAST_ITER: {
            'world_1': one['metrics'][PARALLEL_LAST_ITER][2],
            key: ranks[0]['metrics'][PARALLEL_LAST_ITER][2]},
    }


def phase_parallel(root, card):
    """Data-parallel training and serving on the card (``parallel/``):

    (a) a world-size-1 ``nccl`` group in this process: ``example``'s
    resident and streaming step at full width under it, bit for bit the
    step without a group (deterministic cuDNN, a control step); then a
    world-1 ``Trainer`` of ``example`` (packs from the FiveK tree in
    ``root``, ``critic_initialization`` cut as ``phase_data`` cuts it):
    iterations 0-6, then (b), then 7-11, so that both worlds' plain
    iterations come in turns on one card;
    (b) two spawned ranks sharing the card over ``gloo`` with CUDA tensors:
    the same run at B=64 as 32 + 32 and pool 128 as 64 + 64, iterations
    0-11, the parameters' digests equal across the ranks after every
    iteration, finite metrics, one ``metrics.jsonl``, a resume bit for bit,
    the all-reduce's ms for each update's bucket, peak memory per rank;
    (c) ``dryrun_multigpu(2)`` on the card: the trained ``synthetic_explore``
    artifact serving [512, 512, 512, 3] u8, K=5, as 256 + 256 through K2,
    K1 and K3, within the JAX bounds of the plain chain and 1 LSB of one
    process's pipeline; its launches by kernel.

    Prints the ``{"parallel": ...}`` line's numbers and returns them."""
    import tempfile
    from exposure_tpu_torch.parallel.dryrun import dryrun_multigpu
    from exposure_tpu_torch.parallel.mesh import data_parallel_mesh
    from exposure_tpu_torch.tools import parallel_check as pc
    from exposure_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()
    _release()
    with tempfile.TemporaryDirectory() as work:
        mesh = data_parallel_mesh(1, backend=PARALLEL_ONE_BACKEND,
                                  device=DEVICE, rank=0,
                                  init_file=os.path.join(work, 'rdv-one'))
        try:
            t0 = time.perf_counter()
            eq = pc.step_equality(mesh, load_config(PARALLEL_CONFIG),
                                  seed=SEED)
            if any(a or b for a, b in eq.values()):
                fail('parallel: the step under a world-size-1 %s group '
                     'differs from the step without one, or the control '
                     'from itself: %s' % (mesh.backend, eq))
            say('parallel: (a) %s\'s resident and streaming step at full '
                'width under a world-size-1 %s group, and without a group '
                'twice (the control; deterministic cuDNN): every state '
                'tensor, the pool and the metrics equal bit for bit, %.1f s'
                % (PARALLEL_CONFIG, mesh.backend, time.perf_counter() - t0))
            one, two, two_s = _worlds_in_turns(root, work, mesh,
                                               PARALLEL_WORLD, 'gloo',
                                               'parallel')
        finally:
            mesh.close()
        numbers = dict(_world_numbers(one, two, PARALLEL_WORLD, 'gloo'),
                       card=card, world_2_s=two_s,
                       one_rank_step_equal={k: not (a or b)
                                            for k, (a, b) in eq.items()})
        batch = load_config(PARALLEL_CONFIG).batch_size
        say('parallel: (b) %s at full width on %d ranks sharing the card '
            'over gloo (B=%d as %d a rank), iterations 0-%d in %.1f s with '
            'the spawn: parameters equal across the ranks after each of '
            '%d iterations, finite metrics, one metrics.jsonl, a resume '
            'from checkpoint %d bit for bit; world 1 (%s, in this process, '
            'iterations 0-6 before and 7-11 after) likewise' % (
                PARALLEL_CONFIG, PARALLEL_WORLD, batch,
                batch // PARALLEL_WORLD, PARALLEL_LAST_ITER, two_s,
                numbers['params_equal_iterations'], numbers['resume_step'],
                PARALLEL_ONE_BACKEND))
        say('parallel: ms per plain iteration (iters_per_dispatch 1, CUDA '
            'events, medians of iterations %d-%d), all-reduce ms and bytes '
            'a bucket, peak memory GiB: %s' % (
                DATA_CRITIC_INIT, PARALLEL_LAST_ITER,
                json.dumps({k: numbers[k] for k in (
                    'plain_iteration_ms', 'allreduce_ms', 'allreduce_bytes',
                    'peak_memory_gib')})))
        t0 = time.perf_counter()
        _release()
        dry = dryrun_multigpu(
            PARALLEL_WORLD, device=DEVICE, backend='gloo',
            serve_batch=BATCH, serve_hw=(RES, RES),
            artifact=os.path.join(REPO, ARTIFACT), deadline_s=
            PARALLEL_DEADLINE_S, work_dir=work)
    numbers['dryrun'] = {k: dry[k] for k in (
        'g_loss', 'emd', 'streaming_g_loss', 'served', 'grouped_max_lsb',
        'resume_equal', 'pad_ok', 'superset_ok', 'superset_max_lsb',
        'map_batches_ok', 'dyn_ok', 'dyn_max_lsb', 'pipeline_max_lsb',
        'superset_route', 'launches', 'launches_by_rank')}
    numbers['dryrun_s'] = time.perf_counter() - t0
    numbers['launches'] = dry['launches']
    if DEVICE == 'cuda' and any(v == 0 for v in dry['launches'].values()):
        fail('parallel: the dry run\'s serving launched %s'
             % dry['launches'])
    say('parallel: (c) dryrun_multigpu(%d) on the card, %.1f s: served %s '
        'u8 as %d + %d; max LSB against the plain chain: dynamic %d, '
        'grouped %d, superset %d (bound 2); the gathered output against '
        'one process\'s pipeline %d (bound 1); launches %s' % (
            PARALLEL_WORLD, numbers['dryrun_s'], dry['served'],
            BATCH // PARALLEL_WORLD, BATCH // PARALLEL_WORLD,
            dry['dyn_max_lsb'], dry['grouped_max_lsb'],
            dry['superset_max_lsb'], dry['pipeline_max_lsb'],
            json.dumps(dry['launches'])))
    numbers['phase_s'] = time.perf_counter() - t_phase
    say('parallel: phase %.1f s (budget %d s)' % (numbers['phase_s'],
                                                  PARALLEL_BUDGET_S))
    return numbers


FUSED_BUDGET_S = 120
FUSED_CONFIG = 'example'
FUSED_CHUNK = 10            # iters_per_dispatch: chunks 2-11 and 12-21
FUSED_LAST_ITER = 21        # iterations 0-21, as phase_data's
FUSED_CKPT_INTERVAL = 12    # a checkpoint at 12, the chunks' boundary
FUSED_SERVE_ITER = 23       # the fused trainer goes on through 22-23: a
                            # checkpoint at 24, which from_run serves
FUSED_TURNS = ('plain', 'fused', 'fused', 'plain') * 2


def _fused_cfg(stream_dtype=None, paths=None):
    """``example`` as the fused phase trains it: ``critic_initialization``
    cut as ``phase_data`` cuts it, a checkpoint every
    ``FUSED_CKPT_INTERVAL``, chunks of ``FUSED_CHUNK``; streaming from the
    packs ``paths`` in ``stream_dtype`` when it is given."""
    from exposure_tpu_torch.data.native_provider import NativePackProvider
    from exposure_tpu_torch.utils.config import load_config
    cfg = load_config(FUSED_CONFIG)
    cfg.update(critic_initialization=DATA_CRITIC_INIT,
               checkpoint_interval=FUSED_CKPT_INTERVAL,
               iters_per_dispatch=FUSED_CHUNK, dispatch_pipeline_depth=2,
               stream_iters_per_dispatch=FUSED_CHUNK)
    cfg.name = '%s/fused_%s' % (FUSED_CONFIG, stream_dtype or 'resident')
    if stream_dtype:
        cfg.update(stream_data=True, stream_dtype=stream_dtype)
        cfg.fake_data_provider = lambda: NativePackProvider(
            paths[0], output_size=64, augmentation=0.3, seed=SEED)
        cfg.real_data_provider = lambda: NativePackProvider(
            paths[1], output_size=64, augmentation=1.0, seed=SEED + 1)
    return cfg


class _Rows:
    """Every iteration's metrics a trainer's bookkeeping reads (floats),
    and the state and pool of the records it processes, by the record's
    last iteration."""

    def __init__(self, trainer):
        self.metrics, self.records = {}, {}
        record, chunk = trainer._process_record, trainer._process_chunk

        def kept(it, citers, metrics, books):
            self.metrics[it] = [float(v) for v in metrics]
            return record(it, citers, metrics, books)

        def chunk_kept(rec, books):
            self.records[rec.it0 + rec.chunk - 1] = (rec.state, rec.pool)
            return chunk(rec, books)
        trainer._process_record = kept
        trainer._process_chunk = chunk_kept


def _reset(trainer, snap, n_fuse, depth):
    """``trainer`` back at the snapshot ``(state, pool)``, dispatching
    ``n_fuse`` iterations a chunk with its bookkeeping ``depth`` behind; a
    streaming trainer's producer restarts on fresh providers, so that every
    run from the snapshot trains on the same bundles."""
    from exposure_tpu_torch.core.fused import clone_pool
    trainer.state, trainer.pool = snap[0].clone(), clone_pool(snap[1])
    trainer.n_fuse, trainer.depth = n_fuse, depth
    if trainer.streaming:
        trainer._close_stream()
        for name in ('fake_provider', 'real_provider'):
            getattr(trainer, name).close()
        trainer.fake_provider = trainer.cfg.fake_data_provider()
        trainer.real_provider = trainer.cfg.real_data_provider()


def _outcome(trainer, rows, first, last):
    """``(state, pool, metrics)`` of ``trainer`` after iterations
    ``first .. last``, cloned."""
    import torch
    from exposure_tpu_torch.core.fused import clone_pool
    return (trainer.state.clone(), clone_pool(trainer.pool),
            torch.tensor([rows.metrics[it] for it in range(first, last + 1)]))


def _differing(a, b):
    """What differs between two ``(state, pool, metrics)``: tensor paths,
    ``counts`` (Adam's, the EMA's, the step), ``pool``, ``metrics``."""
    import torch
    ta, tb = a[0].tensors(), b[0].tensors()
    out = [k for k in tb if not torch.equal(ta[k], tb[k])]

    def counts(st):
        return (st.opt_g.count, st.opt_v.count, st.opt_c.count, st.ema.count,
                st.step)
    if counts(a[0]) != counts(b[0]):
        out.append('counts')
    if not (torch.equal(a[1].images, b[1].images) and
            torch.equal(a[1].states, b[1].states)):
        out.append('pool')
    if not torch.equal(a[2], b[2]):
        out.append('metrics')
    return out


def _dispatch(trainer, kind, first, n):
    """Iterations ``first .. first + n - 1`` as one fused chunk or as ``n``
    plain iterations (the trainer's dispatch alone, no bookkeeping)."""
    if kind == 'fused':
        trainer._run_fused(first, n)
        return
    for it in range(first, first + n):
        trainer.run_iteration(it, trainer._generator)


def _fused_turns(trainer, snap):
    """ms per plain iteration of ``FUSED_CHUNK`` iterations from the
    snapshot, fused and plain in turns (``FUSED_TURNS``): CUDA events
    around the dispatch, and the host clock to its end; each turn from the
    same state and pool."""
    import torch
    first = DATA_CRITIC_INIT
    out = {'fused': [], 'plain': [], 'fused_wall': [], 'plain_wall': []}
    for kind in FUSED_TURNS:
        _reset(trainer, snap, FUSED_CHUNK, 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        _dispatch(trainer, kind, first, FUSED_CHUNK)
        end.record()
        end.synchronize()
        out[kind + '_wall'].append(1e3 * (time.perf_counter() - t0) /
                                   FUSED_CHUNK)
        out[kind].append(start.elapsed_time(end) / FUSED_CHUNK)
    return out


def _fused_syncs(trainer, snap, kind):
    """The host synchronisations the sync debug mode flags in
    ``FUSED_CHUNK`` iterations dispatched ``kind`` (the bookkeeping's
    metric read is not in it), with where they were."""
    import torch
    _reset(trainer, snap, FUSED_CHUNK, 0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            _dispatch(trainer, kind, DATA_CRITIC_INIT, FUSED_CHUNK)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sorted('%s:%d' % (os.path.relpath(w.filename, REPO), w.lineno)
                  for w in flagged if 'synchroniz' in str(w.message))


def _fused_profile(trainer, snap, kind):
    """``FUSED_CHUNK`` iterations dispatched ``kind`` under
    ``torch.profiler`` (``tools.profile_calls``): per plain iteration the
    device's kernels, the host's launch calls and the device-busy ms, and
    the idle share of the wall."""
    from exposure_tpu_torch.tools import profile_calls
    _reset(trainer, snap, FUSED_CHUNK, 0)
    return profile_calls(
        lambda: _dispatch(trainer, kind, DATA_CRITIC_INIT, FUSED_CHUNK),
        FUSED_CHUNK, DEVICE)


def _fused_runs(trainer, snap, numbers, tag):
    """From the snapshot after the special iterations, under deterministic
    cuDNN: ``FUSED_CHUNK``-iteration chunks through iteration
    ``FUSED_LAST_ITER`` fused (bookkeeping 2 behind), and twice plain
    (bookkeeping at once; the second the control).  Fails unless all three
    agree bit for bit.  Returns the fused run's outcome."""
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    rows = _Rows(trainer)
    outs = {}
    with deterministic_algorithms():
        for run, n_fuse, depth in (('plain', 1, 0), ('control', 1, 0),
                                   ('fused', FUSED_CHUNK, 2)):
            _reset(trainer, snap, n_fuse, depth)
            rows.metrics.clear()
            trainer.train(last_iter=FUSED_LAST_ITER)
            outs[run] = _outcome(trainer, rows, DATA_CRITIC_INIT,
                                 FUSED_LAST_ITER)
    fused, control = (_differing(outs[k], outs['plain'])
                      for k in ('fused', 'control'))
    runner = trainer._runner(trainer.cfg.giters, trainer.cfg.citers)
    if fused or control or runner.captures != int(runner.graphs):
        fail('fused: %s: the fused run against the plain one: %d differ '
             '(%s); the plain run against itself, the control: %d differ '
             '(%s); graphs captured %d' % (tag, len(fused), fused[:3],
                                           len(control), control[:3],
                                           runner.captures))
    numbers[tag] = {'tensors_equal': len(outs['plain'][0].tensors()),
                    'iterations': [DATA_CRITIC_INIT, FUSED_LAST_ITER],
                    'replays': runner.replays}
    return outs['fused'], rows


def phase_fused(root):
    """The fused N-iteration dispatch (``core/fused.py``) on the card, in
    the FiveK tree ``phase_data`` made in ``root``: ``example`` at full
    width, chunks of 10 (iterations 2-11 and 12-21), resident and streaming
    (u8); the fused run against the plain one and a control bit for bit;
    ms per plain iteration fused and plain in turns, launches, idle share,
    peak memory; a resume from the pipelined checkpoint; a world-size-1
    ``nccl`` group against none; the fused-trained policy served through
    K1.  Returns what the summary line reports of it."""
    import contextlib
    import random
    import tempfile
    import torch
    from exposure_tpu_torch.core.trainer import Trainer
    from exposure_tpu_torch.data.fivek import FiveKDataProvider
    from exposure_tpu_torch.parallel.mesh import data_parallel_mesh
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    t_phase = time.perf_counter()
    _release()
    numbers = {'config': FUSED_CONFIG, 'chunk': FUSED_CHUNK}
    paths = (os.path.join(root, 'data', 'fivek_dataset',
                          'sup_batched80aug_daylight', 'image_raw.npy'),
             os.path.join(root, 'target.npy'))
    with tempfile.TemporaryDirectory() as work, contextlib.chdir(root):
        models = os.path.join(work, 'models')
        FiveKDataProvider._raw_image_pack = None
        cfg = _fused_cfg()
        random.seed(SEED)       # the providers draw from ``random``
        trainer = Trainer(cfg, model_root=models, device=DEVICE)
        try:
            trainer.train(last_iter=DATA_CRITIC_INIT - 1)   # the specials
            snap = (trainer.state.clone(), trainer.pool)
            # (b) speed, in the training's own (default) algorithms
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset(trainer, snap, FUSED_CHUNK, 0)
            t0 = time.perf_counter()
            _dispatch(trainer, 'fused', DATA_CRITIC_INIT, FUSED_CHUNK)
            torch.cuda.synchronize()
            numbers['first_chunk_s'] = time.perf_counter() - t0
            numbers['peak_memory_gib'] = {
                'fused_above_trainer': (torch.cuda.max_memory_allocated() -
                                        base) / 2 ** 30,
                'reserved': torch.cuda.memory_reserved() / 2 ** 30}
            turns = _fused_turns(trainer, snap)
            numbers['turns'] = {'order': FUSED_TURNS, **turns}
            numbers['ms_per_plain_iteration'] = {
                k: _median(turns[k]) for k in ('fused', 'plain')}
            numbers['wall_ms_per_plain_iteration'] = {
                k: _median(turns[k + '_wall']) for k in ('fused', 'plain')}
            numbers['profile'] = {k: _fused_profile(trainer, snap, k)
                                  for k in ('plain', 'fused')}
            syncs = {k: _fused_syncs(trainer, snap, k)
                     for k in ('plain', 'fused')}
            if any(syncs.values()):
                fail('fused: host syncs in the dispatch of %d iterations: %s'
                     % (FUSED_CHUNK, syncs))
            numbers['host_syncs'] = {k: len(v) for k, v in syncs.items()}
            torch.cuda.reset_peak_memory_stats()
            _reset(trainer, snap, 1, 0)
            _dispatch(trainer, 'plain', DATA_CRITIC_INIT, FUSED_CHUNK)
            torch.cuda.synchronize()
            numbers['peak_memory_gib']['plain_above_trainer'] = (
                torch.cuda.max_memory_allocated() - base) / 2 ** 30
            say('fused: ms per plain iteration, %d iterations a turn in '
                'turns %s (CUDA events, medians): fused %.4f, plain %.4f; '
                'host clock fused %.4f, plain %.4f; first chunk with the '
                'warm-up and capture %.2f s; peak memory GiB %s' % (
                    FUSED_CHUNK, '/'.join(FUSED_TURNS),
                    numbers['ms_per_plain_iteration']['fused'],
                    numbers['ms_per_plain_iteration']['plain'],
                    numbers['wall_ms_per_plain_iteration']['fused'],
                    numbers['wall_ms_per_plain_iteration']['plain'],
                    numbers['first_chunk_s'],
                    json.dumps(numbers['peak_memory_gib'])))
            say('fused: under torch.profiler, per plain iteration: %s; '
                'host syncs the sync debug mode flags in the dispatch of %d '
                'iterations: %s' % (json.dumps(numbers['profile']),
                                    FUSED_CHUNK,
                                    json.dumps(numbers['host_syncs'])))
            # (a) bit for bit, with a graph captured under deterministic
            # cuDNN
            trainer._steps = {k: v for k, v in trainer._steps.items()
                              if k[0] != 'fused'}
            fused, rows = _fused_runs(trainer, snap, numbers, 'resident')
            # (c) the checkpoint the pipelined fused run wrote at 12 (its
            # record processed after chunk 12-21 ran on the buffers)
            at12 = rows.records[FUSED_CKPT_INTERVAL - 1]
            random.seed(SEED)   # the same packs, row for row
            again = Trainer(cfg, restore=True, model_root=models,
                            device=DEVICE)
            try:
                step = again.restore()
                restored = _differing((again.state, at12[1], fused[2]),
                                      (at12[0], at12[1], fused[2]))
                again.pool = at12[1]
                again_rows = _Rows(again)
                with deterministic_algorithms():
                    again.train(last_iter=FUSED_LAST_ITER)
                resumed = _differing(_outcome(
                    again, again_rows, FUSED_CKPT_INTERVAL, FUSED_LAST_ITER),
                    (fused[0], fused[1],
                     fused[2][FUSED_CKPT_INTERVAL - DATA_CRITIC_INIT:]))
            finally:
                again.close()
            if step != FUSED_CKPT_INTERVAL or restored or resumed:
                fail('fused: resume: checkpoint %d restored, %d differ from '
                     'the pipelined record (%s); resumed at it, %d differ '
                     'from the run not stopped (%s)' % (
                         step, len(restored), restored[:3], len(resumed),
                         resumed[:3]))
            numbers['resume'] = {'checkpoint': step,
                                 'tensors_equal': len(at12[0].tensors())}
            # (d) the captured all-reduce of a world-size-1 nccl group
            mesh = data_parallel_mesh(1, backend=PARALLEL_ONE_BACKEND,
                                      device=DEVICE, rank=0,
                                      init_file=os.path.join(work, 'rdv'))
            try:
                random.seed(SEED)
                grouped = Trainer(cfg.copy(), num_devices=1,
                                  model_root=os.path.join(work, 'nccl'),
                                  device=DEVICE)
                try:
                    grouped_rows = _Rows(grouped)
                    _reset(grouped, snap, FUSED_CHUNK, 2)
                    with deterministic_algorithms():
                        grouped.train(last_iter=FUSED_LAST_ITER)
                    nccl = _differing(_outcome(
                        grouped, grouped_rows, DATA_CRITIC_INIT,
                        FUSED_LAST_ITER), fused)
                    backend = grouped.mesh.backend
                finally:
                    grouped.close()
            finally:
                mesh.close()
            if nccl or backend != PARALLEL_ONE_BACKEND:
                fail('fused: under a world-size-1 %s group %d differ from '
                     'the run without a group (%s)' % (backend, len(nccl),
                                                       nccl[:3]))
            numbers['nccl_world_1_equal'] = True
            # the fused-trained policy, through a checkpoint at 24
            trainer.n_fuse, trainer.depth = FUSED_CHUNK, 2
            trainer.train(last_iter=FUSED_SERVE_ITER)
            numbers['launches_serve'] = _serve_trained(
                trainer.cfg, models, trainer, 'fused')
        finally:
            trainer.close()
        FiveKDataProvider._raw_image_pack = None
        # streaming, u8 bundles, from the resident trainer's snapshot (the
        # same networks and pool sizes; the special iterations not again)
        random.seed(SEED)
        stream = Trainer(_fused_cfg('uint8', paths), model_root=models,
                         device=DEVICE)
        try:
            _fused_runs(stream, snap, numbers, 'stream_uint8')
        finally:
            stream.close()
    numbers['phase_s'] = time.perf_counter() - t_phase
    say('fused: %s at full width, chunks of %d (iterations %d-%d), '
        'resident and streaming u8: the fused run (bookkeeping 2 chunks '
        'behind), the plain run and its control (bookkeeping at once) equal '
        'bit for bit, %d state tensors, the pool and every metric '
        '(deterministic cuDNN); checkpoint %d written from the pipelined '
        'record restored bit for bit, and the run resumed there equal to '
        'the one not stopped; a world-size-1 nccl group equal to none' % (
            FUSED_CONFIG, FUSED_CHUNK, DATA_CRITIC_INIT, FUSED_LAST_ITER,
            numbers['resident']['tensors_equal'], FUSED_CKPT_INTERVAL))
    say('fused: phase %.1f s (budget %d s)' % (numbers['phase_s'],
                                               FUSED_BUDGET_S))
    return numbers


def world(n):
    """``--world N``, on a machine of N cards: ``example``'s training on N
    ``nccl`` ranks, one a card, against a world-size-1 ``nccl`` run on card
    0 in turns (``_worlds_in_turns``), in the FiveK tree of ``phase_data``
    made anew in a temp dir.  Prints the ``{"world": ...}`` line and the
    device line."""
    import contextlib
    import tempfile
    import torch
    card = phase_card()
    sys.path.insert(0, REPO)
    from exposure_tpu_torch.parallel.mesh import data_parallel_mesh
    if torch.cuda.device_count() < n:
        fail('world: %d cards asked for, %d here'
             % (n, torch.cuda.device_count()))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as work:
        with contextlib.chdir(root):
            _fivek_tree(root)
        mesh = data_parallel_mesh(1, backend='nccl', device='cuda:0', rank=0,
                                  init_file=os.path.join(work, 'rdv-one'))
        try:
            one, ranks, seconds = _worlds_in_turns(root, work, mesh, n,
                                                   'nccl', 'world')
        finally:
            mesh.close()
    numbers = dict(_world_numbers(one, ranks, n, 'nccl'), card=card,
                   world_s=seconds, phase_s=time.perf_counter() - t0)
    say('world: %s at full width on %d nccl ranks, one a card: parameters '
        'equal across the ranks after each of %d iterations, finite '
        'metrics, one metrics.jsonl, a resume from checkpoint %d bit for '
        'bit; world 1 likewise, in turns' % (
            PARALLEL_CONFIG, n, numbers['params_equal_iterations'],
            numbers['resume_step']))
    say(json.dumps({'world': numbers}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def main():
    import tempfile
    import numpy as np
    import torch
    t_start = time.perf_counter()
    card = phase_card()
    sys.path.insert(0, REPO)
    variants = phase_build()
    packed = phase_bf16_ops()
    k1_worst, k1_timing, k1_errors = phase_k1()
    k2_worst, k2_timing = phase_k2()
    k3_worst, k3_timing = phase_k3()
    probe_worst = phase_probes()
    probe_counts, probe_timing, tool_worst, floor_gb_s, copies = \
        phase_probe_tools()
    for key, v in tool_worst.items():   # the largest over both phases
        probe_worst[key] = max(probe_worst[key], v)
    tool_counts, _ = phase_tools()
    phase_small_reference()
    evaluation = phase_evaluate()
    training = phase_train()
    with tempfile.TemporaryDirectory() as fivek_root:
        data = phase_data(fivek_root)
        parallel = phase_parallel(fivek_root, card)
        fused = phase_fused(fivek_root)
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(_images(rng, BATCH, RES, RES)).to(DEVICE)
               for _ in range(MAIN_BATCHES)]
    torch.cuda.synchronize()
    k1_main, _, _ = phase_main_path(batches)
    totals, _ = phase_modes(batches)
    phase_planted(batches[0])
    phase_bf16_plan(batches)
    say('total %.1f s' % (time.perf_counter() - t_start))
    shape = '[%d, %d, %d, 3] u8, K=5' % (BATCH, RES, RES)
    for name in totals:     # the paths: main, modes, probe tools, tools
        totals[name] += probe_counts[name] + tool_counts[name]

    def ptxas(lib, kernel):
        """The worst registers, stack frame and spills over the variants."""
        rows = [p for v, p in variants[lib].items() if v.startswith(kernel)]
        return {k: max(p[k] for p in rows) for k in rows[0]}

    def chain_entry(name, source, replaces, timed, worst, launches, lib,
                    kernel, **extra):
        ms, plain, bound = timed
        return dict({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches,
            'max_abs_err': worst['f32'], 'max_lsb_u8': worst['u8'],
            'ms': ms, 'plain_ms': plain, 'bound_ms': bound['bound_ms'],
            'bound_by': bound['bound_by'], 'flops': bound['flops'],
            'bytes': bound['bytes'], 'library_ms': None,
            'ptxas_worst_variant': ptxas(lib, kernel), 'shape': shape,
            'card': card}, **extra)

    def probe_entry(name, replaces, max_lsb, shape, **extra):
        rows = probe_timing[name]
        library = {k: v[3] for k, v in rows.items() if v[3] is not None}
        return dict({
            'name': name, 'route': 'cuda',
            'source': 'exposure_tpu_torch/csrc/probes.cu',
            'replaces': replaces, 'launches': totals[name],
            'max_abs_err': max_lsb / 255.0, 'max_lsb_u8': max_lsb,
            # the sums over the timed cases; each case's numbers below
            'ms': sum(v[0] for v in rows.values()),
            'plain_ms': sum(v[1] for v in rows.values()),
            'bound_ms': sum(v[2]['bound_ms'] for v in rows.values()),
            # the kind that sets most of the summed bound
            'bound_by': max(('bytes', 'operations'), key=lambda by: sum(
                v[2]['bound_ms'] for v in rows.values()
                if v[2]['bound_by'] == by)),
            # Tensor.copy_ on the 0-step copy's buffers: the one case that
            # a PyTorch call computes
            'library_ms': sum(library.values()) if library else None,
            # every timed case with its own numbers: a case of library
            # calls (the bound counts a call as one operation) is not to be
            # read as a slow kernel
            'cases': {k: {'ms': v[0], 'plain_ms': v[1],
                          'bound_ms': v[2]['bound_ms'],
                          'bound_by': v[2]['bound_by'], 'library_ms': v[3]}
                      for k, v in rows.items()},
            'shape': shape, 'card': card}, **extra)

    say(json.dumps({'data': {
        'card': card, 'host_loader_build_s': data['build_s'],
        'fivek_tree_s': data['tree'],
        'provider_load_s': data['provider_load_s'],
        'device_pack_bytes': data['device_pack_bytes'],
        'assembly': data['loader'], 'resident': data['resident'],
        'stream': data['stream'],
        'u8_step_tensors_equal': data['u8_step_tensors_equal'],
        'launches_serve': data['launches_serve'],
        'phase_s': data['phase_s']}}))
    say(json.dumps({'parallel': parallel}))
    say(json.dumps({'fused': dict(fused, card=card)}))
    served = parallel['launches']
    proxy = PROXY_CASE[0]
    say(json.dumps({'kernels': [
        # the main path's replay launches, with the modes' and the tools';
        # its proxy launches are the next row's
        chain_entry('dyn_chain', 'exposure_tpu_torch/csrc/dyn_chain.cu',
                    'exposure_tpu/ops/pallas_chain.py:479',
                    k1_timing[REPLAY_CASE[0]], k1_worst,
                    k1_main['replay'] + totals['dyn_chain'] +
                    evaluation['launches'] + training['launches_serve'] +
                    data['launches_serve'] + served['dyn_chain'] +
                    fused['launches_serve'],
                    'dyn_chain', 'dyn_chain_kernel',
                    launches_main_path_replay=k1_main['replay'],
                    launches_other_paths=totals['dyn_chain'],
                    launches_evaluation=evaluation['launches'],
                    launches_training_serve=training['launches_serve'],
                    launches_streaming_serve=data['launches_serve'],
                    launches_parallel_serve=served['dyn_chain'],
                    launches_fused_serve=fused['launches_serve']),
        # the same kernel on one full-resolution image, the evaluator's
        # replay: every launch of the evaluation path (its sizes vary; the
        # time is this shape's)
        chain_entry('dyn_chain_evaluate',
                    'exposure_tpu_torch/csrc/dyn_chain.cu',
                    'exposure_tpu/ops/pallas_chain.py:479',
                    evaluation['timed'], evaluation['worst'],
                    evaluation['launches'], 'dyn_chain', 'dyn_chain_kernel',
                    shape='[1, %d, %d, 3] f32, K=5, exact set' % (RES, RES),
                    eval_ms_per_image=evaluation['per_image_ms'],
                    png_ms_512={'read': evaluation['png_read_ms'],
                                'write': evaluation['png_write_ms']},
                    quality_report=evaluation['quality']),
        # the same kernel on the plan's proxy: 5 of its 6 launches a batch,
        # counted by stage on the main path; its error is its own case's
        chain_entry('dyn_chain_proxy', 'exposure_tpu_torch/csrc/dyn_chain.cu',
                    'exposure_tpu/ops/pallas_chain.py:479',
                    k1_timing[proxy], {'f32': k1_errors[proxy], 'u8': None},
                    k1_main['proxy'], 'dyn_chain', 'dyn_chain_kernel',
                    shape='[%d, 64, 64, 3] f32, K=1' % BATCH),
        chain_entry('switch_chain', 'exposure_tpu_torch/csrc/switch_chain.cu',
                    'exposure_tpu/ops/pallas_chain.py:345',
                    k2_timing['f32'], k2_worst,
                    totals['switch_chain'] + served['switch_chain'],
                    'switch_chain', 'switch_chain_f32',
                    launches_parallel_serve=served['switch_chain']),
        # the same wrapper's bf16 kernel; nothing in the package asks for
        # it (direct callers only), so no path launches it
        chain_entry('switch_chain_bf16',
                    'exposure_tpu_torch/csrc/switch_chain.cu',
                    'exposure_tpu/ops/pallas_chain.py:345',
                    k2_timing['bf16'],
                    {'f32': k2_worst['bf16_vs_plain_f32'],
                     'u8': k2_worst['bf16_vs_plain_u8']},
                    totals['switch_chain_bf16'], 'switch_chain',
                    'switch_chain_bf16',
                    frac_off_plain=k2_worst['bf16_vs_plain_frac'],
                    max_lsb_vs_f32_jax_case=k2_worst['bf16_vs_f32_lsb'],
                    packed_ops_differing={
                        op: c['differ'] for op, c in packed.items()}),
        chain_entry('static_chain', 'exposure_tpu_torch/csrc/static_chain.cu',
                    'exposure_tpu/ops/pallas_chain.py:417',
                    k3_timing['replay'], k3_worst,
                    totals['static_chain'] + served['static_chain'],
                    'static_chain', 'static_chain_kernel',
                    shape=shape + ', one signature (E, G, S+, T, Ct)',
                    launches_parallel_serve=served['static_chain']),
        probe_entry('mono_probe',
                    'exposure_tpu/tools/bench_kernel_probe.py:41',
                    probe_worst['mono_probe'],
                    '[%d, %d, %d, 3] u8' % (PROBE_BATCH, RES, RES),
                    u8_round_trip_gb_s=floor_gb_s,
                    copy_against_copy_=copies['mono_probe']),
        probe_entry('fastmath_probe',
                    'exposure_tpu/tools/bench_fastmath.py:117',
                    probe_worst['fastmath_probe'],
                    '[%d, 3, %d, %d] u8, 5 steps' % (PROBE_BATCH, RES, RES)),
        probe_entry('bf16_probe',
                    'exposure_tpu/tools/bench_bf16_probe.py:57',
                    probe_worst['bf16_probe'],
                    '[%d, 1, %d, %d] u8, %d steps' % (
                        BF16_PROBE_BATCH, RES, RES, BF16_PROBE_STEPS),
                    bf16_max_lsb=probe_worst['bf16_probe_bf16_lsb'],
                    bf16_frac_off_plain=probe_worst['bf16_probe_frac_off']),
    ]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _branch_outputs(dev, run=None, prefix=''):
    """One step of each filter of the ``synthetic_explore`` and the
    ``masked`` banks, exact and fast, f32 and u8, on seeded [16, 256, 256,
    3] images, through ``run(img, ids, params, filters, **kw)`` (K1 by
    default): the kernels' math branch by branch, with and without the mask
    blend, ``{name: numpy array}``."""
    import torch
    from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
    run = run or apply_filter_chain_dynamic
    g = torch.Generator().manual_seed(SEED + 11)
    b = 16
    x = torch.rand((b, 256, 256, 3), generator=g) * 1.05
    imgs = {'f32': x.to(dev),
            'u8': (x * 255).round().clamp(0, 255).to(torch.uint8).to(dev)}
    out = {}
    for bank, filters in _banks().items():
        masked = filters[0].use_masking()
        for fid, f in enumerate(filters):
            ids, params = _trajectory(g, filters, 1, b, dev,
                                      ids=torch.full((1, b), fid,
                                                     dtype=torch.int32))
            kw = {}
            if masked:
                kw['mask_params'] = torch.randn((1, b, 6), generator=g).to(
                    dev)
            for fast in (False, True):
                for dt, img in imgs.items():
                    y = run(img, ids, params, filters, fast_math=fast, **kw)
                    out['%s%s%s_%s_%s' % (prefix,
                                          'masked_' if masked else '',
                                          f.get_short_name(),
                                          'fast' if fast else 'exact', dt)] = \
                        y.cpu().numpy()
    return out


def _switch_bf16(img, ids, params, filters, **kw):
    import torch
    from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
    return apply_filter_chain_switch(img, ids, params, filters,
                                     compute_dtype=torch.bfloat16, **kw)


TURN_PROBE_SIZES = dict(PROBE_SIZES, mid=(8, 256, 256))


def _kernel_outputs(dev):
    """What ``--turns`` compares between two trees beside the served
    outputs, ``{name: numpy array}``: one step of each branch of both banks
    through K1 and through K2 in bf16 (``_branch_outputs``), K2 in f32 and
    in bf16 on every case of ``phase_k2``, and every probe case (K4a's ops x
    0, 1 and 5 steps, K4b's ops, K4c's ops x styles) on a small, an odd and
    a middle size."""
    import numpy as np
    import torch
    from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
    from exposure_tpu_torch.tools import bench_bf16_probe as k4c
    from exposure_tpu_torch.tools import bench_fastmath as k4b
    from exposure_tpu_torch.tools import bench_kernel_probe as k4a
    out = _branch_outputs(dev)
    out.update(_branch_outputs(dev, _switch_bf16, 'k2bf16_'))
    for case, filters, img, ids, params, kw in _k2_cases(dev):
        for cdt, tag in ((torch.float32, 'k2f32'), (torch.bfloat16, 'k2bf16')):
            ck = dict(kw, compute_dtype=cdt)
            if case[8] == 'rows':
                ck['out'] = torch.zeros_like(img)
            out['%s_case_%s' % (tag, case[0])] = apply_filter_chain_switch(
                img, ids, params, filters, **ck).cpu().numpy()
    rng = np.random.RandomState(SEED + 4)
    for size, (b, h, w) in TURN_PROBE_SIZES.items():
        def u8(*shape):
            return torch.from_numpy((rng.rand(*shape) * 255).astype(
                np.uint8)).to(dev)
        nhwc, planar, mono = u8(b, h, w, 3), u8(b, 3, h, w), u8(b, 1, h, w)
        for op in k4a.MONO_OPS:
            for steps in (0, 1, 5):
                out['k4a_%s_%s%d' % (size, op, steps)] = k4a.mono_chain(
                    nhwc, steps, op).cpu().numpy()
        for op in k4b.OPS:
            out['k4b_%s_%s' % (size, op)] = k4b.run_op(planar,
                                                       op).cpu().numpy()
        for op in k4c.OPS:
            for style in k4c.STYLES:
                out['k4c_%s_%s_%s' % (size, op, style)] = k4c.run_probe(
                    mono, k4c.PARAMS, op, style,
                    BF16_PROBE_STEPS).cpu().numpy()
    return out


def _kernel_times(dev):
    """ms of each chain kernel at [512, 512, 512, 3] u8 K=5 (``phase_k2``'s
    timed inputs; K3 on the served signature) and of every probe case at the
    tools' shapes, 4 calls back to back a timing: ``{name: ms}`` of the tree
    this process imports."""
    import torch
    from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
    from exposure_tpu_torch.ops.static_chain import apply_filter_chain_static
    from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
    from exposure_tpu_torch.tools import bench_bf16_probe as k4c
    from exposure_tpu_torch.tools import bench_fastmath as k4b
    from exposure_tpu_torch.tools import bench_kernel_probe as k4a
    ms = {}
    for case, filters, img, ids, params, kw in _k2_cases(dev):
        if case[8] != 'timed':
            continue
        sig = _signature_of(filters, SERVED_SIGNATURE)
        runs = {
            'K1': lambda: apply_filter_chain_dynamic(img, ids, params,
                                                     filters, **kw),
            'K2_f32': lambda: apply_filter_chain_switch(img, ids, params,
                                                        filters, **kw),
            'K2_bf16': lambda: _switch_bf16(img, ids, params, filters, **kw),
            'K3': lambda: apply_filter_chain_static(img, sig, params,
                                                    filters, **kw)}
        for name, fn in runs.items():
            ms[name] = cuda_ms(fn, calls=KERNEL_CALLS)
    img = k4a.make_input(PROBE_BATCH, RES).to(dev)
    for key, steps, op in k4a.SECTION_A:
        ms['K4a_' + key] = cuda_ms(lambda: k4a.mono_chain(img, steps, op),
                                   calls=KERNEL_CALLS)
    out = torch.empty_like(img)
    ms['Tensor.copy_'] = cuda_ms(lambda: out.copy_(img), calls=KERNEL_CALLS)
    del out
    img = k4b.make_input(PROBE_BATCH, RES).to(dev)
    for op in k4b.OPS:
        ms['K4b_' + op] = cuda_ms(lambda: k4b.run_op(img, op),
                                  calls=KERNEL_CALLS)
    img = k4c.make_input(BF16_PROBE_BATCH, RES).to(dev)
    for op in k4c.OPS:
        for style in k4c.STYLES:
            ms['K4c_%s/%s' % (op, style)] = cuda_ms(
                lambda: k4c.run_probe(img, k4c.PARAMS, op, style,
                                      BF16_PROBE_STEPS), calls=KERNEL_CALLS)
    return ms


def serve(tree, work, tag, first, kernels_only):
    """``--serve TREE WORK TAG [--first] [--kernels]``: the main path and
    the five modes with the package of the checkout ``TREE`` (its kernels
    built from its own sources), that tree's replay of one fixed plan
    (batch 0's, planned by the first turn and kept in ``WORK``) and its
    kernels' times (``_kernel_times``).  A tree's first turn saves its
    main-path outputs, fixed-plan replay and kernel outputs
    (``_kernel_outputs``) in ``WORK``.  ``--kernels`` leaves the served
    path out.  The last line is ``{"tree", "kernel_ms", "main_img_s",
    "modes": {mode: img/s}, "main_digest", "replay_digest"}``."""
    import numpy as np
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    from exposure_tpu_torch.core.serving import batch_generator
    phase_card()
    phase_build()
    dev = torch.device(DEVICE)
    result = {'tree': tree}
    if first:
        np.savez(os.path.join(work, tag + '_kernels.npz'),
                 **_kernel_outputs(dev))
    result['kernel_ms'] = _kernel_times(dev)
    if kernels_only:
        print(json.dumps(result), flush=True)
        return
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(_images(rng, BATCH, RES, RES)).to(DEVICE)
               for _ in range(MAIN_BATCHES)]
    _, img_s, outs = phase_main_path(batches)
    main_digest = _digest(outs)
    if first:
        np.save(os.path.join(work, tag + '_main.npy'),
                torch.stack(outs).cpu().numpy())
    del outs
    pipe = _pipeline(dev)
    plan_path = os.path.join(work, 'plan.pt')
    if not os.path.exists(plan_path):
        with torch.no_grad():
            plan = pipe.plan(pipe.proxy(batches[0]),
                             batch_generator(SEED, 0, dev))
        torch.save([t.cpu() for t in plan], plan_path)
    plan = [t.to(dev) for t in torch.load(plan_path)]
    replay = pipe.replay(batches[0], *plan)
    replay_digest = _digest([replay])
    if first:
        np.save(os.path.join(work, tag + '_replay.npy'), replay.cpu().numpy())
    del replay, pipe
    _, rows = phase_modes(batches)
    print(json.dumps(dict(result, main_img_s=img_s, modes=dict(rows),
                          main_digest=main_digest,
                          replay_digest=replay_digest)), flush=True)


def _lsb_diff(a, b):
    """(max LSB, values differing) between two u8 arrays, in slices."""
    max_lsb = n_diff = 0
    for i in range(a.shape[0]):
        d = abs(a[i].astype('int16') - b[i].astype('int16'))
        max_lsb = max(max_lsb, int(d.max()))
        n_diff += int((d > 0).sum())
    return max_lsb, n_diff


def _values_differing(a, b):
    """``{name: values of a[name] that differ from b[name]}`` over the
    arrays of ``a``; NaNs at the same places do not differ (a masked f32
    case can hold one)."""
    return {k: int((~((a[k] == b[k]) | ((a[k] != a[k]) &
                                        (b[k] != b[k])))).sum())
            for k in a.keys()}


def _moved_outputs(differing, may_differ=None):
    """The entries of ``differing`` with a count above 0 whose names
    ``may_differ`` (default ``TURNS_MAY_DIFFER``) does not cover."""
    allowed = tuple(TURNS_MAY_DIFFER if may_differ is None else may_differ)
    return {k: v for k, v in differing.items()
            if v and not k.startswith(allowed)}


def turns(parent, kernels_only=False):
    """``--turns PARENT [--kernels]``: the main path and modes of the
    checkout PARENT and of this one, in turns (parent, change, change,
    parent), each turn a process of its own (``--serve``) on the same card;
    then the two trees' main-path outputs compared value by value, their
    replays of one fixed plan (the kernels alone: the plan feeds back
    through the proxy chain, so a last-bit difference there can move a
    plan), and their kernel outputs (``_kernel_outputs``: values differing,
    per output; any fails the run unless ``TURNS_MAY_DIFFER`` names the
    output).  Each turn's outputs are also hashed, to show a tree
    repeats itself, and each turn times the kernels (``_kernel_times``).
    ``--kernels`` compares and times the kernels alone, one turn a tree."""
    import numpy as np
    phase_card()
    work = os.path.join(REPO, 'exposure_tpu_torch', 'build', 'turns')
    os.makedirs(work, exist_ok=True)
    for name in os.listdir(work):
        os.remove(os.path.join(work, name))
    trees = {'parent': os.path.abspath(parent), 'change': REPO}
    results = []
    order = ('parent', 'change') if kernels_only else \
        ('parent', 'change', 'change', 'parent')
    for tag in order:
        cmd = [sys.executable, os.path.abspath(__file__), '--serve',
               trees[tag], work, tag]
        if not any(r['tag'] == tag for r in results):
            cmd.append('--first')
        if kernels_only:
            cmd.append('--kernels')
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1200)
        for ln in proc.stdout.splitlines():
            if ln.startswith(('main:', 'mode ', 'build:', '  ptxas')):
                say('%s: %s' % (tag, ln))
        if proc.returncode != 0:
            say(proc.stdout[-3000:] + proc.stderr[-3000:])
            fail('turn %s failed' % tag)
        results.append(dict(json.loads(proc.stdout.splitlines()[-1]),
                            tag=tag))
        say('turn %s: %s' % (tag, json.dumps(results[-1])))
    compare = {}
    for what in () if kernels_only else ('main', 'replay'):
        a = np.load(os.path.join(work, 'parent_%s.npy' % what),
                    mmap_mode='r')
        b = np.load(os.path.join(work, 'change_%s.npy' % what),
                    mmap_mode='r')
        max_lsb, n_diff = _lsb_diff(a, b)
        compare[what] = {'shape': list(a.shape), 'max_lsb': max_lsb,
                         'values_differing': n_diff}
    a = np.load(os.path.join(work, 'parent_kernels.npz'))
    b = np.load(os.path.join(work, 'change_kernels.npz'))
    differing = _values_differing(a, b)
    compare['kernels'] = {'outputs': len(differing),
                          'values': int(sum(a[k].size for k in a.files)),
                          'differing': {k: v for k, v in differing.items()
                                        if v}}
    say('kernel ms, parent / change by turn: %s' % json.dumps({
        k: ['%s %.4f' % (r['tag'], r['kernel_ms'][k]) for r in results
            if k in r['kernel_ms']]
        for k in results[-1]['kernel_ms']}))
    repeats = {tag: len({(r.get('main_digest'), r.get('replay_digest'))
                         for r in results if r['tag'] == tag}) == 1
               for tag in trees}
    say(json.dumps({'turns': results, 'parent_vs_change': compare,
                    'each_tree_repeats_its_outputs': repeats}))
    if any(c['max_lsb'] > 1 for k, c in compare.items() if k != 'kernels'):
        fail('the two trees differ by more than 1 LSB: %s' % compare)
    moved = _moved_outputs(differing)
    if moved:
        fail('kernel outputs differ from the parent\'s (values differing, '
             'by output; TURNS_MAY_DIFFER lists none of them): %s' % moved)


if __name__ == '__main__':
    flags = [a for a in sys.argv[1:] if a in ('--first', '--kernels')]
    args = [a for a in sys.argv[1:] if a not in flags]
    if len(args) > 3 and args[0] == '--serve':
        serve(args[1], args[2], args[3], '--first' in flags,
              '--kernels' in flags)
    elif len(args) > 1 and args[0] == '--turns':
        turns(args[1], '--kernels' in flags)
    elif len(args) > 1 and args[0] == '--world':
        world(int(args[1]))
    else:
        main()
