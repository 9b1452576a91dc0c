#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``exposure_tpu_torch``) once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns PARENT_CHECKOUT   # A/B of two checkouts
    python3 chip_smoke.py --turns PARENT_CHECKOUT --kernels   # kernels alone
    python3 chip_smoke.py --world 4      # training on 4 nccl ranks, 4 cards

Phases, one line or a few each (a failing phase exits non-zero):

1. card: require CUDA, print the card's name and power limit; the TF32
   flags stay torch's defaults (cuDNN TF32 on), so that every phase shows
   the port holding float32 itself in its plans, training updates and
   critic scores (``exposure_tpu_torch/utils/precision.py``);
2. build: compile the five CUDA kernel libraries from
   ``exposure_tpu_torch/csrc`` (the three chain kernels, the probes and the
   proxy resize) at once, one nvcc each; each chain kernel variant's
   registers, stack frame and spills from ptxas (K2's bf16 variants too),
   the other libraries' ptxas lines; then bf16_ops: the packed bf16
   operations that K2's bf16 path and K4c run (``csrc/fastmath.cuh``)
   against their scalar f32-then-round forms over all 2^32 pairs of
   operands, with the counts of differing results printed (any in an
   operation a kernel runs fails the run); then the proxy resize
   (``csrc/proxy_resize.cu``) at the serving cells' two batch shapes,
   [512, 512, 512, 3] and [32, 3024, 4032, 3] u8 to 64x64, against its
   plain version, torch's ``F.interpolate`` path (the library call it
   replaces): kernel ms, bound ms and ``library_ms``, the
   ``{"proxy_resize": ...}`` line;
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
8b. card tools (``phase_card_tools``): ``bench_truth`` at its JAX defaults
   (B=256 512x512 u8, K=5, 20 dependency-serialized calls: the null call,
   the u8 copy, K2 on five block-uniform mixes; K2's executions counted,
   each mix's first call on 8 images within 1 LSB of the plain version),
   ``branch_roofline`` on phase 8's two tables (the traced operation counts
   beside ``branch_ops``), ``bench_upload`` (1, 27, 270 MB, pageable and
   pinned), ``bench_dispatch``, and the data tools on a planted drop
   (``import_reference_data --validate-only`` in a fresh process, the
   pack's shape its one finding; ``fetch_fivek_test``); the JSON line
   ``{"card_tools": ...}``, K2's executions its row's
   ``launches_card_tools``;
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
   plan), dropout on, each batch one replay of a CUDA graph that
   ``warmup`` captured (``core/serving_graph.py``); checks the output, the
   K1 executions (6 per batch: 5 proxy steps in the plan + 1 replay; the
   launches each stage recorded in the capture times the replays), one
   replay under ``torch.profiler`` with no cuDNN layout conversion
   (``nhwcToNchw``/``nchwToNhwc``) among its kernels, the replay against
   the plain version, no host sync, and prints img/s and its split across
   resize, plan and replay;
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
13. bf16 plan: the served plan in bfloat16 against the f32 plan;
13b. serving graph (``phase_serving_graph``): first one batch's plan and
   u8 output as graphs with the process's TF32 flags on and then off, equal
   bit for bit (its ids printed); then the dynamic selected-plan,
   dynamic bank-plan and switch modes (a batch one CUDA graph) and the
   grouped mode (its plan one graph) against ``graphs=False``: outputs and
   plans bit for bit under deterministic algorithms (a second per-call run
   the control), one capture a mode, executions per batch, then host launch
   calls, device-busy ms, the idle share (``torch.profiler``) and img/s
   (CUDA events) of both, the static buffers' copies, and
   ``load_policy`` under a live graph equal to a fresh pipeline on the new
   weights in f32 and bf16; the JSON line ``{"serving_graph": ...}``, and
   K1's and K2's executions in it their rows' ``launches_serving_graph``;
13c. bench scripts (``phase_bench_scripts``): the root benchmark scripts
   through their command lines, each a fresh process whose chain kernels'
   executions are counted: ``bench_torch.py`` in driver mode (its five
   lines on the artifact, the headline last; K1, K2 and K3 executed),
   ``bench_torch.py --no-pallas`` at B=32 (the branchless control, no
   chain kernel), ``bench_train_torch.py --iters 12`` and
   ``bench_stream_torch.py`` on a 1 GB pack, f32 and then u8 fused by 5:
   every line parses, its value finite and positive, the metric names
   those expected in order, ``g_loss`` and ``emd`` finite; the JSON line
   ``{"bench_scripts": ...}``, and K1-K3's executions in it their rows'
   ``launches_bench_scripts``;
14. serving tools (``phase_serving_tools``): the port's ``export_serving``
   (``phase_train``'s run at float32 and float16, verified),
   ``probe_selected_plan``, ``warmup_serving`` (fresh processes,
   ``--dynamic`` and the grouped path with ``--superset``),
   ``bench_serving_split``, ``bench_dyn_probe`` (K1 held to the branchless
   chain within 1 LSB), ``drive_refreeze`` (the artifact, then
   ``phase_train``'s run: a re-freeze, and the swapped pipeline planning as
   a fresh one on that run bit for bit) and ``bench_stream_device``, each
   at its JAX defaults; the JSON line ``{"serving_tools": ...}``, and
   K1-K3's launches in it their rows' ``launches_serving_tools``;
15. research probes (``phase_research_probes``, in ``phase_train``'s model
   root): the port's ``validate_parity`` (seeds 1 and 2 of
   ``synthetic_explore`` at full width through iteration 12,
   ``critic_initialization`` cut to 2, fused, then ``--skip-trained``: the
   same steps and scores), ``diagnose_diversity``
   (its argmax section against the CPU on the card's dropout draws, at most
   1% of the ids apart), ``probe_critic_family`` (each critic's score of its
   own outputs against a CPU rescore, rtol 1e-3), ``validate_selector`` (the
   repo's ``PARITY_*.json`` and the new report), ``select_policy --truth
   --promote best`` (the link, and an ``Evaluator`` restoring the winner's
   checkpoint through it, one replay through K1) and ``ablate_w_usage
   --drop-filters C`` (a 7-filter run), each a fresh process whose K1
   launches are counted; the ``{"research_probes": ...}`` line, and K1's
   row's ``launches_research_probes``.

Every kernel count is set to 0 just before a path is driven (the serving
modes, and the tools, which are the probes' path) and read just after;
the comparisons with the plain versions do not count.  A count is of
executions: the kernels' launches (``kernels.launch_counts``), less those
a graph's capture recorded, plus those its replays ran (``read_counts``).
The line before the last is a JSON summary of every kernel: launches,
error, time beside its plain version's, its H100 bound
(``ops/dyn_chain.py::chain_cost`` for the chains, ``probe_cost`` for the probes; ``tools.bound_ms``) and the
time of the PyTorch call that computes the same function, where one does
(``Tensor.copy_`` for the probes' 0-step copy; no single call computes a
filter chain); K2's bf16 kernel has an entry of its own, and each probe
entry lists its timed cases one by one under ``cases``.  The last line is
``{"ok": true, "device": {...}}``.

``--turns PARENT`` runs the main path and the five modes of another
checkout (``PARENT``, e.g. ``git archive`` of the parent commit) and of
this one in turns, parent, change, change, parent, and compares the two
trees' main-path outputs and fixed-plan replays value by value, each
mode's outputs by digest, and their kernels' outputs: one
step of every branch of both banks through K1 and through K2 in bf16, K2 in
f32 and bf16 on every case of phase 4, and every probe case.  An output
with a value that differs from the parent's fails the run, unless
``TURNS_MAY_DIFFER`` names it (``main``, ``replay``, ``mode_<mode>`` or a
kernel output).  Each turn also times every kernel, so the two
trees' kernel times come from one card.
``--kernels`` leaves the served path out (one turn a tree).
``--world N``, on a machine of N cards, trains ``example`` on N ``nccl``
ranks, one a card, against world 1 in turns (phase 9e's (b) over NVLink),
then fused (chunks of 10, bookkeeping 2 behind, the all-reduces captured)
against plain on world N and on world 1, bit for bit, with the ranks'
parameters equal after every chunk and a resume from the pipelined
checkpoint, and prints the ``{"world": ...}`` line.
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
# outputs of --turns (``main``, ``replay``, ``mode_<mode>`` or names of
# _kernel_outputs, by prefix) that a deliberate change of the numbers lets
# differ from the parent's; any other differing value fails the turns.  A
# change that keeps the numbers lists none
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


def reset_counts():
    """Set the kernels' launch counts and the graphs' records to 0."""
    from exposure_tpu_torch import kernels
    from exposure_tpu_torch.core import serving_graph
    kernels.reset_launch_counts()
    serving_graph.reset_counts()


def read_counts():
    """Kernel executions by the launch counter's key: the launches, less
    those a CUDA graph's capture recorded (which ran nothing), plus those
    its replays ran (``core/serving_graph.py::executions``);
    ``switch_chain_bf16`` is the part of ``switch_chain``'s that ran the
    bf16 kernel."""
    from exposure_tpu_torch import kernels
    from exposure_tpu_torch.core import serving_graph
    return serving_graph.executions(kernels.launch_counts())


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
    # the process keeps torch's TF32 defaults: the port's plans, updates
    # and scores hold float32 themselves (utils/precision.py)
    say('card: %s | torch %s cuda %s | devices %d | TF32 flags left as '
        'torch sets them: cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s'
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


def start_build():
    """Start the libraries' builds at once, one nvcc each, in
    background threads; returns ``finish()``, which waits for them and
    reports as ``phase_build`` does.  A phase that needs a library before
    then waits for that library alone (``kernels.build`` holds a lock a
    library), so the phases that need no K2 run while K2's library, the
    longest build, compiles."""
    from concurrent.futures import ThreadPoolExecutor
    from exposure_tpu_torch import kernels
    t0 = time.perf_counter()
    names = ('dyn_chain', 'switch_chain', 'static_chain', 'probes',
             'proxy_resize')
    pool = ThreadPoolExecutor(len(names))
    futures = {name: pool.submit(getattr(kernels, name + '_kernel'))
               for name in names}
    pool.shutdown(wait=False)

    def finish():
        libs = {name: fut.result() for name, fut in futures.items()}
        say('build: %d libraries in %.1f s (one nvcc each, all at once; '
            'waited for %.1f s after they started)'
            % (len(libs), max(lib.build_seconds for lib in libs.values()),
               time.perf_counter() - t0))
        return _build_report(libs)
    return finish


def phase_build():
    """Build the libraries at once; print each chain kernel variant's
    registers, stack frame and spills.  Returns ``{library: variants}``."""
    return start_build()()


def _build_report(libs):
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


# the serving cells' batches, [B, H, W] u8, resized to 64x64
RESIZE_CASES = ((512, 512, 512), (32, 3024, 4032))
RESIZE_ATOL = 2e-6     # the kernel against torch's interpolate: f32 sums


def phase_resize(card):
    """The proxy resize kernel at ``RESIZE_CASES`` against its plain
    version (torch's antialiased ``F.interpolate`` path, the library call
    it replaces, so ``plain_ms`` is ``library_ms``), timed with CUDA
    events beside its bound (bytes: the batch read once, the proxy written
    once; the taps' operations); prints the ``{"proxy_resize": ...}``
    line and returns its cases."""
    import torch
    from exposure_tpu_torch.ops.proxy_resize import (
        proxy_resize, proxy_resize_reference, resize_taps)
    from exposure_tpu_torch.tools import bound_ms
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = {}
    for b, h, w in RESIZE_CASES:
        img = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                            device=DEVICE, generator=g)
        got = _launch_checked('proxy_resize', proxy_resize, img, 64)
        err = float((got - proxy_resize_reference(img, 64)).abs().max())
        if err > RESIZE_ATOL:
            fail('proxy_resize [%d, %d, %d, 3]: max_abs_err %.3e over %g'
                 % (b, h, w, err, RESIZE_ATOL))
        ms = cuda_ms(lambda: proxy_resize(img, 64), calls=KERNEL_CALLS)
        plain = cuda_ms(lambda: proxy_resize_reference(img, 64), runs=5,
                        warmup=1)
        taps = 3 * b * (int(resize_taps(h, 64)[1].sum()) * w +
                        int(resize_taps(w, 64)[1].sum()) * 64)
        nbytes = img.numel() + b * 64 * 64 * 3 * 4
        bound, by = bound_ms(2 * taps, nbytes)
        cases['%dx%dx%d' % (b, h, w)] = {
            'ms': ms, 'plain_ms': plain, 'library_ms': plain,
            'bound_ms': bound, 'bound_by': by, 'flops': 2 * taps,
            'bytes': nbytes, 'max_abs_err': err}
        say('proxy_resize [%d, %d, %d, 3] u8 -> 64x64: max_abs_err %.3e  '
            'kernel %.4f ms  plain (F.interpolate) %.4f ms  bound %.4f ms '
            '(%s)' % (b, h, w, err, ms, plain, bound, by))
        del img, got
    line = {'name': 'proxy_resize', 'route': 'cuda',
            'source': 'exposure_tpu_torch/csrc/proxy_resize.cu',
            'replaces': 'none (jax.image.resize is XLA\'s)',
            'cases': cases, 'card': card}
    say(json.dumps({'proxy_resize': line}))
    return cases


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
        got = _launch_checked('dyn_chain', apply_filter_chain_dynamic, img,
                              ids, params, filters, **kw)
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
        got = _launch_checked('static_chain', apply_filter_chain_static,
                              img, sig, params, filters, **kw, **out_kw)
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


def _launch_checked(name, fn, *args, **kw):
    """``fn(*args, **kw)`` on the card, failing unless it launched the
    kernel counted as ``name`` exactly once."""
    import torch
    from exposure_tpu_torch import kernels
    before = kernels.launch_counts()[name]
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    if kernels.launch_counts()[name] != before + 1:
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


CARD_TOOLS_BUDGET_S = 45
TRUTH_ITERS = 20        # bench_truth's JAX defaults: B=256, K=5, 20 calls
TRUTH_CHECK_BATCH = 8   # images of each mix's first call held to the plain
UPLOAD_MB = (1, 27, 270)    # bench_upload's JAX default sizes, 5 reps


def _planted_drop(root):
    """A small FiveK drop under ``root`` for ``import_reference_data``:
    folds of the dataset's lengths, 4,000 artist file names and an 80x80
    pack of 16 crops, so that the pack's shape is its one finding."""
    from exposure_tpu_torch.tools import import_reference_data as ird
    import numpy as np
    rng = np.random.RandomState(SEED)
    pack = os.path.join(root, ird.PACK_REL)
    os.makedirs(os.path.dirname(pack))
    np.save(pack, (rng.rand(16, 80, 80, 3) * 2).astype(np.float32))
    os.makedirs(os.path.join(root, 'data', 'folds'))
    for rel, n in ird.FOLDS.items():
        with open(os.path.join(root, rel), 'w') as f:
            f.write(''.join('%d\n' % i
                            for i in rng.permutation(5000)[:n] + 1))
    artists = os.path.join(root, ird.ARTIST_DIR)
    os.makedirs(artists)
    for i in range(ird.ARTIST_MIN_IMAGES):
        open(os.path.join(artists, 'a%04d.jpg' % (i + 1)), 'wb').close()
    source = os.path.join(root, 'data', 'fivek_dataset',
                          'FiveK_Lightroom_Export_InputDayLight')
    os.makedirs(source)
    with open(os.path.join(root, 'data', 'folds', 'FiveK_test.txt')) as f:
        test_ids = f.read().split()[:3]
    for i in test_ids + ['5001']:
        open(os.path.join(source, 'a%04d-x.tif' % int(i)), 'wb').close()
    return len(test_ids)


def phase_card_tools(tables):
    """The last tools of the port on the card: ``bench_truth`` at its JAX
    defaults (K2's executions counted, each mix's first call on 8 images
    held to the plain version within 1 LSB), ``branch_roofline`` on
    ``phase_tools``' two ``bench_filters`` tables (``tables``: no second
    timing), ``bench_upload`` (pageable and pinned) and ``bench_dispatch``;
    the data tools imported, ``import_reference_data --validate-only`` in a
    fresh process on a planted drop (the pack's shape its one finding) and
    ``fetch_fivek_test`` on it.  Returns the ``{"card_tools": ...}``
    numbers, K2's executions under ``launches``."""
    import tempfile
    import numpy as np
    import torch
    from exposure_tpu_torch.ops.filters import build_filters
    from exposure_tpu_torch.ops.switch_chain import (
        apply_filter_chain_switch, apply_filter_chain_switch_reference)
    from exposure_tpu_torch.tools import (
        bench_dispatch, bench_truth, bench_upload, branch_roofline,
        fetch_fivek, fetch_fivek_test, import_reference_data)
    from exposure_tpu_torch.utils.config import load_config
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    reset_counts()
    truth = bench_truth.report(PROBE_BATCH, RES, 5, TRUTH_ITERS, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts['switch_chain']
    want = len(bench_truth.MIXES) * (TRUTH_ITERS + 1)
    if launches != want or any(v for k, v in counts.items()
                               if k != 'switch_chain'):
        fail('bench_truth: K2 executions %d, want %d and no other kernel: '
             '%s' % (launches, want, counts))
    numbers = [v for k, v in truth.items() if k.endswith(('_ms', '_s',
                                                          '_gbps'))]
    if not all(np.isfinite(v) and v > 0 for v in numbers):
        fail('bench_truth: %s' % truth)
    say('bench_truth: ' + json.dumps(truth))
    filters = build_filters(load_config('example'))
    img = bench_truth.images(TRUTH_CHECK_BATCH, RES)
    worst = 0
    for name, mix in bench_truth.MIXES.items():
        ids, params = bench_truth.make_traj(filters, mix, 5, PROBE_BATCH)
        ids, params = ids[:, :TRUTH_CHECK_BATCH], params[:, :TRUTH_CHECK_BATCH]
        got = apply_filter_chain_switch(img.to(dev), ids.to(dev),
                                        params.to(dev), filters).cpu()
        want_img = apply_filter_chain_switch_reference(img, ids, params,
                                                       filters)
        lsb = int((got.int() - want_img.int()).abs().max())
        worst = max(worst, lsb)
        if lsb > 1:
            fail('bench_truth %s: K2 %d LSB off its plain version'
                 % (name, lsb))
    roof = {}
    for fast in (False, True):
        branch_roofline.check_bench(tables[fast], fast, 'phase_tools')
        roof['fast' if fast else 'exact'] = rep = branch_roofline.roofline(
            fast, tables[fast])
        if not all(np.isfinite(row['achieved_Tops_per_s']) and
                   row['achieved_Tops_per_s'] > 0
                   for row in rep['branches'].values()):
            fail('branch_roofline: %s' % rep)
        say('branch_roofline%s: %s' % (' --exact' if not fast else '',
                                       json.dumps(rep)))
    upload = bench_upload.report(UPLOAD_MB, 5, dev,
                                 say=lambda s: say('bench_upload ' + s))
    for mb in UPLOAD_MB:
        for line in (upload[mb], upload[mb]['pinned']):
            if not (line['mb_per_s'] > 0 and len(line['all_s']) == 5):
                fail('bench_upload %d MB: %s' % (mb, upload[mb]))
    say('bench_upload: ' + json.dumps(upload))
    dispatch = bench_dispatch.report(dev)
    if not all(0 <= v[0] <= v[1] for k, v in dispatch.items()
               if k.endswith('_ms')):
        fail('bench_dispatch: %s' % dispatch)
    say('bench_dispatch: ' + json.dumps(dispatch))
    with tempfile.TemporaryDirectory() as root:
        n_test = _planted_drop(root)
        proc = subprocess.run(
            [sys.executable, '-m',
             'exposure_tpu_torch.tools.import_reference_data',
             '--validate-only', '--data-root', root, '--no-strict-folds'],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        found = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('VALIDATE:')]
        if proc.returncode != 1 or len(found) != 1 or \
                'pack shape (16, 80, 80, 3)' not in found[0]:
            fail('import_reference_data --validate-only: rc %d, %s %s'
                 % (proc.returncode, proc.stdout[-2000:],
                    proc.stderr[-2000:]))
        fetch_fivek_test.fetch(root, os.path.join(root, 'test_set'))
        copied = sorted(os.listdir(os.path.join(root, 'test_set')))
        if len(copied) != n_test:
            fail('fetch_fivek_test copied %s' % copied)
    say('data tools: import_reference_data --validate-only: %s; '
        'fetch_fivek_test copied %d; fetch_fivek imports (%s)'
        % (found[0], len(copied), fetch_fivek.RELEASE_BASE))
    seconds = time.perf_counter() - t0
    say('card tools: %.1f s (budget %d s)' % (seconds, CARD_TOOLS_BUDGET_S))
    if seconds > CARD_TOOLS_BUDGET_S:
        fail('card tools took %.1f s, over %d s' % (seconds,
                                                    CARD_TOOLS_BUDGET_S))
    return {'bench_truth': truth, 'k2_max_lsb_8_images': worst,
            'branch_roofline': {
                k: {key: v[key] for key in ('differences', 'calibration',
                                            'branches')}
                for k, v in roof.items()},
            'bench_upload': upload, 'bench_dispatch': dispatch,
            'launches': launches, 'phase_s': seconds}


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
                                          device_out=True):
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


def _k1_by_stage(pipe):
    """Wrap ``pipe.plan`` and ``pipe.replay`` (which the pipeline's graph
    body calls too): the K1 launches each call makes eagerly, and those
    each records in a capture, by stage.  Returns ``read()``, the K1
    executions by stage since the wrap or the last ``read``: the eager
    ones, plus each stage's recorded launches times the replays of the
    pipeline's graphs since then."""
    import torch
    from exposure_tpu_torch import kernels
    eager = {'plan': 0, 'replay': 0}
    recorded = {'plan': 0, 'replay': 0}
    for stage in eager:
        def counted(*args, _fn=getattr(pipe, stage), _stage=stage, **kw):
            before = kernels.launch_counts()['dyn_chain']
            try:
                return _fn(*args, **kw)
            finally:
                n = kernels.launch_counts()['dyn_chain'] - before
                if torch.cuda.is_current_stream_capturing():
                    recorded[_stage] += n
                else:
                    eager[_stage] += n
        setattr(pipe, stage, counted)

    def replays():
        return pipe.graph_report()['replays']
    last = [replays()]

    def read():
        n = replays() - last[0]
        out = {'proxy': eager['plan'] + recorded['plan'] * n,
               'replay': eager['replay'] + recorded['replay'] * n}
        eager.update(plan=0, replay=0)
        last[0] = replays()
        return out
    return read


# cuDNN's kernels that convert a tensor between NCHW and NHWC: no float32
# plan runs one (``models/networks.py`` gives its convolutions NCHW)
LAYOUT_CONVERSIONS = ('nhwcToNchw', 'nchwToNhwc')


def layout_conversions(names):
    """The kernel names among ``names`` that convert layouts
    (``LAYOUT_CONVERSIONS``)."""
    return sorted({n for n in names
                   if any(c in n for c in LAYOUT_CONVERSIONS)})


def _replay_kernels(pipe, batch):
    """The names of the device kernels that one run of ``pipe`` on
    ``batch`` (a replay of its captured graph) runs, under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from exposure_tpu_torch.tools import device_work
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pipe(batch, SEED, 0, device_out=True)
        torch.cuda.synchronize()
    return {e.name for e in device_work(prof.events())[0]}


def _main_path_counts(pipe, by_stage, counts, warm, batch):
    """Fail unless the main path's counted run executed K1 ``test_steps``
    times a batch on the proxy and once on the replay, the proxy resize
    once a batch and no other chain kernel, from one graph captured by the
    warm-up and replayed per batch; and unless one replay, profiled, runs
    K1 and no layout conversion.  Returns the line's note on the graph."""
    steps = pipe.cfg.test_steps
    launches = counts['dyn_chain']
    if by_stage != {'proxy': steps * MAIN_BATCHES, 'replay': MAIN_BATCHES} \
            or launches != sum(by_stage.values()) or \
            counts['switch_chain'] or counts['static_chain']:
        fail('main path launched %s over %d batches (K1: %s by stage), '
             'expected K1 %d times on the proxy and %d on the replay'
             % (counts, MAIN_BATCHES, by_stage, steps * MAIN_BATCHES,
                MAIN_BATCHES))
    if counts['proxy_resize'] != MAIN_BATCHES:
        fail('main path: the proxy resize kernel ran %d times over %d '
             'batches, expected once a batch'
             % (counts['proxy_resize'], MAIN_BATCHES))
    rep = pipe.graph_report()
    if rep['captures'] != 1 or rep['replays'] != MAIN_BATCHES + 1 or \
            list(rep['launches_per_replay'].values()) != [
                {'dyn_chain': steps + 1, 'proxy_resize': 1}]:
        fail('main path: one graph captured and replayed per batch '
             'expected, got %s' % rep)
    names = _replay_kernels(pipe, batch)
    converting = layout_conversions(names)
    if converting or not any('dyn_chain_kernel' in n for n in names):
        fail('main path: a profiled replay ran layout conversions %s (and '
             'K1: %s) among %d kernels' % (
                 converting, any('dyn_chain_kernel' in n for n in names),
                 len(names)))
    return ('; one CUDA graph (captured in %.3f s by the warm-up, its K1 '
            'launches %d a replay) replayed per batch; a profiled replay '
            'runs %d kernels, no layout conversion'
            % (warm['capture_seconds'], steps + 1, len(names)))


def phase_main_path(batches, counted=True):
    """The served path; returns K1's launches in it, ``{'proxy': n,
    'replay': n}`` (the plan's steps on the proxy, and the replay), img/s,
    the outputs and the proxy resize's executions (one a batch).
    ``counted=False`` (``--serve`` of another tree) checks no count: both
    are None."""
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

    # the warm-up captures the batch's graph (and syncs), so that the
    # counted and timed runs below are replays
    by_stage = _k1_by_stage(pipe) if counted else None
    warm = pipe.warmup(batches[0], seed=SEED)
    if counted:
        by_stage()
        reset_counts()
    outs = list(pipe.map_batches(batches, seed=SEED, device_out=True))
    torch.cuda.synchronize()
    resized = None
    if counted:
        counts = read_counts()
        by_stage = by_stage()
        del pipe.plan, pipe.replay     # the runs below go unwrapped
        graphs = _main_path_counts(pipe, by_stage, counts, warm, batches[0])
        resized = counts['proxy_resize']
        say('main: K1 launches %d (%d per batch: %d on the proxy in the '
            'plan, %d replay)%s; proxy resize executions %d'
            % (counts['dyn_chain'], counts['dyn_chain'] // MAIN_BATCHES,
               by_stage['proxy'] // MAIN_BATCHES,
               by_stage['replay'] // MAIN_BATCHES, graphs, resized))
    for i, out in enumerate(outs):
        if out.shape != batches[i].shape or out.dtype != torch.uint8 or \
                out.device.type != torch.device(DEVICE).type:
            fail('main path output %d: %s %s on %s' % (
                i, tuple(out.shape), out.dtype, out.device))
    changed = float((outs[0] != batches[0]).float().mean())
    say('main: %d batches of [%d, %d, %d, 3] u8 -> u8 on %s; %.3f of '
        'output values differ from the input'
        % (MAIN_BATCHES, BATCH, RES, RES, outs[0].device, changed))

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
    pipe.release()
    return by_stage, img_s, outs, resized


MODES = [
    ('dynamic_bank_plan', dict(dynamic=True, selected_plan=False)),
    ('switch', dict(dynamic=False, grouped=False)),
    ('grouped', dict(grouped=True)),
    ('grouped_superset', dict(grouped=True)),
    ('auto_superset', dict(auto_superset=True, auto_record_batches=2)),
]
# the kernel each mode must launch, and those it must not; every mode also
# resizes each batch's proxy in one execution of the proxy resize kernel,
# and once more for each graph the counted run captures (a capture runs its
# body once eagerly first)
MODE_KERNELS = {
    'dynamic_bank_plan': ('dyn_chain', ('switch_chain', 'static_chain')),
    'switch': ('switch_chain', ('dyn_chain', 'static_chain')),
    'grouped': ('static_chain', ('dyn_chain',)),
    'grouped_superset': ('static_chain', ('dyn_chain',)),
    'auto_superset': ('static_chain', ('dyn_chain',)),
}


def phase_modes(batches, digests=None, counted=True):
    """Every other serving mode on the trained artifact at full width;
    returns the launches per kernel summed over the modes' runs, and
    ``(mode, img/s)`` rows.  ``digests``: a dict that gets each mode's
    output digest (``--serve``, whose trees' modes are compared);
    ``counted=False`` (``--serve`` of another tree) checks no count."""
    import collections
    import torch
    dev = torch.device(DEVICE)
    totals = collections.Counter()
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
        elif not pipe.grouped:
            # captures the batch's graph: the runs below are replays
            pipe.warmup(batches[0], seed=SEED)
        if counted:
            reset_counts()
        if pipe.grouped:
            pipe._runner.launches.clear()
        captured = pipe.graph_report()['captures']
        outs = list(pipe.map_batches(batches, seed=SEED,
                                     device_out=True))
        torch.cuda.synchronize()
        counts = read_counts() if counted else collections.Counter()
        captured = pipe.graph_report()['captures'] - captured
        must, must_not = MODE_KERNELS[mode]
        if counted and (counts[must] == 0 or
                        any(counts[k] for k in must_not) or
                        counts['proxy_resize'] != MAIN_BATCHES + captured):
            fail('mode %s launched %s over %d batches (%d graphs captured)'
                 % (mode, counts, MAIN_BATCHES, captured))
        totals.update(counts)
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
        if digests is not None:
            digests[mode] = _digest(outs)
        pipe.release()
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
    b16.release()
    say('bf16 plan: step-1 ids agree with the f32 plan on %.4f of the '
        'images, all 5 steps on %.4f (%d batches of %d); bf16-planned '
        'output %s %s' % (step1, total, len(batches), BATCH,
                          tuple(out.shape), out.dtype))
    if step1 < BF16_PLAN_STEP1:
        fail('bf16 plan: step-1 agreement %.4f below %.2f'
             % (step1, BF16_PLAN_STEP1))
    return step1, total


SERVING_GRAPH_BUDGET_S = 75
# the modes served as one program a batch: the three non-grouped ones whole
# (the JAX _single_jit), the grouped one's plan (the JAX _plan_for)
GRAPH_MODES = [
    ('dynamic_selected_plan', {}),
    ('dynamic_bank_plan', dict(dynamic=True, selected_plan=False)),
    ('switch', dict(dynamic=False, grouped=False)),
    ('grouped_plan', dict(grouped=True)),
]
SWAP_SEED = 41          # the swapped-in policy's init draws
GRAPH_TURNS = ('graph', 'eager', 'eager', 'graph')   # timed streams


def _differing(got, want):
    """Values of ``got`` that differ from ``want`` (lists of tensors)."""
    return sum(int((a != b).sum()) for a, b in zip(got, want))


def _graph_outputs(pipe):
    """The served outputs of ``pipe`` on the main batches, and in a grouped
    mode each batch's plan (ids, params, mask) as well, all on the card."""
    return lambda batches: list(pipe.map_batches(
        batches, seed=SEED, device_out=True)) + (
        [t.clone() for i, img in enumerate(batches)
         for t in pipe._plan_batch(img, SEED, i)] if pipe.grouped else [])


def _swap_under_graph(batches, dev):
    """``load_policy`` under a live graph, in f32 and with the bf16 plan:
    the graph captured on the artifact's weights, then a policy from seed
    ``SWAP_SEED`` swapped in; its next replay must equal a fresh per-call
    pipeline on that policy bit for bit, with no new capture.  Returns the
    values differing (0) by plan type."""
    import copy
    import torch
    from exposure_tpu_torch.core.serving import RetouchPipeline
    from exposure_tpu_torch.models.networks import build_policy, init_like_flax
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    out = {}
    for bf16 in (False, True):
        pipe = _pipeline(dev, bf16=bf16, graphs=True)
        policy_b = init_like_flax(
            build_policy(pipe.cfg, pipe.filters),
            torch.Generator().manual_seed(SWAP_SEED)).eval()
        fresh = RetouchPipeline(pipe.cfg, copy.deepcopy(policy_b),
                                device=dev, bf16=bf16, graphs=False,
                                use_kernels=pipe.use_kernels)
        with deterministic_algorithms():
            before = pipe(batches[0], SEED, 0, device_out=True)
            pipe.load_policy(policy_b.state_dict())
            got = pipe(batches[1], SEED, 1, device_out=True)
            want = fresh(batches[1], SEED, 1, device_out=True)
            again = pipe(batches[0], SEED, 0, device_out=True)
        rep = pipe.graph_report()
        tag = 'bf16' if bf16 else 'f32'
        out[tag] = _differing([got], [want])
        if out[tag] or rep['captures'] != 1 or torch.equal(before, again):
            fail('serving graph: after load_policy (%s plan) the replay '
                 'differs from a fresh pipeline on the new weights in %d '
                 'values, captures %d, output unchanged by the swap: %s'
                 % (tag, out[tag], rep['captures'],
                    torch.equal(before, again)))
        pipe.release()
    return out


def _flags_alike(batches, dev):
    """One batch of the main path served as graphs (the dynamic selected
    plan: its plan captured alone, and the whole batch) in a fresh pipeline
    with the process's TF32 flags on, then in another with them off, under
    deterministic algorithms: the plan's [K, B] ids and the u8 output equal
    bit for bit, since the port's plans hold float32 whatever the flags
    (``exposure_tpu_torch/utils/precision.py``).  Prints the ids of the
    first images, the filters' counts a step and digests; returns the
    values differing by tensor (0)."""
    import torch
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    got = {}
    try:
        for flags in (True, False):
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = (flags, flags)
            pipe = _pipeline(dev, graphs=True)
            with deterministic_algorithms():
                ids = pipe._plan_for(batches[0], SEED, 0)[0].clone()
                out = pipe(batches[0], SEED, 0, device_out=True)
            got[flags] = (ids, out)
            pipe.release()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    differing = {'ids': _differing([got[True][0]], [got[False][0]]),
                 'u8': _differing([got[True][1]], [got[False][1]])}
    ids = got[True][0].cpu()
    counts = [torch.bincount(row.long(), minlength=8).tolist()
              for row in ids]
    say('serving graph: one batch [%d, %d, %d, 3] u8, the dynamic selected '
        'plan as graphs, TF32 flags on then off: ids of images 0-15 by step '
        '%s; filters\' counts a step %s; ids digest %s / %s, output digest '
        '%s / %s; values differing %s' % (
            BATCH, RES, RES, ids[:, :16].tolist(), counts,
            _digest([got[True][0]]), _digest([got[False][0]]),
            _digest([got[True][1]]), _digest([got[False][1]]), differing))
    if differing['ids'] or differing['u8']:
        fail('serving graph: the TF32 flags moved the plan: %s' % differing)
    return differing


def phase_serving_graph(batches):
    """Serving as one program a batch (``core/serving_graph.py``): one
    batch with the TF32 flags on and off (``_flags_alike``); each of
    ``GRAPH_MODES`` on the trained artifact at full width with
    ``graphs=True`` against ``graphs=False``: under deterministic
    algorithms the graph's outputs (and a grouped mode's plans) equal the
    per-call path's bit for bit, with a second per-call run as the control;
    one capture per mode; kernel executions per batch (the capture's
    launches times the replays); then, the graph captured anew as served,
    host launch calls, device-busy ms and the idle share per batch under
    ``torch.profiler``, and ms per batch and img/s (CUDA events, passes in
    turns, ``GRAPH_TURNS``); the static buffers' copies
    at this size; ``load_policy`` under a live graph
    (``_swap_under_graph``).  Returns the numbers and the kernel executions
    of the counted graph runs."""
    import collections
    import torch
    from exposure_tpu_torch.tools import profile_calls
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    numbers, launches = {}, collections.Counter()
    numbers['tf32_flags_differing'] = _flags_alike(batches, dev)
    for mode, kw in GRAPH_MODES:
        pipes = {'graph': _pipeline(dev, graphs=True, **kw),
                 'eager': _pipeline(dev, graphs=False, **kw)}
        runs = {tag: _graph_outputs(p) for tag, p in pipes.items()}
        with deterministic_algorithms():
            warm = pipes['graph'].warmup(batches[0], probe_batches=1,
                                         seed=SEED)
            want = runs['eager'](batches)
            control = runs['eager'](batches)
            reset_counts()
            got = runs['graph'](batches)
            torch.cuda.synchronize()
            counts = read_counts()
        rep = pipes['graph'].graph_report()
        row = {'differing': _differing(got, want),
               'control_differing': _differing(control, want),
               'values': sum(t.numel() for t in want),
               'captures': rep['captures'],
               'capture_s': rep['capture_s'],
               'launches_per_replay': list(
                   rep['launches_per_replay'].values()),
               'executions_per_batch': {k: v / MAIN_BATCHES
                                        for k, v in counts.items() if v}}
        del want, control, got
        launches.update(counts)
        if row['differing'] or row['control_differing'] or \
                rep['captures'] != 1:
            fail('serving graph: %s against the per-call path: %s'
                 % (mode, row))
        # timed as served: the graph captured anew outside deterministic
        # algorithms (whose convolutions are other kernels, and slower)
        pipes['graph'].release()
        pipes['graph'].warmup(batches[0], probe_batches=1, seed=SEED)
        for tag, pipe in pipes.items():
            prof = profile_calls(lambda: list(pipe.map_batches(
                batches, seed=SEED + 1, device_out=True)), MAIN_BATCHES,
                DEVICE)
            row[tag] = {
                'host_launch_calls_per_batch':
                    prof['host_launch_calls_per_unit'],
                'device_kernels_per_batch': prof['device_kernels_per_unit'],
                'device_busy_ms_per_batch': prof['device_busy_ms_per_unit'],
                'profiled_wall_ms_per_batch': prof['wall_ms_per_unit'],
                'idle_share': prof['idle_share'], 'pass_ms': []}
        for tag in GRAPH_TURNS:
            pipe = pipes[tag]
            row[tag]['pass_ms'] += _timed_stream(pipe, batches,
                                                 trap=not pipe.grouped)[0]
        for tag in pipes:
            times = sorted(row[tag].pop('pass_ms'))
            row[tag].update(ms_per_batch=[t / MAIN_BATCHES for t in times],
                            img_s=_rate(times)[0])
        if mode == 'dynamic_selected_plan':
            static = list(pipes['graph']._graphs.graphs.values())[0]
            row['input_copy_ms'] = cuda_ms(
                lambda: static.input.copy_(batches[0]), calls=KERNEL_CALLS)
            row['output_clone_ms'] = cuda_ms(
                lambda: static.outputs.clone(), calls=KERNEL_CALLS)
        row['warmup'] = {k: warm[k] for k in ('programs_compiled',
                                              'warmup_seconds')}
        for pipe in pipes.values():
            pipe.release()
        del pipes, runs
        numbers[mode] = row
        say('serving graph %-21s graph vs per call: %d of %d values differ '
            '(control %d); captures %d (%.3f s); launches a replay %s; '
            'per batch graph / per call: host launch calls %s / %s, '
            'device busy %s / %s ms, idle share %s / %s (profiled), median '
            '%s / %s img/s (CUDA events)' % (
                mode, row['differing'], row['values'],
                row['control_differing'], row['captures'], row['capture_s'],
                row['launches_per_replay'],
                row['graph']['host_launch_calls_per_batch'],
                row['eager']['host_launch_calls_per_batch'],
                row['graph']['device_busy_ms_per_batch'],
                row['eager']['device_busy_ms_per_batch'],
                row['graph']['idle_share'], row['eager']['idle_share'],
                row['graph']['img_s'], row['eager']['img_s']))
    numbers['static_copies_ms'] = {
        'input_copy': numbers['dynamic_selected_plan'].pop('input_copy_ms'),
        'output_clone': numbers['dynamic_selected_plan'].pop(
            'output_clone_ms')}
    numbers['load_policy_differing'] = _swap_under_graph(batches, dev)
    numbers['phase_s'] = time.perf_counter() - t_phase
    say('serving graph: static buffers at [%d, %d, %d, 3] u8: input copy '
        '%.4f ms, output clone %.4f ms; load_policy under a live graph '
        'equals a fresh pipeline on the new weights (values differing %s); '
        'phase %.1f s (budget %d s)' % (
            BATCH, RES, RES, numbers['static_copies_ms']['input_copy'],
            numbers['static_copies_ms']['output_clone'],
            numbers['load_policy_differing'], numbers['phase_s'],
            SERVING_GRAPH_BUDGET_S))
    return numbers, launches


BENCH_SCRIPTS_BUDGET_S = 150
BENCH_SCRIPT_TIMEOUT_S = 400            # a script process's
BENCH_METRIC = '512px_images_per_sec_5step_inference'
# bench_torch.py's driver mode on the artifact: bench.py's five lines
BENCH_DRIVER_LINES = tuple(BENCH_METRIC + tag for tag in (
    '_u8io', '_u8io_trained_grouped', '_u8io_bf16_trained_stream',
    '_u8io_bf16_trained_stream_superset', '_u8io_bf16_trained_dyn'))
# runs ``python3 <script> <args>`` in this interpreter, then prints the
# chain kernels' executions there on its last line of stderr
_SCRIPT_SHIM = '''
import json, runpy, sys
script = sys.argv[1]
sys.argv = sys.argv[1:]
try:
    runpy.run_path(script, run_name='__main__')
finally:
    from exposure_tpu_torch import kernels
    from exposure_tpu_torch.core.serving_graph import executions
    counts = executions(kernels.launch_counts())
    print('# kernel_executions ' + json.dumps(
        {name: counts[name] for name in %r}), file=sys.stderr, flush=True)
''' % (CHAIN_LIBS,)


BENCH_STREAM_PACK_GB = 1.0


def start_bench_packs(pack_dir):
    """Write ``bench_stream_torch.py``'s packs of ``BENCH_STREAM_PACK_GB``
    into ``pack_dir`` in a process of their own (host work, started while
    the kernels build); returns the process."""
    code = ('import sys; import bench_stream_torch as b; '
            'b.make_packs(sys.argv[1], float(sys.argv[2]))')
    return subprocess.Popen(
        [sys.executable, '-c', code, pack_dir, str(BENCH_STREAM_PACK_GB)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _script_process(args, timeout=BENCH_SCRIPT_TIMEOUT_S):
    """``python3 <script> <args>`` from the repo, a fresh process: ``(its
    JSON lines, the chain kernels' executions in that process, seconds,
    its stderr's comment lines)``.  Fails unless it exits 0 and every line
    of its standard output is a JSON object."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-c', _SCRIPT_SHIM] + list(args), cwd=REPO,
        timeout=timeout, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    counted = re.findall(r'# kernel_executions (\{.*\})', proc.stderr)
    if proc.returncode != 0 or not counted:
        fail('bench scripts: %s exited %d: %s' % (
            ' '.join(args), proc.returncode, proc.stderr[-2000:]))
    lines = []
    for text in proc.stdout.splitlines():
        try:
            line = json.loads(text)
        except ValueError:
            line = None
        if not isinstance(line, dict):
            fail('bench scripts: %s printed a line that is not a JSON '
                 'object: %r' % (' '.join(args), text[:200]))
        lines.append(line)
    notes = [s for s in proc.stderr.splitlines()
             if s.startswith('# ') and not s.startswith('# kernel_exec')]
    return lines, json.loads(counted[-1]), seconds, notes


def phase_bench_scripts(card, packs, packs_proc):
    """The three root benchmark scripts, each through its command line in a
    fresh process from the repo's directory (``_SCRIPT_SHIM``, which counts
    the chain kernels' executions there):

    1. ``bench_torch.py`` in driver mode: the artifact is in the repo, so
       ``BENCH_DRIVER_LINES`` in that order, the headline last; K1 (the
       dynamic line), K2 (the switch line, grouped merges) and K3 (the
       grouped and stream lines) executed;
    2. ``bench_torch.py --no-pallas --run synthetic_explore/best --batch
       32``: the branchless control, which executes no chain kernel (its
       plain chain takes 0.3 s a batch of 128, too long for the smoke's
       time limit at 95 calls);
    3. ``bench_train_torch.py --iters 12``;
    4. ``bench_stream_torch.py --pack-gb 1 --iters 20 --keep-pack`` on the
       packs ``start_bench_packs`` wrote into ``packs`` (``packs_proc``,
       waited for here), then the same with ``--u8 --fuse 5``, which
       deletes them.

    Every run exits 0; every line parses and its value is finite and
    positive; the metric names are the expected ones in order; the
    training lines' ``g_loss`` and ``emd`` are finite.  Returns the
    ``{"bench_scripts": ...}`` line's numbers and the executions by
    kernel."""
    import math
    import torch
    torch.cuda.empty_cache()    # room for the scripts' processes
    t_phase = time.perf_counter()
    runs, executions = {}, {name: 0 for name in CHAIN_LIBS}

    def script(tag, args, names):
        lines, counts, seconds, notes = _script_process(args)
        got = [line.get('metric') for line in lines]
        if got != list(names):
            fail('bench scripts: %s printed %s, expected %s'
                 % (tag, got, list(names)))
        for line in lines:
            value = line.get('value')
            if not (isinstance(value, (int, float)) and math.isfinite(value)
                    and value > 0):
                fail('bench scripts: %s: %s = %r' % (tag, line['metric'],
                                                     value))
            for key in ('g_loss', 'emd'):
                if key in line and not math.isfinite(line[key]):
                    fail('bench scripts: %s: %s = %r' % (tag, key,
                                                         line[key]))
        for name, n in counts.items():
            executions[name] += n
        runs[tag] = {'lines': lines, 'executions': counts,
                     'seconds': seconds, 'notes': notes}
        say('bench scripts: %s (%.1f s, executions %s): %s' % (
            tag, seconds, json.dumps(counts), json.dumps(lines)))
        return counts

    counts = script('bench_torch', ['bench_torch.py'], BENCH_DRIVER_LINES)
    if min(counts.values()) <= 0:
        fail('bench scripts: bench_torch.py\'s driver mode executed no '
             'launch of a chain kernel: %s' % counts)
    counts = script(
        'bench_torch_no_pallas', ['bench_torch.py', '--no-pallas', '--run',
                                  ARTIFACT_RUN, '--batch', '32'],
        [BENCH_METRIC + '_u8io_trained_jnp'])
    if max(counts.values()) != 0:
        fail('bench scripts: the branchless line executed a chain kernel: '
             '%s' % counts)
    script('bench_train_torch', ['bench_train_torch.py', '--iters', '12'],
           ['train_outer_iter_ms'])
    _, err = packs_proc.communicate(timeout=BENCH_SCRIPT_TIMEOUT_S)
    if packs_proc.returncode != 0:
        fail('bench scripts: writing the packs exited %d: %s'
             % (packs_proc.returncode, err[-2000:]))
    stream = ['bench_stream_torch.py', '--pack-gb', str(BENCH_STREAM_PACK_GB),
              '--iters', '20', '--pack-dir', packs]
    script('bench_stream_torch', stream + ['--keep-pack'],
           ['stream_train_outer_iter_ms'])
    script('bench_stream_torch_u8_fuse5', stream + ['--u8', '--fuse', '5'],
           ['stream_train_outer_iter_ms'])
    if os.listdir(packs):
        fail('bench scripts: bench_stream_torch.py left %s'
             % os.listdir(packs))
    numbers = {'runs': runs, 'executions': executions, 'card': card,
               'phase_s': time.perf_counter() - t_phase}
    say('bench scripts: executions %s; phase %.1f s (budget %d s)' % (
        json.dumps(executions), numbers['phase_s'], BENCH_SCRIPTS_BUDGET_S))
    return numbers, executions


SERVING_TOOLS_BUDGET_S = 150
ARTIFACT_RUN = 'synthetic_explore/best'     # served from ARTIFACT
EXPORT_MISMATCH_LIMIT = 0.02                # export_serving --verify's
WARMUP_TOOL_TIMEOUT_S = 240                 # a warmup_serving process's
REFREEZE_SEED = 9000    # a dropout stream the drive did not serve
STREAM_CONFIG = 'example'               # bench_stream_device's


# runs ``python -m exposure_tpu_torch.tools.<tool> <args>`` in this
# interpreter, then prints K1's executions there on its last line of stderr
_COUNTING_SHIM = '''
import runpy, sys
tool = 'exposure_tpu_torch.tools.' + sys.argv[1]
sys.argv = [tool] + sys.argv[2:]
try:
    runpy.run_module(tool, run_name='__main__', alter_sys=True)
finally:
    from exposure_tpu_torch import kernels
    from exposure_tpu_torch.core.serving_graph import executions
    n = executions(kernels.launch_counts())['dyn_chain']
    print('# k1_launches %d' % n, file=sys.stderr, flush=True)
'''

# put before _COUNTING_SHIM: every config the tool loads gets
# critic_initialization %d, as phase_train cuts its own config
_CRITIC_CUT = '''
import exposure_tpu_torch.utils.config as config
load = config.load_config
def load_config(*args, **kwargs):
    cfg = load(*args, **kwargs)
    cfg.critic_initialization = %d
    return cfg
config.load_config = load_config
'''


def _tool_process(args, timeout, out=None, critic_initialization=None):
    """``python -m exposure_tpu_torch.tools.<args>`` from the repo, a
    fresh process: ``(its JSON report, K1's launches in that process,
    seconds)``.  The report is the ``--out`` file it is given, ``out`` or
    one in a temp dir.  ``critic_initialization``: the cut of the configs
    the tool loads (``_CRITIC_CUT``), none by default."""
    import tempfile
    shim = _COUNTING_SHIM if critic_initialization is None else \
        _CRITIC_CUT % critic_initialization + _COUNTING_SHIM
    with tempfile.TemporaryDirectory() as tmp:
        out = out or os.path.join(tmp, 'report.json')
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-c', shim] + list(args) +
            ['--out', out], cwd=REPO, timeout=timeout,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True)
        seconds = time.perf_counter() - t0
        counted = re.findall(r'# k1_launches (\d+)', proc.stderr)
        if proc.returncode != 0 or not counted:
            fail('tools: %s exited %d: %s' % (
                ' '.join(args), proc.returncode, proc.stderr[-2000:]))
        with open(out) as f:
            return json.load(f), int(counted[-1]), seconds


def _sha256(path):
    import hashlib
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def _swap_serves_b(pipe, policy_b, imgs):
    """After ``drive_refreeze``'s swap: a plan of the swapped pipeline equals
    a fresh pipeline's on policy B bit for bit (same seed and index,
    deterministic cuDNN), and its output is within 1 LSB of the fresh
    one's (the frozen layouts differ, so the routes do).  Returns the max
    LSB."""
    import torch
    from exposure_tpu_torch.core.serving import (
        RetouchPipeline,
        batch_generator,
    )
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    fresh = RetouchPipeline(pipe.cfg, policy_b, device=pipe.device,
                            bf16=True, auto_superset=True,
                            auto_record_batches=pipe._ss_record_batches,
                            use_kernels=True)
    with torch.no_grad(), deterministic_algorithms():
        got = pipe.plan(pipe.proxy(imgs), batch_generator(
            REFREEZE_SEED, 0, pipe.device))
        want = fresh.plan(fresh.proxy(imgs), batch_generator(
            REFREEZE_SEED, 0, pipe.device))
        differ = [name for name, a, b in zip(('ids', 'params', 'mask'),
                                             got, want)
                  if not torch.equal(a, b)]
        a = pipe(imgs, REFREEZE_SEED, 0, device_out=True)
        b = fresh(imgs, REFREEZE_SEED, 0, device_out=True)
    lsb = _lsb(a, b)
    if differ or lsb > 1:
        fail('serving tools: after the swap the plan differs from a fresh '
             'pipeline\'s on run B in %s, output off by %d LSB (bound 1)'
             % (differ, lsb))
    return lsb


def phase_serving_tools(train):
    """The serving and streaming tools of ``exposure_tpu_torch/tools`` on the
    card, each through its entry point, in the repo's directory:

    - ``export_serving``'s command line (``run(argv)``, which ``main``
      wraps): without ``--out`` it refuses to write over the in-repo
      artifact; ``phase_train``'s run (its checkpoints in
      ``train['model_root']``) exported into a temp dir at float32 and
      float16 with ``--verify``: exit 0, every leaf and the step restored,
      float32 with 0 of the ids differing, float16 at most 0.02;
    - ``probe_selected_plan`` at its JAX defaults (the artifact, B=512, 4
      batches, bf16);
    - ``warmup_serving`` in fresh processes, so that its cold start is a
      process's: ``--dynamic``, and the grouped path with ``--superset
      --decompose``;
    - ``bench_serving_split`` on the artifact at B=512 512x512 u8;
    - ``bench_dyn_probe`` at its defaults (``example``, B=256 512x512 u8,
      six planted signatures): K1 within 1 LSB of the branchless chain (a
      fraction of the fast S+ band's values at most ``MAX_OUTLIER_FRAC``
      beyond), K1, K2 and the grouped runner timed;
    - ``drive_refreeze``'s command line (``run(argv)``) from the artifact
      (run A) to ``phase_train``'s run (run B, the same config, 12
      iterations from random weights: another action mix) at its defaults,
      the report written to ``--out``: exit 0, at least one re-freeze, then
      on the pipeline the drive left a plan
      of the swapped pipeline equal to a fresh pipeline's on B bit for bit
      and its output within 1 LSB;
    - ``bench_stream_device`` at its defaults (``example`` at full width,
      chunks of 10).

    K1-K3's launches in the tools run in this process are counted (the
    ``warmup_serving`` processes' are not).  Returns the ``{"serving_tools":
    ...}`` line's numbers."""
    import contextlib
    import copy
    import tempfile
    import torch
    from exposure_tpu_torch.tools import (
        bench_dyn_probe,
        bench_serving_split,
        bench_stream_device,
        drive_refreeze,
        export_serving,
        probe_selected_plan,
    )
    from exposure_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()
    _release()
    dev = torch.device(DEVICE)
    kernels = ('dyn_chain', 'switch_chain', 'static_chain')
    numbers = {'launches_by_tool': {}, 'seconds': {}}

    def counted(name, fn):
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        numbers['seconds'][name] = time.perf_counter() - t0
        counts = read_counts()
        numbers['launches_by_tool'][name] = {k: counts[k] for k in kernels}
        return out

    with contextlib.chdir(REPO), tempfile.TemporaryDirectory() as tmp:
        run, root = train['run'], train['model_root']
        # export_serving's command line: without --out it refuses to write
        # over the in-repo artifact, its default path for ARTIFACT_RUN
        before = _sha256(ARTIFACT)
        try:
            export_serving.main(['--run', ARTIFACT_RUN, '--model-root', root])
            refused = None
        except SystemExit as e:
            refused = str(e.code)
        if refused is None or 'exists' not in refused or \
                _sha256(ARTIFACT) != before:
            fail('serving tools: export_serving without --out did not '
                 'refuse to write over %s (%s)' % (ARTIFACT, refused))
        # phase_train's run, both dtypes, --verify
        exports = {}
        for dtype in ('float32', 'float16'):
            path = os.path.join(tmp, dtype + '.msgpack.gz')
            code, rep = counted('export_serving_' + dtype, lambda: (
                export_serving.run(['--run', run, '--model-root', root,
                                    '--out', path, '--verify',
                                    '--dtype', dtype])))
            exports[dtype] = dict(rep, bytes=os.path.getsize(path),
                                  exit_code=code)
        step = exports['float32']['step']
        if any(e['exit_code'] for e in exports.values()) or \
                exports['float32']['ids_differ'] or \
                exports['float32']['worst_abs'] != 0.0 or \
                exports['float16']['mismatch'] > EXPORT_MISMATCH_LIMIT:
            fail('serving tools: export_serving --verify: %s'
                 % json.dumps(exports))
        numbers['export_serving'] = dict(exports, refused_default_out=True)

        numbers['probe_selected_plan'] = counted(
            'probe_selected_plan',
            lambda: probe_selected_plan.main(['--run', ARTIFACT_RUN]))
        numbers['warmup_serving'] = {
            'dynamic': counted('warmup_serving_dynamic', lambda: (
                _tool_process(('warmup_serving', '--run', ARTIFACT_RUN,
                               '--dynamic'), WARMUP_TOOL_TIMEOUT_S)[0])),
            'grouped_superset': counted('warmup_serving_grouped', lambda: (
                _tool_process(('warmup_serving', '--run', ARTIFACT_RUN,
                               '--superset', '--decompose'),
                              WARMUP_TOOL_TIMEOUT_S)[0]))}
        numbers['bench_serving_split'] = counted(
            'bench_serving_split',
            lambda: bench_serving_split.main(['--run', ARTIFACT_RUN]))
        dyn = counted('bench_dyn_probe', lambda: bench_dyn_probe.main([]))
        if dyn['dyn_max_lsb'] > 1 and \
                dyn['dyn_frac_above_1'] > MAX_OUTLIER_FRAC:
            fail('serving tools: bench_dyn_probe: K1 %d LSB off the '
                 'branchless chain, %.2e of the values above 1'
                 % (dyn['dyn_max_lsb'], dyn['dyn_frac_above_1']))
        numbers['bench_dyn_probe'] = dyn

        # drive_refreeze: the artifact, then phase_train's run
        out = os.path.join(tmp, 'refreeze.json')
        code, refreeze, pipe, policy_b, imgs = counted(
            'drive_refreeze', lambda: drive_refreeze.run([
                '--run-a', ARTIFACT_RUN, '--run-b', run, '--model-root',
                root, '--out', out]))
        with open(out) as f:
            written = json.load(f)
        if code != 0 or refreeze['refreezes'] < 1 or \
                written['refreezes'] != refreeze['refreezes']:
            fail('serving tools: drive_refreeze exited %d: re-freezes %d '
                 '(drift mean %s, threshold %s)' % (
                     code, refreeze['refreezes'],
                     refreeze['final_report']['drift_mean'],
                     pipe._ss_threshold))
        refreeze['swap_max_lsb'] = _swap_serves_b(
            pipe, copy.deepcopy(policy_b), imgs)
        refreeze.pop('trace')
        refreeze['final_report'].pop('layout')     # frozen_slots counts it
        numbers['drive_refreeze'] = refreeze
        del pipe, imgs, policy_b
        _release()
        numbers['bench_stream_device'] = counted(
            'bench_stream_device', lambda: bench_stream_device.bench(
                load_config(STREAM_CONFIG), dev))
    numbers['launches'] = {k: sum(c[k] for c in
                                  numbers['launches_by_tool'].values())
                           for k in kernels}
    if any(numbers['launches'][k] == 0 for k in kernels):
        fail('serving tools: launches %s' % numbers['launches'])
    numbers['phase_s'] = time.perf_counter() - t_phase
    exp, probe = numbers['export_serving'], numbers['probe_selected_plan']
    warm = numbers['warmup_serving']
    split = numbers['bench_serving_split']
    stream = numbers['bench_stream_device']
    say('serving tools: export_serving of %s step %d: float32 %d/%d ids '
        'differ, worst %.3e; float16 mismatch %.4f, worst %.3e (limit %.2f)'
        % (run, step, exp['float32']['ids_differ'],
           exp['float32']['ids_total'], exp['float32']['worst_abs'],
           exp['float16']['mismatch'], exp['float16']['worst_abs'],
           EXPORT_MISMATCH_LIMIT))
    say('serving tools: probe_selected_plan (bf16, B=%d x %d): agreement %s, '
        'per step %s' % (probe['batch'], probe['batches'],
                         probe['agreement'], probe['per_step_agreement']))
    say('serving tools: warmup_serving, fresh processes: dynamic cold %.3f s '
        '(its graph\'s capture %s s), next %s s; grouped superset cold %.3f '
        's, warm-up %s routes in %s s, first warm %.4f s, misses %d, '
        'decomposition %s' % (
            warm['dynamic']['cold_first_batch_s'],
            warm['dynamic'].get('capture_s'),
            warm['dynamic']['warm_next_batches_s'],
            warm['grouped_superset']['cold_first_batch_s'],
            warm['grouped_superset']['warmup']['programs_compiled'],
            warm['grouped_superset']['warmup']['warmup_seconds'],
            warm['grouped_superset']['warm_first_batch_s'],
            warm['grouped_superset']['budget_misses'],
            json.dumps(warm['grouped_superset'].get(
                'first_batch_decomposition'))))
    say('serving tools: bench_serving_split ms: %s' % json.dumps(
        {k: v for k, v in split.items() if k.endswith('_ms')}))
    say('serving tools: bench_dyn_probe: K1 %d LSB (%.2e above 1), K1 %.4f, '
        'K2 %.4f, grouped %.4f ms a batch of %d' % (
            dyn['dyn_max_lsb'], dyn['dyn_frac_above_1'], dyn['dyn_ms'],
            dyn['switch_ms'], dyn['grouped_ms'], dyn['shape'][0]))
    say('serving tools: drive_refreeze %s -> %s: re-freezes %d, first seen at '
        'batch %s (swap at %d), steady img/s A %s, B %s, recovered %s; after '
        'the swap the plan equals a fresh pipeline\'s on B bit for bit, '
        'output %d LSB' % (
            ARTIFACT_RUN, run, refreeze['refreezes'],
            refreeze['refreeze_first_seen_batch'], refreeze['swap_batch'],
            refreeze['steady_imgs_per_s_A'], refreeze['steady_imgs_per_s_B'],
            refreeze['steady_imgs_per_s_recovered'],
            refreeze['swap_max_lsb']))
    say('serving tools: bench_stream_device (example, chunks of %d): %.4f ms '
        'a plain iteration, %.4f a dispatch, first dispatch %.2f s'
        % (stream['fuse'], stream['value'], stream['ms_per_dispatch'],
           stream['first_dispatch_s']))
    say('serving tools: launches %s; phase %.1f s (budget %d s)' % (
        json.dumps(numbers['launches']), numbers['phase_s'],
        SERVING_TOOLS_BUDGET_S))
    return numbers


RESEARCH_PROBES_BUDGET_S = 180
RESEARCH_CONFIG = 'synthetic_explore'   # phase_train's config
RESEARCH_SEEDS = (1, 2)                 # validate_parity's two runs
RESEARCH_ITERS = 12                     # iterations 0-12 of each run
RESEARCH_CRITIC_INIT = 2    # cut from 10: over the budget with 10 (PERF.md)
RESEARCH_N = 256                        # the tools' JAX default
RESEARCH_TOOL_TIMEOUT_S = 300           # a tool process's
RESEARCH_ID_FRAC = 0.01                 # card ids off the CPU's (near ties)
RESEARCH_RESCORE_RTOL = 1e-5    # a critic's logits on the card / CPU, of
                                # their scale (PERF.md: TF32 fails it)
ROUNDED = 1e-4 + 1e-9                   # one unit of a report's rounding

def _finite(*values):
    import numpy as np
    flat = [x for v in values for x in np.atleast_1d(
        np.asarray(v, np.float64)).ravel()]
    return bool(np.isfinite(flat).all())


def _card_draws(seed):
    """The draws of a generator on the card seeded ``seed``, handed to a
    plan on the CPU, so that the CPU plans under the card's dropout."""
    import torch
    from exposure_tpu_torch.utils.draws import Draws

    class CardDraws(Draws):
        def _kept(self, name, value):
            return value.cpu()
    return CardDraws(torch.Generator(device=DEVICE).manual_seed(seed),
                     device=DEVICE)


def _parity_checks(first, again):
    """validate_parity's two passes: both seeds trained through iteration
    RESEARCH_ITERS with finite records; the --skip-trained pass restores
    the same step and scores within the reports' rounding."""
    import numpy as np
    runs = {r['seed']: r for r in first['runs']}
    if sorted(runs) != list(RESEARCH_SEEDS):
        fail('research probes: validate_parity ran seeds %s' % sorted(runs))
    worst = 0.0
    for r in again['runs']:
        t = runs[r['seed']]
        if t['iters'] != RESEARCH_ITERS + 1 or r['iters'] != t['iters'] or \
                not _finite(t['final_emd'], t['final_g_loss'],
                            *t['quality'].values()):
            fail('research probes: validate_parity seed %d: iters %d then '
                 '%d, record %s' % (r['seed'], t['iters'], r['iters'],
                                    json.dumps(t)))
        for key, v in t['quality'].items():
            worst = max(worst, float(np.abs(
                np.subtract(v, r['quality'][key], dtype=np.float64)).max()))
        if r['trajectories'] != t['trajectories']:
            fail('research probes: --skip-trained planned other '
                 'trajectories for seed %d' % r['seed'])
    if worst > ROUNDED:
        fail('research probes: --skip-trained scored %.4g off the trained '
             'pass' % worst)
    return worst


def _diversity_checks(report, root):
    """diagnose_diversity's argmax section on the card against ``analyze``
    on the CPU in this process, on the same inputs and the card's dropout
    draws: the ids each key's plan picks (at most RESEARCH_ID_FRAC differ),
    the usage fractions and ``pdf_top1_mean``."""
    import random
    import numpy as np
    import torch
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.rollout import rollout
    from exposure_tpu_torch.tools.diagnose_diversity import analyze
    from exposure_tpu_torch.utils.config import load_config
    cfg = load_config(RESEARCH_CONFIG)
    cfg.name = report['run']
    card = Evaluator(cfg, model_root=root, device=DEVICE)
    cpu = Evaluator(cfg, state=card.state.to('cpu'), device='cpu')
    random.seed(0)          # the tool's --seed
    inputs, _ = cfg.fake_data_provider_test().get_next_batch(RESEARCH_N)
    want = analyze(cfg, cpu, inputs, keys=report['argmax']['keys'],
                   generator=_card_draws)['argmax']
    got = report['argmax']
    differ = total = 0
    x = torch.from_numpy(np.asarray(inputs, np.float32))
    with torch.no_grad():
        for k in range(got['keys']):
            a = rollout(card.policy, x.to(DEVICE), torch.Generator(
                device=DEVICE).manual_seed(1000 + k), cfg=cfg,
                filters=card.filters, is_train=0).filter_ids.cpu()
            b = rollout(cpu.policy, x, _card_draws(1000 + k), cfg=cfg,
                        filters=cpu.filters, is_train=0).filter_ids
            differ += int((a != b).sum())
            total += a.numel()
    usage = max(abs(got['filter_usage_frac'][f] - v)
                for f, v in want['filter_usage_frac'].items())
    top1 = abs(got['pdf_top1_mean'] - want['pdf_top1_mean'])
    if differ > RESEARCH_ID_FRAC * total or \
            usage > RESEARCH_ID_FRAC + ROUNDED or top1 > ROUNDED:
        fail('research probes: diagnose_diversity on the card against the '
             'CPU: %d of %d ids differ, usage %.4f apart, pdf_top1_mean '
             '%.4f apart' % (differ, total, usage, top1))
    return {'ids_differ': differ, 'ids_total': total,
            'usage_frac_max_diff': usage, 'pdf_top1_mean_diff': top1,
            'cpu_argmax': want}


def _critic_checks(report, runs, root):
    """probe_critic_family's 3x5 matrix, finite, its consensus ranking a
    permutation of the runs' outputs; each run's outputs retouched here
    on the card again (K1) and scored by its critic on the card and on the
    CPU: each image's logit within RESEARCH_RESCORE_RTOL of the largest
    logit's magnitude, and the CPU's mean within RESEARCH_RESCORE_RTOL
    relative (or the report's rounding) of the tool's own score."""
    import math
    import random
    import numpy as np
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.serving import batch_generator
    from exposure_tpu_torch.utils.config import load_config
    matrix = report['critic_score_matrix']
    names = ['targets', 'inputs'] + ['out:' + r for r in runs]
    if sorted(matrix) != sorted('critic:' + r for r in runs) or any(
            sorted(row) != sorted(names) or not _finite(
                *[v['mean'] for v in row.values()],
                *[v['std'] for v in row.values()])
            for row in matrix.values()) or \
            sorted(report['consensus_ranking']) != sorted(names[2:]):
        fail('research probes: probe_critic_family: matrix %s, ranking %s'
             % (json.dumps(matrix), report['consensus_ranking']))
    random.seed(0)          # the tool's --seed
    cfg0 = load_config(RESEARCH_CONFIG)
    inputs, _ = cfg0.fake_data_provider_test().get_next_batch(RESEARCH_N)
    inputs = np.clip(inputs, 0.0, 1.0).astype(np.float32)
    rescored = {}
    for run in runs:
        cfg = load_config(RESEARCH_CONFIG)
        cfg.name = run
        card = Evaluator(cfg, model_root=root, device=DEVICE)
        traj, _ = card.plan_trajectory(inputs, batch_generator(0, 0, DEVICE))
        with _NoPlainVersions():
            out = np.clip(card.retouch(inputs, traj), 0.0, 1.0)
        cpu = Evaluator(cfg, state=card.state.to('cpu'), device='cpu')
        want = cpu.critic_logits(out)
        got = card.critic_logits(out)
        mine = float(want.mean())
        tool = matrix['critic:' + run]['out:' + run]['mean']
        per_image = float(np.abs(got - want).max() / np.abs(want).max())
        rescored[run] = {'card_tool': tool, 'cpu_rescore': mine,
                         'card_here': float(got.mean()),
                         'per_image_rel': per_image}
        if per_image > RESEARCH_RESCORE_RTOL or not math.isclose(
                tool, mine, rel_tol=RESEARCH_RESCORE_RTOL, abs_tol=ROUNDED):
            fail('research probes: critic %s scores its outputs %.4f on the '
                 'card, %.6f rescored on the CPU, its logits %.3g of their '
                 'scale apart' % (run, tool, mine, per_image))
    return rescored


def _selector_checks(report, pools):
    """validate_selector: comp2 shipped, every pool read with two valid runs
    in the report and in each selector's aggregate."""
    kept = sorted(report['pools'])
    if report['shipped'] != 'comp2' or kept != sorted(pools) or any(
            a['pools'] != len(kept) for a in report['aggregate'].values()):
        fail('research probes: validate_selector kept pools %s of %s, '
             'aggregate %s' % (kept, sorted(pools),
                               json.dumps(report['aggregate'])))


def _promoted_checks(report, root, runs):
    """select_policy --promote best: the link names the winner that
    ``winner_by`` names; an Evaluator on ``<config>/best`` restores that
    run's checkpoint (not the in-repo artifact of the same name) and
    replays one batch through K1."""
    import numpy as np
    import torch
    from exposure_tpu_torch.core.artifacts import (
        artifact_path,
        flax_to_state_dict,
        has_checkpoint,
        load_artifact,
    )
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.serving import batch_generator, proxy_resize
    from exposure_tpu_torch.utils.config import load_config
    link = os.path.join(root, RESEARCH_CONFIG, 'best')
    by = report['winner_by']
    named = report['comp2']['ranking'][0] if by == 'comp2' else \
        report['consensus_ranking'][0][len('out:'):]
    target = os.readlink(link) if os.path.islink(link) else None
    if target != named or report['winner'] != named or named not in runs:
        fail('research probes: best -> %s, winner %s by %s (%s)' % (
            target, report['winner'], by, named))
    run = RESEARCH_CONFIG + '/best'
    if not has_checkpoint(run, root):
        fail('research probes: %s has no checkpoint through the link' % run)
    cfg = load_config(RESEARCH_CONFIG)
    cfg.name = run
    best = Evaluator(cfg, model_root=root, device=DEVICE)
    cfg.name = RESEARCH_CONFIG + '/' + named
    src = Evaluator(cfg, model_root=root, device=DEVICE)
    differ = [k for k, v in src.state.tensors().items()
              if not torch.equal(best.state.tensors()[k], v)]
    # the in-repo artifact of the same name, which the lookup must not take
    shipped = os.path.join(REPO, artifact_path(run))
    shipped = flax_to_state_dict(load_artifact(shipped)['gen_params']) \
        if os.path.exists(shipped) else None
    if differ or best.state.step != src.state.step or shipped and all(
            torch.equal(best.state.gen_params[k].cpu(), v)
            for k, v in shipped.items()):
        fail('research probes: %s restored other weights than %s (%d '
             'tensors differ) or the artifact\'s' % (run, named, len(differ)))
    imgs = np.random.default_rng(SEED + 12).random(
        (8, RES, RES, 3), dtype=np.float32)
    proxies = proxy_resize(torch.from_numpy(imgs), cfg.source_img_size)
    traj, _ = best.plan_trajectory(proxies, batch_generator(SEED, 0, DEVICE))
    reset_counts()
    with _NoPlainVersions():
        out = best.retouch(imgs, traj)
    torch.cuda.synchronize()
    launches = read_counts()['dyn_chain']
    if launches != 1 or out.shape != imgs.shape or \
            not np.isfinite(out).all():
        fail('research probes: the promoted run replayed %s with %d K1 '
             'launches' % (out.shape, launches))
    return {'step': best.state.step, 'tensors_equal': len(
        src.state.tensors()), 'replay_k1_launches': launches}


def phase_research_probes(training):
    """The research probes of ``exposure_tpu_torch/tools`` on the card, each
    through its command line in a fresh process (``_tool_process``, which
    also counts K1's launches there), in ``phase_train``'s model root
    (``training['model_root']``, beside its run ``synthetic_explore/smoke``),
    reports into a temp dir:

    (a) ``validate_parity`` trains seeds 1 and 2 of ``synthetic_explore``
        at full width through iteration 12 (``critic_initialization`` cut
        to ``RESEARCH_CRITIC_INIT``, so that iterations 2-12 run the
        config's fused dispatch) and scores them (n 256), then
        ``--skip-trained`` restores both: ``iters`` equal, quality within
        the reports' rounding;
    (b) ``diagnose_diversity`` on ``parity-seed1`` (n 256, 4 keys): its
        argmax section against ``analyze`` on the CPU here, on the card's
        dropout draws (``_diversity_checks``);
    (c) ``probe_critic_family`` over ``smoke``, ``parity-seed1`` and
        ``parity-seed2`` (``_critic_checks``);
    (d) ``validate_selector`` on the repo's ``PARITY_*.json`` and (a)'s
        report (``_selector_checks``);
    (e) ``select_policy --truth <(a)> --promote best`` over the three runs
        (``_promoted_checks``);
    (f) ``ablate_w_usage --iters 12 --drop-filters C`` (the same cut): a
        7-filter ``synthetic`` run at full width; no ``C`` in the usage, the
        W fractions in [0, 1].

    Returns the ``{"research_probes": ...}`` line's numbers."""
    import glob
    import tempfile
    t_phase = time.perf_counter()
    _release()
    root = training['model_root']
    smoke = training['run']
    runs = [smoke] + ['%s/parity-seed%d' % (RESEARCH_CONFIG, s)
                      for s in RESEARCH_SEEDS]
    numbers = {'seconds': {}, 'k1_launches': {},
               'critic_initialization_cut_to': RESEARCH_CRITIC_INIT}

    def tool(name, args, out, cut=None):
        report, k1, seconds = _tool_process(
            (name,) + tuple(args), RESEARCH_TOOL_TIMEOUT_S, out, cut)
        numbers['seconds'][name] = numbers['seconds'].get(name, 0.0) + \
            seconds
        numbers['k1_launches'][name] = numbers['k1_launches'].get(
            name, 0) + k1
        return report

    with tempfile.TemporaryDirectory() as tmp:
        def at(name):
            return os.path.join(tmp, name)

        parity = ('--config', RESEARCH_CONFIG, '--seeds') + tuple(
            map(str, RESEARCH_SEEDS)) + ('--iters', str(RESEARCH_ITERS),
                                         '--n-eval', str(RESEARCH_N),
                                         '--model-root', root)
        first = tool('validate_parity', parity, at('parity.json'),
                     RESEARCH_CRITIC_INIT)
        again = tool('validate_parity', parity + ('--skip-trained',),
                     at('parity_again.json'), RESEARCH_CRITIC_INIT)
        numbers['validate_parity'] = {
            'runs': first['runs'], 'summary': first['summary'],
            'skip_trained_max_diff': _parity_checks(first, again)}

        diversity = tool('diagnose_diversity', (
            '--run', runs[1], '--n', str(RESEARCH_N), '--keys', '4',
            '--model-root', root), at('diversity.json'))[-1]
        numbers['diagnose_diversity'] = dict(
            diversity, card_against_cpu=_diversity_checks(diversity, root))

        probe = tool('probe_critic_family', ('--runs',) + tuple(runs) + (
            '--n', str(RESEARCH_N), '--model-root', root), at('probe.json'))
        reset_counts()
        rescored = _critic_checks(probe, runs, root)
        numbers['k1_launches']['critic_rescore_here'] = \
            read_counts()['dyn_chain']
        numbers['probe_critic_family'] = {
            'critic_score_matrix': probe['critic_score_matrix'],
            'consensus_ranking': probe['consensus_ranking'],
            'filter_usage': probe['filter_usage'], 'rescored': rescored}

        pools = sorted(glob.glob(os.path.join(REPO, 'PARITY_*.json'))) + \
            [at('parity.json')]
        selector = tool('validate_selector', ('--pools',) + tuple(pools) + (
            '--min-n', '2'), at('selector.json'))
        _selector_checks(selector, pools)
        numbers['validate_selector'] = {
            'pools': len(selector['pools']),
            'comp2': selector['aggregate']['comp2'],
            'this_run_comp2': selector['pools'][at('parity.json')][
                'selectors']['comp2']}

        names = [r.split('/', 1)[1] for r in runs]
        select = tool('select_policy', (
            '--config', RESEARCH_CONFIG, '--runs') + tuple(names) + (
            '--n', str(RESEARCH_N), '--model-root', root, '--truth',
            at('parity.json'), '--promote', 'best'), at('select.json'))
        promoted = _promoted_checks(select, root, names)
        numbers['k1_launches']['promoted_replay_here'] = \
            promoted['replay_k1_launches']
        numbers['select_policy'] = dict(
            {k: select[k] for k in (
                'verdict', 'winner', 'winner_by', 'family_separation',
                'consensus_ranking', 'comp2', 'spearman_vs_truth',
                'truth_winner') if k in select}, promoted=promoted)

        ablation = tool('ablate_w_usage', (
            '--iters', str(RESEARCH_ITERS), '--n', str(RESEARCH_N),
            '--drop-filters', 'C', '--model-root', at('ablation')),
            at('ablation.json'), RESEARCH_CRITIC_INIT)
        usage = ablation['argmax']['filter_usage_frac']
        w = [usage.get('W', 0.0)] + [
            v for cast in ablation['gray_shift_ablation'].values()
            for v in cast.values()]
        if ablation['iters'] != RESEARCH_ITERS + 1 or 'C' in usage or \
                len(usage) != 7 or not all(0.0 <= v <= 1.0 for v in w):
            fail('research probes: ablate_w_usage: %s' % json.dumps(ablation))
        numbers['ablate_w_usage'] = ablation
    numbers['k1_launches_total'] = sum(numbers['k1_launches'].values())
    if not numbers['k1_launches_total']:
        fail('research probes: K1 never launched')
    numbers['phase_s'] = time.perf_counter() - t_phase
    by = numbers['select_policy']
    say('research probes: validate_parity seeds %s at full width through '
        'iteration %d (critic_initialization cut to %d, then the fused '
        'dispatch): avg_after %s, final EMD %s; --skip-trained within %.2g'
        % (list(RESEARCH_SEEDS), RESEARCH_ITERS, RESEARCH_CRITIC_INIT,
            [r['quality']['avg_after'] for r in first['runs']],
            [r.get('final_emd') for r in first['runs']],
            numbers['validate_parity']['skip_trained_max_diff']))
    div = numbers['diagnose_diversity']
    say('research probes: diagnose_diversity %s: key flips %.4f, pdf top-1 '
        '%.4f; card against CPU on the card\'s draws: %d of %d ids differ, '
        'pdf_top1_mean %.2g apart; W on casts %s' % (
            runs[1], div['argmax']['key_flip_frac'],
            div['argmax']['pdf_top1_mean'],
            div['card_against_cpu']['ids_differ'],
            div['card_against_cpu']['ids_total'],
            div['card_against_cpu']['pdf_top1_mean_diff'],
            json.dumps(div['gray_shift_ablation'])))
    say('research probes: probe_critic_family consensus %s; own-output '
        'scores, card against CPU rescore: %s' % (
            probe['consensus_ranking'], json.dumps(rescored)))
    say('research probes: validate_selector %d pools, comp2 %s; '
        'select_policy verdict %s, winner %s by %s, promoted run restored '
        'from its checkpoint (step %d, %d tensors equal) and replayed '
        'through K1' % (
            numbers['validate_selector']['pools'],
            json.dumps(numbers['validate_selector']['comp2']), by['verdict'],
            by['winner'], by['winner_by'], promoted['step'],
            promoted['tensors_equal']))
    say('research probes: ablate_w_usage -noC, 7 filters: usage %s, W on '
        'casts %s' % (json.dumps(usage),
                      json.dumps(ablation['gray_shift_ablation'])))
    say('research probes: seconds %s; K1 launches %s (%d); phase %.1f s '
        '(budget %d s)' % (
            json.dumps(numbers['seconds']), json.dumps(
                numbers['k1_launches']), numbers['k1_launches_total'],
            numbers['phase_s'], RESEARCH_PROBES_BUDGET_S))
    return numbers


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
        got = _launch_checked('dyn_chain', apply_filter_chain_dynamic, img,
                              ids, params, filters, **kw)
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
        '%s at full width, dropout off, float32, the CPU\'s draws '
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
    by_stage = _k1_by_stage(pipe)
    with _NoPlainVersions():
        pipe.warmup(batch, seed=SEED)     # captures the batch's graph
        by_stage()
        reset_counts()
        out = pipe(batch, SEED, 0, device_out=True)
    torch.cuda.synchronize()
    counts = read_counts()
    by_stage = by_stage()
    pipe.release()
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


def phase_train(model_root):
    """Training on the card: one outer iteration against the CPU; the
    Trainer at full width through iterations 0-11, timed; resume; the
    trained policy exported and served through K1.  The run's checkpoints
    stay in ``model_root`` for ``phase_serving_tools``.  Returns what the
    summary line reports of it, with ``run`` and ``model_root``."""
    import contextlib
    from exposure_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()
    report = _train_check()
    cfg = load_config(TRAIN_CONFIG)
    cfg.name = TRAIN_CONFIG + '/smoke'
    cfg.checkpoint_interval = TRAIN_CKPT_INTERVAL
    # the plain dispatch with its bookkeeping at once, as this phase has
    # timed it since it began (phase_fused times the fused one)
    cfg.update(iters_per_dispatch=1, dispatch_pipeline_depth=0)
    tmp = model_root
    with contextlib.chdir(REPO):
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
    numbers.update(run=cfg.name, model_root=tmp)
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
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
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
    with deterministic_algorithms():
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
                          # the plain dispatch, so that this turn reads as
                          # it always has; gloo's all-reduce goes through
                          # the host and cannot be captured, so a gloo
                          # world is never fused (nccl's fused turn is
                          # _fused_worlds)
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


FUSED_WORLD_TURNS = ('plain', 'fused', 'fused', 'plain')


def _fused_worlds(root, work, mesh, world, backend, tag):
    """The fused dispatch on ``world`` ranks over ``backend`` and on world
    1 (``mesh``, in this process): ``example`` at full width with
    ``iters_per_dispatch`` ``FUSED_CHUNK`` and the bookkeeping 2 chunks
    behind, as ``phase_fused`` trains it, through
    ``tools/parallel_check.py::fused_rank`` on each.  Fails unless on
    every rank the fused run equals the plain one bit for bit, the ranks'
    parameters agree after every chunk and the resume from the pipelined
    checkpoint is bit for bit.  Only ``nccl`` is captured: a ``gloo`` world
    on the card keeps ``iters_per_dispatch`` 1 (``_worlds_in_turns``).
    Returns the ms per plain iteration, fused and plain, of both worlds."""
    from exposure_tpu_torch.data.fivek import FiveKDataProvider
    from exposure_tpu_torch.parallel.launch import spawn_ranks
    from exposure_tpu_torch.tools import parallel_check as pc
    job = dict(config=PARALLEL_CONFIG, root=root, seed=SEED,
               chunk=FUSED_CHUNK, first=DATA_CRITIC_INIT,
               last_iter=FUSED_LAST_ITER, turns=FUSED_WORLD_TURNS,
               knobs=dict(critic_initialization=DATA_CRITIC_INIT,
                          checkpoint_interval=FUSED_CKPT_INTERVAL,
                          iters_per_dispatch=FUSED_CHUNK,
                          dispatch_pipeline_depth=2))
    FiveKDataProvider._raw_image_pack = None
    one = pc.fused_rank(mesh, dict(
        job, name='%s/fused_world_1' % PARALLEL_CONFIG,
        model_root=os.path.join(work, 'fused-one')))
    FiveKDataProvider._raw_image_pack = None
    _release()
    ranks = spawn_ranks(pc.fused_rank, world, (dict(
        job, name='%s/fused_world_%d' % (PARALLEL_CONFIG, world),
        model_root=os.path.join(work, 'fused-many')),), device=DEVICE,
        backend=backend, deadline_s=PARALLEL_DEADLINE_S, rendezvous_dir=work)
    FiveKDataProvider._raw_image_pack = None
    for run in [one] + ranks:
        bad = {k: run[k] for k in ('fused_vs_plain_differing',
                                   'restored_differing', 'resumed_differing')
               if run[k]}
        if bad or run['resume_step'] != FUSED_CKPT_INTERVAL or \
                not run['params_equal_every_chunk'] or \
                run['captures'] != int(DEVICE == 'cuda'):
            fail('%s: fused on world %d rank %d: differing %s, resume step '
                 '%s, parameters equal across the ranks after every chunk '
                 '%s, graphs captured %d' % (
                     tag, run['world'], run['rank'], bad, run['resume_step'],
                     run['params_equal_every_chunk'], run['captures']))
    key = 'world_%d_%s' % (world, backend)
    return {
        'ms_per_plain_iteration': {
            kind: {'world_1_%s' % mesh.backend: _median(
                one['ms_per_plain_iteration'][kind]),
                key: _median([_median(r['ms_per_plain_iteration'][kind])
                              for r in ranks])}
            for kind in ('fused', 'plain')},
        'ms_all': {'world_1': one['ms_per_plain_iteration'],
                   key + '_by_rank': [r['ms_per_plain_iteration']
                                      for r in ranks]},
        'turns': FUSED_WORLD_TURNS, 'chunk': FUSED_CHUNK,
        'iterations': [DATA_CRITIC_INIT, FUSED_LAST_ITER],
        'tensors_compared': one['tensors_compared'],
        'chunks_compared': ranks[0]['chunks_compared'],
        'replays': {'world_1': one['replays'],
                    key: [r['replays'] for r in ranks]},
    }


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


def _dryrun_numbers(dry):
    """What the ``parallel`` and ``world`` lines report of a dry run; its
    fused entries' ``g_loss`` by iteration, or why they did not run."""
    keys = ('g_loss', 'emd', 'streaming_g_loss', 'served', 'grouped_max_lsb',
            'resume_equal', 'pad_ok', 'superset_ok', 'superset_max_lsb',
            'map_batches_ok', 'dyn_ok', 'dyn_max_lsb', 'pipeline_max_lsb',
            'superset_route', 'launches', 'launches_by_rank')
    optional = ('fused_g_loss', 'stream_fused_g_loss', 'fused_not_run')
    return dict({k: dry[k] for k in keys},
                **{k: dry[k] for k in optional if k in dry})


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
    numbers['dryrun'] = _dryrun_numbers(dry)
    numbers['dryrun_s'] = time.perf_counter() - t0
    numbers['launches'] = dry['launches']
    if DEVICE == 'cuda' and any(v == 0 for v in dry['launches'].values()):
        fail('parallel: the dry run\'s serving launched %s'
             % dry['launches'])
    say('parallel: (c) dryrun_multigpu(%d) on the card, %.1f s: served %s '
        'u8 as %d + %d; max LSB against the plain chain: dynamic %d, '
        'grouped %d, superset %d (bound 2); the gathered output against '
        'one process\'s pipeline %d (bound 1); launches %s; the fused '
        'entries: %s' % (
            PARALLEL_WORLD, numbers['dryrun_s'], dry['served'],
            BATCH // PARALLEL_WORLD, BATCH // PARALLEL_WORLD,
            dry['dyn_max_lsb'], dry['grouped_max_lsb'],
            dry['superset_max_lsb'], dry['pipeline_max_lsb'],
            json.dumps(dry['launches']),
            'not run over gloo on one card (%s)' % dry['fused_not_run']
            if 'fused_not_run' in dry else 'ran'))
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
FUSED_TURNS = ('plain', 'fused', 'fused', 'plain')


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


def _pc():
    """``tools/parallel_check.py``, where the fused runs' helpers live
    (``Rows``, ``reset``, ``outcome``, ``differing``, ``dispatch``)."""
    from exposure_tpu_torch.tools import parallel_check
    return parallel_check


def _fused_turns(trainer, snap):
    """ms per plain iteration of ``FUSED_CHUNK`` iterations from the
    snapshot, fused and plain in turns (``FUSED_TURNS``): CUDA events
    around the dispatch, and the host clock to its end; each turn from the
    same state and pool."""
    import torch
    first = DATA_CRITIC_INIT
    out = {'fused': [], 'plain': [], 'fused_wall': [], 'plain_wall': []}
    for kind in FUSED_TURNS:
        _pc().reset(trainer, snap, FUSED_CHUNK, 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        _pc().dispatch(trainer, kind, first, FUSED_CHUNK)
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
    _pc().reset(trainer, snap, FUSED_CHUNK, 0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as flagged:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            _pc().dispatch(trainer, kind, DATA_CRITIC_INIT, FUSED_CHUNK)
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
    _pc().reset(trainer, snap, FUSED_CHUNK, 0)
    return profile_calls(
        lambda: _pc().dispatch(trainer, kind, DATA_CRITIC_INIT, FUSED_CHUNK),
        FUSED_CHUNK, DEVICE)


def _fused_runs(trainer, snap, numbers, tag):
    """``tools/parallel_check.py::bit_runs`` from the snapshot after the
    special iterations, under deterministic cuDNN: through iteration
    ``FUSED_LAST_ITER`` twice plain (bookkeeping at once; the second the
    control), then fused in ``FUSED_CHUNK``-iteration chunks (bookkeeping 2
    behind).  Fails unless all three agree bit for bit.  Returns the fused
    run's outcome and the rows."""
    outs, rows = _pc().bit_runs(trainer, snap, FUSED_CHUNK, DATA_CRITIC_INIT,
                                FUSED_LAST_ITER,
                                runs=('plain', 'control', 'fused'))
    fused, control = (_pc().differing(outs[k], outs['plain'])
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
            _pc().reset(trainer, snap, FUSED_CHUNK, 0)
            t0 = time.perf_counter()
            _pc().dispatch(trainer, 'fused', DATA_CRITIC_INIT, FUSED_CHUNK)
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
            _pc().reset(trainer, snap, 1, 0)
            _pc().dispatch(trainer, 'plain', DATA_CRITIC_INIT, FUSED_CHUNK)
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
                step, restored, resumed = _pc().resume_check(
                    again, at12, fused, FUSED_CKPT_INTERVAL,
                    DATA_CRITIC_INIT, FUSED_LAST_ITER)
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
                    grouped_rows = _pc().Rows(grouped)
                    _pc().reset(grouped, snap, FUSED_CHUNK, 2)
                    with deterministic_algorithms():
                        grouped.train(last_iter=FUSED_LAST_ITER)
                    nccl = _pc().differing(_pc().outcome(
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
    0 in turns (``_worlds_in_turns``); the dry run over ``nccl``, one card a
    rank, its fused entries captured; then the fused dispatch on both
    worlds (``_fused_worlds``), in the FiveK tree of ``phase_data`` made
    anew in a temp dir.  Each part prints its line as it ends; then the
    ``{"world": ...}`` line and the device line."""
    import contextlib
    import tempfile
    import torch
    card = phase_card()
    sys.path.insert(0, REPO)
    from exposure_tpu_torch.parallel.dryrun import dryrun_multigpu
    from exposure_tpu_torch.parallel.mesh import data_parallel_mesh
    if torch.cuda.device_count() < n:
        fail('world: %d cards asked for, %d here'
             % (n, torch.cuda.device_count()))
    t0 = time.perf_counter()
    phase_build()       # the dry run's serving launches K1-K3 on every rank
    with tempfile.TemporaryDirectory() as root, \
            tempfile.TemporaryDirectory() as work:
        with contextlib.chdir(root):
            _fivek_tree(root)
        mesh = data_parallel_mesh(1, backend='nccl', device='cuda:0', rank=0,
                                  init_file=os.path.join(work, 'rdv-one'))
        try:
            one, ranks, seconds = _worlds_in_turns(root, work, mesh, n,
                                                   'nccl', 'world')
            numbers = dict(_world_numbers(one, ranks, n, 'nccl'), card=card,
                           world_s=seconds)
            say('world: %s at full width on %d nccl ranks, one a card: '
                'parameters equal across the ranks after each of %d '
                'iterations, finite metrics, one metrics.jsonl, a resume '
                'from checkpoint %d bit for bit; world 1 likewise, in turns'
                % (PARALLEL_CONFIG, n, numbers['params_equal_iterations'],
                   numbers['resume_step']))
            # the dry run over nccl, one card a rank: its fused entries are
            # captured (over gloo on one card, phase_parallel's, they
            # cannot be)
            _release()
            dry = dryrun_multigpu(n, device=DEVICE, backend='nccl',
                                  serve_batch=BATCH, serve_hw=(RES, RES),
                                  artifact=os.path.join(REPO, ARTIFACT),
                                  deadline_s=PARALLEL_DEADLINE_S,
                                  work_dir=work)
            if 'fused_not_run' in dry:
                fail('world: the dry run over nccl did not run its fused '
                     'entries: %s' % dry['fused_not_run'])
            numbers['dryrun'] = _dryrun_numbers(dry)
            say('world: dryrun_multigpu(%d) over nccl, one card a rank: '
                'fused entries g_loss %s and %s, served max LSB dynamic %d, '
                'grouped %d, superset %d; launches %s' % (
                    n, dry['fused_g_loss'], dry['stream_fused_g_loss'],
                    dry['dyn_max_lsb'], dry['grouped_max_lsb'],
                    dry['superset_max_lsb'], json.dumps(dry['launches'])))
            _release()
            fused = _fused_worlds(root, work, mesh, n, 'nccl', 'world')
        finally:
            mesh.close()
    numbers.update(fused=fused, phase_s=time.perf_counter() - t0)
    say('world: fused, chunks of %d (iterations %d-%d): on each of %d '
        'ranks and on world 1 the fused run equals the plain one bit for '
        'bit (%d state tensors, the pool, every metric row; deterministic '
        'cuDNN), the parameters equal across the ranks after each of %d '
        'chunks, the resume from the pipelined checkpoint %d bit for bit; '
        'ms per plain iteration %s' % (
            FUSED_CHUNK, DATA_CRITIC_INIT, FUSED_LAST_ITER, n,
            fused['tensors_compared'], fused['chunks_compared'],
            FUSED_CKPT_INTERVAL,
            json.dumps(fused['ms_per_plain_iteration'])))
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
    finish_build = start_build()
    with tempfile.TemporaryDirectory() as train_root, \
            tempfile.TemporaryDirectory() as packs:
        packs_proc = start_bench_packs(packs)
        try:
            # the phases that need no K2 run while its library compiles
            packed = phase_bf16_ops()
            resize = phase_resize(card)
            k1_worst, k1_timing, k1_errors = phase_k1()
            k3_worst, k3_timing = phase_k3()
            probe_worst = phase_probes()
            phase_small_reference()
            evaluation = phase_evaluate()
            # phase_train's run stays for phase_serving_tools
            training = phase_train(train_root)
            variants = finish_build()
            k2_worst, k2_timing = phase_k2()
            probe_counts, probe_timing, tool_worst, floor_gb_s, copies = \
                phase_probe_tools()
            for key, v in tool_worst.items():   # the largest of both phases
                probe_worst[key] = max(probe_worst[key], v)
            tool_counts, tables = phase_tools()
            card_tools = phase_card_tools(tables)
            with tempfile.TemporaryDirectory() as fivek_root:
                data = phase_data(fivek_root)
                parallel = phase_parallel(fivek_root, card)
                fused = phase_fused(fivek_root)
            rng = np.random.default_rng(SEED)
            batches = [torch.from_numpy(_images(rng, BATCH, RES, RES))
                       .to(DEVICE) for _ in range(MAIN_BATCHES)]
            torch.cuda.synchronize()
            k1_main, _, _, resize_main = phase_main_path(batches)
            totals, _ = phase_modes(batches)
            phase_planted(batches[0])
            phase_bf16_plan(batches)
            graph_numbers, graph_launches = phase_serving_graph(batches)
            del batches
            scripts, by_scripts = phase_bench_scripts(card, packs, packs_proc)
            tools = phase_serving_tools(training)
            research = phase_research_probes(training)
        finally:
            if packs_proc.poll() is None:     # a phase failed first
                packs_proc.kill()
                packs_proc.wait()
    say('total %.1f s' % (time.perf_counter() - t_start))
    shape = '[%d, %d, %d, 3] u8, K=5' % (BATCH, RES, RES)
    # the paths: main, modes, probe tools, tools
    totals.update(probe_counts)
    totals.update(tool_counts)

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

    def resize_entry(cases, launches, **extra):
        """The proxy resize at the main path's shape, each case below;
        launches counted on the main path, the modes and tools of this
        process and the graph phase (the dry run's, the scripts' and the
        tool processes' wrappers count the chain kernels only)."""
        main = cases['%dx%dx%d' % (BATCH, RES, RES)]
        return dict({
            'name': 'proxy_resize', 'route': 'cuda',
            'source': 'exposure_tpu_torch/csrc/proxy_resize.cu',
            'replaces': 'no TPU kernel (jax.image.resize is XLA\'s); on '
                        'the card the u8 -> f32 copies and F.interpolate',
            'launches': launches,
            'max_abs_err': max(c['max_abs_err'] for c in cases.values()),
            'max_lsb_u8': None, 'ms': main['ms'],
            'plain_ms': main['plain_ms'], 'bound_ms': main['bound_ms'],
            'bound_by': main['bound_by'], 'flops': main['flops'],
            'bytes': main['bytes'], 'library_ms': main['library_ms'],
            'cases': cases,
            'shape': '[%d, %d, %d, 3] u8 -> [%d, 64, 64, 3] f32'
                     % (BATCH, RES, RES, BATCH), 'card': card}, **extra)

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
    say(json.dumps({'serving_tools': dict(tools, card=card)}))
    say(json.dumps({'research_probes': dict(research, card=card)}))
    say(json.dumps({'serving_graph': dict(graph_numbers, card=card)}))
    say(json.dumps({'bench_scripts': scripts}))
    say(json.dumps({'card_tools': dict(card_tools, card=card)}))
    served = parallel['launches']
    by_tools = tools['launches']
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
                    fused['launches_serve'] + by_tools['dyn_chain'] +
                    research['k1_launches_total'] +
                    graph_launches['dyn_chain'] + by_scripts['dyn_chain'],
                    'dyn_chain', 'dyn_chain_kernel',
                    launches_main_path_replay=k1_main['replay'],
                    launches_other_paths=totals['dyn_chain'],
                    launches_serving_graph=graph_launches['dyn_chain'],
                    launches_bench_scripts=by_scripts['dyn_chain'],
                    launches_evaluation=evaluation['launches'],
                    launches_training_serve=training['launches_serve'],
                    launches_streaming_serve=data['launches_serve'],
                    launches_parallel_serve=served['dyn_chain'],
                    launches_fused_serve=fused['launches_serve'],
                    launches_serving_tools=by_tools['dyn_chain'],
                    launches_research_probes=research['k1_launches_total']),
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
                    totals['switch_chain'] + served['switch_chain'] +
                    by_tools['switch_chain'] + graph_launches['switch_chain'] +
                    by_scripts['switch_chain'] + card_tools['launches'],
                    'switch_chain', 'switch_chain_f32',
                    launches_card_tools=card_tools['launches'],
                    launches_serving_graph=graph_launches['switch_chain'],
                    launches_bench_scripts=by_scripts['switch_chain'],
                    launches_parallel_serve=served['switch_chain'],
                    launches_serving_tools=by_tools['switch_chain']),
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
                    totals['static_chain'] + served['static_chain'] +
                    by_tools['static_chain'] + by_scripts['static_chain'],
                    'static_chain', 'static_chain_kernel',
                    shape=shape + ', one signature (E, G, S+, T, Ct)',
                    launches_bench_scripts=by_scripts['static_chain'],
                    launches_parallel_serve=served['static_chain'],
                    launches_serving_tools=by_tools['static_chain']),
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
        resize_entry(resize, resize_main + totals['proxy_resize'] +
                     graph_launches['proxy_resize'],
                     launches_main_path=resize_main,
                     launches_other_paths=totals['proxy_resize'],
                     launches_serving_graph=graph_launches['proxy_resize']),
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
    _, img_s, outs, _ = phase_main_path(batches, counted=False)
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
    mode_digests = {}
    _, rows = phase_modes(batches, mode_digests, counted=False)
    print(json.dumps(dict(result, main_img_s=img_s, modes=dict(rows),
                          main_digest=main_digest,
                          replay_digest=replay_digest,
                          mode_digests=mode_digests)), flush=True)


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
    repeats = {tag: len({(r.get('main_digest'), r.get('replay_digest'),
                          json.dumps(r.get('mode_digests'), sort_keys=True))
                         for r in results if r['tag'] == tag}) == 1
               for tag in trees}
    say(json.dumps({'turns': results, 'parent_vs_change': compare,
                    'each_tree_repeats_its_outputs': repeats}))
    # each mode's outputs, by digest: the first turn of each tree
    firsts = {tag: next(r for r in results if r['tag'] == tag)
              for tag in trees}
    for mode, digest in firsts['parent'].get('mode_digests', {}).items():
        differing['mode_' + mode] = int(
            firsts['change']['mode_digests'].get(mode) != digest)
    for what in ('main', 'replay'):
        if what in compare:
            differing[what] = compare[what]['values_differing']
    if any(c['max_lsb'] > 1 for k, c in compare.items() if k != 'kernels'):
        fail('the two trees differ by more than 1 LSB: %s' % compare)
    moved = _moved_outputs(differing)
    if moved:
        fail('outputs differ from the parent\'s (values differing, by '
             'output; a mode_ entry is 1 when its digest differs; '
             'TURNS_MAY_DIFFER lists none of them): %s' % moved)


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
