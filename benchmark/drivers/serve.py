"""Serving cells: ``RetouchPipeline`` batches in a closed loop.

Set-up: the pipeline from the configuration's artifact (its sha256 held),
the program's configuration held to the cell's file, ``distinct`` batches
of photos made on the card from the seed, and ``warm_batches`` batches
that capture the batch's CUDA graph.  The window: a client keeps
``in_flight`` batches submitted; batch ``i`` is the resident batch ``i mod
distinct`` with the dropout stream of ``(seed, i)``; a batch's latency runs
from the host's call to the completion of its output on the card (an
event recorded after the call).  Submission stops once ``seconds`` have
passed; the window ends when the last batch completes.

With ``--trace 1`` the same loop then runs ``trace_batches`` more batches
under the profiler.  Afterwards (and after ``memory_peak_bytes`` is read
and the pipeline is freed) the reference judges a sample of the window's
answers: a reservoir of ``check_batches`` batches drawn from the seed over
every batch of the window, and ``check_images`` photos of each, with the
first and the last photo of the batch among them."""

import gc
import random
import time

from benchmark.lib.common import BenchError, Check, ROOT, percentile
from benchmark.lib.inputs import generator, photos
from benchmark.lib.trace import profile, span
from benchmark.lib.window import rate
from benchmark.reference import artifact

TRACE_INDEX = 1 << 40      # dropout indexes of the traced batches
WARM_INDEX = 1 << 41       # and of the warm-up batches


def _config_matches(program_cfg, config):
    """Raise unless the program's configuration holds the cell's values."""
    bad = []
    for k, v in config.items():
        have = program_cfg.get(k)
        if isinstance(have, tuple):
            have = list(have)
        if have != v:
            bad.append('%s: file %r, program %r' % (k, v, have))
    if bad:
        raise BenchError('the program\'s configuration differs from the '
                         'cell\'s: ' + '; '.join(bad))


def _pipeline(cfgfile, traffic, device, bf16=False):
    from exposure_tpu_torch.core.serving import RetouchPipeline
    from exposure_tpu_torch.utils.config import load_config
    _config_matches(load_config(cfgfile['program_config']),
                    cfgfile['config'])
    path = ROOT / cfgfile['weights']['path']
    if artifact.sha256(path) != cfgfile['weights']['sha256']:
        raise BenchError('%s is not the artifact the cell was set on' % path)
    knobs = dict(traffic.get('pipeline', {}))
    if bf16:
        knobs['bf16'] = True
    return RetouchPipeline.from_artifact(
        cfgfile['program_config'], str(path), device=device, **knobs)


def make_batches(traffic, seed, device):
    """The ``distinct`` resident batches of the traffic, from ``seed``."""
    b, h, w = traffic['batch'], traffic['height'], traffic['width']
    return [photos(generator(seed, device, k), b, h, w,
                   traffic['layout'], traffic['texture'], device)
            for k in range(traffic['distinct'])]


class Window:
    """The measured stretch's record: host submit times, completion
    events, and the reservoir of kept answers."""

    def __init__(self, keep, rng):
        self.submit, self.done = [], []
        self.keep, self.rng = keep, rng
        self.kept = []          # (batch index, output tensor)

    def offer(self, i, out):
        """Reservoir sampling over every batch of the window."""
        if not self.keep:
            return
        if len(self.kept) < self.keep:
            self.kept.append((i, out))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.kept[j] = (i, out)


class HostEvent:
    """A host-clock stand-in for a CUDA event, for runs on the CPU, where
    a call returns when its work is done."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def closed_loop(pipe, batches, seed, seconds, in_flight, window, cuda,
                count=None, first=0):
    """Submit batches, ``in_flight`` outstanding, until ``seconds`` have
    passed (or ``count`` batches were submitted), batch ``i`` with the
    dropout index ``first + i``; returns ``(start, end, latencies)`` on the
    host clock."""
    import torch
    event = torch.cuda.Event if cuda else HostEvent
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    anchor = event(enable_timing=True)
    anchor.record()
    anchor.synchronize()
    t0 = time.perf_counter()
    end_at = None if seconds is None else t0 + seconds
    pending = []
    i = 0
    while (i < count) if end_at is None else (time.perf_counter() < end_at):
        if len(pending) >= in_flight:
            with span('wait'):
                pending.pop(0).synchronize()
        with span('submit'):
            t = time.perf_counter()
            out = pipe(batches[i % len(batches)], seed, first + i,
                       device_out=True)
            ev = event(enable_timing=True)
            ev.record()
        window.submit.append(t)
        window.done.append(ev)
        window.offer(i, out)
        pending.append(ev)
        i += 1
    sync()
    done = [t0 + anchor.elapsed_time(ev) / 1000.0 for ev in window.done]
    lat = [d - s for s, d in zip(window.submit, done)]
    return t0, max(done), lat


class Faulty:
    """The pipeline with a fault planted under it, for the limits' upper
    readings and the tests: ``unchanged`` hands back the photos as they
    came, ``half_batch`` leaves the second half of the batch out (its rows
    come back unprocessed), ``altered`` alters one answer where it is
    produced (the batch's first photo comes back 8 units brighter)."""

    def __init__(self, pipe, fault):
        self.pipe, self.fault = pipe, fault

    def release(self):
        self.pipe.release()

    def __call__(self, images, seed, index, device_out=True):
        import torch
        out = self.pipe(images, seed, index, device_out=True)
        if self.fault == 'unchanged':
            return images.clone()
        if self.fault == 'half_batch':
            half = images.shape[0] // 2
            out[half:] = images[half:]
        elif self.fault == 'altered':
            out[0] = (out[0].to(torch.int16) + 8).clamp_(0, 255).to(
                out.dtype)
        return out


def run(spec, seed, seconds, trace, started, device='cuda', chips=1,
        control=False, fault=None):
    """One run of a serving cell; returns ``(check, e2e, layer_ctx,
    device_numbers, trace)``.  ``control``: the program's own
    lower-precision path (the bf16 plan) in its place; ``fault``: a fault
    planted under the pipeline (``Faulty``); both for the limits."""
    import torch
    cfgfile, traffic = spec['config'], spec['traffic']
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pipe = _pipeline(cfgfile, traffic, device, bf16=control)
    if fault:
        pipe = Faulty(pipe, fault)
    batches = make_batches(traffic, seed, device)
    for k in range(traffic['warm_batches']):
        pipe(batches[k % len(batches)], seed, WARM_INDEX + k,
             device_out=True)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started

    window = Window(traffic['check_batches'], random.Random(seed))
    start, end, lat = closed_loop(pipe, batches, seed, seconds,
                                  traffic['in_flight'], window, cuda)
    n = len(lat)
    e2e = {'serve_images_per_s': rate(n * traffic['batch'], start, end),
           'serve_batch_p95_ms': 1e3 * percentile(lat, 95),
           'setup_s': setup_s}
    traced = None
    if trace:
        n_traced = traffic['trace_batches']

        def traced_batches():
            closed_loop(pipe, batches, seed, None, traffic['in_flight'],
                        Window(0, None), cuda, count=n_traced,
                        first=TRACE_INDEX)
        traced = profile(traced_batches, n_traced)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kept = sorted(window.kept, key=lambda x: x[0])
    pipe.release()
    del pipe, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    check, ref = judge(spec, seed, batches, kept, device)
    ctx = {'trace': traced, 'ref': ref, 'batches': batches, 'seed': seed,
           'traffic': traffic, 'config': cfgfile, 'batches_in_window': n}
    return check, e2e, ctx, {'memory_peak_bytes': peak}, traced


def sample_rows(rng, batch, n):
    """``n`` image rows of a batch of ``batch``: the first, the last, and
    the rest drawn without replacement."""
    rows = {0, batch - 1}
    rest = [r for r in range(1, batch - 1)]
    rng.shuffle(rest)
    rows.update(rest[:max(0, n - 2)])
    return sorted(rows)[:max(n, 1)]


def judge(spec, seed, batches, kept, device):
    """Hold each kept answer's sampled photos to the reference; returns
    ``(Check, reference)``.  Two numbers over every value compared: the
    share off by more than one unit of the last bit, and the 99.99th
    percentile of the difference."""
    import torch
    from benchmark.reference.serve import ServeReference, over_share, \
        row_masks, tail_lsb
    cfgfile, traffic, limits = spec['config'], spec['traffic'], \
        spec['limits']
    if not kept:
        raise BenchError('the window completed no batch')
    ref = ServeReference(cfgfile['config'],
                         str(ROOT / cfgfile['weights']['path']), device,
                         tie=limits['plan_tie'])
    rng = random.Random(seed ^ 0x5EED)
    check = Check()
    total = torch.zeros(256, dtype=torch.int64)
    gap = 0.0
    for i, out in kept:
        images = batches[i % len(batches)]
        masks = ref.keep_masks(seed, i, images.shape[0])
        for row in sample_rows(rng, images.shape[0],
                               traffic['check_images']):
            r = ref.judge(images[row], out[row], row_masks(masks, row))
            check.attempted += 1
            check.failed += int(
                over_share(r['hist']) > limits['out_over_1lsb'] or
                tail_lsb(r['hist']) > limits['out_lsb_p9999'])
            total += r['hist']
            gap = max(gap, r['gap'])
    check.add('out_over_1lsb', over_share(total), limits['out_over_1lsb'])
    check.add('out_lsb_p9999', tail_lsb(total), limits['out_lsb_p9999'])
    worst = int(torch.nonzero(total)[-1])
    check.notes.append('largest difference %d LSB; plan ties taken: widest '
                       'gap %.3g' % (worst, gap))
    return check, ref
