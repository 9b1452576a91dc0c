"""Training cells: fused chunks of outer iterations, as ``Trainer.train``
dispatches them (``core/steps.py::build_fused_iterations_step`` ->
``core/fused.py::FusedRunner.run``), state and pool chained from chunk to
chunk.

Set-up builds one runner from weights, packs and a pool the harness makes
on the card from the seed.  A first dispatch of the cell's first iteration
captures the runner's graph (``FusedRunner`` runs that iteration eagerly
and captures it unrun); its result is thrown away: the runner holds copies
of the state and the pool it is handed, so they stay as made.  The same
runner then runs the cell's first three iterations from them through the
window's own call (``runner.run``), every one a graph replay: the first
one and then two more, so that Adam's moments after one iteration and the
parameters after three can be read.  The window dispatches ``chunk``
iterations a call, ``depth`` calls outstanding, until ``seconds`` have
passed, and ends when the last one completes.  ``train_ms_per_iter`` is
the window's seconds over its iterations.  Set-up's stages are timed on
standard error.

With ``--trace 1`` the same loop runs ``depth`` more chunks under the
profiler, of ``trace_chunk`` iterations each (a chunk of the window's
length holds some 750,000 device activities, which take minutes to
read).  After the window (``memory_peak_bytes`` read, the runner freed)
the reference runs the same three iterations from the same inputs
(``reference/train.py``) and the program's readings are held to it."""

import gc
import sys
import time

from benchmark.drivers.serve import _config_matches
from benchmark.lib.common import MARKS, BenchError, Check
from benchmark.lib.inputs import generator, glorot_params, photos
from benchmark.lib.trace import profile, span
from benchmark.reference import train as reference

FIRST = 3       # iterations the reference follows


def make_data(traffic, config, seed, device):
    """``(fake, real, pool images)`` float32 packs on the card: RAW-style
    crops for the generator, brighter retouched-style ones for the critic,
    the pool's central crops of more RAW-style images."""
    fake = photos(generator(seed, device, 10), traffic['pack_n'],
                  traffic['fake_size'], traffic['fake_size'],
                  traffic['layout'], traffic['texture'], device, 'float32')
    real = photos(generator(seed, device, 11), traffic['pack_n'],
                  traffic['real_size'], traffic['real_size'],
                  traffic['layout'], traffic['texture'], device, 'float32',
                  exposure=(-0.5, 0.5))
    n, size = config['replay_memory_size'], traffic['fake_size']
    crop = config['source_img_size']
    lo = (size - crop) // 2
    pool = photos(generator(seed, device, 12), n, size, size,
                  traffic['layout'], traffic['texture'], device,
                  'float32')[:, lo:lo + crop, lo:lo + crop].contiguous()
    return fake, real, pool


def initial_params(config, seed, device):
    """``{tree: {name: tensor}}``: Glorot-uniform weights and zero biases
    of the policy, value and critic nets, from the seed."""
    shapes = reference.parameter_shapes(config)
    return {t: glorot_params(shapes[t], generator(seed, device, 20 + i),
                             device)
            for i, t in enumerate(reference.TREES)}


def _program(cfgfile, traffic, seed, device, init):
    """The program's runner factory and its first state."""
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import build_fused_iterations_step
    from exposure_tpu_torch.core.train_state import TrainState
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.config import load_config
    from exposure_tpu_torch.utils.draws import Draws
    import torch
    cfg = load_config(cfgfile['program_config'])
    _config_matches(cfg, cfgfile['config'])
    filters, policy, critic, value = build_models(cfg)
    for t, m in zip(reference.TREES, (policy, value, critic)):
        have = {k: tuple(v.shape) for k, v in m.state_dict().items()}
        want = {k: tuple(v.shape) for k, v in init[t].items()}
        if have != want:
            raise BenchError('the program\'s %s net has other parameters '
                             'than the reference\'s' % t)
        m.to(device)
    state = TrainState.create(*({k: v.clone() for k, v in init[t].items()}
                                for t in ('gen', 'val', 'crit')))
    gen = torch.Generator(device=device)

    def draws_for(it):
        gen.manual_seed(reference.iteration_seed(seed, it))
        return Draws(gen, device)

    def runner(giters, citers):
        return build_fused_iterations_step(
            cfg, policy, critic, value, filters,
            tuple(traffic['fake_meta']), tuple(traffic['real_meta']),
            giters, citers, draws_for, gen)

    return cfg, runner, state, PoolState.create


def _mu(state):
    return {t: {k: v.clone() for k, v in o.mu.items()}
            for t, o in zip(reference.TREES,
                            (state.opt_g, state.opt_v, state.opt_c))}


def chained(dispatch, state, pool, nxt, chunk, depth, cuda, seconds=None,
            chunks=None):
    """The window's loop: ``chunk`` iterations a dispatch from iteration
    ``nxt``, ``depth`` dispatches outstanding, until ``seconds`` have
    passed (or ``chunks`` dispatches were made), then the last one
    completes.  Returns ``(state, pool, nxt, iterations, start, end)`` on
    the host clock."""
    import torch
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pending, n_iters, made = [], 0, 0
    t0 = time.perf_counter()
    end_at = None if seconds is None else t0 + seconds

    def more():
        if end_at is None:
            return made < chunks
        return time.perf_counter() < end_at

    while more():
        if len(pending) >= depth:
            with span('wait'):
                pending.pop(0).synchronize()
            if not more():
                break
        with span('dispatch'):
            state, pool, _ = dispatch(state, pool,
                                      list(range(nxt, nxt + chunk)))
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
        nxt += chunk
        n_iters += chunk
        made += 1
    sync()
    return state, pool, nxt, n_iters, t0, time.perf_counter()


class Stages:
    """Set-up's stages on the host clock from ``started``: ``run.py``'s
    steps (``common.MARKS``), then the driver's, each ended by a
    synchronize so that its device work counts in it; printed on standard
    error."""

    def __init__(self, sync, started):
        self.sync, self.t, self.items = sync, started, []
        for step, t in MARKS:
            self.items.append((step, t - self.t))
            self.t = t

    def end(self, name):
        self.sync()
        now = time.perf_counter()
        self.items.append((name, now - self.t))
        self.t = now

    def line(self):
        return 'setup stages: ' + ', '.join('%s %.3f s' % kv
                                            for kv in self.items)


def run(spec, seed, seconds, trace, started, device='cuda', chips=1,
        control=False, fault=None):
    """One run of a training cell; returns ``(check, e2e, layer_ctx,
    device_numbers, trace)``.  ``control``/``fault``: the reference with
    TF32 on, or with a planted fault, in the program's place; no window."""
    import torch
    cfgfile, traffic, limits = spec['config'], spec['traffic'], \
        spec['limits']
    config, schedule = cfgfile['config'], cfgfile['schedule']
    cuda = torch.device(device).type == 'cuda'
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stages = Stages(sync, started)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fake, real, pool_images = make_data(traffic, config, seed, device)
    init = initial_params(config, seed, device)
    stages.end('data')
    it0 = traffic['first_iteration']
    first = list(range(it0, it0 + FIRST))
    metas = (tuple(traffic['fake_meta']), tuple(traffic['real_meta']))

    def ref_run(**kw):
        return reference.reference_run(config, *metas, init, pool_images,
                                       fake, real, first, seed, schedule,
                                       device, **kw)

    if control or fault:
        prog = ref_run(tf32_on=bool(control), fault=fault)
        check = judge(prog, ref_run(), init, limits)
        return check, {}, {}, {'memory_peak_bytes': 0}, None

    cfg, make_runner, state0, make_pool = _program(cfgfile, traffic, seed,
                                                   device, init)
    pool0 = make_pool(pool_images.clone(), cfg.num_state_dim)
    runner = make_runner(cfg.giters, cfg.citers)
    data = (fake, real)
    stages.end('program')

    def dispatch(state, pool, iters):
        lr_g, lr_c, prog = reference.learning_rates(schedule, iters)
        return runner.run(state, pool, data, iters, lr_g, lr_c, prog)

    # the capture, on an iteration the check does not read (a replay that
    # kept the capture's draws would differ from the first iteration on);
    # the runner copied state0 and pool0, which stay as made
    dispatch(state0, pool0, [it0 - 1])
    stages.end('capture')
    # the first iterations, replays through the window's own call
    state, pool, m1 = dispatch(state0, pool0, first[:1])
    mu1, params1 = _mu(state), reference.params_of(state)
    state, pool, m23 = dispatch(state, pool, first[1:])
    params3 = reference.params_of(state)
    rows = torch.cat([m1, m23]).tolist()
    del state0, pool0
    stages.end('first')
    setup_s = time.perf_counter() - started
    print('# ' + stages.line(), file=sys.stderr)

    chunk, depth = traffic['chunk'], traffic['depth']
    state, pool, nxt, n_iters, t0, t1 = chained(
        dispatch, state, pool, first[-1] + 1, chunk, depth, cuda,
        seconds=seconds)
    e2e = {'train_ms_per_iter': 1e3 * (t1 - t0) / n_iters,
           'setup_s': setup_s}

    traced, ctx = None, {}
    if trace:
        box = {}

        n = traffic['trace_chunk']

        def traced_chunks():
            box['out'] = chained(dispatch, state, pool, nxt, n, depth, cuda,
                                 chunks=depth)
        traced = profile(traced_chunks, n * depth)
        state, pool, nxt = box['out'][:3]
        ctx['phase_ms'] = phase_ms(make_runner, cfg, state, pool, data,
                                   schedule, nxt, traffic)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    runner.release()
    del runner, state, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    prog = reference.Snapshot(reference.snapshot_losses(rows), mu1, params1,
                              params3)
    check = judge(prog, ref_run(), init, limits)
    if trace:
        from benchmark.counts.flops import Flops
        with Flops() as counter:
            reference.reference_run(config, *metas, init, pool_images, fake,
                                    real, first[:1], seed, schedule, device)
        ctx['iteration_flops'] = counter.total
        ctx['trace'] = traced
        ctx['ms_per_iter'] = 1e3 * traced.window_s / traced.units
    return check, e2e, ctx, {'memory_peak_bytes': peak}, traced


def phase_ms(make_runner, cfg, state, pool, data, schedule, it, traffic):
    """``{'critic', 'generator'}``: ms an iteration of fused runs of the
    critic phase alone ``(0, citers)`` and of the generator phase alone
    ``(giters, 0)``, CUDA events around ``phase_iters`` replays after a
    capture, each from the window's state."""
    import torch
    out = {}
    for name, (g, c) in (('critic', (0, cfg.citers)),
                         ('generator', (cfg.giters, 0))):
        r = make_runner(g, c)

        def go(iters):
            lr_g, lr_c, prog = reference.learning_rates(schedule, iters)
            return r.run(state, pool, data, iters, lr_g, lr_c, prog)
        go([it, it + 1])
        n = traffic['phase_iters']
        iters = list(range(it + 2, it + 2 + n))
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        go(iters)
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / n
        r.release()
    return out


def judge(prog, ref, init, limits):
    """The program's (or the control's) readings against the
    reference's."""
    gaps = reference.compare(prog, ref, init)
    check = Check()
    check.attempted = FIRST
    for name in ('loss_gap', 'grad_gap', 'change_gap'):
        check.add(name, gaps[name], limits[name])
    check.failed = int(not check.correct)
    for label, key in (('', 'change_nets'), (' after one', 'change_nets_1')):
        check.notes.append('change%s by net (median leaf): %s' % (
            label, ', '.join('%s %.3g' % kv for kv in gaps[key].items())))
    check.notes.append('loss gaps of the later iterations: %s' % ', '.join(
        '%.3g' % g for g in gaps['later_loss_gaps']))
    check.notes.append('worst leaves: gradient %s, change %s (%.3g); left '
                       'out of the change: %d leaves'
                       % (gaps['worst']['grad'], gaps['worst']['change'],
                          gaps['change_worst'], len(gaps['left_out'])))
    return check
