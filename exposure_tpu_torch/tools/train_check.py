"""One outer training iteration on the card against the same iteration on
the CPU.

    python -m exposure_tpu_torch.tools.train_check [--config synthetic_explore]
        [--giters 1] [--citers 1] [--seed 0]
        [--stream float32|uint8]

Both devices start from the same state (``init_train_state``), pool and
dataset packs, and take the same draws: drawn on the CPU, recorded, then
replayed on the card (``utils/draws.py``).  ``--stream`` checks the
streaming step instead (``build_streaming_outer_step``): both devices take
the same host bundle, assembled from the config's providers
(``core/streaming.py``) in that dtype.  Dropout is off; the step runs in
float32 whatever the process's TF32 flags (``utils/precision.py``), as on
the CPU.  The iteration is that of training iteration 1 (its
learning rates and progress) on a pool where every third record has
terminated, so that the selection drops records and the critic samples
terminated ones.

The report holds the card against the CPU:

- each metric within rtol 1e-4 (atol 1e-7);
- each tree's worst gradient difference over the updates, as a fraction of
  the tree's largest gradient on the CPU, within ``GRAD_FRAC``: 1.4e-3,
  halfway in log terms between the worst reading with TF32 off (4.84e-4,
  the critic's: a difference of two means that nearly cancel) and the
  least with TF32 on (4.0e-3, the generator's), at ``synthetic_explore``'s
  full width on an H100, seeds 0-2;
- Adam's moments against the CPU's: ``mu`` within ``GRAD_FRAC`` of the
  largest of its tree, ``nu`` (a square) within twice that;
- Adam replayed on the CPU from the same state on the gradients the card
  took: the card's moments and parameters within ``REPLAY_ULPS`` units of
  2^-23 of the replay's, elementwise, a parameter's taken as at least its
  size before the updates plus lr (the moments come out equal; the card
  divides by the bias correction as a product with its reciprocal, which
  can move a parameter by an ulp of its update's operands each update: 8
  allows a few updates; a skipped update reads about 2^23 lr / (|p| + lr),
  over 100 for any parameter under 1), so that an update skipped or
  applied to the wrong tensors fails, which the next bound cannot see;
- each tree's worst parameter difference in units of its learning rate,
  within 3 (Adam's first step moves a parameter by about lr whatever its
  gradient's size, so two sound runs stay within 2 lr);
- the selected filter ids equal, or each differing row within 1e-5 of a
  tie (the distance from the selection noise to the nearest edge of the
  cumulative pdf); the pool's states equal and its images within 1e-4 on
  the slots no differing row wrote.

cuDNN's convolution algorithms differ between the devices in the last
bits, so these are tolerances.  ``chip_smoke.py::phase_train`` prints the
report and fails on any of its failures.
"""

import argparse
import json
import random

import numpy as np
import torch

from exposure_tpu_torch.core.replay import PoolState
from exposure_tpu_torch.core.steps import (
    build_outer_step,
    build_streaming_outer_step,
)
from exposure_tpu_torch.core.streaming import assemble_stream
from exposure_tpu_torch.core.train_state import (
    apply_lr_update,
    clip_tree,
    init_train_state,
)
from exposure_tpu_torch.models.networks import build_models
from exposure_tpu_torch.utils.config import load_config
from exposure_tpu_torch.utils.draws import Draws, ReplayedDraws
from exposure_tpu_torch.utils.ops import STATE_STEP_DIM, STATE_STOPPED_DIM

METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-7
GRAD_FRAC = 1.4e-3
PARAM_LRS = 3.0
REPLAY_ULPS = 8.0
TIE_MARGIN = 1e-5
POOL_ATOL = 1e-4


def _pool(cfg, provider, seed):
    """The provider's pool batch, every third record terminated after 5
    steps and the others between 0 and 4 steps in."""
    images, _ = provider.get_next_batch(cfg.replay_memory_size)
    pool = PoolState.create(torch.from_numpy(np.ascontiguousarray(images)),
                            cfg.num_state_dim)
    steps = np.random.RandomState(seed).randint(0, 5, cfg.replay_memory_size)
    pool.states[:, STATE_STEP_DIM] = torch.from_numpy(steps.astype(
        np.float32))
    pool.states[::3, STATE_STOPPED_DIM] = 1.0
    pool.states[::3, STATE_STEP_DIM] = 5.0
    return pool


def _host(tree):
    return {k: v.detach().cpu() for k, v in tree.items()}


def _run(cfg, nets, state, pool, data, draws, device, giters, citers,
         rates, stream):
    """One step on ``device``: ``data`` is the two packs ``(images, size,
    augment)``, or with ``stream`` the bundle's two tensors."""
    filters, policy, critic, value = nets
    taps = []
    if stream:
        step = build_streaming_outer_step(cfg, policy, critic, value,
                                          filters, giters, citers, taps=taps)
    else:
        step = build_outer_step(cfg, policy, critic, value, filters,
                                data[0][1:], data[1][1:], giters, citers,
                                taps=taps)
        data = (data[0][0], data[1][0])
    st, pl, metrics = step(state.to(device), pool.to(device),
                           data[0].to(device), data[1].to(device), draws,
                           *rates)
    taps = [{k: _host(v) if isinstance(v, dict) else v.detach().cpu()
             for k, v in tap.items()} for tap in taps]
    return (st.to('cpu'), pl.to('cpu'),
            {k: float(v) for k, v in metrics._asdict().items()}, taps)


def _adam_replay(cfg, state, taps, lr_g, lr_c):
    """The state Adam gives from ``state`` on the CPU on the gradients
    ``taps`` recorded, update by update as ``core/steps.py`` applies
    them."""
    betas = (cfg.get('adam_beta1', 0.5), cfg.get('adam_beta2', 0.9))
    for tap in taps:
        if 'crit' in tap:
            crit, opt_c = apply_lr_update(tap['crit'], state.opt_c,
                                          state.crit_params, lr_c, *betas)
            if cfg.gan == 'w' and cfg.gradient_penalty_lambda <= 0:
                crit = clip_tree(crit, cfg.clamp_critic)
            state = state.replace(crit_params=crit, opt_c=opt_c)
            continue
        gen, opt_g = apply_lr_update(tap['gen'], state.opt_g,
                                     state.gen_params, lr_g, *betas)
        val, opt_v = apply_lr_update(tap['val'], state.opt_v,
                                     state.val_params,
                                     lr_g * cfg.value_lr_mul, *betas)
        state = state.replace(gen_params=gen, val_params=val, opt_g=opt_g,
                              opt_v=opt_v)
    return state


def _worst(a, b, scale=1.0):
    """The worst ``|a - b|`` over two state_dicts, over ``scale``."""
    worst = max(float((a[n] - b[n]).abs().max()) for n in a)
    return worst / scale if scale else worst


def _worst_ulps(a, b, floor=None):
    """The worst ``|a - b|`` over two state_dicts in units of 2^-23 of
    ``|b| + floor``, elementwise: about float32 ulps of ``b``.  For a
    parameter, ``floor`` is its size before the updates plus lr: an update
    that cancels most of a parameter rounds at the operands' scale."""
    tiny = torch.finfo(torch.float32).tiny
    return max(float(((a[n] - b[n]).abs() / (
        (b[n].abs() + (0 if floor is None else floor[n])).clamp_min(tiny) *
        2.0 ** -23)).max()) for n in a)


def _largest(tree):
    return max(float(v.abs().max()) for v in tree.values())


def _tie_margin(pdf, noise):
    """The distance from each row's noise to the nearest inner edge of its
    cumulative pdf (as ``ops/sampling.py::pdf_sample`` normalizes it)."""
    pdf = pdf / (pdf.sum(dim=1, keepdim=True) + 1e-36)
    edges = torch.cumsum(pdf, dim=1)[:, :-1]
    return (edges - noise).abs().min(dim=1).values


def card_against_cpu(cfg, device='cuda', giters=1, citers=1, seed=0,
                     it=1, stream=None):
    """Run one outer iteration (``giters`` generator and ``citers`` critic
    updates) on the CPU and on ``device`` from the same state and draws;
    with ``stream``
    (``'float32'`` or ``'uint8'``) the streaming step on one host bundle of
    that dtype.  Returns the report: ``{'metrics', 'grad_frac',
    'moment_frac', 'replay', 'param_lrs', 'ids', 'pool', 'failures'}``."""
    cfg = cfg.copy()
    cfg.dropout_keep_prob = 1.0
    nets = build_models(cfg)
    state = init_train_state(cfg, *nets[1:], seed=seed)
    random.seed(seed)           # the providers draw from ``random``
    fake, real = cfg.fake_data_provider(), cfg.real_data_provider()
    pool = _pool(cfg, fake, seed)
    if stream:
        cfg.stream_dtype = stream
        data = tuple(torch.from_numpy(x) for x in assemble_stream(
            cfg, False, fake, real, giters, citers))
    else:
        data = [(p.images, p.output_size, p.augment)
                for p in (fake.device_pack(), real.device_pack())]
    lr_g, lr_c = cfg.lr_g(it), cfg.lr_c(it)
    rates = (lr_g, lr_c, it / cfg.max_iter_step)
    draws = Draws(torch.Generator().manual_seed(seed), record=True)
    cpu = _run(cfg, nets, state, pool, data, draws, 'cpu', giters, citers,
               rates, stream)
    replay = ReplayedDraws(draws.log, device)
    card = _run(cfg, nets, state, pool, data, replay, device, giters,
                citers, rates, stream)
    if replay.left():
        raise RuntimeError('the card took %d draws fewer than the CPU'
                           % replay.left())
    failures = []
    report = {'metrics': {}, 'grad_frac': {}, 'moment_frac': {},
              'replay': {}, 'param_lrs': {}}

    for name, want in cpu[2].items():
        got = card[2][name]
        report['metrics'][name] = (got, want)
        if not abs(got - want) <= METRIC_ATOL + METRIC_RTOL * abs(want):
            failures.append('metric %s: card %r, CPU %r' % (name, got, want))

    # the selections, and the slots the rows that differ wrote
    noises = [v for name, v in draws.log if name == 'noise']
    g_taps = [(c, k) for c, k in zip(cpu[3], card[3]) if 'ids' in c]
    differing, margins, spoiled = 0, [], set()
    for (c, k), noise in zip(g_taps, noises):
        rows = (c['ids'] != k['ids']).nonzero().flatten()
        differing += len(rows)
        margin = _tie_margin(c['pdf'], noise)[rows]
        margins += margin.tolist()
        spoiled |= set(c['sel_idx'][rows].tolist())
        if len(rows) and float(margin.max()) >= TIE_MARGIN:
            failures.append('selected ids differ on %d rows, tie margins %s'
                            % (len(rows), margin.tolist()))
    report['ids'] = {'rows': sum(len(c['ids']) for c, _ in g_taps),
                     'differing': differing, 'margins': margins}

    if not differing:   # a flipped selection changes every later number
        for tree in ('gen', 'val', 'crit'):
            pairs = [(c[tree], k[tree]) for c, k in zip(cpu[3], card[3])
                     if tree in c]
            if not pairs:
                continue
            scale = max(_largest(c) for c, _ in pairs)
            report['grad_frac'][tree] = max(_worst(c, k, scale)
                                            for c, k in pairs)
            if report['grad_frac'][tree] > GRAD_FRAC:
                failures.append('%s gradients: worst %.3e of the largest'
                                % (tree, report['grad_frac'][tree]))
        ran = _adam_replay(cfg, state, card[3], lr_g, lr_c)
        for opt in ('opt_g', 'opt_v', 'opt_c'):
            a, b, r = (getattr(x, opt) for x in (cpu[0], card[0], ran))
            for moment, bound in (('mu', GRAD_FRAC), ('nu', 2 * GRAD_FRAC)):
                want, got = getattr(a, moment), getattr(b, moment)
                frac = _worst(got, want, _largest(want))
                report['moment_frac'][opt + '.' + moment] = frac
                if frac > bound:
                    failures.append('%s %s: worst %.3e of the largest'
                                    % (opt, moment, frac))
                ulps = _worst_ulps(got, getattr(r, moment))
                report['replay'][opt + '.' + moment] = ulps
                if ulps > REPLAY_ULPS or b.count != r.count:
                    failures.append('%s %s: %.3g ulps off Adam replayed on '
                                    'its gradients, count %d against %d'
                                    % (opt, moment, ulps, b.count, r.count))
        for tree, lr in (('gen_params', lr_g),
                         ('val_params', lr_g * cfg.value_lr_mul),
                         ('crit_params', lr_c)):
            a, b, r = (getattr(x, tree) for x in (cpu[0], card[0], ran))
            floor = {n: v.abs() + lr
                     for n, v in getattr(state, tree).items()}
            report['replay'][tree] = _worst_ulps(b, r, floor)
            if report['replay'][tree] > REPLAY_ULPS:
                failures.append('%s: %.3g ulps off Adam replayed on its '
                                'gradients' % (tree, report['replay'][tree]))
            report['param_lrs'][tree] = _worst(a, b, lr)
            if report['param_lrs'][tree] > PARAM_LRS:
                failures.append('%s: %.2f lr apart'
                                % (tree, report['param_lrs'][tree]))

    keep = torch.ones(cfg.replay_memory_size, dtype=torch.bool)
    keep[sorted(spoiled)] = False
    states_equal = bool(torch.equal(cpu[1].states[keep],
                                    card[1].states[keep]))
    image_err = float((cpu[1].images[keep] - card[1].images[keep]).abs()
                      .max())
    report['pool'] = {'states_equal': states_equal,
                      'image_max_abs_err': image_err,
                      'slots_compared': int(keep.sum())}
    if not states_equal or image_err > POOL_ATOL:
        failures.append('pool: states equal %s, images %.3e apart'
                        % (states_equal, image_err))
    report['failures'] = failures
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config', default='synthetic_explore')
    parser.add_argument('--giters', type=int, default=1)
    parser.add_argument('--citers', type=int, default=1)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--stream', choices=('float32', 'uint8'),
                        help='check the streaming step on a host bundle')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('train_check needs a CUDA device')
    report = card_against_cpu(load_config(args.config), 'cuda', args.giters,
                              args.citers, args.seed, stream=args.stream)
    print(json.dumps(report))
    if report['failures']:
        raise SystemExit(1)


if __name__ == '__main__':
    main()
