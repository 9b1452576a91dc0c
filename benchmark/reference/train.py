"""The plain reference of the first training iterations, and the comparison
that decides a training cell's ``correct``.

The reference runs the frozen outer iteration (``frozen/steps.py``) eagerly
from the weights, packs and pool the harness made, with every iteration's
draws from a generator seeded by ``iteration_seed(seed, it)``, as the
harness seeds the program's, and at the learning rates and progress the
harness hands both sides.  TF32 is off; the control turns it on.

Three numbers are compared, each the worst over what it covers:

- ``loss_gap``: the first iteration's generator, value and critic (EMD)
  losses, ``|program - reference|`` over the larger of ``|reference|``
  and the median ``|reference|`` of the three (the later iterations'
  losses are left out: a sampled action that rounding flips after the
  first updates moves them by as much as TF32 does);
- ``grad_gap``: the first gradient as Adam holds it after one iteration
  (its first moment), a leaf's norm against the reference's: ``|‖p‖ -
  ‖r‖|`` over the larger of ``‖r‖`` and the median leaf's of its net;
- ``change_gap``: each leaf's change after three iterations, measured so,
  leaving out the leaves whose reference gradient is under a thousandth of
  its net's median leaf's (they move by round-off alone under Adam); the
  median leaf's gap of each net, the worst of the three nets, not the
  worst leaf's: the worst swings from seed to seed
  with the noise of a small leaf (a critic bias, whose first Adam steps
  move each element by about the learning rate whatever the gradient's
  size, so rounding that flips a near-zero gradient's sign moves the
  leaf's change), and the worst is reported beside it."""

import statistics

import torch

from benchmark.reference.frozen.draws import Draws
from benchmark.reference.frozen.networks import build_models
from benchmark.reference.frozen.replay import PoolState
from benchmark.reference.frozen import steps as frozen_steps
from benchmark.reference.frozen.steps import outer_iteration, step_scalars
from benchmark.reference.frozen.train_state import TrainState, \
    apply_lr_update
from benchmark.reference.serve import Cfg, tf32

TREES = ('gen', 'val', 'crit')
LOSSES = (0, 1, 2)     # g_loss, v_loss, emd in a metrics row
SMALL_GRAD = 1e-3      # a leaf under this share of the median is left out


def iteration_seed(seed, it):
    """The generator seed of iteration ``it`` of a run seeded ``seed``."""
    return (int(seed) * 0x2545F4914F6CDD1D + int(it) * 0x9E3779B1 + 1) \
        % (1 << 63)


def learning_rates(schedule, iters):
    """``(lr_g, lr_c, progress)`` lists of ``iters``, from the
    configuration's ``schedule``: ``mul * base_lr`` decayed by ``decay``
    over each ``1 / segments`` of ``max_iter_step``."""
    def lr(mul, t):
        return mul * schedule['base_lr'] * schedule['decay'] ** (
            1.0 * t * schedule['segments'] / schedule['max_iter_step'])
    return ([lr(schedule['lr_g_mul'], t) for t in iters],
            [lr(schedule['lr_c_mul'], t) for t in iters],
            [t / schedule['max_iter_step'] for t in iters])


def parameter_shapes(config):
    """``{tree: {name: shape}}`` of the three networks, from the frozen
    modules built for ``config``."""
    _, policy, critic, value = build_models(Cfg(config))
    return {t: {k: tuple(v.shape) for k, v in m.state_dict().items()}
            for t, m in zip(TREES, (policy, value, critic))}


class Snapshot:
    """What the comparison reads of a run's first three iterations: the
    losses a row, Adam's first moments after iteration 1, the parameters
    after iterations 1 (printed only) and 3."""

    def __init__(self, losses, mu1, params1, params3):
        self.losses = losses        # [3][3] floats
        self.mu1 = mu1              # {tree: {name: tensor}}
        self.params1 = params1      # {tree: {name: tensor}}
        self.params3 = params3      # {tree: {name: tensor}}


def params_of(state):
    """``{tree: {name: tensor}}``: a copy of ``state``'s parameters."""
    return {t: {k: v.clone() for k, v in p.items()}
            for t, p in zip(TREES, (state.gen_params, state.val_params,
                                    state.crit_params))}


def snapshot_losses(rows):
    return [[float(r[j]) for j in LOSSES] for r in rows]


def reference_run(config, fake_meta, real_meta, init, pool_images, fake,
                  real, iters, seed, schedule, device, tf32_on=False,
                  fault=None):
    """The reference's first ``len(iters)`` iterations, as a ``Snapshot``.
    ``tf32_on``: the control.  ``fault``: a fault planted in the reference
    put in the program's place, for the limits' upper readings:
    ``unchanged`` (each iteration hands its state back as it came),
    ``half_batch`` (every update on half the batch, the means over the
    rest), ``altered`` (the first gradient of one leaf 1% off where it is
    produced)."""
    if fault == 'altered':
        frozen_steps.apply_lr_update = _altered_once(apply_lr_update)
    try:
        with tf32(tf32_on):
            return _run(config, fake_meta, real_meta, init, pool_images,
                        fake, real, iters, seed, schedule, device, fault)
    finally:
        frozen_steps.apply_lr_update = apply_lr_update


def _run(config, fake_meta, real_meta, init, pool_images, fake, real, iters,
         seed, schedule, device, fault):
    cfg = Cfg(config)
    filters, policy, critic, value = build_models(cfg)
    for m in (policy, critic, value):
        m.to(device)
    batch = cfg.batch_size // 2 if fault == 'half_batch' else cfg.batch_size
    step = outer_iteration(Cfg(dict(config, batch_size=batch)), policy,
                           critic, value, filters, fake_meta, real_meta,
                           cfg.giters, cfg.citers)
    state = TrainState.create(*({k: v.clone() for k, v in init[t].items()}
                                for t in ('gen', 'val', 'crit')))
    pool = PoolState.create(pool_images.clone(), cfg.num_state_dim)
    lr_g, lr_c, prog = learning_rates(schedule, iters)
    gen = torch.Generator(device=device)
    rows, mu1, params1 = [], None, None
    for i, it in enumerate(iters):
        gen.manual_seed(iteration_seed(seed, it))
        sc = step_scalars(cfg, state, cfg.giters, cfg.citers, lr_g[i],
                          lr_c[i], prog[i], device)
        new_state, pool, m = step(state, pool, fake, real,
                                  Draws(gen, device), sc)
        if fault != 'unchanged':
            state = new_state
        rows.append(torch.stack(list(m)).tolist())
        if i == 0:
            mu1 = {t: {k: v.clone() for k, v in o.mu.items()}
                   for t, o in zip(TREES, (state.opt_g, state.opt_v,
                                           state.opt_c))}
            params1 = params_of(state)
    return Snapshot(snapshot_losses(rows), mu1, params1, params_of(state))


def _altered_once(update):
    """``apply_lr_update`` that scales the first leaf's gradient of its
    first call by 1.01."""
    done = []

    def altered(grads, *args, **kwargs):
        if not done:
            done.append(True)
            k = next(iter(grads))
            grads = dict(grads, **{k: grads[k] * 1.01})
        return update(grads, *args, **kwargs)
    return altered


def _norm(x):
    return float(torch.linalg.vector_norm(x.double()))


def _gaps(prog, ref, keep=None):
    """``|‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖ of the net)`` of each leaf
    (those ``keep`` allows), worst first: ``[(gap, tree/name)]``."""
    out = []
    for t in TREES:
        norms_r = {k: _norm(v) for k, v in ref[t].items()}
        med = statistics.median(norms_r.values())
        for k, v in prog[t].items():
            if keep is not None and not keep(t, k):
                continue
            denom = max(norms_r[k], med)
            if denom == 0.0:
                continue
            out.append((abs(_norm(v) - norms_r[k]) / denom, '%s/%s' % (t, k)))
    return sorted(out, reverse=True)


def compare(prog, ref, init):
    """The compared ``loss_gap``, ``grad_gap`` and ``change_gap`` of the
    program's ``Snapshot`` against the reference's, from the initial
    parameters ``init``, with what runs print beside them: each net's
    change after one and after three iterations, the later iterations'
    loss gaps, the worst leaves and those left out."""
    def loss_gap(i):
        med = statistics.median(abs(v) for v in ref.losses[i])
        return max(abs(p - r) / max(abs(r), med) if max(abs(r), med) else 0
                   for p, r in zip(prog.losses[i], ref.losses[i]))
    grads = _gaps(prog.mu1, ref.mu1)
    small = {}
    for t in TREES:
        norms = {k: _norm(v) for k, v in ref.mu1[t].items()}
        med_t = statistics.median(norms.values())
        small.update({(t, k): n < SMALL_GRAD * med_t
                      for k, n in norms.items()})

    def changes(after):
        def moved(snap):
            return {t: {k: after(snap)[t][k] - init[t][k]
                        for k in after(snap)[t]} for t in TREES}
        return _gaps(moved(prog), moved(ref),
                     keep=lambda t, k: not small[(t, k)])

    def per_net(gaps):
        return {t: statistics.median(g for g, n in gaps
                                     if n.startswith(t + '/'))
                for t in TREES}

    third = changes(lambda snap: snap.params3)
    nets = per_net(third)
    return {'loss_gap': loss_gap(0), 'grad_gap': grads[0][0],
            'change_gap': max(nets.values()), 'change_nets': nets,
            'change_nets_1': per_net(changes(lambda snap: snap.params1)),
            'later_loss_gaps': [loss_gap(i)
                                for i in range(1, len(ref.losses))],
            'change_worst': third[0][0],
            'worst': {'grad': grads[0][1], 'change': third[0][1]},
            'left_out': sorted('%s/%s' % tk for tk, s in small.items() if s)}


