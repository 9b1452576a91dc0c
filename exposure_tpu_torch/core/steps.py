"""The outer training iteration on one device (torch counterpart of
``exposure_tpu/core/steps.py::build_outer_step`` and
``build_streaming_outer_step``).

One call of the step runs ``giters`` generator+value updates, then
``citers`` critic WGAN-GP updates, each a plain eager PyTorch update with
no host synchronisation; the metrics stay device tensors until the trainer
reads them.  Two data paths:

- device-resident (``build_outer_step``): the dataset packs and the replay
  pool live on the device and fresh crops are sampled there
  (``data/device_sampler.py``);
- streaming (``build_streaming_outer_step``): the fresh crops arrive as a
  bundle assembled on the host (``core/streaming.py``, the native host
  loader), float32 or uint8, for packs too large for the device.

Randomness comes from the caller's ``utils/draws.py::Draws``: by default a
``torch.Generator``, in the tests the JAX step's own draws replayed.

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank runs the step
on its shard (``batch_size // world`` crops an update, its slice of the
pool and of the packs or bundle) and averages where the JAX step's
``lax.pmean`` does, with one all-reduce a phase of an update: a generator
update's gradients with its ``g_loss``, ``v_loss`` and mean reward in one
flat bucket, a critic update's gradients with its EMD, gradient norm and
``c_average`` (the EMA takes the average), and the pool's two statistics
at the end.  Without a mesh, or with a world of one without a process
group, the step is the one-device program, untouched.

The schedule's scalars reach a step as device tensors (``StepScalars``):
the learning rates, the progress and every update's Adam bias corrections,
formed on the host in float32 (``scalar_row``) and copied to the device in
one piece, so that no host value is frozen into a step captured in a CUDA
graph.  The JAX fused N-iteration steps (``build_fused_iterations_step``,
``build_streaming_fused_step``) replay one plain iteration N times
(``core/fused.py``).

With tracing on (``utils/trace.py``) a fused iteration's phases are the
device regions ``train.generator`` and ``train.critic``, and each update's
Adam step (the generator's and the value net's together) a region
``train.adam`` inside its phase.
"""

from typing import NamedTuple

import numpy as np
import torch

from exposure_tpu_torch.core.fused import FusedRunner, to_device
from exposure_tpu_torch.core.losses import critic_loss, generator_value_loss
from exposure_tpu_torch.core.replay import (
    reinsert,
    sample_terminated,
    select_generator_batch,
)
from exposure_tpu_torch.core.train_state import (
    apply_lr_update,
    bias_corrections,
    clip_tree,
)
from exposure_tpu_torch.data.device_sampler import (
    DevicePack,
    channels_to_paired,
    sample_batch,
)
from exposure_tpu_torch.parallel.mesh import local_batch_size
from exposure_tpu_torch.utils import trace
from exposure_tpu_torch.utils.precision import tf32_off


class StepMetrics(NamedTuple):
    g_loss: torch.Tensor
    v_loss: torch.Tensor
    emd: torch.Tensor
    critic_gradient_norm: torch.Tensor
    reward: torch.Tensor
    pool_avg_trajectory: torch.Tensor
    pool_terminated_frac: torch.Tensor


class StepScalars(NamedTuple):
    """The schedule's scalars of a step, float32 views into one device
    vector (``scalar_row``'s layout): the learning rates of the generator,
    the value net and the critic, the progress, and ``[n, 2]`` bias
    corrections ``(bc1, bc2)`` of each of the ``n`` generator, value and
    critic updates to come, in order."""

    lr_g: torch.Tensor
    lr_v: torch.Tensor
    lr_c: torch.Tensor
    progress: torch.Tensor
    bc_g: torch.Tensor
    bc_v: torch.Tensor
    bc_c: torch.Tensor

    def after(self, g_updates, c_updates):
        """The scalars of the updates that follow the first ``g_updates``
        generator and ``c_updates`` critic ones."""
        return self._replace(bc_g=self.bc_g[g_updates:],
                             bc_v=self.bc_v[g_updates:],
                             bc_c=self.bc_c[c_updates:])


def scalar_width(giters, citers):
    """The length of ``scalar_row`` for ``giters`` generator and
    ``citers`` critic updates."""
    return 4 + 4 * giters + 2 * citers


def scalar_row(cfg, state, giters, citers, lr_g, lr_c, progress):
    """The host values of ``StepScalars`` for ``giters`` generator and
    ``citers`` critic updates from ``state``'s Adam counts: the value net's
    rate is ``lr_g * value_lr_mul`` formed in double and rounded once, as
    a python scalar reaches the device; the bias corrections are
    ``train_state._bias_correction``'s float32 values."""
    b1, b2 = cfg.get('adam_beta1', 0.5), cfg.get('adam_beta2', 0.9)
    row = [lr_g, lr_g * cfg.value_lr_mul, lr_c, progress]
    for opt, n in ((state.opt_g, giters), (state.opt_v, giters),
                   (state.opt_c, citers)):
        for pair in bias_corrections(opt.count, n, b1, b2):
            row += pair
    return row


def scalars_view(vec, giters, citers):
    """``StepScalars`` over a device vector of ``scalar_row``'s layout."""
    g, c = 2 * giters, 2 * citers
    return StepScalars(vec[0], vec[1], vec[2], vec[3],
                       vec[4:4 + g].view(giters, 2),
                       vec[4 + g:4 + 2 * g].view(giters, 2),
                       vec[4 + 2 * g:4 + 2 * g + c].view(citers, 2))


def step_scalars(cfg, state, giters, citers, lr_g, lr_c, progress, device):
    """``StepScalars`` on ``device`` for a step from ``state``."""
    return scalars_view(to_device(scalar_row(cfg, state, giters, citers,
                                             lr_g, lr_c, progress), device),
                        giters, citers)


def with_critic(metrics, c_metrics):
    """An iteration's metrics: the generator phase's, with the critic
    phase's EMD, gradient norm and pool statistics."""
    return metrics._replace(
        emd=c_metrics.emd,
        critic_gradient_norm=c_metrics.critic_gradient_norm,
        pool_avg_trajectory=c_metrics.pool_avg_trajectory,
        pool_terminated_frac=c_metrics.pool_terminated_frac)


def _leaves(params):
    """Fresh leaf tensors to differentiate, sharing ``params``' storage."""
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def pmean_bucket(mesh, tensors, scalars):
    """The means over ranks of ``tensors`` and 0-d ``scalars``, in one
    all-reduce of one flat float32 bucket; both unchanged without a process
    group."""
    if mesh is None or not mesh.grouped:
        return tensors, scalars
    flat = mesh.pmean(torch.cat([t.reshape(-1) for t in tensors] +
                                [s.reshape(1) for s in scalars]))
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out, list(flat[i:])


def _make_phase_bodies(cfg, policy, critic_mod, value_mod, filters,
                       local_batch, taps=None, mesh=None):
    """The generator-phase and critic-phase update cores.  ``taps``: a
    list each update appends its gradients to (and a generator update its
    selection), or None; ``mesh``: the ranks to average over, or None.
    Each update runs in float32 whatever the process's TF32 flags
    (``utils/precision.py``): the forward, the backward and the gradient
    penalty's double backward all launch inside it."""
    betas = (cfg.get('adam_beta1', 0.5), cfg.get('adam_beta2', 0.9))

    @tf32_off()
    def g_update(st, pl, fresh_triplet, draws, sc, i):
        """Generator update ``i`` of the step, its scalars from ``sc``."""
        (fresh_batch, fresh_gt), (fresh2, fresh2_gt), \
            (fresh_pool, fresh_pool_gt) = fresh_triplet
        sel_idx, b_img, b_states, dropped, b_gt = select_generator_batch(
            pl, draws, local_batch, fresh_batch, fresh_gt)

        params = {'gen': _leaves(st.gen_params),
                  'val': _leaves(st.val_params)}
        loss, aux = generator_value_loss(
            params, st.crit_params, policy, critic_mod, value_mod, b_img,
            b_states, draws, 1, sc.progress, cfg, filters, ground_truth=b_gt)
        names = [(tree, k) for tree in ('gen', 'val') for k in params[tree]]
        grads = torch.autograd.grad(loss, [params[t][k] for t, k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[t][k]) if g is None else g
                 for (t, k), g in zip(names, grads)]
        grads, (g_loss, v_loss, reward) = pmean_bucket(
            mesh, grads, [aux.g_loss, aux.v_loss, torch.mean(aux.reward)])
        grads = dict(zip(names, grads))

        if taps is not None:
            taps.append({
                'gen': {k: grads['gen', k] for k in st.gen_params},
                'val': {k: grads['val', k] for k in st.val_params},
                'sel_idx': sel_idx, 'ids': aux.selected_filter_id,
                'pdf': aux.pdf})
        with trace.region('train.adam', pl.images.device):
            gen_params, opt_g = apply_lr_update(
                {k: grads['gen', k] for k in st.gen_params}, st.opt_g,
                st.gen_params, sc.lr_g, *betas, bc=sc.bc_g[i])
            val_params, opt_v = apply_lr_update(
                {k: grads['val', k] for k in st.val_params}, st.opt_v,
                st.val_params, sc.lr_v, *betas, bc=sc.bc_v[i])
        st = st.replace(gen_params=gen_params, val_params=val_params,
                        opt_g=opt_g, opt_v=opt_v)

        pl = reinsert(pl, draws, sel_idx, aux.new_images, aux.new_states,
                      dropped, fresh2, fresh_pool,
                      cfg.maximum_trajectory_length,
                      cfg.over_length_keep_prob,
                      batch_gt=b_gt, fresh_gt_for_batch=fresh2_gt,
                      fresh_gt_for_pool=fresh_pool_gt)
        return st, pl, (g_loss, v_loss, reward)

    @tf32_off()
    def c_update(st, pool, real_batch, draws, sc, i):
        """Critic update ``i`` of the step, its scalars from ``sc``."""
        fake_batch, _ = sample_terminated(pool, draws, local_batch)
        crit = _leaves(st.crit_params)
        loss, aux = critic_loss(crit, critic_mod, real_batch, fake_batch,
                                draws, cfg)
        names = list(crit)
        grads = torch.autograd.grad(loss, [crit[k] for k in names])
        grads, (emd, cgn, c_average) = pmean_bucket(
            mesh, grads, [aux.emd, aux.critic_gradient_norm, aux.c_average])
        if taps is not None:
            taps.append({'crit': dict(zip(names, grads))})
        with trace.region('train.adam', pool.images.device):
            crit_params, opt_c = apply_lr_update(
                dict(zip(names, grads)), st.opt_c, st.crit_params, sc.lr_c,
                *betas, bc=sc.bc_c[i])
        if cfg.gan == 'w' and cfg.gradient_penalty_lambda <= 0:
            # weight clipping when the gradient penalty is off
            crit_params = clip_tree(crit_params, cfg.clamp_critic)
        st = st.replace(crit_params=crit_params, opt_c=opt_c,
                        ema=st.ema.update(c_average))
        return st, (emd, cgn)

    return g_update, c_update


def _finalize(state, pool, g_outs, c_outs, mesh=None):
    """The iteration's metrics, device tensors: the means over the updates
    (the critic gradient norm of the last critic update) and the pool's
    statistics, averaged over ranks.  A phase that ran no update gives NaN
    for its metrics, as the JAX mean of nothing does (the trainer takes
    them from the other phase)."""
    device = pool.images.device
    nan = torch.full((), float('nan'), device=device)
    _, (avg_traj, terminated_frac) = pmean_bucket(
        mesh, [], [pool.average_trajectory(),
                   torch.mean(pool.terminated_mask().to(torch.float32))])

    def mean(xs):
        return torch.stack(xs).mean() if xs else nan

    g_losses, v_losses, rewards = zip(*g_outs) if g_outs else ((), (), ())
    emds, cgns = zip(*c_outs) if c_outs else ((), ())
    metrics = StepMetrics(
        g_loss=mean(g_losses),
        v_loss=mean(v_losses),
        emd=mean(emds) if emds else torch.zeros((), device=device),
        critic_gradient_norm=cgns[-1] if cgns else torch.zeros(
            (), device=device),
        reward=mean(rewards),
        pool_avg_trajectory=avg_traj,
        pool_terminated_frac=terminated_frac,
    )
    return state, pool, metrics


def _check_divisibility(cfg, mesh):
    """The local batch of ``mesh``'s ranks; raises when the world size does
    not divide ``batch_size`` and ``replay_memory_size`` (JAX asserts)."""
    if mesh is None:
        return cfg.batch_size
    local_batch_size(cfg.replay_memory_size, mesh)
    return local_batch_size(cfg.batch_size, mesh)


def build_outer_step(cfg, policy, critic_mod, value_mod, filters,
                     fake_meta, real_meta, giters, citers, taps=None,
                     mesh=None):
    """The train step for fixed (giters, citers).

    ``fake_meta``/``real_meta`` are the packs' ``(output_size, augment)``;
    their images are passed at call time.  ``taps``: a list that every
    update appends its gradients to (``tools/train_check.py`` compares the
    card's with the CPU's).  ``mesh``: this rank's ``parallel.mesh.Mesh``
    (its shards of the packs and the pool are passed in), or None for one
    device.  Returns
    ``step(state, pool, fake_images, real_images, draws, lr_g, lr_c,
    progress, scalars=None) -> (state, pool, StepMetrics)``: the schedule
    as python floats, or as ``StepScalars`` on the device (``scalars``,
    which then takes the place of the three)."""
    local_batch = _check_divisibility(cfg, mesh)
    supervised = bool(cfg.get('supervised', False))
    if supervised and citers:
        raise ValueError('supervised mode has no critic updates')
    fake_size, fake_augment = fake_meta
    real_size, real_augment = real_meta
    img_channels = cfg.get('real_img_channels', 3)
    g_update, c_update = _make_phase_bodies(
        cfg, policy, critic_mod, value_mod, filters, local_batch, taps,
        mesh)

    def step(state, pool, fake_images, real_images, draws, lr_g=None,
             lr_c=None, progress=None, scalars=None):
        sc = scalars if scalars is not None else step_scalars(
            cfg, state, giters, citers, lr_g, lr_c, progress,
            pool.images.device)
        fake_pack = DevicePack(fake_images, fake_size, fake_augment)
        real_pack = DevicePack(real_images, real_size, real_augment)

        def sample_fake(n):
            """Fresh RAW; in supervised mode the pack carries (input, gt)
            pairs as stacked channels: returns (img, gt)."""
            batch = sample_batch(fake_pack, draws, n)
            if supervised:
                return channels_to_paired(batch, img_channels)
            return batch, None

        g_outs = []
        for i in range(giters):
            triplet = (sample_fake(local_batch), sample_fake(local_batch),
                       sample_fake(pool.size))
            state, pool, outs = g_update(state, pool, triplet, draws, sc, i)
            g_outs.append(outs)

        c_outs = []
        for i in range(citers):
            real_batch = sample_batch(real_pack, draws, local_batch)
            state, outs = c_update(state, pool, real_batch, draws, sc, i)
            c_outs.append(outs)
        return _finalize(state, pool, g_outs, c_outs, mesh)

    return step


_INV_255 = float(np.float32(1.0 / 255.0))


def dequant_stream(x):
    """A uint8 streaming bundle as float32: ``x * float32(1/255)``, the
    JAX expression (a product, not a quotient, so that the bits match; the
    native loader quantized ``round(clamp(v, 0, 1) * 255)``).  A float32
    bundle passes through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * _INV_255
    return x


def build_streaming_outer_step(cfg, policy, critic_mod, value_mod, filters,
                               giters, citers, taps=None, mesh=None):
    """The streaming train step for fixed (giters, citers): the updates of
    ``build_outer_step`` (the same phase bodies and ``_finalize``), with
    the fresh crops taken from a host-assembled bundle instead of the
    device sampler.  Returns ``step(state, pool, g_fresh, real_batches,
    draws, lr_g, lr_c, progress) -> (state, pool, StepMetrics)`` where

    - ``g_fresh``: [giters, 2B + P, S, S, C] float32 or uint8; generator
      update ``i`` takes ``g_fresh[i][:B]`` (the selection's backfill),
      ``[B:2B]`` (over-length replacements) and ``[2B:2B + P]`` (dropped
      pool slots); in supervised mode each crop carries its ground truth
      as C more channels ([..., 2C]);
    - ``real_batches``: [citers, B, S, S, C] float32 or uint8.

    Under ``mesh`` a rank is given its shard of both along axis 1
    (``P(None, DATA_AXIS)``), B and P its local sizes.

    The draws are the resident step's without the sampler's: per generator
    update ``rank``, ``dropout``/``noise`` and ``keep`` (JAX's ``k_sel``,
    ``k_step``, ``k_keep``), per critic update ``terminated`` and
    ``alpha`` (``k_fake``, ``k_gp``).  The schedule comes as in
    ``build_outer_step``."""
    local_batch = _check_divisibility(cfg, mesh)
    supervised = bool(cfg.get('supervised', False))
    if supervised and citers:
        raise ValueError('supervised mode has no critic updates')
    img_channels = cfg.get('real_img_channels', 3)
    g_update, c_update = _make_phase_bodies(
        cfg, policy, critic_mod, value_mod, filters, local_batch, taps,
        mesh)

    def pair(x):
        if supervised:
            return x[..., :img_channels], x[..., img_channels:]
        return x, None

    def step(state, pool, g_fresh, real_batches, draws, lr_g=None,
             lr_c=None, progress=None, scalars=None):
        sc = scalars if scalars is not None else step_scalars(
            cfg, state, giters, citers, lr_g, lr_c, progress,
            pool.images.device)
        g_fresh = dequant_stream(g_fresh)
        real_batches = dequant_stream(real_batches)
        b = local_batch
        g_outs = []
        for i in range(giters):
            fresh = g_fresh[i]
            triplet = (pair(fresh[:b]), pair(fresh[b:2 * b]),
                       pair(fresh[2 * b:2 * b + pool.size]))
            state, pool, outs = g_update(state, pool, triplet, draws, sc, i)
            g_outs.append(outs)
        c_outs = []
        for i in range(citers):
            state, outs = c_update(state, pool, real_batches[i], draws, sc,
                                   i)
            c_outs.append(outs)
        return _finalize(state, pool, g_outs, c_outs, mesh)

    return step


def _fused(cfg, g_step, c_step, giters, citers, draws_for, generator, mesh,
           stacked):
    """A ``FusedRunner`` of the plain iteration ``g_step`` then ``c_step``
    (either None without its updates), as ``Trainer.run_iteration`` runs
    it."""
    def body(state, pool, data, draws, scalars):
        g_data = c_data = data
        if stacked:     # the iteration's slice of the bundle, by phase
            g_data, c_data = (data[0], data[1][:0]), (data[0][:0], data[1])
        metrics = None
        device = pool.images.device
        if g_step is not None:
            with trace.region('train.generator', device):
                state, pool, metrics = g_step(state, pool, *g_data, draws,
                                              scalars=scalars)
        if c_step is not None:
            with trace.region('train.critic', device):
                state, pool, c_metrics = c_step(state, pool, *c_data, draws,
                                                scalars=scalars)
            metrics = c_metrics if metrics is None else with_critic(
                metrics, c_metrics)
        return state, pool, metrics

    def row(state, lr_g, lr_c, progress):
        return scalar_row(cfg, state, giters, citers, lr_g, lr_c, progress)

    return FusedRunner(body, row,
                       lambda vec: scalars_view(vec, giters, citers),
                       scalar_width(giters, citers), giters, citers,
                       draws_for, generator, stacked, mesh)


def build_fused_iterations_step(cfg, policy, critic_mod, value_mod, filters,
                                fake_meta, real_meta, giters, citers,
                                draws_for, generator=None, mesh=None):
    """N plain outer iterations of fixed ``(giters, citers)`` in one call
    (the JAX ``build_fused_iterations_step``): on the card one iteration
    captured as a CUDA graph and replayed N times, on the CPU the same body
    run N times (``core/fused.py``), bit for bit the iterations run one by
    one through ``build_outer_step``'s generator step then critic step.
    ``draws_for(it)``: iteration ``it``'s ``Draws``, from ``generator``
    reseeded for it (on the card the graph holds ``generator``).  Returns
    a ``FusedRunner``: ``run(state, pool, (fake_images, real_images),
    iters, lr_gs, lr_cs, progresses) -> (state, pool, metrics [N, 7])``,
    the JAX call less its key."""
    g_step = build_outer_step(cfg, policy, critic_mod, value_mod, filters,
                              fake_meta, real_meta, giters, 0,
                              mesh=mesh) if giters else None
    c_step = build_outer_step(cfg, policy, critic_mod, value_mod, filters,
                              fake_meta, real_meta, 0, citers,
                              mesh=mesh) if citers else None
    return _fused(cfg, g_step, c_step, giters, citers, draws_for, generator,
                  mesh, stacked=False)


def build_streaming_fused_step(cfg, policy, critic_mod, value_mod, filters,
                               giters, citers, draws_for, generator=None,
                               mesh=None):
    """N streaming outer iterations in one call (the JAX
    ``build_streaming_fused_step``), as ``build_fused_iterations_step``
    runs them, on a chunk's bundle: ``run(state, pool, (g_fresh [N, giters,
    2B + P, S, S, C], real [N, citers, B, S, S, C]), iters, lr_gs, lr_cs,
    progresses)``; iteration i trains on slice i, float32 or uint8."""
    g_step = build_streaming_outer_step(
        cfg, policy, critic_mod, value_mod, filters, giters, 0,
        mesh=mesh) if giters else None
    c_step = build_streaming_outer_step(
        cfg, policy, critic_mod, value_mod, filters, 0, citers,
        mesh=mesh) if citers else None
    return _fused(cfg, g_step, c_step, giters, citers, draws_for, generator,
                  mesh, stacked=True)
