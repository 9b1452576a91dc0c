"""The outer training iteration, eager and on one device: a frozen copy of
the generator and critic updates of ``exposure_tpu_torch/core/steps.py``
(``_make_phase_bodies``, ``pmean_bucket``, ``_finalize``,
``build_outer_step``) with the fused dispatch and the streaming step taken
out.  ``mesh``: an object with ``grouped`` and ``pmean(flat)`` (the mean
over ranks), or None for one device.

Precision is the caller's: nothing here sets the TF32 flags (the program's
updates run inside its own ``tf32_off``), so the reference sets them off
and the control on (``benchmark/reference/train.py``).

One iteration is ``giters`` generator+value updates, then ``citers`` critic
WGAN-GP updates, drawing from one ``Draws`` in the program's order.  The
schedule's scalars come as ``StepScalars`` formed by ``scalar_row``.
"""

from typing import NamedTuple

import torch

from .device_sampler import DevicePack, sample_batch
from .losses import critic_loss, generator_value_loss
from .replay import reinsert, sample_terminated, select_generator_batch
from .train_state import apply_lr_update, bias_corrections, clip_tree


class StepMetrics(NamedTuple):
    g_loss: torch.Tensor
    v_loss: torch.Tensor
    emd: torch.Tensor
    critic_gradient_norm: torch.Tensor
    reward: torch.Tensor
    pool_avg_trajectory: torch.Tensor
    pool_terminated_frac: torch.Tensor


class StepScalars(NamedTuple):
    """Learning rates, progress and each update's ``(bc1, bc2)``."""

    lr_g: torch.Tensor
    lr_v: torch.Tensor
    lr_c: torch.Tensor
    progress: torch.Tensor
    bc_g: torch.Tensor
    bc_v: torch.Tensor
    bc_c: torch.Tensor


def scalar_row(cfg, state, giters, citers, lr_g, lr_c, progress):
    """The host values of ``StepScalars`` from ``state``'s Adam counts."""
    b1, b2 = cfg.get('adam_beta1', 0.5), cfg.get('adam_beta2', 0.9)
    row = [lr_g, lr_g * cfg.value_lr_mul, lr_c, progress]
    for opt, n in ((state.opt_g, giters), (state.opt_v, giters),
                   (state.opt_c, citers)):
        for pair in bias_corrections(opt.count, n, b1, b2):
            row += pair
    return row


def step_scalars(cfg, state, giters, citers, lr_g, lr_c, progress, device):
    vec = torch.tensor(scalar_row(cfg, state, giters, citers, lr_g, lr_c,
                                  progress), dtype=torch.float32).to(device)
    g, c = 2 * giters, 2 * citers
    return StepScalars(vec[0], vec[1], vec[2], vec[3],
                       vec[4:4 + g].view(giters, 2),
                       vec[4 + g:4 + 2 * g].view(giters, 2),
                       vec[4 + 2 * g:4 + 2 * g + c].view(citers, 2))


def _leaves(params):
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def pmean_bucket(mesh, tensors, scalars):
    """The means over ranks of ``tensors`` and 0-d ``scalars``, as one flat
    bucket; both unchanged without a group."""
    if mesh is None or not mesh.grouped:
        return tensors, scalars
    flat = mesh.pmean(torch.cat([t.reshape(-1) for t in tensors] +
                                [s.reshape(1) for s in scalars]))
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out, list(flat[i:])


def phase_bodies(cfg, policy, critic_mod, value_mod, filters, local_batch,
                 mesh=None):
    """``(g_update, c_update)``: one generator+value update and one critic
    update, as the program's ``_make_phase_bodies``."""
    betas = (cfg.get('adam_beta1', 0.5), cfg.get('adam_beta2', 0.9))

    def g_update(st, pl, fresh_triplet, draws, sc, i):
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

    def c_update(st, pool, real_batch, draws, sc, i):
        fake_batch, _ = sample_terminated(pool, draws, local_batch)
        crit = _leaves(st.crit_params)
        loss, aux = critic_loss(crit, critic_mod, real_batch, fake_batch,
                                draws, cfg)
        names = list(crit)
        grads = torch.autograd.grad(loss, [crit[k] for k in names])
        grads, (emd, cgn, c_average) = pmean_bucket(
            mesh, grads, [aux.emd, aux.critic_gradient_norm, aux.c_average])
        crit_params, opt_c = apply_lr_update(
            dict(zip(names, grads)), st.opt_c, st.crit_params, sc.lr_c,
            *betas, bc=sc.bc_c[i])
        if cfg.gan == 'w' and cfg.gradient_penalty_lambda <= 0:
            crit_params = clip_tree(crit_params, cfg.clamp_critic)
        st = st.replace(crit_params=crit_params, opt_c=opt_c,
                        ema=st.ema.update(c_average))
        return st, (emd, cgn)

    return g_update, c_update


def outer_iteration(cfg, policy, critic_mod, value_mod, filters, fake_meta,
                    real_meta, giters, citers, mesh=None, world=1):
    """``step(state, pool, fake_images, real_images, draws, sc) -> (state,
    pool, StepMetrics)``: the generator phase then the critic phase of one
    plain iteration, on the device-resident packs (a rank's shards of them
    and of the pool, its ``batch_size / world`` a batch, under ``mesh``)."""
    b = cfg.batch_size // world
    g_update, c_update = phase_bodies(cfg, policy, critic_mod, value_mod,
                                      filters, b, mesh)

    def step(state, pool, fake_images, real_images, draws, sc):
        fake_pack = DevicePack(fake_images, *fake_meta)
        real_pack = DevicePack(real_images, *real_meta)
        g_outs, c_outs = [], []
        for i in range(giters):
            triplet = ((sample_batch(fake_pack, draws, b), None),
                       (sample_batch(fake_pack, draws, b), None),
                       (sample_batch(fake_pack, draws, pool.size), None))
            state, pool, outs = g_update(state, pool, triplet, draws, sc, i)
            g_outs.append(outs)
        for i in range(citers):
            real_batch = sample_batch(real_pack, draws, b)
            state, outs = c_update(state, pool, real_batch, draws, sc, i)
            c_outs.append(outs)
        g_losses, v_losses, rewards = zip(*g_outs)
        emds, cgns = zip(*c_outs)
        _, (avg_traj, terminated) = pmean_bucket(
            mesh, [], [pool.average_trajectory(),
                       torch.mean(pool.terminated_mask().to(torch.float32))])
        metrics = StepMetrics(
            g_loss=torch.stack(g_losses).mean(),
            v_loss=torch.stack(v_losses).mean(),
            emd=torch.stack(emds).mean(),
            critic_gradient_norm=cgns[-1],
            reward=torch.stack(rewards).mean(),
            pool_avg_trajectory=avg_traj,
            pool_terminated_frac=terminated)
        return state, pool, metrics

    return step
