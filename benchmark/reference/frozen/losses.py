"""Loss functions: dense RL reward, TD(0) advantage, WGAN-GP (torch
counterpart of ``exposure_tpu/core/losses.py``).

- reward    = (all_reward + (1 - all_reward) * stopped) *
              (fake_logit - sg(input_logit)) * critic_logit_multiplier
              - penalty
- q         = reward + (1 - stopped) * gamma * V(s'), V(s') zeroed past the
              maximum trajectory length
- advantage = sg(q) - V(s); v_loss = E[advantage^2]
- g_loss    = E[-q * parameter_lr_mul + log pi * sg(-advantage)]
- c_loss    = E[fake] - E[real] + lambda * GP, one-sided GP on uniform
              interpolates

The networks run through ``torch.func.functional_call`` on parameter
dicts.  In the generator path the critic's and the value net's
*parameters* are detached, and their activations stay live: the pathwise
reward reaches the generator, and one ``torch.autograd.grad`` over the
{gen, val} leaves gives each optimizer its own gradient, as the JAX
``stop_gradient`` of the parameter trees does.
"""

from typing import NamedTuple

import torch
from torch.func import functional_call

from .agent import agent_step
from .ops import STATE_STEP_DIM, STATE_STOPPED_DIM, clip


def apply(module, params, *args):
    """``module`` run on the tensors of ``params`` in place of its own."""
    return functional_call(module, params, args)


def _detached(params):
    return {k: v.detach() for k, v in params.items()}


class GVLossAux(NamedTuple):
    g_loss: torch.Tensor
    v_loss: torch.Tensor
    reward: torch.Tensor
    q_value: torch.Tensor
    advantage: torch.Tensor
    fake_logit: torch.Tensor
    new_images: torch.Tensor
    new_states: torch.Tensor
    selected_filter_id: torch.Tensor
    selected_params: torch.Tensor
    pdf: torch.Tensor


def supervised_distance(images, ground_truth):
    """Default supervised scorer: per-sample MSE to the paired ground
    truth (lower is better; the reward negates it)."""
    return torch.mean((images - ground_truth) ** 2, dim=(1, 2, 3))[:, None]


def generator_value_loss(params, crit_params, policy, critic, value,
                         batch_images, batch_states, draws, is_train,
                         progress, cfg, filters, ground_truth=None):
    """Joint scalar loss for the generator (actor) and value optimizers.

    Args:
      params: ``{'gen': policy params, 'val': value params}``, the tensors
        to differentiate.
      crit_params: critic params (constants here).
      draws: the step's ``utils/draws.py::Draws`` (dropout, then the
        selection noise).
      ground_truth: paired targets, supervised mode only.
    Returns:
      ``(g_loss + v_loss, GVLossAux)``
    """
    supervised = bool(cfg.get('supervised', False))
    out = agent_step(
        lambda x, g: apply(policy, params['gen'], x, g), batch_images,
        batch_states, draws, is_train=is_train, progress=progress, cfg=cfg,
        filters=filters)

    if supervised:
        if ground_truth is None:
            raise ValueError('supervised mode requires paired ground truth')
        scorer = cfg.get('supervised_scorer', None) or supervised_distance
        fake_logit = scorer(out.image, ground_truth)
        input_logit = scorer(batch_images, ground_truth)
    else:
        crit = _detached(crit_params)
        fake_logit = apply(critic, crit, out.image)
        input_logit = apply(critic, crit, batch_images)

    old_value = apply(value, params['val'], batch_images, batch_states)
    new_value_for_g = apply(value, _detached(params['val']), out.image,
                            out.new_states)

    stopped = out.new_states[:, STATE_STOPPED_DIM:STATE_STOPPED_DIM + 1]
    clear_final = (out.new_states[:, STATE_STEP_DIM:STATE_STEP_DIM + 1]
                   > cfg.maximum_trajectory_length).to(torch.float32)
    new_value_for_g = new_value_for_g * (1.0 - clear_final)

    all_mask = cfg.all_reward + (1 - cfg.all_reward) * stopped
    if supervised:
        raw_reward = all_mask * (-fake_logit)
    elif cfg.gan == 'ls':
        raw_reward = all_mask * (1 - (fake_logit - 1) ** 2)
    else:
        raw_reward = all_mask * (
            fake_logit - input_logit.detach()) * cfg.critic_logit_multiplier
    reward = raw_reward
    if cfg.use_penalty:
        reward = reward - out.penalty

    q_value = reward + (1.0 - stopped) * cfg.discount_factor * new_value_for_g
    advantage = q_value.detach() - old_value
    v_loss = torch.mean(advantage ** 2)

    if cfg.use_TD:
        routine_loss = -q_value * cfg.parameter_lr_mul
        adv_for_pg = -advantage
    else:
        routine_loss = -reward
        adv_for_pg = -reward
    g_loss = torch.mean(routine_loss + out.surrogate * adv_for_pg.detach())

    aux = GVLossAux(
        g_loss=g_loss.detach(), v_loss=v_loss.detach(),
        reward=reward.detach(), q_value=q_value.detach(),
        advantage=advantage.detach(), fake_logit=fake_logit.detach(),
        new_images=out.image.detach(), new_states=out.new_states.detach(),
        selected_filter_id=out.selected_filter_id,
        selected_params=out.selected_params.detach(),
        pdf=out.pdf.detach())
    return g_loss + v_loss, aux


class CriticLossAux(NamedTuple):
    c_loss: torch.Tensor
    emd: torch.Tensor
    gradient_penalty: torch.Tensor
    critic_gradient_norm: torch.Tensor
    c_average: torch.Tensor


def critic_loss(crit_params, critic, real_images, fake_images, draws, cfg):
    """Critic loss: WGAN-GP or LSGAN.  The interpolation weight ``alpha``
    is drawn per row of the batch (``draws``' ``alpha``), and the penalty's
    per-sample input gradients come from the gradient of the summed logits
    (the rows are independent), kept in the graph so the penalty trains
    the critic."""
    fake_logit = apply(critic, crit_params, fake_images)
    real_logit = apply(critic, crit_params, real_images)
    if cfg.gan == 'ls':
        c_loss = torch.mean(fake_logit ** 2) + torch.mean(
            (real_logit - 1) ** 2)
        emd = c_loss
        c_average = torch.zeros((), device=real_images.device)
    else:
        c_loss = torch.mean(fake_logit) - torch.mean(real_logit)
        emd = -c_loss
        c_average = torch.mean(fake_logit + real_logit) * 0.5

    alpha = draws.uniform('alpha', (real_images.shape[0], 1, 1, 1))
    interpolated = (real_images + alpha * (fake_images - real_images)) \
        .detach().requires_grad_(True)
    gradients, = torch.autograd.grad(
        apply(critic, crit_params, interpolated).sum(), interpolated,
        create_graph=True)
    gradient_norm = torch.sqrt(1e-6 + torch.sum(gradients ** 2,
                                                dim=(1, 2, 3)))
    gradient_penalty = cfg.gradient_penalty_lambda * torch.mean(
        clip(gradient_norm - 1.0, lo=0.0) ** 2)
    if cfg.gan == 'w' and cfg.gradient_penalty_lambda > 0:
        c_loss = c_loss + gradient_penalty

    aux = CriticLossAux(
        c_loss=c_loss.detach(), emd=emd.detach(),
        gradient_penalty=gradient_penalty.detach(),
        critic_gradient_norm=torch.mean(gradient_norm).detach(),
        c_average=c_average.detach())
    return c_loss, aux
