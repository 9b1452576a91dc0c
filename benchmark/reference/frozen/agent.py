"""The agent step (torch counterpart of ``exposure_tpu/models/agent.py``)
and its helpers: the state-enriched policy input, the packed trajectory
rows the chain kernels consume, the action distribution and the
trajectory state machine.

``agent_step`` is the training formulation of one step: every filter of
the bank is applied to the proxy and the candidates are blended by the
one-hot selection.  The bank-plan serving modes plan with it (through
``core/rollout.py::rollout``); the selected-plan mode uses
``serve_rollout``, which advances the proxy through the selected branch
only.
"""

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .filters import max_filter_parameters
from .sampling import pdf_sample
from .draws import randint, uniform
from .ops import (
    STATE_DROPOUT_BEGIN,
    STATE_STEP_DIM,
    clip,
)


def enrich_image_input(cfg, img, states):
    """Broadcast the state vector as constant channels onto the NHWC image,
    gated by ``cfg.img_include_states``."""
    if cfg.img_include_states:
        bcast = states[:, None, None, :] + img[:, :, :, 0:1] * 0
        img = torch.cat([img, bcast], dim=3)
    return img


def initial_states(batch_size, num_state_dim, dtype=torch.float32,
                   device=None):
    """Fresh trajectory state: all zeros."""
    return torch.zeros((batch_size, num_state_dim), dtype=dtype,
                       device=device)


def pack_param_rows(filters, params_list, raw_mask_list, batch, dtype):
    """Pack per-filter regressed params and raw mask heads into the
    fixed-width layout ``(packed [B, K, max_p], packed_mask [B, K, max_m])``."""
    max_p = max_filter_parameters(filters)
    max_m = max(f.get_num_mask_parameters() for f in filters)
    packed, packed_mask = [], []
    for p, raw_m in zip(params_list, raw_mask_list):
        flat = p.reshape(p.shape[0], -1)
        packed.append(F.pad(flat, (0, max_p - flat.shape[1])))
        if raw_m is not None:
            packed_mask.append(F.pad(raw_m, (0, max_m - raw_m.shape[1])))
        else:
            packed_mask.append(torch.zeros((batch, max_m), dtype=dtype,
                                           device=flat.device))
    return torch.stack(packed, dim=1), torch.stack(packed_mask, dim=1)


def action_distribution(logits, cfg, num_filters):
    """Softmax + epsilon exploration mix."""
    pdf = torch.softmax(logits, dim=1) + 1e-37
    pdf = pdf * (1 - cfg.exploration) + cfg.exploration / num_filters
    return pdf / (torch.sum(pdf, dim=1, keepdim=True) + 1e-30)


def advance_states(states, one_hot, cfg, dtype):
    """State-machine step: returns ``(new_states, is_last_step,
    usage_penalty)``."""
    step = states[:, STATE_STEP_DIM:STATE_STEP_DIM + 1]
    is_last_step = (torch.abs(step + 1 - cfg.test_steps) < 1e-4).to(dtype)
    usage = states[:, STATE_DROPOUT_BEGIN:]
    usage_penalty = torch.sum(usage * one_hot, dim=1, keepdim=True)
    new_usage = torch.maximum(usage, one_hot)
    new_states = torch.cat([is_last_step, is_last_step, step + 1, new_usage],
                           dim=1)
    return new_states, is_last_step, usage_penalty


class AgentStepOutput(NamedTuple):
    image: torch.Tensor            # [B, H, W, C] selected filtered image
    new_states: torch.Tensor       # [B, state_dim]
    surrogate: torch.Tensor        # [B, 1] log pi(selected)
    penalty: torch.Tensor          # [B, 1]
    selected_filter_id: torch.Tensor   # [B] int32
    selected_params: torch.Tensor  # [B, max_params] packed regressed params
    selected_mask_params: torch.Tensor  # [B, max_mask] raw mask params
    pdf: torch.Tensor              # [B, K] post-mixing action distribution
    entropy: torch.Tensor          # [B, 1]
    all_params: Any                # list of per-filter regressed params
    high_res_output: Optional[torch.Tensor]  # [B, Hh, Wh, C] or None


def _is_zero(x):
    return not torch.is_tensor(x) and not x


def agent_step(policy, img, states, generator, *, is_train, progress, cfg,
               filters, high_res=None, selection_noise=None):
    """Run one policy + filter step.

    Args:
      policy: the ``PolicyNet``.
      img: [B, H, W, C] low-res proxy in [0, 1].
      states: [B, state_dim] trajectory state.
      generator: ``torch.Generator`` on the image's device (or None for
        the global one), or a training step's ``utils/draws.py::Draws``.
        Dropout draws from it first, then the selection noise, as the JAX
        step splits its key into (dropout, noise).
      is_train: 1 samples the action, 0 takes the argmax; an int or an
        int tensor, blended arithmetically as the reference does.  With a
        python 0 the sample is not used, so no selection noise is drawn.
      progress: float (or scalar tensor) in [0, 1]; decays the entropy
        penalty.
      high_res: optional [B, Hh, Wh, C] image given the same step.
      selection_noise: optional [B, 1] uniform noise in place of the
        drawn one.
    """
    num_filters = len(filters)
    batch = img.shape[0]
    enriched = enrich_image_input(cfg, img, states)
    raw_list, logits = policy(enriched, generator)

    candidates, hi_candidates, all_params, raw_masks = [], [], [], []
    for f, raw in zip(filters, raw_list):
        n = f.get_num_filter_parameters()
        raw_m = raw[:, n:] if f.use_masking() else None
        low, hi, params = f.apply(img, raw_parameters=raw[:, :n],
                                  mask_parameters=raw_m, high_res=high_res)
        candidates.append(low)
        hi_candidates.append(hi)
        all_params.append(params)
        raw_masks.append(raw_m)
    candidates = torch.stack(candidates, dim=1)  # [B, K, H, W, C]
    packed, packed_mask = pack_param_rows(filters, all_params, raw_masks,
                                          batch, img.dtype)

    pdf = action_distribution(logits, cfg, num_filters)
    entropy = torch.sum(-pdf * torch.log(pdf), dim=1)[:, None]

    inject_p = float(cfg.replay_inject_prob or 0.0)
    greedy_id = torch.argmax(pdf, dim=1).to(torch.int32)
    if selection_noise is None and (not _is_zero(is_train) or inject_p > 0):
        selection_noise = uniform(generator, 'noise', (batch, 1), img.device)
    if selection_noise is not None:
        sampled_id = pdf_sample(pdf, selection_noise)
    else:   # is_train is a python 0: the blend keeps the greedy id
        sampled_id = greedy_id
    if torch.is_tensor(is_train):
        is_train = is_train.to(torch.int32)
        selected_id = is_train * sampled_id + (1 - is_train) * greedy_id
    else:
        selected_id = sampled_id if is_train else greedy_id

    # Replay-pool off-policy injection (training only): with probability
    # replay_inject_prob the action is forced to a random filter (uniform,
    # or ~ 1 / (pdf + 0.02) in 'anti' mode) and its surrogate is zeroed.
    # The draws come after the selection noise on the same generator.
    injected = None
    if inject_p > 0.0:
        injected = uniform(generator, 'inject', (batch,), img.device) \
            < inject_p
        for gate in (is_train > 0 if torch.is_tensor(is_train)
                     else bool(is_train),
                     progress < cfg.replay_inject_until):
            injected = injected & gate if torch.is_tensor(gate) else \
                (injected if gate else torch.zeros_like(injected))
        if str(cfg.replay_inject_mode) == 'anti':
            q = 1.0 / (pdf + 0.02)
            q = q / torch.sum(q, dim=1, keepdim=True)
            forced_id = pdf_sample(q, uniform(generator, 'forced', (batch, 1),
                                              img.device))
        else:
            forced_id = randint(generator, 'forced', num_filters, (batch,),
                                img.device).to(torch.int32)
        selected_id = torch.where(injected, forced_id, selected_id)

    one_hot = F.one_hot(selected_id.long(), num_filters).to(img.dtype)
    surrogate = torch.sum(one_hot * torch.log(pdf + 1e-10), dim=1,
                          keepdim=True)
    if injected is not None:
        surrogate = torch.where(injected[:, None],
                                torch.zeros_like(surrogate), surrogate)

    out = torch.sum(candidates * one_hot[:, :, None, None, None], dim=1)
    high_res_output = None
    if high_res is not None:
        hi_stack = torch.stack(hi_candidates, dim=1)
        high_res_output = torch.sum(
            hi_stack * one_hot[:, :, None, None, None], dim=1)
    selected_params = torch.sum(packed * one_hot[:, :, None], dim=1)
    selected_mask_params = torch.sum(packed_mask * one_hot[:, :, None],
                                     dim=1)

    # this release terminates exactly at cfg.test_steps
    new_states, is_last_step, usage_penalty = advance_states(
        states, one_hot, cfg, img.dtype)
    submitted = is_last_step
    if cfg.clamp:
        out = clip(out, 0.0, 5.0)

    early_stop_penalty = (1 - is_last_step) * submitted * \
        cfg.early_stop_penalty
    # linear entropy-bonus decay, plus the optional triangular re-spike
    decay = 1.0 - progress
    respike = float(cfg.entropy_respike or 0.0)
    if respike > 0.0:
        bump = 1.0 - abs(progress - cfg.entropy_respike_center) / \
            cfg.entropy_respike_width
        decay = decay + respike * (clip(bump, lo=0.0)
                                   if torch.is_tensor(bump)
                                   else max(0.0, bump))
    entropy_penalty = decay * cfg.exploration_penalty * (
        -entropy + math.log(num_filters))
    overflow = torch.mean(clip(out - 1, lo=0.0) ** 2,
                          dim=(1, 2, 3))[:, None]
    penalty = (overflow + entropy_penalty +
               usage_penalty * cfg.filter_usage_penalty + early_stop_penalty)

    return AgentStepOutput(
        image=out,
        new_states=new_states,
        surrogate=surrogate,
        penalty=penalty,
        selected_filter_id=selected_id,
        selected_params=selected_params,
        selected_mask_params=selected_mask_params,
        pdf=pdf,
        entropy=entropy,
        all_params=all_params,
        high_res_output=high_res_output,
    )
