"""Serving-side agent helpers (torch counterpart of the helpers in
``exposure_tpu/models/agent.py``): the state-enriched policy input, the
packed trajectory rows the chain kernel consumes, the action distribution
and the trajectory state machine."""

import torch
import torch.nn.functional as F

from exposure_tpu_torch.ops.filters import max_filter_parameters
from exposure_tpu_torch.utils.ops import STATE_DROPOUT_BEGIN, STATE_STEP_DIM


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
