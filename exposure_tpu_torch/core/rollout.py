"""Trajectory rollouts (torch counterpart of
``exposure_tpu/core/rollout.py``).

``rollout`` runs K ``agent_step``s, the 8-candidate bank formulation, as a
Python loop over the steps (the JAX ``lax.scan``) with no host
synchronisation.  ``serve_rollout`` is the serving-only plan: each step
regresses every filter's parameter head, takes the argmax of the
epsilon-mixed action distribution, and advances the 64px proxy through the
dynamic chain kernel on the selected branch only, the same kernel and
branch math the full-resolution replay uses.  Both draw dropout from one
``torch.Generator`` in step order; at ``is_train=0`` ``rollout`` draws no
selection noise, so the two plans see the same dropout at every step.

Every plan runs in float32 whatever the process's TF32 flags
(``utils/precision.py``), per call and in a captured graph, which replays
the kernels launched inside the contract; a bfloat16 policy and proxy (the
bf16 plan) stay bfloat16."""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from exposure_tpu_torch.models.agent import (
    action_distribution,
    advance_states,
    agent_step,
    enrich_image_input,
    initial_states,
    pack_param_rows,
)
from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
from exposure_tpu_torch.utils.precision import tf32_off


class Trajectory(NamedTuple):
    images: torch.Tensor        # [K, B, S, S, C] per-step outputs
    states: torch.Tensor        # [K, B, D]
    filter_ids: torch.Tensor    # [K, B] int32
    params: torch.Tensor        # [K, B, max_p]
    mask_params: torch.Tensor   # [K, B, max_mask] raw mask-head outputs
    pdfs: torch.Tensor          # [K, B, num_filters]
    surrogates: torch.Tensor    # [K, B, 1]
    final_image: torch.Tensor   # [B, S, S, C]
    final_state: torch.Tensor   # [B, D]


@tf32_off()
def rollout(policy, images, generator, *, cfg, filters, is_train=0,
            num_steps=None, progress=1.0):
    """Run ``num_steps`` (default ``cfg.test_steps``) agent steps."""
    if num_steps is None:
        num_steps = cfg.test_steps
    img = images
    st = initial_states(images.shape[0], cfg.num_state_dim, images.dtype,
                        images.device)
    ys = []
    for _ in range(num_steps):
        out = agent_step(policy, img, st, generator, is_train=is_train,
                         progress=progress, cfg=cfg, filters=filters)
        img, st = out.image, out.new_states
        ys.append((out.image, out.new_states, out.selected_filter_id,
                   out.selected_params, out.selected_mask_params, out.pdf,
                   out.surrogate))
    imgs, sts, ids, params, mask_params, pdfs, surs = (
        torch.stack(y) for y in zip(*ys))
    return Trajectory(images=imgs, states=sts, filter_ids=ids, params=params,
                      mask_params=mask_params, pdfs=pdfs, surrogates=surs,
                      final_image=img, final_state=st)


@tf32_off()
def serve_rollout(policy, images, generator, *, cfg, filters,
                  num_steps=None, fast_math=True):
    """Plan a trajectory for a batch of proxies.

    Args:
      policy: the ``PolicyNet``.
      images: [B, S, S, 3] float32 proxies in [0, 1].
      generator: ``torch.Generator`` on the images' device, for dropout.

    Returns ``(filter_ids [K, B] int32, params [K, B, max_p],
    mask_params [K, B, max_m])`` for K = ``num_steps`` (default
    ``cfg.test_steps``).  The proxy advances through the branch set the
    replay uses (``fast_math``).
    """
    if num_steps is None:
        num_steps = cfg.test_steps
    batch = images.shape[0]
    num_filters = len(filters)
    masking = any(f.use_masking() for f in filters)
    img = images
    st = initial_states(batch, cfg.num_state_dim, images.dtype,
                        images.device)
    rows = torch.arange(batch, device=images.device)
    ids, params, masks = [], [], []
    for _ in range(num_steps):
        enriched = enrich_image_input(cfg, img, st)
        raw_list, logits = policy(enriched, generator)

        params_list, raw_masks = [], []
        for f, raw in zip(filters, raw_list):
            n = f.get_num_filter_parameters()
            params_list.append(f.filter_param_regressor(raw[:, :n]))
            raw_masks.append(raw[:, n:] if f.use_masking() else None)
        packed, packed_mask = pack_param_rows(
            filters, params_list, raw_masks, batch, img.dtype)

        # serving is argmax: the uniform selection draw is not needed
        pdf = action_distribution(logits, cfg, num_filters)
        selected_id = torch.argmax(pdf, dim=1).to(torch.int32)
        sel_params = packed[rows, selected_id.long()]
        sel_mask = packed_mask[rows, selected_id.long()]

        out = apply_filter_chain_dynamic(
            img.to(torch.float32), selected_id[None],
            sel_params.to(torch.float32)[None], filters,
            mask_params=(sel_mask.to(torch.float32)[None]
                         if masking else None),
            fast_math=fast_math).to(img.dtype)
        if cfg.clamp:
            out = torch.clamp(out, 0.0, 5.0)

        one_hot = F.one_hot(selected_id.long(), num_filters).to(img.dtype)
        st, _, _ = advance_states(st, one_hot, cfg, img.dtype)
        img = out
        ids.append(selected_id)
        params.append(sel_params)
        masks.append(sel_mask)
    return torch.stack(ids), torch.stack(params), torch.stack(masks)
