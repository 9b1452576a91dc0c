"""Serving rollout (torch counterpart of
``exposure_tpu/core/rollout.py::serve_rollout``).

Each step regresses every filter's parameter head, takes the argmax of the
epsilon-mixed action distribution, and advances the 64px proxy through the
dynamic chain kernel on the selected branch only: the same kernel and
branch math the full-resolution replay uses.  The loop runs on the device
with no host synchronisation."""

import torch
import torch.nn.functional as F

from exposure_tpu_torch.models.agent import (
    action_distribution,
    advance_states,
    enrich_image_input,
    initial_states,
    pack_param_rows,
)
from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic


def serve_rollout(policy, images, generator, *, cfg, filters):
    """Plan a trajectory for a batch of proxies.

    Args:
      policy: the ``PolicyNet``.
      images: [B, S, S, 3] float32 proxies in [0, 1].
      generator: ``torch.Generator`` on the images' device, for dropout.

    Returns ``(filter_ids [K, B] int32, params [K, B, max_p],
    mask_params [K, B, max_m])`` for K = ``cfg.test_steps``.  The proxy
    advances through the fast branch set, as the replay does.
    """
    batch = images.shape[0]
    num_filters = len(filters)
    masking = any(f.use_masking() for f in filters)
    img = images
    st = initial_states(batch, cfg.num_state_dim, images.dtype,
                        images.device)
    rows = torch.arange(batch, device=images.device)
    ids, params, masks = [], [], []
    for _ in range(cfg.test_steps):
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
            fast_math=True).to(img.dtype)
        if cfg.clamp:
            out = torch.clamp(out, 0.0, 5.0)

        one_hot = F.one_hot(selected_id.long(), num_filters).to(img.dtype)
        st, _, _ = advance_states(st, one_hot, cfg, img.dtype)
        img = out
        ids.append(selected_id)
        params.append(sel_params)
        masks.append(sel_mask)
    return torch.stack(ids), torch.stack(params), torch.stack(masks)
