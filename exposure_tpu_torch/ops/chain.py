"""Branchless filter-chain replay (torch counterpart of
``exposure_tpu/ops/chain.py``).

Every step evaluates all filters on the whole batch and selects each
image's result with a one-hot blend.  This is the reference the tests use
for the chain; serving replays through ``ops.dyn_chain``, which runs only
each image's selected branch."""

import torch
import torch.nn.functional as F


def apply_filter_step(img, filter_id, packed_params, filters,
                      mask_params=None):
    """Apply one recorded step to [B, H, W, C] given per-sample ids.

    Args:
      img: [B, H, W, C].
      filter_id: [B] integer ids into ``filters``.
      packed_params: [B, max_p] regressed parameters (zero-padded).
      mask_params: optional [B, max_mask] raw mask-head outputs.
    """
    outs = []
    for f in filters:
        n = f.get_num_filter_parameters()
        mp = None
        if mask_params is not None and f.use_masking():
            mp = mask_params[:, :f.get_num_mask_parameters()]
        outs.append(f.apply(img, specified_parameter=packed_params[:, :n],
                            mask_parameters=mp)[0])
    stacked = torch.stack(outs, dim=1)  # [B, K, H, W, C]
    one_hot = F.one_hot(filter_id.long(), len(filters)).to(img.dtype)
    return torch.sum(stacked * one_hot[:, :, None, None, None], dim=1)


def apply_filter_chain(img, filter_ids, packed_params, filters,
                       active_steps=None, mask_params=None):
    """Replay a K-step trajectory.

    Args:
      img: [B, H, W, C] input image (linear domain).
      filter_ids: [K, B] per-step filter choices.
      packed_params: [K, B, max_p] per-step packed parameters.
      active_steps: optional [K, B] 0/1 mask (1 = apply the step).
      mask_params: optional [K, B, max_mask] raw mask-head outputs.

    Returns:
      [B, H, W, C] output image.
    """
    out = img
    for k in range(filter_ids.shape[0]):
        mp = mask_params[k] if mask_params is not None else None
        step = apply_filter_step(out, filter_ids[k], packed_params[k],
                                 filters, mask_params=mp)
        if active_steps is not None:
            step = torch.where(active_steps[k][:, None, None, None] > 0,
                               step, out)
        out = step
    return out
