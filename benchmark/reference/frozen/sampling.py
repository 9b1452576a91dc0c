"""Inverse-CDF categorical sampling (torch counterpart of
``exposure_tpu/ops/sampling.py``)."""

import torch


def pdf_sample(pdf, uniform_noise):
    """Sample category indices via inverse-CDF.

    Args:
      pdf: [B, K] unnormalized probabilities (strictly positive).
      uniform_noise: [B, 1] uniform samples in [0, 1).

    Returns:
      [B] int32 sampled indices, clamped to [0, K - 1]: noise exactly 0
      would otherwise give -1 (no cdf entry is below it).
    """
    pdf = pdf / (torch.sum(pdf, dim=1, keepdim=True) + 1e-36)
    cdf = torch.cumsum(pdf, dim=1) - pdf  # exclusive cumsum
    indices = torch.sum((cdf < uniform_noise).to(torch.int32), dim=1) - 1
    return torch.clamp(indices, 0, pdf.shape[1] - 1).to(torch.int32)
