"""Batch sampling on the device (torch counterpart of
``exposure_tpu/data/device_sampler.py``).

The whole dataset pack lives on the device, and every batch is gathered
there inside the train step: index gather, random crop and horizontal
flip, with no host work.  Without augmentation a pack of another size is
resized with the antialiased bilinear ``interpolate``, equal to
``jax.image.resize(..., 'linear')`` within 1e-6.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F


class DevicePack(NamedTuple):
    """A dataset on the device plus static sampling metadata."""

    images: torch.Tensor  # [N, H, W, C] float32
    output_size: int      # crop / resize target
    augment: bool         # random crop + flip if True, resize if False


def paired_to_channels(pairs):
    """[N, 2, H, W, C] (input, ground-truth) pairs -> [N, H, W, 2C], so
    that crop and flip apply to both halves alike."""
    n, two, h, w, c = pairs.shape
    if two != 2:
        raise ValueError('expected pairs on axis 1, got %s'
                         % (tuple(pairs.shape),))
    return pairs.permute(0, 2, 3, 1, 4).reshape(n, h, w, 2 * c)


def channels_to_paired(batch, channels):
    """Inverse of :func:`paired_to_channels` on a sampled batch:
    [B, h, w, 2C] -> (input [B, h, w, C], ground truth [B, h, w, C])."""
    b, h, w, _ = batch.shape
    pairs = batch.reshape(b, h, w, 2, channels)
    return pairs[:, :, :, 0, :], pairs[:, :, :, 1, :]


def sample_batch(pack: DevicePack, draws, batch_size: int):
    """Draw a [batch_size, out, out, C] batch from the pack, i.i.d. with
    replacement.  Draws (``utils/draws.py``): ``idx``, then ``crop_x`` and
    ``crop_y`` when the pack is larger than the crop, then ``flip``, as the
    JAX sampler's key splits (idx, ox, oy, flip)."""
    images = pack.images
    n, h, w, c = images.shape
    out = pack.output_size
    idx = draws.randint('idx', n, (batch_size,))
    if pack.augment:
        if h > out or w > out:
            ox = draws.randint('crop_x', h - out + 1, (batch_size,))
            oy = draws.randint('crop_y', w - out + 1, (batch_size,))
            steps = torch.arange(out, device=images.device)
            rows = ox[:, None] + steps
            cols = oy[:, None] + steps
            batch = images[idx[:, None, None], rows[:, :, None],
                           cols[:, None, :]]
        else:
            batch = images[idx]
        flip = draws.bernoulli('flip', 0.5, (batch_size,))
        return torch.where(flip[:, None, None, None], batch.flip(2), batch)
    batch = images[idx]
    if (h, w) != (out, out):
        batch = F.interpolate(batch.permute(0, 3, 1, 2), size=(out, out),
                              mode='bilinear', antialias=True,
                              align_corners=False).permute(0, 2, 3, 1)
    return batch.contiguous()
