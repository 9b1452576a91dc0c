"""Policy, critic and value networks (torch counterpart of
``exposure_tpu/models/networks.py``, and of ``build_models`` in
``exposure_tpu/core/trainer.py``).

Inputs keep the JAX package's NHWC layout; the modules permute to NCHW for
the convolutions.  Three details carry the flax semantics over:

- ``SAME`` padding of a 4x4 stride-2 convolution is ``padding=1`` at even
  input sizes (64 -> 32 -> 16 -> 8 -> 4); odd sizes are refused.
- flax flattens the final feature map in NHWC order, so the map is
  permuted back to NHWC before ``flatten``.
- dropout stays on at serving, as in the reference.  It is applied
  explicitly from a caller's ``torch.Generator`` (``nn.Dropout`` would
  follow ``train()``/``eval()`` instead); with keep probability 1 it is
  the identity, as flax ``Dropout(rate=0)`` is.

``CriticNet`` is the WGAN critic and, given ``states``, the value network:
hand-made statistics channels (``critic_stats``) and the optional state
vector are broadcast over the image as constant channels, then a strided
conv stack without normalization and two dense layers give one logit.
``core/losses.py`` trains it.

``init_like_flax`` starts a module as the JAX networks start: Glorot-uniform
kernels (``nn.initializers.glorot_uniform``, the reference's
``xavier_initializer``) and zero biases; torch's own defaults differ.
"""

import math

import torch
import torch.nn as nn

from .draws import uniform
from .ops import clip, lrelu

MIN_FEATURE_MAP_SIZE = 4   # the convs stop at a 4x4 map


def dropout(x, keep_prob, generator):
    """Inverted dropout that is on whatever the module mode.  The mask is
    drawn in float32 whatever ``x``'s dtype, so a bfloat16 plan drops the
    same units as a float32 one from the same generator; ``generator`` is a
    ``torch.Generator`` or a training step's ``Draws``."""
    if keep_prob >= 1.0:
        return x
    keep = uniform(generator, 'dropout', x.shape, x.device) < keep_prob
    return x * keep / keep_prob


class FeatureExtractor(nn.Module):
    """Strided-conv feature pyramid -> flat feature vector with dropout."""

    def __init__(self, in_channels, output_dim, base_channels=32,
                 dropout_keep_prob=0.5, input_size=64):
        super().__init__()
        min_size = MIN_FEATURE_MAP_SIZE
        if output_dim % (min_size ** 2):
            raise ValueError('output_dim must be a multiple of %d'
                             % min_size ** 2)
        self.output_dim = output_dim
        self.dropout_keep_prob = dropout_keep_prob
        self.input_size = input_size
        widths = [base_channels]
        size = input_size // 2
        channels = base_channels
        while size > min_size:
            if size == min_size * 2:
                channels = output_dim // (min_size ** 2)
            else:
                channels *= 2
            widths.append(channels)
            size //= 2
        ins = [in_channels] + widths[:-1]
        self.convs = nn.ModuleList(
            nn.Conv2d(c_in, c_out, 4, stride=2, padding=1)
            for c_in, c_out in zip(ins, widths))

    def forward(self, x, generator=None):
        """[B, S, S, C] NHWC -> [B, output_dim]."""
        if x.shape[1] != self.input_size or x.shape[2] != self.input_size:
            raise ValueError('expected %dx%d input, got %s'
                             % (self.input_size, self.input_size,
                                tuple(x.shape)))
        x = (x - 0.5).permute(0, 3, 1, 2)
        for conv in self.convs:
            if x.shape[-1] % 2 or x.shape[-2] % 2:
                raise ValueError('SAME padding equals padding=1 only at '
                                 'even sizes, got %s' % (tuple(x.shape),))
            x = lrelu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], self.output_dim)
        return dropout(x, self.dropout_keep_prob, generator)


class PolicyNet(nn.Module):
    """Per-filter raw parameter heads and selector logits.

    ``filter_output_dims`` holds n_params + n_mask_params per filter (the
    mask part is present even when masking is off)."""

    def __init__(self, in_channels, filter_output_dims,
                 feature_extractor_dims=4096, base_channels=32, fc1_size=128,
                 dropout_keep_prob=0.5, input_size=64):
        super().__init__()
        self.filter_output_dims = tuple(filter_output_dims)

        def extractor():
            return FeatureExtractor(in_channels, feature_extractor_dims,
                                    base_channels, dropout_keep_prob,
                                    input_size)

        self.shared_extractor = extractor()
        self.filter_fc1 = nn.ModuleList(
            nn.Linear(feature_extractor_dims, fc1_size)
            for _ in self.filter_output_dims)
        self.filter_fc2 = nn.ModuleList(
            nn.Linear(fc1_size, d) for d in self.filter_output_dims)
        self.selector_extractor = extractor()
        self.selector_fc1 = nn.Linear(feature_extractor_dims, fc1_size)
        self.selector_fc2 = nn.Linear(fc1_size, len(self.filter_output_dims))

    def forward(self, enriched, generator=None):
        """[B, S, S, C] -> (list of [B, out_j] raw heads, [B, K] logits)."""
        shared = self.shared_extractor(enriched, generator)
        raw_params = [fc2(lrelu(fc1(shared)))
                      for fc1, fc2 in zip(self.filter_fc1, self.filter_fc2)]
        sel = self.selector_extractor(enriched, generator)
        logits = self.selector_fc2(lrelu(self.selector_fc1(sel)))
        return raw_params, logits


def build_policy(cfg, filters):
    """The ``PolicyNet`` a config and its filter bank call for."""
    return PolicyNet(
        in_channels=3 + (cfg.num_state_dim if cfg.img_include_states else 0),
        filter_output_dims=[
            f.get_num_filter_parameters() + f.get_num_mask_parameters()
            for f in filters],
        feature_extractor_dims=cfg.feature_extractor_dims,
        base_channels=cfg.base_channels,
        fc1_size=cfg.fc1_size,
        dropout_keep_prob=cfg.dropout_keep_prob,
        input_size=cfg.source_img_size)



def critic_stats(images):
    """[B, H, W, 3] -> [B, 3]: luminance mean, luminance variance (the
    population variance, as ``jnp.var``) and mean saturation."""
    lum = (images[..., 0] * 0.27 + images[..., 1] * 0.67 +
           images[..., 2] * 0.06 + 1e-5)
    luminance = lum.mean(dim=(1, 2))
    contrast = lum.var(dim=(1, 2), unbiased=False)
    clipped = clip(images, 0.0, 1.0)
    # amax/amin split the gradient over tied channels, as jnp.max does
    i_max = clipped.amax(dim=3)
    i_min = clipped.amin(dim=3)
    sat = (i_max - i_min) / (torch.minimum(i_max + i_min,
                                           2.0 - i_max - i_min) + 1e-2)
    saturation = sat.mean(dim=(1, 2))
    return torch.stack([luminance, contrast, saturation], dim=1)


class CriticNet(nn.Module):
    """WGAN critic / value network with statistics (+ state) channels.

    ``in_channels`` counts the image's channels, the state vector's
    entries when the net is called with ``states`` (the value network) and
    the three statistics."""

    def __init__(self, in_channels, base_channels=32, fc1_size=128,
                 input_size=64):
        super().__init__()
        self.in_channels = in_channels
        self.input_size = input_size
        widths = [base_channels]
        size = input_size // 2
        while size > MIN_FEATURE_MAP_SIZE:
            widths.append(widths[-1] * 2)
            size //= 2
        ins = [in_channels] + widths[:-1]
        self.convs = nn.ModuleList(
            nn.Conv2d(c_in, c_out, 4, stride=2, padding=1)
            for c_in, c_out in zip(ins, widths))
        self.flat_dim = MIN_FEATURE_MAP_SIZE ** 2 * widths[-1]
        self.fc1 = nn.Linear(self.flat_dim, fc1_size)
        self.fc2 = nn.Linear(fc1_size, 1)

    def forward(self, images, states=None):
        """[B, S, S, C] NHWC (and [B, D] states) -> [B, 1] logit."""
        if images.shape[1] != self.input_size or \
                images.shape[2] != self.input_size:
            raise ValueError('expected %dx%d input, got %s'
                             % (self.input_size, self.input_size,
                                tuple(images.shape)))
        stat = critic_stats(images)
        states = stat if states is None else torch.cat([states, stat], dim=1)
        if images.shape[3] + states.shape[1] != self.in_channels:
            raise ValueError(
                'built for %d input channels, got %d image channels and %d '
                'state and statistics entries'
                % (self.in_channels, images.shape[3], states.shape[1]))
        bcast = states[:, None, None, :].expand(
            -1, images.shape[1], images.shape[2], -1)
        x = (torch.cat([images, bcast], dim=3) - 0.5).permute(0, 3, 1, 2)
        for conv in self.convs:
            if x.shape[-1] % 2 or x.shape[-2] % 2:
                raise ValueError('SAME padding equals padding=1 only at '
                                 'even sizes, got %s' % (tuple(x.shape),))
            x = lrelu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], self.flat_dim)
        return self.fc2(lrelu(self.fc1(x)))


def init_like_flax(module, generator=None):
    """Glorot-uniform on every conv and linear weight, zero on every bias,
    drawn from ``generator`` in ``module.modules()`` order.  A conv weight
    is OIHW: fan_in is ``I*kh*kw`` and fan_out ``O*kh*kw``, as flax counts
    them on its HWIO kernel.  Returns the module."""
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, (nn.Conv2d, nn.Linear)):
                continue
            w = m.weight
            receptive = w[0, 0].numel() if w.dim() > 2 else 1
            fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            w.uniform_(-limit, limit, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return module


def build_models(cfg):
    """``(filters, policy, critic, value)`` for a config, as the JAX
    ``build_models``: the critic sees the image and its statistics, the
    value network the state vector as well."""
    from .filters import build_filters
    filters = build_filters(cfg)
    policy = build_policy(cfg, filters)
    channels = cfg.real_img_channels
    critic = CriticNet(channels + 3, cfg.base_channels, cfg.fc1_size,
                       cfg.source_img_size)
    value = CriticNet(channels + cfg.num_state_dim + 3, cfg.base_channels,
                      cfg.fc1_size, cfg.source_img_size)
    return filters, policy, critic, value
