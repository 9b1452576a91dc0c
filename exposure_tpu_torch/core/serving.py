"""Serving: the batch retouching pipeline (torch counterpart of
``exposure_tpu/core/serving.py``, dynamic selected-plan path).

Per batch: scale the [B, H, W, 3] images to [0, 1] and resize them to the
64x64 proxy (``proxy``), plan a 5-step trajectory on the proxy with the
policy, advancing it through the chain kernel on the selected branch only
(``plan``), then replay the [K, B] ids and [K, B, P] params on the
full-resolution batch through the same kernel (``replay``).  uint8 input
gives uint8 output; float32 input is the linear [0, 1] domain.

Dropout stays on at serving, as in the reference: each batch draws it from
a ``torch.Generator`` on the device seeded from (seed, batch index), so a
batch's output is a function of its images, the seed and its index.

>>> pipe = RetouchPipeline.from_artifact(
...     'synthetic_explore',
...     'artifacts/serving/synthetic_explore--best.msgpack.gz',
...     device='cuda')
>>> out_u8 = pipe(images_u8)           # [B, H, W, 3] uint8 tensor
"""

import torch
import torch.nn.functional as F

from exposure_tpu_torch.core.artifacts import flax_to_state_dict, load_artifact
from exposure_tpu_torch.core.rollout import serve_rollout
from exposure_tpu_torch.models.networks import build_policy
from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.utils.config import load_config

# Distinct batches of one seed get distinct dropout streams; the stride is
# a large odd number so (seed, index) pairs do not collide in practice.
_SEED_STRIDE = 0x9E3779B1


def batch_generator(seed, index, device):
    """The dropout generator of batch ``index`` under ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * _SEED_STRIDE + int(index)) % (2 ** 63))
    return g


def proxy_resize(images, size):
    """[B, H, W, 3] uint8 or float32 -> [B, size, size, 3] float32 proxy:
    scale to [0, 1], then antialiased bilinear resize (matches
    ``jax.image.resize(..., 'linear')``)."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x * (1.0 / 255.0)
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode='bilinear', antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1).contiguous()


class RetouchPipeline:

    def __init__(self, cfg, policy, device='cpu', run=None, step=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.filters = build_filters(cfg)
        self.policy = policy.to(self.device).eval()
        self.masking = bool(cfg.masking)
        self.run, self.step = run, step   # where the weights came from

    @classmethod
    def from_artifact(cls, config_name, path, device='cpu'):
        """A pipeline serving the generator of a JAX serving artifact."""
        cfg = load_config(config_name)
        policy = build_policy(cfg, build_filters(cfg))
        payload = load_artifact(path)
        policy.load_state_dict(flax_to_state_dict(payload['gen_params']))
        return cls(cfg, policy, device=device, run=payload.get('run'),
                   step=payload.get('step'))

    def _to_device(self, images):
        if not torch.is_tensor(images):
            images = torch.from_numpy(images)
        if images.dtype not in (torch.uint8, torch.float32):
            raise TypeError('images must be uint8 or float32, got %s'
                            % images.dtype)
        return images.to(self.device).contiguous()

    def proxy(self, images):
        return proxy_resize(images, self.cfg.source_img_size)

    @torch.no_grad()
    def plan(self, proxy, generator):
        """-> (ids [K, B] int32, params [K, B, max_p], mask [K, B, max_m])."""
        return serve_rollout(self.policy, proxy, generator, cfg=self.cfg,
                             filters=self.filters)

    def replay(self, images, ids, params, mask):
        """The plan on the full-resolution batch, fast branch set."""
        return apply_filter_chain_dynamic(
            images, ids, params.to(torch.float32), self.filters,
            mask_params=mask.to(torch.float32) if self.masking else None,
            fast_math=True)

    @torch.no_grad()
    def __call__(self, images, seed=0, index=0):
        """Retouch one [B, H, W, 3] batch, drawing dropout from the stream
        of (seed, index); returns a tensor on the pipeline's device."""
        images = self._to_device(images)
        proxy = self.proxy(images)
        ids, params, mask = self.plan(
            proxy, batch_generator(seed, index, self.device))
        return self.replay(images, ids, params, mask)

    def map_batches(self, batches, seed=0):
        """Retouch a stream of batches in order.  Nothing waits for the
        device: each batch's work is queued behind the last, and batch i
        uses the dropout stream of (seed, i)."""
        for i, images in enumerate(batches):
            yield self(images, seed, i)
