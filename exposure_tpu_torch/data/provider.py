"""Host-side data providers: a numpy copy of ``exposure_tpu/data/provider.py``.

An in-RAM float32 image array, epoch-shuffled indices, random-crop and
horizontal-flip augmentation, and ``get_next_batch(bs) -> (images,
features)``.  Draws come from the global ``random`` module, as in the JAX
package, so two providers seeded alike hand out the same batches.

Two differences from the JAX file:

- ``_resize``: the JAX provider resizes with ``cv2.resize`` when ``cv2`` is
  installed and by nearest index when it is not, so its batches depend on
  the machine.  Here it is always plain bilinear with half-pixel centres
  and no antialiasing, in numpy: what ``cv2.resize`` computes by default
  (``INTER_LINEAR``) on float images.
- ``device_pack`` takes the device to put the pack on (the JAX trainer
  moves it there itself).
"""

import random

import numpy as np
import torch

from exposure_tpu_torch.data.device_sampler import DevicePack


def _linear_taps(n_in, n_out):
    """Source indices and weights of a bilinear resize along one axis, as
    ``cv2.resize(..., interpolation=cv2.INTER_LINEAR)``: half-pixel
    centres, edge pixels replicated."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src)
    frac = (src - lo).astype(np.float32)
    lo = lo.astype(np.int64)
    frac[lo < 0] = 0.0
    frac[lo >= n_in - 1] = 0.0
    lo = np.clip(lo, 0, n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, frac


def resize_bilinear(img, size):
    """[H, W(, C)] float -> [size[0], size[1](, C)]: plain bilinear, no
    antialiasing (columns first, then rows, in float32)."""
    img = np.asarray(img, np.float32)
    lo, hi, f = _linear_taps(img.shape[1], size[1])
    f = f.reshape((1, -1) + (1,) * (img.ndim - 2))
    img = img[:, lo] * (1 - f) + img[:, hi] * f
    lo, hi, f = _linear_taps(img.shape[0], size[0])
    f = f.reshape((-1, 1) + (1,) * (img.ndim - 2))
    return img[lo] * (1 - f) + img[hi] * f


class DataProvider:

    def __init__(self,
                 data,
                 output_size=-1,
                 limit=-1,
                 augmentation=0,
                 bnw=False,
                 default_batch_size=64,
                 image_scaling=1.0,
                 synchronous=True,
                 *args,
                 **kwargs):
        if limit == -1:
            limit = data.shape[0]
        elif isinstance(limit, float):
            limit = int(data.shape[0] * limit)
        self.image_scaling = image_scaling
        self.data = np.asarray(data[:limit], dtype=np.float32)
        self.bnw = bnw
        if self.bnw:
            lum = (0.27 * self.data[..., 0] + 0.67 * self.data[..., 1] +
                   0.06 * self.data[..., 2])
            self.data = lum[..., None]
        self.num_images = len(self.data)
        self.default_batch_size = default_batch_size
        self.image_size = self.data.shape[1:3]
        self.augmentation = augmentation
        self.indices = list(range(self.num_images))
        random.shuffle(self.indices)
        if output_size == -1:
            self.output_size = self.data.shape[1:3]
        else:
            self.output_size = (output_size, output_size)

    def device_pack(self, device='cpu'):
        """The full source array on ``device``, with its sampling metadata,
        for ``data/device_sampler.py::sample_batch`` (training)."""
        return DevicePack(
            images=torch.from_numpy(self.data * self.image_scaling).to(device),
            output_size=self.output_size[0],
            augment=self.augmentation > 0)

    def augment_one(self, img):
        s = self.output_size[0]
        sx = random.randrange(0, img.shape[0] - s + 1)
        sy = random.randrange(0, img.shape[1] - s + 1)
        img = img[sx:sx + s, sy:sy + s]
        if random.random() < 0.5:
            img = img[:, ::-1]
        if img.ndim < 3:
            img = img[:, :, None]
        return img

    def _resize(self, img):
        if img.shape[:2] == tuple(self.output_size):
            return img
        out = resize_bilinear(img, self.output_size)
        if out.ndim < 3:
            out = out[:, :, None]
        return out

    def get_next_batch(self, batch_size):
        batch = []
        while len(batch) < batch_size:
            s = min(len(self.indices), batch_size - len(batch))
            batch += self.indices[:s]
            self.indices = self.indices[s:]
            if not self.indices:
                self.indices = list(range(self.num_images))
                random.shuffle(self.indices)
        out = np.empty((batch_size,) + tuple(self.output_size) +
                       self.data.shape[3:], dtype=self.data.dtype)
        for i, idx in enumerate(batch):
            if self.augmentation > 0:
                out[i] = self.augment_one(self.data[idx])
            else:
                out[i] = self._resize(self.data[idx])
        return out * self.image_scaling, np.zeros((batch_size,),
                                                  dtype=np.float32)

    def get_random_batch(self, batch_size):
        indices = list(range(self.num_images))
        random.shuffle(indices)
        indices = indices[:batch_size]
        return self.data[indices], np.zeros((len(indices),), dtype=np.float32)
