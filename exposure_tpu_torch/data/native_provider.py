"""Provider backed by the native host loader (a copy of
``exposure_tpu/data/native_provider.py``).

For packs too large to keep on the device, this provider draws augmented
batches straight off the memory-mapped ``.npy`` pack with the native
crop/flip sampler.  Its seed stream is the JAX provider's: ``seed *
2654435761 + 1``, advanced by ``0x9e3779b9`` before every call
(``get_next_batch`` and ``sample_into``, a call for 0 rows too), so both
packages hand out the same crops from the same seed."""

import numpy as np

from exposure_tpu_torch.native import NativePack


class NativePackProvider:

    def __init__(self, pack_path, output_size=64, augmentation=0.3,
                 default_batch_size=64, image_scaling=1.0, seed=0):
        self.pack = NativePack(pack_path)
        self.output_size = (output_size, output_size)
        self.augmentation = augmentation
        self.default_batch_size = default_batch_size
        self.image_scaling = image_scaling
        self._seed = np.uint64(seed * 2654435761 + 1)
        self.num_images = self.pack.shape[0]

    def _next_seed(self):
        self._seed = np.uint64(self._seed + np.uint64(0x9e3779b9))
        return int(self._seed)

    def get_next_batch(self, batch_size):
        batch = self.pack.sample(batch_size, self.output_size[0],
                                 augment=self.augmentation > 0,
                                 seed=self._next_seed())
        if self.image_scaling != 1.0:
            batch = batch * self.image_scaling
        return batch, np.zeros((batch_size,), np.float32)

    def sample_into(self, dest):
        """Fill a C-contiguous [n, S, S, C] float32 or uint8 view in one
        native call (the streaming bundle assembly: no Python batch loop, no
        restack copy).  A uint8 ``dest`` gets the quantized pixels of the
        float32 batch the same seed gives; it cannot carry
        ``image_scaling``."""
        seed = self._next_seed()
        if dest.dtype == np.uint8 and self.image_scaling != 1.0:
            raise ValueError('uint8 bundles cannot carry image_scaling '
                             '(%g); fold it into the device-side dequant '
                             'instead' % self.image_scaling)
        self.pack.sample_into(dest, augment=self.augmentation > 0,
                              seed=seed)
        if self.image_scaling != 1.0:
            dest *= self.image_scaling
        return dest

    def close(self):
        self.pack.close()
