"""The native host loader (C++, bound with ctypes): a memory-mapped
``.npy`` pack reader with OpenMP-parallel random-crop/flip batch sampling,
for packs too large to keep on the device (``data/device_sampler.py`` is
the path whenever the pack fits).

The library is built from ``hostloader.cpp`` by g++ at first use
(``native/build.py``); a missing compiler or a failed build raises.  There
is no fallback to a numpy sampler."""

import ctypes
import os
import shutil

import numpy as np

from exposure_tpu_torch.native import build as _build


def library_available():
    """Whether the library is built or g++ is there to build it."""
    from exposure_tpu_torch import kernels
    return 'hostloader' in kernels._LIBRARIES or \
        shutil.which('g++') is not None


class NativePack:
    """mmap'ed float32 ``.npy`` image pack with native batch sampling."""

    def __init__(self, path):
        self._lib = _build.build().lib
        self._handle = self._lib.hl_open_pack(
            os.fsencode(os.path.abspath(path)))
        if not self._handle:
            raise IOError('hostloader could not open %s (needs a C-order '
                          'little-endian float32 4-D .npy)' % path)
        dims = [ctypes.c_long() for _ in range(4)]
        self._lib.hl_pack_info(self._handle,
                               *[ctypes.byref(d) for d in dims])
        self.shape = tuple(d.value for d in dims)

    def sample(self, batch_size, out_size, augment=True, seed=0):
        """Draw a [batch, out, out, C] float32 crop batch."""
        out = np.empty((batch_size, out_size, out_size, self.shape[3]),
                       np.float32)
        return self.sample_into(out, augment=augment, seed=seed)

    def sample_into(self, out, augment=True, seed=0):
        """Fill a caller-owned C-contiguous [batch, S, S, C] buffer in one
        native call.  dtype float32 (the pack's values) or uint8 (pixels
        quantized round(clamp(x, 0, 1) * 255) at write; the same draws, so
        the same crops and flips).  Row ``i`` draws from its own state,
        ``seed ^ (0x5851f42d4c957f2d * (i + 1))``, so the output does not
        depend on the number of threads.  Without ``augment`` an image of
        another size than ``S`` is resized bilinearly, one of size ``S``
        copied."""
        if (out.ndim != 4 or out.dtype not in (np.float32, np.uint8)
                or not out.flags.c_contiguous
                or out.shape[1] != out.shape[2]
                or out.shape[3] != self.shape[3]):
            raise ValueError('need C-contiguous [n, S, S, %d] float32 or '
                             'uint8, got %s %s' % (self.shape[3],
                                                   out.shape, out.dtype))
        fn = (self._lib.hl_sample_crops if out.dtype == np.float32
              else self._lib.hl_sample_crops_u8)
        rc = fn(self._handle, out.shape[0], out.shape[1], int(bool(augment)),
                np.uint64(seed) or 1, out)
        if rc != 0:
            raise ValueError('hl_sample_crops failed (%d); out_size %d vs '
                             'pack %s' % (rc, out.shape[1], self.shape))
        return out

    def close(self):
        if getattr(self, '_handle', None):
            self._lib.hl_close_pack(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except AttributeError:  # interpreter shutdown took the library
            pass
