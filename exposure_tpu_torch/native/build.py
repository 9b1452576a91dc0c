"""Build the host loader: ``python -m exposure_tpu_torch.native.build``.

``hostloader.cpp`` is compiled with g++ (plain C ABI, bound with ctypes)
by the package's one builder, ``kernels.build``, into
``exposure_tpu_torch/build/libhostloader-<digest>.so``; the digest covers
the source, the flags and, for ``-march=native``, the host's CPU.
``NativePack`` builds it at first use, so running this is optional."""

import ctypes
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, 'hostloader.cpp')
GXX_FLAGS = ('-O3', '-march=native', '-fopenmp', '-fPIC', '-shared',
             '-std=c++17', '-Wall')


def _bind(lib):
    long_, vp = ctypes.c_long, ctypes.c_void_p
    lib.hl_open_pack.restype = vp
    lib.hl_open_pack.argtypes = [ctypes.c_char_p]
    lib.hl_pack_info.restype = ctypes.c_int
    lib.hl_pack_info.argtypes = [vp] + [ctypes.POINTER(long_)] * 4
    for fn, dtype in ((lib.hl_sample_crops, np.float32),
                      (lib.hl_sample_crops_u8, np.uint8)):
        fn.restype = ctypes.c_int
        fn.argtypes = [vp, long_, long_, ctypes.c_int, ctypes.c_ulonglong,
                       np.ctypeslib.ndpointer(dtype, flags='C_CONTIGUOUS')]
    lib.hl_close_pack.restype = None
    lib.hl_close_pack.argtypes = [vp]


def build():
    """The bound library (a ``kernels.KernelLibrary``: ``lib``, ``path``,
    ``build_seconds``, ``build_log``), built when its file is missing.
    Raises ``RuntimeError`` when g++ is missing or fails."""
    from exposure_tpu_torch import kernels
    return kernels.build('hostloader', _bind, src=SOURCE,
                         compiler=kernels._gxx, flags=GXX_FLAGS)


if __name__ == '__main__':
    lib = build()
    print('built %s in %.1f s with g++ %s' % (lib.path, lib.build_seconds,
                                              ' '.join(GXX_FLAGS)))
    sys.exit(0)
