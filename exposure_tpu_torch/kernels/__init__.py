"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each kernel source is compiled with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, at first use, under
``exposure_tpu_torch/build/`` (listed in ``.gitignore``), and loaded with
ctypes.  Every pointer and the CUDA stream are passed as ``c_void_p``; a
launcher returns ``cudaGetLastError()`` and the Python wrapper raises when
it is not 0.  A library is named by a hash of its source and flags, so an
edited source builds anew.  Nothing here runs at import time: the CPU
tests import every module of the package.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOCK = threading.Lock()
_LIBRARIES = {}


class KernelLibrary:
    """A loaded kernel library with what its build reported."""

    def __init__(self, lib, path, build_seconds, build_log):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when the build was cached
        self.build_log = build_log          # nvcc's output (ptxas -v)


def _nvcc():
    found = shutil.which('nvcc')
    if not found:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME:
            found = os.path.join(CUDA_HOME, 'bin', 'nvcc')
    if not found or not os.path.exists(found):
        raise RuntimeError('nvcc not found: put the CUDA toolkit on PATH '
                           'to build the CUDA kernels')
    return found


def build(name, bind):
    """Compile ``csrc/<name>.cu`` (once per source hash), load it and
    declare its C interface with ``bind(lib)``."""
    with _LOCK:
        if name in _LIBRARIES:
            return _LIBRARIES[name]
        src = os.path.join(CSRC_DIR, name + '.cu')
        with open(src, 'rb') as f:
            digest = hashlib.sha256(
                f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name, digest))
        seconds, log = 0.0, ''
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '%s.%d.tmp' % (path, os.getpid())
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed on %s:\n%s' % (src, log))
            os.replace(tmp, path)
        lib = KernelLibrary(ctypes.CDLL(path), path, seconds, log)
        bind(lib.lib)
        _LIBRARIES[name] = lib
        return lib


def _bind_dyn_chain(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dyn_chain_launch.argtypes = [
        vp, vp, vp, vp,            # img, out, ids, params
        ctypes.POINTER(i), i,      # branch codes, n_filters
        i, i, i, i, i, i,          # B, H, W, K, P, mask_offset
        i, i, i, i,                # is_u8, fast, masked, curve_steps
        f, f, f,                   # max_sharpness, min_strength, 1-min
        f, f, f,                   # shorter, grid_off_h, grid_off_w
        vp]                        # stream
    lib.dyn_chain_launch.restype = i
    lib.dyn_chain_error_string.argtypes = [i]
    lib.dyn_chain_error_string.restype = ctypes.c_char_p


def dyn_chain_kernel():
    """The ``dyn_chain`` library with what its build reported."""
    return build('dyn_chain', _bind_dyn_chain)


def dyn_chain_library():
    """The bound ``dyn_chain`` library (built on first use)."""
    return dyn_chain_kernel().lib
