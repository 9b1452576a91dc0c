"""Build and bind the hand-written CUDA kernels of ``csrc/`` (and the
host loader of ``native/``, through the same builder).

Each kernel source is compiled with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, at first use, under
``exposure_tpu_torch/build/`` (listed in ``.gitignore``), and loaded with
ctypes.  Every pointer and the CUDA stream are passed as ``c_void_p``; a
launcher returns ``cudaGetLastError()``.  ``launch`` is the one place that
calls a launcher: it passes the current stream, raises with the library's
error string when the code is not 0 (``check``) and counts the launch
under the keys its caller names (``launch_counts``; a CPU call runs a
plain version and launches nothing, so it counts nothing).  A library is
named by a hash of its source, of every header it includes from the
source's directory (``#include "..."``, followed through headers) and of
the compiler flags, so an edited source, header or flag builds anew; flags
that ask for the host's own instruction set (``-march=native``) hash the
host's CPU too.  A build writes a file of its own and renames it into
place, so processes that build one library at once all end with the same
file.  Nothing here runs at import time: the CPU tests import every module
of the package.
"""

import collections
import ctypes
import hashlib
import os
import platform
import re
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
_NAME_LOCKS = {}
_LIBRARIES = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
# kernel launches by the keys their callers name
_LAUNCHES = collections.Counter()


class KernelLibrary:
    """A loaded kernel library with what its build reported."""

    def __init__(self, name, lib, path, build_seconds, build_log):
        self.name = name    # its symbols' prefix: <name>_error_string
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


def _gxx():
    found = shutil.which('g++')
    if not found:
        raise RuntimeError('g++ not found: put a C++ compiler on PATH to '
                           'build the host loader')
    return found


def _host_cpu():
    """What ``-march=native`` resolves from: the machine and, on Linux,
    the CPU's model and feature flags."""
    lines = [platform.machine()]
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('model name', 'flags')):
                    lines.append(line.strip())
                    if len(lines) == 3:
                        break
    except OSError:
        pass
    return '\n'.join(lines)


def source_digest(src, csrc_dir=CSRC_DIR, flags=NVCC_FLAGS):
    """Hash of ``src``, of every file it includes from ``csrc_dir`` (each
    once, headers followed recursively) and of the compiler ``flags``."""
    h = hashlib.sha256(' '.join(flags).encode())
    if '-march=native' in flags:
        h.update(_host_cpu().encode())
    seen, todo = set(), [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, 'rb') as f:
            text = f.read()
        h.update(os.path.basename(path).encode() + b'\0' + text + b'\0')
        for inc in _INCLUDE.findall(text):
            dep = os.path.abspath(os.path.join(os.path.dirname(path),
                                               inc.decode()))
            if os.path.dirname(dep) == os.path.abspath(csrc_dir) and \
                    os.path.exists(dep):
                todo.append(dep)
    return h.hexdigest()[:16]


def build(name, bind, src=None, compiler=_nvcc, flags=NVCC_FLAGS):
    """Compile ``src`` (default ``csrc/<name>.cu``) with ``compiler()`` and
    ``flags`` (default nvcc for Hopper), once per source digest, load it
    and declare its C interface with ``bind(lib)``.  Builds of different
    libraries may run at once, from different threads."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBRARIES:
            return _LIBRARIES[name]
        src = src or os.path.join(CSRC_DIR, name + '.cu')
        digest = source_digest(src, os.path.dirname(os.path.abspath(src)),
                               flags)
        path = os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name, digest))
        seconds, log = 0.0, ''
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '%s.%d.%d.tmp' % (path, os.getpid(), threading.get_ident())
            t0 = time.perf_counter()
            exe = compiler()
            proc = subprocess.run([exe, *flags, '-o', tmp, src],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError('%s failed on %s:\n%s'
                                   % (os.path.basename(exe), src, log))
            os.replace(tmp, path)
        lib = KernelLibrary(name, ctypes.CDLL(path), path, seconds, log)
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


def _bind_switch_chain(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.switch_chain_launch.argtypes = [
        vp, vp, vp, vp, vp, vp,    # img, out, ids, params, mask, rows
        ctypes.POINTER(i), i,      # branch codes, n_filters
        i, i, i,                   # n, n_active, B
        i, i, i, i, i,             # H, W, K, Pp, M
        i, i, i, i, i,             # is_u8, bf16, fast, masked, curve_steps
        f, f, f,                   # max_sharpness, min_strength, 1-min
        f, f, f,                   # shorter, grid_off_h, grid_off_w
        vp]                        # stream
    lib.switch_chain_launch.restype = i
    lib.switch_chain_error_string.argtypes = [i]
    lib.switch_chain_error_string.restype = ctypes.c_char_p


def _bind_static_chain(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.static_chain_launch.argtypes = [
        vp, vp, vp, vp, vp,        # img, out, params, mask, rows
        ctypes.POINTER(i),         # signature branch codes
        i, i, i,                   # n, n_active, B
        i, i, i, i, i,             # H, W, K, Pp, M
        i, i, i, i,                # is_u8, fast, masked, curve_steps
        f, f, f,                   # max_sharpness, min_strength, 1-min
        f, f, f,                   # shorter, grid_off_h, grid_off_w
        vp]                        # stream
    lib.static_chain_launch.restype = i
    lib.static_chain_error_string.argtypes = [i]
    lib.static_chain_error_string.restype = ctypes.c_char_p


def _bind_probes(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    n = ctypes.c_longlong
    lib.mono_probe_launch.argtypes = [vp, vp, n, i, i, vp]  # op, steps
    lib.mono_probe_launch.restype = i
    lib.fastmath_probe_launch.argtypes = [vp, vp, n, i, i, vp]
    lib.fastmath_probe_launch.restype = i
    lib.bf16_probe_launch.argtypes = [
        vp, vp, n, i, i, i,        # in, out, n, op, style, steps
        f, f, vp]                  # p0, p1, stream
    lib.bf16_probe_launch.restype = i
    lib.packed_bf16_check_launch.argtypes = [vp, vp]   # counts, stream
    lib.packed_bf16_check_launch.restype = i
    lib.probes_error_string.argtypes = [i]
    lib.probes_error_string.restype = ctypes.c_char_p


def _bind_trace_stamp(lib):
    vp, n = ctypes.c_void_p, ctypes.c_longlong
    lib.trace_stamp_launch.argtypes = [vp, vp, n, n, vp]  # ring, count,
    lib.trace_stamp_launch.restype = ctypes.c_int          # capacity, code
    lib.trace_stamp_error_string.argtypes = [ctypes.c_int]
    lib.trace_stamp_error_string.restype = ctypes.c_char_p


def _bind_proxy_resize(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.proxy_resize_launch.argtypes = [
        vp, vp, vp, vp,            # img, out, steps, band offsets
        vp, vp, vp, vp,            # slices, col first, col count, col w
        i, i, i, i, i,             # taps_x, B, H, W, S
        i, i, i,                   # band rows, n_bands, n_slices
        i, i, i, i,                # threads, buf_floats, is_u8, vec
        vp]                        # stream
    lib.proxy_resize_launch.restype = i
    lib.proxy_resize_prepare.argtypes = []
    lib.proxy_resize_prepare.restype = i
    lib.proxy_resize_error_string.argtypes = [i]
    lib.proxy_resize_error_string.restype = ctypes.c_char_p


def dyn_chain_kernel():
    """The ``dyn_chain`` library with what its build reported."""
    return build('dyn_chain', _bind_dyn_chain)


def switch_chain_kernel():
    """The ``switch_chain`` library with what its build reported."""
    return build('switch_chain', _bind_switch_chain)


def static_chain_kernel():
    """The ``static_chain`` library with what its build reported."""
    return build('static_chain', _bind_static_chain)


def probes_kernel():
    """The ``probes`` library (K4a-c) with what its build reported."""
    return build('probes', _bind_probes)


def trace_stamp_kernel():
    """The ``trace_stamp`` library of ``utils/trace.py``'s regions with
    what its build reported."""
    return build('trace_stamp', _bind_trace_stamp)


def proxy_resize_kernel():
    """The ``proxy_resize`` library (``ops/proxy_resize.py``) with what its
    build reported."""
    return build('proxy_resize', _bind_proxy_resize)


def kernel_stream(device):
    """The handle of ``device``'s current CUDA stream, as a launcher takes
    it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(library, err, entry):
    """Raise ``RuntimeError`` with ``library``'s error string unless the
    code ``err`` that its entry point ``entry`` returned is 0."""
    if err != 0:
        text = getattr(library.lib, library.name + '_error_string')(err)
        raise RuntimeError('%s failed: %s' % (entry, text.decode()))


def launch(library, name, device, *args, count=()):
    """Call ``library``'s launcher ``<name>_launch(*args, stream)`` on
    ``device``'s current stream, raise if it returns an error, then add 1
    to each of the launch counter's keys ``count``."""
    import torch
    with torch.cuda.device(device):
        err = getattr(library.lib, name + '_launch')(*args,
                                                     kernel_stream(device))
    check(library, err, name + '_launch')
    _LAUNCHES.update(count)


def launch_counts():
    """A copy of the launch counter: launches by the keys ``launch`` was
    given (``dyn_chain``, ``switch_chain`` and its bf16 part
    ``switch_chain_bf16``, ``static_chain``, ``proxy_resize``,
    ``mono_probe``, ``fastmath_probe``, ``bf16_probe``)."""
    return collections.Counter(_LAUNCHES)


def reset_launch_counts():
    _LAUNCHES.clear()


def build_all():
    """Build (or load) every kernel library at once, one nvcc each, and
    return ``{name: KernelLibrary}``."""
    from concurrent.futures import ThreadPoolExecutor
    accessors = {'dyn_chain': dyn_chain_kernel,
                 'switch_chain': switch_chain_kernel,
                 'static_chain': static_chain_kernel,
                 'probes': probes_kernel,
                 'trace_stamp': trace_stamp_kernel,
                 'proxy_resize': proxy_resize_kernel}
    with ThreadPoolExecutor(len(accessors)) as pool:
        futures = {name: pool.submit(fn) for name, fn in accessors.items()}
        return {name: fut.result() for name, fut in futures.items()}
