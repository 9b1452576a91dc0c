"""The kernel build's source digest, on the CPU (no nvcc needed): a
library is named by a hash of its source and of every header it includes
from ``csrc/``, so editing a shared header rebuilds every kernel that
includes it, directly or through another header.  ``kernels.launch`` on a
fake library: its arguments and stream, its error check and its counter.

On the card (marked ``cuda``, skipped without a device; no JAX import):
the proxy resize kernel (``csrc/proxy_resize.cu``) against its plain
version, torch's ``F.interpolate`` path, at the serving cells' shapes and
odd ones, uint8 and float32, atol 2e-6 (float32 sums in another order);
its CUDA-graph capture replayed on a new input bit for bit; a captured
``RetouchPipeline`` batch launching it once and never ``F.interpolate``:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""

import os
import shutil

import pytest
import torch

from exposure_tpu_torch import kernels
from exposure_tpu_torch.kernels import CSRC_DIR, source_digest

KERNELS = ('dyn_chain', 'switch_chain', 'static_chain', 'probes')


def _copy_csrc(tmp_path):
    dst = tmp_path / 'csrc'
    shutil.copytree(CSRC_DIR, dst)
    return str(dst)


def test_digest_follows_included_headers(tmp_path):
    csrc = _copy_csrc(tmp_path)
    srcs = {k: os.path.join(csrc, k + '.cu') for k in KERNELS}
    before = {k: source_digest(p, csrc) for k, p in srcs.items()}
    assert before == {k: source_digest(os.path.join(CSRC_DIR, k + '.cu'))
                      for k in KERNELS}
    assert len(set(before.values())) == len(KERNELS)
    # every kernel includes both shared headers (fastmath.cuh through
    # chain_branches.cuh)
    for header in ('chain_branches.cuh', 'fastmath.cuh'):
        with open(os.path.join(csrc, header), 'ab') as f:
            f.write(b'\n// one more line\n')
        after = {k: source_digest(p, csrc) for k, p in srcs.items()}
        for k in KERNELS:
            assert after[k] != before[k], (header, k)
        before = after


def test_build_all_covers_every_kernel_source(monkeypatch):
    """``build_all`` builds one library for each ``.cu`` of ``csrc/``, each
    once, so a source added there without an accessor shows here (the
    region stamp of ``utils/trace.py`` and the proxy resize too, which
    include no shared header)."""
    built = []
    monkeypatch.setattr(kernels, 'build',
                        lambda name, bind: built.append(name) or name)
    libs = kernels.build_all()
    sources = sorted(f[:-3] for f in os.listdir(CSRC_DIR)
                     if f.endswith('.cu'))
    assert sorted(built) == sources == sorted(
        KERNELS + ('trace_stamp', 'proxy_resize'))
    assert libs == {name: name for name in sources}


def test_digest_of_a_header_chain_and_of_the_source(tmp_path):
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'k.cu').write_bytes(b'#include "a.cuh"\n#include <cstdint>\n')
    (csrc / 'a.cuh').write_bytes(b'#pragma once\n  #  include "b.cuh"\n')
    (csrc / 'b.cuh').write_bytes(b'// b\n')
    src = str(csrc / 'k.cu')
    d0 = source_digest(src, str(csrc))
    (csrc / 'b.cuh').write_bytes(b'// b, edited\n')
    d1 = source_digest(src, str(csrc))
    (csrc / 'k.cu').write_bytes(b'#include "a.cuh"\n#include <cstdint>\n\n')
    d2 = source_digest(src, str(csrc))
    assert len({d0, d1, d2}) == 3
    # a system header is not followed, and an unrelated file is not hashed
    (csrc / 'unused.cuh').write_bytes(b'// not included\n')
    assert source_digest(src, str(csrc)) == d2


RESIZE_ATOL = 2e-6


class _FakeLibrary:
    """A library as ``kernels.launch`` sees one: ``lib`` holds the
    launcher, which records its arguments and returns ``code``, and the
    library's error string."""

    def __init__(self, code):
        self.name, self.calls = 'fake', []
        self.lib = self
        self.code = code

    def fake_launch(self, *args):
        self.calls.append(args)
        return self.code

    def fake_error_string(self, err):
        return b'error %d' % err


@pytest.mark.parametrize('code', [0, 7], ids=['ok', 'error'])
def test_launch_checks_and_counts(monkeypatch, code):
    """``kernels.launch`` passes its arguments and the device's current
    stream to ``<name>_launch``; a code other than 0 raises with the
    library's error string and counts nothing, a 0 adds 1 to each key the
    caller names."""
    import collections
    import contextlib
    monkeypatch.setattr(kernels, '_LAUNCHES', collections.Counter())
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernels, 'kernel_stream', lambda device: 'stream')
    lib = _FakeLibrary(code)
    launch = lambda: kernels.launch(lib, 'fake', 'cuda:0', 1, 2,
                                    count=('k', 'k_bf16'))
    if code:
        with pytest.raises(RuntimeError, match='fake_launch failed: error 7'):
            launch()
        assert kernels.launch_counts() == {}
    else:
        launch()
        launch()
        assert kernels.launch_counts() == {'k': 2, 'k_bf16': 2}
        kernels.launch(lib, 'fake', 'cuda:0', 3)     # counted under no key
        assert kernels.launch_counts() == {'k': 2, 'k_bf16': 2}
        kernels.reset_launch_counts()
        assert kernels.launch_counts() == {}
    assert lib.calls[0] == (1, 2, 'stream')


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _photos(device, shape, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                      generator=g)
    return x if dtype == 'uint8' else x.to(torch.float32) / 255.0


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [
    (2, 512, 512, 3), (2, 3024, 4032, 3), (2, 756, 1008, 3),
    (2, 100, 150, 3), (2, 37, 50, 3), (1, 64, 6000, 3), 'offset'])
@pytest.mark.parametrize('dtype', ['uint8', 'float32'])
def test_proxy_resize_kernel_matches_plain(cuda_device, shape, dtype):
    """Downscale by an integer, the 12-MP cell's shape, a non-integer
    scale, an aspect change, an upscale (rows whose 16-byte chunks are
    ragged take the kernel's element loads), a row so wide that a slice's
    buffers take more than 48 KB (the launcher's opt-in), and a base one
    element off 16-byte alignment."""
    from exposure_tpu_torch.ops.proxy_resize import (
        proxy_resize, proxy_resize_reference)
    if shape == 'offset':
        flat = _photos(cuda_device, (2 * 64 * 96 * 3 + 1,), dtype)
        img = flat[1:].view(2, 64, 96, 3)
        assert img.data_ptr() % 16 != 0
    else:
        img = _photos(cuda_device, shape, dtype)
    before = kernels.launch_counts()['proxy_resize']
    got = proxy_resize(img, 64)
    assert kernels.launch_counts()['proxy_resize'] == before + 1
    want = proxy_resize_reference(img, 64)
    torch.cuda.synchronize()
    assert got.shape == (img.shape[0], 64, 64, 3)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= RESIZE_ATOL


@pytest.mark.cuda
def test_proxy_resize_graph_replays_bit_for_bit(cuda_device):
    """A capture of the kernel (its tables built by the call before),
    replayed on a new input in the captured buffer, equals the eager call
    on that input bit for bit, and the replay calls no wrapper."""
    from exposure_tpu_torch.ops.proxy_resize import proxy_resize
    static = _photos(cuda_device, (4, 300, 400, 3), 'uint8', seed=1)
    proxy_resize(static, 64)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.graph(graph, stream=side):
        out = proxy_resize(static, 64)
    fresh = _photos(cuda_device, (4, 300, 400, 3), 'uint8', seed=2)
    want = proxy_resize(fresh, 64)
    static.copy_(fresh)
    before = kernels.launch_counts()
    graph.replay()
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_served_batch_resizes_in_one_launch(cuda_device, monkeypatch):
    """The trained artifact served through the batch graph: each replay
    executes the resize kernel once, and nothing calls ``F.interpolate``."""
    from exposure_tpu_torch.core import serving_graph as sg
    from exposure_tpu_torch.core.serving import RetouchPipeline

    def refuse(*args, **kwargs):
        raise AssertionError('F.interpolate ran on the card')
    monkeypatch.setattr(torch.nn.functional, 'interpolate', refuse)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pipe = RetouchPipeline.from_artifact(
        'synthetic_explore', os.path.join(
            root, 'artifacts', 'serving',
            'synthetic_explore--best.msgpack.gz'), device=cuda_device)
    batches = [_photos(cuda_device, (8, 480, 640, 3), 'uint8', seed=s)
               for s in range(3)]
    pipe.warmup(batches[0])
    before = sg.executions(kernels.launch_counts())
    for i, batch in enumerate(batches):
        pipe(batch, 7, i, device_out=True)
    torch.cuda.synchronize()
    after = sg.executions(kernels.launch_counts())
    assert after['proxy_resize'] - before['proxy_resize'] == len(batches)
    launches = list(pipe.graph_report()['launches_per_replay'].values())
    assert [n['proxy_resize'] for n in launches] == [1]
