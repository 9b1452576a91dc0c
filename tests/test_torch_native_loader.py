"""The port's native host loader (its own copy of ``hostloader.cpp``, built
by g++ into ``exposure_tpu_torch/build/``) against the JAX package's
``NativePack`` (built by ``torch_train_helpers.jax_native_built``),
bit for bit: float32 and uint8, augment on and off, the resize path, the
same-size passthrough, ``sample_into`` against ``sample``; the
``NativePackProvider`` seed streams and batches against JAX's; wrong
dtypes and shapes refused; the build's digest and concurrent builds."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_train_helpers import jax_native_built  # noqa: F401 (a fixture)
from exposure_tpu_torch import kernels
from exposure_tpu_torch.data.native_provider import NativePackProvider
from exposure_tpu_torch.native import NativePack, build as t_build
from exposure_tpu_torch.tools import bench_host_assembly

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jax_native(jax_native_built):
    from exposure_tpu.data.native_provider import NativePackProvider as J
    return jax_native_built.NativePack, J


@pytest.fixture(scope='module')
def pack_files(tmp_path_factory):
    rng = np.random.RandomState(0)
    d = tmp_path_factory.mktemp('packs')
    # values beyond [0, 1] too: the u8 quantizer clamps
    big = (rng.rand(20, 80, 80, 3) * 1.2 - 0.1).astype(np.float32)
    small = rng.rand(9, 64, 64, 3).astype(np.float32)
    paths = str(d / 'big.npy'), str(d / 'small.npy')
    np.save(paths[0], big)
    np.save(paths[1], small)
    return paths, (big, small)


# (dtype, augment, out size): crops, the resize (80 -> 48 and 64 -> 80)
# and the same-size passthrough (80 -> 80)
CASES = [(dt, aug, size) for dt in ('f32', 'u8')
         for aug, size in ((True, 64), (False, 48), (False, 80))]


@pytest.mark.parametrize('dt,augment,size', CASES)
def test_samples_equal_jax(jax_native, pack_files, dt, augment, size):
    j_pack_cls, _ = jax_native
    path = pack_files[0][0]
    t, j = NativePack(path), j_pack_cls(path)
    assert t.shape == j.shape == (20, 80, 80, 3)
    dtype = np.float32 if dt == 'f32' else np.uint8
    for seed in (1, 7, 2 ** 63 + 5):
        got = np.empty((13, size, size, 3), dtype)
        want = np.empty_like(got)
        t.sample_into(got, augment=augment, seed=seed)
        j.sample_into(want, augment=augment, seed=seed)
        np.testing.assert_array_equal(got, want)
        if dt == 'f32':
            np.testing.assert_array_equal(
                t.sample(13, size, augment=augment, seed=seed), got)
        else:   # the same draws: the f32 crops, quantized
            f32 = t.sample(13, size, augment=augment, seed=seed)
            np.testing.assert_array_equal(
                got, (np.clip(f32, 0, 1) * np.float32(255) +
                      np.float32(0.5)).astype(np.uint8))
    if not augment and size == 80:
        # the passthrough copies whole images of the pack
        pack = pack_files[1][0]
        for crop in t.sample(5, 80, augment=False, seed=3):
            assert any(np.array_equal(crop, im) for im in pack)
    t.close()
    j.close()


def test_upscale_resize_equals_jax(jax_native, pack_files):
    j_pack_cls, _ = jax_native
    path = pack_files[0][1]
    t, j = NativePack(path), j_pack_cls(path)
    np.testing.assert_array_equal(t.sample(6, 80, augment=False, seed=4),
                                  j.sample(6, 80, augment=False, seed=4))


def test_provider_seed_streams_equal_jax(jax_native, pack_files):
    _, j_provider_cls = jax_native
    path = pack_files[0][0]
    t = NativePackProvider(path, output_size=64, augmentation=0.3, seed=5)
    j = j_provider_cls(path, output_size=64, augmentation=0.3, seed=5)
    for call in ('batch', 'into_f32', 'into_empty', 'into_u8', 'batch'):
        if call == 'batch':
            got, want = t.get_next_batch(7)[0], j.get_next_batch(7)[0]
        else:
            n = 0 if call == 'into_empty' else 9
            dtype = np.uint8 if call == 'into_u8' else np.float32
            got = t.sample_into(np.empty((n, 64, 64, 3), dtype))
            want = j.sample_into(np.empty((n, 64, 64, 3), dtype))
        np.testing.assert_array_equal(got, want)
        assert int(t._seed) == int(j._seed), call
    scaled = NativePackProvider(path, augmentation=0.0, image_scaling=0.5,
                                seed=2)
    j_scaled = j_provider_cls(path, augmentation=0.0, image_scaling=0.5,
                              seed=2)
    np.testing.assert_array_equal(scaled.get_next_batch(3)[0],
                                  j_scaled.get_next_batch(3)[0])
    with pytest.raises(ValueError, match='image_scaling'):
        scaled.sample_into(np.empty((2, 64, 64, 3), np.uint8))
    for p in (t, j, scaled, j_scaled):
        p.close()


def test_wrong_dtype_and_shape_refused(pack_files, tmp_path):
    bad = str(tmp_path / 'f64.npy')
    np.save(bad, np.zeros((2, 8, 8, 3), np.float64))
    with pytest.raises(IOError, match='float32'):
        NativePack(bad)
    pack = NativePack(pack_files[0][0])
    for out in (np.empty((2, 64, 64, 3), np.float64),
                np.empty((2, 64, 64, 1), np.float32),
                np.empty((2, 64, 60, 3), np.float32),
                np.empty((2, 64, 64, 3), np.float32)[:, ::2],
                np.empty((64, 64, 3), np.float32)):
        with pytest.raises(ValueError, match='C-contiguous'):
            pack.sample_into(out)
    with pytest.raises(ValueError, match='hl_sample_crops failed'):
        pack.sample_into(np.empty((2, 96, 96, 3), np.float32), augment=True)
    pack.close()


def test_built_by_gxx_into_the_build_dir_named_by_digest(tmp_path,
                                                       monkeypatch):
    lib = t_build.build()
    assert os.path.dirname(lib.path) == kernels.BUILD_DIR
    digest = kernels.source_digest(t_build.SOURCE, t_build.HERE,
                                   t_build.GXX_FLAGS)
    assert os.path.basename(lib.path) == 'libhostloader-%s.so' % digest
    # an edited copy of the source, or other flags, name another library
    copy = tmp_path / 'hostloader.cpp'
    shutil.copy(t_build.SOURCE, copy)
    assert kernels.source_digest(str(copy), str(tmp_path),
                                 t_build.GXX_FLAGS) == digest
    with open(copy, 'a') as f:
        f.write('\n// one more line\n')
    assert kernels.source_digest(str(copy), str(tmp_path),
                                 t_build.GXX_FLAGS) != digest
    assert kernels.source_digest(t_build.SOURCE, t_build.HERE,
                                 t_build.GXX_FLAGS[1:]) != digest
    # -march=native hashes the host's CPU too, other flags do not
    portable = tuple(f for f in t_build.GXX_FLAGS if f != '-march=native')
    before = kernels.source_digest(t_build.SOURCE, t_build.HERE, portable)
    monkeypatch.setattr(kernels, '_host_cpu', lambda: 'another CPU')
    assert kernels.source_digest(t_build.SOURCE, t_build.HERE,
                                 t_build.GXX_FLAGS) != digest
    assert kernels.source_digest(t_build.SOURCE, t_build.HERE,
                                 portable) == before


def test_processes_building_at_once_agree(tmp_path):
    """Three processes build into one empty build dir at once: each writes
    a file of its own and renames it into place, and all load the same
    library."""
    code = ('import sys; from exposure_tpu_torch import kernels; '
            'kernels.BUILD_DIR = sys.argv[1]; '
            'from exposure_tpu_torch.native.build import build; '
            'print(build().path)')
    procs = [subprocess.Popen([sys.executable, '-c', code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    assert [f for f in os.listdir(tmp_path) if f.endswith('.tmp')] == []


def test_bench_host_assembly_on_a_tiny_pack(tmp_path):
    """The tool's thread curve (one subprocess a thread count) and memcpy
    baseline on a 2 MiB pack; the numbers are this host's, the test holds
    their shape."""
    out = tmp_path / 'report.json'
    report = bench_host_assembly.main([
        '--pack-gb', '0.002', '--threads', '1', '2', '--reps', '2',
        '--bundle-images', '16', '--pack-dir', str(tmp_path),
        '--out', str(out)])
    assert report['pack_images'] == 27 and report['bundle_images'] == 16
    assert sorted(report['threads']) == [1, 2]
    for row in report['threads'].values():
        assert row['assembly_ms'] > 0 and row['gb_per_s'] > 0
    assert report['memcpy_ms'] > 0 and report['assembly_vs_memcpy'] > 0
    assert out.exists()
