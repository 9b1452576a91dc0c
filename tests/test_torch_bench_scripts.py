"""The port's three root benchmark scripts against the JAX ones, on the
CPU: ``bench_torch.py`` against ``bench.py``, ``bench_train_torch.py``
against ``bench_train.py``, ``bench_stream_torch.py`` against
``bench_stream.py`` (the root modules, imported as they are).

- ``measure``'s metric names for every flag combination, and driver mode's
  lines in order, letter for letter (the timing and the pipelines stubbed
  on both sides);
- ``build_pipeline`` on the in-repo artifact at B=2: the u8 inputs within
  1 LSB (the floats before the truncation within 1e-5, also upsampled to
  96x96), and the switch, grouped and branchless outputs within 1 LSB with
  at most a 1e-4 fraction of S+ outliers; dropout is off on both sides
  (``load_config`` wrapped), and the JAX Pallas calls run in interpret mode
  (the names ``bench.py`` imports from ``pallas_chain`` patched);
- the training packs, the disk packs and the streaming bundles (the native
  loaders of both packages, f32 and u8, ``sample_into`` and the legacy
  assembly) bit for bit;
- each script's JSON line on the CPU has the JAX line's keys, less
  ``bench.py``'s ``vs_baseline``: the port's scripts run for real at small
  sizes, the JAX training scripts with their step stubbed (only the keys
  are compared; the steps are held to JAX in ``test_torch_train_step.py``
  and ``test_torch_streaming.py``);
- without ``--cpu`` and without a GPU each script exits non-zero, as
  does ``tools/bench_tf32.py``, which runs them on the card;
- ``utils/config.py::load_config_file`` and ``load_config``'s file
  fallback.
"""

import collections
import functools
import json
import os
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_stream
import bench_stream_torch
import bench_torch
import bench_train
import bench_train_torch
from exposure_tpu_torch.tools import bench_tf32
from torch_train_helpers import jax_native_built  # noqa: F401 (fixture)

RUN = 'synthetic_explore/best'      # the in-repo serving artifact
MAX_OUTLIER_FRAC = 1e-4             # S+ at exact gray, see ops/dyn_chain.py
CPU = torch.device('cpu')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op thread while this file runs (the suite's workers share
    the cores; ``ROADMAP.md``'s oversubscription trap)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def dropout_off(monkeypatch):
    """Both packages' ``load_config`` with ``dropout_keep_prob`` 1.0 (the
    scripts look it up at call time)."""
    import exposure_tpu.utils.config as jconf
    import exposure_tpu_torch.utils.config as tconf
    for mod in (jconf, tconf):
        def load(name, real=mod.load_config):
            cfg = real(name)
            cfg.dropout_keep_prob = 1.0
            return cfg
        monkeypatch.setattr(mod, 'load_config', load)


@pytest.fixture
def jax_interpret(monkeypatch):
    """The Pallas entry points ``bench.py`` imports, in interpret mode."""
    import exposure_tpu.ops.pallas_chain as pc
    runner = pc.GroupedChainRunner

    class Interpreted(runner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, interpret=True, **kwargs)

    monkeypatch.setattr(pc, 'GroupedChainRunner', Interpreted)
    monkeypatch.setattr(pc, 'pallas_apply_filter_chain', functools.partial(
        pc.pallas_apply_filter_chain, interpret=True))


def _lines(out):
    return [json.loads(s) for s in out.splitlines() if s.startswith('{')]


# -- metric names ---------------------------------------------------------
def _stub_measures(monkeypatch):
    """Both scripts' pipelines and timings stubbed: ``measure`` builds only
    its name."""
    monkeypatch.setattr(bench, 'bench_stream', lambda *a, **k: ([1.0], 0))
    monkeypatch.setattr(bench, 'build_pipeline',
                        lambda *a, **k: (lambda *x: None, None, None, None))
    monkeypatch.setattr(bench, 'slope_time', lambda fn: [1.0])
    monkeypatch.setattr(bench_torch, 'bench_stream',
                        lambda *a, **k: ([1.0], 0))
    monkeypatch.setattr(bench_torch, 'build_pipeline',
                        lambda *a, **k: (lambda *x: None, None, 0))
    monkeypatch.setattr(bench_torch, 'step_seconds',
                        lambda fn, device, calls: [1.0])


@pytest.mark.parametrize('mode', ['switch', 'grouped', 'jnp', 'stream',
                                  'dyn'])
def test_metric_names_equal_bench_py(monkeypatch, mode):
    _stub_measures(monkeypatch)
    seen = set()
    for u8 in (True, False):
        for run in (None, RUN):
            for bf16 in (False, True):
                for superset in (False, True):
                    for bank_plan in (False, True):
                        monkeypatch.setattr(sys, 'argv', ['bench.py'] + (
                            ['--bank-plan'] if bank_plan else []))
                        _, want = bench.measure(mode, 2, 64, u8, run, bf16,
                                                True, superset=superset)
                        _, got = bench_torch.measure(
                            mode, 2, 64, u8, run, bf16, True,
                            superset=superset, bank_plan=bank_plan,
                            device=CPU)
                        assert got == want
                        seen.add(got)
    assert len(seen) == (32 if mode == 'dyn' else 16)


@pytest.mark.parametrize('trained', [True, False])
def test_driver_mode_lines_equal_bench_py(monkeypatch, capsys, trained):
    import exposure_tpu.core.artifacts as jart
    import exposure_tpu_torch.core.artifacts as tart
    _stub_measures(monkeypatch)
    for mod in (jart, tart):
        monkeypatch.setattr(mod, 'has_trained_params',
                            lambda run: trained and run == RUN)
    monkeypatch.setattr(sys, 'argv', ['bench.py'])
    bench.main()
    want = [line['metric'] for line in _lines(capsys.readouterr().out)]
    bench_torch.main(['--cpu'])
    got = [line['metric'] for line in _lines(capsys.readouterr().out)]
    assert got == want
    if trained:
        assert len(got) == 5
        assert got[-1] == bench_torch.METRIC + '_u8io_bf16_trained_dyn'
    else:
        assert got == [bench_torch.METRIC + '_u8io']


# -- build_pipeline against bench.py on the artifact ----------------------
@pytest.mark.parametrize('res', [64, 96])
def test_build_pipeline_inputs_equal_bench_py(dropout_off, res):
    """The trained inputs: the floats before the truncation, and the u8
    batch."""
    imgs = {}
    for u8 in (False, True):
        random.seed(0)
        _, _, want, _ = bench.build_pipeline(2, res, 'switch', u8, run=RUN)
        _, got, _ = bench_torch.build_pipeline(2, res, 'switch', u8, run=RUN,
                                               device=CPU)
        imgs[u8] = np.asarray(want), got.numpy()
    want, got = imgs[False]
    assert got.shape == want.shape == (2, res, res, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want, got = imgs[True]
    assert got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    # truncated as bench.py truncates: apart only where the floats' last
    # bits straddle an integer (a rounding would move about half of them)
    assert (got != want).mean() <= 1e-3


@pytest.mark.parametrize('mode', ['switch', 'grouped', 'jnp'])
def test_build_pipeline_output_equals_bench_py(dropout_off, jax_interpret,
                                               mode):
    random.seed(0)
    step, params, imgs, key = bench.build_pipeline(2, 64, mode, True,
                                                   run=RUN)
    want = np.asarray(step(params, imgs, key))
    step_fn, t_imgs, seed = bench_torch.build_pipeline(2, 64, mode, True,
                                                       run=RUN, device=CPU)
    got = step_fn(t_imgs, seed).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, 64, 64,
                                                                 3)
    lsb = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (lsb > 1).mean() <= MAX_OUTLIER_FRAC, lsb.max()
    # and quantized alike: a truncation for a rounding would move about
    # half the values by 1 LSB (these plans agree, and the outputs do too)
    assert (lsb > 0).mean() <= 1e-3


# -- packs and bundles ----------------------------------------------------
def test_training_packs_equal_bench_train():
    from exposure_tpu.data.synthetic import make_synthetic_pack
    from exposure_tpu_torch.utils.config import load_config
    cfg = load_config('test')
    got = bench_train_torch.make_packs(cfg, 16)
    want = (make_synthetic_pack(16, 80, 'raw', 0),
            make_synthetic_pack(16, 64, 'retouched', 1),
            make_synthetic_pack(cfg.replay_memory_size, 80, 'raw', 2)
            [:, 8:72, 8:72])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize('size,seed', [(80, 0), (64, 7)])
def test_disk_pack_equals_bench_stream(tmp_path, size, seed):
    gigabytes = 0.003       # 41 80x80 or 65 64x64 images: chunks of 16
    got_path, n = bench_stream_torch.make_disk_pack(
        str(tmp_path / 'port.npy'), gigabytes, size=size, seed=seed,
        chunk=16)
    want_path, m = bench_stream.make_disk_pack(
        str(tmp_path / 'jax.npy'), gigabytes, size=size, seed=seed, chunk=16)
    assert n == m > 32
    got, want = np.load(got_path), np.load(want_path)
    assert got.shape == (n, size, size, 3) and np.array_equal(got, want)


@pytest.mark.parametrize('legacy', [False, True])
@pytest.mark.parametrize('dtype', [np.float32, np.uint8])
def test_bundle_equals_bench_stream(tmp_path, jax_native_built, dtype,
                                    legacy):
    """Two bundles in a row (the providers' seeds advance alike), as
    ``bench_stream.py``'s ``assemble`` makes them with the JAX native
    provider, at fuse 2, giters 1, citers 2, B 4, pool 8."""
    from exposure_tpu.data.native_provider import NativePackProvider as JP
    from exposure_tpu_torch.data.native_provider import (
        NativePackProvider as TP,
    )
    fake, _ = bench_stream_torch.make_disk_pack(
        str(tmp_path / 'fake.npy'), 0.001, chunk=16)
    real, _ = bench_stream_torch.make_disk_pack(
        str(tmp_path / 'real.npy'), 0.001, size=64, seed=7, chunk=16)
    fuse, giters, citers, b, p = 2, 1, 2, 4, 8
    chunk = 2 * b + p
    providers = [(P(fake, output_size=64, augmentation=0.3, seed=1),
                  P(real, output_size=64, augmentation=1.0, seed=2))
                 for P in (JP, TP)]
    (jf, jr), (tf, tr) = providers
    for _ in range(2):
        # bench_stream.py:138-156
        g_fresh = np.empty((fuse * giters, chunk, 64, 64, 3), dtype)
        if legacy:
            def q(x):
                return (np.clip(x, 0, 1) * 255 + 0.5).astype(dtype) \
                    if dtype == np.uint8 else x
            for i in range(fuse * giters):
                g_fresh[i] = q(jf.get_next_batch(chunk)[0])
            want_real = q(np.stack([jr.get_next_batch(b)[0]
                                    for _ in range(fuse * citers)]))
        else:
            jf.sample_into(g_fresh.reshape(-1, 64, 64, 3))
            want_real = np.empty((fuse * citers * b, 64, 64, 3), dtype)
            jr.sample_into(want_real)
            want_real = want_real.reshape(fuse * citers, b, 64, 64, 3)
        got = bench_stream_torch.assemble_bundle(
            tf, tr, np.empty(g_fresh.shape, dtype),
            np.empty(want_real.shape, dtype), legacy=legacy)
        for g, w in zip(got, (g_fresh, want_real)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    for pair in providers:
        for provider in pair:
            provider.close()


# -- the JSON lines -------------------------------------------------------
def _keys(fn, capsys):
    fn()
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 1
    return lines[0]


@pytest.mark.parametrize('mode', ['switch', 'dyn'])
def test_bench_line_keys_equal_bench_py(capsys, mode):
    want = _keys(lambda: bench.emit([1.0, 3.0, 2.0], 'm', 1), capsys)
    values, metric = bench_torch.measure(
        mode, 2, 64, True, RUN if mode == 'dyn' else None, False, True,
        depth=1, device=CPU, calls=1)
    got = _keys(lambda: bench_torch.emit(values, metric), capsys)
    assert set(got) == set(want) - {'vs_baseline'}
    assert got['n_reruns'] == bench_torch.RERUNS
    assert 0 < got['value_min'] <= got['value'] <= got['value_max']


Metrics = collections.namedtuple('Metrics', 'g_loss emd')


def _stub_step(*args, **kwargs):
    def step(state, pool, *rest):
        return state, pool, Metrics(jnp.float32(0.5), jnp.float32(0.25))
    return step


def test_train_line_keys_equal_bench_train(monkeypatch, capsys):
    from exposure_tpu.utils.config import load_config
    monkeypatch.setattr(bench_train, 'load_config',
                        lambda name: load_config('test'))
    monkeypatch.setattr(bench_train, 'build_outer_step', _stub_step)
    monkeypatch.setattr(sys, 'argv', ['bench_train.py', '--iters', '3',
                                      '--pack-n', '16'])
    want = _keys(bench_train.main, capsys)
    got = _keys(lambda: bench_train_torch.main(
        ['--cpu', '--iters', '2', '--pack-n', '16'], config='test'), capsys)
    assert set(got) == set(want)
    assert got['metric'] == want['metric'] and got['unit'] == want['unit']
    assert np.isfinite([got['g_loss'], got['emd']]).all()
    assert got['value'] > 0


def test_stream_line_keys_equal_bench_stream(monkeypatch, capsys, tmp_path,
                                             jax_native_built):
    monkeypatch.setattr(bench_stream, 'build_streaming_outer_step',
                        _stub_step)
    monkeypatch.setattr(bench_stream, 'make_disk_pack', functools.partial(
        bench_stream.make_disk_pack, chunk=16))
    args = ['--pack-gb', '0.0001', '--iters', '2', '--config', 'test',
            '--u8', '--pack-dir']
    monkeypatch.setattr(sys, 'argv', ['bench_stream.py'] + args +
                        [str(tmp_path / 'jax')])
    want = _keys(bench_stream.main, capsys)
    port = tmp_path / 'port'
    got = _keys(lambda: bench_stream_torch.main(
        ['--cpu'] + args + [str(port)], chunk=16), capsys)
    assert set(got) == set(want)
    for key in ('metric', 'unit', 'pack_images', 'iters_per_dispatch',
                'bundle_dtype'):
        assert got[key] == want[key]
    assert np.isfinite([got['g_loss'], got['emd']]).all()
    assert got['value'] > 0 and got['host_assembly_gb_per_s'] > 0
    assert os.listdir(port) == []       # the packs were removed


def test_fused_stream_line_on_the_cpu(capsys, tmp_path):
    """``--fuse 2`` runs ``build_streaming_fused_step`` on stacked f32
    bundles, assembled one provider batch at a time; ``--keep-pack`` keeps
    the packs."""
    line = _keys(lambda: bench_stream_torch.main(
        ['--cpu', '--pack-gb', '0.0001', '--iters', '4', '--config', 'test',
         '--fuse', '2', '--legacy-assembly', '--keep-pack', '--pack-dir',
         str(tmp_path)], chunk=16), capsys)
    assert line['iters_per_dispatch'] == 2
    assert line['bundle_dtype'] == 'float32'
    assert line['unit'].endswith('fused x2)')
    assert np.isfinite([line['g_loss'], line['emd']]).all()
    assert sorted(os.listdir(tmp_path)) == ['stream_fake_0.0gb.npy',
                                            'stream_real_1gb.npy']


@pytest.mark.parametrize('script', [bench_torch, bench_train_torch,
                                    bench_stream_torch, bench_tf32])
def test_scripts_need_a_gpu_without_cpu(monkeypatch, capsys, tmp_path,
                                        script):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exit_:
        script.main([])
    assert exit_.value.code not in (0, None)
    assert 'no CUDA device' in str(exit_.value.code)
    assert capsys.readouterr().out == ''
    assert os.listdir(tmp_path) == []


# -- config files ---------------------------------------------------------
def test_load_config_file_and_working_directory(monkeypatch, tmp_path):
    from exposure_tpu_torch.utils.config import load_config, \
        load_config_file
    path = tmp_path / 'config_mine.py'
    path.write_text(
        'from exposure_tpu_torch.utils.config import load_config\n'
        "cfg = load_config('example')\n"
        'cfg.batch_size = 8\n')
    cfg = load_config_file(str(path))
    assert cfg.batch_size == 8 and cfg.name == 'example'
    assert cfg.fc1_size == load_config('example').fc1_size
    monkeypatch.chdir(tmp_path)
    mine = load_config('mine')
    assert mine.batch_size == 8 and mine.name == 'mine'
    assert load_config('example').batch_size != 8   # the table comes first
    with pytest.raises(KeyError, match='config_other.py'):
        load_config('other')
