"""The port's white-box tools and the data they draw on, against the JAX
package on the CPU:

- ``edit_sequence``: ``apply_edit`` and ``pack_trajectory`` equal,
  ``replay`` within the chain tolerance (atol 3e-5 / rtol 1e-4, at most
  1e-4 of the values outside), and the command end to end;
- ``pickle_to_tex``: the same file from the same pickle;
- ``histogram_intersection``: ``get_statistics`` and
  ``compare_image_sets`` within 1e-6 with ``cv2`` hidden on both sides (the
  port never takes it), ``read_images`` on a directory, the fold branch's
  refusal;
- ``data/synthetic.py`` and ``data/provider.py``: packs equal array for
  array; batches equal under the same ``random`` seed; the numpy bilinear
  resize within 1e-5 of the JAX provider's ``cv2.resize`` branch; the
  config table's providers build what the JAX configs' build;
- ``quality_report``: the same report from the same inputs and weights
  (intersections within 1e-4: they are rounded to 4 places)."""

import json
import os
import pickle
import random
import sys

import jax
import numpy as np
import pytest
import torch

from exposure_tpu.core.trainer import build_models as j_build_models
from exposure_tpu.core.trainer import init_train_state
from exposure_tpu.data import provider as j_provider
from exposure_tpu.data import synthetic as j_synth
from exposure_tpu.tools import edit_sequence as j_edit
from exposure_tpu.tools import histogram_intersection as j_hist
from exposure_tpu.tools import pickle_to_tex as j_tex
from exposure_tpu.tools import quality_report as j_quality
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.core.artifacts import flax_to_state_dict
from exposure_tpu_torch.data import provider as t_provider
from exposure_tpu_torch.data import synthetic as t_synth
from exposure_tpu_torch.models.networks import build_models as t_build_models
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.tools import edit_sequence as t_edit
from exposure_tpu_torch.tools import histogram_intersection as t_hist
from exposure_tpu_torch.tools import pickle_to_tex as t_tex
from exposure_tpu_torch.tools import quality_report as t_quality
from exposure_tpu_torch.utils.config import load_config as t_load_config
from exposure_tpu_torch.utils.image_io import read_image, write_image

F32_ATOL, F32_RTOL, MAX_OUTLIER_FRAC = 3e-5, 1e-4, 1e-4


def _debug(filters, rng, masked=False, applied=(True, True, True, False)):
    """A debug list as ``Evaluator.eval`` writes it, with regressed random
    parameters."""
    names = [f.get_short_name() for f in filters]
    out = []
    for i, on in enumerate(applied):
        fid = int(rng.randint(0, len(filters)))
        f = filters[fid]
        n = f.get_num_filter_parameters()
        raw = torch.from_numpy(rng.randn(1, n).astype(np.float32))
        out.append({
            'step': i, 'filter_id': fid, 'short_name': names[fid],
            'all_short_names': names,
            'filter_parameters': f.filter_param_regressor(raw).numpy()[0],
            'mask_parameters': rng.randn(
                f.get_num_mask_parameters()).astype(np.float32)
            if masked else np.zeros((0,), np.float32),
            'pdf': np.full((len(filters),), 1.0 / len(filters), np.float32),
            'applied': bool(on)})
    return out


def _banks(name):
    jcfg = j_load_config(name)
    return build_filters(t_load_config(name)), [f(jcfg) for f in jcfg.filters]


@pytest.mark.parametrize('name', ['test', 'masked'])
def test_pack_trajectory_and_replay_match(name):
    tf, jf = _banks(name)
    rng = np.random.RandomState(3)
    debug = _debug(tf, rng, masked=(name == 'masked'))
    del debug[1]['mask_parameters']     # unmasked pickles may omit the key
    if name == 'masked':
        debug[1]['mask_parameters'] = np.zeros((6,), np.float32)
    for got, want in zip(t_edit.pack_trajectory(debug, tf),
                         j_edit.pack_trajectory(debug, jf)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    image = (rng.rand(50, 77, 3) * 0.7).astype(np.float32)
    got = t_edit.replay(image, debug, tf, device='cpu')
    want = j_edit.replay(image, debug, jf, use_pallas=False)
    assert got.shape == want.shape == image.shape and got.dtype == np.float32
    bad = ~np.isclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    assert bad.mean() <= MAX_OUTLIER_FRAC, np.abs(got - want).max()


@pytest.mark.parametrize('edit', [dict(scale=0.5), dict(sets=['0=0.25']),
                                  dict(scale=2.0, sets=['0=1.5']),
                                  dict(drop=True)])
def test_apply_edit_matches(edit):
    tf, _ = _banks('test')
    debug = _debug(tf, np.random.RandomState(5))
    got, got_rec = t_edit.apply_edit(debug, 1, **edit)
    want, want_rec = j_edit.apply_edit(debug, 1, **edit)
    assert got_rec == want_rec
    assert debug[1]['applied'] is True      # the input is not mutated
    for a, b in zip(got, want):
        assert a['applied'] == b['applied']
        np.testing.assert_array_equal(a['filter_parameters'],
                                      b['filter_parameters'])


def test_edit_sequence_command(tmp_path):
    """The case of tests/test_tools.py::TestEditSequence through the port's
    command on the CPU."""
    filters = build_filters(t_load_config('test'))
    fid = next(i for i, f in enumerate(filters)
               if type(f).__name__ == 'ExposureFilter')
    names = [f.get_short_name() for f in filters]
    debug = [
        {'step': 0, 'filter_id': fid, 'short_name': names[fid],
         'all_short_names': names,
         'filter_parameters': np.asarray([2.0], np.float32),
         'mask_parameters': np.zeros((0,), np.float32),
         'pdf': np.zeros((len(filters),), np.float32), 'applied': True},
        {'step': 1, 'filter_id': fid, 'short_name': names[fid],
         'all_short_names': names,
         'filter_parameters': np.asarray([0.5], np.float32),
         'pdf': np.zeros((len(filters),), np.float32), 'applied': False},
    ]
    dbg = tmp_path / 'img_debug.pkl'
    with open(dbg, 'wb') as f:
        pickle.dump(debug, f)
    img = tmp_path / 'img.png'
    write_image(str(img), np.random.RandomState(0).rand(24, 32, 3) * 0.5 +
                0.2)
    out = tmp_path / 'edit'
    rec = t_edit.main(['--config', 'test', '--debug', str(dbg), '--image',
                       str(img), '--step', '0', '--scale', '0.5',
                       '--out-dir', str(out), '--device', 'cpu'])
    before = read_image(str(out / 'before.png'))
    after = read_image(str(out / 'after.png'))
    assert after.mean() < before.mean()
    assert np.abs(after - before).max() > 0.01
    assert rec == json.loads((out / 'edit.json').read_text())
    assert rec['edit'] == 'scale 0.5'
    assert rec['params_before'] == [2.0] and rec['params_after'] == [1.0]
    assert len(rec['sequence']) == 2
    assert rec['sequence'][1]['applied'] is False
    # the JAX command on the same inputs writes the same two images
    jout = tmp_path / 'jedit'
    j_edit.main(['--config', 'test', '--debug', str(dbg), '--image',
                 str(img), '--step', '0', '--scale', '0.5', '--out-dir',
                 str(jout)])
    for name in ('before.png', 'after.png'):
        a = read_image(str(out / name)) * 255
        b = read_image(str(jout / name)) * 255
        assert np.abs(a - b).max() <= 1, name   # 8-bit truncation of 3e-5
    out2 = tmp_path / 'edit2'
    t_edit.main(['--config', 'test', '--debug', str(dbg), '--image',
                 str(img), '--step', '0', '--drop', '--out-dir', str(out2),
                 '--device', 'cpu'])
    from exposure_tpu_torch.core.evaluator import load_linear_image
    ident = np.clip(load_linear_image(str(img)), 0, 1)
    assert np.abs(read_image(str(out2 / 'after.png')) - ident).max() \
        < 2.5 / 255
    with pytest.raises(SystemExit):
        t_edit.main(['--config', 'test', '--debug', str(dbg), '--image',
                     str(img), '--step', '0'])


def test_replay_on_a_cuda_device_never_takes_the_cpu_path(monkeypatch):
    """Asked for the card, ``replay`` hands CUDA tensors to K1's wrapper
    (which launches or raises) and never the branchless chain."""
    import exposure_tpu_torch.ops.chain as chain
    from exposure_tpu_torch import kernels
    tf, _ = _banks('test')
    debug = _debug(tf, np.random.RandomState(1))
    monkeypatch.setattr(chain, 'apply_filter_chain', lambda *a, **kw: 1 / 0)
    image = np.full((8, 8, 3), 0.5, np.float32)
    before = kernels.launch_counts()['dyn_chain']
    if torch.cuda.is_available():
        t_edit.replay(image, debug, tf, device='cuda')
        assert kernels.launch_counts()['dyn_chain'] == before + 1
    else:
        # no card: it raises rather than replaying on the host
        with pytest.raises((RuntimeError, AssertionError)):
            t_edit.replay(image, debug, tf, device='cuda')
        assert kernels.launch_counts()['dyn_chain'] == before


def test_pickle_to_tex_matches(tmp_path):
    tf, _ = _banks('test')
    rng = np.random.RandomState(7)
    debug = _debug(tf, rng, applied=(True,) * 6 + (False,))
    pkl = str(tmp_path / 'a_debug.pkl')
    with open(pkl, 'wb') as f:
        pickle.dump(debug, f)
    got = t_tex.convert(pkl, str(tmp_path / 't.tex'))
    want = j_tex.convert(pkl, str(tmp_path / 'j.tex'))
    text = open(got).read()
    assert text == open(want).read()
    assert text.count('\\begin{tikzpicture}') == 6
    assert t_tex.convert(pkl) == str(tmp_path / 'a_debug.tex')


def _photos(rng, n, size=64):
    base = rng.rand(n, 4, 4, 3)
    img = np.kron(base, np.ones((1, size // 4, size // 4, 1)))
    return np.clip(img + rng.randn(n, size, size, 3) * 0.05, -0.1,
                   1.2).astype(np.float32)


def test_histogram_statistics_match_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    rng = np.random.RandomState(0)
    a, b = _photos(rng, 40), np.abs(_photos(rng, 40)) ** 1.7
    gray = np.full((64, 64, 3), 0.4, np.float32)    # max == min everywhere
    for img in list(a[:5]) + [gray]:
        np.testing.assert_allclose(t_hist.get_statistics(img),
                                   j_hist.get_statistics(img), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(t_hist.compare_image_sets(a, b),
                               j_hist.compare_image_sets(a, b), rtol=0,
                               atol=1e-6)
    got_h, got_s = t_hist.get_histograms(list(a))
    want_h, want_s = j_hist.get_histograms(list(a))
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=1e-6)
    assert t_hist.hist_intersection(got_h[0], got_h[0]) == pytest.approx(1.0)
    assert t_hist.HIST_BINS == j_hist.HIST_BINS == 32


def test_histogram_never_takes_cv2():
    """With ``cv2`` installed the port still computes the numpy
    saturation: a call with ``cv2`` present equals one with it hidden."""
    img = _photos(np.random.RandomState(1), 1)[0]
    with_cv2 = t_hist.get_statistics(img)
    saved = sys.modules.get('cv2')
    sys.modules['cv2'] = None
    try:
        without = t_hist.get_statistics(img)
    finally:
        if saved is None:
            del sys.modules['cv2']
        else:
            sys.modules['cv2'] = saved
    assert with_cv2 == without


def test_read_images_and_compare_dirs(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    rng = np.random.RandomState(2)
    for d in ('out', 'target'):
        os.makedirs(str(tmp_path / d))
        for i in range(3):
            write_image(str(tmp_path / d / ('%d.png' % i)),
                        _photos(rng, 1, 96)[0, :, :88])
    got = t_hist.read_images(str(tmp_path / 'out'), seed=4)
    want = j_hist.read_images(str(tmp_path / 'out'), seed=4)
    assert len(got) == len(want) == 3 * 16
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        t_hist.compare_dirs(str(tmp_path / 'out'), str(tmp_path / 'target'),
                            seed=4),
        j_hist.compare_dirs(str(tmp_path / 'out'), str(tmp_path / 'target'),
                            seed=4), rtol=0, atol=1e-6)
    # a FiveK fold keeps the files named by its ids (0 and 2 here)
    folds = tmp_path / 'data' / 'folds'
    folds.mkdir(parents=True)
    (folds / 'FiveK_test.txt').write_text('# ids\n0\n\n2\n')
    got = t_hist.read_images(str(tmp_path / 'out'), fold='u_test',
                             data_root=str(tmp_path), seed=4)
    want = j_hist.read_images(str(tmp_path / 'out'), fold='u_test',
                              data_root=str(tmp_path), seed=4)
    assert len(got) == len(want) == 2 * 16
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match='FiveK_train_first2k'):
        t_hist.read_images(str(tmp_path / 'out'), fold='2k_train',
                           data_root=str(tmp_path))


@pytest.mark.parametrize('kw', [
    dict(style='raw'), dict(style='retouched'),
    dict(style='raw', cast=0.3), dict(style='retouched', spread=1.0),
    dict(style='raw', texture=1.0), dict(style='retouched', texture=1.0),
    dict(style='retouched', size=64, seed=2)])
def test_make_synthetic_pack_equal(kw):
    kw = dict(dict(n=6, size=80, seed=1), **kw)
    got = t_synth.make_synthetic_pack(**kw)
    want = j_synth.make_synthetic_pack(**kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_paired_pack_and_provider_equal():
    np.testing.assert_array_equal(
        t_synth.make_paired_synthetic_pack(4, 80, 3),
        j_synth.make_paired_synthetic_pack(4, 80, 3))
    with pytest.raises(ValueError):
        t_synth.make_synthetic_pack(2, style='other')
    random.seed(9)
    t = t_synth.PairedSyntheticDataProvider(n=8, seed=1)
    got = t.get_next_batch(5)
    random.seed(9)
    j = j_synth.PairedSyntheticDataProvider(n=8, seed=1)
    want = j.get_next_batch(5)
    assert got[0].shape == (5, 2, 64, 64, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize('kw', [
    dict(augmentation=0.3, output_size=64),         # crop and flip
    dict(augmentation=1.0, output_size=64, bnw=True),
    dict(augmentation=0.0, output_size=-1),         # as stored
    dict(augmentation=0.3, output_size=64, limit=0.5, image_scaling=0.5)])
def test_get_next_batch_equal(kw):
    """No resize in these: the same ``random`` draws give equal batches,
    across an epoch's end too."""
    data = t_synth.make_synthetic_pack(10, 80, 'raw', 0)
    random.seed(3)
    t = t_provider.DataProvider(data, **kw)
    got = [t.get_next_batch(4) for _ in range(4)]
    got_r = t.get_random_batch(3)
    random.seed(3)
    j = j_provider.DataProvider(data, **kw)
    want = [j.get_next_batch(4) for _ in range(4)]
    want_r = j.get_random_batch(3)
    for (a, fa), (b, fb) in zip(got + [got_r], want + [want_r]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(fa, fb)
    pack, want = t.device_pack(), j.device_pack()
    np.testing.assert_array_equal(pack.images.numpy(), want.images)
    assert (pack.output_size, pack.augment) == (want.output_size,
                                                want.augment)


@pytest.mark.parametrize('src,dst', [(80, 64), (64, 80), (100, 64),
                                     (33, 64)])
def test_resize_matches_the_cv2_branch(src, dst):
    """The numpy bilinear resize against ``cv2.resize`` (``INTER_LINEAR``,
    the JAX provider's branch when ``cv2`` is installed) on float images:
    within 1e-5 (it reaches about 1e-7: ``cv2`` computes float images with
    float weights)."""
    assert j_provider.cv2 is not None
    data = np.random.RandomState(4).rand(3, src, src, 3).astype(np.float32)
    random.seed(0)
    t = t_provider.DataProvider(data, output_size=dst, augmentation=0.0)
    got, _ = t.get_next_batch(3)
    random.seed(0)
    j = j_provider.DataProvider(data, output_size=dst, augmentation=0.0)
    want, _ = j.get_next_batch(3)
    assert got.shape == want.shape == (3, dst, dst, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    gray = t_provider.resize_bilinear(data[0, :, :, 0], (dst, dst))
    assert gray.shape == (dst, dst)
    np.testing.assert_allclose(
        gray, j_provider.cv2.resize(data[0, :, :, 0], (dst, dst)), rtol=0,
        atol=1e-5)


@pytest.mark.parametrize('name', ['synthetic', 'synthetic_explore', 'test',
                                  'masked'])
def test_config_providers_build_what_the_jax_configs_build(name, tmp_path,
                                                           monkeypatch):
    jcfg, tcfg = j_load_config(name), t_load_config(name)
    assert tcfg.batch_size == jcfg.batch_size
    assert tcfg.real_img_channels == jcfg.real_img_channels
    assert tcfg.supervised == jcfg.supervised
    assert tcfg.vis_step_test == jcfg.vis_step_test
    for knob in ('fake_data_provider', 'fake_data_provider_test',
                 'real_data_provider'):
        if name in ('synthetic', 'masked') and knob != \
                'fake_data_provider_test':
            continue    # the same 2048-image packs as synthetic_explore's
        random.seed(1)
        t = tcfg[knob]()
        random.seed(1)
        j = jcfg[knob]()
        np.testing.assert_array_equal(t.data, j.data)
        assert t.output_size == j.output_size
        assert t.augmentation == j.augmentation
        assert t.default_batch_size == j.default_batch_size
        assert t.indices == j.indices
    # the flagship's factories read the FiveK tree under the working
    # directory (tests/test_torch_data_paths.py holds them to JAX's there)
    monkeypatch.chdir(str(tmp_path))
    with pytest.raises(FileNotFoundError, match='FiveK_train_first2k'):
        t_load_config('example').fake_data_provider()


def test_quality_report_matches(monkeypatch):
    """The same report from the same weights (dropout off) and the same
    inputs: both sides draw their 64-pixel inputs without a resize, and
    ``cv2`` is hidden from the JAX saturation."""
    monkeypatch.setitem(sys.modules, 'cv2', None)
    jcfg = j_load_config('test').copy()
    jcfg.dropout_keep_prob = 1.0
    jcfg.name = 'test/none'
    _, policy, critic, value = j_build_models(jcfg)
    state, _ = init_train_state(jcfg, policy, critic, value, 2)
    tcfg = t_load_config('test')
    tcfg.dropout_keep_prob = 1.0
    tcfg.name = jcfg.name
    _, tpolicy, _, _ = t_build_models(tcfg)
    tpolicy.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.gen_params)))
    for cfg, synth in ((jcfg, j_synth), (tcfg, t_synth)):
        cfg.fake_data_provider_test = lambda s=synth: \
            s.SyntheticDataProvider(n=32, size=64, style='raw', seed=1,
                                    output_size=64, augmentation=0.0)
    random.seed(5)
    want = j_quality.quality_report(jcfg, n=24, state=state)
    random.seed(5)
    got = t_quality.quality_report(tcfg, n=24, policy=tpolicy, device='cpu')
    assert sorted(got) == sorted(want)
    assert got['n'] == want['n'] == 24
    assert got['avg_steps_applied'] == want['avg_steps_applied']
    for key in ('intersection_before', 'intersection_after', 'avg_before',
                'avg_after'):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4,
                                   err_msg=key)


def test_quality_report_supervised_branch():
    """The paired branch: inputs and targets from one paired provider, and
    the two MSE keys."""
    cfg = t_load_config('test')
    cfg.name = 'test/none'
    cfg.supervised = True
    cfg.fake_data_provider_test = lambda: \
        t_synth.PairedSyntheticDataProvider(n=8, seed=1, augmentation=0.0,
                                            size=64)
    torch.manual_seed(0)
    _, policy, _, _ = t_build_models(cfg)
    rep = t_quality.quality_report(cfg, n=6, policy=policy, device='cpu')
    assert rep['n'] == 6 and 0 <= rep['mse_after'] and rep['mse_before'] > 0
    assert len(rep['intersection_after']) == 3
