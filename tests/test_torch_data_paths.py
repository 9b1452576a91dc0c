"""The data slice of the port against the JAX package, on a miniature FiveK
tree built on the fly (as ``tests/test_fivek_path.py`` builds it: 16-bit
TIFF exports, the fold files, JPEG and PNG artist renditions):

- ``read_set`` for every fold name, ``5k``, comments and the two errors;
- ``preprocess_raw_aug``: the pack and ``meta_raw.pkl`` equal;
- ``FiveKDataProvider`` (``2k_train``, ``u_test``, ``raw=False``),
  ``ArtistDataProvider`` (``2k_target``, a ``.txt`` set, ``read_limit``)
  and ``FolderDataProvider``: the data equal bit for bit, the device pack
  equal, batches equal on the same ``random`` seed (a resized batch within
  1e-5 of the JAX provider's ``cv2.resize``, as
  ``tests/test_torch_eval_tools.py`` holds the resize);
- the ``example`` and ``sintel`` configs' provider factories against the
  JAX configs', in the tree's directory;
- the TIFF reader against ``imageio``.

The JAX calls see ``cv2`` hidden, so that they take the strided resize the
port always takes (the JAX provider's own ``cv2`` import, at module level,
stays)."""

import os
import pickle
import random
import struct
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from exposure_tpu.data import artist as j_artist
from exposure_tpu.data import fivek as j_fivek
from exposure_tpu.data import folder as j_folder
from exposure_tpu.data import folds as j_folds
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.data import artist as t_artist
from exposure_tpu_torch.data import fivek as t_fivek
from exposure_tpu_torch.data import folder as t_folder
from exposure_tpu_torch.data import folds as t_folds
from exposure_tpu_torch.utils import image_io
from exposure_tpu_torch.utils.config import load_config as t_load_config
from exposure_tpu_torch.utils.dict_util import Dict, merge_dict

N_IMAGES = 6
FOLD_TEXT = {
    'FiveK_train_first2k.txt': '1\n2\n3\n',
    'FiveK_test.txt': '# the test fold\n4\n\n',
    'FiveK_train_second2k.txt': '5\n6\n',
    'FiveK_test_AMT.txt': '4\n',
}


def write_tiff(path, arr, order='<', deflate=False, predictor=False,
               rows_per_strip=None):
    """A baseline TIFF of a uint8/uint16 [H, W] or [H, W, 3] array, in
    strips of ``rows_per_strip`` rows."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    rows = rows_per_strip or h
    data = arr.reshape(h, w, c).astype(arr.dtype.newbyteorder(order))
    if predictor:
        data = data.copy()
        data[:, 1:] = np.diff(data, axis=1)
    strips = []
    for top in range(0, h, rows):
        raw = data[top:top + rows].tobytes()
        strips.append(zlib.compress(raw) if deflate else raw)
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    extra = b''
    tags = [(256, 4, [w]), (257, 4, [h]),
            (258, 3, [8 * arr.dtype.itemsize] * c),
            (259, 3, [8 if deflate else 1]), (262, 3, [2 if c == 3 else 1]),
            (273, 4, offsets), (277, 3, [c]), (278, 4, [rows]),
            (279, 4, [len(s) for s in strips]), (284, 3, [1])]
    if predictor:
        tags.append((317, 3, [2]))
    ifd_at = pos
    entries = []
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    for tag, kind, values in tags:
        code = 'H' if kind == 3 else 'I'
        packed = struct.pack(order + code * len(values), *values)
        if len(packed) <= 4:
            field = packed.ljust(4, b'\0')
        else:
            field = struct.pack(order + 'I', extra_at + len(extra))
            extra += packed
        entries.append(struct.pack(order + 'HHI', tag, kind, len(values)) +
                       field)
    head = (b'II' if order == '<' else b'MM') + \
        struct.pack(order + 'HI', 42, ifd_at)
    with open(path, 'wb') as f:
        f.write(head + b''.join(strips) +
                struct.pack(order + 'H', len(tags)) + b''.join(entries) +
                struct.pack(order + 'I', 0) + extra)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """A miniature FiveK tree with the dataset's layout."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp('fivek_root')
    src = root / 'data' / 'fivek_dataset' / \
        'FiveK_Lightroom_Export_InputDayLight'
    src.mkdir(parents=True)
    for i in range(N_IMAGES):
        img16 = (rng.rand(100 + 7 * i, 120, 3) * 65535).astype(np.uint16)
        if i % 2:
            imageio.imwrite(str(src / ('a%04d.tif' % (i + 1))), img16)
        else:
            write_tiff(str(src / ('a%04d.tif' % (i + 1))), img16, order='>',
                       deflate=True, predictor=True, rows_per_strip=16)
    folds = root / 'data' / 'folds'
    folds.mkdir(parents=True)
    for fn, text in FOLD_TEXT.items():
        (folds / fn).write_text(text)
    artists = root / 'data' / 'artists' / 'FiveK_C'
    artists.mkdir(parents=True)
    for i in range(N_IMAGES):
        img8 = (rng.rand(90 + 9 * i, 110, 3) * 255).astype(np.uint8)
        name = 'a%04d.%s' % (i + 1, 'jpg' if i % 2 else 'png')
        imageio.imwrite(str(artists / name), img8)
    sintel = root / 'data' / 'sintel' / 'outputs'
    sintel.mkdir(parents=True)
    for i in range(3):
        imageio.imwrite(str(sintel / ('f%02d.png' % i)),
                        (rng.rand(120, 96, 3) * 255).astype(np.uint8))
    (root / 'set.txt').write_text('0\n3\n5\n')
    batched = root / t_fivek.BATCHED_DIR
    batched.mkdir(parents=True)
    np.save(str(batched / 'image_retouched.npy'),
            rng.rand(4 * N_IMAGES, 80, 80, 3).astype(np.float32))
    return root


@pytest.fixture(scope='module')
def packs(tree):
    """``preprocess_raw_aug`` of both packages on the same ``random`` seed:
    the port's into the tree, the JAX one's beside it."""
    src = str(tree / t_fivek.SOURCE_DIR)
    random.seed(3)
    got = t_fivek.preprocess_raw_aug(src, str(tree / t_fivek.BATCHED_DIR))
    saved = sys.modules.get('cv2')
    sys.modules['cv2'] = None
    try:
        random.seed(3)
        want = j_fivek.preprocess_raw_aug(src, str(tree / 'jax_batched'))
    finally:
        if saved is None:
            del sys.modules['cv2']
        else:
            sys.modules['cv2'] = saved
    return got, want


@pytest.fixture
def fresh_pack_cache():
    for cls in (t_fivek.FiveKDataProvider, j_fivek.FiveKDataProvider):
        cls._raw_image_pack = None
    yield
    for cls in (t_fivek.FiveKDataProvider, j_fivek.FiveKDataProvider):
        cls._raw_image_pack = None


@pytest.mark.parametrize('name', ['u_test', 'u_amt', '2k_train',
                                  '2k_target', '5k'])
def test_read_set_equal(tree, name):
    got = t_folds.read_set(name, str(tree))
    assert got == j_folds.read_set(name, str(tree))
    if name == 'u_test':
        assert got == [4]       # the comment and the blank line skipped
    if name == '5k':
        assert got == list(range(1, 5001))


def test_read_set_errors(tmp_path):
    with pytest.raises(ValueError, match='known folds'):
        t_folds.read_set('3k')
    with pytest.raises(FileNotFoundError, match='FiveK_test.txt'):
        t_folds.read_set('u_test', str(tmp_path))
    assert t_folds.FOLD_FILES == j_folds.FOLD_FILES


def test_dict_and_merge_dict():
    d = Dict({'a': 1}, b=2)
    d.c = 3
    assert (d.a, d['b'], d.c) == (1, 2, 3)
    del d.c
    assert 'c' not in d and isinstance(d.copy(), Dict)
    with pytest.raises(AttributeError):
        d.missing
    assert merge_dict(d, {'e': 5}) == {'a': 1, 'b': 2, 'e': 5}
    with pytest.raises(KeyError, match='already exists'):
        merge_dict(d, {'a': 0})


def test_preprocess_raw_aug_equal(tree, packs):
    got, want = packs
    assert got.shape == (4 * N_IMAGES, 80, 80, 3)
    np.testing.assert_array_equal(got, want)
    for rel in ('image_raw.npy', 'meta_raw.pkl'):
        with open(str(tree / t_fivek.BATCHED_DIR / rel), 'rb') as f:
            a = f.read()
        with open(str(tree / 'jax_batched' / rel), 'rb') as f:
            assert a == f.read(), rel
    with open(str(tree / t_fivek.BATCHED_DIR / 'meta_raw.pkl'), 'rb') as f:
        assert pickle.load(f)['filenames'] == sorted(
            os.listdir(str(tree / t_fivek.SOURCE_DIR)))


def _equal_batches(t, j, n, seed, atol=0.0):
    random.seed(seed)
    got, _ = t.get_next_batch(n)
    random.seed(seed)
    want, _ = j.get_next_batch(n)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize('set_name,raw,aug', [('2k_train', True, 0.3),
                                              ('u_test', True, 0.0),
                                              ('2k_train', False, 0.3)])
def test_fivek_provider_equal(tree, packs, fresh_pack_cache, set_name, raw,
                              aug):
    kw = dict(set_name=set_name, raw=raw, data_root=str(tree),
              output_size=64, augmentation=aug, default_batch_size=8)
    random.seed(1)
    t = t_fivek.FiveKDataProvider(**kw)
    random.seed(1)
    j = j_fivek.FiveKDataProvider(**kw)
    ids = len(t_folds.read_set(set_name, str(tree)))
    assert t.num_images == j.num_images == 4 * ids
    np.testing.assert_array_equal(t.data, j.data)
    pack, jpack = t.device_pack('cpu'), j.device_pack()
    assert (pack.output_size, pack.augment) == (jpack.output_size,
                                                jpack.augment)
    np.testing.assert_array_equal(pack.images.numpy(),
                                  np.asarray(jpack.images))
    # the resize: plain bilinear against the JAX provider's cv2.resize
    _equal_batches(t, j, 8, 5, atol=0 if aug else 1e-5)


@pytest.mark.parametrize('case', ['2k_target', 'txt', 'read_limit'])
def test_artist_provider_equal(tree, monkeypatch, case):
    kw = dict(data_root=str(tree), output_size=64, augmentation=1.0,
              default_batch_size=8)
    if case == '2k_target':
        kw['set_name'] = '2k_target'
    elif case == 'txt':
        kw['set_name'] = str(tree / 'set.txt')
    else:
        kw['read_limit'] = 4
    random.seed(2)
    t = t_artist.ArtistDataProvider(**kw)
    monkeypatch.setitem(sys.modules, 'cv2', None)
    random.seed(2)
    j = j_artist.ArtistDataProvider(**kw)
    assert t.num_images == j.num_images == 4 * {'2k_target': 2, 'txt': 3,
                                                'read_limit': 4}[case]
    np.testing.assert_array_equal(t.data, j.data)
    _equal_batches(t, j, 8, 6)


def test_folder_provider_equal(tree, monkeypatch):
    folder = str(tree / 'data' / 'sintel' / 'outputs')
    # bnw, augmentation and output_size are overridden
    kw = dict(folder=folder, bnw=True, augmentation=0.0, output_size=32,
              default_batch_size=4)
    random.seed(4)
    t = t_folder.FolderDataProvider(**kw)
    monkeypatch.setitem(sys.modules, 'cv2', None)
    random.seed(4)
    j = j_folder.FolderDataProvider(**kw)
    assert (t.bnw, t.augmentation, t.output_size) == (False, 1.0, (64, 64))
    np.testing.assert_array_equal(t.data, j.data)
    _equal_batches(t, j, 12, 7)


@pytest.mark.parametrize('name', ['example', 'sintel'])
def test_config_providers_equal(tree, packs, fresh_pack_cache, monkeypatch,
                                name):
    """The configs' three factories, read relative to the working
    directory as the JAX configs read them: the flagship's batches
    [64, 64, 64, 3] equal on the same ``random`` seed."""
    monkeypatch.chdir(str(tree))
    tcfg, jcfg = t_load_config(name), j_load_config(name)
    monkeypatch.setitem(sys.modules, 'cv2', None)
    for knob in ('fake_data_provider', 'fake_data_provider_test',
                 'real_data_provider'):
        random.seed(8)
        t = tcfg[knob]()
        random.seed(8)
        j = jcfg[knob]()
        assert type(t).__name__ == type(j).__name__
        np.testing.assert_array_equal(t.data, j.data)
        _equal_batches(t, j, tcfg.batch_size, 9,
                       atol=1e-5 if knob.endswith('_test') else 0)


TIFF_CASES = ['rgb16', 'rgb16_big_endian', 'gray16', 'rgb8', 'gray8',
              'deflate_rgb8_strips', 'deflate_gray8', 'deflate_predictor16',
              'big_endian_strips16', 'lzw_by_imageio']


def _tiff(path, case, rng):
    img16 = (rng.rand(37, 53, 3) * 65535).astype(np.uint16)
    img8 = (img16 >> 8).astype(np.uint8)
    from PIL import Image
    if case == 'rgb16':
        imageio.imwrite(path, img16)
    elif case == 'rgb16_big_endian':
        imageio.imwrite(path, img16, byteorder='>')
    elif case == 'gray16':
        imageio.imwrite(path, img16[..., 0])
    elif case == 'rgb8':
        imageio.imwrite(path, img8)
    elif case == 'gray8':
        imageio.imwrite(path, img8[..., 1])
    elif case == 'deflate_rgb8_strips':
        big = (rng.rand(300, 200, 3) * 255).astype(np.uint8)
        Image.fromarray(big).save(path, compression='tiff_deflate')
    elif case == 'deflate_gray8':
        Image.fromarray(img8[..., 2]).save(path,
                                           compression='tiff_adobe_deflate')
    elif case == 'deflate_predictor16':
        write_tiff(path, img16, deflate=True, predictor=True,
                   rows_per_strip=5)
    elif case == 'big_endian_strips16':
        write_tiff(path, img16, order='>', rows_per_strip=4)
    else:
        Image.fromarray(img8).save(path, compression='tiff_lzw')


@pytest.mark.parametrize('case', TIFF_CASES)
def test_tiff_reader_against_imageio(tmp_path, case):
    path = str(tmp_path / 'x.tif')
    _tiff(path, case, np.random.RandomState(TIFF_CASES.index(case)))
    want = np.asarray(imageio.imread(path))
    if case == 'lzw_by_imageio':
        with pytest.raises(image_io.TiffNotRead):
            image_io.read_tiff(path)
    else:
        got = image_io.read_tiff(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    depth = 8 * want.dtype.itemsize
    np.testing.assert_array_equal(
        image_io.read_tiff16(path),
        want.astype(np.float32) * (1.0 / (2 ** depth - 1)))


def test_tiff_without_imageio_names_it(tmp_path, monkeypatch):
    path = str(tmp_path / 'x.tif')
    _tiff(path, 'lzw_by_imageio', np.random.RandomState(0))
    monkeypatch.setitem(sys.modules, 'imageio', None)
    monkeypatch.setitem(sys.modules, 'imageio.v2', None)
    with pytest.raises(RuntimeError, match='imageio'):
        image_io.read_tiff16(path)
    # a baseline file needs no imageio
    write_tiff(path, np.arange(12, dtype=np.uint16).reshape(3, 4))
    assert image_io.read_tiff16(path).shape == (3, 4)


def test_fivek_device_pack_goes_to_the_device(tree, packs,
                                             fresh_pack_cache):
    t = t_fivek.FiveKDataProvider('u_test', data_root=str(tree))
    pack = t.device_pack(torch.device('cpu'))
    assert pack.images.dtype == torch.float32
    assert tuple(pack.images.shape) == (4, 80, 80, 3)
