"""The port's FiveK data-ingest tools against the JAX originals on the same
procedural trees: ``import_reference_data`` (its constants, the findings of
``validate_pack`` strict and not, with one fold's digest changed, the links
and copies of ``import_data``, the command line), ``fetch_fivek_test``
(the files copied) and ``fetch_fivek`` (its URLs pointed at ``file://``
paths of a planted directory: no network)."""

import contextlib
import io
import os
import pickle
import sys
import zipfile

import numpy as np
import pytest

from exposure_tpu.tools import fetch_fivek as j_fetch
from exposure_tpu.tools import fetch_fivek_test as j_fetch_test
from exposure_tpu.tools import import_reference_data as j_ird
from exposure_tpu_torch.tools import fetch_fivek as t_fetch
from exposure_tpu_torch.tools import fetch_fivek_test as t_fetch_test
from exposure_tpu_torch.tools import import_reference_data as t_ird

FOLD_LINES = {'FiveK_train_first2k.txt': 2000,
              'FiveK_train_second2k.txt': 2000,
              'FiveK_test.txt': 1000, 'FiveK_test_AMT.txt': 100}
SOURCE = 'data/fivek_dataset/FiveK_Lightroom_Export_InputDayLight'


def _fivek_tree(root, pack=None, folds=FOLD_LINES, artists=6, tiffs=8):
    """A FiveK layout under ``root`` made from a seed: the 80x80 pack
    (``pack``, or a small linear-RAW-like one), the fold files (ids in
    shuffled order, ``folds`` lines each), ``artists`` artist JPEG names and
    ``tiffs`` Lightroom export names."""
    rng = np.random.RandomState(0)
    pack_path = os.path.join(root, t_ird.PACK_REL)
    os.makedirs(os.path.dirname(pack_path))
    if pack is None:
        pack = (rng.rand(12, 80, 80, 3) * 2).astype(np.float32)
    np.save(pack_path, pack)
    os.makedirs(os.path.join(root, 'data', 'folds'))
    for name, n in folds.items():
        ids = rng.permutation(5000)[:n] + 1
        with open(os.path.join(root, 'data', 'folds', name), 'w') as f:
            f.write(''.join('%d\n' % i for i in ids))
    adir = os.path.join(root, t_ird.ARTIST_DIR)
    os.makedirs(adir)
    for i in range(artists):
        with open(os.path.join(adir, 'a%04d.jpg' % (i + 1)), 'wb') as f:
            f.write(b'\xff\xd8' + rng.bytes(16) + b'\xff\xd9')
    src = os.path.join(root, SOURCE)
    os.makedirs(src)
    test_ids = open(os.path.join(root, 'data', 'folds',
                                 'FiveK_test.txt')).read().split()
    names = ['a%04d-x.tif' % int(i) for i in test_ids[:tiffs // 2]] + \
        ['a%04d-y.tif' % (5001 + i) for i in range(tiffs // 2)] + \
        ['notes.txt']
    for name in names:
        with open(os.path.join(src, name), 'wb') as f:
            f.write(rng.bytes(64))
    return root


def _tree(root):
    """``{relative path: bytes, or ('->', link target)}`` under ``root``."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = ('->', os.readlink(path))
            elif os.path.isfile(path):
                with open(path, 'rb') as f:
                    out[rel] = f.read()
    return out


def test_constants_are_the_jax_tools():
    for name in ('ARTIFACT_DIRS', 'PACK_REL', 'PACK_SHAPE', 'FOLDS',
                 'FOLD_SHA256', 'ARTIST_DIR', 'ARTIST_MIN_IMAGES'):
        assert getattr(t_ird, name) == getattr(j_ird, name), name
    for name in ('RELEASE_BASE', 'ARTIFACTS', 'FOLD_BASE', 'FOLDS'):
        assert getattr(t_fetch, name) == getattr(j_fetch, name), name
    from exposure_tpu.data.fivek import SOURCE_DIR
    assert t_fetch_test.SOURCE_DIR == SOURCE_DIR == SOURCE


TREES = {
    'miniature': dict(),
    'short_folds': dict(folds={k: 7 for k in FOLD_LINES}),
    'missing_fold': dict(folds={k: v for k, v in FOLD_LINES.items()
                                if k != 'FiveK_test_AMT.txt'}),
    'bad_range': dict(pack=np.full((4, 80, 80, 3), 99.0, np.float32)),
    'negative': dict(pack=np.full((4, 80, 80, 3), -1.0, np.float32)),
    'non_finite': dict(pack=np.full((4, 80, 80, 3), np.nan, np.float32)),
    'zeros': dict(pack=np.zeros((4, 80, 80, 3), np.float32)),
    'float64': dict(pack=np.full((4, 80, 80, 3), 0.5)),
}


@pytest.mark.parametrize('strict', [True, False], ids=['strict', 'loose'])
@pytest.mark.parametrize('tree', list(TREES))
def test_validate_pack_findings_equal_jax(tmp_path, tree, strict):
    root = _fivek_tree(str(tmp_path), **TREES[tree])
    got = t_ird.validate_pack(root, strict_folds=strict)
    assert got == j_ird.validate_pack(root, strict_folds=strict)
    assert not got[0]


@pytest.mark.parametrize('strict', [True, False], ids=['strict', 'loose'])
def test_validate_pack_with_one_fold_digest_changed(tmp_path, monkeypatch,
                                                    strict):
    """One fold's canonical digest set to the planted file's: strict
    validation then passes that fold and flags the other three, in both
    tools alike."""
    root = _fivek_tree(str(tmp_path))
    rel = 'data/folds/FiveK_test_AMT.txt'
    digest = t_ird._sha256_file(os.path.join(root, rel))
    assert digest == j_ird._sha256_file(os.path.join(root, rel))
    monkeypatch.setitem(t_ird.FOLD_SHA256, rel, digest)
    monkeypatch.setitem(j_ird.FOLD_SHA256, rel, digest)
    got = t_ird.validate_pack(root, strict_folds=strict)
    assert got == j_ird.validate_pack(root, strict_folds=strict)
    assert sum('sha256' in f for f in got[1]) == (3 if strict else 0)
    assert not any(rel + ' sha256' in f for f in got[1])


def test_missing_tree_findings_equal_jax(tmp_path):
    got = t_ird.validate_pack(str(tmp_path))
    assert got == j_ird.validate_pack(str(tmp_path))
    assert len(got[1]) == 6 and all('MISSING' in f for f in got[1])


def _main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['tool'] + list(argv))
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            module.main()
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


def test_validate_only_cli_equals_jax(tmp_path, monkeypatch):
    """On the planted tree only the pack's shape and the artist count are
    off (non-strict folds of the right lengths): the same lines and exit
    code from both tools."""
    root = _fivek_tree(str(tmp_path))
    argv = ['--validate-only', '--data-root', root, '--no-strict-folds']
    got = _main(t_ird, argv, monkeypatch)
    assert got == _main(j_ird, argv, monkeypatch)
    assert got[0] == 1 and 'pack shape' in got[1]
    assert 'validation FAILED (2 findings)' in got[1]


def test_clean_drop_names_the_port_campaign(tmp_path, monkeypatch):
    """A drop of the dataset's sizes (a sparse pack: only the validator's
    sample rows are written) validates; the message names the port's
    ``validate_parity``."""
    root = str(tmp_path)
    _fivek_tree(root, artists=t_ird.ARTIST_MIN_IMAGES, tiffs=0)
    pack = np.lib.format.open_memmap(
        os.path.join(root, t_ird.PACK_REL), mode='w+', dtype=np.float32,
        shape=t_ird.PACK_SHAPE)
    pack[::t_ird.PACK_SHAPE[0] // 64] = 0.25
    del pack
    code, out = _main(t_ird, ['--validate-only', '--data-root', root,
                              '--no-strict-folds'], monkeypatch)
    assert code == 0 and 'validation OK' in out
    assert 'python -m exposure_tpu_torch.tools.validate_parity --config ' \
        'example' in out.replace('\n  ', ' ')
    assert 'exposure_tpu.tools' not in out


@pytest.mark.parametrize('copy', [False, True], ids=['link', 'copy'])
def test_import_data_equals_jax(tmp_path, copy):
    ref = _fivek_tree(str(tmp_path / 'reference'))
    os.makedirs(str(tmp_path / 'mine' / 'data' / 'folds'))  # present: kept
    os.makedirs(str(tmp_path / 'theirs' / 'data' / 'folds'))
    got = t_ird.import_data(ref, str(tmp_path / 'mine'), copy=copy)
    want = j_ird.import_data(ref, str(tmp_path / 'theirs'), copy=copy)
    assert got == want == ['data/artists', 'data/fivek_dataset']
    mine, theirs = _tree(str(tmp_path / 'mine')), \
        _tree(str(tmp_path / 'theirs'))
    assert mine == theirs
    if copy:
        assert t_ird.PACK_REL in mine
    else:
        assert mine['data/artists'] == ('->', os.path.join(ref,
                                                           'data/artists'))
    # a second import finds everything present and imports nothing
    assert t_ird.import_data(ref, str(tmp_path / 'mine'), copy=copy) == []


def test_fetch_test_set_equals_jax(tmp_path, monkeypatch):
    root = _fivek_tree(str(tmp_path / 'root'))
    monkeypatch.chdir(str(tmp_path))
    t_fetch_test.fetch(root, str(tmp_path / 'mine'))
    j_fetch_test.fetch(root, str(tmp_path / 'theirs'))
    mine = _tree(str(tmp_path / 'mine'))
    assert mine == _tree(str(tmp_path / 'theirs'))
    assert len(mine) == 4 and all(k.endswith('-x.tif') for k in mine)


@pytest.fixture
def release(tmp_path):
    """A planted release directory: the fold files, a small FiveK_C.zip of
    JPEGs, ``image_raw.npy`` and ``meta_raw.pkl``; its ``file://`` URL."""
    rng = np.random.RandomState(1)
    rel = tmp_path / 'release'
    rel.mkdir()
    for name in j_fetch.FOLDS:
        (rel / name).write_text(''.join(
            '%d\n' % i for i in rng.permutation(5000)[:5] + 1))
    with zipfile.ZipFile(str(rel / 'FiveK_C.zip'), 'w') as z:
        for i in range(3):
            z.writestr('FiveK_C/a%04d.jpg' % (i + 1), rng.bytes(32))
    np.save(str(rel / 'image_raw.npy'),
            rng.rand(4, 80, 80, 3).astype(np.float32))
    with open(str(rel / 'meta_raw.pkl'), 'wb') as f:
        pickle.dump(['a0001', 'a0002'], f)
    return 'file://' + str(rel) + '/'


def test_fetch_fivek_equals_jax_on_a_planted_release(tmp_path, monkeypatch,
                                                     release):
    for module in (t_fetch, j_fetch):
        monkeypatch.setattr(module, 'RELEASE_BASE', release)
        monkeypatch.setattr(module, 'FOLD_BASE', release)
    mine, theirs = str(tmp_path / 'mine'), str(tmp_path / 'theirs')
    assert _main(t_fetch, ['--data-root', mine], monkeypatch)[0] == 0
    assert _main(j_fetch, ['--data-root', theirs], monkeypatch)[0] == 0
    tree = _tree(mine)
    assert tree == _tree(theirs)
    assert 'data/artists/FiveK_C/a0003.jpg' in tree
    assert 'data/folds/FiveK_test.txt' in tree
    assert os.path.join(os.path.dirname(t_fetch.ARTIFACTS['image_raw.npy']),
                        'image_raw.npy') in tree
    # a second run downloads nothing: every file exists
    code, out = _main(t_fetch, ['--data-root', mine], monkeypatch)
    assert code == 0 and 'downloading' not in out
    assert out.count('exists, skipping') == 7
