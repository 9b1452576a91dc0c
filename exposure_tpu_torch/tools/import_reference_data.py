"""Import dataset artifacts from an existing exposure checkout (a copy of
``exposure_tpu/tools/import_reference_data.py``: pure Python and numpy,
so it runs on a machine without JAX).

Users switching from the reference implementation typically already have
its ``data/`` tree (folds, artist sets, FiveK packs).  This tool links or
copies those *dataset artifacts* (not code) into this repo's layout so no
re-download is needed — and VALIDATES the result (pack shape/dtype/value
range, fold line counts, artist set size), so a single drop + this
command is everything needed before the full parity campaign:

  python -m exposure_tpu_torch.tools.import_reference_data /path/to/exposure
  python -m exposure_tpu_torch.tools.validate_parity --config example

Validation alone (e.g. after a manual file drop):

  python -m exposure_tpu_torch.tools.import_reference_data --validate-only

Usage: python -m exposure_tpu_torch.tools.import_reference_data \
           [/path/to/exposure] [--data-root .] [--copy] [--validate-only]
"""

import argparse
import hashlib
import os
import shutil

ARTIFACT_DIRS = [
    'data/folds',
    'data/artists',
    'data/fivek_dataset',
]

# expected artifacts (reference fetch_fivek.py:7-68, fivek.py:12-14,
# 33-36, util.py:441-473)
PACK_REL = 'data/fivek_dataset/sup_batched80aug_daylight/image_raw.npy'
PACK_SHAPE = (20000, 80, 80, 3)  # 5000 RAW images x 4 crops
FOLDS = {
    'data/folds/FiveK_train_first2k.txt': 2000,
    'data/folds/FiveK_train_second2k.txt': 2000,
    'data/folds/FiveK_test.txt': 1000,
    'data/folds/FiveK_test_AMT.txt': 100,
}
# SHA-256 of the canonical fold files shipped with the reference
# dataset release (data/folds/*.txt).  A fold with the right line count
# but a different digest is a DIFFERENT experimental split — results on
# it are not comparable to the paper, so strict validation (the CLI
# default) fails on mismatch.
FOLD_SHA256 = {
    'data/folds/FiveK_train_first2k.txt':
        '1b745f582a267611acbba652c14f7fc5a778fec5dcb152d50eddcec4ba8a2234',
    'data/folds/FiveK_train_second2k.txt':
        'bc17755a354397acf47cb91fcd6535d4fa0b32c59533be4da376d7fe1a7935af',
    'data/folds/FiveK_test.txt':
        'c1b0ea133b46cdca94c3a71239c875c311fcf619ce45b62a243b70fe31bf0d8b',
    'data/folds/FiveK_test_AMT.txt':
        'a264fced5c9be509f6b58f24806dafc90b8d2ba77dc651d511ece80e86f81ca7',
}


def _sha256_file(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()
ARTIST_DIR = 'data/artists/FiveK_C'  # expert-C JPEGs (FiveK_C.zip),
                                     # config_example.py real provider
ARTIST_MIN_IMAGES = 4000        # nominally 5000


def validate_pack(data_root='.', strict_folds=True):
    """Check the dropped artifacts; returns (ok, list of findings).

    ``strict_folds`` additionally requires each fold file to match the
    canonical release byte-for-byte (SHA-256) — the guarantee that a
    quality number measured on this drop is on the PAPER's split."""
    import numpy as np
    findings = []

    path = os.path.join(data_root, PACK_REL)
    if not os.path.exists(path):
        findings.append('MISSING pack: %s' % path)
    else:
        try:
            arr = np.load(path, mmap_mode='r')
            if tuple(arr.shape) != PACK_SHAPE:
                findings.append('pack shape %r != expected %r (a partial '
                                'pack still works but is not the paper '
                                'benchmark)' % (tuple(arr.shape),
                                                PACK_SHAPE))
            if arr.dtype != np.float32:
                findings.append('pack dtype %s != float32' % arr.dtype)
            # spot-check value sanity on a strided sample (linearized
            # ProPhotoRGB RAW is non-negative and peaks well under ~16)
            sample = np.asarray(arr[:: max(len(arr) // 64, 1)])
            if not np.isfinite(sample).all():
                findings.append('pack contains non-finite values')
            elif sample.min() < -1e-3 or sample.max() > 64:
                findings.append('pack value range [%.3g, %.3g] is not '
                                'linear RAW-like' % (sample.min(),
                                                     sample.max()))
            elif sample.max() <= 0:
                findings.append('pack is all zeros')
        except (ValueError, OSError) as e:
            findings.append('pack unreadable: %s' % e)

    for rel, n in FOLDS.items():
        p = os.path.join(data_root, rel)
        if not os.path.exists(p):
            findings.append('MISSING fold: %s' % p)
            continue
        with open(p) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        if len(lines) != n:
            findings.append('%s has %d ids, expected %d'
                            % (rel, len(lines), n))
        elif strict_folds and rel in FOLD_SHA256:
            digest = _sha256_file(p)
            if digest != FOLD_SHA256[rel]:
                findings.append(
                    '%s sha256 %s... != canonical %s... — a different '
                    'split; results are not paper-comparable '
                    '(--no-strict-folds to accept)'
                    % (rel, digest[:16], FOLD_SHA256[rel][:16]))

    adir = os.path.join(data_root, ARTIST_DIR)
    if not os.path.isdir(adir):
        findings.append('MISSING artist set: %s (FiveK_C.zip)' % adir)
    else:
        n_img = len([f for f in os.listdir(adir)
                     if f.lower().endswith(('.jpg', '.jpeg', '.png'))])
        if n_img < ARTIST_MIN_IMAGES:
            findings.append('%s holds %d images, expected ~5000'
                            % (adir, n_img))
    return not findings, findings


def import_data(reference_root, data_root='.', copy=False):
    imported = []
    for rel in ARTIFACT_DIRS:
        src = os.path.join(reference_root, rel)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(data_root, rel)
        if os.path.exists(dst):
            print('exists, skipping:', dst)
            continue
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if copy:
            shutil.copytree(src, dst)
        else:
            os.symlink(os.path.abspath(src), dst)
        imported.append(rel)
    return imported


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('reference_root', nargs='?', default=None)
    parser.add_argument('--data-root', default='.')
    parser.add_argument('--copy', action='store_true',
                        help='copy instead of symlink')
    parser.add_argument('--validate-only', action='store_true',
                        help='only validate what is already dropped')
    parser.add_argument('--no-strict-folds', action='store_true',
                        help='accept fold files whose content differs '
                             'from the canonical release (line counts '
                             'still checked)')
    args = parser.parse_args()
    if not args.validate_only:
        if not args.reference_root:
            parser.error('reference_root required unless --validate-only')
        imported = import_data(args.reference_root, args.data_root,
                               args.copy)
        print('imported:',
              imported or 'nothing (all present or source empty)')
    ok, findings = validate_pack(args.data_root,
                                 strict_folds=not args.no_strict_folds)
    for f in findings:
        print('VALIDATE:', f)
    if ok:
        print('validation OK — run the full parity campaign with:\n'
              '  python -m exposure_tpu_torch.tools.validate_parity '
              '--config example')
    else:
        print('validation FAILED (%d findings)' % len(findings))
        raise SystemExit(1)


if __name__ == '__main__':
    main()
