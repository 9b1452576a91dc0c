"""Fetch the MIT-Adobe FiveK training artifacts (~2.4 GB; a copy of
``exposure_tpu/tools/fetch_fivek.py``, standard library only).

Parity with reference fetch_fivek.py:7-68: downloads the prebuilt
80x80 RAW pack (image_raw.npy), its metadata (meta_raw.pkl), the expert-C
retouched JPEG set (FiveK_C.zip), and the fold id lists, then unpacks
them into the reference-compatible ``data/`` layout.

Usage: python -m exposure_tpu_torch.tools.fetch_fivek [--data-root DIR]
"""

import argparse
import os
import sys
import urllib.request
import zipfile

RELEASE_BASE = ('https://github.com/yuanming-hu/exposure/releases/'
                'download/v0.9/')
ARTIFACTS = {
    'FiveK_C.zip': 'data/artists/',
    'image_raw.npy': 'data/fivek_dataset/sup_batched80aug_daylight/',
    'meta_raw.pkl': 'data/fivek_dataset/sup_batched80aug_daylight/',
}
FOLD_BASE = ('https://raw.githubusercontent.com/yuanming-hu/exposure/'
             'master/data/folds/')
FOLDS = ['FiveK_test.txt', 'FiveK_test_AMT.txt', 'FiveK_train_first2k.txt',
         'FiveK_train_second2k.txt']


def download(url, dest):
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    if os.path.exists(dest):
        print('exists, skipping:', dest)
        return

    def hook(count, block, total):
        if total > 0 and count % 64 == 0:
            pct = min(count * block * 100.0 / total, 100)
            sys.stdout.write('\r%s: %.1f%%' % (os.path.basename(dest), pct))
            sys.stdout.flush()

    print('downloading', url)
    urllib.request.urlretrieve(url, dest, hook)
    print()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--data-root', default='.')
    args = parser.parse_args()
    root = args.data_root

    for fold in FOLDS:
        download(FOLD_BASE + fold, os.path.join(root, 'data/folds', fold))
    for name, dest_dir in ARTIFACTS.items():
        dest = os.path.join(root, dest_dir, name)
        download(RELEASE_BASE + name, dest)
        if name.endswith('.zip'):
            print('unpacking', dest)
            with zipfile.ZipFile(dest) as z:
                z.extractall(os.path.join(root, dest_dir))
    print('done.')


if __name__ == '__main__':
    main()
