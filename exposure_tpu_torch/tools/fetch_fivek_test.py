"""Extract the user-test fold's RAW TIFFs into ``test_set/``
(parity with reference fetch_fivek_test.py:13-17; a copy of
``exposure_tpu/tools/fetch_fivek_test.py`` on the port's ``data/folds.py``
and ``data/fivek.py``).

Usage: python -m exposure_tpu_torch.tools.fetch_fivek_test [--data-root DIR]
"""

import argparse
import os
import shutil

from exposure_tpu_torch.data.folds import read_set
from exposure_tpu_torch.data.fivek import SOURCE_DIR


def fetch(data_root='.', dest='test_set'):
    os.makedirs(dest, exist_ok=True)
    src = os.path.join(data_root, SOURCE_DIR)
    files = sorted(os.listdir(src))
    ids = set(read_set('u_test', data_root))
    copied = 0
    for f in files:
        try:
            if int(f.split('-')[0].lstrip('a')) in ids:
                shutil.copy(os.path.join(src, f), dest)
                copied += 1
        except ValueError:
            continue
    print('copied %d test images to %s' % (copied, dest))


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--data-root', default='.')
    parser.add_argument('--dest', default='test_set')
    args = parser.parse_args()
    fetch(args.data_root, args.dest)
