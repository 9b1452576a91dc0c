"""MIT-Adobe FiveK fold definitions (a copy of
``exposure_tpu/data/folds.py``).

The fold id lists are dataset files under ``data/folds/*.txt``, one image
id (1-5000) a line; blank lines and lines starting with ``#`` are
skipped."""

import os

FOLD_FILES = {
    'u_test': 'data/folds/FiveK_test.txt',
    'u_amt': 'data/folds/FiveK_test_AMT.txt',
    '2k_train': 'data/folds/FiveK_train_first2k.txt',
    '2k_target': 'data/folds/FiveK_train_second2k.txt',
}


def read_set(name, data_root='.'):
    """Return the list of FiveK image ids in the named fold."""
    if name == '5k':
        return list(range(1, 5001))
    if name not in FOLD_FILES:
        raise ValueError('%s not found (known folds: %s)' %
                         (name, sorted(FOLD_FILES) + ['5k']))
    fn = os.path.join(data_root, FOLD_FILES[name])
    if not os.path.exists(fn):
        raise FileNotFoundError(
            'fold file %s missing: the FiveK fold id lists go under '
            'data/folds/ with the dataset' % fn)
    ids = []
    with open(fn) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            try:
                ids.append(int(line))
            except ValueError:
                pass
    return ids
