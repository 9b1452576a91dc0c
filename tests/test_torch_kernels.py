"""The kernel build's source digest, on the CPU (no nvcc needed): a
library is named by a hash of its source and of every header it includes
from ``csrc/``, so editing a shared header rebuilds every kernel that
includes it, directly or through another header."""

import os
import shutil

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
    region stamp of ``utils/trace.py`` too, which no chain kernel
    includes)."""
    built = []
    monkeypatch.setattr(kernels, 'build',
                        lambda name, bind: built.append(name) or name)
    libs = kernels.build_all()
    sources = sorted(f[:-3] for f in os.listdir(CSRC_DIR)
                     if f.endswith('.cu'))
    assert sorted(built) == sources == sorted(KERNELS + ('trace_stamp',))
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
