"""The port's card tools on the CPU, held to their JAX originals:
``bench_truth`` (its trajectories, its dependency-serialized chains through
K2's plain version against the JAX kernel in interpret mode, its report
keys), ``branch_roofline`` (the traced operation counts against
``ops/dyn_chain.py::branch_ops`` and against the JAX jaxprs' primitive
kinds, the refusal of a table not measured on a CUDA card),
``bench_upload`` and ``bench_dispatch`` (their report keys, the pinned
upload's bytes), and the rule that each exits non-zero without a CUDA
device unless asked for the CPU."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.tools import bench_dispatch as j_dispatch
from exposure_tpu.tools import bench_truth as j_truth
from exposure_tpu.tools import bench_upload as j_upload
from exposure_tpu.tools.branch_roofline import count_vector_ops
from exposure_tpu.ops.filters import max_filter_parameters as j_max_p
from exposure_tpu.ops.pallas_chain import planar_branches as j_branches
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.ops.filters import build_filters
from exposure_tpu_torch.tools import bench_dispatch as t_dispatch
from exposure_tpu_torch.tools import bench_truth as t_truth
from exposure_tpu_torch.tools import bench_upload as t_upload
from exposure_tpu_torch.tools import branch_roofline as t_roofline
from exposure_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ['--batch', '2', '--res', '16', '--iters', '2']


def _jax_main(module, argv, monkeypatch):
    """The JAX tool's ``main`` under ``argv``: its last printed JSON."""
    monkeypatch.setattr(sys, 'argv', [module.__name__] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


# --- bench_truth -----------------------------------------------------------

@pytest.mark.parametrize('mix', list(t_truth.MIXES))
def test_make_traj_equals_jax(mix):
    assert t_truth.MIXES[mix] == {
        'cheap_all_E': ['E'], 'trained_EGCtSpT': ['E', 'G', 'Ct', 'S+', 'T'],
        'heavy_all_G': ['G'], 'heavy_all_Sp': ['S+'],
        'heavy_all_C': ['C']}[mix]
    cfg = j_load_config('example')
    j_ids, j_params = j_truth.make_traj([f(cfg) for f in cfg.filters],
                                        t_truth.MIXES[mix], 5, 4)
    ids, params = t_truth.make_traj(build_filters(load_config('example')),
                                    t_truth.MIXES[mix], 5, 4)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(params.numpy(), np.asarray(j_params),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope='module')
def truth_runs():
    """Both tools at ``--batch 2 --res 16 --iters 2``: the JAX one in
    interpret mode, its ``serialized_time`` made to keep each line's last
    output (the same chain, x_{i+1} = fn(x_i), warm-up call included); the
    port's on the CPU (K2's plain version)."""
    chains = []

    def keep(fn, x, iters, *args):
        for _ in range(iters + 1):
            x = fn(x, *args)
        chains.append(np.asarray(jax.block_until_ready(x)))
        return 1e-3

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_truth, 'serialized_time', keep)
        want = _jax_main(j_truth, SMALL + ['--interpret'], mp)
    finally:
        mp.undo()
    outputs = {}
    got = t_truth.report(2, 16, 5, 2, 'cpu', outputs=outputs)
    return want, dict(zip(['null', 'memcpy'] + list(t_truth.MIXES),
                          chains)), got, outputs


def test_truth_report_keys_equal_jax(truth_runs):
    want, _, got, _ = truth_runs
    assert list(got) == ['batch', 'res', 'steps', 'device', 'timing'] + \
        [k for k in want if k not in ('batch', 'res', 'steps', 'device')]
    assert set(got) - {'timing'} == set(want)
    assert got['timing'] == 'host_clock_serialized_to_synchronize'
    assert got['device'] == 'cpu'
    assert all(got[k] > 0 for k in got if k.endswith(('_ms', '_s', 'gbps')))


@pytest.mark.parametrize('line', ['null', 'memcpy'] + list(t_truth.MIXES))
def test_serialized_chain_equals_jax(truth_runs, line):
    """Each line's output after the warm-up call and 2 timed calls, each
    call's input the previous output: u8 within 1 LSB of the JAX chain."""
    _, want, _, got = truth_runs
    got = got[line].numpy()
    assert got.shape == want[line].shape and got.dtype == want[line].dtype
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int32) - want[line].astype(np.int32))
        assert diff.max() <= 1
        assert not np.array_equal(got, t_truth.images(2, 16).numpy())
    else:
        np.testing.assert_allclose(got, want[line], rtol=0, atol=1e-6)
        assert float(got.min()) == 3.0   # three chained calls of x + 1


def test_serialized_time_feeds_each_output_forward():
    seen = []

    def fn(x, step):
        seen.append(int(x))
        return x + step

    dt, last = t_truth.serialized_time(fn, torch.tensor(0), 4, 2)
    assert seen == [0, 2, 4, 6, 8] and int(last) == 10 and dt >= 0


def test_bench_truth_cli_with_cpu():
    proc = _tool('bench_truth', '--cpu', *SMALL)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['device'] == 'cpu' and out['batch'] == 2
    assert out['chain_heavy_all_C_img_s'] > 0


# --- branch_roofline -------------------------------------------------------

# (fast, branch): (traced, branch_ops, why they differ).  Every other branch
# of the example bank agrees.
KNOWN_DIFFERENCES = {
    # the plain version starts each curve's sum at x * 0 (3 multiplies a
    # pixel); the kernel's Curve starts at 0
    (False, 'T'): (126, 123, 'x * 0 in the plain clip-form curve'),
    (False, 'C'): (126, 123, 'x * 0 in the plain clip-form curve'),
    # the plain version multiplies lum by pi before cos; the kernel's
    # cospif takes lum
    (False, 'Ct'): (26, 25, 'pi * lum before cos in the plain version'),
    # the plain polynomial starts at c0 * ones_like(x); the kernel at c0
    (True, 'Ct'): (33, 32, 'c0 * ones in the plain polynomial'),
}


@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
def test_traced_counts_against_branch_ops(fast):
    counts = t_roofline.branch_counts(fast)
    assert list(counts) == ['E', 'G', 'W', 'S+', 'T', 'Ct', 'BW', 'C']
    for name, row in counts.items():
        pinned = KNOWN_DIFFERENCES.get((fast, name))
        if pinned is None:
            assert row['ops_per_step'] == row['hand_ops_per_step'], name
        else:
            assert (row['ops_per_step'], row['hand_ops_per_step']) == \
                pinned[:2], (name, pinned[2])
    report = t_roofline.roofline(fast, None)
    assert set(report['differences']) == {
        name for f, name in KNOWN_DIFFERENCES if f == fast}


# JAX primitive -> the aten operations of the port's branches that run it
JAX_TO_ATEN = {
    'mul': {'mul'}, 'add': {'add'}, 'sub': {'sub', 'rsub'}, 'div': {'div'},
    'max': {'maximum', 'clamp'}, 'min': {'minimum', 'clamp'},
    'abs': {'abs'}, 'gt': {'gt'}, 'le': {'le'}, 'select_n': {'where'},
    'neg': {'neg'}, 'cos': {'cos'}, 'pow': {'pow'}, 'exp2': {'exp2'},
    'log': {'log', 'log2'},
}
# the fast gamma: JAX takes exp2(g * log(x) / ln 2), the port log2(x)
NO_COUNTERPART = {(True, 'G'): {'div'}}


@pytest.mark.parametrize('fast', [False, True], ids=['exact', 'fast'])
def test_primitives_cover_the_jax_kinds(fast):
    cfg = j_load_config('example')
    filters = [f(cfg) for f in cfg.filters]
    max_p = j_max_p(filters)
    counts = t_roofline.branch_counts(fast)
    for f, branch in zip(filters, j_branches(filters, fast_math=fast)):
        p = [np.float32(0.3 + 0.1 * j) for j in range(max_p)]
        gx = gy = jnp.zeros((1, 1), jnp.float32)
        _, prims = count_vector_ops(
            lambda r, g, b, branch=branch, p=p: branch(r, g, b, p, gx, gy))
        name = f.get_short_name()
        names = set(counts[name]['primitives'])
        skip = NO_COUNTERPART.get((fast, name), set())
        for kind in set(prims) - skip:
            assert JAX_TO_ATEN[kind] & names, (name, kind, names)
        # and the port adds no kind of operation JAX does not have
        covered = set().union(*(JAX_TO_ATEN[k] for k in prims))
        assert names <= covered, (name, names - covered)


def _bench(**over):
    bench = {'metric': 'per_filter_images_per_sec', 'shape': [256, 512, 512],
             'steps': 5, 'dtype': 'u8', 'kernel': 'static_switchless_fast',
             'timing': 'cuda_events_median',
             'device': 'NVIDIA H100 80GB HBM3',
             'per_filter': {'E': 1000.0, 'T': 500.0, 'S+': 250.0}}
    bench.update(over)
    return bench


@pytest.mark.parametrize('case', ['tpu_record', 'cpu_report', 'no_table',
                                  'other_set'])
def test_bench_file_not_from_a_cuda_card_is_refused(tmp_path, case,
                                                    capsys):
    if case == 'tpu_record':   # the JAX package's record: no device key
        path = os.path.join(REPO, 'FILTER_BENCH.json')
        with open(path) as f:
            assert 'device' not in json.load(f)
        why = 'names no device'
    else:
        bench = {'cpu_report': _bench(device='cpu',
                                      timing='host_clock_median_cpu'),
                 'no_table': {'device': 'NVIDIA H100 80GB HBM3'},
                 'other_set': _bench(kernel='static_switchless')}[case]
        why = {'cpu_report': 'not measured on a CUDA card',
               'no_table': 'not a bench_filters report',
               'other_set': 'pass --exact'}[case]
        path = str(tmp_path / 'bench.json')
        with open(path, 'w') as f:
            json.dump(bench, f)
    with pytest.raises(SystemExit) as e:
        t_roofline.main(['--bench', path])
    assert 'refused' in str(e.value) and why in str(e.value), e.value
    assert capsys.readouterr().out == ''


def test_roofline_of_a_card_table(tmp_path, capsys):
    path = str(tmp_path / 'bench.json')
    with open(path, 'w') as f:
        json.dump(_bench(), f)
    t_roofline.main(['--bench', path])
    report = json.loads(capsys.readouterr().out)
    assert report['device'] == 'NVIDIA H100 80GB HBM3'
    assert report['timing'] == 'cuda_events_median'
    px = 256 * 512 * 512
    t = report['branches']['T']
    ms = 256 / 500.0 * 1e3
    assert t['measured_ms_5step'] == pytest.approx(ms, rel=1e-6)
    rate = 5 * t['ops_per_step'] * px / (ms * 1e-3)
    assert t['achieved_Tops_per_s'] == pytest.approx(rate / 1e12, abs=1e-4)
    assert t['vs_peak'] == pytest.approx(rate / 67e12, abs=1e-4)
    assert t['vs_calibration'] == 1.0
    assert report['calibration']['branch'] == 'T'
    assert 'measured_ms_5step' not in report['branches']['G']
    assert os.listdir(tmp_path) == ['bench.json']   # no --out: no file


# --- bench_upload and bench_dispatch ----------------------------------------

def test_upload_report_keys_equal_jax(monkeypatch):
    want = _jax_main(j_upload, ['--mb', '1', '--reps', '1'], monkeypatch)
    got = json.loads(json.dumps(t_upload.report((1,), 1, 'cpu',
                                                say=lambda s: None)))
    assert set(got) - {'device', 'timing'} == set(want) == {'1'}
    assert set(got['1']) - {'pinned'} == set(want['1'])
    assert set(got['1']['pinned']) == set(want['1'])
    assert got['device'] == 'cpu'


def test_pinned_upload_bytes_equal_pageable():
    from exposure_tpu_torch.core.streaming import host_buffers
    host = np.random.RandomState(0).rand(4096).astype(np.float32)
    (buf,) = host_buffers(((host.size,),), torch.float32, False)
    buf.numpy()[...] = host
    a = t_upload.pageable_upload(host, 'cpu')
    b = t_upload.pinned_upload(buf, 'cpu', None)
    assert b.data_ptr() != buf.data_ptr()
    assert torch.equal(a, b) and np.array_equal(a.numpy(), host)


def test_dispatch_report_keys_equal_jax(monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['bench_dispatch'])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_dispatch.main()
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    got = t_dispatch.report('cpu')
    assert list(got) == ['device', 'timing'] + [k for k in want
                                                 if k != 'device']
    assert all(len(v) == 2 and v[0] <= v[1] for k, v in got.items()
               if k.endswith('_ms'))


# --- no card ---------------------------------------------------------------

def _tool(name, *args):
    return subprocess.run(
        [sys.executable, '-m', 'exposure_tpu_torch.tools.' + name, *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('tool', ['bench_truth', 'branch_roofline',
                                  'bench_upload', 'bench_dispatch'])
def test_card_tools_exit_nonzero_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without a CUDA device')
    proc = _tool(tool)
    assert proc.returncode != 0, tool
    assert 'no CUDA device' in proc.stderr, (tool, proc.stderr[-500:])
    assert proc.stdout.strip() == '' or '{' not in proc.stdout
