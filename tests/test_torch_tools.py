"""The port's kernel tools on the CPU: ``verify_kernel``'s cases through
the kernels' plain versions (as tests/test_tools.py::TestVerifyKernel runs
the JAX tool in interpret mode), its numpy draws against the JAX tool's,
the per-filter table and the probe reports at a tiny size with ``--cpu``,
the rule that a tool without a CUDA device and without ``--cpu``
exits non-zero, the back-to-back timing, the SASS opcode reader on a canned
listing and the refusal of the packed-operation check off the card."""

import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from exposure_tpu.tools import verify_kernel as j_verify
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.tools import bench_bf16_probe as t_bf16
from exposure_tpu_torch.tools import bench_fastmath as t_fastmath
from exposure_tpu_torch.tools import bench_filters as t_filters
from exposure_tpu_torch.tools import bench_kernel_probe as t_probe
from exposure_tpu_torch.tools import median_seconds
from exposure_tpu_torch.tools import verify_kernel as t_verify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_random_trajectory_draws_as_jax():
    cfg = j_load_config('example')
    j_ids, j_params = j_verify.random_trajectory(
        np.random.RandomState(3), [f(cfg) for f in cfg.filters], 5, 4)
    ids, params = t_verify.random_trajectory(
        np.random.RandomState(3), t_verify.banks()['plain'], 5, 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(params.numpy(), np.asarray(j_params),
                               rtol=1e-6, atol=1e-6)


# name, bank, shape, steps, dtype, masked, active, grouped, fast, dynamic:
# one of each kind of the 24 cases, at a small size
CASES = [
    ('f32', 'plain', (2, 32, 64), 3, 'f32', False, False, False, False,
     False),
    ('u8_active', 'plain', (2, 32, 48), 3, 'u8', False, True, False, False,
     False),
    ('masked', 'masked', (1, 32, 64), 2, 'f32', True, False, False, False,
     False),
    ('vignette', 'vignette', (1, 32, 48), 2, 'f32', True, False, False,
     False, False),
    ('fast_u8', 'plain', (2, 32, 64), 3, 'u8', False, False, False, True,
     False),
    ('grouped_u8', 'plain', (3, 32, 64), 3, 'u8', False, False, True, False,
     False),
    ('fast_grouped_masked_u8', 'masked', (2, 32, 64), 2, 'u8', True, False,
     True, True, False),
    ('dyn_f32_active', 'plain', (2, 32, 48), 3, 'f32', False, True, False,
     False, True),
    ('fast_dyn_masked_u8', 'masked', (2, 32, 64), 2, 'u8', True, False,
     False, True, True),
]


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_run_case_on_the_plain_versions(case):
    name, bank, shape, steps, dtype, masked, active, grouped, fast, dyn = \
        case
    r = t_verify.run_case(name, np.random.RandomState(0),
                          t_verify.banks()[bank], shape, steps, dtype=dtype,
                          masked=masked, active=active, grouped=grouped,
                          fast_math=fast, dynamic=dyn, device='cpu')
    assert r['ok'], r
    assert r['tol'] == (2 if dtype == 'u8' else 1e-4)


def _jax_banks():
    cfg = j_load_config('example')
    mcfg = cfg.copy()
    mcfg.masking = True
    return {'plain': [f(cfg) for f in cfg.filters],
            'masked': [f(mcfg) for f in mcfg.filters]}


# name, bank, shape, steps, masked, active, fast, dynamic: u8 cases
JAX_CASES = [
    ('u8_active', 'plain', (2, 32, 48), 3, False, True, False, False),
    ('fast_u8', 'plain', (2, 32, 64), 3, False, False, True, False),
    ('fast_dyn_masked_u8', 'masked', (2, 32, 64), 2, True, False, True,
     True),
]


@pytest.mark.parametrize('case', JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_replay_against_the_jax_tools_chain(case):
    """The port's replay route on a case's draws (its K2 or K1 plain
    version) against the JAX tool's reference, its branchless chain, on the
    same RandomState draws, judged by the tool's rule."""
    import jax.numpy as jnp
    from exposure_tpu.ops.chain import apply_filter_chain as j_chain
    name, bank, shape, steps, masked, active, fast, dyn = case
    filters = t_verify.banks()[bank]
    imgf, ids, params, mask_params, active_steps = t_verify.draw_case(
        np.random.RandomState(0), filters, shape, steps, masked, active)
    img8 = (imgf * 255).round().astype(np.uint8)
    got = t_verify._replay(filters, False, dyn, fast, ids, params,
                           active_steps, mask_params)(
        torch.from_numpy(img8)).numpy()

    def jax_arg(t):
        return None if t is None else jnp.asarray(t.numpy())

    want = np.asarray(j_chain(
        jnp.asarray(img8.astype(np.float32) / 255.0), jax_arg(ids),
        jax_arg(params), _jax_banks()[bank],
        active_steps=jax_arg(active_steps), mask_params=jax_arg(mask_params)))
    want_q = np.round(np.clip(want, 0, 1) * 255.0)
    diffs = np.abs(got.astype(np.int64) - want_q.astype(np.int64))
    assert t_verify.judge(diffs, t_verify.U8_TOL, 64, ids, filters, fast), \
        (name, diffs.max(), (diffs > t_verify.U8_TOL).mean())


def test_cases_are_the_jax_tools_24():
    """The same 24 cases, in the JAX tool's order, read from its source."""
    with open(j_verify.__file__) as f:
        src = f.read()
    banks = {'filters': 'plain', 'mfilters': 'masked', 'vfilters': 'vignette'}
    want = [(name, banks[bank], tuple(int(d) for d in shape.split(', ')),
             int(steps), dtype)
            for name, bank, shape, steps, dtype in re.findall(
                r"\('(\w+)', (\w+), \(([\d, ]+)\), (\d), '(\w+)'", src)]
    assert len(want) == 24
    assert [c[:5] for c in t_verify.cases()] == want
    report = {'ok': True, 'device': 'cpu', 'cases': [
        {'dtype': 'u8', 'fast_math': True, 'max_abs_diff': 1.0,
         'outlier_frac': 0.0}]}
    assert set(t_verify.summary(report)) == {
        'kernel_check_ok', 'device', 'worst_f32', 'worst_u8_lsb',
        'worst_fast_u8_lsb', 'worst_fast_outlier_frac'}


def test_per_filter_table_on_the_cpu():
    out = t_filters.per_filter(batch=2, res=32, steps=2, fast=True,
                               device='cpu', say=lambda s: None)
    assert out['kernel'] == 'static_switchless_fast'
    assert out['timing'] == 'host_clock_median_cpu'
    assert list(out['per_filter']) == ['E', 'G', 'W', 'S+', 'T', 'Ct', 'BW',
                                       'C']
    assert all(v > 0 for v in out['per_filter'].values())


def test_probe_reports_carry_the_jax_keys():
    a = t_probe.report(batch=2, res=32, iters=1, device='cpu')
    assert {'pallas_copy_0step_ms', 'pallas_E_1step_ms', 'pallas_E_5step_ms',
            'pallas_G_5step_ms', 'switch_E_1step_ms', 'switch_E_5step_ms',
            'jnp_chain_5step_f32_ms', 'switch_E_5step_f32_ms'} <= set(a)
    b = t_fastmath.report(batch=1, res=16, device='cpu', say=lambda s: None)
    assert {op + '_ms' for op in t_fastmath.OPS} | {
        'pow_err', 'cos_err', 'div_err', 'curve_err'} <= set(b)
    assert b['pow_err'] < 5e-5 and b['cos_err'] < 2e-6
    assert b['div_err'] < 1e-2 and b['curve_err'] < 2e-6
    c = t_bf16.probe('curve', 'bf16_splat', 2, 16, 2, device='cpu')
    assert set(c) == {'op', 'style', 'ok', 'ms'} and c['ok']


def _tool(*args):
    return subprocess.run([sys.executable, '-m', *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_tools_exit_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without a CUDA device')
    for tool in ('bench_kernel_probe', 'bench_fastmath', 'bench_bf16_probe',
                 'bench_filters', 'verify_kernel'):
        proc = _tool('exposure_tpu_torch.tools.' + tool)
        assert proc.returncode != 0, tool
        assert 'no CUDA device' in proc.stderr, (tool, proc.stderr[-500:])


def test_bench_filters_cli_with_cpu():
    proc = _tool('exposure_tpu_torch.tools.bench_filters', '--cpu',
                 '--batch', '2', '--res', '32', '--steps', '2', '--f32')
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out['dtype'] == 'f32' and out['device'] == 'cpu'
    assert out['sum_all_branches_ms'] > 0


@pytest.mark.parametrize('calls', [1, 4])
def test_median_seconds_times_calls_back_to_back(calls):
    """``runs`` timings of ``calls`` calls each after ``warmup`` calls, the
    time divided by the calls."""
    seen = []
    per_call = median_seconds(lambda: seen.append(1), 'cpu', runs=3,
                              warmup=2, calls=calls)
    assert len(seen) == 2 + 3 * calls   # the CPU takes no lead-in call
    assert 0.0 <= per_call < 1.0


@pytest.mark.parametrize('iters', [1, 20])
def test_serialized_time_runs_calls_back_to_back(iters):
    """The probe tool's timing: 2 warm-up calls, then 3 timings of
    ``iters // 3`` calls each (at least one)."""
    seen = []
    x = torch.zeros(1)
    dt = t_probe.serialized_time(lambda t, k: seen.append(k), x, iters, 7)
    assert seen == [7] * (2 + 3 * max(1, iters // 3))
    assert 0.0 <= dt < 1.0


def test_packed_op_check_needs_the_card():
    with pytest.raises(ValueError):
        t_bf16.check_packed_ops('cpu')
    assert len(t_bf16.PACKED_OPS) == 12


def test_sass_opcodes_counts_one_kernel(monkeypatch):
    """The opcode table reads the instruction lines of the named kernel
    alone, predicated ones too, and skips the encoding-only lines."""
    text = '\n'.join([
        '\t\tFunction : _ZN3foo12probe_kernelINS_4MonoILi1EEEEEvPKhPhxiT_',
        '        /*0000*/                   I2F.U8 R0, R2 ;   /* 0x01 */',
        '\t\tFunction : _ZN3foo12probe_kernelINS_4MonoILi0EEEEEvPKhPhxiT_',
        '        /*0000*/                   LDG.E.128 R4, [R2.64] ;  /* 0x02 */',
        '                                                   /* 0x000fe2 */',
        '        /*0010*/              @!P0 PRMT R0, R4, 0x7440, R5 ;  /* 0x03 */',
        '        /*0020*/                   PRMT R1, R4, 0x7441, R5 ;  /* 0x04 */',
        '        /*0030*/               @P1 EXIT ;   /* 0x05 */',
        '\t\tFunction : other',
        '        /*0000*/                   F2I.NTZ R0, R2 ;  /* 0x06 */'])
    monkeypatch.setattr(t_probe.kernels, '_nvcc', lambda: '/cuda/bin/nvcc')
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=text, stderr='')
    monkeypatch.setattr(t_probe.subprocess, 'run', run)
    assert t_probe.sass_opcodes('lib.so') == {
        'LDG.E.128': 1, 'PRMT': 2, 'EXIT': 1}
    assert calls == [['/cuda/bin/cuobjdump', '-sass', 'lib.so']]


def _load_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_times_with_median_seconds(monkeypatch):
    """``chip_smoke.py::cuda_ms`` is ``tools.median_seconds`` in
    milliseconds, with its arguments passed on, not a copy of it."""
    import exposure_tpu_torch.tools as tools
    smoke = _load_smoke()
    seen = []

    def fake(fn, device, runs, warmup, calls):
        seen.append((fn, device, runs, warmup, calls))
        return 0.002

    monkeypatch.setattr(tools, 'median_seconds', fake)
    fn = lambda: None
    assert smoke.cuda_ms(fn, runs=5, warmup=1, calls=4) == 2.0
    assert smoke.cuda_ms(fn) == 2.0
    assert seen == [(fn, smoke.DEVICE, 5, 1, 4), (fn, smoke.DEVICE, 7, 2, 1)]


def test_turns_judge_any_differing_kernel_value():
    """``chip_smoke.py --turns`` counts, by kernel output, the values that
    differ from the parent's (NaNs at the same places aside) and lets none
    pass that is not listed as a deliberate change."""
    smoke = _load_smoke()
    nan = np.float32('nan')
    parent = {'k1_E_exact_u8': np.arange(6, dtype=np.uint8),
              'k2f32_case_masked': np.array([0.5, nan, 1.0], np.float32),
              'k4c_small_cos_bf16_cast': np.zeros(4, np.uint8)}
    change = {'k1_E_exact_u8': np.arange(6, dtype=np.uint8),
              'k2f32_case_masked': np.array([0.5, nan, nan], np.float32),
              'k4c_small_cos_bf16_cast': np.array([0, 1, 0, 1], np.uint8)}
    differing = smoke._values_differing(parent, change)
    assert differing == {'k1_E_exact_u8': 0, 'k2f32_case_masked': 1,
                         'k4c_small_cos_bf16_cast': 2}
    # no output may differ: not the served ones, not a mode's, not the
    # fixed plan's replay and no kernel output
    assert smoke.TURNS_MAY_DIFFER == ()
    assert smoke._moved_outputs(differing) == {
        'k2f32_case_masked': 1, 'k4c_small_cos_bf16_cast': 2}
    assert smoke._moved_outputs({'main': 3, 'mode_switch': 1, 'replay': 1,
                                 'k1_E_exact_u8': 1, 'k1_G_fast_f32': 0}) == {
        'main': 3, 'mode_switch': 1, 'replay': 1, 'k1_E_exact_u8': 1}
    assert smoke._moved_outputs({'main': 3, 'replay': 1},
                                ('main',)) == {'replay': 1}
    assert smoke._moved_outputs(differing, ('k4c_',)) == {
        'k2f32_case_masked': 1}
    assert smoke._moved_outputs(smoke._values_differing(parent, parent)) == {}


@pytest.fixture
def counts(monkeypatch):
    """Fresh launch counts and graph records, and ``launch(key, n)``,
    which counts ``n`` launches under ``key`` as ``kernels.launch`` does
    on the card (through a fake library)."""
    import collections
    import contextlib
    import exposure_tpu_torch.core.serving_graph as sg
    from exposure_tpu_torch import kernels
    monkeypatch.setattr(kernels, '_LAUNCHES', collections.Counter())
    monkeypatch.setattr(sg, 'RECORDED', collections.Counter())
    monkeypatch.setattr(sg, 'REPLAYED', collections.Counter())
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernels, 'kernel_stream', lambda device: None)
    fake = types.SimpleNamespace(name='fake')
    fake.lib = types.SimpleNamespace(fake_launch=lambda *args: 0)

    def launch(key, n=1):
        for _ in range(n):
            kernels.launch(fake, 'fake', 'cuda', count=(key,))
    return launch


def test_smoke_counts_proxy_resize_executions(counts):
    """The proxy resize kernel's launches are counted with the others'
    (``kernels.launch``, key ``proxy_resize``): ``chip_smoke.py`` sets them
    to 0 with the others and reads its executions through the graphs'
    records like the chain kernels'."""
    import exposure_tpu_torch.core.serving_graph as sg
    from exposure_tpu_torch import kernels
    smoke = _load_smoke()
    counts('proxy_resize', 3)
    sg.RECORDED.update({'proxy_resize': 1})
    smoke.reset_counts()
    assert not kernels.launch_counts() and not sg.RECORDED
    counts('proxy_resize', 1 + 1)           # a warm-up, a capture
    sg.RECORDED.update({'proxy_resize': 1})
    sg.REPLAYED.update({'proxy_resize': 4})
    assert smoke.read_counts()['proxy_resize'] == 1 + 4


def test_smoke_counts_extractor_forwards_by_layout():
    """The smoke's scan of a profiled replay's kernel names finds cuDNN's
    layout conversions (``nhwcToNchw``, ``nchwToNhwc``, as any kernel that
    carries them in its name) and nothing else."""
    smoke = _load_smoke()
    names = [
        'void dyn_chain_kernel<unsigned char, true, false, 5>(Params)',
        'sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nchwkcrs_nchw',
        'void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, '
        'float, false, true, (cudnnKernelDataType_t)2>(...)',
        'void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, '
        '__nv_bfloat16, float, true, false, (cudnnKernelDataType_t)0>(...)',
        'void at::native::elementwise_kernel<128, 2>(int, ...)']
    assert smoke.layout_conversions(names) == sorted(names[2:4])
    assert smoke.layout_conversions(names[:2] + names[4:]) == []
    assert smoke.layout_conversions(names[2:3] * 3) == names[2:3]


def test_smoke_counts_kernel_executions_under_graphs(counts, monkeypatch):
    """``chip_smoke.py::read_counts`` turns the kernels' launches into
    executions (a capture's recorded launches ran nothing, each replay ran
    them all), and ``_k1_by_stage`` splits K1's executions into the plan's
    and the replay's: eager calls as they ran, recorded ones times the
    pipeline's replays since the last read."""
    import exposure_tpu_torch.core.serving_graph as sg
    smoke = _load_smoke()
    counts('dyn_chain', 6 + 6)              # a warm-up, a capture
    sg.RECORDED.update({'dyn_chain': 6})
    sg.REPLAYED.update({'dyn_chain': 6 * 3})
    assert smoke.read_counts()['dyn_chain'] == 6 + 18
    smoke.reset_counts()
    assert smoke.read_counts()['dyn_chain'] == 0 and not sg.RECORDED

    class Pipe:
        replays = 0

        def plan(self):
            counts('dyn_chain', 5)

        def replay(self):
            counts('dyn_chain')

        def graph_report(self):
            return {'replays': self.replays}

    pipe = Pipe()
    read = smoke._k1_by_stage(pipe)
    capturing = [True]
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: capturing[0])
    pipe.plan()
    pipe.replay()           # recorded by a capture
    capturing[0] = False
    pipe.plan()
    pipe.replay()           # run eagerly (the warm-up)
    pipe.replays = 3
    assert read() == {'proxy': 5 + 5 * 3, 'replay': 1 + 3}
    pipe.replays = 4
    assert read() == {'proxy': 5, 'replay': 1}
