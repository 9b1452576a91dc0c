"""The port's serving and streaming tools against the JAX package, on the
CPU at small sizes (``--device cpu``, the kernels' plain versions):

- ``export_serving``: the port's artifact of a checkpoint the port wrote
  for ``test`` equals the JAX tool's artifact of the same checkpoint, leaf
  by leaf (float32 bit for bit, float16 equal), each package restores the
  other's, and ``--verify`` at float32 finds no id differing; the default
  ``--out`` never writes over a file;
- ``probe_selected_plan``: with dropout off, in float32, the port's bank
  plan's ids equal the JAX ``rollout``'s and its selected plan's the JAX
  ``serve_rollout``'s, id by id, but for at most one near-tie flip of 80
  each, and the report's agreement equals the one the JAX ids give within
  those flips;
- ``warmup_serving``: ``RetouchPipeline.warmup``'s report keys are the JAX
  pipeline's, a ``budget=`` replay runs the probed warm-up's routes, and the
  tool's report keys are the JAX tool's;
- ``bench_dyn_probe``: the planted images and ids equal the JAX script's
  bit for bit, and the params are its raw draws through the port's
  regressors: within 8 float32 ulps of JAX's (torch's ``tanh``, ``exp``
  and ``sigmoid`` are not XLA's to the last bit);
- ``drive_refreeze``: a re-freeze fires after the swap, and after the swap
  under ``bf16=True`` the plan equals a fresh pipeline's on policy B bit
  for bit and the output is within 1 LSB of it;
- ``bench_serving_split`` and ``bench_stream_device``: the ``--device cpu``
  report holds the JAX tool's keys;
- a missing run is an error naming it.
"""

import copy
import json
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu_torch.core.artifacts import (
    load_artifact,
    restore_serving_artifact,
)
from exposure_tpu_torch.core.checkpoint import save_checkpoint
from exposure_tpu_torch.core.serving import RetouchPipeline, batch_generator
from exposure_tpu_torch.core.train_state import init_train_state
from exposure_tpu_torch.models.networks import build_models

pytestmark = pytest.mark.usefixtures('few_threads')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOLS = os.path.join(REPO, 'exposure_tpu', 'tools')
STEPS = {'test/a': 7, 'test/b': 9}
SEEDS = {'test/a': 0, 'test/b': 1}


def _jax_source(name):
    with open(os.path.join(JAX_TOOLS, name + '.py')) as f:
        return f.read()


@pytest.fixture(scope='module')
def model_root(tmp_path_factory):
    """Two ``test`` runs the port checkpointed: initial states from seeds
    0 and 1."""
    root = str(tmp_path_factory.mktemp('models'))
    for run, step in STEPS.items():
        cfg = H.t_load_config('test')
        _, policy, critic, value = build_models(cfg)
        state = init_train_state(cfg, policy, critic, value, SEEDS[run])
        save_checkpoint(os.path.join(root, run), state, step)
    return root


def _leaves(tree, at=''):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_leaves(tree[k], at + '/' + k))
        return out
    return {at: np.asarray(tree)}


@pytest.mark.parametrize('dtype', ['float32', 'float16'])
def test_export_equals_the_jax_tools_artifact(model_root, tmp_path, dtype,
                                              monkeypatch):
    from exposure_tpu.core.artifacts import (
        restore_serving_artifact as j_restore)
    from exposure_tpu.tools import export_serving as j_tool
    from exposure_tpu_torch.tools import export_serving
    mine, theirs = str(tmp_path / 'port.gz'), str(tmp_path / 'jax.gz')
    assert export_serving.main([
        '--run', 'test/a', '--model-root', model_root, '--out', mine,
        '--dtype', dtype, '--device', 'cpu']) == 0
    monkeypatch.setattr(sys, 'argv', [
        'export_serving', '--run', 'test/a', '--model-root', model_root,
        '--out', theirs, '--dtype', dtype])
    assert j_tool.main() == 0
    a, b = load_artifact(mine), load_artifact(theirs)
    assert (a['run'], a['step'], a['dtype']) == \
        (b['run'], b['step'], b['dtype']) == ('test/a', 7, dtype)
    la, lb = _leaves(a['gen_params']), _leaves(b['gen_params'])
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype == np.dtype(dtype), k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)

    # each package restores the other's artifact
    cfg = H.t_load_config('test')
    _, policy, critic, value = build_models(cfg)
    template = init_train_state(cfg, policy, critic, value, 5)
    own, _ = restore_serving_artifact(mine, template)
    other, step = restore_serving_artifact(theirs, template)
    assert step == 7
    for k, v in own.gen_params.items():
        assert torch.equal(v, other.gen_params[k]), k
    jm = H.j_build_models(H.j_load_config('test'))
    jtemplate, _ = H.j_init_train_state(H.j_load_config('test'),
                                        *jm[1:], 5)
    j_own, _ = j_restore(theirs, jtemplate)
    j_other, j_step = j_restore(mine, jtemplate)
    assert j_step == 7
    for x, y in zip(jax.tree_util.tree_leaves(j_own.gen_params),
                    jax.tree_util.tree_leaves(j_other.gen_params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_export_verify_and_refusals(model_root, tmp_path, monkeypatch):
    from exposure_tpu_torch.tools import export_serving
    cfg, filters, nets, state, step = export_serving._load(
        'test/a', model_root, 'cpu')
    for dtype in ('float32', 'float16'):
        path = str(tmp_path / (dtype + '.gz'))
        from exposure_tpu_torch.core.artifacts import export_serving_artifact
        export_serving_artifact('test/a', state, step, path, dtype=dtype)
        report, code = export_serving.verify(cfg, filters, nets, state,
                                             step, path, 'cpu')
        assert code == int(report['mismatch'] > 0.02)
        if dtype == 'float32':
            assert report['worst_abs'] == 0.0 and report['ids_differ'] == 0
    # the default --out is the run's artifact path, and only when free
    monkeypatch.chdir(tmp_path)
    assert export_serving.main(['--run', 'test/a', '--model-root',
                                model_root, '--device', 'cpu']) == 0
    written = tmp_path / 'artifacts' / 'serving' / 'test--a.msgpack.gz'
    before = written.read_bytes()
    with pytest.raises(SystemExit) as e:
        export_serving.main(['--run', 'test/a', '--model-root', model_root,
                             '--device', 'cpu'])
    assert 'exists' in str(e.value) and written.read_bytes() == before


def test_missing_runs_are_named(model_root, monkeypatch, tmp_path):
    from exposure_tpu_torch.tools import (
        bench_serving_split,
        drive_refreeze,
        probe_selected_plan,
        warmup_serving,
    )
    monkeypatch.chdir(tmp_path)
    for main, argv, run in (
            (bench_serving_split.main, [], 'synthetic/final-r2'),
            (warmup_serving.main, ['--run', 'synthetic/final-r4'],
             'synthetic/final-r4'),
            (drive_refreeze.main, ['--run-a', 'test/a'],
             'synthetic_inject15/best'),
            (drive_refreeze.main, ['--run-a', 'test/a', '--run-b',
                                   'test/zzz'], 'test/zzz'),
            (probe_selected_plan.main, ['--run', 'test/zzz'], 'test/zzz')):
        with pytest.raises(SystemExit) as e:
            main(argv + ['--model-root', model_root, '--device', 'cpu'])
        assert run in str(e.value), (run, e.value)


@pytest.fixture(scope='module')
def same_policy():
    """A random ``test`` policy on both sides, dropout keep 1.0."""
    jcfg, tcfg = H.configs('test', dropout_keep_prob=1.0)
    jm, jstate, _, tm, tstate = H.models(jcfg, tcfg)
    tm[1].load_state_dict(tstate.gen_params)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jm=jm,
                                 gen_params=jstate.gen_params,
                                 filters=tm[0], policy=tm[1].eval())


NEAR_TIE_FLIPS = 1      # ids of 80 a plan may pick unlike JAX's


def test_probe_agreement_equals_jax(same_policy):
    from exposure_tpu.core.rollout import rollout as j_rollout
    from exposure_tpu.core.rollout import serve_rollout as j_serve
    from exposure_tpu_torch.tools.probe_selected_plan import plans, probe
    m = same_policy
    proxy = np.random.RandomState(3).rand(16, 64, 64, 3).astype(np.float32)
    rep = probe(m.tcfg, m.filters, m.policy, torch.from_numpy(proxy), [100],
                bf16=False)
    bank, selected = plans(m.tcfg, m.filters, m.policy,
                           torch.from_numpy(proxy), 100)
    key = jax.random.PRNGKey(100)
    jf, jp = m.jm[0], m.jm[1]
    a = np.asarray(j_rollout(jp, m.gen_params, jnp.asarray(proxy), key,
                             cfg=m.jcfg, filters=jf, is_train=0).filter_ids)
    b = np.asarray(j_serve(jp, m.gen_params, jnp.asarray(proxy), key,
                           cfg=m.jcfg, filters=jf, interpret=True,
                           fast_math=True)[0])
    assert rep['ids_total'] == a.size == 80 and rep['bf16'] is False
    assert set(rep) == {'batch', 'batches', 'bf16', 'ids_total',
                        'ids_agree', 'agreement', 'per_step_agreement'}
    # each plan's ids against its JAX counterpart's, id by id: at most
    # NEAR_TIE_FLIPS of the 80 may differ (an argmax at a near-tie)
    assert int((bank != a).sum()) <= NEAR_TIE_FLIPS
    assert int((selected != b).sum()) <= NEAR_TIE_FLIPS
    assert abs(rep['ids_agree'] - int((a == b).sum())) <= 2 * NEAR_TIE_FLIPS
    per_step = (a == b).mean(axis=1)
    assert rep['per_step_agreement'][0] == pytest.approx(per_step[0])


def test_probe_sees_one_dropout_draw_per_batch():
    """Both plans of a batch draw dropout from generators seeded alike:
    the bank and selected plans of the same policy agree on step 0 even
    with dropout on, where one advancing generator would not."""
    from exposure_tpu_torch.tools.probe_selected_plan import probe
    cfg = H.t_load_config('test')
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, 0)
    policy.load_state_dict(state.gen_params)
    proxy = torch.from_numpy(np.random.RandomState(4).rand(
        16, 64, 64, 3).astype(np.float32))
    rep = probe(cfg, filters, policy.eval(), proxy, [100, 101], bf16=False)
    assert rep['per_step_agreement'][0] == 1.0


def test_warmup_report_keys_and_budget_replay(same_policy):
    from exposure_tpu.core.serving import RetouchPipeline as JPipeline
    m = same_policy
    imgs = (np.random.RandomState(5).rand(8, 32, 32, 3) * 255).astype(
        np.uint8)
    jpipe = JPipeline(m.jcfg, types.SimpleNamespace(
        gen_params=m.gen_params), use_pallas=True, interpret=True,
        grouped=True, fused_set_limit=0)
    want = jpipe.warmup(imgs, probe_batches=2, seed=0)

    def pipeline():
        return RetouchPipeline(m.tcfg, copy.deepcopy(m.policy),
                               device='cpu', use_kernels=True, grouped=True,
                               fused_set_limit=0)
    probed = pipeline()
    got = probed.warmup(torch.from_numpy(imgs), probe_batches=2, seed=0)
    assert sorted(got) == sorted(want)
    assert got['programs_compiled'] == len(probed._runner.routes)
    replayed = pipeline()
    rep = replayed.warmup(torch.from_numpy(imgs), budget=got['budget'])
    assert rep['probe_batches'] == 0

    def acc(pipe):
        return {r for r in pipe._runner.routes if r[0] == 'acc'}
    assert acc(replayed) == acc(probed)
    # traffic on a probed stream adds no route the warm-up ran
    n = len(probed._runner.routes)
    probed(torch.from_numpy(imgs), seed=0)
    assert {r for r in probed._runner.routes if r[0] == 'acc'} <= \
        acc(probed) | acc(replayed)
    assert len(probed._runner.routes) >= n


def test_warmup_tool_keys_are_the_jax_tools(model_root, tmp_path, capsys):
    from exposure_tpu_torch.tools import warmup_serving
    src = _jax_source('warmup_serving')
    out = str(tmp_path / 'w.json')
    report = warmup_serving.main([
        '--run', 'test/a', '--model-root', model_root, '--batch', '4',
        '--res', '32', '--probes', '2', '--seeds', '2', '--decompose',
        '--device', 'cpu', '--out', out])
    with open(out) as f:
        assert json.load(f) == report
    assert set(re.findall(r"report\['(\w+)'\] =", src)) - {'mode'} == \
        set(report) - {'run', 'batch', 'res'}
    assert set(re.findall(r"decomp\['(\w+)'\] =", src)) == \
        set(report['first_batch_decomposition'])
    assert report['budget_misses'] == report['programs_after_traffic'] - \
        report['warmup']['programs_compiled']
    dyn = warmup_serving.main([
        '--run', 'test/a', '--model-root', model_root, '--batch', '4',
        '--res', '32', '--seeds', '1', '--dynamic', '--device', 'cpu'])
    # capture_s: the port's own, the cold batch's graph capture (0 here)
    assert set(dyn) == {'run', 'batch', 'res', 'mode', 'cold_first_batch_s',
                        'capture_s', 'warm_next_batches_s'}
    assert dyn['capture_s'] == 0.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        dyn


def test_planted_mix_is_the_jax_scripts():
    """The JAX script's draws (exposure_tpu/tools/bench_dyn_probe.py:11-26)
    at a small size, against the port's ``planted``."""
    from exposure_tpu.ops.filters import max_filter_parameters
    from exposure_tpu_torch.ops.filters import build_filters
    from exposure_tpu_torch.tools.bench_dyn_probe import planted
    b, h, w, k = 40, 4, 6, 5
    cfg = H.j_load_config('example')
    filters = [f(cfg) for f in cfg.filters]
    rng = np.random.RandomState(0)
    img = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    sig_pool = [rng.randint(0, len(filters), k) for _ in range(6)]
    assign = rng.randint(0, 6, b)
    ids = np.stack([sig_pool[a] for a in assign], axis=1).astype(np.int32)
    params = np.zeros((k, b, max_filter_parameters(filters)), np.float32)
    for s in range(k):
        for i in range(b):
            f = filters[ids[s, i]]
            n = f.get_num_filter_parameters()
            raw = rng.randn(1, n).astype(np.float32)
            params[s, i, :n] = np.asarray(
                f.filter_param_regressor(jnp.asarray(raw))).reshape(-1)
    t_img, t_ids, t_params = planted(
        build_filters(H.t_load_config('example')), b, h, w, k)
    np.testing.assert_array_equal(t_img, img)
    np.testing.assert_array_equal(t_ids, ids)
    # the raw draws are the same values; the regressors' tanh, exp and
    # sigmoid are torch's, a few float32 ulps off XLA's on the CPU
    np.testing.assert_allclose(t_params, params, rtol=1e-6, atol=1e-7)
    ulps = np.abs(t_params - params) / np.spacing(np.abs(params))
    assert ulps.max() <= 8, ulps.max()


def test_dyn_probe_on_the_cpu(capsys):
    from exposure_tpu_torch.tools import bench_dyn_probe
    rep = bench_dyn_probe.main(['--batch', '12', '--res', '16',
                                '--device', 'cpu'])
    assert rep['dyn_max_lsb'] <= 1 and rep['dyn_frac_above_1'] == 0.0
    for key in ('dyn_switch_ms', 'dyn_tree_ms'):
        assert rep[key] is None
    assert set(rep['dyn_chunk_ms'].values()) == {None}
    assert rep['grouped_last_route'] in ('accumulate', 'fused')
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        rep


def _policy(cfg, seed):
    _, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, seed)
    policy.load_state_dict(state.gen_params)
    return policy.eval()


def test_refreeze_fires_and_the_swap_serves_b(model_root):
    from exposure_tpu_torch.tools.drive_refreeze import drive, traffic
    cfg = H.t_load_config('test')
    policy_a, policy_b = _policy(cfg, 0), _policy(cfg, 1)
    imgs = traffic(cfg, 8, 32, 'cpu')
    kw = dict(device='cpu', use_kernels=True, bf16=True, auto_superset=True,
              auto_record_batches=2, auto_drift_window=2)
    pipe = RetouchPipeline(cfg, copy.deepcopy(policy_a), **kw)
    trace, seen = drive(pipe, imgs, policy_b, 'test/b', 9, pre=3, post=5,
                        recover=1, log=lambda m: None)
    rep = pipe.superset_report()
    assert rep['refreezes'] >= 1 and seen is not None and seen >= 3
    assert [r['phase'] for r in trace][-1] == 'R'
    assert not any(r['warm_pending'] for r in trace)
    assert (pipe.run, pipe.step) == ('test/b', 9)

    fresh = RetouchPipeline(cfg, copy.deepcopy(policy_b), **kw)
    for seed in (40, 41):
        got = pipe.plan(pipe.proxy(imgs), batch_generator(seed, 0, 'cpu'))
        want = fresh.plan(fresh.proxy(imgs),
                          batch_generator(seed, 0, 'cpu'))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        lsb = (torch.from_numpy(pipe(imgs, seed=seed)).int() -
               torch.from_numpy(fresh(imgs, seed=seed)).int()).abs().max()
        assert int(lsb) <= 1

    # the trap the swap avoids: policy B's weights under A's bf16 copy
    stale = RetouchPipeline(cfg, copy.deepcopy(policy_a), **kw)
    stale.policy.load_state_dict(policy_b.state_dict())
    old = stale.plan(stale.proxy(imgs), batch_generator(40, 0, 'cpu'))
    new = fresh.plan(fresh.proxy(imgs), batch_generator(40, 0, 'cpu'))
    assert not torch.equal(old[1], new[1])


def test_split_tool_keys_are_the_jax_tools(model_root):
    from exposure_tpu_torch.tools import bench_serving_split
    want = set(re.findall(r"results\['(\w+)'\] =",
                          _jax_source('bench_serving_split')))
    got = bench_serving_split.main([
        '--run', 'test/a', '--model-root', model_root, '--batch', '8',
        '--res', '32', '--runs', '1', '--device', 'cpu'])
    # the port's own: the grouped path's way back, and the whole batch as
    # one graph replay beside the per-call path
    assert want == set(got) - {'scatter_u8_ms', 'batch_graph_ms',
                               'batch_eager_ms'}
    assert all(v > 0 for v in got.values())


def test_stream_tool_keys_are_the_jax_tools():
    from exposure_tpu_torch.tools import bench_stream_device
    src = _jax_source('bench_stream_device')
    start = src.index("print(json.dumps({")
    block = src[start:src.index('}))', start)]
    want = set(re.findall(r"'(\w+)':", block))
    got = bench_stream_device.main(['--config', 'test', '--fuse', '2',
                                    '--disp', '1', '--warm', '0',
                                    '--device', 'cpu'])
    assert want <= set(got)
    assert got['metric'] == 'stream_fused_device_ms_per_iter'
    assert got['value'] == pytest.approx(got['ms_per_dispatch'] / 2)
