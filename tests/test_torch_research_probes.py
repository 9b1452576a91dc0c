"""The port's research probes against the JAX tools, on the CPU: the pure
functions and the Evaluator's train state.

- the pure functions of ``validate_parity`` (``summarize``),
  ``diagnose_diversity`` (``sequences_of``, ``seq_entropy_bits``),
  ``probe_critic_family`` (``consensus_ranking``, ``family_separation``,
  ``patch_profile``), ``validate_selector`` (``rankdata``, also against
  ``scipy.stats.rankdata``, ``spearman``, ``composite_rank_mean``,
  ``eval_pool``) and ``select_policy`` (``comp2_scores``) equal the JAX
  ones on the same seeded inputs, bit for bit;
- ``validate_selector``'s whole report on the repo's ``PARITY_*.json``
  records equals the JAX tool's;
- ``Evaluator`` restores a JAX-written ``test`` checkpoint's whole train
  state (the three parameter trees bit for bit) and scores a batch with its
  critic as the JAX critic does (atol 1e-5); from an artifact it serves
  the artifact's policy beside an untrained critic and says so;
  ``quality_report(state=)`` equals the JAX report;
- without a GPU every tool's default ``--device cuda`` fails naming the
  device, and a run that does not exist fails naming it.

The tools themselves, end to end, are ``test_torch_research_runs.py``.
"""

import glob
import json
import os
import random
import sys

import jax
import numpy as np
import pytest
import scipy.stats
import torch

import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.tools import diagnose_diversity as j_dd
from exposure_tpu.tools import probe_critic_family as j_pcf
from exposure_tpu.tools import select_policy as j_sp
from exposure_tpu.tools import validate_parity as j_vp
from exposure_tpu.tools import validate_selector as j_vs
from exposure_tpu_torch.core.artifacts import (
    flax_critic_to_state_dict,
    flax_to_state_dict,
)
from exposure_tpu_torch.tools import diagnose_diversity as t_dd
from exposure_tpu_torch.tools import probe_critic_family as t_pcf
from exposure_tpu_torch.tools import select_policy as t_sp
from exposure_tpu_torch.tools import validate_parity as t_vp
from exposure_tpu_torch.tools import validate_selector as t_vs

pytestmark = pytest.mark.usefixtures('few_threads')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 2]


# -- pure functions ----------------------------------------------------------

def _records(rng, n):
    """``validate_parity`` run records with seeded random signals (ties
    among the Ct counts and emds included)."""
    out = []
    for i in range(n):
        after = rng.rand(3).round(4)
        out.append({
            'seed': i, 'final_emd': float(rng.choice([20.0, 21.5, 23.0])),
            'final_g_loss': round(float(rng.randn()), 3),
            'quality': {'intersection_before': rng.rand(3).round(4).tolist(),
                        'intersection_after': after.tolist(),
                        'avg_before': round(float(rng.rand()), 4),
                        'avg_after': float(after.mean().round(4))},
            'trajectories': {
                'filter_usage': {'Ct': int(rng.randint(0, 4) * 50),
                                 'C': int(rng.randint(0, 300))},
                'distinct_sequences_frac': round(float(rng.rand()), 4)}})
    return out


@pytest.mark.parametrize('seed', SEEDS)
def test_summarize_equals_jax(seed):
    recs = _records(np.random.RandomState(seed), 2 + seed)
    assert t_vp.summarize(recs) == j_vp.summarize(recs)


@pytest.mark.parametrize('seed', SEEDS)
def test_sequences_and_entropy_equal_jax(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 3, (5, 40)).astype(np.int32)
    applied = rng.randint(0, 6, 40).astype(np.int32)
    seqs = t_dd.sequences_of(ids, applied)
    assert seqs == j_dd.sequences_of(ids, applied)
    assert t_dd.seq_entropy_bits(seqs) == j_dd.seq_entropy_bits(seqs)


def _matrix(rng, n_critics, names, anchor=True, ties=False):
    m = {}
    for c in range(n_critics):
        row = {n: {'mean': round(float(rng.randn()), 1 if ties else 4),
                   'std': 1.0} for n in names}
        if anchor:
            row['inputs'] = {'mean': round(float(rng.randn()), 4) - 3.0,
                             'std': 1.0}
        m['critic:%d' % c] = row
    return m


@pytest.mark.parametrize('seed', SEEDS)
def test_consensus_and_separation_equal_jax(seed):
    rng = np.random.RandomState(seed)
    names = ['out:run%d' % i for i in range(3 + seed)]
    for kw in (dict(), dict(ties=True), dict(anchor=False)):
        m = _matrix(rng, 2 + seed, names, **kw)
        assert t_pcf.consensus_ranking(m, names) == \
            j_pcf.consensus_ranking(m, names)
        assert t_pcf.family_separation(m, names) == \
            j_pcf.family_separation(m, names)
    assert t_pcf.ABSTAIN_THRESHOLD == j_pcf.ABSTAIN_THRESHOLD == 0.10
    np.testing.assert_array_equal(t_pcf.LUM_W, j_pcf.LUM_W)


@pytest.mark.parametrize('seed', SEEDS)
def test_patch_profile_equals_jax(seed):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(3, 18, 22, 3).astype(np.float32) ** (1 + 2 * seed)
    imgs[0, :8, :8] = 0.5           # flat patches
    assert t_pcf.patch_profile(imgs) == j_pcf.patch_profile(imgs)


@pytest.mark.parametrize('seed', SEEDS)
def test_rank_statistics_equal_jax_and_scipy(seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 6, 25).astype(np.float64)      # ties
    y = rng.randn(25)
    for v in (x, y, x[:1], np.array([2.0, 2.0])):
        np.testing.assert_array_equal(t_vs.rankdata(v), j_vs.rankdata(v))
        np.testing.assert_array_equal(t_vs.rankdata(v),
                                      scipy.stats.rankdata(v))
    assert t_vs.spearman(x, y) == j_vs.spearman(x, y)
    assert t_vs.spearman(x, np.ones(25)) == 0.0


@pytest.mark.parametrize('seed', SEEDS)
def test_composites_and_eval_pool_equal_jax(seed):
    recs = _records(np.random.RandomState(seed), 3 + seed)
    assert list(t_vs.SELECTORS) == list(j_vs.SELECTORS)
    assert t_vs.COMPOSITES == j_vs.COMPOSITES
    scores = {k: [t_vs.SELECTORS[k](r) for r in recs] for k in t_vs.SELECTORS}
    for name, (keys, w) in t_vs.COMPOSITES.items():
        got = t_vs.composite_rank_mean(recs, keys, w)
        np.testing.assert_array_equal(
            got, j_vs.composite_rank_mean(recs, keys, w))
        scores[name] = got
    assert t_vs.eval_pool('p', recs, scores) == \
        j_vs.eval_pool('p', recs, scores)


@pytest.mark.parametrize('seed', SEEDS)
def test_comp2_scores_equal_jax(seed):
    rng = np.random.RandomState(seed)
    runs = ['seed%d' % i for i in range(2 + seed)]
    ct = {r: int(rng.randint(0, 3)) * 100 for r in runs}
    emd = {r: float(rng.choice([20.0, 22.0, float('nan')])) for r in runs}
    assert t_sp.comp2_scores(runs, ct, emd) == \
        j_sp.comp2_scores(runs, ct, emd)


@pytest.mark.parametrize('min_n', [1, 3])
def test_validate_selector_report_equals_jax(tmp_path, monkeypatch, min_n):
    pools = sorted(glob.glob(os.path.join(REPO, 'PARITY_*.json')))
    assert len(pools) >= 8
    before = {p: os.path.getmtime(p) for p in pools}
    mine, theirs = tmp_path / 'port.json', tmp_path / 'jax.json'
    got = t_vs.main(['--pools', *pools, '--min-n', str(min_n),
                     '--out', str(mine)])
    monkeypatch.setattr(sys, 'argv', [
        'validate_selector', '--pools', *pools, '--min-n', str(min_n),
        '--out', str(theirs)])
    j_vs.main()
    want = json.loads(theirs.read_text())
    assert json.loads(mine.read_text()) == want == json.loads(
        json.dumps(got))
    assert want['shipped'] == 'comp2' and want['pools']
    assert {p: os.path.getmtime(p) for p in pools} == before
    # without --out it only prints: nothing is written where it runs
    monkeypatch.chdir(tmp_path)
    for p in pools:
        os.symlink(p, os.path.basename(p))
    listing = sorted(os.listdir(tmp_path))
    printed = t_vs.main(['--min-n', str(min_n)])
    assert printed['pools'] == {os.path.basename(p): v
                                for p, v in got['pools'].items()}
    assert printed['aggregate'] == got['aggregate']
    assert sorted(os.listdir(tmp_path)) == listing


# -- the Evaluator's train state ---------------------------------------------

@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A ``test`` run whose checkpoint the JAX package wrote: seed 3, the
    critic and value trees moved off their initial values."""
    from exposure_tpu.core.checkpoint import save_checkpoint
    root = str(tmp_path_factory.mktemp('models'))
    jcfg, tcfg = H.configs('test', dropout_keep_prob=1.0)
    jm = H.j_build_models(jcfg)
    jstate, _ = H.j_init_train_state(jcfg, *jm[1:], 3)
    jstate = jstate.replace(
        crit_params=jax.tree_util.tree_map(lambda x: x * 1.01 + 1e-3,
                                           jstate.crit_params),
        val_params=jax.tree_util.tree_map(lambda x: x - 0.02,
                                          jstate.val_params), step=11)
    save_checkpoint(os.path.join(root, 'test', 'j'), jstate, 11)
    return root, jcfg, tcfg, jm, jstate


def test_evaluator_restores_the_whole_jax_state(jax_run, capsys):
    from exposure_tpu.core.evaluator import Evaluator as JEvaluator
    from exposure_tpu_torch.core.evaluator import Evaluator
    root, jcfg, tcfg, jm, jstate = jax_run
    tcfg.name = jcfg.name = 'test/j'
    ev = Evaluator(tcfg, model_root=root, device='cpu')
    assert 'at step 11 (checkpoint)' in capsys.readouterr().out
    host = H.host_tree(jstate)
    assert ev.state.step == 11
    for got, want in ((ev.state.gen_params, flax_to_state_dict(
            host.gen_params)), (ev.state.crit_params,
                                flax_critic_to_state_dict(host.crit_params)),
            (ev.state.val_params, flax_critic_to_state_dict(
                host.val_params))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for k, v in ev.policy.state_dict().items():
        assert torch.equal(v, ev.state.gen_params[k]), k

    x = np.random.RandomState(4).rand(6, 64, 64, 3).astype(np.float32)
    want = np.asarray(jm[2].apply(jstate.crit_params, x))
    got = ev.critic_logits(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jev = JEvaluator(jcfg, model_root=root)
    np.testing.assert_allclose(
        got, np.asarray(jev.critic.apply(jev.state.crit_params, x)), rtol=0,
        atol=1e-5)

    # state= serves the given state, and policy= keeps its old meaning
    again = Evaluator(tcfg, state=ev.state, device='cpu')
    np.testing.assert_array_equal(again.critic_logits(x), got)
    bare = Evaluator(tcfg, policy=again.policy, device='cpu')
    assert bare.state is None
    with pytest.raises(ValueError, match='no train state'):
        bare.critic_logits(x)


def test_evaluator_from_an_artifact_has_an_untrained_critic(
        tmp_path, monkeypatch, capsys):
    from exposure_tpu_torch.core.artifacts import (
        artifact_path,
        export_serving_artifact,
    )
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    monkeypatch.chdir(tmp_path)
    cfg = H.t_load_config('test')
    cfg.name = 'test/art'
    trained = init_train_state(cfg, *build_models(cfg)[1:], 8)
    export_serving_artifact(cfg.name, trained, 40)
    assert os.path.exists(artifact_path(cfg.name))
    ev = Evaluator(cfg, model_root=str(tmp_path / 'models'), device='cpu')
    out = capsys.readouterr().out
    assert 'at step 40 (artifact)' in out and 'untrained' in out
    fresh = init_train_state(cfg, *build_models(cfg)[1:], cfg.seed)
    for k, v in trained.gen_params.items():
        assert torch.equal(ev.state.gen_params[k], v), k
    for k, v in fresh.crit_params.items():
        assert torch.equal(ev.state.crit_params[k], v), k


def test_quality_report_state_equals_jax(jax_run):
    from exposure_tpu.tools.quality_report import quality_report as j_report
    from exposure_tpu_torch.core.evaluator import Evaluator
    from exposure_tpu_torch.tools.quality_report import quality_report
    root, jcfg, tcfg, jm, jstate = jax_run
    tcfg.name = jcfg.name = 'test/j'
    state = Evaluator(tcfg, model_root=root, device='cpu').state
    random.seed(5)
    got = quality_report(tcfg, n=32, state=state, device='cpu')
    random.seed(5)
    want = j_report(jcfg, n=32, state=jstate)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 + 1e-9,
                                   err_msg=k)


# -- refusals ----------------------------------------------------------------

TOOL_ARGS = {
    'validate_parity': ['--config', 'test', '--seeds', '0', '--iters', '1'],
    'diagnose_diversity': ['--run', 'test/zzz'],
    'probe_critic_family': ['--runs', 'test/zzz'],
    'select_policy': ['--config', 'test', '--runs', 'zzz'],
    'ablate_w_usage': ['--iters', '1'],
}


@pytest.mark.parametrize('tool', sorted(TOOL_ARGS))
def test_no_gpu_fails_naming_it(tool, monkeypatch, tmp_path):
    import importlib
    main = importlib.import_module('exposure_tpu_torch.tools.' + tool).main
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(TOOL_ARGS[tool] + ['--model-root', str(tmp_path)])
    assert 'no CUDA device' in str(e.value)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize('main,argv,run', [
    (t_dd.main, [], 'synthetic/parity-seed0'),
    (t_dd.main, ['--run', 'test/zzz'], 'test/zzz'),
    (t_pcf.main, ['--runs', 'test/zzz'], 'test/zzz'),
    (t_sp.main, ['--config', 'test', '--runs', 'zzz'], 'test/zzz')])
def test_missing_runs_are_named(main, argv, run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(argv + ['--model-root', str(tmp_path), '--device', 'cpu'])
    assert run in str(e.value)
    if run.endswith('parity-seed0'):
        assert 'validate_parity' in str(e.value)
