"""The port's ``probe_critic_family`` and ``select_policy`` end to end
against the JAX tools, on the CPU at the ``test`` widths, dropout off on
both sides (a patched ``load_config``), ``random`` seeded alike before the
providers draw, on ``test`` runs whose checkpoints the JAX package wrote
(seeds 0-2, and a pool of two equal checkpoints, which abstains) with
planted ``metrics.jsonl``, n 8: the score matrix within 1e-4 (one unit of
its 4-decimal rounding), the rankings, verdict, ``ct_usage``,
``final_emd``, the ``--truth`` Spearman and the ``--promote`` links equal;
a non-symlink is never replaced; the promoted run restores through its
link.  The other probes end to end are ``test_torch_research_training.py``.
"""

import json
import os
import random
import sys

import pytest

import torch_train_helpers as H
from torch_train_helpers import dropout_off, few_threads  # noqa: F401
from exposure_tpu.tools import probe_critic_family as j_pcf
from exposure_tpu.tools import select_policy as j_sp
from exposure_tpu_torch.tools import probe_critic_family as t_pcf
from exposure_tpu_torch.tools import select_policy as t_sp

pytestmark = pytest.mark.usefixtures('few_threads')

ROUNDED = 1e-4 + 1e-9       # one unit of the reports' 4-decimal rounding
EMD = {'s0': 21.5, 's1': 20.25, 's2': 23.0, 'same': 21.5}


@pytest.fixture(scope='module')
def model_root(tmp_path_factory):
    """``test`` runs the JAX package checkpointed from seeds 0, 1 and 2
    (``same`` holds seed 0's checkpoint again), each with a planted
    ``metrics.jsonl``."""
    from exposure_tpu.core.checkpoint import save_checkpoint
    root = str(tmp_path_factory.mktemp('models'))
    jcfg = H.j_load_config('test')
    jm = H.j_build_models(jcfg)
    for run, seed in (('s0', 0), ('s1', 1), ('s2', 2), ('same', 0)):
        state, _ = H.j_init_train_state(jcfg, *jm[1:], seed)
        run_dir = os.path.join(root, 'test', run)
        save_checkpoint(run_dir, state, 5)
        with open(os.path.join(run_dir, 'metrics.jsonl'), 'w') as f:
            for step, emd in ((0, 30.0), (10, EMD[run])):
                f.write(json.dumps({'step': step, 'emd': emd,
                                    'g_loss': -0.5 - step / 100}) + '\n')
    return root


def _jax_main(module, monkeypatch, argv):
    """A JAX tool's ``main`` with ``argv``, ``random`` seeded with 0 as the
    port's tools seed it."""
    monkeypatch.setattr(sys, 'argv', [module.__name__] + argv)
    random.seed(0)
    return module.main()


def _close_matrix(got, want):
    assert sorted(got) == sorted(want)
    for critic in want:
        assert sorted(got[critic]) == sorted(want[critic])
        for name in want[critic]:
            for stat in ('mean', 'std'):
                assert abs(got[critic][name][stat] -
                           want[critic][name][stat]) <= ROUNDED, \
                    (critic, name, stat)


def _close_profiles(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        for key, v in want[name].items():
            if isinstance(v, dict):
                for stat, x in v.items():
                    y = got[name][key][stat]
                    assert (x is None) == (y is None), (name, key)
                    if x is not None:
                        assert abs(x - y) <= ROUNDED, (name, key, stat)
            else:
                assert abs(v - got[name][key]) <= ROUNDED, (name, key)


def test_probe_critic_family_equals_jax(model_root, tmp_path, monkeypatch,
                                        dropout_off):
    runs = ['test/s0', 'test/s1', 'test/s2']
    mine, theirs = tmp_path / 'port.json', tmp_path / 'jax.json'
    t_pcf.main(['--runs', *runs, '--n', '8', '--model-root', model_root,
                '--device', 'cpu', '--out', str(mine)])
    _jax_main(j_pcf, monkeypatch, ['--runs', *runs, '--n', '8',
                                   '--model-root', model_root,
                                   '--out', str(theirs)])
    got, want = json.loads(mine.read_text()), json.loads(theirs.read_text())
    assert sorted(got) == sorted(want)
    _close_matrix(got['critic_score_matrix'], want['critic_score_matrix'])
    for key in ('runs', 'n_eval', 'filter_usage', 'consensus_ranking',
                'consensus_mean_rank', 'reading'):
        assert got[key] == want[key], key
    # the same inputs and targets; the outputs' profiles within rounding
    for name in ('targets', 'inputs'):
        assert got['patch_profiles'][name] == want['patch_profiles'][name]
    _close_profiles(got['patch_profiles'], want['patch_profiles'])


@pytest.mark.parametrize('pool', [('s0', 's1', 's2'), ('s0', 'same')])
def test_select_policy_equals_jax(pool, model_root, tmp_path, monkeypatch,
                                  dropout_off):
    truth = tmp_path / 'parity.json'
    truth.write_text(json.dumps({'runs': [
        {'run': 'test/%s' % r, 'quality': {'avg_after': q}}
        for r, q in zip(pool, (0.41, 0.63, 0.52))]}))
    flags = ['--config', 'test', '--runs', *pool, '--n', '8',
             '--model-root', model_root, '--truth', str(truth),
             '--promote', 'best']
    link = os.path.join(model_root, 'test', 'best')
    theirs = tmp_path / 'jax.json'
    _jax_main(j_sp, monkeypatch, flags + ['--out', str(theirs)])
    want = json.loads(theirs.read_text())
    jax_link = os.readlink(link)
    # the JAX tool's winners by each rule, which its --promote-by follows
    by_rule = {'consensus': jax_link, 'truth': want['truth_winner'],
               'comp2': want['comp2']['ranking'][0]}
    for by in ('consensus', 'truth', 'comp2'):
        mine = tmp_path / ('port-%s.json' % by)
        t_sp.main(flags + ['--promote-by', by, '--device', 'cpu',
                           '--out', str(mine)])
        assert os.readlink(link) == by_rule[by], by
        got = json.loads(mine.read_text())
        assert sorted(got) == sorted(want)
        _close_matrix(got['critic_score_matrix'], want['critic_score_matrix'])
        assert abs(got['family_separation'] -
                   want['family_separation']) <= ROUNDED
        for key in ('runs', 'consensus_ranking', 'consensus_mean_rank',
                    'verdict', 'winner', 'comp2', 'abstain_threshold',
                    'truth_quality', 'spearman_vs_truth', 'truth_winner',
                    'promoted'):
            assert got[key] == want[key], (by, key)
        assert got['winner_by'] == ('comp2' if by == 'comp2' else
                                    want['winner_by'])
        assert got['comp2']['final_emd'] == {r: EMD[r] for r in pool}
    os.unlink(link)
    assert jax_link == (want['winner'] if want['verdict'] == 'rank' else
                        want['comp2']['ranking'][0])
    if pool == ('s0', 'same'):      # equal outputs: no family split
        assert want['verdict'] == 'abstain' and want['winner_by'] == 'comp2'
    assert by_rule['truth'] == pool[1]      # 0.63

    # a file or directory that is not a symlink is never replaced
    os.makedirs(link)
    with pytest.raises(SystemExit, match='non-symlink'):
        t_sp.main(flags + ['--device', 'cpu'])
    assert os.path.isdir(link) and not os.path.islink(link)
    os.rmdir(link)


def test_the_promoted_run_restores_through_the_link(model_root, tmp_path,
                                                    dropout_off):
    from exposure_tpu_torch.core.evaluator import Evaluator
    rep = t_sp.main(['--config', 'test', '--runs', 's1', 's2', '--n', '8',
                     '--model-root', model_root, '--promote', 'best',
                     '--promote-by', 'comp2', '--device', 'cpu'])
    assert rep['winner_by'] == 'comp2'
    cfg = H.t_load_config('test')
    cfg.name = 'test/best'
    ev = Evaluator(cfg, model_root=model_root, device='cpu')
    cfg.name = 'test/' + rep['comp2']['ranking'][0]
    src = Evaluator(cfg, model_root=model_root, device='cpu')
    for k, v in src.state.tensors().items():
        assert (ev.state.tensors()[k] == v).all(), k
    os.unlink(os.path.join(model_root, 'test', 'best'))
