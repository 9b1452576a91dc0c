"""Checkpoints and serving artifacts between the port and the JAX package,
on the CPU.

- The port's msgpack writer gives flax's bytes for the same train state,
  and a checkpoint written by either package restores in the other into
  its own template, every leaf equal;
- a serving artifact written by either package serves in the other, every
  weight equal;
- the write path: keep-N pruning, the fallback from an unreadable newest
  file, no ``.tmp`` left behind, a missing directory and a tree that does
  not fit the template raise;
- ``restore_for_serving`` and ``RetouchPipeline.from_run`` take the
  checkpoint when there is one, the artifact otherwise, and
  ``restore_train_state`` takes the same source.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import torch_train_helpers as H
from exposure_tpu.core import artifacts as jart
from exposure_tpu.core import checkpoint as jck
from exposure_tpu_torch.core import artifacts as tart
from exposure_tpu_torch.core import checkpoint as tck
from exposure_tpu_torch.core.serving import RetouchPipeline
from exposure_tpu_torch.core.train_state import AdamState, EmaState


@pytest.fixture(scope='module')
def states():
    """A JAX state with every leaf moved off its init, and the port's
    copy of it."""
    jcfg, tcfg = H.configs('test')
    _, jstate, _, tm, tstate = H.models(jcfg, tcfg)
    leaves, treedef = jax.tree_util.tree_flatten(jstate)
    rng = np.random.RandomState(0)
    moved = [np.asarray(x) + np.float32(rng.randn(*np.shape(x)))
             if np.asarray(x).dtype == np.float32 else np.asarray(x) + 3
             for x in leaves]
    jstate = jax.tree_util.tree_unflatten(treedef,
                                          [jnp.asarray(x) for x in moved])
    return jcfg, tcfg, tm, jstate, H.to_torch_state(jstate, tstate)


def _assert_same(t_state, j_state):
    got = tck.state_to_flax(t_state)
    want = serialization.to_state_dict(H.host_tree(j_state))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_writer_gives_flax_bytes(states):
    _, _, _, jstate, tstate = states
    assert tstate.opt_g.count == 3 and tstate.step == 3
    assert tart.msgpack_serialize(tck.state_to_flax(tstate)) == \
        serialization.to_bytes(H.host_tree(jstate))


def test_port_checkpoint_restores_in_jax(states, tmp_path):
    _, _, _, jstate, tstate = states
    tck.save_checkpoint(str(tmp_path), tstate, 7)
    template = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    restored, step = jck.restore_checkpoint(str(tmp_path), template)
    assert step == 7
    _assert_same(tstate, restored)


def test_jax_checkpoint_restores_in_port(states, tmp_path):
    _, _, _, jstate, tstate = states
    jck.save_checkpoint(str(tmp_path), jstate, 9)
    template = tstate.replace(
        gen_params={k: torch.zeros_like(v)
                    for k, v in tstate.gen_params.items()},
        opt_c=AdamState.create(tstate.crit_params),
        ema=EmaState.create(), step=0)
    restored, step = tck.restore_checkpoint(str(tmp_path), template)
    assert step == 9 and tck.latest_checkpoint_step(str(tmp_path)) == 9
    _assert_same(restored, jstate)
    for k, v in restored.tensors().items():
        assert v.dtype == torch.float32 and v.device.type == 'cpu', k


def test_artifacts_cross_both_ways(states, tmp_path):
    jcfg, tcfg, tm, jstate, tstate = states
    path = tart.export_serving_artifact('test/x', tstate, 5,
                                        path=str(tmp_path / 'a.msgpack.gz'))
    template = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    restored, step = jart.restore_serving_artifact(path, template)
    assert step == 5
    want = tart.state_dict_to_flax(tstate.gen_params)
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(want),
            jax.tree_util.tree_leaves_with_path(
                H.host_tree(restored.gen_params))):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    path = jart.export_serving_artifact('test/y', jstate, 6,
                                        path=str(tmp_path / 'b.msgpack.gz'))
    payload = tart.load_artifact(path)
    assert (payload['run'], int(payload['step'])) == ('test/y', 6)
    sd = tart.flax_to_state_dict(payload['gen_params'])
    for k, v in tstate.gen_params.items():
        assert torch.equal(sd[k], v), k


def test_keep_pruning_and_no_tmp(states, tmp_path):
    tstate = states[4]
    d = str(tmp_path)
    (tmp_path / 'model.ckpt-0.msgpack.tmp').write_bytes(b'orphan')
    for s in (1, 2, 3):
        tck.save_checkpoint(d, tstate, s, keep=2)
    assert sorted(os.listdir(d)) == ['model.ckpt-2.msgpack',
                                     'model.ckpt-3.msgpack']
    assert tck.latest_checkpoint_step(d) == 3


def test_unreadable_newest_falls_back(states, tmp_path, capsys):
    tstate = states[4]
    d = str(tmp_path)
    tck.save_checkpoint(d, tstate, 5, keep=3)
    for step, junk in ((10, b''), (11, b'\x81\xa4step')):
        (tmp_path / ('model.ckpt-%d.msgpack' % step)).write_bytes(junk)
    restored, step = tck.restore_checkpoint(d, tstate)
    assert step == 5
    assert 'unreadable' in capsys.readouterr().out
    tree, step = tck.read_checkpoint(d)
    assert step == 5 and set(tree) >= {'gen_params', 'opt_g', 'step'}


def test_missing_dir_and_mismatched_template_raise(states, tmp_path):
    _, _, _, jstate, tstate = states
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / 'nope'), tstate)
    jck.save_checkpoint(str(tmp_path), jstate, 1)
    small = tstate.replace(crit_params=dict(
        list(tstate.crit_params.items())[:-1]))
    with pytest.raises(ValueError, match='mismatch'):
        tck.restore_checkpoint(str(tmp_path), small)


def test_serving_takes_the_checkpoint_then_the_artifact(states, tmp_path,
                                                        monkeypatch):
    _, tcfg, _, _, tstate = states
    cfg = tcfg.copy()
    cfg.name = 'test/served'
    root = tmp_path / 'models'
    monkeypatch.chdir(tmp_path)     # the artifact goes under artifacts/
    with pytest.raises(FileNotFoundError):
        tart.restore_for_serving(cfg.name, str(root))
    path = tart.export_serving_artifact(cfg.name, tstate, 4)
    assert path == os.path.join('artifacts', 'serving',
                                'test--served.msgpack.gz')
    assert os.path.exists(tmp_path / path)
    sd, step, source = tart.restore_for_serving(cfg.name, str(root))
    assert (step, source) == (4, 'artifact')
    moved = tstate.replace(gen_params={k: v + 1 for k, v in
                                       tstate.gen_params.items()})
    tck.save_checkpoint(str(root / cfg.name), moved, 8)
    sd, step, source = tart.restore_for_serving(cfg.name, str(root))
    assert (step, source) == (8, 'checkpoint')
    pipe = RetouchPipeline.from_run(cfg, model_root=str(root), device='cpu')
    assert pipe.step == 8
    for k, v in pipe.policy.state_dict().items():
        assert torch.equal(v, moved.gen_params[k]), k


def test_train_state_takes_the_source_serving_takes(states, tmp_path,
                                                    monkeypatch):
    """``restore_train_state`` reads where ``restore_for_serving`` reads:
    neither finds a run with no checkpoint and no artifact; the artifact
    gives its generator over the template's critic; the checkpoint gives
    its whole state; both report the same step and source."""
    _, _, _, _, tstate = states
    run, root = 'test/whole', str(tmp_path / 'models')
    monkeypatch.chdir(tmp_path)     # the artifact goes under artifacts/
    template = tstate.replace(crit_params={
        k: torch.zeros_like(v) for k, v in tstate.crit_params.items()})

    def crit_equal(state, want):
        return all(torch.equal(v, want.crit_params[k])
                   for k, v in state.crit_params.items())
    assert not tart.has_trained_params(run, root)
    for restore in (lambda: tart.restore_for_serving(run, root),
                    lambda: tart.restore_train_state(run, template, root)):
        with pytest.raises(FileNotFoundError, match='no checkpoint under'):
            restore()
    tart.export_serving_artifact(run, tstate, 4)
    assert tart.has_trained_params(run, root)
    state, step, source = tart.restore_train_state(run, template, root)
    assert (step, source) == (4, 'artifact') == \
        tart.restore_for_serving(run, root)[1:]
    assert all(torch.equal(v, tstate.gen_params[k])
               for k, v in state.gen_params.items())
    assert crit_equal(state, template) and not crit_equal(state, tstate)
    tck.save_checkpoint(os.path.join(root, run), tstate, 8)
    state, step, source = tart.restore_train_state(run, template, root)
    assert (step, source) == (8, 'checkpoint') == \
        tart.restore_for_serving(run, root)[1:]
    assert crit_equal(state, tstate)
