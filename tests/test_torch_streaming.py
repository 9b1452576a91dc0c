"""Streaming training of the port against the JAX package, on the CPU:

- ``build_streaming_outer_step`` against the JAX step on a 1-device mesh,
  on the same bundle, the JAX step's draws replayed (``wgan``: giters 2,
  citers 2; ``supervised``: 1, 0), with the tolerances of
  ``tests/test_torch_train_step.py`` (metrics rtol 1e-4, parameters within
  3 lr, Adam's moments, the pool); a uint8 bundle against the JAX step on
  it, and against the port's step on its dequantized float32 bundle (bit
  for bit);
- the bundle assembly against the JAX ``Trainer._assemble_stream``
  (called unbound on a stub) on native providers of each package on the
  same seeds, and on procedural and paired providers on the same
  ``random`` seed: the bundles equal bit for bit, and the providers'
  seeds afterwards;
- ``AsyncPrefetcher``: order, an error raised in the consumer, ``stop``;
- a short streaming ``Trainer`` run of ``test`` (native packs, float32 and
  uint8) and of ``supervised_test`` (a paired provider): finite metrics,
  the pool moved, checkpoints written; two runs from one seed give equal
  parameters (the one ordered producer)."""

import os
import random
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from torch_train_helpers import jax_native_built  # noqa: F401 (a fixture)
from torch_train_helpers import stream_draws
from exposure_tpu.core.replay import PoolState as JPool
from exposure_tpu.core.steps import (
    build_streaming_outer_step as j_build_streaming_outer_step,
)
from exposure_tpu.core.trainer import Trainer as JTrainer
from exposure_tpu.data import synthetic as j_synth
from exposure_tpu.parallel.mesh import data_parallel_mesh
from exposure_tpu_torch.core.replay import PoolState as TPool
from exposure_tpu_torch.core.steps import (
    build_streaming_outer_step,
    dequant_stream,
)
from exposure_tpu_torch.core.streaming import assemble_stream
from exposure_tpu_torch.core.train_state import init_train_state
from exposure_tpu_torch.core.trainer import Trainer
from exposure_tpu_torch.data import native_provider as t_native
from exposure_tpu_torch.data import synthetic as t_synth
from exposure_tpu_torch.data.native_provider import NativePackProvider
from exposure_tpu_torch.data.synthetic import make_synthetic_pack
from exposure_tpu_torch.models.networks import build_models
from exposure_tpu_torch.utils.config import load_config
from exposure_tpu_torch.utils.draws import Draws
from exposure_tpu_torch.utils.prefetch import AsyncPrefetcher

pytestmark = pytest.mark.usefixtures('few_threads')

B, P = 8, 16
LR = 1e-3
CASES = {
    # name: (knobs, giters, citers, bundle dtype)
    'wgan': (dict(), 2, 2, np.float32),
    'wgan_u8': (dict(), 2, 2, np.uint8),
    'supervised': (dict(supervised=True), 1, 0, np.float32),
}


def _bundle(supervised, giters, citers, dtype, num_state_dim):
    rng = np.random.RandomState(0)
    channels = 6 if supervised else 3
    g = rng.rand(giters, 2 * B + P, 64, 64, channels)
    r = rng.rand(citers, B, 64, 64, 3)
    if dtype == np.uint8:
        g, r = (np.round(x * 255).astype(np.uint8) for x in (g, r))
    else:
        g, r = g.astype(np.float32), r.astype(np.float32)
    pool_img = rng.rand(P, 64, 64, 3).astype(np.float32)
    pool_gt = rng.rand(P, 64, 64, 3).astype(np.float32) if supervised \
        else None
    states = np.zeros((P, num_state_dim), np.float32)
    states[::3, 1] = 1
    states[::3, 2] = 5
    states[1::3, 2] = 2
    states[2::5, 2] = 7         # over-length records: the keep draw acts
    return g, r, pool_img, pool_gt, states


def _pool(cls, lib, pool_img, states, pool_gt):
    return cls(images=lib(pool_img), states=lib(states),
               ground_truth=None if pool_gt is None else lib(pool_gt))


@pytest.fixture(scope='module', params=sorted(CASES))
def stepped(request):
    knobs, giters, citers, dtype = CASES[request.param]
    jcfg, tcfg = H.configs('test', dropout_keep_prob=1.0, batch_size=B,
                           replay_memory_size=P, **knobs)
    jm, jstate, tx, tm, tstate = H.models(jcfg, tcfg)
    supervised = bool(knobs.get('supervised'))
    g, r, pool_img, pool_gt, states = _bundle(supervised, giters, citers,
                                              dtype, jcfg.num_state_dim)
    step = j_build_streaming_outer_step(jcfg, *jm[1:], jm[0], tx,
                                        data_parallel_mesh(1), giters, citers)
    key = jax.random.PRNGKey(5)
    rates = (LR, LR, 0.3)
    j_out = step(jstate, _pool(JPool, jnp.asarray, pool_img, states, pool_gt),
                 jnp.asarray(g), jnp.asarray(r), key,
                 *[jnp.float32(x) for x in rates])
    t_step = build_streaming_outer_step(tcfg, *tm[1:], tm[0], giters, citers)

    def run(g_bundle, r_bundle):
        draws = H.JaxDraws(stream_draws(key, jcfg, giters, citers))
        out = t_step(tstate, _pool(TPool, torch.from_numpy, pool_img,
                                   states, pool_gt),
                     torch.from_numpy(g_bundle), torch.from_numpy(r_bundle),
                     draws, *rates)
        assert draws.left() == 0
        return out

    return tstate, j_out, run(g, r)


def test_metrics_match(stepped):
    _, (_, _, j_m), (_, _, t_m) = stepped
    for field, want in j_m._asdict().items():
        got = float(getattr(t_m, field))
        if np.isnan(float(want)):       # a phase that ran no update
            assert np.isnan(got), field
            continue
        np.testing.assert_allclose(got, float(want), rtol=1e-4, atol=1e-6,
                                   err_msg=field)


def test_parameters_and_adam_match(stepped):
    t0, (j_state, _, _), (t_state, _, _) = stepped
    want = H.to_torch_state(j_state, t0)
    for tree in ('gen_params', 'val_params', 'crit_params'):
        worst = max(H.tree_max_abs(getattr(t_state, tree),
                                   getattr(want, tree)).values())
        assert worst <= 3 * LR, (tree, worst / LR)
    for opt in ('opt_g', 'opt_v', 'opt_c'):
        a, b = getattr(t_state, opt), getattr(want, opt)
        assert a.count == b.count, opt
        for moment in ('mu', 'nu'):
            ma, mb = getattr(a, moment), getattr(b, moment)
            scale = max(float(v.abs().max()) for v in mb.values())
            for k in mb:
                np.testing.assert_allclose(
                    ma[k].numpy(), mb[k].numpy(), rtol=1e-3,
                    atol=1e-4 * scale, err_msg='%s %s %s' % (opt, moment, k))
    assert t_state.ema.count == want.ema.count


def test_pool_matches_slot_for_slot(stepped):
    _, (_, j_pool, _), (_, t_pool, _) = stepped
    np.testing.assert_array_equal(t_pool.states.numpy(),
                                  np.asarray(j_pool.states))
    np.testing.assert_allclose(t_pool.images.numpy(),
                               np.asarray(j_pool.images), atol=1e-5)
    if j_pool.ground_truth is not None:
        np.testing.assert_array_equal(t_pool.ground_truth.numpy(),
                                      np.asarray(j_pool.ground_truth))


def test_u8_bundle_equals_its_dequantized_f32():
    """The port's step on a uint8 bundle and on that bundle dequantized on
    the host: the same bits everywhere."""
    _, tcfg = H.configs('test', dropout_keep_prob=1.0, batch_size=B,
                        replay_memory_size=P)
    filters, policy, critic, value = build_models(tcfg)
    state = init_train_state(tcfg, policy, critic, value, seed=0)
    g, r, pool_img, _, states = _bundle(False, 1, 1, np.uint8,
                                        tcfg.num_state_dim)
    step = build_streaming_outer_step(tcfg, policy, critic, value, filters,
                                      1, 1)
    inv = np.float32(1.0 / 255.0)
    outs = []
    for g_b, r_b in ((g, r), (g.astype(np.float32) * inv,
                              r.astype(np.float32) * inv)):
        gen = torch.Generator().manual_seed(3)
        outs.append(step(state, _pool(TPool, torch.from_numpy, pool_img,
                                      states, None),
                         torch.from_numpy(g_b), torch.from_numpy(r_b),
                         Draws(gen),
                         LR, LR, 0.3))
    (s8, p8, m8), (sf, pf, mf) = outs
    a, b = s8.tensors(), sf.tensors()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(p8.images, pf.images)
    assert torch.equal(torch.stack(list(m8)), torch.stack(list(mf)))


def test_dequant_is_the_jax_product():
    x = np.arange(256, dtype=np.uint8)
    got = dequant_stream(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.float32) *
                      jnp.float32(1.0 / 255.0))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    f = torch.rand(3)
    assert dequant_stream(f) is f


def test_supervised_streaming_refuses_critic_updates():
    _, tcfg = H.configs('test', supervised=True)
    with pytest.raises(ValueError, match='supervised'):
        build_streaming_outer_step(tcfg, None, None, None, None, 1, 2)


# --- the bundle assembly -------------------------------------------------
@pytest.fixture(scope='module')
def packs(tmp_path_factory):
    d = tmp_path_factory.mktemp('stream_packs')
    raw, real = str(d / 'raw.npy'), str(d / 'real.npy')
    np.save(raw, make_synthetic_pack(12, 80, 'raw', 0))
    np.save(real, make_synthetic_pack(12, 64, 'retouched', 1))
    return raw, real


def _native_pair(module, packs):
    return (module.NativePackProvider(packs[0], output_size=64,
                                      augmentation=0.3, seed=3),
            module.NativePackProvider(packs[1], output_size=64,
                                      augmentation=0.0, seed=4))


@pytest.mark.parametrize('case', ['f32', 'u8', 'n_iters_3', 'giters_0',
                                  'procedural_u8', 'paired_u8'])
def test_assembly_equals_jax(packs, jax_native_built, case):
    from exposure_tpu.data import native_provider as j_native
    supervised = case == 'paired_u8'
    name = 'supervised_test' if supervised else 'test'
    jcfg, tcfg = H.configs(name, batch_size=4, replay_memory_size=6,
                           stream_dtype='uint8' if 'u8' in case
                           else 'float32')
    giters, citers, n = {'n_iters_3': (1, 2, 3),
                         'giters_0': (0, 2, 1)}.get(case, (2, 3, 1))
    if supervised:
        citers = 0
    sides = []
    for module, cfg, synth in ((t_native, tcfg, t_synth),
                               (j_native, jcfg, j_synth)):
        random.seed(11)
        if case == 'procedural_u8':
            providers = (synth.SyntheticDataProvider(n=6, seed=0,
                                                     output_size=64,
                                                     augmentation=0.3),
                         synth.SyntheticDataProvider(n=6, size=64, seed=1,
                                                     output_size=64,
                                                     augmentation=1.0))
        elif supervised:
            providers = (synth.PairedSyntheticDataProvider(n=6, seed=0),
                         synth.SyntheticDataProvider(n=6, size=64, seed=2,
                                                     output_size=64))
        else:
            providers = _native_pair(module, packs)
        sides.append(providers)
    (t_fake, t_real), (j_fake, j_real) = sides
    for _ in range(2):      # two bundles in a row: the seeds go on alike
        random.seed(12)
        got = assemble_stream(tcfg, supervised, t_fake, t_real, giters,
                              citers, n)
        random.seed(12)
        stub = types.SimpleNamespace(cfg=jcfg, supervised=supervised,
                                     fake_provider=j_fake,
                                     real_provider=j_real)
        want = JTrainer._assemble_stream(stub, giters, citers, n)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        for t, j in ((t_fake, j_fake), (t_real, j_real)):
            if hasattr(t, '_seed'):
                assert int(t._seed) == int(j._seed)
    assert got[0].dtype == (np.uint8 if 'u8' in case else np.float32)
    if n > 1:
        assert got[0].shape[:2] == (n, giters)


def test_assembly_into_buffers_refuses_other_shapes(packs):
    _, tcfg = H.configs('test', batch_size=4, replay_memory_size=6)
    fake, real = _native_pair(t_native, packs)
    with pytest.raises(ValueError, match='bundle buffers'):
        assemble_stream(tcfg, False, fake, real, 1, 1,
                        out=(np.empty((1, 14, 64, 64, 3), np.float32),
                             np.empty((1, 4, 64, 64, 3), np.uint8)))


# --- the prefetcher ------------------------------------------------------
def test_prefetcher_order_errors_and_stop():
    made = iter(range(100))
    pf = AsyncPrefetcher(lambda: next(made), slots=3)
    assert [pf.get_next() for _ in range(5)] == [0, 1, 2, 3, 4]
    pf.stop()
    assert not pf._thread.is_alive()

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 2:
            raise ValueError('producer failure')
        return len(calls)

    pf = AsyncPrefetcher(flaky)
    assert pf.get_next() == 1
    with pytest.raises(ValueError, match='producer failure'):
        pf.get_next()
    assert pf.get_next() == 3
    pf.stop()

    def slow():
        time.sleep(0.05)
        return 0
    pf = AsyncPrefetcher(slow, slots=1)
    pf.stop()
    assert not pf._thread.is_alive()


# --- the streaming Trainer -----------------------------------------------
def _stream_cfg(name, tag, packs=None, **knobs):
    cfg = load_config(name)
    cfg.name = 'stream/' + tag
    cfg.update(max_iter_step=5, stream_data=True,
               stream_iters_per_dispatch=3, write_image_interval=4)
    if packs is not None:
        cfg.fake_data_provider = lambda: NativePackProvider(
            packs[0], output_size=64, augmentation=0.3, seed=0)
        cfg.real_data_provider = lambda: NativePackProvider(
            packs[1], output_size=64, augmentation=0.0, seed=1)
    cfg.update(knobs)
    return cfg


def _train(cfg, root):
    random.seed(0)
    trainer = Trainer(cfg, model_root=str(root), device='cpu')
    pool0 = trainer.pool.images.clone()
    try:
        metrics = trainer.train()
    finally:
        trainer.close()
    return trainer, pool0, metrics


@pytest.fixture(scope='module')
def streamed(packs, tmp_path_factory):
    root = tmp_path_factory.mktemp('stream_runs')
    return {tag: _train(_stream_cfg(name, tag, p, stream_dtype=dt), root)
            for tag, name, p, dt in (
                ('a', 'test', packs, 'float32'),
                ('b', 'test', packs, 'float32'),
                ('u8', 'test', packs, 'uint8'),
                ('supervised', 'supervised_test', None, 'float32'))}


@pytest.mark.parametrize('tag', ['a', 'u8', 'supervised'])
def test_streaming_trainer_runs(streamed, tag):
    trainer, pool0, metrics = streamed[tag]
    assert trainer.streaming and trainer.fake_images is None
    assert trainer.feeder is None           # closed
    assert np.isfinite(np.asarray(metrics)).all()
    assert not torch.equal(trainer.pool.images, pool0)
    assert trainer.latest_checkpoint() == 6
    assert trainer.state.step == 6
    assert sorted(os.listdir(trainer.image_dir)) == [
        '000000.png', '000004.png']
    if tag == 'supervised':
        assert metrics.emd == 0.0 and trainer.pool.ground_truth is not None
        assert trainer.state.opt_c.count == 0


def test_streaming_runs_are_a_function_of_the_seed(streamed):
    a, b = streamed['a'][0].state.tensors(), streamed['b'][0].state.tensors()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(streamed['a'][0].pool.images,
                       streamed['b'][0].pool.images)


def test_stream_schedule_follows_the_jax_chunks(packs, tmp_path):
    from exposure_tpu.core.trainer import plan_fused_chunk as j_plan
    from exposure_tpu_torch.core.trainer import plan_fused_chunk
    cfg = _stream_cfg('test', 'plan', packs, max_iter_step=40,
                      checkpoint_interval=7)
    for it in range(41):
        for n_fuse in (1, 3, 10):
            for supervised in (False, True):
                assert plan_fused_chunk(it, cfg, n_fuse, supervised) == \
                    j_plan(it, cfg, n_fuse, supervised)
    trainer = Trainer(cfg, restore=True, model_root=str(tmp_path),
                      device='cpu')
    plan = list(trainer.stream_schedule(0))
    trainer.close()
    # the warmup: 6 generator bundles, then the burst's 4 // 2 critic ones
    assert plan[0] == (0, 1, [(1, 0, 1)] * 6 + [(0, 2, 1)] * 2)
    its = [it for it, _, _ in plan]
    chunks = [c for _, c, _ in plan]
    assert its[0] == 0 and its[-1] + chunks[-1] == 41
    assert all(a + c == b for a, c, b in zip(its, chunks, its[1:]))
    assert any(k == [(1, 2, c)] for _, c, k in plan if c > 1)


def test_a_restored_streaming_trainer_restarts_its_stream(packs, tmp_path):
    """``restore`` moves the trainer to another iteration than its stream
    is at: the producer starts again there, and training goes on."""
    cfg = _stream_cfg('test', 'restore', packs, write_image_interval=0)
    random.seed(0)
    trainer = Trainer(cfg, model_root=str(tmp_path), device='cpu')
    try:
        trainer.train(last_iter=2)
        assert trainer.restore(2) == 2 and trainer.state.step == 2
        metrics = trainer.train(last_iter=4)
    finally:
        trainer.close()
    assert trainer.state.step == 5
    assert np.isfinite(np.asarray(metrics)).all()
