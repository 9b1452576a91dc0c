"""The fused N-iteration dispatch of the port (``core/fused.py``,
``core/steps.py::build_fused_iterations_step`` and
``build_streaming_fused_step``, ``Trainer._run_fused``) on the CPU, where
the chunk runs its static-buffer body eagerly:

- a fused chunk equals the same iterations through
  ``Trainer.run_iteration`` bit for bit: every state tensor, the counts,
  the pool and every iteration's metrics; resident, streaming on a float32
  and a uint8 bundle, and on each rank of a two-rank ``gloo`` world
  (``tools/parallel_check.py::fused_rank`` too, plain against fused and the
  resume from the pipelined checkpoint);
- one chunk against the JAX ``build_fused_iterations_step`` and one against
  ``build_streaming_fused_step`` (N 3, giters 1, citers 2) on the JAX
  steps' own draws replayed, with dropout off, at the tolerances of
  ``tests/test_torch_train_step.py``: metrics rtol 1e-4 (atol 1e-6), the
  parameters within 3 lr, Adam's moments within 1e-4 of the largest of
  their tree (rtol 1e-3) and their counts, the EMA rtol 1e-4 and its count,
  the pool's states equal and images within 1e-5;
- the bias corrections the steps read equal ``_bias_correction`` at every
  count of a run;
- ``Trainer`` with ``iters_per_dispatch`` 5 and ``dispatch_pipeline_depth``
  2 against 1 and 0 over 13 iterations of ``test`` (the counterpart of
  ``tests/test_e2e.py::test_fused_dispatch_training``): the same state and
  pool bit for bit, ``metrics.jsonl`` rows, log lines (their ms left out),
  checkpoint files byte for byte, which the JAX ``restore_checkpoint``
  reads, and grids;
- the NaN guard names the chunk's iterations; a ``gloo`` group on a CUDA
  device with ``iters_per_dispatch`` above 1 raises (the device check
  stubbed: there is no card here).
"""

import os
import random
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import torch_parallel_workers as W
import torch_train_helpers as H
from torch_train_helpers import few_threads  # noqa: F401 (a fixture)
from exposure_tpu.core.checkpoint import restore_checkpoint as j_restore
from exposure_tpu.core.replay import PoolState as JPool
from exposure_tpu.core.steps import (
    build_fused_iterations_step as j_build_fused,
    build_streaming_fused_step as j_build_streaming_fused,
)
from exposure_tpu.parallel.mesh import data_parallel_mesh as j_mesh
from exposure_tpu_torch.core import trainer as ttrainer
from exposure_tpu_torch.core.checkpoint import state_to_flax
from exposure_tpu_torch.core.replay import PoolState as TPool
from exposure_tpu_torch.core.steps import (
    build_fused_iterations_step,
    build_outer_step,
    build_streaming_fused_step,
    scalar_row,
    scalars_view,
)
from exposure_tpu_torch.core.train_state import (
    _bias_correction,
    bias_corrections,
)
from exposure_tpu_torch.core.trainer import Trainer
from exposure_tpu_torch.parallel.launch import spawn_ranks
from exposure_tpu_torch.parallel.mesh import Mesh
from exposure_tpu_torch.utils.config import load_config
from exposure_tpu_torch.utils.draws import Draws

pytestmark = pytest.mark.usefixtures('few_threads')

B, P = 8, 16
LR = 1e-3
N = 2
ITERS = [5, 6]
META = (64, True)      # the packs' crop size and augmentation


def _cfg(name, **knobs):
    cfg = load_config('test')
    cfg.name = name
    cfg.update(knobs)
    return cfg


# --- the fused chunk against run_iteration -------------------------------
def _stream_group(trainer, it0, chunk, dtype):
    """A fixed bundle for iterations ``it0 .. it0 + chunk - 1`` in place of
    the trainer's producer, made from a seed."""
    cfg = trainer.cfg
    rng = np.random.RandomState(7)
    b, p = cfg.batch_size, cfg.replay_memory_size
    g = rng.rand(chunk, cfg.giters, 2 * b + p, 64, 64, 3)
    r = rng.rand(chunk, cfg.citers, b, 64, 64, 3)
    if dtype == 'uint8':
        g, r = (np.round(x * 255).astype(np.uint8) for x in (g, r))
    else:
        g, r = g.astype(np.float32), r.astype(np.float32)
    group = (it0, chunk, (torch.from_numpy(g), torch.from_numpy(r)))
    trainer._stream_take = lambda it, n: group


@pytest.mark.parametrize('path', ['resident', 'stream_float32',
                                  'stream_uint8'])
def test_fused_chunk_equals_run_iteration(path, tmp_path):
    knobs = {}
    if path != 'resident':
        knobs = dict(stream_data=True, stream_dtype=path.split('_')[1])
    trainer = Trainer(_cfg('fused/' + path, **knobs), restore=True,
                      model_root=str(tmp_path), device='cpu')
    try:
        if path == 'resident':
            trainer.train(last_iter=0)      # the warmup and the burst
        else:
            trainer.state = trainer.state.replace(step=1)
            _stream_group(trainer, 1, 4, knobs['stream_dtype'])
        fused, plain = W.fused_and_plain(trainer, 1, 4)
    finally:
        trainer.close()
    assert W.differing(fused, plain) == []
    assert fused[0].step == 5 and fused[2].shape == (4, 7)
    assert torch.isfinite(fused[2]).all()
    runner = next(v for k, v in trainer._steps.items() if k[0] == 'fused')
    assert not runner.graphs and runner.graph is None


def test_fused_chunk_on_two_gloo_ranks(tmp_path):
    ranks = spawn_ranks(W.fused_rank, 2, (dict(root=str(tmp_path),
                                               chunk=3),),
                        device='cpu', threads=2, deadline_s=150,
                        rendezvous_dir=str(tmp_path))
    for rank in ranks:
        assert rank['differing'] == []
        assert np.isfinite(rank['metrics']).all()
    # the metrics are averaged over the ranks
    np.testing.assert_array_equal(ranks[0]['metrics'], ranks[1]['metrics'])


def test_parallel_checks_fused_rank_on_two_gloo_ranks(tmp_path):
    """``tools/parallel_check.py::fused_rank``, which ``chip_smoke.py
    --world N`` runs on each ``nccl`` card, on two CPU ranks of ``test``:
    the fused run equals the plain one, the ranks' parameters agree after
    every chunk, and the checkpoint the pipelined run wrote resumes bit for
    bit."""
    from exposure_tpu_torch.tools.parallel_check import fused_rank
    job = dict(config='test', root=str(tmp_path), seed=0, chunk=2, first=2,
               last_iter=7, turns=('fused',), name='test/fused_rank',
               model_root=str(tmp_path / 'models'),
               knobs=dict(critic_initialization=2, checkpoint_interval=4,
                          iters_per_dispatch=2, dispatch_pipeline_depth=2))
    ranks = spawn_ranks(fused_rank, 2, (job,), device='cpu', threads=2,
                        deadline_s=400, rendezvous_dir=str(tmp_path))
    for rank in ranks:
        assert rank['fused_vs_plain_differing'] == []
        assert rank['restored_differing'] == rank['resumed_differing'] == []
        assert rank['params_equal_every_chunk'] and rank['resume_step'] == 4
        assert rank['chunks_compared'] == 3 and rank['captures'] == 0


# --- against the JAX fused steps -----------------------------------------
def _inputs(num_state_dim):
    rng = np.random.RandomState(0)
    fake = rng.rand(12, 80, 80, 3).astype(np.float32)
    real = rng.rand(12, 64, 64, 3).astype(np.float32)
    g_all = rng.rand(N, 1, 2 * B + P, 64, 64, 3).astype(np.float32)
    r_all = rng.rand(N, 2, B, 64, 64, 3).astype(np.float32)
    pool_img = rng.rand(P, 64, 64, 3).astype(np.float32)
    states = np.zeros((P, num_state_dim), np.float32)
    states[::3, 1] = 1
    states[::3, 2] = 5
    states[1::3, 2] = 2
    states[2::5, 2] = 7         # over-length records: the keep draw acts
    return fake, real, g_all, r_all, pool_img, states


@pytest.fixture(scope='module')
def warmed():
    """Both packages' models, and a state and pool after an iteration 0 of
    the ``test`` schedule (6 generator updates at lr 0, a burst of 4 critic
    updates; the port's step, carried over to JAX through the checkpoint
    map): a fused chunk never starts from fresh Adam moments, whose first
    step moves a parameter by about lr whatever its gradient's size
    (near-zero gradients of the other sign end 2 lr apart)."""
    jcfg, tcfg = H.configs('test', dropout_keep_prob=1.0, batch_size=B,
                           replay_memory_size=P)
    jm, jstate, tx, tm, tstate = H.models(jcfg, tcfg)
    inputs = _inputs(jcfg.num_state_dim)
    fake, real, _, _, pool_img, states = inputs
    step = build_outer_step(tcfg, *tm[1:], tm[0], META, META, 6, 4)
    tstate, tpool, _ = step(
        tstate, TPool(images=torch.from_numpy(pool_img),
                      states=torch.from_numpy(states)),
        torch.from_numpy(fake), torch.from_numpy(real),
        Draws(torch.Generator().manual_seed(3)), 0.0, LR, 0.0)
    jstate = serialization.from_state_dict(jstate, state_to_flax(tstate))
    jpool = JPool(images=jnp.asarray(tpool.images.numpy()),
                  states=jnp.asarray(tpool.states.numpy()))
    return jcfg, tcfg, jm, tx, tm, jstate, tstate, jpool, inputs


@pytest.fixture(scope='module', params=['resident', 'streaming'])
def against_jax(request, warmed):
    streaming = request.param == 'streaming'
    jcfg, tcfg, jm, tx, tm, jstate, t0, jpool, inputs = warmed
    tstate = H.to_torch_state(jstate, t0)
    fake, real, g_all, r_all, _, _ = inputs
    meta = META
    base = jax.random.PRNGKey(11)
    lr_gs = [LR, 0.5 * LR]
    lr_cs = [0.5 * LR, LR]
    progs = [0.1, 0.4]
    rates = (jnp.asarray(ITERS, jnp.int32), jnp.asarray(lr_gs, jnp.float32),
             jnp.asarray(lr_cs, jnp.float32), jnp.asarray(progs, jnp.float32))
    if streaming:
        step = j_build_streaming_fused(jcfg, *jm[1:], jm[0], tx, j_mesh(1),
                                       1, 2, N)
        j_out = step(jstate, jpool, jnp.asarray(g_all), jnp.asarray(r_all),
                     base, *rates)
    else:
        step = j_build_fused(jcfg, *jm[1:], jm[0], tx, j_mesh(1), meta,
                             meta, 1, 2, N)
        j_out = step(jstate, jpool, jnp.asarray(fake), jnp.asarray(real),
                     base, *rates)

    shapes = (fake.shape, meta, real.shape, meta)
    handed = []

    def draws_for(it):
        key = jax.random.fold_in(base, it)
        if streaming:
            draws = H.stream_draws(jax.random.fold_in(key, 0), jcfg, 1, 0) + \
                H.stream_draws(jax.random.fold_in(key, 1), jcfg, 0, 2)
        else:
            draws = H.step_draws(jax.random.fold_in(key, 0), jcfg, 1, 0,
                                 *shapes) + \
                H.step_draws(jax.random.fold_in(key, 1), jcfg, 0, 2, *shapes)
        handed.append(H.JaxDraws(draws))
        return handed[-1]

    if streaming:
        runner = build_streaming_fused_step(tcfg, *tm[1:], tm[0], 1, 2,
                                            draws_for)
        data = (torch.from_numpy(g_all), torch.from_numpy(r_all))
    else:
        runner = build_fused_iterations_step(tcfg, *tm[1:], tm[0], meta,
                                             meta, 1, 2, draws_for)
        data = (torch.from_numpy(fake), torch.from_numpy(real))
    t_out = runner.run(tstate, TPool(images=H._t(jpool.images),
                                     states=H._t(jpool.states)),
                       data, ITERS, lr_gs, lr_cs, progs)
    assert len(handed) == N and all(d.left() == 0 for d in handed)
    return tstate, j_out, t_out


def test_fused_metrics_match_jax(against_jax):
    _, (_, _, j_m), (_, _, t_m) = against_jax
    assert t_m.shape == (N, 7)
    for f, (field, want) in enumerate(j_m._asdict().items()):
        np.testing.assert_allclose(t_m[:, f].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6, err_msg=field)


def test_fused_state_matches_jax(against_jax):
    t0, (j_state, _, _), (t_state, _, _) = against_jax
    want = H.to_torch_state(j_state, t0)
    lr = LR
    for tree in ('gen_params', 'val_params', 'crit_params'):
        worst = max(H.tree_max_abs(getattr(t_state, tree),
                                   getattr(want, tree)).values())
        assert worst <= 3 * lr, (tree, worst / lr)
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
    assert t_state.ema.count == want.ema.count == 4 + 2 * N
    np.testing.assert_allclose(float(t_state.ema.biased),
                               float(want.ema.biased), rtol=1e-4)


def test_fused_pool_matches_jax(against_jax):
    _, (_, j_pool, _), (_, t_pool, _) = against_jax
    np.testing.assert_array_equal(t_pool.states.numpy(),
                                  np.asarray(j_pool.states))
    np.testing.assert_allclose(t_pool.images.numpy(),
                               np.asarray(j_pool.images), atol=1e-5)


# --- the bias corrections -------------------------------------------------
def test_bias_corrections_equal_the_host_formula():
    """Every count of a 20,000-iteration run (the critic's reaches about
    104,100) for both betas, and a step's scalar vector laid out as the
    steps read it."""
    for b in (0.5, 0.9):
        got = bias_corrections(0, 105000, b1=b, b2=b)
        want = 1 - torch.tensor(b, dtype=torch.float32) ** torch.arange(
            1, 105001, dtype=torch.float32)
        for count in (1, 2, 3, 50, 101, 1000, 104100, 105000):
            assert got[count - 1][0] == float(_bias_correction(b, count))
        np.testing.assert_array_equal(
            np.asarray(got, np.float32)[:, 0],
            np.asarray([float(_bias_correction(b, c))
                        for c in range(1, 105001)], np.float32))
        assert np.abs(np.asarray(got)[:, 0] - want.numpy()).max() < 1e-6
    cfg = load_config('test')
    state = _counts(opt_g=7, opt_v=7, opt_c=40)
    vec = torch.tensor(scalar_row(cfg, state, 2, 3, 1e-4, 3e-4, 0.25),
                       dtype=torch.float32)
    sc = scalars_view(vec, 2, 3)
    assert float(sc.lr_v) == float(torch.tensor(1e-4 * cfg.value_lr_mul))
    assert float(sc.progress) == float(torch.tensor(0.25))
    for bc, count, n in ((sc.bc_g, 7, 2), (sc.bc_v, 7, 2), (sc.bc_c, 40, 3)):
        for i in range(n):
            for j, beta in enumerate((0.5, 0.9)):
                assert float(bc[i, j]) == float(
                    _bias_correction(beta, count + 1 + i))
    assert sc.after(1, 2).bc_g.shape == (1, 2)
    assert sc.after(1, 2).bc_c.shape == (1, 2)


def _counts(opt_g, opt_v, opt_c):
    """A stand-in state with Adam's counts alone."""
    return types.SimpleNamespace(
        opt_g=types.SimpleNamespace(count=opt_g),
        opt_v=types.SimpleNamespace(count=opt_v),
        opt_c=types.SimpleNamespace(count=opt_c))


# --- the Trainer ----------------------------------------------------------
# the wall-clock readings of the log lines
CLOCK = re.compile(r'\s*[0-9.]+ ms/it|ela\. .*')


@pytest.fixture(scope='module')
def two_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('fused_runs')
    runs = {}
    for tag, n, depth in (('plain', 1, 0), ('fused', 5, 2)):
        cfg = _cfg('test/' + tag, max_iter_step=12, checkpoint_interval=10,
                   write_image_interval=4, iters_per_dispatch=n,
                   dispatch_pipeline_depth=depth)
        random.seed(0)
        trainer = Trainer(cfg, model_root=str(root), device='cpu')
        chunks = []
        process = trainer._process_chunk
        trainer._process_chunk = lambda rec, books: (
            chunks.append((rec.it0, rec.chunk)), process(rec, books))
        try:
            metrics = trainer.train()
        finally:
            trainer.close()
        runs[tag] = (trainer, metrics, chunks,
                     os.path.join(str(root), 'test', tag))
    return runs


def test_trainer_fused_equals_plain(two_runs):
    (plain, pm, p_chunks, _), (fused, fm, f_chunks, _) = \
        two_runs['plain'], two_runs['fused']
    assert p_chunks == [(i, 1) for i in range(13)]
    # iteration 0 alone; chunks end on the grids (4, 8, 12) and the
    # checkpoint (9)
    assert f_chunks == [(0, 1), (1, 4), (5, 4), (9, 1), (10, 3)]
    assert W.differing((fused.state, fused.pool, torch.tensor(fm)),
                       (plain.state, plain.pool, torch.tensor(pm))) == []
    runner = fused._steps[('fused', 1, 2, 'resident', None)]
    assert runner.graph is None and plain.n_fuse == 1
    assert fused.state.step == plain.state.step == 13


def _read(run_dir, name):
    with open(os.path.join(run_dir, name)) as f:
        return f.read().splitlines()


def test_trainer_fused_writes_what_plain_writes(two_runs):
    p_dir, f_dir = two_runs['plain'][3], two_runs['fused'][3]
    p_rows, f_rows = (
        [re.sub(r'"(t|ms_per_iter)": [^,}]*', '', r)
         for r in _read(d, 'metrics.jsonl')] for d in (p_dir, f_dir))
    assert p_rows == f_rows and len(p_rows) == 2       # iterations 0, 10

    def lines(d):
        name = '/'.join(d.split(os.sep)[-2:])
        log = [CLOCK.sub('', line.replace(d, '<run>').replace(name, '<run>'))
               for line in _read(d, 'log.txt')
               if not line.startswith('# exposure_tpu_torch')]
        saved = sorted(line for line in log if 'checkpoint saved' in line)
        return [line for line in log if 'checkpoint saved' not in line], saved
    assert lines(p_dir) == lines(f_dir)
    assert len(lines(f_dir)[1]) == 1
    ckpts = sorted(p for p in os.listdir(f_dir) if p.endswith('.msgpack'))
    assert ckpts == sorted(p for p in os.listdir(p_dir)
                           if p.endswith('.msgpack')) == \
        ['model.ckpt-10.msgpack']
    for name in ckpts:
        with open(os.path.join(p_dir, name), 'rb') as a, \
                open(os.path.join(f_dir, name), 'rb') as b:
            assert a.read() == b.read(), name
    images = [sorted(os.listdir(t.image_dir)) for t in
              (two_runs['plain'][0], two_runs['fused'][0])]
    assert images[0] == images[1] == ['%06d.png' % i for i in (0, 4, 8, 12)]
    for name in images[0]:
        with open(os.path.join(two_runs['plain'][0].image_dir, name),
                  'rb') as a, open(os.path.join(
                      two_runs['fused'][0].image_dir, name), 'rb') as b:
            assert a.read() == b.read(), name


def test_fused_checkpoint_restores_in_jax(two_runs):
    trainer, _, _, run_dir = two_runs['fused']
    jcfg, tcfg = H.configs('test')
    _, jstate, _, _, t0 = H.models(jcfg, tcfg)
    restored, step = j_restore(run_dir, jstate)
    assert int(step) == 10
    got = H.to_torch_state(restored, t0)
    again = Trainer(trainer.cfg, restore=True,
                    model_root=os.path.dirname(os.path.dirname(run_dir)),
                    device='cpu')
    try:
        assert again.restore() == 10
    finally:
        again.close()
    want = again.state.tensors()
    for k, v in got.tensors().items():
        assert torch.equal(v, want[k]), k
    for opt in ('opt_g', 'opt_v', 'opt_c'):
        assert getattr(got, opt).count == getattr(again.state, opt).count


def test_nan_guard_names_the_chunk(tmp_path):
    cfg = _cfg('fused/nan', max_iter_step=12, checkpoint_interval=10,
               iters_per_dispatch=5, dispatch_pipeline_depth=2)
    trainer = Trainer(cfg, restore=True, model_root=str(tmp_path),
                      device='cpu')
    try:
        trainer.train(last_iter=0)
        next(iter(trainer.state.gen_params.values())).fill_(float('nan'))
        with pytest.raises(FloatingPointError,
                           match=r'non-finite .* in iterations \[1, 5\]'):
            trainer.train()
    finally:
        trainer.close()
    assert os.path.exists(os.path.join(trainer.dir, 'model.ckpt-5.msgpack'))


def test_gloo_on_the_card_refuses_fused_dispatch(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(ttrainer, 'data_parallel_mesh',
                        lambda *a, **k: Mesh(0, 2, 'cuda', 'gloo'))
    cfg = _cfg('fused/gloo', iters_per_dispatch=5)
    with pytest.raises(ValueError, match='gloo group cannot be captured'):
        Trainer(cfg, model_root=str(tmp_path), device='cuda')
    # what may be captured: nccl on the card, any group on the CPU
    Mesh(0, 2, 'cuda', 'nccl').check_capturable()
    Mesh(0, 2, 'cpu', 'gloo').check_capturable()
    Mesh(0, 1, 'cuda', None).check_capturable()


def test_bench_train_split_runs_the_plain_lines_on_the_cpu():
    from exposure_tpu_torch.tools import bench_train_split
    report = bench_train_split.run('test', 'cpu', chunk=1, runs=1)
    assert report['timing'] == 'host_clock_median_cpu'
    assert report['turns'] == ['plain', 'plain']
    for name in ('outer_ms', 'g_phase_ms', 'c_phase_ms', 'c_single_ms',
                 'sampling_ms'):
        assert set(report[name]) == {'plain'} and report[name]['plain'] > 0
    assert set(report['profile']) == {'plain'}
    assert report['profile']['plain']['idle_share'] is None
