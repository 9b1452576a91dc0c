"""The port's replay pool against the JAX pool, slot for slot, on the CPU.

The cases of ``tests/test_replay.py``, each run through both packages on
the same pool: the JAX function draws from its key, the port replays that
draw (``utils/draws.py::ReplayedDraws``), and every output must be equal
(indices, masks, states and images exactly).  Then the port's own draws:
``Draws.categorical`` picks terminated slots only, and with none in the
pool it falls back to slot 0 for the whole batch without raising, as
``jax.random.categorical`` over all -1e9 logits does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exposure_tpu.core import replay as jr
from exposure_tpu_torch.core import replay as tr
from exposure_tpu_torch.utils.draws import Draws, ReplayedDraws
from exposure_tpu_torch.utils.ops import STATE_STEP_DIM, STATE_STOPPED_DIM

P, B, S, D = 32, 8, 4, 11


def _pools(finished_idx=(), with_gt=False):
    images = np.arange(P, dtype=np.float32)[:, None, None, None] * \
        np.ones((P, S, S, 3), np.float32)
    states = np.zeros((P, D), np.float32)
    for i in finished_idx:
        states[i, STATE_STOPPED_DIM] = 1.0
        states[i, STATE_STEP_DIM] = 5.0
    gt = images + 0.5 if with_gt else None
    j = jr.PoolState(images=jnp.asarray(images), states=jnp.asarray(states),
                     ground_truth=None if gt is None else jnp.asarray(gt))
    t = tr.PoolState(images=torch.from_numpy(images),
                     states=torch.from_numpy(states),
                     ground_truth=None if gt is None else torch.from_numpy(gt))
    return j, t


def _fresh(n, value=-1.0):
    return np.full((n, S, S, 3), value, np.float32)


def _equal(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _select(jpool, tpool, seed, fresh_gt=None):
    key = jax.random.PRNGKey(seed)
    want = jr.select_generator_batch(
        jpool, key, B, jnp.asarray(_fresh(B)),
        None if fresh_gt is None else jnp.asarray(fresh_gt))
    draws = ReplayedDraws([('rank', torch.from_numpy(np.array(
        jax.random.uniform(key, (P,)))))])
    got = tr.select_generator_batch(
        tpool, draws, B, torch.from_numpy(_fresh(B)),
        None if fresh_gt is None else torch.from_numpy(fresh_gt))
    assert draws.left() == 0
    for g, w in zip(got, want):
        _equal(g, w)
    return got


@pytest.mark.parametrize('finished', [
    (),                        # all unfinished
    tuple(range(16)),          # skips the finished ones
    tuple(range(P - 4)),       # underfilled: backfills fresh RAW
    tuple(range(0, P, 3))])
def test_select_matches_jax(finished):
    jpool, tpool = _pools(finished)
    for seed in range(4):
        sel, imgs, states, dropped, _ = _select(jpool, tpool, seed)
        assert not set(sel.tolist()) & set(finished) or \
            len(finished) > P - B
        assert set(np.nonzero(dropped.numpy())[0].tolist()) <= set(finished)
        assert (states[:, STATE_STOPPED_DIM] == 0).all()
    if len(finished) == P - 4:
        n_fresh = int((imgs.reshape(B, -1).mean(1) < 0).sum())
        assert n_fresh == B - 4


def test_select_and_reinsert_carry_ground_truth():
    jpool, tpool = _pools((1, 5, 9), with_gt=True)
    _select(jpool, tpool, 2, fresh_gt=_fresh(B, -7.0))
    sel, imgs, states, dropped, gt = _select(jpool, tpool, 3,
                                             fresh_gt=_fresh(B, -7.0))
    _reinsert(jpool, tpool, sel, imgs, states, dropped, step_inc=3,
              seed=4, gt=gt)


def _reinsert(jpool, tpool, sel, imgs, states, dropped, step_inc, seed,
              gt=None, keep_prob=0.5):
    new_states = states.numpy().copy()
    new_states[:, STATE_STEP_DIM] += step_inc
    new_images = imgs.numpy() + 100.0
    key = jax.random.PRNGKey(seed)
    kw = {}
    if gt is not None:
        kw = dict(batch_gt=gt.numpy(), fresh_gt_for_batch=_fresh(B, -8.0),
                  fresh_gt_for_pool=_fresh(P, -9.0))
    want = jr.reinsert(jpool, key, jnp.asarray(sel.numpy()),
                       jnp.asarray(new_images), jnp.asarray(new_states),
                       jnp.asarray(dropped.numpy()), _fresh(B, -2.0),
                       _fresh(P, -3.0), 7, keep_prob,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    draws = ReplayedDraws([('keep', torch.from_numpy(np.array(
        jax.random.bernoulli(key, keep_prob, (B,)))))])
    got = tr.reinsert(tpool, draws, sel, torch.from_numpy(new_images),
                      torch.from_numpy(new_states), dropped,
                      torch.from_numpy(_fresh(B, -2.0)),
                      torch.from_numpy(_fresh(P, -3.0)), 7, keep_prob,
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert draws.left() == 0
    for field in ('images', 'states', 'ground_truth'):
        _equal(getattr(got, field), getattr(want, field))
    return got


def test_reinsert_writes_back_and_replaces_dropped():
    jpool, tpool = _pools([3])
    sel, imgs, states, dropped, _ = _select(jpool, tpool, 0)
    pool2 = _reinsert(jpool, tpool, sel, imgs, states, dropped, 1, 1)
    for idx in sel.tolist():
        assert pool2.images[idx].mean() >= 99.0
        assert pool2.states[idx, STATE_STEP_DIM] == 1
    for idx in np.nonzero(dropped.numpy())[0]:
        assert pool2.images[idx].mean() == -3.0
        assert pool2.states[idx, STATE_STEP_DIM] == 0


def test_reinsert_overlength_thinning():
    jpool, tpool = _pools()
    sel = torch.arange(B)
    over = torch.zeros((B, D))
    over[:, STATE_STEP_DIM] = 8.0 - 1       # the helper adds 1: past 7
    keeps = []
    for seed in range(12):
        pool2 = _reinsert(jpool, tpool, sel, torch.zeros((B, S, S, 3)),
                          over, torch.zeros((P,), dtype=torch.bool), 1,
                          seed)
        keeps.append((pool2.images[:B].reshape(B, -1).mean(1) == 100.0)
                     .float().mean().item())
    assert 0.2 < np.mean(keeps) < 0.8


@pytest.mark.parametrize('finished', [(2, 7, 19), ()])
def test_sample_terminated_matches_jax(finished):
    jpool, tpool = _pools(finished)
    key = jax.random.PRNGKey(0)
    want_imgs, want_idx = jr.sample_terminated(jpool, key, 16)
    logits = jnp.where(jpool.terminated_mask(), 0.0, -1e9)
    draws = ReplayedDraws([('terminated', torch.from_numpy(np.array(
        jax.random.categorical(key, logits, shape=(16,)))).long())])
    imgs, idx = tr.sample_terminated(tpool, draws, 16)
    _equal(idx, want_idx)
    _equal(imgs, want_imgs)
    if finished:
        assert set(idx.tolist()) <= set(finished)
    else:
        # JAX's draw over all -1e9 logits: the Gumbel noise is lost in
        # float32 rounding and every draw is slot 0
        assert idx.tolist() == [0] * 16


def test_port_draws_sample_terminated_and_fall_back():
    draws = Draws(torch.Generator().manual_seed(0))
    _, tpool = _pools((2, 7, 19))
    _, idx = tr.sample_terminated(tpool, draws, 600)
    counts = np.bincount(idx.numpy(), minlength=P)
    assert set(np.nonzero(counts)[0].tolist()) == {2, 7, 19}
    assert counts[[2, 7, 19]].min() > 150          # about 200 each
    _, empty = _pools()
    _, idx = tr.sample_terminated(empty, draws, 16)  # no raise
    assert idx.tolist() == [0] * 16


def test_pool_metrics():
    _, tpool = _pools((1, 4))
    assert tpool.terminated_mask().sum() == 2
    assert float(tpool.average_trajectory()) == 10.0 / P
    created = tr.PoolState.create(torch.zeros((P, S, S, 3)), D)
    assert created.states.shape == (P, D) and not created.states.any()
