"""Shared pieces of the training tests of the port (``test_torch_*.py``):
the two packages' models and states on the same weights, and the JAX
outer step's random draws reproduced from its keys (``JaxDraws``).

The draws follow ``exposure_tpu/core/steps.py::build_outer_step`` on a
1-device mesh: the step key is folded with the axis index 0, then the
generator keys are ``split(fold_in(key, 1), giters)``, each split in 6
(``k_sel, k_f1, k_f2, k_f3, k_step, k_keep``), a sampler key in 4 (idx,
ox, oy, flip), the agent step's key in 2 (dropout, noise); the critic keys
are ``split(fold_in(key, 2), citers)``, each split in 3 (real, fake,
alpha).  They are listed in the order the port makes them."""

import ctypes
import fcntl
import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from exposure_tpu.core.trainer import build_models as j_build_models
from exposure_tpu.core.trainer import init_train_state as j_init_train_state
from exposure_tpu.utils import load_config as j_load_config
from exposure_tpu_torch.core.checkpoint import state_from_flax
from exposure_tpu_torch.core.train_state import init_train_state
from exposure_tpu_torch.models.networks import build_models
from exposure_tpu_torch.utils.config import load_config as t_load_config
from exposure_tpu_torch.utils.draws import ReplayedDraws


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_jax_native():
    subprocess.check_call([sys.executable, '-m', 'exposure_tpu.native.build'],
                          cwd=REPO)


@pytest.fixture(scope='module')
def jax_native_built():
    """The JAX package's ``native`` module with ``libhostloader.so`` built
    and loadable, whatever order the suite's workers run the tests in: the
    build runs under an exclusive lock on a file in the temp dir, only when
    the library is missing, and once more when the file there does not
    load (another process's unlocked build may have been writing it)."""
    from exposure_tpu import native
    lock_path = os.path.join(tempfile.gettempdir(),
                             'exposure_tpu-libhostloader.lock')
    with open(lock_path, 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not native.library_available():
                _build_jax_native()
            try:
                ctypes.CDLL(native._LIB_PATH)
            except OSError:
                _build_jax_native()
                ctypes.CDLL(native._LIB_PATH)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return native


@pytest.fixture(scope='module')
def few_threads():
    """Two torch threads for a module's tests: a training step is
    thousands of small operations, and with the suite's worker processes
    each running all the cores' threads they wait on each other (the
    trainer's three iterations took 106 s so, 8 s on two threads)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def configs(name='test', **knobs):
    """The named config of both packages with ``knobs`` set on both."""
    jcfg, tcfg = j_load_config(name), t_load_config(name)
    for k, v in knobs.items():
        jcfg[k] = v
        tcfg[k] = v
    return jcfg, tcfg


def host_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch_state(jstate, tstate):
    """The JAX ``TrainState`` as the port's, through the checkpoint map."""
    return state_from_flax(serialization.to_state_dict(host_tree(jstate)),
                           tstate)


def models(jcfg, tcfg, seed=0):
    """``(j_models, jstate, tx, t_models, tstate)``: the JAX state from its
    own init, carried over to the port's modules."""
    j_models = j_build_models(jcfg)
    jstate, tx = j_init_train_state(jcfg, *j_models[1:], seed)
    t_models = build_models(tcfg)
    tstate = to_torch_state(jstate, init_train_state(tcfg, *t_models[1:]))
    return j_models, jstate, tx, t_models, tstate


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def sampler_draws(key, n, pack_shape, meta):
    """``sample_batch``'s draws: idx, crop offsets when it crops, flip."""
    size, augment = meta
    _, h, w, _ = pack_shape
    k_idx, k_ox, k_oy, k_flip = jax.random.split(key, 4)
    out = [('idx', _t(jax.random.randint(k_idx, (n,), 0, pack_shape[0]),
                      torch.int64))]
    if augment:
        if h > size or w > size:
            out.append(('crop_x', _t(jax.random.randint(
                k_ox, (n,), 0, h - size + 1), torch.int64)))
            out.append(('crop_y', _t(jax.random.randint(
                k_oy, (n,), 0, w - size + 1), torch.int64)))
        out.append(('flip', _t(jax.random.bernoulli(k_flip, 0.5, (n,)))))
    return out


def _categorical(key, logits, n):
    return _t(jax.random.categorical(key, jnp.asarray(logits.cpu().numpy()),
                                     shape=(n,)), torch.int64)


class JaxDraws(ReplayedDraws):
    """``ReplayedDraws`` of ``step_draws``' list, whose ``terminated`` draws
    are made when the port asks for them: ``jax.random.categorical`` from
    the JAX key over the logits the port hands in (they read the pool as
    the generator phase left it)."""

    def categorical(self, name, logits, n):
        if self._queue and callable(self._queue[0][1]):
            want, make = self._queue.popleft()
            self._queue.appendleft((want, make(logits, n)))
        return super().categorical(name, logits, n)


def gumbel_draw(key, n, k):
    """``jax.random.categorical(key, logits, shape=(n,))`` over [k] float32
    logits is ``argmax(gumbel + logits)`` with this [n, k] noise, which
    does not depend on the logits: a process without JAX replays the draw
    from it (``torch_parallel_workers.GumbelDraws``)."""
    return ('gumbel', np.asarray(jax.random.gumbel(key, (n, k), jnp.float32)))


def step_draws(key, cfg, giters, citers, fake_shape, fake_meta, real_shape,
               real_meta, axis=0, batch=None, pool=None, gumbel=False):
    """Every draw of one JAX outer step, in the port's order, for
    ``JaxDraws``: those of device ``axis`` of the mesh (the step key folded
    with it), whose shards hold ``batch`` crops an update (default the
    config's), ``pool`` pool slots and ``fake_shape``/``real_shape`` pack
    rows.  ``gumbel``: the ``terminated`` draws as their Gumbel noise
    (``gumbel_draw``), not as calls into JAX."""
    b = cfg.batch_size if batch is None else batch
    p = cfg.replay_memory_size if pool is None else pool
    key = jax.random.fold_in(key, axis)
    out = []
    for k in jax.random.split(jax.random.fold_in(key, 1), giters):
        k_sel, k_f1, k_f2, k_f3, k_step, k_keep = jax.random.split(k, 6)
        for kf, n in ((k_f1, b), (k_f2, b), (k_f3, p)):
            out += sampler_draws(kf, n, fake_shape, fake_meta)
        out.append(('rank', _t(jax.random.uniform(k_sel, (p,)))))
        _, k_noise = jax.random.split(k_step)
        out.append(('noise', _t(jax.random.uniform(k_noise, (b, 1)))))
        out.append(('keep', _t(jax.random.bernoulli(
            k_keep, cfg.over_length_keep_prob, (b,)))))
    for k in (jax.random.split(jax.random.fold_in(key, 2), citers)
              if citers else []):
        k_real, k_fake, k_gp = jax.random.split(k, 3)
        out += sampler_draws(k_real, b, real_shape, real_meta)
        out.append(('terminated', gumbel_draw(k_fake, b, p) if gumbel else
                     functools.partial(_categorical, k_fake)))
        out.append(('alpha', _t(jax.random.uniform(k_gp, (b, 1, 1, 1)))))
    return out


def stream_draws(key, cfg, giters, citers):
    """Every draw of one JAX streaming step, in the port's order: per
    generator update ``split(k, 3)`` (rank, the agent step's noise, keep),
    per critic update ``split(k, 2)`` (terminated, alpha)."""
    b, p = cfg.batch_size, cfg.replay_memory_size
    key = jax.random.fold_in(key, 0)
    out = []
    for k in jax.random.split(jax.random.fold_in(key, 1), giters):
        k_sel, k_step, k_keep = jax.random.split(k, 3)
        out.append(('rank', _t(jax.random.uniform(k_sel, (p,)))))
        _, k_noise = jax.random.split(k_step)
        out.append(('noise', _t(jax.random.uniform(k_noise, (b, 1)))))
        out.append(('keep', _t(jax.random.bernoulli(
            k_keep, cfg.over_length_keep_prob, (b,)))))
    for k in (jax.random.split(jax.random.fold_in(key, 2), citers)
              if citers else []):
        k_fake, k_gp = jax.random.split(k, 2)
        out.append(('terminated', lambda logits, n, k=k_fake:
                    _categorical(k, logits, n)))
        out.append(('alpha', _t(jax.random.uniform(k_gp, (b, 1, 1, 1)))))
    return out


def tree_max_abs(a, b):
    """``{name: max |a - b|}`` over two state_dicts."""
    return {k: float((a[k] - b[k]).abs().max()) for k in a}


# --- the two-rank tests (tests/test_torch_parallel_*.py) ------------------
def numpy_draws(draws):
    """A draw list as numpy, for a spawned rank's
    ``torch_parallel_workers.GumbelDraws``."""
    return [(name, v if isinstance(v, tuple) else v.numpy())
            for name, v in draws]


def check_rank_metrics(j_metrics, ranks):
    """Every rank's metrics against the JAX step's (its ``pmean``-ed
    ones): rtol 1e-4; NaN where a phase ran no update."""
    for rank in ranks:
        for (field, want), got in zip(j_metrics._asdict().items(),
                                      rank['metrics']):
            if np.isnan(float(want)):
                assert np.isnan(got), field
                continue
            np.testing.assert_allclose(got, float(want), rtol=1e-4,
                                       atol=1e-6, err_msg=field)


def check_rank_states(t0, j_state, ranks, lr):
    """Every rank's state against the JAX step's: the parameters within 3
    lr, Adam's moments within 1e-4 of the largest of their tree (rtol
    1e-3) and their counts, the EMA (rtol 1e-4) and its count."""
    want = to_torch_state(j_state, t0)
    for rank in ranks:
        got = state_from_flax(rank['state'], t0)
        for tree in ('gen_params', 'val_params', 'crit_params'):
            worst = max(tree_max_abs(getattr(got, tree),
                                     getattr(want, tree)).values())
            assert worst <= 3 * lr, (tree, worst / lr)
        for opt in ('opt_g', 'opt_v', 'opt_c'):
            a, b = getattr(got, opt), getattr(want, opt)
            assert a.count == b.count, opt
            for moment in ('mu', 'nu'):
                ma, mb = getattr(a, moment), getattr(b, moment)
                scale = max(float(v.abs().max()) for v in mb.values())
                for k in mb:
                    np.testing.assert_allclose(
                        ma[k].numpy(), mb[k].numpy(), rtol=1e-3,
                        atol=1e-4 * scale,
                        err_msg='%s %s %s' % (opt, moment, k))
        assert got.ema.count == want.ema.count
        np.testing.assert_allclose(float(got.ema.biased),
                                   float(want.ema.biased), rtol=1e-4,
                                   atol=1e-9)


def check_rank_pools(j_pool, ranks):
    """Rank r's pool against rows ``[r * n / w, (r + 1) * n / w)`` of the
    JAX pool: states and ground truth equal, images within 1e-5."""
    n = j_pool.images.shape[0] // len(ranks)
    for r, rank in enumerate(ranks):
        images, states, gt = rank['pool']
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_array_equal(states, np.asarray(j_pool.states)[rows])
        np.testing.assert_allclose(images, np.asarray(j_pool.images)[rows],
                                   atol=1e-5)
        if j_pool.ground_truth is not None:
            np.testing.assert_array_equal(
                gt, np.asarray(j_pool.ground_truth)[rows])


def check_ranks_equal(ranks):
    """Every rank holds rank 0's state tensors and metrics, bit for bit."""
    for rank in ranks[1:]:
        assert rank['tensors'].keys() == ranks[0]['tensors'].keys()
        for k, v in ranks[0]['tensors'].items():
            np.testing.assert_array_equal(rank['tensors'][k], v, err_msg=k)
        np.testing.assert_array_equal(rank['metrics'], ranks[0]['metrics'])


@pytest.fixture
def dropout_off(monkeypatch):
    """``load_config`` of both packages with ``dropout_keep_prob`` 1.0,
    where the research probes look it up (the JAX ``probe_critic_family``
    and ``select_policy`` import it at module level)."""
    import exposure_tpu.utils.config as jconf
    import exposure_tpu_torch.utils.config as tconf
    from exposure_tpu.tools import probe_critic_family, select_policy

    def off(real):
        def load(name):
            cfg = real(name)
            cfg.dropout_keep_prob = 1.0
            return cfg
        return load
    j_load, t_load = off(jconf.load_config), off(tconf.load_config)
    monkeypatch.setattr(jconf, 'load_config', j_load)
    monkeypatch.setattr(tconf, 'load_config', t_load)
    for mod in (probe_critic_family, select_policy):
        monkeypatch.setattr(mod, 'load_config', j_load)
    return j_load, t_load
