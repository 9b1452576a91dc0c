"""What the ranks of the two-process tests (``tests/test_torch_parallel_*.py``)
run.  The ranks are spawned processes (``parallel/launch.py``): they
import this module, which imports no JAX and nothing of the JAX package,
and each asserts at its end that JAX was not imported.  The JAX side of a
test runs in the test process and hands the ranks numpy arrays: inputs,
flax state trees and each rank's replayed draws (``GumbelDraws``).
"""

import os

import numpy as np
import torch

from exposure_tpu_torch.core.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    state_from_flax,
    state_to_flax,
)
from exposure_tpu_torch.core.replay import PoolState
from exposure_tpu_torch.core.steps import (
    build_outer_step,
    build_streaming_outer_step,
)
from exposure_tpu_torch.core.train_state import init_train_state
from exposure_tpu_torch.models.networks import build_models
from exposure_tpu_torch.parallel.mesh import digest
from exposure_tpu_torch.utils.config import load_config
from exposure_tpu_torch.utils.draws import Draws, ReplayedDraws


class GumbelDraws(ReplayedDraws):
    """``ReplayedDraws`` of numpy draws, whose ``terminated`` draws come as
    ``('gumbel', noise [n, K])``: ``argmax(noise + logits)`` over the
    logits the port hands in, which is ``jax.random.categorical``'s draw."""

    def __init__(self, log, device='cpu'):
        super().__init__([(name, v if isinstance(v, tuple)
                           else torch.from_numpy(np.asarray(v)))
                          for name, v in log], device)

    def categorical(self, name, logits, n):
        want, value = self._queue[0]
        if isinstance(value, tuple):
            self._queue.popleft()
            if want != name or value[1].shape != (n, logits.shape[0]):
                raise ValueError('draw %r %s asked for, %r %s is next'
                                 % (name, (n,), want, value[1].shape))
            noise = torch.from_numpy(value[1]).to(logits.device)
            return torch.argmax(noise + logits, dim=1)
        return super().categorical(name, logits, n)


def config(knobs):
    cfg = load_config('test')
    cfg.update(knobs)
    return cfg


def models_and_state(cfg, tree=None, seed=0):
    """The port's modules of ``cfg`` and a state: ``tree`` (a flax state
    dict) restored onto the init of ``seed``, or that init."""
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, seed=seed)
    if tree is not None:
        state = state_from_flax(tree, state)
    return (filters, policy, critic, value), state


def _shard(mesh, x, axis=0):
    return None if x is None else mesh.shard(torch.from_numpy(x),
                                             axis).to(mesh.device)


def _pool(mesh, images, states, gt):
    return PoolState(images=_shard(mesh, images), states=_shard(mesh, states),
                     ground_truth=_shard(mesh, gt))


def _numpy(x):
    return None if x is None else x.detach().cpu().numpy()


def _result(state, pool, metrics):
    return {'state': state_to_flax(state),
            'tensors': {k: _numpy(v) for k, v in state.tensors().items()},
            'pool': (_numpy(pool.images), _numpy(pool.states),
                     _numpy(pool.ground_truth)),
            'metrics': [float(v) for v in metrics]}


def step_rank(mesh, job):
    """One outer step (``job['kind']``: ``resident`` or ``streaming``) of
    the ``test`` config with ``job['knobs']`` on this rank's shards of the
    job's arrays, from its flax state, on its rank's replayed draws
    (``job['draws'][rank]``; a Draws from ``job['seed']`` when None), on
    the mesh's device.  Returns the state, the pool shard and the metrics
    as numpy."""
    cfg = config(job['knobs'])
    nets, state = models_and_state(cfg, job.get('state'))
    state = state.to(mesh.device)
    filters, policy, critic, value = nets
    pool = _pool(mesh, *job['pool'])
    draws_log = job['draws'][mesh.rank] if job.get('draws') else None
    draws = GumbelDraws(draws_log, mesh.device) if draws_log is not None \
        else Draws(torch.Generator(mesh.device).manual_seed(
            job['seed'] + mesh.rank), mesh.device)
    giters, citers = job['giters'], job['citers']
    step_mesh = mesh if job.get('use_mesh', True) else None
    if job['kind'] == 'resident':
        meta = job['meta']
        step = build_outer_step(cfg, policy, critic, value, filters, meta,
                                meta, giters, citers, mesh=step_mesh)
        data = [_shard(mesh, x) for x in job['data']]
    else:
        step = build_streaming_outer_step(cfg, policy, critic, value,
                                          filters, giters, citers,
                                          mesh=step_mesh)
        data = [_shard(mesh, x, axis=1) for x in job['data']]
    out = step(state, pool, *data, draws, *job['rates'])
    if draws_log is not None and draws.left():
        raise AssertionError('%d draws left over' % draws.left())
    return _result(*out)


def resume_rank(mesh, job):
    """Resume under the ranks: a first step, then the next from its state
    and from that state saved by rank 0 and restored by every rank onto
    another seed's init; and the JAX checkpoint in ``job['jax_dir']``
    restored.  Returns whether the two next steps agree bit for bit, the
    saved state and the restored JAX one (flax trees)."""
    cfg = config(job['knobs'])
    nets, state = models_and_state(cfg)
    filters, policy, critic, value = nets
    meta = (64, True)
    step = build_outer_step(cfg, policy, critic, value, filters, meta, meta,
                            job['giters'], job['citers'], mesh=mesh)
    data = [_shard(mesh, x) for x in job['data']]

    def run(st, seed):
        draws = Draws(torch.Generator().manual_seed(seed + 7 * mesh.rank))
        return step(st, _pool(mesh, *job['pool']), *data, draws,
                    *job['rates'])

    first, _, _ = run(state, 1)
    cont_a = run(first, 2)
    if mesh.rank == 0:
        save_checkpoint(job['dir'], first, 5)
    mesh.barrier()
    _, template = models_and_state(cfg, seed=1)
    restored, got = restore_checkpoint(job['dir'], template)
    cont_b = run(restored, 2)
    equal = got == 5 and all(
        torch.equal(a, b) for a, b in zip(
            list(cont_a[0].tensors().values()) + [cont_a[1].images,
                                                  cont_a[1].states],
            list(cont_b[0].tensors().values()) + [cont_b[1].images,
                                                  cont_b[1].states])) and \
        torch.equal(torch.stack(list(cont_a[2])), torch.stack(list(cont_b[2])))
    from_jax, _ = restore_checkpoint(job['jax_dir'], template)
    return {'equal': equal, 'saved': state_to_flax(first),
            'from_jax': state_to_flax(from_jax),
            'digest': digest(*cont_b[0].tensors().values())}


def trainer_rank(mesh, job):
    """``Trainer(num_devices=world)`` runs of the ``test`` config with
    ``job['knobs']``, one a name of ``job['runs']``, each through
    ``job['last_iter']`` into ``job['root']``.  Each rank seeds ``random``
    apart first: the trainer must seed the providers alike.  Returns each
    run's state tensors, pool shard and last metrics."""
    import random
    from exposure_tpu_torch.core.trainer import Trainer
    out = {}
    for run in job['runs']:
        cfg = config(job['knobs'])
        cfg.name = 'parallel/' + run
        random.seed(1000 + mesh.rank)
        trainer = Trainer(cfg, num_devices=mesh.world, model_root=job['root'],
                          device=job.get('device', 'cpu'))
        try:
            metrics = trainer.train(last_iter=job['last_iter'])
        finally:
            trainer.close()
        out[run] = {'tensors': {k: _numpy(v) for k, v in
                                trainer.state.tensors().items()},
                    'pool': _numpy(trainer.pool.images),
                    'metrics': list(metrics), 'step': trainer.state.step,
                    'streaming': trainer.streaming}
    return out


def fused_and_plain(trainer, it, chunk):
    """Iterations ``it .. it + chunk - 1`` from ``trainer``'s state and pool
    through its fused step (``Trainer._run_fused``), then again through
    ``run_iteration`` from the same state and pool: ``(fused, plain)``, each
    ``(state, pool, metrics [chunk, 7])``."""
    from exposure_tpu_torch.core.fused import clone_pool
    state, pool = trainer.state.clone(), clone_pool(trainer.pool)
    _, metrics = trainer._run_fused(it, chunk)
    fused = (trainer.state.clone(), clone_pool(trainer.pool), metrics.clone())
    trainer.state, trainer.pool = state, pool
    rows = [torch.stack(list(trainer.run_iteration(j, trainer._generator)[1]))
            for j in range(it, it + chunk)]
    return fused, (trainer.state, trainer.pool, torch.stack(rows))


def differing(a, b):
    """What differs between two ``(state, pool, metrics)``: tensor paths,
    ``counts`` (Adam's, the EMA's, the step), ``pool``, ``metrics``."""
    ta, tb = a[0].tensors(), b[0].tensors()
    out = [k for k in tb if not torch.equal(ta[k], tb[k])]

    def counts(st):
        return (st.opt_g.count, st.opt_v.count, st.opt_c.count, st.ema.count,
                st.step)
    if counts(a[0]) != counts(b[0]):
        out.append('counts')
    if not (torch.equal(a[1].images, b[1].images) and
            torch.equal(a[1].states, b[1].states)):
        out.append('pool')
    if not torch.equal(a[2], b[2]):
        out.append('metrics')
    return out


def fused_rank(mesh, job):
    """A ``Trainer(num_devices=world)`` of ``test`` through iteration 0,
    then ``fused_and_plain`` over iterations 1 .. ``job['chunk']``: what
    differs, and the iterations' metrics."""
    import random
    from exposure_tpu_torch.core.trainer import Trainer
    cfg = config(job.get('knobs', {}))
    cfg.name = 'parallel/fused'
    random.seed(0)
    trainer = Trainer(cfg, num_devices=mesh.world, model_root=job['root'],
                      device='cpu')
    try:
        trainer.train(last_iter=0)
        fused, plain = fused_and_plain(trainer, 1, job['chunk'])
    finally:
        trainer.close()
    return {'differing': differing(fused, plain),
            'metrics': _numpy(fused[2])}


def hang(mesh):
    """Rank 1 never reaches the barrier rank 0 waits at."""
    import time
    if mesh.rank == 1:
        time.sleep(600)
    mesh.barrier()


def listing(root):
    """Every file under ``root``, relative."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)
