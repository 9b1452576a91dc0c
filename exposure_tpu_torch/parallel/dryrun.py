"""The multi-GPU dry run: ``dryrun_multigpu(n)``, the counterpart of the
JAX ``__graft_entry__.py::dryrun_multichip``.

It spawns a world of ``n`` ranks (``parallel/launch.py``) and runs on each,
with the JAX dry run's tiny ``test`` shapes (batch 2n, pool 4n):

1. the resident outer step (giters 2, citers 2) on the rank's shards of
   the packs and the pool, with the state bit-identical across ranks
   afterwards (an all-gathered digest) and the metrics finite;
2. one streaming step on the rank's shard of a bundle along axis 1;
2b. the fused entries (``core/fused.py``): 3 iterations (5-7, giters 1,
   citers 2, lr 1e-4, progress 0.1 to 0.2) through
   ``build_fused_iterations_step``, and 2 streaming iterations (giters 1,
   citers 1) on stacked bundles sharded along axis 2 through
   ``build_streaming_fused_step``; their metrics stacked one row an
   iteration and finite, the state equal across ranks after each.  On the
   CPU the fused body runs eagerly; on the card it is captured, which a
   ``gloo`` group cannot be (``Mesh.check_capturable``): there the two
   entries are not run, and the summary line says so with the error;
3. resume: rank 0 saves a checkpoint, every rank restores it onto a
   template from another seed, and the step from the restored state equals
   the step from the saved one bit for bit;
4. the pad path: a pack whose rows do not divide the world, padded by
   ``pad_to_devices`` (rows wrap around), sharded and stepped;
5. sharded serving, each rank serving its shard of a u8 batch with a
   generator folded with its rank (``batch_generator(seed, rank)``): the
   bank rollout plus K2; the dynamic selected plan plus K1 (a
   ``RetouchPipeline``, exact branch set); the bank plan grouped plus K3;
   a planted superset layout (a covered slot, an overflowing slot, a
   missing signature, an empty slot) plus K3 and the K2 merge; and
   ``map_batches`` with auto-superset.  The dynamic, grouped and superset
   outputs are held to the plain chain (``ops/chain.py``) within the JAX
   dry run's bound, 2 LSB; rank 0 gathers the dynamic outputs and holds
   them to a one-process ``RetouchPipeline`` run on each rank's shard
   with that rank's generator (1 LSB).

The chain kernels' launches in the serving part are counted on each rank
(``kernels.launch_counts``; on the CPU the wrappers run their plain
versions and count none).  It prints the JAX dry run's summary line and
returns a dict of what it found.

    python -m exposure_tpu_torch.parallel.dryrun 2 --device cpu
"""

import argparse
import gc
import os
import shutil
import tempfile

import numpy as np
import torch

from exposure_tpu_torch import kernels
from exposure_tpu_torch.parallel.launch import spawn_ranks
from exposure_tpu_torch.parallel.mesh import digest, pad_to_devices

LSB_BOUND = 2           # the JAX dry run's bound against the plain chain
ARTIFACT_CONFIG = 'synthetic_explore'   # the config of the in-repo artifact
PIPELINE_LSB_BOUND = 1  # the gathered output against one process's
SERVE_SEED = 2
CHAIN_KERNELS = ('dyn_chain', 'static_chain', 'switch_chain')


def _finite(metrics, what):
    for name, v in metrics._asdict().items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError('%s metric %s is not finite' % (what, name))


def _state_digest(state, pool=None):
    tensors = state.tensors()
    parts = [tensors[k] for k in sorted(tensors)]
    if pool is not None:
        parts.append(pool.images)
    return digest(*parts)


def _draws(seed, mesh):
    from exposure_tpu_torch.core.trainer import iteration_seed
    from exposure_tpu_torch.utils.draws import Draws
    g = torch.Generator(device=mesh.device)
    g.manual_seed(iteration_seed(seed, 0, mesh.rank))
    return Draws(g, mesh.device)


def _copy(pool):
    from exposure_tpu_torch.core.replay import PoolState
    return PoolState(images=pool.images.clone(), states=pool.states.clone(),
                     ground_truth=None)


def _u8(x):
    return torch.round(torch.clamp(x, 0, 1) * 255).to(torch.uint8)


def _lsb(got, want):
    return int((got.int() - want.int()).abs().max()) if got.numel() else 0


def _plain(images, ids, params, filters, mask, rows=32):
    """The plain chain on a u8 batch, rounded back to u8, ``rows`` images
    at a time (the branchless chain holds every filter's output of its
    rows: 6 GiB for 256 images of 512x512)."""
    from exposure_tpu_torch.ops.chain import apply_filter_chain
    out = []
    for i in range(0, images.shape[0], rows):
        part = slice(i, i + rows)
        out.append(_u8(apply_filter_chain(
            images[part].to(torch.float32) * (1.0 / 255.0), ids[:, part],
            params[:, part], filters,
            mask_params=None if mask is None else mask[:, part])))
    return torch.cat(out)


def _planted(local_b, k_steps, n_filters):
    """The JAX dry run's superset plan on a rank's ``local_b`` rows: half
    of them one signature (its slot covers them), a quarter another (its
    slot holds half of them: the rest overflow into the merge, at any
    batch), the rest a third that the layout lacks, and an empty slot of a
    fourth."""
    from exposure_tpu_torch.ops.grouped_chain import bucket_size

    def sig(a, b):
        return tuple([a, b] * ((k_steps + 1) // 2))[:k_steps]
    sig_a, sig_b, sig_c = sig(0, 1), sig(2, 0), sig(1, 2)
    sig_unused = tuple([3 % n_filters] * k_steps)
    n_a = max(2, local_b // 2)
    n_b = max(2, local_b // 4)
    ids = np.empty((k_steps, local_b), np.int32)
    for i in range(local_b):
        ids[:, i] = sig_a if i < n_a else (sig_b if i < n_a + n_b else sig_c)
    layout = ((sig_a, bucket_size(n_a)),
              (sig_b, max(1, n_b // 2)),
              (sig_unused, 2))
    merge = bucket_size(local_b - n_a - n_b + max(0, n_b - layout[1][1]))
    return ids, layout, merge


def _train_part(mesh, out, work_dir):
    """Steps 1-4 on the ``test`` config; returns the state the serving
    part starts from when it serves the trained ``test`` policy."""
    from exposure_tpu_torch.core.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from exposure_tpu_torch.core.replay import PoolState
    from exposure_tpu_torch.core.steps import (
        build_outer_step,
        build_streaming_outer_step,
    )
    from exposure_tpu_torch.core.train_state import init_train_state
    from exposure_tpu_torch.models.networks import build_models
    from exposure_tpu_torch.utils.config import load_config
    from exposure_tpu_torch.utils.ops import deterministic_algorithms
    n, dev = mesh.world, mesh.device
    cfg = load_config('test')
    cfg.batch_size = 2 * n
    cfg.replay_memory_size = 4 * n
    filters, policy, critic, value = build_models(cfg)
    state = init_train_state(cfg, policy, critic, value, seed=0, device=dev)

    rng = np.random.RandomState(0)

    def shard(x, axis=0):
        return mesh.shard(torch.from_numpy(np.asarray(x, np.float32)),
                          axis).to(dev)
    fake = shard(rng.rand(4 * n, 80, 80, 3))
    real = shard(rng.rand(4 * n, 64, 64, 3))
    pool = PoolState.create(shard(rng.rand(cfg.replay_memory_size, 64, 64,
                                           3)), cfg.num_state_dim)
    meta = (64, True)
    step = build_outer_step(cfg, policy, critic, value, filters, meta, meta,
                            giters=2, citers=2, mesh=mesh)
    lr = 1e-4
    state2, pool2, metrics = step(state, _copy(pool), fake, real,
                                  _draws(0, mesh), lr, lr, 0.0)
    _finite(metrics, 'resident')
    if not mesh.all_equal(_state_digest(state2)):
        raise AssertionError('the state differs across ranks after the '
                             'resident step')
    out.update(g_loss=float(metrics.g_loss), emd=float(metrics.emd))

    s_step = build_streaming_outer_step(cfg, policy, critic, value, filters,
                                        giters=1, citers=1, mesh=mesh)
    chunk = 2 * cfg.batch_size + cfg.replay_memory_size
    g_fresh = shard(rng.rand(1, chunk, 64, 64, 3), axis=1)
    reals = shard(rng.rand(1, cfg.batch_size, 64, 64, 3), axis=1)
    state3, pool3, m3 = s_step(state2, _copy(pool2), g_fresh, reals,
                               _draws(1, mesh), lr, lr, 0.5)
    _finite(m3, 'streaming')
    if not mesh.all_equal(_state_digest(state3)):
        raise AssertionError('the state differs across ranks after the '
                             'streaming step')
    out['streaming_g_loss'] = float(m3.g_loss)
    _fused_part(mesh, out, cfg, (policy, critic, value, filters), state3,
                pool3, fake, real, rng, lr)

    # resume: rank 0 saves, every rank restores onto another seed's state
    # (deterministic algorithms: the card's defaults may add in another
    # order from one call to the next)
    with deterministic_algorithms():
        cont_a = step(state2, _copy(pool2), fake, real, _draws(7, mesh), lr,
                      lr, 0.5)
    if mesh.rank == 0:
        save_checkpoint(work_dir, state2, 123)
    mesh.barrier()
    template = init_train_state(cfg, policy, critic, value, seed=1,
                                device=dev)
    restored, got_step = restore_checkpoint(work_dir, template)
    with deterministic_algorithms():
        cont_b = step(restored, _copy(pool2), fake, real, _draws(7, mesh),
                      lr, lr, 0.5)
    equal = got_step == 123 and \
        _state_digest(cont_a[0], cont_a[1]) == \
        _state_digest(cont_b[0], cont_b[1]) and \
        torch.equal(torch.stack(list(cont_a[2])),
                    torch.stack(list(cont_b[2])))
    out['resume_equal'] = mesh.all_true(equal)
    if not out['resume_equal']:
        raise AssertionError('the resumed step differs from the saved one')

    # the pad path: rows that do not divide the world wrap around
    n_odd = 4 * n - 3
    odd = rng.rand(n_odd, 80, 80, 3).astype(np.float32)
    padded = pad_to_devices(odd, n)
    pad_ok = padded.shape[0] % n == 0 and np.array_equal(
        padded[n_odd:], odd[:padded.shape[0] - n_odd])
    _, _, m_p = step(state2, _copy(pool2), shard(padded), real,
                     _draws(9, mesh), lr, lr, 0.5)
    _finite(m_p, 'pad')
    out['pad_ok'] = mesh.all_true(pad_ok)
    return cfg, policy, state3


FUSED_ITERS = (5, 6, 7)     # the JAX dry run's fused entry
STREAM_FUSED_ITERS = (0, 1)


def _fused_part(mesh, out, cfg, nets, state, pool, fake, real, rng, lr):
    """The JAX dry run's two fused entries, from the streaming step's state
    and pool: ``out['fused_g_loss']`` and ``out['stream_fused_g_loss']``
    (each iteration's), or ``out['fused_not_run']`` with the reason when
    this rank's group cannot be captured."""
    from exposure_tpu_torch.core.steps import (
        build_fused_iterations_step,
        build_streaming_fused_step,
    )
    from exposure_tpu_torch.core.trainer import iteration_seed
    from exposure_tpu_torch.utils.draws import Draws
    try:
        mesh.check_capturable()
    except ValueError as e:
        out['fused_not_run'] = str(e)
        return
    dev = mesh.device
    generator = torch.Generator(device=dev)

    def draws_for(seed):
        def draws(it):
            generator.manual_seed(iteration_seed(seed, it, mesh.rank))
            return Draws(generator, dev)
        return draws

    def check(metrics, n, what, state):
        if tuple(metrics.shape) != (n, 7) or \
                not bool(torch.isfinite(metrics).all()):
            raise AssertionError('%s metrics %s, finite %s' % (
                what, tuple(metrics.shape),
                bool(torch.isfinite(metrics).all())))
        if not mesh.all_equal(_state_digest(state)):
            raise AssertionError('the state differs across ranks after the '
                                 '%s entry' % what)
        return [float(v) for v in metrics[:, 0]]    # g_loss, by iteration

    meta = (64, True)
    n = len(FUSED_ITERS)
    runner = build_fused_iterations_step(
        cfg, *nets, meta, meta, 1, 2, draws_for(3), generator, mesh=mesh)
    state4, pool4, m4 = runner.run(
        state, _copy(pool), (fake, real), FUSED_ITERS, [lr] * n, [lr] * n,
        np.linspace(0.1, 0.2, n).astype(np.float32).tolist())
    out['fused_g_loss'] = check(m4, n, 'fused', state4)

    def shard(x):
        return mesh.shard(torch.from_numpy(np.asarray(x, np.float32)),
                          2).to(dev)
    n = len(STREAM_FUSED_ITERS)
    chunk = 2 * cfg.batch_size + cfg.replay_memory_size
    bundle = (shard(rng.rand(n, 1, chunk, 64, 64, 3)),
              shard(rng.rand(n, 1, cfg.batch_size, 64, 64, 3)))
    s_runner = build_streaming_fused_step(cfg, *nets, 1, 1, draws_for(5),
                                          generator, mesh=mesh)
    state5, _, m5 = s_runner.run(state, _copy(pool), bundle,
                                 STREAM_FUSED_ITERS, [lr] * n, [lr] * n,
                                 [0.5] * n)
    out['stream_fused_g_loss'] = check(m5, n, 'streaming fused', state5)
    # free the captured graphs (and their all-reduces) before the rank
    # leaves the process group
    del runner, s_runner, state4, pool4, state5
    gc.collect()


def _serve_part(mesh, out, settings, trained):
    from exposure_tpu_torch.core.rollout import rollout
    from exposure_tpu_torch.core.serving import (
        RetouchPipeline,
        batch_generator,
        proxy_resize,
    )
    from exposure_tpu_torch.ops.filters import build_filters
    from exposure_tpu_torch.ops.grouped_chain import GroupedChainRunner
    from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
    n, dev, rank = mesh.world, mesh.device, mesh.rank
    if settings.get('artifact'):
        base = RetouchPipeline.from_artifact(
            ARTIFACT_CONFIG, settings['artifact'], device=dev)
        cfg, policy = base.cfg, base.policy
    else:
        cfg, policy, state = trained
        policy.load_state_dict(state.gen_params)
        policy = policy.to(dev)
    filters = build_filters(cfg)
    masking = bool(cfg.masking)
    s = cfg.source_img_size
    total = settings['serve_batch']
    h, w = settings['serve_hw']
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    full = torch.randint(0, 256, (total, h, w, 3), generator=g,
                         dtype=torch.uint8, device=dev)
    images = mesh.shard(full)
    local_b = images.shape[0]

    def gen():
        return batch_generator(SERVE_SEED, rank, dev)

    def pipeline(**kw):
        return RetouchPipeline(cfg, policy, device=dev, use_kernels=True,
                               **kw)

    def mask_of(m):
        return m if masking else None
    kernels.reset_launch_counts()
    lsb = {}
    with torch.no_grad():
        # the bank rollout and K2
        traj = rollout(policy, proxy_resize(images, s), gen(), cfg=cfg,
                       filters=filters, is_train=0)
        served = apply_filter_chain_switch(
            images, traj.filter_ids, traj.params, filters,
            mask_params=mask_of(traj.mask_params))
        gathered = mesh.gather_rows(served)
        if rank == 0:
            if gathered.dtype != torch.uint8 or \
                    tuple(gathered.shape) != tuple(full.shape):
                raise AssertionError('served %s %s' % (gathered.dtype,
                                                       gathered.shape))
            out['served'] = tuple(gathered.shape)

        # the dynamic selected plan and K1, as the pipeline serves it
        dyn_pipe = pipeline(dynamic=True, fast_math=False)
        ids, params, mask = dyn_pipe.plan(dyn_pipe.proxy(images), gen())
        dyn = dyn_pipe.replay(images, ids, params, mask)
        lsb['dyn'] = _lsb(dyn, _plain(images, ids, params, filters,
                                      mask_of(mask)))

        # the bank plan grouped, and K3
        runner = GroupedChainRunner(filters, max_signatures=10_000)
        grouped = runner(images, traj.filter_ids, traj.params,
                         mask_params=mask_of(traj.mask_params))
        lsb['grouped'] = _lsb(grouped, _plain(
            images, traj.filter_ids, traj.params, filters,
            mask_of(traj.mask_params)))

        # a planted superset layout: K3 slots and the K2 merge
        k_steps = traj.filter_ids.shape[0]
        ids_host, layout, merge = _planted(local_b, k_steps, len(filters))
        mask_p = traj.mask_params.shape[-1]
        runner.warmup_superset(layout, images.shape, images.dtype, k_steps,
                               max_p=traj.params.shape[-1],
                               mask_p=mask_p, merge_sizes=(merge,),
                               device=dev)
        superset = runner.call_superset(
            images, ids_host, traj.params, layout,
            mask_params=mask_of(traj.mask_params))
        route = runner.last_route
        lsb['superset'] = _lsb(superset, _plain(
            images, torch.from_numpy(ids_host).to(dev), traj.params,
            filters, mask_of(traj.mask_params)))
        superset_ok = route['route'] == 'superset' and \
            route['filled_slots'] == 2 and route['merge'] is not None
        out['superset_route'] = route

        # map_batches with auto-superset on the rank's own small batches
        auto = pipeline(auto_superset=True, auto_record_batches=2)
        small_g = torch.Generator(device=dev).manual_seed(100 + rank)
        small = [torch.randint(0, 256, (4, 32, 32, 3), generator=small_g,
                               dtype=torch.uint8, device=dev)
                 for _ in range(4)]
        outs = list(auto.map_batches(small, seed=rank, device_out=True))
        rep = auto.superset_report()
        map_ok = len(outs) == len(small) and all(
            o.shape == x.shape and o.dtype == torch.uint8
            for o, x in zip(outs, small)) and \
            rep['frozen_slots'] is not None and rep['auto']
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        counted = kernels.launch_counts()
        launches = {name: counted[name] for name in CHAIN_KERNELS}

        # rank 0: the gathered dynamic output against one process's
        # pipeline on each rank's shard with that rank's generator
        dyn_all = mesh.gather_rows(dyn)
        if rank == 0:
            one = pipeline(dynamic=True, fast_math=False)
            step = local_b
            want = torch.cat([
                one.replay(full[r * step:(r + 1) * step], *one.plan(
                    one.proxy(full[r * step:(r + 1) * step]),
                    batch_generator(SERVE_SEED, r, dev)))
                for r in range(n)])
            out['pipeline_max_lsb'] = _lsb(dyn_all, want)
    worst = mesh.all_gather(torch.tensor(
        [lsb['dyn'], lsb['grouped'], lsb['superset']], dtype=torch.int64,
        device=dev)).amax(0).tolist()
    out.update(dyn_max_lsb=worst[0], grouped_max_lsb=worst[1],
               superset_max_lsb=worst[2])
    out['dyn_ok'] = worst[0] <= LSB_BOUND
    out['superset_ok'] = mesh.all_true(superset_ok) and \
        worst[2] <= LSB_BOUND
    out['map_batches_ok'] = mesh.all_true(map_ok)
    counts = mesh.all_gather(torch.tensor(
        [launches[k] for k in sorted(launches)], dtype=torch.int64,
        device=dev)).sum(0).tolist()
    out['launches'] = dict(zip(sorted(launches), counts))
    out['launches_by_rank'] = launches
    out['serve_shape'] = [total, h, w, 3]


def dryrun_rank(mesh, settings):
    """The dry run on one rank of ``mesh``; returns what it found (rank
    0's dict holds the gathered results too)."""
    out = {'world': mesh.world, 'rank': mesh.rank,
           'device': str(mesh.device), 'backend': mesh.backend}
    trained = _train_part(mesh, out, settings['work_dir'])
    _serve_part(mesh, out, settings, trained)
    if mesh.rank == 0:
        bad = {k: out[k] for k in ('dyn_max_lsb', 'grouped_max_lsb',
                                   'superset_max_lsb')
               if out[k] > LSB_BOUND}
        if bad or out['pipeline_max_lsb'] > PIPELINE_LSB_BOUND:
            raise AssertionError(
                'sharded serving off the plain chain %s (bound %d) or the '
                'one-process pipeline by %d LSB (bound %d)' % (
                    bad, LSB_BOUND, out['pipeline_max_lsb'],
                    PIPELINE_LSB_BOUND))
        for key in ('resume_equal', 'pad_ok', 'dyn_ok', 'superset_ok',
                    'map_batches_ok'):
            if not out[key]:
                raise AssertionError('dry run: %s is false' % key)
    return out


def summary_line(out):
    """The JAX dry run's summary line.  Where the fused entries could not
    run (a ``gloo`` group on the card), ``fused_g_loss[-1]`` reads
    ``not_run`` and the line ends with the reason."""
    not_run = out.get('fused_not_run')
    fused = 'not_run' if not_run else '%.4f' % out['fused_g_loss'][-1]
    line = ('dryrun_multigpu(%d): ok, g_loss=%.4f emd=%.4f '
            'streaming_g_loss=%.4f fused_g_loss[-1]=%s served=%s '
            'grouped_max_lsb=%d resume_equal=%s pad_ok=%s superset_ok=%s '
            'superset_max_lsb=%d map_batches_ok=%s dyn_ok=%s '
            'dyn_max_lsb=%d' % (
                out['world'], out['g_loss'], out['emd'],
                out['streaming_g_loss'], fused, out['served'],
                out['grouped_max_lsb'], out['resume_equal'], out['pad_ok'],
                out['superset_ok'], out['superset_max_lsb'],
                out['map_batches_ok'], out['dyn_ok'], out['dyn_max_lsb']))
    if not_run:
        line += (' (the fused and streaming fused entries not run: %s)'
                 % not_run)
    return line


def dryrun_multigpu(n_devices, device='cuda', backend=None, serve_batch=None,
                    serve_hw=(96, 128), artifact=None, deadline_s=600,
                    threads=None, work_dir=None):
    """Run the dry run on ``n_devices`` spawned ranks; print its summary
    line and return rank 0's findings.

    ``serve_batch``: the global u8 serving batch (default 4 a rank) at
    ``serve_hw``; ``artifact``: a ``synthetic_explore`` serving artifact
    to serve (default: the policy the dry run's steps trained);
    ``device``/``backend``: as ``data_parallel_mesh`` (two ranks on one
    card: ``gloo``); ``work_dir``: where the rendezvous file and the
    checkpoint go (a temp dir when None)."""
    own = work_dir is None
    work_dir = tempfile.mkdtemp(prefix='dryrun-') if own else work_dir
    ckpt_dir = os.path.join(work_dir, 'ckpt')
    os.makedirs(ckpt_dir, exist_ok=True)
    settings = dict(work_dir=ckpt_dir, serve_hw=tuple(serve_hw),
                    serve_batch=serve_batch or 4 * n_devices,
                    artifact=artifact)
    try:
        outs = spawn_ranks(dryrun_rank, n_devices, (settings,), device=device,
                           backend=backend, deadline_s=deadline_s,
                           threads=threads, rendezvous_dir=work_dir)
    finally:
        if own:
            shutil.rmtree(work_dir, ignore_errors=True)
    out = outs[0]
    out['launches_by_rank'] = [o['launches_by_rank'] for o in outs]
    print(summary_line(out), flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('n_devices', type=int)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--backend', default=None)
    args = parser.parse_args(argv)
    dryrun_multigpu(args.n_devices, device=args.device, backend=args.backend)


if __name__ == '__main__':
    main()
