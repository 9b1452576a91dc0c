#!/usr/bin/env python3
"""Train a retouching agent with the PyTorch/CUDA port:
``python3 train_torch.py <config> <run-name>``.

The counterpart of ``train.py``, with the same positional arguments,
``--resume`` and ``--num-devices``, the same ``models/<config>/<run>``
layout and checkpoints that either package restores, plus ``--device``
(``cuda`` by default; ``cpu`` trains on the host).  Configs are the port's
table (``exposure_tpu_torch/utils/config.py``), which carries the dispatch
knobs as the JAX configs do: ``iters_per_dispatch`` (100 in ``example``)
replays stretches of plain iterations as a CUDA graph on the card, and
``dispatch_pipeline_depth`` defers their bookkeeping (``core/trainer.py``).

``--num-devices N`` trains data-parallel over N ranks, one process a GPU
(``exposure_tpu_torch/parallel``): under ``torchrun --nproc-per-node N``
each process joins the group torchrun names; without torchrun the script
spawns the N processes itself, so the command line is the same as
``train.py``'s.  On the card the ranks talk over ``nccl`` (one card a
rank), on the host (``--device cpu``) over ``gloo``."""

import argparse
import os

from exposure_tpu_torch.parallel.mesh import local_batch_size
from exposure_tpu_torch.utils.config import load_config


def _train(args, num_devices, last_iter):
    from exposure_tpu_torch.core.trainer import Trainer
    cfg = load_config(args.config)
    cfg.name = args.config + '/' + args.run_name
    trainer = Trainer(cfg, restore=False, num_devices=num_devices,
                      device=args.device)
    try:
        if args.resume and trainer.latest_checkpoint() is not None:
            trainer.restore()
        trainer.train(last_iter=last_iter)
    finally:
        trainer.close()


def _rank_main(mesh, args, last_iter):
    _train(args, mesh.world, last_iter)


def main(argv=None, last_iter=None, deadline_s=None, threads=None):
    """Train as the command line says.  ``last_iter``: stop after that
    iteration (the schedule stays the full run's); ``deadline_s``: the
    seconds spawned ranks may take; ``threads``: torch threads a spawned
    rank (on the host by default the cores shared out)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('config')
    parser.add_argument('run_name')
    parser.add_argument('--resume', action='store_true',
                        help='resume from the latest checkpoint')
    parser.add_argument('--num-devices', type=int, default=None,
                        help='data-parallel ranks, one process a device')
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)
    n = args.num_devices
    if n is None or n == 1 or 'WORLD_SIZE' in os.environ:
        _train(args, n, last_iter)
        return
    cfg = load_config(args.config)
    # refuse before any process starts
    local_batch_size(cfg.batch_size, n)
    local_batch_size(cfg.replay_memory_size, n)
    from exposure_tpu_torch.parallel.launch import spawn_ranks
    if threads is None and args.device == 'cpu':
        threads = max(1, (os.cpu_count() or 1) // n)
    spawn_ranks(_rank_main, n, (args, last_iter), device=args.device,
                deadline_s=deadline_s, threads=threads)


if __name__ == '__main__':
    main()
