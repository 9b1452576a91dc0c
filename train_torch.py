#!/usr/bin/env python3
"""Train a retouching agent with the PyTorch/CUDA port:
``python3 train_torch.py <config> <run-name>``.

The counterpart of ``train.py``, with the same positional arguments and
``--resume``, the same ``models/<config>/<run>`` layout and checkpoints
that either package restores, plus ``--device`` (``cuda`` by default;
``cpu`` trains on the host).  ``--num-devices`` waits for multi-GPU
training (``ROADMAP.md`` item 11).  Configs are the port's table
(``exposure_tpu_torch/utils/config.py``)."""

import argparse

from exposure_tpu_torch.utils.config import load_config


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('config')
    parser.add_argument('run_name')
    parser.add_argument('--resume', action='store_true',
                        help='resume from the latest checkpoint')
    parser.add_argument('--device', default='cuda',
                        help='cuda (default) or cpu')
    args = parser.parse_args(argv)

    from exposure_tpu_torch.core.trainer import Trainer
    cfg = load_config(args.config)
    cfg.name = args.config + '/' + args.run_name
    trainer = Trainer(cfg, restore=False, device=args.device)
    try:
        if args.resume and trainer.latest_checkpoint() is not None:
            trainer.restore()
        trainer.train()
    finally:
        trainer.close()


if __name__ == '__main__':
    main()
