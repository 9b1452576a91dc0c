"""The port's one precision contract: float32, as the JAX package computes.

cuDNN and cuBLAS may run float32 convolutions and matmuls in TF32 (torch's
default turns it on for cuDNN), which flips a plan's near-tie argmax
decisions and moves a training step's gradients.  So every plan
(``core/rollout.py::rollout`` and ``serve_rollout``), every update of a
training step (``core/steps.py::_make_phase_bodies``: the loss, its
gradients and the gradient penalty's double backward) and every score of
the critic or the value net outside a step (``Evaluator.critic_logits``,
``Trainer.critic_scores``, ``state_values``, ``critic_gradients``) runs
inside ``tf32_off``, whatever flags the process set.  A flag is read when a
kernel launches, so the block holds the backward as well as the forward,
and a CUDA graph captured inside it replays float32 kernels.  The bf16 plan
(``RetouchPipeline(bf16=True)``) is the one reduced-precision mode, as in
the JAX package: the flags do not touch bfloat16 convolutions.

The flags belong to the whole process, and the trainer plans and scores on
worker threads while it trains.  Entries are counted under a lock: the
outermost saves the flags, the last exit restores them, so one thread's
exit never turns TF32 back on under another's launches.  The block reads
and writes the legacy ``allow_tf32`` flags only, which also set the
``fp32_precision`` leaves that a convolution and a matmul read; torch can
refuse a mix of the two interfaces."""

import contextlib
import threading

import torch

_LOCK = threading.Lock()
_depth = 0
_saved = None


def _set(flags):
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block
    (or the decorated function), the process's flags restored when the
    last block open in any thread exits."""
    global _depth, _saved
    with _LOCK:
        if _depth == 0:
            _saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
            _set((False, False))
        _depth += 1
    try:
        yield
    finally:
        with _LOCK:
            _depth -= 1
            if _depth == 0:
                _set(_saved)
