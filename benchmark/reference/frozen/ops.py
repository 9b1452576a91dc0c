"""Small numeric building blocks (torch counterpart of
``exposure_tpu/utils/ops.py``)."""

import contextlib
import math

import torch

# Trajectory-state vector layout:
#   [0] got-reward flag, [1] stopped flag, [2] step count,
#   [3:3+K] per-filter usage bits.
STATE_REWARD_DIM = 0
STATE_STOPPED_DIM = 1
STATE_STEP_DIM = 2
STATE_DROPOUT_BEGIN = 3


class _Abs(torch.autograd.Function):
    """``torch.abs`` with ``jnp.abs``'s gradient: +1 at zero (torch: 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, grad, -grad)


def abs_(x):
    """``|x|``, bit for bit ``torch.abs``, differentiated as JAX does."""
    return _Abs.apply(x)


class _Clip(torch.autograd.Function):
    """``torch.clamp`` with ``jnp.clip``'s gradient: half of it where ``x``
    equals a bound (JAX differentiates ``minimum(maximum(x, lo), hi)`` so),
    where torch's passes all of it.  The backward is written in torch ops,
    so the gradient penalty can differentiate it again."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        lo, hi = ctx.bounds
        # slope = (sign(x - lo) - sign(x - hi)) / 2: 1 inside, 1/2 at a
        # bound, 0 outside (x - b is 0 only where x == b)
        above = 1.0 if lo is None else torch.sign(x - lo)
        below = -1.0 if hi is None else torch.sign(x - hi)
        return grad * ((above - below) * 0.5), None, None


def lrelu(x, leak=0.2):
    """Leaky ReLU in the abs-combination form the JAX package uses."""
    f1 = 0.5 * (1 + leak)
    f2 = 0.5 * (1 - leak)
    return f1 * x + f2 * abs_(x)


def rgb2lum(image):
    """Luminance of an NHWC image, keepdims."""
    lum = (0.27 * image[..., 0] + 0.67 * image[..., 1] +
           0.06 * image[..., 2])
    return lum[..., None]


def tanh01(x):
    return torch.tanh(x) * 0.5 + 0.5


def tanh_range(l, r, initial=None):
    """Bounded activation mapping R -> (l, r); ``initial`` shifts the
    pre-activation so that x=0 maps to ``initial``."""

    def activation(x):
        if initial is not None:
            bias = math.atanh(2 * (initial - l) / (r - l) - 1)
        else:
            bias = 0.0
        return tanh01(x + bias) * (r - l) + l

    return activation


def lerp(a, b, t):
    return (1 - t) * a + t * b


def clip(x, lo=None, hi=None):
    """``jnp.clip(x, lo, hi)`` (or ``jnp.maximum(x, lo)``,
    ``jnp.minimum(x, hi)``) against constants: ``torch.clamp``'s values,
    JAX's gradient (``_Clip``)."""
    return _Clip.apply(x, lo, hi)


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's and torch's deterministic algorithms inside the block (the
    default ones add in an order that can differ from call to call on the
    card), their warnings silenced, restored after it."""
    import warnings
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.backends.cudnn.benchmark = saved[1]
        torch.use_deterministic_algorithms(saved[2])
