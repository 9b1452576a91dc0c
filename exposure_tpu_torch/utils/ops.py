"""Small numeric building blocks (torch counterpart of
``exposure_tpu/utils/ops.py``)."""

import math

import torch

# Trajectory-state vector layout:
#   [0] got-reward flag, [1] stopped flag, [2] step count,
#   [3:3+K] per-filter usage bits.
STATE_REWARD_DIM = 0
STATE_STOPPED_DIM = 1
STATE_STEP_DIM = 2
STATE_DROPOUT_BEGIN = 3


def lrelu(x, leak=0.2):
    """Leaky ReLU in the abs-combination form the JAX package uses."""
    f1 = 0.5 * (1 + leak)
    f2 = 0.5 * (1 - leak)
    return f1 * x + f2 * torch.abs(x)


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
