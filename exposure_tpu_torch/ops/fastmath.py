"""The two fast-math helpers the serving branch set uses (torch
counterpart of ``exposure_tpu/ops/fastmath.py:88,105``).  The CUDA kernel
``csrc/dyn_chain.cu`` carries the same arithmetic as device functions.

- ``fast_half_cos_pi``: -cos(pi x)/2 + 1/2 via an odd sin polynomial,
  |err| <= ~1e-6 on [0, 1].
- ``curve_relu``: the 8-knot piecewise-linear curve as a telescoped
  ``max`` sum; the same function as the clip form, exact up to rounding.

Both take float32 or bfloat16 tensors.  In bfloat16 every constant is
rounded to bfloat16 first (``const``), as JAX does with the weakly typed
constants of a bf16 computation, and every operation rounds its result.
"""

import functools

import torch

_SIN_C = (-0.55945275, 2.54400687, -5.16740635, 3.14159026)


@functools.lru_cache(maxsize=None)
def _bf16_value(value):
    return float(torch.tensor(value, dtype=torch.bfloat16))


def const(value, like):
    """``value`` as a constant of ``like``'s dtype: unchanged for float32,
    rounded to bfloat16 for a bfloat16 tensor."""
    if like.dtype == torch.bfloat16:
        return _bf16_value(float(value))
    return value


def _poly(coeffs, x):
    acc = const(coeffs[0], x) * torch.ones_like(x)
    for c in coeffs[1:]:
        acc = acc * x + const(c, x)
    return acc


def fast_half_cos_pi(x):
    """-cos(pi x)/2 + 1/2 on x in [0, 1]: cos(pi x) = -sin(pi (x - 1/2))."""
    u = x - 0.5
    return _poly(_SIN_C, u * u) * u * 0.5 + 0.5


def curve_relu(x, knots, norm):
    """sum_i t_i clip(x - i/K, 0, 1/K) * norm, rewritten as
    sum_i d_i max(x, i/K) - t_{K-1} max(x, 1) + C0 with d_i = t_i - t_{i-1}
    and C0 = t_{K-1} - sum_i d_i i/K.

    ``knots`` is a sequence of K scalars or tensors that broadcast against
    ``x``; ``norm`` is K / sum(t)."""
    k = len(knots)
    total = torch.clamp(x, min=0.0) * knots[0]
    c0 = knots[k - 1]
    for i in range(1, k):
        d = knots[i] - knots[i - 1]
        total = total + torch.clamp(x, min=const(i / k, x)) * d
        c0 = c0 - d * const(i / k, x)
    total = total - torch.clamp(x, min=1.0) * knots[k - 1]
    return (total + c0) * norm
