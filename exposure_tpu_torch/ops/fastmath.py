"""Polynomial and bit-trick versions of the expensive per-pixel math of
the filter kernels (torch counterpart of ``exposure_tpu/ops/fastmath.py``,
same coefficients and bit tricks).  The CUDA kernels carry the same
arithmetic as device functions in ``csrc/fastmath.cuh``.

- ``fast_half_cos_pi``: -cos(pi x)/2 + 1/2 via an odd sin polynomial,
  |err| <= ~1e-6 on [0, 1].  The fast branch set's contrast uses it.
- ``curve_relu``: the 8-knot piecewise-linear curve as a telescoped
  ``max`` sum; the same function as the clip form, exact up to rounding.
  The fast branch set's tone and colour curves use it.
- ``fast_log2`` / ``fast_exp2`` / ``fast_pow``: polynomial
  exp2(g log2 x); |err| <= ~4e-5 for outputs in [0, 1.2] and exponents
  in [1/3, 3] (the gamma range).  Library only: the fast gamma branch
  is the library composition exp2f(g * log2f(x)).
- ``fast_rcp``: Newton iterations from the classic bit-trick seed;
  relative error <= ~1e-6.  Library only: the kernels divide.

Which of these the kernels use was decided by the JAX package on a TPU
(its docstring gives the TPU timings); those findings are the TPU's.
On the H100, ``tools/bench_fastmath.py`` times each polynomial against
the CUDA library call it would replace.

``fast_half_cos_pi`` and ``curve_relu`` take float32 or bfloat16 tensors.
In bfloat16 every constant is rounded to bfloat16 first (``const``), as
JAX does with the weakly typed constants of a bf16 computation, and every
operation rounds its result.  The other four work on float32 only: they
reinterpret the float bits as int32.
"""

import functools

import torch

# minimax-fit coefficients, as the JAX package's
_LOG2_C = (0.04392957, -0.40948426, 1.61020813, -3.52027091,
           5.06979932, -2.79416749)
_EXP2_C = (0.00189511, 0.00894622, 0.05586326, 0.24014079,
           0.69315462, 0.9999999)
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


def _bits(x):
    if x.dtype != torch.float32:
        raise TypeError('the bit tricks need float32, got %s' % x.dtype)
    return x.view(torch.int32)


def fast_log2(x):
    """log2(x) for x > 0 (f32): exponent from the float bits (arithmetic
    shift), mantissa via a degree-5 polynomial on [1, 2)."""
    bits = _bits(x)
    e = (bits >> 23) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    return e.to(torch.float32) + _poly(_LOG2_C, m)


def fast_exp2(y):
    """2**y for y in roughly [-30, 30] (f32): integer part (floor, also
    for negative y) via the exponent bits, fraction via a degree-5
    polynomial on [0, 1)."""
    _bits(y)
    y = torch.clamp(y, -126.0, 126.0)
    k = torch.floor(y)
    f = y - k
    scale = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return _poly(_EXP2_C, f) * scale


def fast_pow(x, g):
    """x**g for x > 0; g may be a scalar or a broadcastable tensor."""
    return fast_exp2(g * fast_log2(x))


def fast_half_cos_pi(x):
    """-cos(pi x)/2 + 1/2 on x in [0, 1]: cos(pi x) = -sin(pi (x - 1/2))."""
    u = x - 0.5
    return _poly(_SIN_C, u * u) * u * 0.5 + 0.5


def fast_rcp(x, iters=3):
    """1/x for x > 0 via the bit-trick seed 0x7EF311C3 - bits and
    ``iters`` Newton steps y <- y (2 - x y)."""
    y = (0x7EF311C3 - _bits(x)).view(torch.float32)
    for _ in range(iters):
        y = y * (2.0 - x * y)
    return y


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
