// Fast-math device functions: one copy for every kernel of csrc/.
//
// Counterpart of exposure_tpu/ops/fastmath.py (same coefficients and bit
// tricks); the plain PyTorch version is exposure_tpu_torch/ops/fastmath.py.
// The chain kernels (through chain_branches.cuh) run fast_half_cos_pi in
// their fast branch set, and the probe kernels (probes.cu) time every
// function here against the CUDA library call it would replace.  The
// curves, in both sets, are chain_branches.cuh's (plan_curve, Curve),
// which the probes time too.
//
// The f32 functions are written as plain expressions: nvcc contracts
// a * b + c into an FMA, as it does in the chain kernels.  The bf16 section
// rounds after every operation, with the _rn intrinsics, which nvcc never
// contracts: the semantics of a JAX computation on bf16 arrays with weakly
// typed constants, and of torch's bf16 elementwise ops.
//
// Built without --use_fast_math, as every kernel that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// f32
// ---------------------------------------------------------------------------

// log2(x) for x > 0: exponent from the float bits (arithmetic shift, right
// for the positive domain), mantissa via a degree-5 polynomial on [1, 2).
__device__ __forceinline__ float fast_log2(float x) {
  const int bits = __float_as_int(x);
  const int e = (bits >> 23) - 127;
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  float acc = 0.04392957f;
  acc = acc * m + -0.40948426f;
  acc = acc * m + 1.61020813f;
  acc = acc * m + -3.52027091f;
  acc = acc * m + 5.06979932f;
  acc = acc * m + -2.79416749f;
  return (float)e + acc;
}

// 2**y: the integer part (floor, also for negative y) via the exponent
// bits, the fraction via a degree-5 polynomial on [0, 1).
__device__ __forceinline__ float fast_exp2(float y) {
  y = fminf(fmaxf(y, -126.0f), 126.0f);
  const float k = floorf(y);
  const float f = y - k;
  const float scale = __int_as_float(((int)k + 127) << 23);
  float acc = 0.00189511f;
  acc = acc * f + 0.00894622f;
  acc = acc * f + 0.05586326f;
  acc = acc * f + 0.24014079f;
  acc = acc * f + 0.69315462f;
  acc = acc * f + 0.9999999f;
  return acc * scale;
}

// x**g for x > 0.
__device__ __forceinline__ float fast_pow(float x, float g) {
  return fast_exp2(g * fast_log2(x));
}

// 1/x for x > 0: the bit-trick seed and 3 Newton steps y <- y (2 - x y).
__device__ __forceinline__ float fast_rcp(float x) {
  float y = __int_as_float(0x7EF311C3 - __float_as_int(x));
#pragma unroll
  for (int i = 0; i < 3; ++i) y = y * (2.0f - x * y);
  return y;
}

// -cos(pi x)/2 + 1/2 on [0, 1] via the odd sin polynomial.
__device__ __forceinline__ float fast_half_cos_pi(float x) {
  const float u = x - 0.5f;
  const float z = u * u;
  float acc = -0.55945275f;
  acc = acc * z + 2.54400687f;
  acc = acc * z + -5.16740635f;
  acc = acc * z + 3.14159026f;
  return acc * u * 0.5f + 0.5f;
}

// ---------------------------------------------------------------------------
// bf16, one rounding after every operation
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf;

__device__ __forceinline__ float F(bf x) { return __bfloat162float(x); }
__device__ __forceinline__ bf R(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ bf add(bf a, bf b) { return R(__fadd_rn(F(a), F(b))); }
__device__ __forceinline__ bf sub(bf a, bf b) { return R(__fsub_rn(F(a), F(b))); }
__device__ __forceinline__ bf mul(bf a, bf b) { return R(__fmul_rn(F(a), F(b))); }
__device__ __forceinline__ bf dvd(bf a, bf b) { return R(__fdiv_rn(F(a), F(b))); }
__device__ __forceinline__ bf bmax(bf a, bf b) { return F(a) >= F(b) ? a : b; }
__device__ __forceinline__ bf bmin(bf a, bf b) { return F(a) <= F(b) ? a : b; }
__device__ __forceinline__ bf bclamp(bf x, bf lo, bf hi) {
  return bmin(bmax(x, lo), hi);
}
__device__ __forceinline__ bf bneg(bf x) { return R(-F(x)); }
__device__ __forceinline__ bf babs(bf x) { return R(fabsf(F(x))); }
// a constant rounded to bf16 (a weakly typed constant in a JAX kernel)
__device__ __forceinline__ bf C(float x) { return R(x); }
// 1 / x, as torch's x.reciprocal()
__device__ __forceinline__ bf rcp(bf x) { return R(__frcp_rn(F(x))); }

// fast_half_cos_pi in bf16
__device__ __forceinline__ bf fast_half_cos_pi_bf(bf x) {
  const bf u = sub(x, C(0.5f));
  const bf z = mul(u, u);
  bf acc = C(-0.55945275f);
  acc = add(mul(acc, z), C(2.54400687f));
  acc = add(mul(acc, z), C(-5.16740635f));
  acc = add(mul(acc, z), C(3.14159026f));
  return add(mul(mul(acc, u), C(0.5f)), C(0.5f));
}

// sum_i t_i clip(x - i/K, 0, 1/K) * norm in the telescoped max form,
// sum_i d_i max(x, i/K) - t_{K-1} max(x, 1) + C0 with d_i = t_i - t_{i-1},
// in bf16: knots, d_i and C0 are bf16 values
__device__ __forceinline__ bf curve_relu_bf(bf x, const bf* t, int steps,
                                            bf norm) {
  bf total = mul(bmax(x, C(0.0f)), t[0]);
  bf c0 = t[steps - 1];
  for (int i = 1; i < steps; ++i) {
    const bf d = sub(t[i], t[i - 1]);
    const bf c = C((float)i / (float)steps);
    total = add(total, mul(bmax(x, c), d));
    c0 = sub(c0, mul(d, c));
  }
  total = sub(total, mul(bmax(x, C(1.0f)), t[steps - 1]));
  return mul(add(total, c0), norm);
}

}  // namespace
