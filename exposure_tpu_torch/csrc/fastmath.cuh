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
// rounds after every operation and never fuses a multiply into an add: the
// semantics of a JAX computation on bf16 arrays with weakly typed
// constants, and of torch's bf16 elementwise ops.  The switch kernel's bf16
// path (switch_chain.cu) and the bf16 probe (probes.cu) run on it.
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
//
// One arithmetic in two forms.  The scalar form (`bf`) widens to f32, does
// one _rn operation and rounds: it defines the numbers, and runs where a
// value is made once (a kernel's prologue, a per-step plan).  The packed form
// (`bf2`, two values a register) runs per pixel on Hopper's native packed
// bf16 instructions: add, subtract and multiply through the _rn intrinsics
// (add.rn.bf16x2 ..., never contracted into an FMA, which would drop a
// rounding), abs and neg on the sign bits, and max, min and every select
// through packed comparisons (set.*.bf16x2 masks), which keep the scalar
// form's `a >= b ? a : b` for signed zeros and NaN where the native
// max.bf16x2 returns +0 and the non-NaN operand.  Divide, the reciprocal and
// every transcendental stay f32 on each unpacked lane, rounded once.
// `packed_bf16_check` (probes.cu) holds each packed operation to the scalar
// form over every operand pair on the card.

typedef __nv_bfloat16 bf;
typedef __nv_bfloat162 bf2;

__device__ __forceinline__ float F(bf x) { return __bfloat162float(x); }
__device__ __forceinline__ bf R(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ bf add(bf a, bf b) { return R(__fadd_rn(F(a), F(b))); }
__device__ __forceinline__ bf sub(bf a, bf b) { return R(__fsub_rn(F(a), F(b))); }
__device__ __forceinline__ bf mul(bf a, bf b) { return R(__fmul_rn(F(a), F(b))); }
__device__ __forceinline__ bf dvd(bf a, bf b) { return R(__fdiv_rn(F(a), F(b))); }
__device__ __forceinline__ bf bmax(bf a, bf b) { return F(a) >= F(b) ? a : b; }
__device__ __forceinline__ bf bmin(bf a, bf b) { return F(a) <= F(b) ? a : b; }
__device__ __forceinline__ bf bneg(bf x) { return R(-F(x)); }
__device__ __forceinline__ bf babs(bf x) { return R(fabsf(F(x))); }
// a constant rounded to bf16 (a weakly typed constant in a JAX kernel)
__device__ __forceinline__ bf C(float x) { return R(x); }
// 1 / x, as torch's x.reciprocal()
__device__ __forceinline__ bf rcp(bf x) { return R(__frcp_rn(F(x))); }

// packed: lane 0 is the low half
__device__ __forceinline__ unsigned bits2(bf2 x) {
  return *reinterpret_cast<const unsigned*>(&x);
}
__device__ __forceinline__ bf2 from_bits2(unsigned u) {
  return *reinterpret_cast<const bf2*>(&u);
}
__device__ __forceinline__ bf2 both(bf x) { return __bfloat162bfloat162(x); }
__device__ __forceinline__ bf2 C2(float x) { return __float2bfloat162_rn(x); }
// two f32 values rounded into one register
__device__ __forceinline__ bf2 pack2(float low, float high) {
  return __floats2bfloat162_rn(low, high);
}
__device__ __forceinline__ float lo(bf2 x) { return __low2float(x); }
__device__ __forceinline__ float hi(bf2 x) { return __high2float(x); }
__device__ __forceinline__ bf2 add2(bf2 a, bf2 b) { return __hadd2_rn(a, b); }
__device__ __forceinline__ bf2 sub2(bf2 a, bf2 b) { return __hsub2_rn(a, b); }
__device__ __forceinline__ bf2 mul2(bf2 a, bf2 b) { return __hmul2_rn(a, b); }
__device__ __forceinline__ bf2 abs2(bf2 x) { return __habs2(x); }
__device__ __forceinline__ bf2 neg2(bf2 x) { return __hneg2(x); }
// per-lane masks (0xFFFF where true; false on a NaN) and the select by one
__device__ __forceinline__ unsigned ge2(bf2 a, bf2 b) { return __hge2_mask(a, b); }
__device__ __forceinline__ unsigned le2(bf2 a, bf2 b) { return __hle2_mask(a, b); }
__device__ __forceinline__ unsigned gt2(bf2 a, bf2 b) { return __hgt2_mask(a, b); }
__device__ __forceinline__ bf2 sel2(unsigned m, bf2 a, bf2 b) {
  return from_bits2((bits2(a) & m) | (bits2(b) & ~m));
}
__device__ __forceinline__ bf2 bmax2(bf2 a, bf2 b) { return sel2(ge2(a, b), a, b); }
__device__ __forceinline__ bf2 bmin2(bf2 a, bf2 b) { return sel2(le2(a, b), a, b); }
__device__ __forceinline__ bf2 bclamp2(bf2 x, bf2 low, bf2 high) {
  return bmin2(bmax2(x, low), high);
}
__device__ __forceinline__ bf2 dvd2(bf2 a, bf2 b) {
  return pack2(__fdiv_rn(lo(a), lo(b)), __fdiv_rn(hi(a), hi(b)));
}
// f(x) in f32 on each lane's bf16 value, rounded once
template <typename Fn>
__device__ __forceinline__ bf2 lanes(bf2 x, const Fn& f) {
  return pack2(f(lo(x)), f(hi(x)));
}

// fast_half_cos_pi in bf16
__device__ __forceinline__ bf2 fast_half_cos_pi_bf2(bf2 x) {
  const bf2 u = sub2(x, C2(0.5f));
  const bf2 z = mul2(u, u);
  bf2 acc = C2(-0.55945275f);
  acc = add2(mul2(acc, z), C2(2.54400687f));
  acc = add2(mul2(acc, z), C2(-5.16740635f));
  acc = add2(mul2(acc, z), C2(3.14159026f));
  return add2(mul2(mul2(acc, u), C2(0.5f)), C2(0.5f));
}

// sum_i t_i clip(x - i/K, 0, 1/K) * norm in the telescoped max form,
// sum_i d_i max(x, i/K) - t_{K-1} max(x, 1) + C0 with d_i = t_i - t_{i-1},
// in bf16: knots, d_i and C0 are bf16 values.  S > 0 is the knot count at
// compile time (the loops unroll and the positions i/K fold to constants),
// S == 0 takes it from `steps`.
//
// The part that depends on the knots alone, made once: q = [t_0, d_1 ..
// d_{K-1}, t_{K-1}, C0], each in both lanes; `knot(i)` is t_i.
template <int S, typename Knot>
__device__ __forceinline__ void curve_relu_plan_bf(const Knot& knot, int steps,
                                                   bf2* q) {
  const int n = S ? S : steps;
  bf c0 = knot(n - 1);
  q[0] = both(knot(0));
#pragma unroll
  for (int i = 1; i < n; ++i) {
    const bf d = sub(knot(i), knot(i - 1));
    const bf c = C((float)i / (float)n);
    q[i] = both(d);
    c0 = sub(c0, mul(d, c));
  }
  q[n] = both(knot(n - 1));
  q[n + 1] = both(c0);
}

// The curve on M pairs of values, knot by knot, from the plan `q`; `y` may
// be `x`.
template <int S, int M>
__device__ __forceinline__ void curve_relu_bf2(const bf2 (&x)[M], bf2 (&y)[M],
                                               const bf2* q, int steps,
                                               bf2 norm) {
  const int n = S ? S : steps;
  bf2 total[M];
  {
    const bf2 t0 = q[0], zero = C2(0.0f);
#pragma unroll
    for (int m = 0; m < M; ++m) total[m] = mul2(bmax2(x[m], zero), t0);
  }
#pragma unroll
  for (int i = 1; i < n; ++i) {
    const bf2 d = q[i], c = C2((float)i / (float)n);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      total[m] = add2(total[m], mul2(bmax2(x[m], c), d));
    }
  }
  const bf2 last = q[n], c0 = q[n + 1], one = C2(1.0f);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    total[m] = sub2(total[m], mul2(bmax2(x[m], one), last));
    y[m] = mul2(add2(total[m], c0), norm);
  }
}

}  // namespace
