// Probe kernels for Hopper (sm_90a): K4a, K4b and K4c.
//
// Replace the TPU kernels of the JAX package's kernel tools:
// - K4a `_mono_kernel` (exposure_tpu/tools/bench_kernel_probe.py), reached
//   through `mono_chain`: `steps` x copy, E (x 1.5) or G (pow 0.8);
// - K4b `_kernel` (exposure_tpu/tools/bench_fastmath.py), reached through
//   `run_op`: 5 x one of the 11 ops of that tool's `OPS`;
// - K4c `_probe_kernel` (exposure_tpu/tools/bench_bf16_probe.py), reached
//   through `probe`: `steps` x mul, pow, cos or curve with two scalar
//   parameters, in f32 or in bf16 (styles bf16_cast and bf16_splat).
// The wrappers are exposure_tpu_torch/tools/bench_kernel_probe.py,
// bench_fastmath.py and bench_bf16_probe.py, beside their plain versions.
//
// What they compute: an elementwise pass over a contiguous u8 buffer.
// Each value is dequantized (x * (1/255), in f32; rounded to bf16 in the
// bf16 styles), goes through the op `steps` times, and is quantized with
// round half to even of clip(x, 0, 1) * 255 (quantize_px).  Every op acts
// on each value alone, so the TPU's planar layout and 256x256 tiles do not
// matter here: the kernels read any layout as flat bytes.
//
// The ops call the device functions the chain kernels run: the library
// calls of chain_branches.cuh (gamma_exact = powf, gamma_fast = exp2f of
// log2f, half_cospi = cospif), its curves (the per-step plan_curve and
// Curve at 8 knots, clip and max form) and the polynomials of
// fastmath.cuh.  So K4b times the code of the chain's branches, and is
// built, like them, without --use_fast_math: its "builtin" rows are the
// CUDA library's full-precision calls.  In K4c the bf16 styles round after
// every add, subtract and multiply and round every constant first
// (fastmath.cuh's bf16 section); bf16_cast rounds the parameters once,
// before the launch, and bf16_splat where each step uses them, so the two
// give the same bits: the TPU's difference between them was whether Mosaic
// legalized scalar bf16 arithmetic, not the numbers.
//
// What bounds them on an H100: with 0 steps, memory traffic alone (1 byte
// read and 1 written per value), which makes K4a's copy the measure of the
// u8 round trip's floor; with more steps the op's instructions.
//
// What the design does about it: each thread loads 16 consecutive bytes
// with one uint4 load, keeps the 16 values in registers through all the
// steps (16 independent chains for the scheduler to overlap; in the bf16
// styles 8 registers of two values each, on fastmath.cuh's packed
// arithmetic) and stores 16 bytes with one uint4 store.  With calls back to
// back the 0-step copy takes Tensor.copy_'s time; more chunks a thread and
// streaming loads and stores were timed and bought nothing.  The u8
// conversions run on the f32 pipe (load_px, quantize_bits), which shows in
// the short ops and in the chain kernels.  The thread holding the ragged end
// of a buffer whose length is not a multiple of 16 loads and stores it byte
// by byte.  The buffers must be 16-byte aligned (the wrappers check).  What
// depends on an op's parameters alone (the bf16 curve's plan) is made once
// per thread, before the loops.
//
// Besides the probes, `packed_bf16_check` holds fastmath.cuh's packed bf16
// operations to their scalar f32-then-round forms over every operand pair.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (exposure_tpu_torch/kernels/__init__.py).

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "chain_branches.cuh"

namespace {

constexpr int kBytes = 16;   // bytes a thread: one uint4 load and store

// Op codes; the wrappers' tuples keep the same order
// (bench_kernel_probe.MONO_OPS, bench_fastmath.OPS,
// bench_bf16_probe.OPS and STYLES).
enum MonoOp : int { kMonoCopy = 0, kMonoE = 1, kMonoG = 2 };
enum FastMathOp : int {
  kFmCopy = 0,
  kFmPowBuiltin = 1,
  kFmPowFast = 2,
  kFmPowExp2Log2 = 3,
  kFmPowExpLog = 4,
  kFmCosBuiltin = 5,
  kFmCosFast = 6,
  kFmDivBuiltin = 7,
  kFmDivFast = 8,
  kFmCurveClip = 9,
  kFmCurveRelu = 10,
};
enum ScalarOp : int { kScMul = 0, kScPow = 1, kScCos = 2, kScCurve = 3 };
enum Style : int { kF32 = 0, kBf16Cast = 1, kBf16Splat = 2 };

constexpr int kCurveKnots = 8;

// The chain's curve on knots t: its per-step plan (plan_curve) and the
// evaluation at a compiled knot count (Curve<FAST, 8>); a nonzero norm
// replaces the plan's.  The plan depends on the knots alone (constants in
// K4b, kernel parameters in K4c), so the compiler may hoist it out of the
// loops over values and steps, as the chain kernels make it once a block.
template <bool FAST>
__device__ __forceinline__ float knot_curve(float x,
                                            const float (&t)[kCurveKnots],
                                            float norm = 0.0f) {
  float plan[curve_plan_floats(kCurveKnots)];
  plan_curve<FAST>(t, kCurveKnots, plan);
  if (norm != 0.0f) plan[curve_plan_floats(kCurveKnots) - 1] = norm;
  return Curve<FAST, kCurveKnots>(plan, kCurveKnots)(x);
}

// four quantized values' low bytes in one word
__device__ __forceinline__ uint32_t pack_bytes(uint32_t q0, uint32_t q1,
                                               uint32_t q2, uint32_t q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040u),
                     __byte_perm(q2, q3, 0x0040u), 0x5410u);
}

// How a thread's 16 values enter and leave an op: 16 f32 registers, or 8
// registers of two bf16 values rounded from the f32 dequantized values and
// quantized from their f32 values.  `prepare` is what a thread makes of the
// op's parameters before its loops (nothing, by default).
struct F32Pixels {
  typedef float T;
  static constexpr int kCount = kBytes;
  __device__ void prepare() {}
  __device__ static void load(const uint32_t (&w)[4], float (&x)[kCount]) {
#pragma unroll
    for (int j = 0; j < kBytes; ++j) x[j] = load_px(w[j / 4], j % 4);
  }
  __device__ static void store(const float (&x)[kCount], uint32_t (&q)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = pack_bytes(quantize_bits(x[4 * i]), quantize_bits(x[4 * i + 1]),
                        quantize_bits(x[4 * i + 2]),
                        quantize_bits(x[4 * i + 3]));
    }
  }
};

struct Bf16Pixels {
  typedef bf2 T;
  static constexpr int kCount = kBytes / 2;
  __device__ void prepare() {}
  __device__ static void load(const uint32_t (&w)[4], bf2 (&x)[kCount]) {
#pragma unroll
    for (int m = 0; m < kCount; ++m) {
      x[m] = pack2(load_px(w[m / 2], (2 * m) % 4),
                   load_px(w[m / 2], (2 * m + 1) % 4));
    }
  }
  __device__ static void store(const bf2 (&x)[kCount], uint32_t (&q)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = pack_bytes(quantize_bits(lo(x[2 * i])),
                        quantize_bits(hi(x[2 * i])),
                        quantize_bits(lo(x[2 * i + 1])),
                        quantize_bits(hi(x[2 * i + 1])));
    }
  }
};

// K4a
template <int OP>
struct Mono : F32Pixels {
  __device__ float step(float x) const {
    if constexpr (OP == kMonoE) {
      return x * 1.5f;
    } else if constexpr (OP == kMonoG) {
      return gamma_exact(x, 0.8f);
    } else {
      return x;
    }
  }
};

// K4b: bench_fastmath.py's OPS with its constants (pow 0.7, the divide's
// 1e-6, the knots _T)
template <int OP>
struct FastMath : F32Pixels {
  __device__ float step(float x) const {
    if constexpr (OP == kFmPowBuiltin) {
      return gamma_exact(x, 0.7f);
    } else if constexpr (OP == kFmPowFast) {
      return fast_pow(fmaxf(x, 0.001f), 0.7f);
    } else if constexpr (OP == kFmPowExp2Log2) {
      return gamma_fast(x, 0.7f);
    } else if constexpr (OP == kFmPowExpLog) {
      return expf(0.7f * logf(fmaxf(x, 0.001f)));
    } else if constexpr (OP == kFmCosBuiltin) {
      return half_cospi(clamp01(x));
    } else if constexpr (OP == kFmCosFast) {
      return fast_half_cos_pi(clamp01(x));
    } else if constexpr (OP == kFmDivBuiltin) {
      return 0.5f / (x + 1e-6f);
    } else if constexpr (OP == kFmDivFast) {
      return 0.5f * fast_rcp(x + 1e-6f);
    } else if constexpr (OP == kFmCurveClip || OP == kFmCurveRelu) {
      const float knots[kCurveKnots] = {1.1f, 0.9f, 1.3f, 0.7f,
                                        1.2f, 0.8f, 1.05f, 0.95f};
      return knot_curve<OP == kFmCurveRelu>(x, knots);
    } else {
      return x;
    }
  }
};

// K4c: parameters p0, p1 and the curve's norm = 8 / (sum of the knots
// [p0, p1, p0, ...] + 1e-30), all taken in f32 on the host; bf16_cast
// holds them rounded to bf16, bf16_splat rounds them at each use.  The bf16
// styles run on the packed arithmetic, and their curve on a plan made by
// `prepare`.
struct NoPlan {};
struct CurvePlanBf {
  bf2 q[kCurveKnots + 2];
};

template <int OP, int STYLE>
struct Scalar
    : std::conditional_t<STYLE == kF32, F32Pixels, Bf16Pixels> {
  typedef std::conditional_t<STYLE == kF32, float, bf2> T;
  typedef std::conditional_t<STYLE == kBf16Cast, bf, float> P;
  static constexpr bool kPlanned = OP == kScCurve && STYLE != kF32;
  P p0, p1, norm;
  std::conditional_t<kPlanned, CurvePlanBf, NoPlan> plan;

  __device__ bf use(P p) const {
    if constexpr (STYLE == kBf16Cast) {
      return p;
    } else {
      return R(p);
    }
  }

  __device__ void prepare() {
    if constexpr (kPlanned) {
      curve_relu_plan_bf<kCurveKnots>(
          [&](int i) { return use(i % 2 == 0 ? p0 : p1); }, kCurveKnots,
          plan.q);
    }
  }

  __device__ T step(T x) const {
    if constexpr (STYLE == kF32) {
      if constexpr (OP == kScMul) {
        return x * p0;
      } else if constexpr (OP == kScPow) {
        return gamma_exact(x, p0);
      } else if constexpr (OP == kScCos) {
        return x + (fast_half_cos_pi(clamp01(x)) - x) * p0;
      } else {
        const float t[kCurveKnots] = {p0, p1, p0, p1, p0, p1, p0, p1};
        return knot_curve<true>(x, t, norm);
      }
    } else {
      const bf g = use(p0);
      if constexpr (OP == kScMul) {
        return mul2(x, both(g));
      } else if constexpr (OP == kScPow) {
        const float gf = F(g);
        return lanes(bmax2(x, C2(0.001f)),
                     [&](float v) { return powf(v, gf); });
      } else if constexpr (OP == kScCos) {
        const bf2 lum = bclamp2(x, C2(0.0f), C2(1.0f));
        return add2(x, mul2(sub2(fast_half_cos_pi_bf2(lum), x), both(g)));
      } else {
        const bf2 xs[1] = {x};
        bf2 ys[1];
        curve_relu_bf2<kCurveKnots, 1>(xs, ys, plan.q, kCurveKnots,
                                       both(use(norm)));
        return ys[0];
      }
    }
  }
};

// A thread's 16 bytes at `start` into w: one 16-byte load, or byte by byte
// at the buffer's ragged end (nothing past it).
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ in,
                                           long long start, long long n,
                                           uint32_t (&w)[4]) {
  if (n - start >= kBytes) {
    const uint4 v = *reinterpret_cast<const uint4*>(in + start);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
#pragma unroll
  for (int j = 0; j < kBytes; ++j) {
    if (start + j < n) w[j / 4] |= (uint32_t)in[start + j] << (8 * (j % 4));
  }
}

__device__ __forceinline__ void store_chunk(uint8_t* __restrict__ out,
                                            long long start, long long n,
                                            const uint32_t (&q)[4]) {
  if (n - start >= kBytes) {
    *reinterpret_cast<uint4*>(out + start) = make_uint4(q[0], q[1], q[2], q[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < kBytes; ++j) {
    if (start + j < n) out[start + j] = (uint8_t)(q[j / 4] >> (8 * (j % 4)));
  }
}

// The skeleton: 16 bytes a thread, the op `steps` times on each value.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
             long long n, int steps, const Op op_in) {
  typedef typename Op::T T;
  const long long start =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kBytes;
  if (start >= n) return;
  uint32_t w[4];
  load_chunk(in, start, n, w);
  Op op = op_in;
  op.prepare();
  T x[Op::kCount];
  Op::load(w, x);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < Op::kCount; ++j) x[j] = op.step(x[j]);
  }
  uint32_t q[4];
  Op::store(x, q);
  store_chunk(out, start, n, q);
}

template <typename Op>
cudaError_t launch(const void* in, void* out, long long n, int steps,
                   const Op& op, cudaStream_t stream) {
  const long long chunks = (n + kBytes - 1) / kBytes;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  probe_kernel<Op><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, steps,
      op);
  return cudaGetLastError();
}

bool bad_buffers(const void* in, const void* out, long long n, int steps) {
  return !in || !out || n <= 0 || steps < 0 ||
         reinterpret_cast<uintptr_t>(in) % kBytes != 0 ||
         reinterpret_cast<uintptr_t>(out) % kBytes != 0;
}

template <int OP, int STYLE>
cudaError_t launch_scalar(const void* in, void* out, long long n, int steps,
                          float p0, float p1, float norm, cudaStream_t s) {
  Scalar<OP, STYLE> op;
  if constexpr (STYLE == kBf16Cast) {   // once, before the loop
    op.p0 = __float2bfloat16_rn(p0);
    op.p1 = __float2bfloat16_rn(p1);
    op.norm = __float2bfloat16_rn(norm);
  } else {
    op.p0 = p0;
    op.p1 = p1;
    op.norm = norm;
  }
  return launch(in, out, n, steps, op, s);
}

template <int STYLE>
cudaError_t launch_style(const void* in, void* out, long long n, int op,
                         int steps, float p0, float p1, float norm,
                         cudaStream_t s) {
  switch (op) {
    case kScMul:
      return launch_scalar<kScMul, STYLE>(in, out, n, steps, p0, p1, norm, s);
    case kScPow:
      return launch_scalar<kScPow, STYLE>(in, out, n, steps, p0, p1, norm, s);
    case kScCos:
      return launch_scalar<kScCos, STYLE>(in, out, n, steps, p0, p1, norm, s);
    case kScCurve:
      return launch_scalar<kScCurve, STYLE>(in, out, n, steps, p0, p1, norm,
                                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the packed bf16 operations against their scalar forms, exhaustively
// ---------------------------------------------------------------------------

// The order of bench_bf16_probe.PACKED_OPS.  Max and Min are the
// comparison-and-select forms the kernels run (bmax2, bmin2); Hmax and Hmin
// the native max.bf16x2 and min.bf16x2, counted to show where they differ.
enum PackedOp : int {
  kPkAdd, kPkSub, kPkMul, kPkMax, kPkMin, kPkGe, kPkLe, kPkGt, kPkHmax,
  kPkHmin, kPkAbs, kPkNeg, kPkOps
};
// per op: results whose bits differ (two NaNs aside), those among them that
// are zeros of either sign, and pairs of NaNs with different bits
enum PackedCount : int { kDiffer, kZeroSign, kNanPayload, kPkCounts };

__device__ __forceinline__ bool is_nan_bits(unsigned v) {
  return (v & 0x7FFFu) > 0x7F80u;
}

template <int OP>
__device__ __forceinline__ void tally(unsigned (&local)[kPkOps][kPkCounts],
                                      unsigned got, unsigned want) {
  got &= 0xFFFFu;
  want &= 0xFFFFu;
  if (got == want) return;
  if (is_nan_bits(got) && is_nan_bits(want)) {
    ++local[OP][kNanPayload];
    return;
  }
  ++local[OP][kDiffer];
  if (((got | want) & 0x7FFFu) == 0u) ++local[OP][kZeroSign];
}

// Both lanes of a packed result against the scalar form on each lane.
template <int OP>
__device__ __forceinline__ void tally2(unsigned (&local)[kPkOps][kPkCounts],
                                       bf2 got, bf want_lo, bf want_hi) {
  tally<OP>(local, bits2(got), __bfloat16_as_ushort(want_lo));
  tally<OP>(local, bits2(got) >> 16, __bfloat16_as_ushort(want_hi));
}

template <int OP>
__device__ __forceinline__ void tally_mask(
    unsigned (&local)[kPkOps][kPkCounts], unsigned got, bool want_lo,
    bool want_hi) {
  tally<OP>(local, got, want_lo ? 0xFFFFu : 0u);
  tally<OP>(local, got >> 16, want_hi ? 0xFFFFu : 0u);
}

// Thread (x, y): the operand pair b = (2x, 2x + 1) as bit patterns against
// the 256 values a = 256 y .. 256 y + 255 in both lanes; the grid covers all
// 2^32 (a, b).  The unary operations see every b once (y == 0).
__global__ void __launch_bounds__(kThreads)
packed_bf16_check_kernel(unsigned long long* __restrict__ counts) {
  const unsigned pair = blockIdx.x * kThreads + threadIdx.x;
  const bf b0 = __ushort_as_bfloat16((unsigned short)(2u * pair));
  const bf b1 = __ushort_as_bfloat16((unsigned short)(2u * pair + 1u));
  const bf2 b = from_bits2(2u * pair | (2u * pair + 1u) << 16);
  unsigned local[kPkOps][kPkCounts] = {};
  for (unsigned i = 0; i < 256u; ++i) {
    const bf a = __ushort_as_bfloat16((unsigned short)(blockIdx.y * 256u + i));
    const bf2 a2 = both(a);
    tally2<kPkAdd>(local, add2(a2, b), add(a, b0), add(a, b1));
    tally2<kPkSub>(local, sub2(a2, b), sub(a, b0), sub(a, b1));
    tally2<kPkMul>(local, mul2(a2, b), mul(a, b0), mul(a, b1));
    tally2<kPkMax>(local, bmax2(a2, b), bmax(a, b0), bmax(a, b1));
    tally2<kPkMin>(local, bmin2(a2, b), bmin(a, b0), bmin(a, b1));
    tally2<kPkHmax>(local, __hmax2(a2, b), bmax(a, b0), bmax(a, b1));
    tally2<kPkHmin>(local, __hmin2(a2, b), bmin(a, b0), bmin(a, b1));
    tally_mask<kPkGe>(local, ge2(a2, b), F(a) >= F(b0), F(a) >= F(b1));
    tally_mask<kPkLe>(local, le2(a2, b), F(a) <= F(b0), F(a) <= F(b1));
    tally_mask<kPkGt>(local, gt2(a2, b), F(a) > F(b0), F(a) > F(b1));
  }
  if (blockIdx.y == 0) {
    tally2<kPkAbs>(local, abs2(b), babs(b0), babs(b1));
    tally2<kPkNeg>(local, neg2(b), bneg(b0), bneg(b1));
  }
#pragma unroll
  for (int op = 0; op < kPkOps; ++op) {
#pragma unroll
    for (int c = 0; c < kPkCounts; ++c) {
      if (local[op][c]) {
        atomicAdd(&counts[op * kPkCounts + c],
                  (unsigned long long)local[op][c]);
      }
    }
  }
}

}  // namespace

extern "C" {

// in/out: n contiguous u8 values, 16-byte aligned.  Each launcher runs on
// `stream` and returns cudaGetLastError() (0 on success).

// K4a: op 0 copy, 1 E, 2 G.
int mono_probe_launch(const void* in, void* out, long long n, int op,
                      int steps, void* stream) {
  if (bad_buffers(in, out, n, steps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kMonoCopy: return (int)launch(in, out, n, steps, Mono<kMonoCopy>(), s);
    case kMonoE: return (int)launch(in, out, n, steps, Mono<kMonoE>(), s);
    case kMonoG: return (int)launch(in, out, n, steps, Mono<kMonoG>(), s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4b: op is the index of the op in bench_fastmath.OPS.
int fastmath_probe_launch(const void* in, void* out, long long n, int op,
                          int steps, void* stream) {
  if (bad_buffers(in, out, n, steps)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (op) {
    case kFmCopy: err = launch(in, out, n, steps, FastMath<kFmCopy>(), s); break;
    case kFmPowBuiltin: err = launch(in, out, n, steps, FastMath<kFmPowBuiltin>(), s); break;
    case kFmPowFast: err = launch(in, out, n, steps, FastMath<kFmPowFast>(), s); break;
    case kFmPowExp2Log2: err = launch(in, out, n, steps, FastMath<kFmPowExp2Log2>(), s); break;
    case kFmPowExpLog: err = launch(in, out, n, steps, FastMath<kFmPowExpLog>(), s); break;
    case kFmCosBuiltin: err = launch(in, out, n, steps, FastMath<kFmCosBuiltin>(), s); break;
    case kFmCosFast: err = launch(in, out, n, steps, FastMath<kFmCosFast>(), s); break;
    case kFmDivBuiltin: err = launch(in, out, n, steps, FastMath<kFmDivBuiltin>(), s); break;
    case kFmDivFast: err = launch(in, out, n, steps, FastMath<kFmDivFast>(), s); break;
    case kFmCurveClip: err = launch(in, out, n, steps, FastMath<kFmCurveClip>(), s); break;
    case kFmCurveRelu: err = launch(in, out, n, steps, FastMath<kFmCurveRelu>(), s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// K4c: op 0 mul, 1 pow, 2 cos, 3 curve; style 0 f32, 1 bf16_cast,
// 2 bf16_splat; p0, p1 the two scalar parameters.
int bf16_probe_launch(const void* in, void* out, long long n, int op,
                      int style, int steps, float p0, float p1,
                      void* stream) {
  if (bad_buffers(in, out, n, steps)) return (int)cudaErrorInvalidValue;
  // the curve's knots are [p0, p1, p0, ...]; its norm in f32, summed in
  // the knots' order from 0
  float sum = 0.0f;
  for (int i = 0; i < kCurveKnots; ++i) sum += (i % 2 == 0) ? p0 : p1;
  const float norm = 8.0f / (sum + 1e-30f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (style) {
    case kF32:
      return (int)launch_style<kF32>(in, out, n, op, steps, p0, p1, norm, s);
    case kBf16Cast:
      return (int)launch_style<kBf16Cast>(in, out, n, op, steps, p0, p1,
                                          norm, s);
    case kBf16Splat:
      return (int)launch_style<kBf16Splat>(in, out, n, op, steps, p0, p1,
                                           norm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The packed bf16 operations of fastmath.cuh against their scalar forms
// over all 2^32 operand pairs (abs and neg over all 2^16 values): adds to
// counts[op * 3 + {0: results that differ, 1: those that are zeros of
// either sign, 2: NaN pairs with different bits}], 12 ops in PackedOp's
// order, 36 zeroed 64-bit integers on the device.
int packed_bf16_check_launch(void* counts, void* stream) {
  if (!counts) return (int)cudaErrorInvalidValue;
  const dim3 grid(32768 / kThreads, 256);
  packed_bf16_check_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

const char* probes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
