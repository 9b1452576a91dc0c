// The filter-chain core shared by the three chain kernels (dyn_chain.cu,
// switch_chain.cu, static_chain.cu), so that the dynamic, switch and
// grouped replays of one plan run one copy of each filter's f32 math, and
// the switch kernel's bf16 path one copy of the frame around it.
//
// Counterpart of the planar branch set of exposure_tpu/ops/pallas_chain.py
// (`_PLANAR_IMPL`, `_PLANAR_IMPL_FAST`, `_with_mask`, `_vignet_masked`);
// the fast-math helpers it uses live in fastmath.cuh.  The plain PyTorch
// version of the same math is exposure_tpu_torch/ops/dyn_chain.py.
//
// The design, for an H100:
//
// - A per-step plan, made once per block.  In each kernel's prologue the
//   threads k < K turn step k's raw parameters into the scalars its branch
//   needs per pixel (`plan_step`): E's multiplier, each curve's weights or
//   differences, C0 and norm, Level's reciprocal, the tanh-mapped mask
//   parameters with the sharpness and strength factors.  The TPU kernel
//   folded these into scalar-unit arithmetic at trace time; computed per
//   pixel they cost about 24 IEEE divides a pixel per curve step.  Each
//   scalar is written with the expression, in the order, that the per-pixel
//   code used before, so the per-pixel result is unchanged.
// - The curve's knot count fixed at compile time (`S`, 8 in every config):
//   the knot positions i/S fold to constants and the curve loops unroll, as
//   in the TPU kernel.  S = 0 is the generic instantiation for any other
//   count, which reads the plan from shared memory at each use.
// - One branch per step, not per pixel: a thread holds the r, g, b of N
//   pixels in registers and, for each step, enters the switch on the
//   block-uniform code once and applies the branch to its N pixels: N
//   independent chains for the scheduler to interleave.
// - 16-byte I/O: a thread owns a run of kRun = 16 contiguous pixels, 48
//   bytes of u8 (three 16-byte loads and stores) or 192 of f32 (twelve).
//   An image's base is not always 16-byte aligned (odd shapes, `rows`, a
//   storage offset), so the runs start at the image's first aligned pixel;
//   the pixels before it (the head) and after the last full run (the tail)
//   take the scalar path in the kernel, as does a whole image whose input
//   and output disagree in alignment.  The u8 conversions run on the f32
//   pipe (load_px, quantize_bits below).
// - The frame takes the arithmetic as a parameter: `chain_image` does the
//   run mapping, the I/O and the staging of the plans, and a `Math` (ChainF32
//   here, ChainBf16 in switch_chain.cu) makes a step's plan and applies the
//   K steps to the pixels.
// - Arguments by value: every kernel takes ChainArgs and its code table as
//   __grid_constant__ parameters, read in place, with no local copy.
// - No __launch_bounds__ on the f32 chain kernels: with
//   __launch_bounds__(256) ptxas held the masked u8 variants to 64
//   registers and spilled (a 48-56 byte stack frame); without it no variant
//   spills or has a stack frame, and the served one uses 72 registers.
//
// Every kernel that includes this header is built without --use_fast_math:
// the exact branch set must stay exact, and the S+ gray test divides by
// the channel range.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "fastmath.cuh"

namespace {

constexpr int kMaxFilters = 32;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;   // launchers split larger batches
constexpr int kCurveSteps = 8;     // curve_steps of every config
constexpr int kRun = 16;           // pixels a thread owns: 48 u8 bytes

// Branch codes; exposure_tpu_torch/ops/dyn_chain.py::BRANCH_CODES keeps
// the same numbering.
enum Branch : int {
  kExposure = 0,
  kGamma = 1,
  kWhiteBalance = 2,
  kSaturationPlus = 3,
  kTone = 4,
  kContrast = 5,
  kBlackWhite = 6,
  kColor = 7,
  kLevel = 8,
  kVignet = 9,
  kIdentity = 10,
};

struct BranchTable {
  int8_t code[kMaxFilters];
};

struct ChainArgs {
  int n_filters;
  int H, W, K, P;          // P: parameter row width
  int mask_offset;         // start of the mask parameters in a row
  int curve_steps;
  float max_sharpness;
  float min_strength;
  float one_minus_min_strength;
  float shorter;           // min(H, W)
  float grid_off_h;        // (shorter - H) / 2
  float grid_off_w;        // (shorter - W) / 2
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// 0.27 r + 0.67 g + 0.06 b with its FMAs written out: left to the
// compiler, the contraction's order depended on the code around it.
__device__ __forceinline__ float lum_of(float r, float g, float b) {
  return fmaf(0.06f, b, fmaf(0.67f, g, 0.27f * r));
}

// The library calls of the exact set and of the fast gamma, which the
// probes (probes.cu) time beside their polynomial counterparts.
__device__ __forceinline__ float gamma_exact(float x, float g) {
  return powf(fmaxf(x, 0.001f), g);
}

// exp2(g log2 x): the same function as pow on the clamped input
__device__ __forceinline__ float gamma_fast(float x, float g) {
  return exp2f(g * log2f(fmaxf(x, 0.001f)));
}

// -cos(pi x)/2 + 1/2 through the library's cospif: the exact set's cos,
// which K4b's cos_builtin times (probes.cu).  cospif reduces its argument
// exactly and keeps no local array, where cosf of the rounded product pi x
// gives every kernel that calls it a 32-byte stack frame (the reduction for
// large arguments); the two differ by an ulp on some inputs.
__device__ __forceinline__ float half_cospi(float x) {
  return -cospif(x) * 0.5f + 0.5f;
}

template <bool FAST>
__device__ __forceinline__ void saturation_plus(float& r, float& g,
                                                float& b, float t) {
  const float r1 = fminf(r, 1.0f), g1 = fminf(g, 1.0f), b1 = fminf(b, 1.0f);
  const float v = fmaxf(fmaxf(r1, g1), b1);
  const float mn = fminf(fminf(r1, g1), b1);
  const float rng = v - mn;
  const float k = (0.5f - fabsf(0.5f - v)) * 0.8f;
  const float one_m_k = 1.0f - k;
  const bool vpos = v > 0.0f;
  const float safe_v = vpos ? v : 1.0f;
  const float rng_pos = vpos ? rng : 0.0f;
  // the fast set pins a small relative band to the gray (hue 0) path,
  // see pallas_chain.py::_saturation_fast
  const bool gray = FAST ? (rng <= 2e-4f * safe_v) : (rng <= 0.0f);
  const float ratio = (one_m_k * rng_pos + k * safe_v) / (gray ? 1.0f : rng);
  const float vg = one_m_k * (v - rng_pos);
  const float fr = gray ? v : v - (v - r1) * ratio;
  const float fg = gray ? vg : v - (v - g1) * ratio;
  const float fb = gray ? vg : v - (v - b1) * ratio;
  r = r1 * (1.0f - t) + fr * t;
  g = g1 * (1.0f - t) + fg * t;
  b = b1 * (1.0f - t) + fb * t;
}

// ---------------------------------------------------------------------------
// the per-step plan
// ---------------------------------------------------------------------------

// A curve's plan: the exact set's [t_0 .. t_{S-1}, norm], or the fast set's
// telescoped max form [t_0, d_1 .. d_{S-1}, t_{S-1}, C0, norm], with
// d_i = t_i - t_{i-1} and norm = S / (1e-30 + sum t).
__host__ __device__ constexpr int curve_plan_floats(int steps) {
  return steps + 3;
}
// A step's plan: room for three curves (C), then the six mask scalars.
__host__ __device__ constexpr int mask_plan_offset(int steps) {
  return 3 * curve_plan_floats(steps);
}
__host__ __device__ constexpr int plan_floats(int steps) {
  return mask_plan_offset(steps) + 6;
}
// The dynamic shared memory of a K-step block: codes, then plans.
inline size_t plan_smem_bytes(int K, int steps) {
  return (size_t)K * sizeof(int) + (size_t)K * plan_floats(steps) * sizeof(float);
}

template <bool FAST>
__device__ __forceinline__ void plan_curve(const float* t, int steps,
                                           float* q) {
  float psum = 1e-30f;
  for (int i = 0; i < steps; ++i) psum += t[i];
  const float norm = (float)steps / psum;
  if (FAST) {
    float c0 = t[steps - 1];
    q[0] = t[0];
    for (int i = 1; i < steps; ++i) {
      const float d = t[i] - t[i - 1];
      const float c = (float)i / (float)steps;
      q[i] = d;
      c0 -= d * c;
    }
    q[steps] = t[steps - 1];
    q[steps + 1] = c0;
    q[steps + 2] = norm;
  } else {
    for (int i = 0; i < steps; ++i) q[i] = t[i];
    q[steps] = norm;
  }
}

// Step plan `q` of branch `code` from its raw parameters `p` and its raw
// mask parameters `mp` (read only when masking).
template <bool FAST, bool MASKED>
__device__ __forceinline__ void plan_step(int code, const float* p,
                                          const float* mp,
                                          const ChainArgs& a, float* q) {
  const int steps = a.curve_steps;
  const float fir = 5.0f;  // filter_input_range
  switch (code) {
    case kExposure:
      q[0] = expf(p[0] * 0.6931471805599453f);
      break;
    case kGamma:
    case kSaturationPlus:
    case kContrast:
    case kBlackWhite:
      q[0] = p[0];
      break;
    case kWhiteBalance:
      q[0] = p[0]; q[1] = p[1]; q[2] = p[2];
      break;
    case kTone:
      plan_curve<FAST>(p, steps, q);
      break;
    case kColor:
      for (int c = 0; c < 3; ++c) {
        plan_curve<FAST>(p + c * steps, steps, q + c * curve_plan_floats(steps));
      }
      break;
    case kLevel: {
      const float lo = p[0];
      const float hi = p[1] + 1.0f;
      q[0] = lo;
      q[1] = 1.0f / (hi - lo + 1e-6f);
      break;
    }
    case kVignet:
      if (MASKED) {
        const float m3 = tanhf(mp[3]) * fir, m4 = tanhf(mp[4]) * fir;
        q[0] = tanhf(mp[0]) * fir;
        q[1] = tanhf(mp[1]) * fir;
        q[2] = tanhf(mp[2]);   // its * fir is fused per pixel (run_step)
        q[3] = a.max_sharpness * m3 / fir;
        q[4] = m4 / fir * 0.5f + 0.5f;
      }
      break;
    default:  // identity
      break;
  }
  if (MASKED && code >= 0 && code < kVignet) {
    float* qm = q + mask_plan_offset(steps);
    const float m4 = tanhf(mp[4]) * fir, m5 = tanhf(mp[5]) * fir;
#pragma unroll
    for (int j = 0; j < 4; ++j) qm[j] = tanhf(mp[j]) * fir;
    qm[4] = a.max_sharpness * m4 / fir;
    qm[5] = m5 / fir * 0.5f + 0.5f;
  }
}

// A curve evaluated from its plan; S > 0 holds the plan in registers and
// unrolls, S == 0 reads it from shared memory at each use.
template <bool FAST, int S>
struct Curve {
  float q[S + 3];
  __device__ __forceinline__ Curve(const float* plan, int) {
#pragma unroll
    for (int i = 0; i < S + 3; ++i) q[i] = plan[i];
  }
  // The sums' FMAs are written out: unrolled, the compiler fused the first
  // two terms the other way round.
  __device__ __forceinline__ float operator()(float x) const {
    if (FAST) {
      float total = fmaxf(x, 0.0f) * q[0];
#pragma unroll
      for (int i = 1; i < S; ++i) {
        total = fmaf(fmaxf(x, (float)i / (float)S), q[i], total);
      }
      total -= fmaxf(x, 1.0f) * q[S];
      return (total + q[S + 1]) * q[S + 2];
    }
    const float width = 1.0f / (float)S;
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      total = fmaf(fminf(fmaxf(x - (float)i / (float)S, 0.0f), width), q[i],
                   total);
    }
    return total * q[S];
  }
};

template <bool FAST>
struct Curve<FAST, 0> {
  const float* q;
  int steps;
  __device__ __forceinline__ Curve(const float* plan, int n)
      : q(plan), steps(n) {}
  __device__ __forceinline__ float operator()(float x) const {
    if (FAST) {
      float total = fmaxf(x, 0.0f) * q[0];
      for (int i = 1; i < steps; ++i) {
        total = fmaf(fmaxf(x, (float)i / (float)steps), q[i], total);
      }
      total -= fmaxf(x, 1.0f) * q[steps];
      return (total + q[steps + 1]) * q[steps + 2];
    }
    const float width = 1.0f / (float)steps;
    float total = 0.0f;
    for (int i = 0; i < steps; ++i) {
      total = fmaf(fminf(fmaxf(x - (float)i / (float)steps, 0.0f), width),
                   q[i], total);
    }
    return total * q[steps];
  }
};

// The 6-parameter sigmoid mask of a step, from its plan.
struct MaskPlan {
  float m0, m1, m2, m3, sharp, amp;
  __device__ __forceinline__ explicit MaskPlan(const float* qm)
      : m0(qm[0]), m1(qm[1]), m2(qm[2]), m3(qm[3]), sharp(qm[4]),
        amp(qm[5]) {}
  // the mask at a pixel, from its input (r, g, b) and grid position
  __device__ __forceinline__ float mask(float r, float g, float b, float gx,
                                        float gy, const ChainArgs& a) const {
    const float lum = lum_of(r, g, b);
    // gx m0 + gy m1 + m2 (lum - 1/2) + 2 m3, its FMAs written out in the
    // order the per-pixel code before the plan contracted them
    float inp = fmaf(m3, 2.0f, fmaf(lum - 0.5f, m2, fmaf(gx, m0, gy * m1)));
    inp = inp * sharp;
    const float m = sigmoidf(inp);
    return m * amp * a.one_minus_min_strength + a.min_strength;
  }
};

// Blend a channel's branch output x2 into x by the pixel's mask.  x2 - x is
// rounded on its own (__fsub_rn is never contracted): inlined beside the
// branch, the compiler would fuse a branch that ends in a product (E, W,
// the curves) into fma(x, m, -x), where the plain version and the earlier
// per-pixel code round the branch's output before blending it.
__device__ __forceinline__ void blend(float& x, float x2, float mask) {
  x = fmaf(__fsub_rn(x2, x), mask, x);
}

// ---------------------------------------------------------------------------
// one step on N pixels
// ---------------------------------------------------------------------------

// Step plan `q` with branch `code` on the N pixels (pr, pg, pb); with
// masking each branch is blended in by its mask at the pixel's grid
// position (gx, gy), and the vignette has its own elliptical mask.
template <bool FAST, bool MASKED, int S, int N>
__device__ __forceinline__ void run_step(int code, const float* q,
                                         float (&pr)[N], float (&pg)[N],
                                         float (&pb)[N], const float (&gx)[N],
                                         const float (&gy)[N],
                                         const ChainArgs& a) {
  const int steps = S ? S : a.curve_steps;
  if (MASKED) {
    if (code == kVignet) {
      const float fir = 5.0f;
      const float m0 = q[0], m1 = q[1], t2 = q[2], sharp = q[3], amp = q[4];
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float ex = gx[n] * m0, ey = gy[n] * m1;
        // ex^2 + ey^2 + m2 - fir with m2 = tanh(mp[2]) * fir, its FMAs
        // written out as the per-pixel code before the plan contracted them
        float inp = fmaf(t2, fir, fmaf(ex, ex, ey * ey)) - fir;
        inp = inp * sharp;
        const float mask = sigmoidf(inp) * amp;
        const float inv = 1.0f - mask;
        pr[n] *= inv; pg[n] *= inv; pb[n] *= inv;
      }
      return;
    }
    if (code < 0 || code >= kVignet) return;  // identity
  }
  // With masking, each pixel's mask first, from its input: then a branch
  // can run channel by channel and blend each channel as it goes.
  float mask[N];
  if constexpr (MASKED) {
    const MaskPlan mk(q + mask_plan_offset(steps));
#pragma unroll
    for (int n = 0; n < N; ++n) {
      mask[n] = mk.mask(pr[n], pg[n], pb[n], gx[n], gy[n], a);
    }
  }
  // f(r, g, b) on every pixel, blended by its mask when masking
  auto each = [&](auto f) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if constexpr (MASKED) {
        float r2 = pr[n], g2 = pg[n], b2 = pb[n];
        f(r2, g2, b2);
        blend(pr[n], r2, mask[n]);
        blend(pg[n], g2, mask[n]);
        blend(pb[n], b2, mask[n]);
      } else {
        f(pr[n], pg[n], pb[n]);
      }
    }
  };
  // curve c on channel x of every pixel, blended when masking
  auto each_channel = [&](float (&x)[N], const float* plan) {
    const Curve<FAST, S> c(plan, steps);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if constexpr (MASKED) {
        blend(x[n], c(x[n]), mask[n]);
      } else {
        x[n] = c(x[n]);
      }
    }
  };
  switch (code) {
    case kExposure: {
      const float m = q[0];
      each([&](float& r, float& g, float& b) { r *= m; g *= m; b *= m; });
      break;
    }
    case kGamma: {
      const float gm = q[0];
      each([&](float& r, float& g, float& b) {
        if (FAST) {
          r = gamma_fast(r, gm); g = gamma_fast(g, gm); b = gamma_fast(b, gm);
        } else {
          r = gamma_exact(r, gm); g = gamma_exact(g, gm);
          b = gamma_exact(b, gm);
        }
      });
      break;
    }
    case kWhiteBalance: {
      const float w0 = q[0], w1 = q[1], w2 = q[2];
      each([&](float& r, float& g, float& b) { r *= w0; g *= w1; b *= w2; });
      break;
    }
    case kSaturationPlus: {
      const float t = q[0];
      each([&](float& r, float& g, float& b) {
        saturation_plus<FAST>(r, g, b, t);
      });
      break;
    }
    case kTone: {
      each_channel(pr, q);
      each_channel(pg, q);
      each_channel(pb, q);
      break;
    }
    case kContrast: {
      const float t = q[0];
      each([&](float& r, float& g, float& b) {
        const float lum = clamp01(lum_of(r, g, b));
        const float clum = FAST ? fast_half_cos_pi(lum) : half_cospi(lum);
        const float scale = clum / (lum + 1e-6f);
        r = r + (r * scale - r) * t;
        g = g + (g * scale - g) * t;
        b = b + (b * scale - b) * t;
      });
      break;
    }
    case kBlackWhite: {
      const float t = q[0];
      each([&](float& r, float& g, float& b) {
        const float lum = lum_of(r, g, b);
        r = r + (lum - r) * t;
        g = g + (lum - g) * t;
        b = b + (lum - b) * t;
      });
      break;
    }
    case kColor: {   // channel by channel: one curve's plan live at a time
      const int cp = curve_plan_floats(steps);
      each_channel(pr, q);
      each_channel(pg, q + cp);
      each_channel(pb, q + 2 * cp);
      break;
    }
    case kLevel: {
      const float lo = q[0], inv = q[1];
      each([&](float& r, float& g, float& b) {
        r = clamp01((r - lo) * inv);
        g = clamp01((g - lo) * inv);
        b = clamp01((b - lo) * inv);
      });
      break;
    }
    default:  // identity (and the vignette without masking)
      break;
  }
}

// ---------------------------------------------------------------------------
// pixel I/O: a thread's run of kRun pixels
// ---------------------------------------------------------------------------

// u8 conversions on the f32 pipe.  An int-to-float or float-to-int
// conversion issues at a fraction of the f32 rate, and a chain converts
// every value twice, so both are done with the 2^23 trick, which is exact
// for a byte: 0x4B000000 | v is the float 2^23 + v, and x + 1.5 * 2^23 for
// x in [0, 255] rounds x half to even into the sum's low mantissa byte.

// v * (1/255) for byte `k` of the word `w`
__device__ __forceinline__ float load_px(uint32_t w, int k) {
  const uint32_t bits = __byte_perm(w, 0x4B000000u, 0x7440u | (uint32_t)k);
  return (__uint_as_float(bits) - 8388608.0f) * (1.0f / 255.0f);
}

__device__ __forceinline__ float load_px(const uint8_t v) {
  return load_px((uint32_t)v, 0);
}

// round half to even of clip(x, 0, 1) * 255, as jnp.round, in the low byte
// of the returned word (the other bytes are not zero).  The product is
// rounded before the add (an FMA would round once, not twice).
__device__ __forceinline__ uint32_t quantize_bits(float x) {
  return __float_as_uint(__fadd_rn(clamp01(x) * 255.0f, 12582912.0f));
}

__device__ __forceinline__ uint8_t quantize_px(float x) {
  return (uint8_t)quantize_bits(x);
}

template <typename T>
struct Run;

// 48 bytes in 12 words; value j is byte j (pixel j / 3, channel j % 3)
template <>
struct Run<uint8_t> {
  uint32_t w[3 * kRun / 4];
  __device__ __forceinline__ void load(const uint8_t* src, int count,
                                       bool full) {
    if (full) {
      const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint4 v = s[i];
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < 3 * kRun / 4; ++i) w[i] = 0u;
#pragma unroll
    for (int j = 0; j < 3 * kRun; ++j) {
      if (j < 3 * count) w[j / 4] |= (uint32_t)src[j] << (8 * (j % 4));
    }
  }
  __device__ __forceinline__ float get(int j) const {
    return load_px(w[j / 4], j % 4);
  }
  // Values are set in ascending j, every one of a word that is stored:
  // byte 0 replaces the whole word (the input's bits are dead from there,
  // which frees their registers; the sum's upper bytes are overwritten by
  // the next three values), bytes 1 to 3 are inserted.
  __device__ __forceinline__ void set(int j, float x) {
    const uint32_t q = quantize_bits(x);
    if (j % 4 == 0) {
      w[j / 4] = q;
    } else {
      const uint32_t keep = 0x3210u & ~(0xFu << (4 * (j % 4)));
      w[j / 4] = __byte_perm(w[j / 4], q, keep | (4u << (4 * (j % 4))));
    }
  }
  __device__ __forceinline__ void store(uint8_t* dst, int count,
                                        bool full) const {
    if (full) {
      uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        d[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 3 * kRun; ++j) {
      if (j < 3 * count) dst[j] = (uint8_t)(w[j / 4] >> (8 * (j % 4)));
    }
  }
};

template <>
struct Run<float> {
  float v[3 * kRun];
  __device__ __forceinline__ void load(const float* src, int count,
                                       bool full) {
    if (full) {
      const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int i = 0; i < 3 * kRun / 4; ++i) {
        const float4 x = s[i];
        v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z;
        v[4 * i + 3] = x.w;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 3 * kRun; ++j) v[j] = j < 3 * count ? src[j] : 0.0f;
  }
  __device__ __forceinline__ float get(int j) const { return v[j]; }
  __device__ __forceinline__ void set(int j, float x) { v[j] = x; }
  __device__ __forceinline__ void store(float* dst, int count,
                                        bool full) const {
    if (full) {
      float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int i = 0; i < 3 * kRun / 4; ++i) {
        d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < 3 * kRun; ++j) {
      if (j < 3 * count) dst[j] = v[j];
    }
  }
};

// Pixels before the first 16-byte aligned pixel of an image at `p` (u8:
// 3-byte pixels, 3 * 11 = 1 mod 16; f32: 12-byte pixels on a 4-byte
// aligned base).
template <typename T>
__device__ __forceinline__ int head_pixels(const T* p) {
  const unsigned gap = (16u - (unsigned)((uintptr_t)p & 15u)) & 15u;
  return sizeof(T) == 1 ? (int)((gap * 11u) & 15u)
                        : (int)(((gap >> 2) * 3u) & 3u);
}

// How one image's pixels fall into runs: an optional head run of `head`
// pixels, then runs of kRun from the first aligned pixel, the last one
// ragged.  With input and output aligned differently every run takes the
// scalar path (head 0).
struct RunMap {
  long long hw;
  int head;
  bool vec;
  long long runs;
};

template <typename T>
__device__ __forceinline__ RunMap run_map(const T* src, const T* dst,
                                          const ChainArgs& a) {
  RunMap m;
  m.hw = (long long)a.H * a.W;
  const int hs = head_pixels(src);
  m.vec = hs == head_pixels(dst);
  m.head = m.vec ? (int)(hs < m.hw ? hs : m.hw) : 0;
  m.runs = (m.head > 0) + (m.hw - m.head + kRun - 1) / kRun;
  return m;
}

// Blocks along x that cover the runs of an image of any alignment.
inline unsigned chain_blocks(int H, int W) {
  const long long runs = 1 + ((long long)H * W + kRun - 1) / kRun;
  return (unsigned)((runs + kThreads - 1) / kThreads);
}

// The f32 arithmetic of a chain, as `chain_image` takes it: the plan's
// scalar type Q (4 bytes), the compiled knot count S, the N pixels a thread
// holds at a time (all kRun unmasked; a quarter with masking, which also
// holds each pixel's grid position and mask), `plan` (a step's plan from its
// raw parameters) and `pixels` (the K steps on group h of a thread's run).
// kMasked: the bank masks, so `pixels` reads the grid position.
template <bool FAST, bool MASKED, int S_>
struct ChainF32 {
  typedef float Q;
  static constexpr int S = S_;
  static constexpr bool kMasked = MASKED;
  static constexpr int N = MASKED ? kRun / 4 : kRun;

  __device__ __forceinline__ static void plan(int code, const float* p,
                                              const float* mp,
                                              const ChainArgs& a, float* q) {
    plan_step<FAST, MASKED>(code, p, mp, a, q);
  }

  // `row`, `col`: the grid position of the group's first pixel, advanced
  // past the group (read only when masking)
  template <typename T>
  __device__ __forceinline__ static void pixels(Run<T>& run, int h,
                                                const int* s_code,
                                                const float* s_plan,
                                                int stride, int& row,
                                                int& col,
                                                const ChainArgs& a) {
    float r[N], g[N], b[N], gx[N], gy[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int j = (h * N + n) * 3;
      r[n] = run.get(j);
      g[n] = run.get(j + 1);
      b[n] = run.get(j + 2);
      if (MASKED) {  // the normalized centered grid (pallas_chain.py:515-522)
        gx[n] = ((float)row + a.grid_off_h) / a.shorter - 0.5f;
        gy[n] = ((float)col + a.grid_off_w) / a.shorter - 0.5f;
        if (++col == a.W) {
          col = 0;
          ++row;
        }
      }
    }
    for (int k = 0; k < a.K; ++k) {
      run_step<FAST, MASKED, S, N>(s_code[k], s_plan + k * stride, r, g, b,
                                   gx, gy, a);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int j = (h * N + n) * 3;
      run.set(j, r[n]);
      run.set(j + 1, g[n]);
      run.set(j + 2, b[n]);
    }
  }
};

// The K-step chain over one image, the body of every chain kernel, in the
// arithmetic `Math` (ChainF32 above; switch_chain.cu's ChainBf16): each
// thread reads its run of kRun pixels (16-byte loads where aligned), the
// block makes its per-step plans (`stage(k, s_code, plan)` for each step k,
// on threads k < K, while the pixels are in flight), and each thread applies
// the K steps, branch code s_code[k] on step k's plan, to Math::N pixels at
// a time (`Math::pixels`), then writes its run once.  A block whose runs all
// lie past the image's returns before it loads anything.
template <typename T, typename Math, typename Stage>
__device__ __forceinline__ void chain_image(const T* __restrict__ src,
                                            T* __restrict__ dst,
                                            const ChainArgs& a,
                                            const Stage& stage) {
  typedef typename Math::Q Q;
  static_assert(sizeof(Q) == sizeof(float), "a plan entry is 4 bytes");
  const RunMap m = run_map(src, dst, a);
  if ((long long)blockIdx.x * kThreads >= m.runs) return;
  extern __shared__ float smem[];
  int* s_code = reinterpret_cast<int*>(smem);
  Q* s_plan = reinterpret_cast<Q*>(smem + a.K);
  const int stride = plan_floats(Math::S ? Math::S : a.curve_steps);

  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < m.runs;
  const int has_head = m.head > 0;
  long long start = 0;
  int count = 0;
  if (t < has_head) {
    count = m.head;
  } else if (live) {
    start = m.head + (t - has_head) * kRun;
    count = (int)(m.hw - start < kRun ? m.hw - start : kRun);
  }
  const bool full = m.vec && count == kRun;
  Run<T> run;
  if (live) run.load(src + start * 3, count, full);

  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    stage(k, s_code, s_plan + k * stride);
  }
  __syncthreads();
  if (!live) return;

  int row = 0, col = 0;
  if (Math::kMasked) {   // the run's first grid position
    row = (int)(start / a.W);
    col = (int)(start - (long long)row * a.W);
  }
#pragma unroll
  for (int h = 0; h < kRun / Math::N; ++h) {
    Math::pixels(run, h, s_code, s_plan, stride, row, col, a);
  }
  run.store(dst + start * 3, count, full);
}

// The offset of image `row` in a [B, H, W, 3] batch, in elements.
__device__ __forceinline__ size_t image_offset(int row, const ChainArgs& a) {
  return (size_t)row * (size_t)a.H * (size_t)a.W * 3;
}

// Host side: the arguments every chain kernel shares, from the launcher's
// flat C arguments; codes[i] for i >= n_filters is the identity.
inline ChainArgs make_chain_args(int n_filters, int H, int W, int K, int P,
                                 int mask_offset, int curve_steps,
                                 float max_sharpness, float min_strength,
                                 float one_minus_min_strength, float shorter,
                                 float grid_off_h, float grid_off_w) {
  ChainArgs a;
  a.n_filters = n_filters;
  a.H = H; a.W = W; a.K = K; a.P = P;
  a.mask_offset = mask_offset;
  a.curve_steps = curve_steps;
  a.max_sharpness = max_sharpness;
  a.min_strength = min_strength;
  a.one_minus_min_strength = one_minus_min_strength;
  a.shorter = shorter;
  a.grid_off_h = grid_off_h;
  a.grid_off_w = grid_off_w;
  return a;
}

inline BranchTable make_branch_table(const int* codes, int n_filters) {
  BranchTable table;
  for (int i = 0; i < kMaxFilters; ++i) {
    table.code[i] = (int8_t)(i < n_filters ? codes[i] : kIdentity);
  }
  return table;
}

// launch(std::integral_constant<int, S>) with S = kCurveSteps when the
// config's knot count is that, else the generic instantiation S = 0.
template <typename L>
cudaError_t with_curve_steps(int curve_steps, const L& launch) {
  return curve_steps == kCurveSteps
      ? launch(std::integral_constant<int, kCurveSteps>())
      : launch(std::integral_constant<int, 0>());
}

}  // namespace
