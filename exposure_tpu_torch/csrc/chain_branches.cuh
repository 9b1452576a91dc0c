// Branch math shared by the three chain kernels (dyn_chain.cu,
// switch_chain.cu, static_chain.cu), so that the dynamic, switch and
// grouped replays of one plan run one copy of each filter's f32 math.
//
// Counterpart of the planar branch set of exposure_tpu/ops/pallas_chain.py
// (`_PLANAR_IMPL`, `_PLANAR_IMPL_FAST`, `_with_mask`, `_vignet_masked`);
// the fast-math helpers it uses live in fastmath.cuh.  The plain PyTorch
// version of the same math is exposure_tpu_torch/ops/dyn_chain.py.
//
// Every kernel that includes this header is built without --use_fast_math:
// the exact branch set must stay exact, and the S+ gray test divides by
// the channel range.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fastmath.cuh"

namespace {

constexpr int kMaxFilters = 32;
constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;
constexpr int kMaxGridY = 65535;   // launchers split larger batches

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
  int H, W, K, P;          // P: staged parameter row width
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

__device__ __forceinline__ float lum_of(float r, float g, float b) {
  return 0.27f * r + 0.67f * g + 0.06f * b;
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

__device__ __forceinline__ float half_cos_pi(float x) {
  return -cosf(3.14159265358979323846f * x) * 0.5f + 0.5f;
}

// sum_i t_i clip(x - i/K, 0, 1/K) * K / (1e-30 + sum_i t_i)
__device__ __forceinline__ float curve_exact(float x, const float* t,
                                             int steps) {
  float psum = 1e-30f;
  for (int i = 0; i < steps; ++i) psum += t[i];
  const float width = 1.0f / (float)steps;
  float total = 0.0f;
  for (int i = 0; i < steps; ++i) {
    const float lo = (float)i / (float)steps;
    total += fminf(fmaxf(x - lo, 0.0f), width) * t[i];
  }
  return total * ((float)steps / psum);
}

template <bool FAST>
__device__ __forceinline__ float curve(float x, const float* t, int steps) {
  return FAST ? curve_fast(x, t, steps) : curve_exact(x, t, steps);
}

template <bool FAST>
__device__ __forceinline__ void saturation_plus(float& r, float& g,
                                                float& b, const float* p) {
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
  const float t = p[0];
  const float fr = gray ? v : v - (v - r1) * ratio;
  const float fg = gray ? vg : v - (v - g1) * ratio;
  const float fb = gray ? vg : v - (v - b1) * ratio;
  r = r1 * (1.0f - t) + fr * t;
  g = g1 * (1.0f - t) + fg * t;
  b = b1 * (1.0f - t) + fb * t;
}

// One unmasked filter step.
template <bool FAST>
__device__ __forceinline__ void apply_branch(int code, float& r, float& g,
                                             float& b, const float* p,
                                             const ChainArgs& a) {
  switch (code) {
    case kExposure: {
      const float m = expf(p[0] * 0.6931471805599453f);
      r *= m; g *= m; b *= m;
      break;
    }
    case kGamma: {
      const float gm = p[0];
      if (FAST) {
        r = gamma_fast(r, gm);
        g = gamma_fast(g, gm);
        b = gamma_fast(b, gm);
      } else {
        r = gamma_exact(r, gm);
        g = gamma_exact(g, gm);
        b = gamma_exact(b, gm);
      }
      break;
    }
    case kWhiteBalance:
      r *= p[0]; g *= p[1]; b *= p[2];
      break;
    case kSaturationPlus:
      saturation_plus<FAST>(r, g, b, p);
      break;
    case kTone:
      r = curve<FAST>(r, p, a.curve_steps);
      g = curve<FAST>(g, p, a.curve_steps);
      b = curve<FAST>(b, p, a.curve_steps);
      break;
    case kContrast: {
      const float lum = clamp01(lum_of(r, g, b));
      const float clum = FAST ? fast_half_cos_pi(lum) : half_cos_pi(lum);
      const float scale = clum / (lum + 1e-6f);
      const float t = p[0];
      r = r + (r * scale - r) * t;
      g = g + (g * scale - g) * t;
      b = b + (b * scale - b) * t;
      break;
    }
    case kBlackWhite: {
      const float lum = lum_of(r, g, b);
      const float t = p[0];
      r = r + (lum - r) * t;
      g = g + (lum - g) * t;
      b = b + (lum - b) * t;
      break;
    }
    case kColor:
      r = curve<FAST>(r, p, a.curve_steps);
      g = curve<FAST>(g, p + a.curve_steps, a.curve_steps);
      b = curve<FAST>(b, p + 2 * a.curve_steps, a.curve_steps);
      break;
    case kLevel: {
      const float lo = p[0];
      const float hi = p[1] + 1.0f;
      const float inv = 1.0f / (hi - lo + 1e-6f);
      r = clamp01((r - lo) * inv);
      g = clamp01((g - lo) * inv);
      b = clamp01((b - lo) * inv);
      break;
    }
    default:  // identity
      break;
  }
}

// One step with the spatial masks: the 6-parameter sigmoid mask blends
// each filter in; the vignette has its own 5-parameter elliptical mask.
template <bool FAST>
__device__ __forceinline__ void apply_branch_masked(
    int code, float& r, float& g, float& b, const float* p, float gx,
    float gy, const ChainArgs& a) {
  const float fir = 5.0f;  // filter_input_range
  const float* mp = p + a.mask_offset;
  if (code == kVignet) {
    const float m0 = tanhf(mp[0]) * fir, m1 = tanhf(mp[1]) * fir;
    const float m2 = tanhf(mp[2]) * fir, m3 = tanhf(mp[3]) * fir;
    const float m4 = tanhf(mp[4]) * fir;
    const float ex = gx * m0, ey = gy * m1;
    float inp = ex * ex + ey * ey + m2 - fir;
    inp = inp * (a.max_sharpness * m3 / fir);
    const float mask = sigmoidf(inp) * (m4 / fir * 0.5f + 0.5f);
    const float inv = 1.0f - mask;
    r *= inv; g *= inv; b *= inv;
    return;
  }
  if (code < 0 || code >= kVignet) return;  // identity
  float r2 = r, g2 = g, b2 = b;
  apply_branch<FAST>(code, r2, g2, b2, p, a);
  float m[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) m[j] = tanhf(mp[j]) * fir;
  const float lum = lum_of(r, g, b);
  float inp = gx * m[0] + gy * m[1] + m[2] * (lum - 0.5f) + m[3] * 2.0f;
  inp = inp * (a.max_sharpness * m[4] / fir);
  float mask = sigmoidf(inp);
  mask = mask * (m[5] / fir * 0.5f + 0.5f) * a.one_minus_min_strength +
         a.min_strength;
  r = r + (r2 - r) * mask;
  g = g + (g2 - g) * mask;
  b = b + (b2 - b) * mask;
}

// The normalized centered mask grid at a pixel: x runs over rows and y
// over columns (pallas_chain.py:515-522).
__device__ __forceinline__ void mask_grid(long long pix, const ChainArgs& a,
                                          float& gx, float& gy) {
  const int row_i = (int)(pix / a.W);
  const int col_j = (int)(pix - (long long)row_i * a.W);
  gx = ((float)row_i + a.grid_off_h) / a.shorter - 0.5f;
  gy = ((float)col_j + a.grid_off_w) / a.shorter - 0.5f;
}

__device__ __forceinline__ float load_px(const uint8_t v) {
  return (float)v * (1.0f / 255.0f);
}
__device__ __forceinline__ float load_px(const float v) { return v; }

// u8: round half to even of clip(x, 0, 1) * 255, as jnp.round.
__device__ __forceinline__ uint8_t quantize_px(float x) {
  return (uint8_t)__float2int_rn(clamp01(x) * 255.0f);
}
__device__ __forceinline__ void store_px(uint8_t* dst, float x) {
  *dst = quantize_px(x);
}
__device__ __forceinline__ void store_px(float* dst, float x) { *dst = x; }

// The K-step chain over one block's pixels of one image: each thread reads
// its pixels of `src` once, runs step k with branch code s_code[k] and the
// parameter row s_params + k * a.P, and writes `dst` once.  r, g, b stay
// in registers through all K steps.
template <typename T, bool FAST, bool MASKED>
__device__ __forceinline__ void chain_pixels(const T* __restrict__ src,
                                             T* __restrict__ dst,
                                             const int* s_code,
                                             const float* s_params,
                                             const ChainArgs& a) {
  const long long hw = (long long)a.H * a.W;
  const long long base =
      (long long)blockIdx.x * (kThreads * kPixelsPerThread) + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kPixelsPerThread; ++it) {
    const long long pix = base + (long long)it * kThreads;
    if (pix >= hw) break;
    float r = load_px(src[pix * 3 + 0]);
    float g = load_px(src[pix * 3 + 1]);
    float bl = load_px(src[pix * 3 + 2]);
    float gx = 0.0f, gy = 0.0f;
    if (MASKED) mask_grid(pix, a, gx, gy);
    for (int k = 0; k < a.K; ++k) {
      const int code = s_code[k];
      const float* p = s_params + k * a.P;
      if (MASKED) {
        apply_branch_masked<FAST>(code, r, g, bl, p, gx, gy, a);
      } else {
        apply_branch<FAST>(code, r, g, bl, p, a);
      }
    }
    store_px(dst + pix * 3 + 0, r);
    store_px(dst + pix * 3 + 1, g);
    store_px(dst + pix * 3 + 2, bl);
  }
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

// Pixel blocks of one image: the grid is (pixel blocks, images).
inline unsigned pixel_blocks(int H, int W) {
  const long long hw = (long long)H * W;
  const long long per_block = (long long)kThreads * kPixelsPerThread;
  return (unsigned)((hw + per_block - 1) / per_block);
}

}  // namespace
