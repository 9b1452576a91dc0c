// Dynamic filter-chain kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dyn_chain_kernel` reached through
// `pallas_apply_filter_chain_dynamic` (exposure_tpu/ops/pallas_chain.py),
// with its branch math (`_PLANAR_IMPL`, `_PLANAR_IMPL_FAST`, `_with_mask`,
// `_vignet_masked`) and the fast-math helpers `fast_half_cos_pi` and
// `curve_relu` (exposure_tpu/ops/fastmath.py).
//
// What it computes: a K-step filter chain per image.  Step k of image b
// runs the filter whose id is ids[b, k] with the scalar parameters
// params[b, k, :]; an id outside [0, n_filters) is the identity (an
// inactive step).  u8 images are dequantized on load (x / 255) and
// quantized on store (round half to even of clip(x, 0, 1) * 255), as the
// TPU kernel does with jnp.round.  With masking on, every step is blended
// in by a sigmoid mask evaluated from the global pixel grid.
//
// What bounds it on an H100: memory traffic.  With u8 in and out a pixel
// costs 6 bytes (3 read, 3 written): a 512-image batch of 512x512 moves
// about 805 MB.  Against that, each pixel runs at most 5 branches of f32
// math on scalar parameters (tens to a few hundred flops per step).
//
// What this simple design does about it: each pixel is read once and
// written once, and its r, g, b stay in registers through all K steps.
// The grid is (pixel blocks, B): a block belongs to one image, so the
// filter id of each step is uniform across the block and the branch is a
// plain switch with no warp divergence (the counterpart of the TPU
// kernel's pl.when on an SMEM scalar).  Each block stages its image's K
// branch codes and K x P parameters in shared memory.  The image is read
// NHWC directly: the TPU wrapper's planar transpose, padding and batch
// chunking exist for the TPU's tiling and are gone.  Vector loads and
// more pixels per thread are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (exposure_tpu_torch/kernels/__init__.py).
// No --use_fast_math: the exact branch set must stay exact, and the S+
// gray test divides by the channel range.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxFilters = 32;
constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;

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
  int H, W, K, P;          // P: packed parameter row width
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

// -cos(pi x)/2 + 1/2 via the odd sin polynomial of fastmath.py.
__device__ __forceinline__ float fast_half_cos_pi(float x) {
  const float u = x - 0.5f;
  const float z = u * u;
  float acc = -0.55945275f;
  acc = acc * z + 2.54400687f;
  acc = acc * z + -5.16740635f;
  acc = acc * z + 3.14159026f;
  return acc * u * 0.5f + 0.5f;
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

// The same curve in the telescoped max form of fastmath.py::curve_relu.
__device__ __forceinline__ float curve_fast(float x, const float* t,
                                            int steps) {
  float psum = 1e-30f;
  for (int i = 0; i < steps; ++i) psum += t[i];
  const float norm = (float)steps / psum;
  float total = fmaxf(x, 0.0f) * t[0];
  float c0 = t[steps - 1];
  for (int i = 1; i < steps; ++i) {
    const float d = t[i] - t[i - 1];
    const float c = (float)i / (float)steps;
    total += fmaxf(x, c) * d;
    c0 -= d * c;
  }
  total -= fmaxf(x, 1.0f) * t[steps - 1];
  return (total + c0) * norm;
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
        r = exp2f(gm * log2f(fmaxf(r, 0.001f)));
        g = exp2f(gm * log2f(fmaxf(g, 0.001f)));
        b = exp2f(gm * log2f(fmaxf(b, 0.001f)));
      } else {
        r = powf(fmaxf(r, 0.001f), gm);
        g = powf(fmaxf(g, 0.001f), gm);
        b = powf(fmaxf(b, 0.001f), gm);
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
      const float clum = FAST
          ? fast_half_cos_pi(lum)
          : -cosf(3.14159265358979323846f * lum) * 0.5f + 0.5f;
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

__device__ __forceinline__ float load_px(const uint8_t v) {
  return (float)v * (1.0f / 255.0f);
}
__device__ __forceinline__ float load_px(const float v) { return v; }

__device__ __forceinline__ void store_px(uint8_t* dst, float x) {
  *dst = (uint8_t)__float2int_rn(clamp01(x) * 255.0f);
}
__device__ __forceinline__ void store_px(float* dst, float x) { *dst = x; }

template <typename T, bool FAST, bool MASKED>
__global__ void __launch_bounds__(kThreads)
dyn_chain_kernel(const T* __restrict__ img, T* __restrict__ out,
                 const int32_t* __restrict__ ids,
                 const float* __restrict__ params, BranchTable table,
                 ChainArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int kp = a.K * a.P;
  float* s_params = smem;
  int* s_code = reinterpret_cast<int*>(smem + kp);

  const float* row = params + (size_t)b * kp;
  for (int i = threadIdx.x; i < kp; i += blockDim.x) s_params[i] = row[i];
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    const int id = ids[(size_t)b * a.K + k];
    s_code[k] = (id >= 0 && id < a.n_filters) ? (int)table.code[id]
                                              : (int)kIdentity;
  }
  __syncthreads();

  const long long hw = (long long)a.H * a.W;
  const T* src = img + (size_t)b * (size_t)hw * 3;
  T* dst = out + (size_t)b * (size_t)hw * 3;
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
    if (MASKED) {
      const int row_i = (int)(pix / a.W);
      const int col_j = (int)(pix - (long long)row_i * a.W);
      // x runs over rows and y over columns (pallas_chain.py:515-522)
      gx = ((float)row_i + a.grid_off_h) / a.shorter - 0.5f;
      gy = ((float)col_j + a.grid_off_w) / a.shorter - 0.5f;
    }
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

template <typename T, bool FAST, bool MASKED>
cudaError_t launch(const void* img, void* out, const void* ids,
                   const void* params, const BranchTable& table,
                   const ChainArgs& a, int B, cudaStream_t stream) {
  const long long hw = (long long)a.H * a.W;
  const long long per_block = (long long)kThreads * kPixelsPerThread;
  const dim3 grid((unsigned)((hw + per_block - 1) / per_block),
                  (unsigned)B);
  const size_t smem =
      (size_t)a.K * a.P * sizeof(float) + (size_t)a.K * sizeof(int);
  dyn_chain_kernel<T, FAST, MASKED><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out),
      static_cast<const int32_t*>(ids), static_cast<const float*>(params),
      table, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* img, void* out, const void* ids,
                         const void* params, const BranchTable& table,
                         const ChainArgs& a, int B, int fast, int masked,
                         cudaStream_t s) {
  if (fast) {
    return masked ? launch<T, true, true>(img, out, ids, params, table, a, B, s)
                  : launch<T, true, false>(img, out, ids, params, table, a, B, s);
  }
  return masked ? launch<T, false, true>(img, out, ids, params, table, a, B, s)
                : launch<T, false, false>(img, out, ids, params, table, a, B, s);
}

}  // namespace

extern "C" {

// img/out: [B, H, W, 3] u8 (is_u8) or f32; ids: [B, K] int32;
// params: [B, K, P] f32; codes: host array of n_filters branch codes.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int dyn_chain_launch(const void* img, void* out, const void* ids,
                     const void* params, const int* codes, int n_filters,
                     int B, int H, int W, int K, int P, int mask_offset,
                     int is_u8, int fast, int masked, int curve_steps,
                     float max_sharpness, float min_strength,
                     float one_minus_min_strength, float shorter,
                     float grid_off_h, float grid_off_w, void* stream) {
  if (n_filters < 0 || n_filters > kMaxFilters || B <= 0 || B > 65535 ||
      H <= 0 || W <= 0 || K <= 0 || P <= 0 || curve_steps <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  BranchTable table;
  for (int i = 0; i < kMaxFilters; ++i) {
    table.code[i] = (int8_t)(i < n_filters ? codes[i] : kIdentity);
  }
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_u8
      ? launch_typed<uint8_t>(img, out, ids, params, table, a, B, fast, masked, s)
      : launch_typed<float>(img, out, ids, params, table, a, B, fast, masked, s);
  return (int)err;
}

const char* dyn_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
