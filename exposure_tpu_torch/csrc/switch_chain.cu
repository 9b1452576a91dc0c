// Switch filter-chain kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_chain_kernel` reached through `_chain_call` and
// `pallas_apply_filter_chain` (exposure_tpu/ops/pallas_chain.py): the
// switch-mode replay, the grouped runner's fallback for batches with many
// signatures, and its merge of small groups and of superset leftovers.
//
// What it computes: a K-step chain with a filter id per image and step,
// ids[k, row] and parameters params[k, row, :] (mask[k, row, :] when
// masking), in one of two compute types.  Slot i < n_active reads image
// rows[i] (image i without `rows`) and writes out[row]; slots at or past
// n_active do nothing.  An id outside [0, n_filters) is the identity.
//
// - f32: the core of chain_branches.cuh (branch math, per-step plan made in
//   the prologue, 16-pixel runs with 16-byte I/O), shared with the dynamic
//   and static kernels, so the modes agree bit for bit.
// - bf16: r, g, b and the parameters are __nv_bfloat16.  Every add,
//   subtract, multiply and divide is done in f32 with the _rn intrinsics
//   (which nvcc never contracts into an FMA) and rounded to bf16 at once;
//   exp2, log2, pow, cos, tanh and the sigmoid are evaluated in f32 on the
//   bf16 value and rounded; every constant is first rounded to bf16.  That
//   is the semantics of the TPU kernel's compute_dtype=bfloat16 (bf16
//   arrays, weakly typed constants) and of the plain PyTorch version in
//   ops/switch_chain.py.  u8 is dequantized in f32 and rounded to bf16, and
//   quantized from the f32 value of the bf16 result, as the TPU kernel does.
//
// What bounds it on an H100: memory traffic (6 bytes a pixel for u8 in
// and out); bf16 does not move fewer bytes here, since pixels live in
// registers between load and store.
//
// What this design does about it: the TPU's lax.switch ran every
// branch; on the card a switch on a block-uniform id is real control flow,
// so each step costs only its own branch.  The grid is (pixel blocks,
// slots), reading the plan's [K, B, P] layout directly.  The f32 path's
// prologue writes its row's K branch codes and per-step plans to shared
// memory; the bf16 path, not yet redesigned, stages its row's K x (P + M)
// parameters in bf16 and runs 4 pixels a thread with byte loads.  `rows` lets the grouped runner merge a few images of a batch
// in one launch without gathering or scattering whole images.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (exposure_tpu_torch/kernels/__init__.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_branches.cuh"

namespace {

// ---------------------------------------------------------------------------
// the bf16 branch set (its arithmetic: fastmath.cuh's bf16 section)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bf lum_bf(bf r, bf g, bf b) {
  return add(add(mul(C(0.27f), r), mul(C(0.67f), g)), mul(C(0.06f), b));
}

// steps / (1e-30 + sum t): torch evaluates `steps / psum` as
// psum.reciprocal() * steps
__device__ __forceinline__ bf curve_norm_bf(const bf* t, int steps) {
  bf psum = add(C(1e-30f), t[0]);
  for (int i = 1; i < steps; ++i) psum = add(psum, t[i]);
  return mul(rcp(psum), C((float)steps));
}

__device__ __forceinline__ bf curve_exact_bf(bf x, const bf* t, int steps) {
  const bf norm = curve_norm_bf(t, steps);
  const bf width = C(1.0f / (float)steps);
  bf total = mul(x, C(0.0f));
  for (int i = 0; i < steps; ++i) {
    const bf lo = C((float)i / (float)steps);
    total = add(total, mul(bclamp(sub(x, lo), C(0.0f), width), t[i]));
  }
  return mul(total, norm);
}

__device__ __forceinline__ bf curve_fast_bf(bf x, const bf* t, int steps) {
  return curve_relu_bf(x, t, steps, curve_norm_bf(t, steps));
}

template <bool FAST>
__device__ __forceinline__ bf curve_bf(bf x, const bf* t, int steps) {
  return FAST ? curve_fast_bf(x, t, steps) : curve_exact_bf(x, t, steps);
}

template <bool FAST>
__device__ __forceinline__ void saturation_plus_bf(bf& r, bf& g, bf& b,
                                                   const bf* p) {
  const bf one = C(1.0f), half = C(0.5f), zero = C(0.0f);
  const bf r1 = bmin(r, one), g1 = bmin(g, one), b1 = bmin(b, one);
  const bf v = bmax(bmax(r1, g1), b1);
  const bf mn = bmin(bmin(r1, g1), b1);
  const bf rng = sub(v, mn);
  const bf k = mul(sub(half, babs(sub(half, v))), C(0.8f));
  const bf one_m_k = sub(one, k);
  const bool vpos = F(v) > 0.0f;
  const bf safe_v = vpos ? v : one;
  const bf rng_pos = vpos ? rng : zero;
  const bool gray = FAST ? (F(rng) <= F(mul(C(2e-4f), safe_v)))
                         : (F(rng) <= 0.0f);
  const bf ratio = dvd(add(mul(one_m_k, rng_pos), mul(k, safe_v)),
                       gray ? one : rng);
  const bf vg = mul(one_m_k, sub(v, rng_pos));
  const bf t = p[0];
  const bf keep = sub(one, t);
  const bf fr = gray ? v : sub(v, mul(sub(v, r1), ratio));
  const bf fg = gray ? vg : sub(v, mul(sub(v, g1), ratio));
  const bf fb = gray ? vg : sub(v, mul(sub(v, b1), ratio));
  r = add(mul(r1, keep), mul(fr, t));
  g = add(mul(g1, keep), mul(fg, t));
  b = add(mul(b1, keep), mul(fb, t));
}

template <bool FAST>
__device__ __forceinline__ void apply_branch_bf(int code, bf& r, bf& g,
                                                bf& b, const bf* p,
                                                int steps) {
  switch (code) {
    case kExposure: {
      const bf m = R(expf(F(mul(p[0], C(0.6931471805599453f)))));
      r = mul(r, m); g = mul(g, m); b = mul(b, m);
      break;
    }
    case kGamma: {
      const float gm = F(p[0]);
      const bf lo = C(0.001f);
      if (FAST) {
        r = R(exp2f(F(mul(p[0], R(log2f(F(bmax(r, lo))))))));
        g = R(exp2f(F(mul(p[0], R(log2f(F(bmax(g, lo))))))));
        b = R(exp2f(F(mul(p[0], R(log2f(F(bmax(b, lo))))))));
      } else {
        r = R(powf(F(bmax(r, lo)), gm));
        g = R(powf(F(bmax(g, lo)), gm));
        b = R(powf(F(bmax(b, lo)), gm));
      }
      break;
    }
    case kWhiteBalance:
      r = mul(r, p[0]); g = mul(g, p[1]); b = mul(b, p[2]);
      break;
    case kSaturationPlus:
      saturation_plus_bf<FAST>(r, g, b, p);
      break;
    case kTone:
      r = curve_bf<FAST>(r, p, steps);
      g = curve_bf<FAST>(g, p, steps);
      b = curve_bf<FAST>(b, p, steps);
      break;
    case kContrast: {
      const bf lum = bclamp(lum_bf(r, g, b), C(0.0f), C(1.0f));
      const bf clum = FAST
          ? fast_half_cos_pi_bf(lum)
          : add(mul(bneg(R(cosf(F(mul(C(3.14159265358979323846f), lum))))),
                    C(0.5f)),
                C(0.5f));
      const bf scale = dvd(clum, add(lum, C(1e-6f)));
      const bf t = p[0];
      r = add(r, mul(sub(mul(r, scale), r), t));
      g = add(g, mul(sub(mul(g, scale), g), t));
      b = add(b, mul(sub(mul(b, scale), b), t));
      break;
    }
    case kBlackWhite: {
      const bf lum = lum_bf(r, g, b);
      const bf t = p[0];
      r = add(r, mul(sub(lum, r), t));
      g = add(g, mul(sub(lum, g), t));
      b = add(b, mul(sub(lum, b), t));
      break;
    }
    case kColor:
      r = curve_bf<FAST>(r, p, steps);
      g = curve_bf<FAST>(g, p + steps, steps);
      b = curve_bf<FAST>(b, p + 2 * steps, steps);
      break;
    case kLevel: {
      const bf lo = p[0];
      const bf hi = add(p[1], C(1.0f));
      const bf inv = rcp(add(sub(hi, lo), C(1e-6f)));
      r = bclamp(mul(sub(r, lo), inv), C(0.0f), C(1.0f));
      g = bclamp(mul(sub(g, lo), inv), C(0.0f), C(1.0f));
      b = bclamp(mul(sub(b, lo), inv), C(0.0f), C(1.0f));
      break;
    }
    default:  // identity
      break;
  }
}

__device__ __forceinline__ bf sigmoid_bf(bf x) {
  return R(1.0f / (1.0f + expf(-F(x))));
}

template <bool FAST>
__device__ __forceinline__ void apply_branch_masked_bf(
    int code, bf& r, bf& g, bf& b, const bf* p, bf gx, bf gy,
    const ChainArgs& a) {
  const bf fir = C(5.0f);
  const bf* mp = p + a.mask_offset;
  const bf sharp = C(a.max_sharpness);
  if (code == kVignet) {
    bf m[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) m[j] = mul(R(tanhf(F(mp[j]))), fir);
    const bf ex = mul(gx, m[0]), ey = mul(gy, m[1]);
    bf inp = sub(add(add(mul(ex, ex), mul(ey, ey)), m[2]), fir);
    inp = mul(inp, dvd(mul(sharp, m[3]), fir));
    const bf mask = mul(sigmoid_bf(inp),
                        add(mul(dvd(m[4], fir), C(0.5f)), C(0.5f)));
    const bf inv = sub(C(1.0f), mask);
    r = mul(r, inv); g = mul(g, inv); b = mul(b, inv);
    return;
  }
  if (code < 0 || code >= kVignet) return;  // identity
  bf r2 = r, g2 = g, b2 = b;
  apply_branch_bf<FAST>(code, r2, g2, b2, p, a.curve_steps);
  bf m[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) m[j] = mul(R(tanhf(F(mp[j]))), fir);
  const bf lum = lum_bf(r, g, b);
  bf inp = add(add(add(mul(gx, m[0]), mul(gy, m[1])),
                   mul(m[2], sub(lum, C(0.5f)))),
               mul(m[3], C(2.0f)));
  inp = mul(inp, dvd(mul(sharp, m[4]), fir));
  bf mask = sigmoid_bf(inp);
  mask = add(mul(mul(mask, add(mul(dvd(m[5], fir), C(0.5f)), C(0.5f))),
                 C(a.one_minus_min_strength)),
             C(a.min_strength));
  r = add(r, mul(sub(r2, r), mask));
  g = add(g, mul(sub(g2, g), mask));
  b = add(b, mul(sub(b2, b), mask));
}

__device__ __forceinline__ bf load_bf(const uint8_t v) { return R(load_px(v)); }
__device__ __forceinline__ bf load_bf(const float v) { return R(v); }

__device__ __forceinline__ void store_px(uint8_t* dst, float x) {
  *dst = quantize_px(x);
}
__device__ __forceinline__ void store_px(float* dst, float x) { *dst = x; }

// The normalized centered mask grid at a pixel: x runs over rows and y
// over columns (pallas_chain.py:515-522).
__device__ __forceinline__ void mask_grid(long long pix, const ChainArgs& a,
                                          float& gx, float& gy) {
  const int row_i = (int)(pix / a.W);
  const int col_j = (int)(pix - (long long)row_i * a.W);
  gx = ((float)row_i + a.grid_off_h) / a.shorter - 0.5f;
  gy = ((float)col_j + a.grid_off_w) / a.shorter - 0.5f;
}

constexpr int kPixelsPerThread = 4;   // the bf16 path's pixels a thread

inline unsigned pixel_blocks(int H, int W) {
  const long long hw = (long long)H * W;
  const long long per_block = (long long)kThreads * kPixelsPerThread;
  return (unsigned)((hw + per_block - 1) / per_block);
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// Stage slot i's branch codes and K x (P + M) bf16 parameters (the bf16
// path); returns the slot's image row.
template <typename P>
__device__ __forceinline__ int stage_row(
    const int32_t* __restrict__ ids, const float* __restrict__ params,
    const float* __restrict__ mask, const int32_t* __restrict__ rows, int i,
    int B, int M, const BranchTable& table, const ChainArgs& a, P* s_params,
    int* s_code) {
  const int row = rows ? rows[i] : i;
  const int pp = a.mask_offset;
  const int kp = a.K * a.P;
  for (int idx = threadIdx.x; idx < kp; idx += blockDim.x) {
    const int k = idx / a.P, j = idx - k * a.P;
    const float v = j < pp ? params[((size_t)k * B + row) * pp + j]
                           : mask[((size_t)k * B + row) * M + (j - pp)];
    s_params[idx] = (P)v;
  }
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    const int id = ids[(size_t)k * B + row];
    s_code[k] = (id >= 0 && id < a.n_filters) ? (int)table.code[id]
                                              : (int)kIdentity;
  }
  __syncthreads();
  return row;
}

template <typename T, bool FAST, bool MASKED, int S>
__global__ void switch_chain_f32(const T* __restrict__ img, T* __restrict__ out,
                 const int32_t* __restrict__ ids,
                 const float* __restrict__ params,
                 const float* __restrict__ mask,
                 const int32_t* __restrict__ rows, int i0, int n_active,
                 int B, int M, const __grid_constant__ BranchTable table,
                 const __grid_constant__ ChainArgs a) {
  const int i = blockIdx.y + i0;
  if (i >= n_active) return;
  const int row = rows ? rows[i] : i;
  const int pp = a.mask_offset;
  chain_image<T, FAST, MASKED, S>(
      img + image_offset(row, a), out + image_offset(row, a), a,
      [&](int k, int* s_code, float* plan) {
        const int id = ids[(size_t)k * B + row];
        const int code = (id >= 0 && id < a.n_filters) ? (int)table.code[id]
                                                       : (int)kIdentity;
        s_code[k] = code;
        plan_step<FAST, MASKED>(code, params + ((size_t)k * B + row) * pp,
                                MASKED ? mask + ((size_t)k * B + row) * M
                                       : nullptr,
                                a, plan);
      });
}

template <typename T, bool FAST, bool MASKED>
__global__ void __launch_bounds__(kThreads)
switch_chain_bf16(const T* __restrict__ img, T* __restrict__ out,
                  const int32_t* __restrict__ ids,
                  const float* __restrict__ params,
                  const float* __restrict__ mask,
                  const int32_t* __restrict__ rows, int i0, int n_active,
                  int B, int M, const __grid_constant__ BranchTable table,
                  const __grid_constant__ ChainArgs a) {
  const int i = blockIdx.y + i0;
  if (i >= n_active) return;
  extern __shared__ float smem[];
  int* s_code = reinterpret_cast<int*>(smem);
  bf* s_params = reinterpret_cast<bf*>(s_code + a.K);
  const int row = stage_row(ids, params, mask, rows, i, B, M, table, a,
                            s_params, s_code);

  const long long hw = (long long)a.H * a.W;
  const T* src = img + image_offset(row, a);
  T* dst = out + image_offset(row, a);
  const long long base =
      (long long)blockIdx.x * (kThreads * kPixelsPerThread) + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kPixelsPerThread; ++it) {
    const long long pix = base + (long long)it * kThreads;
    if (pix >= hw) break;
    bf r = load_bf(src[pix * 3 + 0]);
    bf g = load_bf(src[pix * 3 + 1]);
    bf bl = load_bf(src[pix * 3 + 2]);
    bf gx = R(0.0f), gy = R(0.0f);
    if (MASKED) {
      float fx, fy;
      mask_grid(pix, a, fx, fy);
      gx = R(fx);
      gy = R(fy);
    }
    for (int k = 0; k < a.K; ++k) {
      const int code = s_code[k];
      const bf* p = s_params + k * a.P;
      if (MASKED) {
        apply_branch_masked_bf<FAST>(code, r, g, bl, p, gx, gy, a);
      } else {
        apply_branch_bf<FAST>(code, r, g, bl, p, a.curve_steps);
      }
    }
    store_px(dst + pix * 3 + 0, F(r));
    store_px(dst + pix * 3 + 1, F(g));
    store_px(dst + pix * 3 + 2, F(bl));
  }
}

struct Launch {
  const void* img;
  void* out;
  const void* ids;
  const void* params;
  const void* mask;
  const void* rows;
  int n, n_active, B, M;
};

// One launch per chunk of at most kMaxGridY slots, through `kernel(grid)`.
template <typename K>
cudaError_t launch_chunks(const Launch& l, unsigned blocks, const K& kernel) {
  const int n_run = l.n_active < l.n ? l.n_active : l.n;
  for (int i0 = 0; i0 < n_run; i0 += kMaxGridY) {
    const int chunk = n_run - i0 < kMaxGridY ? n_run - i0 : kMaxGridY;
    kernel(dim3(blocks, (unsigned)chunk), i0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, bool BF16, bool FAST, bool MASKED>
cudaError_t launch(const Launch& l, const BranchTable& table,
                   const ChainArgs& a, cudaStream_t stream) {
  const T* img = static_cast<const T*>(l.img);
  T* out = static_cast<T*>(l.out);
  const int32_t* ids = static_cast<const int32_t*>(l.ids);
  const float* params = static_cast<const float*>(l.params);
  const float* mask = static_cast<const float*>(l.mask);
  const int32_t* rows = static_cast<const int32_t*>(l.rows);
  if constexpr (BF16) {
    const size_t smem =
        (size_t)a.K * sizeof(int) + (size_t)a.K * a.P * sizeof(bf);
    return launch_chunks(l, pixel_blocks(a.H, a.W), [&](dim3 grid, int i0) {
      switch_chain_bf16<T, FAST, MASKED><<<grid, kThreads, smem, stream>>>(
          img, out, ids, params, mask, rows, i0, l.n_active, l.B, l.M, table,
          a);
    });
  }
  const size_t smem = plan_smem_bytes(a.K, a.curve_steps);
  return with_curve_steps(a.curve_steps, [&](auto steps) {
    constexpr int S = decltype(steps)::value;
    return launch_chunks(l, chain_blocks(a.H, a.W), [&](dim3 grid, int i0) {
      switch_chain_f32<T, FAST, MASKED, S><<<grid, kThreads, smem, stream>>>(
          img, out, ids, params, mask, rows, i0, l.n_active, l.B, l.M, table,
          a);
    });
  });
}

template <typename T, bool BF16>
cudaError_t launch_flags(const Launch& l, const BranchTable& table,
                         const ChainArgs& a, int fast, int masked,
                         cudaStream_t s) {
  if (fast) {
    return masked ? launch<T, BF16, true, true>(l, table, a, s)
                  : launch<T, BF16, true, false>(l, table, a, s);
  }
  return masked ? launch<T, BF16, false, true>(l, table, a, s)
                : launch<T, BF16, false, false>(l, table, a, s);
}

template <typename T>
cudaError_t launch_typed(const Launch& l, const BranchTable& table,
                         const ChainArgs& a, int bf16, int fast, int masked,
                         cudaStream_t s) {
  return bf16 ? launch_flags<T, true>(l, table, a, fast, masked, s)
              : launch_flags<T, false>(l, table, a, fast, masked, s);
}

}  // namespace

extern "C" {

// img/out: [B, H, W, 3] u8 (is_u8) or f32, the whole batch; ids: [K, B]
// int32; params: [K, B, Pp] f32; mask: [K, B, M] f32 or null (masked ==
// 0); rows: [n] int32 image indices or null (slot i is image i, n <= B);
// codes: host array of n_filters branch codes; bf16: the compute type.
// Slots at or past n_active do nothing.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int switch_chain_launch(const void* img, void* out, const void* ids,
                        const void* params, const void* mask,
                        const void* rows, const int* codes, int n_filters,
                        int n, int n_active, int B, int H, int W, int K,
                        int Pp, int M, int is_u8, int bf16, int fast,
                        int masked, int curve_steps, float max_sharpness,
                        float min_strength, float one_minus_min_strength,
                        float shorter, float grid_off_h, float grid_off_w,
                        void* stream) {
  if (n_filters < 0 || n_filters > kMaxFilters || n < 0 || B <= 0 ||
      H <= 0 || W <= 0 || K <= 0 || Pp <= 0 || M < 0 || curve_steps <= 0 ||
      (masked && (!mask || M < 6)) || (!rows && n > B)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || n_active <= 0) return (int)cudaSuccess;
  const BranchTable table = make_branch_table(codes, n_filters);
  const ChainArgs a = make_chain_args(
      n_filters, H, W, K, Pp + (masked ? M : 0), Pp, curve_steps,
      max_sharpness, min_strength, one_minus_min_strength, shorter,
      grid_off_h, grid_off_w);
  const Launch l = {img, out, ids, params, mask, rows, n, n_active, B, M};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_u8
      ? launch_typed<uint8_t>(l, table, a, bf16, fast, masked, s)
      : launch_typed<float>(l, table, a, bf16, fast, masked, s);
  return (int)err;
}

const char* switch_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
