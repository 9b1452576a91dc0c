// Dynamic filter-chain kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dyn_chain_kernel` reached through
// `pallas_apply_filter_chain_dynamic` (exposure_tpu/ops/pallas_chain.py).
// Its branch math lives in chain_branches.cuh, shared with the switch and
// static chain kernels.
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
// NHWC directly: the TPU wrapper's planar transpose and padding exist for
// the TPU's tiling and are gone.  Grid dimension y holds at most 65535
// images, so the launcher splits a larger batch into several launches.
// Vector loads and more pixels per thread are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (exposure_tpu_torch/kernels/__init__.py).
// No --use_fast_math: the exact branch set must stay exact, and the S+
// gray test divides by the channel range.

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_branches.cuh"

namespace {

template <typename T, bool FAST, bool MASKED>
__global__ void __launch_bounds__(kThreads)
dyn_chain_kernel(const T* __restrict__ img, T* __restrict__ out,
                 const int32_t* __restrict__ ids,
                 const float* __restrict__ params, int b0, BranchTable table,
                 ChainArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.y + b0;
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
  chain_pixels<T, FAST, MASKED>(img + image_offset(b, a),
                                out + image_offset(b, a), s_code, s_params,
                                a);
}

template <typename T, bool FAST, bool MASKED>
cudaError_t launch(const void* img, void* out, const void* ids,
                   const void* params, const BranchTable& table,
                   const ChainArgs& a, int B, cudaStream_t stream) {
  const size_t smem =
      (size_t)a.K * a.P * sizeof(float) + (size_t)a.K * sizeof(int);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int n = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const dim3 grid(pixel_blocks(a.H, a.W), (unsigned)n);
    dyn_chain_kernel<T, FAST, MASKED><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(img), static_cast<T*>(out),
        static_cast<const int32_t*>(ids), static_cast<const float*>(params),
        b0, table, a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  if (n_filters < 0 || n_filters > kMaxFilters || B <= 0 || H <= 0 ||
      W <= 0 || K <= 0 || P <= 0 || curve_steps <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const BranchTable table = make_branch_table(codes, n_filters);
  const ChainArgs a = make_chain_args(
      n_filters, H, W, K, P, mask_offset, curve_steps, max_sharpness,
      min_strength, one_minus_min_strength, shorter, grid_off_h, grid_off_w);
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
