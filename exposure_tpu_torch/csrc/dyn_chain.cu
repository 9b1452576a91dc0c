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
// What bounds it on an H100 (ops/dyn_chain.py::chain_cost counts both
// bounds): with u8 in and out a pixel costs 6 bytes (3 read, 3 written),
// so a 512-image batch of 512x512 moves 805 MB, 0.240 ms at 3.35 TB/s.
// The served trajectory (E, G, S+, T, Ct in the fast set) runs 198 f32
// operations a pixel, most of them in the curves, the S+ HSV round trip
// and the contrast: 0.389 ms at 67 TFLOP/s.  So the redesigned kernel sits
// nearer its operations bound than its bytes bound.
//
// The design (chain_branches.cuh): the grid is (pixel blocks, B) and a
// block belongs to one image, so the code of each step is uniform across
// the block and the branch is a plain switch with no warp divergence (the
// counterpart of the TPU kernel's pl.when on an SMEM scalar).  In the
// prologue the threads k < K read step k's id and raw parameters and write
// its code and per-step plan to shared memory; then each thread reads its
// run of 16 pixels with 16-byte loads, applies the K steps, branching once
// per step, and writes the run with 16-byte stores.  The image is read
// NHWC directly: the TPU wrapper's planar transpose and padding exist for
// the TPU's tiling and are gone.  Grid dimension y holds at most 65535
// images, so the launcher splits a larger batch into several launches.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (exposure_tpu_torch/kernels/__init__.py).
// No --use_fast_math: the exact branch set must stay exact, and the S+
// gray test divides by the channel range.

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_branches.cuh"

namespace {

template <typename T, bool FAST, bool MASKED, int S>
__global__ void dyn_chain_kernel(const T* __restrict__ img, T* __restrict__ out,
                 const int32_t* __restrict__ ids,
                 const float* __restrict__ params, int b0,
                 const __grid_constant__ BranchTable table,
                 const __grid_constant__ ChainArgs a) {
  const int b = blockIdx.y + b0;
  chain_image<T, ChainF32<FAST, MASKED, S>>(
      img + image_offset(b, a), out + image_offset(b, a), a,
      [&](int k, int* s_code, float* plan) {
        const int id = ids[(size_t)b * a.K + k];
        const int code = (id >= 0 && id < a.n_filters) ? (int)table.code[id]
                                                       : (int)kIdentity;
        const float* p = params + ((size_t)b * a.K + k) * a.P;
        s_code[k] = code;
        plan_step<FAST, MASKED>(code, p, p + a.mask_offset, a, plan);
      });
}

template <typename T, bool FAST, bool MASKED>
cudaError_t launch(const void* img, void* out, const void* ids,
                   const void* params, const BranchTable& table,
                   const ChainArgs& a, int B, cudaStream_t stream) {
  const size_t smem = plan_smem_bytes(a.K, a.curve_steps);
  return with_curve_steps(a.curve_steps, [&](auto steps) {
    constexpr int S = decltype(steps)::value;
    for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
      const int n = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
      const dim3 grid(chain_blocks(a.H, a.W), (unsigned)n);
      dyn_chain_kernel<T, FAST, MASKED, S><<<grid, kThreads, smem, stream>>>(
          static_cast<const T*>(img), static_cast<T*>(out),
          static_cast<const int32_t*>(ids), static_cast<const float*>(params),
          b0, table, a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  });
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
// img and out may have any 4-byte (f32) or byte (u8) alignment.
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
