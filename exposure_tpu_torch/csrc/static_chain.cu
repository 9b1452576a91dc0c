// Static filter-chain kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_static_chain_kernel` reached through
// `pallas_apply_filter_chain_static` (exposure_tpu/ops/pallas_chain.py),
// which the grouped replay runs once per trajectory signature.  The branch
// math is chain_branches.cuh, shared with the dynamic and switch kernels.
//
// What it computes: one K-step chain whose signature (the filter of each
// step) is shared by every image of the launch.  Slot i < n_active reads
// image rows[i] (or image i without `rows`), runs the signature with that
// image's parameters params[k, row, :] (and mask[k, row, :] when masking)
// and writes out[row]; slots at or past n_active do no work, and their
// output is left as it was.  An id outside [0, n_filters) is the identity.
// u8 is dequantized on load and quantized on store (round half to even).
//
// What bounds it on an H100: 6 bytes a pixel for u8 in and out, and the
// operations of the signature's branches, as for the dynamic kernel (see
// dyn_chain.cu); on the served signature the operations bound the larger.
//
// The design: the TPU compiled one program per signature because its
// lax.switch ran every branch; here a switch on a block-uniform code is
// real control flow, so one compiled kernel serves every signature, and
// the branch math, per-step plan and 16-pixel runs are the dynamic
// kernel's (chain_branches.cuh: one copy, so the modes agree bit for bit).
// The K branch codes and n_active come in by value from the host; the grid
// is (pixel blocks, slots), a block belongs to one slot, and a block past
// n_active returns before loading a pixel.  The gather of a group's images
// and the scatter of its results happen in the kernel through `rows` (the
// TPU wrapper's jnp.take and .at[].set(mode='drop') around the call), so a
// group is one launch; a slot's image base, and so its alignment, comes
// from rows[i].  Parameters are read in the plan's own [K, B, P] layout by
// the prologue's threads k < K, which write the block's per-step plans to
// shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (exposure_tpu_torch/kernels/__init__.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_branches.cuh"

namespace {

constexpr int kMaxSteps = 32;

struct Signature {
  int8_t code[kMaxSteps];
};

template <typename T, bool FAST, bool MASKED, int S>
__global__ void static_chain_kernel(const T* __restrict__ img, T* __restrict__ out,
                    const float* __restrict__ params,
                    const float* __restrict__ mask,
                    const int32_t* __restrict__ rows, int i0, int n_active,
                    int B, int M, const __grid_constant__ Signature sig,
                    const __grid_constant__ ChainArgs a) {
  const int i = blockIdx.y + i0;
  if (i >= n_active) return;   // padded slot: no load, no math, no store
  const int row = rows ? rows[i] : i;
  const int pp = a.mask_offset;   // packed filter-parameter width
  chain_image<T, ChainF32<FAST, MASKED, S>>(
      img + image_offset(row, a), out + image_offset(row, a), a,
      [&](int k, int* s_code, float* plan) {
        const int code = sig.code[k];
        s_code[k] = code;
        plan_step<FAST, MASKED>(code, params + ((size_t)k * B + row) * pp,
                                MASKED ? mask + ((size_t)k * B + row) * M
                                       : nullptr,
                                a, plan);
      });
}

template <typename T, bool FAST, bool MASKED>
cudaError_t launch(const void* img, void* out, const void* params,
                   const void* mask, const void* rows, int n, int n_active,
                   int B, int M, const Signature& sig, const ChainArgs& a,
                   cudaStream_t stream) {
  const size_t smem = plan_smem_bytes(a.K, a.curve_steps);
  const int n_run = n_active < n ? n_active : n;
  return with_curve_steps(a.curve_steps, [&](auto steps) {
    constexpr int S = decltype(steps)::value;
    for (int i0 = 0; i0 < n_run; i0 += kMaxGridY) {
      const int chunk = n_run - i0 < kMaxGridY ? n_run - i0 : kMaxGridY;
      const dim3 grid(chain_blocks(a.H, a.W), (unsigned)chunk);
      static_chain_kernel<T, FAST, MASKED, S>
          <<<grid, kThreads, smem, stream>>>(
              static_cast<const T*>(img), static_cast<T*>(out),
              static_cast<const float*>(params),
              static_cast<const float*>(mask),
              static_cast<const int32_t*>(rows), i0, n_active, B, M, sig, a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  });
}

template <typename T>
cudaError_t launch_typed(const void* img, void* out, const void* params,
                         const void* mask, const void* rows, int n,
                         int n_active, int B, int M, const Signature& sig,
                         const ChainArgs& a, int fast, int masked,
                         cudaStream_t s) {
  if (fast) {
    return masked
        ? launch<T, true, true>(img, out, params, mask, rows, n, n_active, B, M, sig, a, s)
        : launch<T, true, false>(img, out, params, mask, rows, n, n_active, B, M, sig, a, s);
  }
  return masked
      ? launch<T, false, true>(img, out, params, mask, rows, n, n_active, B, M, sig, a, s)
      : launch<T, false, false>(img, out, params, mask, rows, n, n_active, B, M, sig, a, s);
}

}  // namespace

extern "C" {

// img/out: [B, H, W, 3] u8 (is_u8) or f32, the whole batch; params:
// [K, B, Pp] f32; mask: [K, B, M] f32 or null (masked == 0); rows: [n]
// int32 image indices or null (slot i is image i, n <= B); signature: host
// array of K branch codes.  Slots at or past n_active do nothing.  img and
// out may have any 4-byte (f32) or byte (u8) alignment.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int static_chain_launch(const void* img, void* out, const void* params,
                        const void* mask, const void* rows,
                        const int* signature, int n, int n_active, int B,
                        int H, int W, int K, int Pp, int M, int is_u8,
                        int fast, int masked, int curve_steps,
                        float max_sharpness, float min_strength,
                        float one_minus_min_strength, float shorter,
                        float grid_off_h, float grid_off_w, void* stream) {
  if (n < 0 || B <= 0 || H <= 0 || W <= 0 || K <= 0 || K > kMaxSteps ||
      Pp <= 0 || M < 0 || curve_steps <= 0 || (masked && (!mask || M < 6)) ||
      (!rows && n > B)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || n_active <= 0) return (int)cudaSuccess;
  Signature sig;
  for (int k = 0; k < kMaxSteps; ++k) {
    sig.code[k] = (int8_t)(k < K ? signature[k] : kIdentity);
  }
  const int width = Pp + (masked ? M : 0);
  const ChainArgs a = make_chain_args(
      0, H, W, K, width, Pp, curve_steps, max_sharpness, min_strength,
      one_minus_min_strength, shorter, grid_off_h, grid_off_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_u8
      ? launch_typed<uint8_t>(img, out, params, mask, rows, n, n_active, B, M, sig, a, fast, masked, s)
      : launch_typed<float>(img, out, params, mask, rows, n, n_active, B, M, sig, a, fast, masked, s);
  return (int)err;
}

const char* static_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
