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
//   subtract, multiply and divide rounds its result to bf16 at once (never
//   an FMA, which would drop a rounding); exp2, log2, pow, cos, tanh and the
//   sigmoid are evaluated in f32 on the bf16 value and rounded; every
//   constant is first rounded to bf16.  That is the semantics of the TPU
//   kernel's compute_dtype=bfloat16 (bf16 arrays, weakly typed constants)
//   and of the plain PyTorch version in ops/switch_chain.py.  u8 is
//   dequantized in f32 and rounded to bf16, and quantized from the f32 value
//   of the bf16 result, as the TPU kernel does.
//
// What bounds it on an H100: the branches' operations (about 200 a pixel on
// the served trajectory against 6 bytes of u8 in and out); bf16 does not
// move fewer bytes here, since pixels live in registers between load and
// store, and without FMA packed bf16 has the f32 rate of operations.
//
// What this design does about it: the TPU's lax.switch ran every
// branch; on the card a switch on a block-uniform id is real control flow,
// so each step costs only its own branch.  The grid is (pixel blocks,
// slots), reading the plan's [K, B, P] layout directly.  Both compute types
// run on chain_image's frame: the prologue writes the row's K branch codes
// and per-step plans to shared memory, and a thread moves 16 pixels with
// 16-byte loads and stores.  The bf16 path (ChainBf16 below) holds two
// pixels a register and runs fastmath.cuh's packed arithmetic; its plan is
// the per-pixel expressions that do not depend on the pixel (E's multiplier,
// each curve's norm, differences and C0, Level's reciprocal, the
// tanh-mapped mask scalars and their quotients), each rounded in the same
// sequence as per pixel, stored with the value in both lanes.  `rows` lets
// the grouped runner merge a few images of a batch in one launch without
// gathering or scattering whole images.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC (exposure_tpu_torch/kernels/__init__.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_branches.cuh"

namespace {

// ---------------------------------------------------------------------------
// the bf16 arithmetic of a chain (fastmath.cuh's bf16 section)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bf2 lum_bf2(bf2 r, bf2 g, bf2 b) {
  return add2(add2(mul2(C2(0.27f), r), mul2(C2(0.67f), g)),
              mul2(C2(0.06f), b));
}

__device__ __forceinline__ bf2 sigmoid_bf2(bf2 x) {
  return lanes(x, [](float v) { return sigmoidf(v); });
}

// A curve's plan from its knots `knot(i)`, in ChainF32's layout: the exact
// set's [t_0 .. t_{S-1}, norm] or the fast set's [t_0, d_1 .. d_{S-1},
// t_{S-1}, C0, norm].  norm = steps / (1e-30 + sum t): torch evaluates
// `steps / psum` as psum.reciprocal() * steps.
template <bool FAST, typename Knot>
__device__ __forceinline__ void plan_curve_bf(const Knot& knot, int steps,
                                              bf2* q) {
  bf psum = add(C(1e-30f), knot(0));
  for (int i = 1; i < steps; ++i) psum = add(psum, knot(i));
  const bf norm = mul(rcp(psum), C((float)steps));
  if (FAST) {
    curve_relu_plan_bf<0>(knot, steps, q);
    q[steps + 2] = both(norm);
  } else {
    for (int i = 0; i < steps; ++i) q[i] = both(knot(i));
    q[steps] = both(norm);
  }
}

// Step plan `q` of branch `code` from its raw f32 parameters `p` and raw
// mask parameters `mp` (read only when masking), each rounded to bf16 first.
template <bool FAST, bool MASKED>
__device__ __forceinline__ void plan_step_bf(int code, const float* p,
                                             const float* mp,
                                             const ChainArgs& a, bf2* q) {
  const int steps = a.curve_steps;
  const bf fir = C(5.0f);  // filter_input_range
  const bf sharp = C(a.max_sharpness);
  auto tanh_fir = [&](int j) { return mul(R(tanhf(F(R(mp[j])))), fir); };
  auto amp_of = [&](bf m) {
    return add(mul(dvd(m, fir), C(0.5f)), C(0.5f));
  };
  switch (code) {
    case kExposure:
      q[0] = both(R(expf(F(mul(R(p[0]), C(0.6931471805599453f))))));
      break;
    case kGamma:
    case kContrast:
    case kBlackWhite:
      q[0] = both(R(p[0]));
      break;
    case kSaturationPlus:
      q[0] = both(R(p[0]));
      q[1] = both(sub(C(1.0f), R(p[0])));
      break;
    case kWhiteBalance:
      q[0] = both(R(p[0])); q[1] = both(R(p[1])); q[2] = both(R(p[2]));
      break;
    case kTone:
      plan_curve_bf<FAST>([&](int i) { return R(p[i]); }, steps, q);
      break;
    case kColor:
      for (int c = 0; c < 3; ++c) {
        plan_curve_bf<FAST>([&](int i) { return R(p[c * steps + i]); }, steps,
                            q + c * curve_plan_floats(steps));
      }
      break;
    case kLevel: {
      const bf lo = R(p[0]);
      const bf hi = add(R(p[1]), C(1.0f));
      q[0] = both(lo);
      q[1] = both(rcp(add(sub(hi, lo), C(1e-6f))));
      break;
    }
    case kVignet:
      if (MASKED) {
        q[0] = both(tanh_fir(0));
        q[1] = both(tanh_fir(1));
        q[2] = both(tanh_fir(2));
        q[3] = both(dvd(mul(sharp, tanh_fir(3)), fir));
        q[4] = both(amp_of(tanh_fir(4)));
      }
      break;
    default:  // identity
      break;
  }
  if (MASKED && code >= 0 && code < kVignet) {
    bf2* qm = q + mask_plan_offset(steps);
    qm[0] = both(tanh_fir(0));
    qm[1] = both(tanh_fir(1));
    qm[2] = both(tanh_fir(2));
    qm[3] = both(mul(tanh_fir(3), C(2.0f)));
    qm[4] = both(dvd(mul(sharp, tanh_fir(4)), fir));
    qm[5] = both(amp_of(tanh_fir(5)));
  }
}

// A curve on M pairs from its plan; `y` may be `x`.
template <bool FAST, int S, int M>
__device__ __forceinline__ void curve_bf2(const bf2 (&x)[M], bf2 (&y)[M],
                                          const bf2* q, int steps) {
  if (FAST) {
    curve_relu_bf2<S, M>(x, y, q, steps, q[steps + 2]);
    return;
  }
  const bf2 width = C2(1.0f / (float)steps), zero = C2(0.0f);
  bf2 total[M];
#pragma unroll
  for (int m = 0; m < M; ++m) total[m] = mul2(x[m], zero);
#pragma unroll
  for (int i = 0; i < (S ? S : steps); ++i) {
    const bf2 at = C2((float)i / (float)steps), t = q[i];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      total[m] = add2(total[m],
                      mul2(bclamp2(sub2(x[m], at), zero, width), t));
    }
  }
  const bf2 norm = q[steps];
#pragma unroll
  for (int m = 0; m < M; ++m) y[m] = mul2(total[m], norm);
}

// `keep` is 1 - t, from the plan
template <bool FAST>
__device__ __forceinline__ void saturation_plus_bf2(bf2& r, bf2& g, bf2& b,
                                                    bf2 t, bf2 keep) {
  const bf2 one = C2(1.0f), half = C2(0.5f), zero = C2(0.0f);
  const bf2 r1 = bmin2(r, one), g1 = bmin2(g, one), b1 = bmin2(b, one);
  const bf2 v = bmax2(bmax2(r1, g1), b1);
  const bf2 mn = bmin2(bmin2(r1, g1), b1);
  const bf2 rng = sub2(v, mn);
  const bf2 k = mul2(sub2(half, abs2(sub2(half, v))), C2(0.8f));
  const bf2 one_m_k = sub2(one, k);
  const unsigned vpos = gt2(v, zero);
  const bf2 safe_v = sel2(vpos, v, one);
  const bf2 rng_pos = sel2(vpos, rng, zero);
  const unsigned gray = FAST ? le2(rng, mul2(C2(2e-4f), safe_v))
                             : le2(rng, zero);
  const bf2 ratio = dvd2(add2(mul2(one_m_k, rng_pos), mul2(k, safe_v)),
                         sel2(gray, one, rng));
  const bf2 vg = mul2(one_m_k, sub2(v, rng_pos));
  const bf2 fr = sel2(gray, v, sub2(v, mul2(sub2(v, r1), ratio)));
  const bf2 fg = sel2(gray, vg, sub2(v, mul2(sub2(v, g1), ratio)));
  const bf2 fb = sel2(gray, vg, sub2(v, mul2(sub2(v, b1), ratio)));
  r = add2(mul2(r1, keep), mul2(fr, t));
  g = add2(mul2(g1, keep), mul2(fg, t));
  b = add2(mul2(b1, keep), mul2(fb, t));
}

// Step plan `q` with branch `code` on M pairs of pixels (pr, pg, pb); with
// masking each branch is blended in by its mask at the pixels' grid
// positions (gx, gy), computed first from the step's input, and the
// vignette has its own elliptical mask.
template <bool FAST, bool MASKED, int S, int M>
__device__ __forceinline__ void run_step_bf(int code, const bf2* q,
                                            bf2 (&pr)[M], bf2 (&pg)[M],
                                            bf2 (&pb)[M],
                                            const bf2 (&gx)[M],
                                            const bf2 (&gy)[M],
                                            const ChainArgs& a) {
  const int steps = S ? S : a.curve_steps;
  const bf2 one = C2(1.0f), half = C2(0.5f), zero = C2(0.0f);
  if (MASKED) {
    if (code == kVignet) {
      const bf2 fir = C2(5.0f);
      const bf2 m0 = q[0], m1 = q[1], m2 = q[2], sharp = q[3], amp = q[4];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const bf2 ex = mul2(gx[m], m0), ey = mul2(gy[m], m1);
        bf2 inp = sub2(add2(add2(mul2(ex, ex), mul2(ey, ey)), m2), fir);
        inp = mul2(inp, sharp);
        const bf2 inv = sub2(one, mul2(sigmoid_bf2(inp), amp));
        pr[m] = mul2(pr[m], inv);
        pg[m] = mul2(pg[m], inv);
        pb[m] = mul2(pb[m], inv);
      }
      return;
    }
    if (code < 0 || code >= kVignet) return;  // identity
  }
  bf2 mask[M];
  if constexpr (MASKED) {
    const bf2* qm = q + mask_plan_offset(steps);
    const bf2 m0 = qm[0], m1 = qm[1], m2 = qm[2], m3x2 = qm[3];
    const bf2 sharp = qm[4], amp = qm[5];
    const bf2 strength = C2(a.one_minus_min_strength);
    const bf2 min_strength = C2(a.min_strength);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const bf2 lum = lum_bf2(pr[m], pg[m], pb[m]);
      bf2 inp = add2(add2(add2(mul2(gx[m], m0), mul2(gy[m], m1)),
                          mul2(m2, sub2(lum, half))),
                     m3x2);
      inp = mul2(inp, sharp);
      mask[m] = add2(mul2(mul2(sigmoid_bf2(inp), amp), strength),
                     min_strength);
    }
  }
  auto blend = [&](bf2& x, bf2 x2, int m) {
    x = add2(x, mul2(sub2(x2, x), mask[m]));
  };
  // f(r, g, b) on every pair, blended by its mask when masking
  auto each = [&](auto f) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if constexpr (MASKED) {
        bf2 r2 = pr[m], g2 = pg[m], b2 = pb[m];
        f(r2, g2, b2);
        blend(pr[m], r2, m);
        blend(pg[m], g2, m);
        blend(pb[m], b2, m);
      } else {
        f(pr[m], pg[m], pb[m]);
      }
    }
  };
  // a curve on channel x of every pair, blended when masking
  auto each_channel = [&](bf2 (&x)[M], const bf2* plan) {
    if constexpr (MASKED) {
      bf2 y[M];
      curve_bf2<FAST, S, M>(x, y, plan, steps);
#pragma unroll
      for (int m = 0; m < M; ++m) blend(x[m], y[m], m);
    } else {
      curve_bf2<FAST, S, M>(x, x, plan, steps);
    }
  };
  switch (code) {
    case kExposure: {
      const bf2 mlt = q[0];
      each([&](bf2& r, bf2& g, bf2& b) {
        r = mul2(r, mlt); g = mul2(g, mlt); b = mul2(b, mlt);
      });
      break;
    }
    case kGamma: {
      const bf2 gm = q[0], lowest = C2(0.001f);
      const float gmf = lo(gm);
      auto gamma = [&](bf2 x) {
        const bf2 t = bmax2(x, lowest);
        if (FAST) {
          const bf2 lg = lanes(t, [](float v) { return log2f(v); });
          return lanes(mul2(gm, lg), [](float v) { return exp2f(v); });
        }
        return lanes(t, [&](float v) { return powf(v, gmf); });
      };
      each([&](bf2& r, bf2& g, bf2& b) {
        r = gamma(r); g = gamma(g); b = gamma(b);
      });
      break;
    }
    case kWhiteBalance: {
      const bf2 w0 = q[0], w1 = q[1], w2 = q[2];
      each([&](bf2& r, bf2& g, bf2& b) {
        r = mul2(r, w0); g = mul2(g, w1); b = mul2(b, w2);
      });
      break;
    }
    case kSaturationPlus: {
      const bf2 t = q[0], keep = q[1];
      each([&](bf2& r, bf2& g, bf2& b) {
        saturation_plus_bf2<FAST>(r, g, b, t, keep);
      });
      break;
    }
    case kTone:
      each_channel(pr, q);
      each_channel(pg, q);
      each_channel(pb, q);
      break;
    case kContrast: {
      const bf2 t = q[0];
      each([&](bf2& r, bf2& g, bf2& b) {
        const bf2 lum = bclamp2(lum_bf2(r, g, b), zero, one);
        // the exact set's cos on the rounded product pi x, as the plain
        // version; its argument stays in [0, pi]
        const bf2 clum = FAST
            ? fast_half_cos_pi_bf2(lum)
            : add2(mul2(neg2(lanes(mul2(C2(3.14159265358979323846f), lum),
                                   [](float v) { return cosf(v); })),
                        half),
                   half);
        const bf2 scale = dvd2(clum, add2(lum, C2(1e-6f)));
        r = add2(r, mul2(sub2(mul2(r, scale), r), t));
        g = add2(g, mul2(sub2(mul2(g, scale), g), t));
        b = add2(b, mul2(sub2(mul2(b, scale), b), t));
      });
      break;
    }
    case kBlackWhite: {
      const bf2 t = q[0];
      each([&](bf2& r, bf2& g, bf2& b) {
        const bf2 lum = lum_bf2(r, g, b);
        r = add2(r, mul2(sub2(lum, r), t));
        g = add2(g, mul2(sub2(lum, g), t));
        b = add2(b, mul2(sub2(lum, b), t));
      });
      break;
    }
    case kColor: {
      const int cp = curve_plan_floats(steps);
      each_channel(pr, q);
      each_channel(pg, q + cp);
      each_channel(pb, q + 2 * cp);
      break;
    }
    case kLevel: {
      const bf2 low = q[0], inv = q[1];
      each([&](bf2& r, bf2& g, bf2& b) {
        r = bclamp2(mul2(sub2(r, low), inv), zero, one);
        g = bclamp2(mul2(sub2(g, low), inv), zero, one);
        b = bclamp2(mul2(sub2(b, low), inv), zero, one);
      });
      break;
    }
    default:  // identity (and the vignette without masking)
      break;
  }
}

// The bf16 arithmetic as `chain_image` takes it (see ChainF32): the plan's
// entries are bf162 with the scalar in both lanes, and a thread holds its
// N pixels two a register, pixels 2m and 2m + 1 in pair m.
template <bool FAST, bool MASKED, int S_>
struct ChainBf16 {
  typedef bf2 Q;
  static constexpr int S = S_;
  static constexpr bool kMasked = MASKED;
  static constexpr int N = MASKED ? kRun / 2 : kRun;

  __device__ __forceinline__ static void plan(int code, const float* p,
                                              const float* mp,
                                              const ChainArgs& a, bf2* q) {
    plan_step_bf<FAST, MASKED>(code, p, mp, a, q);
  }

  template <typename T>
  __device__ __forceinline__ static void pixels(Run<T>& run, int h,
                                                const int* s_code,
                                                const bf2* s_plan, int stride,
                                                int& row, int& col,
                                                const ChainArgs& a) {
    constexpr int M = N / 2;
    bf2 r[M], g[M], b[M], gx[M], gy[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = (h * N + 2 * m) * 3;
      r[m] = pack2(run.get(j), run.get(j + 3));
      g[m] = pack2(run.get(j + 1), run.get(j + 4));
      b[m] = pack2(run.get(j + 2), run.get(j + 5));
      if (MASKED) {  // the normalized centered grid, in f32, then rounded
        float fx[2], fy[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          fx[e] = ((float)row + a.grid_off_h) / a.shorter - 0.5f;
          fy[e] = ((float)col + a.grid_off_w) / a.shorter - 0.5f;
          if (++col == a.W) {
            col = 0;
            ++row;
          }
        }
        gx[m] = pack2(fx[0], fx[1]);
        gy[m] = pack2(fy[0], fy[1]);
      }
    }
    for (int k = 0; k < a.K; ++k) {
      run_step_bf<FAST, MASKED, S, M>(s_code[k], s_plan + k * stride, r, g,
                                      b, gx, gy, a);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = (h * N + 2 * m) * 3;
      run.set(j, lo(r[m]));
      run.set(j + 1, lo(g[m]));
      run.set(j + 2, lo(b[m]));
      run.set(j + 3, hi(r[m]));
      run.set(j + 4, hi(g[m]));
      run.set(j + 5, hi(b[m]));
    }
  }
};

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// Slot blockIdx.y + i0's image through the chain in the arithmetic `Math`.
template <typename T, typename Math>
__device__ __forceinline__ void switch_image(
    const T* __restrict__ img, T* __restrict__ out,
    const int32_t* __restrict__ ids, const float* __restrict__ params,
    const float* __restrict__ mask, const int32_t* __restrict__ rows, int i0,
    int n_active, int B, int M, const BranchTable& table,
    const ChainArgs& a) {
  const int i = blockIdx.y + i0;
  if (i >= n_active) return;
  const int row = rows ? rows[i] : i;
  const int pp = a.mask_offset;
  chain_image<T, Math>(
      img + image_offset(row, a), out + image_offset(row, a), a,
      [&](int k, int* s_code, typename Math::Q* plan) {
        const int id = ids[(size_t)k * B + row];
        const int code = (id >= 0 && id < a.n_filters) ? (int)table.code[id]
                                                       : (int)kIdentity;
        s_code[k] = code;
        Math::plan(code, params + ((size_t)k * B + row) * pp,
                   Math::kMasked ? mask + ((size_t)k * B + row) * M : nullptr,
                   a, plan);
      });
}

template <typename T, bool FAST, bool MASKED, int S>
__global__ void switch_chain_f32(const T* __restrict__ img, T* __restrict__ out,
                 const int32_t* __restrict__ ids,
                 const float* __restrict__ params,
                 const float* __restrict__ mask,
                 const int32_t* __restrict__ rows, int i0, int n_active,
                 int B, int M, const __grid_constant__ BranchTable table,
                 const __grid_constant__ ChainArgs a) {
  switch_image<T, ChainF32<FAST, MASKED, S>>(img, out, ids, params, mask,
                                             rows, i0, n_active, B, M, table,
                                             a);
}

template <typename T, bool FAST, bool MASKED, int S>
__global__ void switch_chain_bf16(const T* __restrict__ img, T* __restrict__ out,
                  const int32_t* __restrict__ ids,
                  const float* __restrict__ params,
                  const float* __restrict__ mask,
                  const int32_t* __restrict__ rows, int i0, int n_active,
                  int B, int M, const __grid_constant__ BranchTable table,
                  const __grid_constant__ ChainArgs a) {
  switch_image<T, ChainBf16<FAST, MASKED, S>>(img, out, ids, params, mask,
                                              rows, i0, n_active, B, M, table,
                                              a);
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
  const size_t smem = plan_smem_bytes(a.K, a.curve_steps);
  return with_curve_steps(a.curve_steps, [&](auto steps) {
    constexpr int S = decltype(steps)::value;
    return launch_chunks(l, chain_blocks(a.H, a.W), [&](dim3 grid, int i0) {
      if constexpr (BF16) {
        switch_chain_bf16<T, FAST, MASKED, S><<<grid, kThreads, smem, stream>>>(
            img, out, ids, params, mask, rows, i0, l.n_active, l.B, l.M,
            table, a);
      } else {
        switch_chain_f32<T, FAST, MASKED, S><<<grid, kThreads, smem, stream>>>(
            img, out, ids, params, mask, rows, i0, l.n_active, l.B, l.M,
            table, a);
      }
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
