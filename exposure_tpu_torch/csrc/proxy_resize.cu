// The proxy resize (exposure_tpu_torch/ops/proxy_resize.py): a batch of
// photos [B, H, W, 3], uint8 or float32, NHWC, to its [B, S, S, 3] float32
// proxy, NHWC, by the antialiased linear resize of
// jax.image.resize(..., 'linear'): a triangle filter widened by the scale
// when shrinking, each output's weights normalised, rows first, then
// columns, float32 sums; uint8 is scaled by 1/255 as it is read.
//
// It replaces no TPU kernel: the JAX package resizes with jax.image.resize,
// which XLA compiles.  On the card it replaces the uint8 -> float32
// conversion, the scaling, the permutes' copies and torch's antialiased
// interpolate, which wrote the whole batch as float32 twice and then read
// it through a permuted, strided view.
//
// Bound: bytes.  The batch is read once and the proxy written once: at
// [32, 3024, 4032, 3] uint8 1.1705 GB plus 1.57 MB, 0.350 ms at 3.35 TB/s;
// at [512, 512, 512, 3] uint8 402.7 MB plus 25.2 MB, 0.128 ms.  The taps,
// two operations each, are under 5 GFLOP at the first shape (0.071 ms at
// 67 TFLOP/s).
//
// Design.  A block owns one image's band of output rows and a slice of its
// output columns.  Its threads stream the input rows under the band, each
// once and in order, each thread one 16-byte chunk of the row (neighbouring
// threads on neighbouring chunks; four rows load while the four before
// them are added; two neighbouring bands both read the rows under the
// output rows they meet at, so a band of b rows reads (b+1)/b of its
// share), and add each row into the one or two output rows whose support
// holds it: slot A, the output row being finished, and slot B, the next
// one, both in registers.  The host's schedule lists the band's rows with their two
// weights and flags the last row of slot A's output; there the block puts
// that output row into shared memory (two buffers, used in turns, so one
// barrier an output row), runs the column pass out of it and writes only
// the proxy, and slot B becomes slot A.  Upscaling, where a row lies under
// more than two output rows, runs the same schedule, which then lists a
// row again with weight 0 for the slot that already holds it.  Column
// slices overlap by a filter's support, a few percent of a row, which
// neighbouring blocks read at about the same time; the host picks the band
// height and the slices so that the blocks fill the card: at 12 MP two
// slices of 384 threads, bands of 16 output rows and 48 KB of buffers, at
// 512 px one slice of 96 threads and bands of 32 (proxy_resize_prepare
// opts every variant in to more than 48 KB, once a device).  On an H100 80GB HBM3 at 700 W:
// 0.58 ms at the first shape, 0.33 ms at the second.
//
// The kernel's name holds upsample_gen2d_aa_out_frame, the name of torch's
// antialiased interpolate kernel that it replaces: the serving benchmark's
// per-layer readings (benchmark/lib/serve_layers.py) assign device kernels
// to the resize by that name.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // ops/proxy_resize.py::MAX_THREADS
constexpr int kInFlight = 4;       // rows a batch; the next batch loads
                                   // while this one is added
constexpr unsigned kLastRow = 0x80000000u;
constexpr float kScaleU8 = (float)(1.0 / 255.0);

// 16 bytes of a row at chunk `chunk`; elements past the row's end (a row
// whose length is not a whole number of chunks) read as 0.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* row, long long chunk,
                                            long long n) {
    if constexpr (VEC) {
        return __ldg(reinterpret_cast<const uint4*>(row) + chunk);
    } else {
        constexpr int V = 16 / sizeof(T);
        union {
            uint4 u;
            T e[V];
        } r;
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const long long e = chunk * V + i;
            r.e[i] = e < n ? row[e] : T(0);
        }
        return r.u;
    }
}

// The chunk's values as float32, uint8 scaled by 1/255 (torch's
// x.float() * (1/255), rounded once).  A byte becomes 2^23 + byte as the
// bits of a float (one byte permute) less 2^23, exactly: cheaper than a
// conversion instruction, which issues at a fraction of the float rate.
template <typename T>
__device__ __forceinline__ void chunk_values(uint4 raw, float* v);

template <>
__device__ __forceinline__ void chunk_values<unsigned char>(uint4 raw,
                                                            float* v) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float big = __uint_as_float(
                __byte_perm(w[k], 0x4B000000u, 0x7540u + j));
            v[4 * k + j] = __fmul_rn(__fsub_rn(big, 8388608.0f), kScaleU8);
        }
    }
}

template <>
__device__ __forceinline__ void chunk_values<float>(uint4 raw, float* v) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
}

// The schedule's steps [s, s + kInFlight) below s1 and the rows they
// name, at the thread's chunk; past s1 (and a chunk past the slice) zeros.
template <typename T, bool VEC>
__device__ __forceinline__ void load_rows(const int4* __restrict__ steps,
                                          int s, int s1, const T* image,
                                          long long chunk, long long n,
                                          bool live, int4 (&st)[kInFlight],
                                          uint4 (&raw)[kInFlight]) {
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        st[u] = make_int4(0, 0, 0, 0);
        if (s + u < s1) {
            st[u] = __ldg(steps + s + u);
            const long long y = (unsigned)st[u].x & ~kLastRow;
            if (live)
                raw[u] = load_chunk<T, VEC>(image + y * n, chunk, n);
        }
    }
}

// steps: the bands' schedules, one after another: (row | kLastRow on the
// last row of slot A's output, weight A, weight B, unused); band_off:
// [n_bands + 1] offsets into it.  slices: (first output column, end, first
// chunk, end chunk).  col_first, col_count, col_w: each output column's
// first input column, its number of taps and their weights ([S, taps_x]).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
upsample_gen2d_aa_out_frame_nhwc(
        const T* __restrict__ img, float* __restrict__ out,
        const int4* __restrict__ steps, const int* __restrict__ band_off,
        const int4* __restrict__ slices, const int* __restrict__ col_first,
        const int* __restrict__ col_count, const float* __restrict__ col_w,
        int taps_x, int H, int W, int S, int band_rows, int n_bands,
        int n_slices, int buf_floats) {
    constexpr int V = 16 / sizeof(T);
    extern __shared__ __align__(16) float rows[];  // [2, buf_floats]

    const int slice = blockIdx.x % n_slices;
    const int band = (blockIdx.x / n_slices) % n_bands;
    const long long b = blockIdx.x / (n_slices * n_bands);
    const int4 sl = slices[slice];
    const long long chunk = sl.z + (long long)threadIdx.x;
    const bool live = chunk < sl.w;
    const long long n = (long long)W * 3;
    const T* image = img + b * H * n;
    const int nq3 = 3 * (sl.y - sl.x);
    const int first_elem = sl.z * V;

    float a[V], c[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        a[i] = 0.f;
        c[i] = 0.f;
    }
    int o = band * band_rows;
    int buf = 0;
    const int s0 = band_off[band], s1 = band_off[band + 1];
    // the next kInFlight rows load while the current ones are added
    int4 st[kInFlight], next_st[kInFlight];
    uint4 raw[kInFlight], next_raw[kInFlight];
    load_rows<T, VEC>(steps, s0, s1, image, chunk, n, live, st, raw);
    for (int s = s0; s < s1; s += kInFlight) {
        load_rows<T, VEC>(steps, s + kInFlight, s1, image, chunk, n, live,
                          next_st, next_raw);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
            if (s + u >= s1)
                break;
            if (live) {
                const float wa = __int_as_float(st[u].y);
                const float wb = __int_as_float(st[u].z);
                float v[V];
                chunk_values<T>(raw[u], v);
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    a[i] = fmaf(wa, v[i], a[i]);
                    c[i] = fmaf(wb, v[i], c[i]);
                }
            }
            if ((unsigned)st[u].x & kLastRow) {
                // slot A holds output row o over the slice's chunks
                float* row = rows + buf * buf_floats;
                if (live) {
                    float4* dst = reinterpret_cast<float4*>(
                        row + (chunk - sl.z) * V);
#pragma unroll
                    for (int i = 0; i < V / 4; ++i)
                        dst[i] = make_float4(a[4 * i], a[4 * i + 1],
                                             a[4 * i + 2], a[4 * i + 3]);
                }
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    a[i] = c[i];
                    c[i] = 0.f;
                }
                __syncthreads();
                // the column pass: output (o, q, ch) of the slice's columns
                float* dst = out + ((b * S + o) * S + sl.x) * 3;
                for (int idx = threadIdx.x; idx < nq3; idx += blockDim.x) {
                    const int q = sl.x + idx / 3;
                    const int ch = idx - 3 * (idx / 3);
                    const float* w = col_w + (long long)q * taps_x;
                    const float* src = row + col_first[q] * 3 + ch -
                                       first_elem;
                    const int count = col_count[q];
                    float acc = 0.f;
#pragma unroll 16
                    for (int t = 0; t < count; ++t)
                        acc = fmaf(__ldg(w + t), src[3 * t], acc);
                    dst[idx] = acc;
                }
                ++o;
                buf ^= 1;
            }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
            st[u] = next_st[u];
            raw[u] = next_raw[u];
        }
    }
}

template <typename T, bool VEC>
int launch(const void* img, void* out, const void* steps,
           const void* band_off, const void* slices, const void* col_first,
           const void* col_count, const void* col_w, int taps_x, int H,
           int W, int S, int band_rows, int n_bands, int n_slices,
           long long blocks, int threads, int buf_floats,
           cudaStream_t stream) {
    auto kernel = upsample_gen2d_aa_out_frame_nhwc<T, VEC>;
    const int smem = 2 * buf_floats * (int)sizeof(float);
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(
        (const T*)img, (float*)out, (const int4*)steps,
        (const int*)band_off, (const int4*)slices, (const int*)col_first,
        (const int*)col_count, (const float*)col_w, taps_x, H, W, S,
        band_rows, n_bands, n_slices, buf_floats);
    return (int)cudaGetLastError();
}

// Lets the variant take up to `smem` bytes of shared memory a block.
template <typename T, bool VEC>
int opt_in(int smem) {
    return (int)cudaFuncSetAttribute(
        upsample_gen2d_aa_out_frame_nhwc<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

// Lets every variant take as much shared memory a block as the current
// device allows (above the default 48 KB), so a launch needs no attribute
// set: call once a device, outside any graph capture, before the first
// launch.  Returns 0 on success, else the CUDA error.
int proxy_resize_prepare(void) {
    int device = 0, smem = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess)
        return (int)err;
    int r = opt_in<unsigned char, true>(smem);
    if (r == 0)
        r = opt_in<unsigned char, false>(smem);
    if (r == 0)
        r = opt_in<float, true>(smem);
    if (r == 0)
        r = opt_in<float, false>(smem);
    return r;
}

// One launch: B x n_bands x n_slices blocks of `threads` threads, with
// 2 x buf_floats floats of shared memory.  is_u8: uint8 input (else
// float32); vec: rows of whole 16-byte chunks on a 16-byte aligned base.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int proxy_resize_launch(const void* img, void* out, const void* steps,
                        const void* band_off, const void* slices,
                        const void* col_first, const void* col_count,
                        const void* col_w, int taps_x, int B, int H, int W,
                        int S, int band_rows, int n_bands, int n_slices,
                        int threads, int buf_floats, int is_u8, int vec,
                        void* stream) {
    const long long blocks = (long long)B * n_bands * n_slices;
    if (blocks == 0)
        return 0;
    if (blocks > 0x7fffffffLL || threads < 1 || threads > kMaxThreads)
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = (cudaStream_t)stream;
#define PROXY_RESIZE_LAUNCH(T, VEC)                                         \
    launch<T, VEC>(img, out, steps, band_off, slices, col_first, col_count, \
                   col_w, taps_x, H, W, S, band_rows, n_bands, n_slices,    \
                   blocks, threads, buf_floats, s)
    if (is_u8)
        return vec ? PROXY_RESIZE_LAUNCH(unsigned char, true)
                   : PROXY_RESIZE_LAUNCH(unsigned char, false);
    return vec ? PROXY_RESIZE_LAUNCH(float, true)
               : PROXY_RESIZE_LAUNCH(float, false);
#undef PROXY_RESIZE_LAUNCH
}

const char* proxy_resize_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
