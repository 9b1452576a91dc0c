// hostloader: native host-side dataset pack loader + batch sampler.
//
// Purpose: when an image pack is too large to keep resident in device
// memory (the on-device pipeline in data/device_sampler.py) or even in host
// RAM, this library memory-maps the .npy pack and materializes augmented
// batches (random crop + horizontal flip) with OpenMP-parallel copies,
// built for multi-GB packs and zero-copy OS page caching.  A copy of the
// JAX package's exposure_tpu/native/hostloader.cpp: the C ABI and the
// draws are the same, so both give the same crops for the same seed.
//
// C ABI (consumed via ctypes from exposure_tpu_torch/native/__init__.py):
//   void*  hl_open_pack(const char* path)           -> handle or NULL
//   int    hl_pack_info(void* h, long* n, long* hgt, long* wid, long* c)
//   int    hl_sample_crops(void* h, long batch, long out_size,
//                          int augment, unsigned long long seed,
//                          float* out)               -> 0 on success
//   void   hl_close_pack(void* h)
//
// The sampler draws i.i.d. indices/offsets/flips from a splitmix64 PRNG
// seeded per call, matching the distribution of the device sampler.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <type_traits>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Pack {
  int fd = -1;
  void* map = nullptr;
  size_t map_size = 0;
  const float* data = nullptr;  // [n, h, w, c] float32, C-order
  long n = 0, h = 0, w = 0, c = 0;
};

// splitmix64: tiny, statistically solid for sampling decisions.
static inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

static inline long rand_below(uint64_t& state, long bound) {
  if (bound <= 1) return 0;
  return static_cast<long>(splitmix64(state) % static_cast<uint64_t>(bound));
}

// Parse a v1/v2 .npy header for a little-endian float32 C-order array
// with 4 dims. Returns byte offset of the data or 0 on failure.
static size_t parse_npy_header(const unsigned char* buf, size_t size,
                               long dims[4]) {
  if (size < 16 || memcmp(buf, "\x93NUMPY", 6) != 0) return 0;
  int major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_off = 10;
  } else {
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
                 (static_cast<size_t>(buf[11]) << 24);
    header_off = 12;
  }
  if (header_off + header_len > size) return 0;
  std::string header(reinterpret_cast<const char*>(buf + header_off),
                     header_len);
  if (header.find("'descr': '<f4'") == std::string::npos &&
      header.find("\"descr\": \"<f4\"") == std::string::npos)
    return 0;
  if (header.find("'fortran_order': False") == std::string::npos &&
      header.find("\"fortran_order\": false") == std::string::npos)
    return 0;
  size_t sp = header.find("shape");
  if (sp == std::string::npos) return 0;
  sp = header.find('(', sp);
  size_t ep = header.find(')', sp);
  if (sp == std::string::npos || ep == std::string::npos) return 0;
  std::string shape = header.substr(sp + 1, ep - sp - 1);
  int nd = 0;
  const char* p = shape.c_str();
  while (*p && nd < 4) {
    while (*p == ' ' || *p == ',') ++p;
    if (!*p) break;
    dims[nd++] = strtol(p, const_cast<char**>(&p), 10);
  }
  if (nd != 4) return 0;
  return header_off + header_len;
}

}  // namespace

extern "C" {

void* hl_open_pack(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 64) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  long dims[4] = {0, 0, 0, 0};
  size_t offset = parse_npy_header(
      static_cast<const unsigned char*>(map), st.st_size, dims);
  size_t expected = static_cast<size_t>(dims[0]) * dims[1] * dims[2] *
                    dims[3] * sizeof(float);
  if (offset == 0 || offset + expected > static_cast<size_t>(st.st_size)) {
    munmap(map, st.st_size);
    close(fd);
    return nullptr;
  }
  Pack* pack = new Pack();
  pack->fd = fd;
  pack->map = map;
  pack->map_size = st.st_size;
  pack->data = reinterpret_cast<const float*>(
      static_cast<const char*>(map) + offset);
  pack->n = dims[0];
  pack->h = dims[1];
  pack->w = dims[2];
  pack->c = dims[3];
  // advise the kernel we will fault pages randomly
  madvise(map, st.st_size, MADV_RANDOM);
  return pack;
}

int hl_pack_info(void* handle, long* n, long* h, long* w, long* c) {
  if (!handle) return -1;
  Pack* p = static_cast<Pack*>(handle);
  *n = p->n;
  *h = p->h;
  *w = p->w;
  *c = p->c;
  return 0;
}

}  // extern "C"

namespace {

// Bilinear resize of one [H, W, C] image to [out, out, C], matching
// cv2.resize INTER_LINEAR center-aligned sampling on float images
// (src = (dst + 0.5) * scale - 0.5) — the Python provider's
// non-augmented path (data/provider.py:89-101).
static void bilinear_resize(const float* src, long H, long W, long C,
                            long out_size, float* dst) {
  const double sx_scale = static_cast<double>(H) / out_size;
  const double sy_scale = static_cast<double>(W) / out_size;
  for (long r = 0; r < out_size; ++r) {
    double fx = (r + 0.5) * sx_scale - 0.5;
    if (fx < 0) fx = 0;
    long x0 = static_cast<long>(fx);
    if (x0 > H - 1) x0 = H - 1;
    long x1 = x0 + 1 < H ? x0 + 1 : H - 1;
    const float wx = static_cast<float>(fx - x0);
    float* drow = dst + r * out_size * C;
    for (long col = 0; col < out_size; ++col) {
      double fy = (col + 0.5) * sy_scale - 0.5;
      if (fy < 0) fy = 0;
      long y0 = static_cast<long>(fy);
      if (y0 > W - 1) y0 = W - 1;
      long y1 = y0 + 1 < W ? y0 + 1 : W - 1;
      const float wy = static_cast<float>(fy - y0);
      const float* p00 = src + (x0 * W + y0) * C;
      const float* p01 = src + (x0 * W + y1) * C;
      const float* p10 = src + (x1 * W + y0) * C;
      const float* p11 = src + (x1 * W + y1) * C;
      for (long ch = 0; ch < C; ++ch) {
        const float top = p00[ch] + (p01[ch] - p00[ch]) * wy;
        const float bot = p10[ch] + (p11[ch] - p10[ch]) * wy;
        drow[col * C + ch] = top + (bot - top) * wx;
      }
    }
  }
}

}  // namespace

namespace {

inline unsigned char quantize_u8(float x) {
  x = x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
  return static_cast<unsigned char>(x * 255.f + 0.5f);
}

// Shared sampling core: identical RNG stream / crop selection for both
// output dtypes, so a u8 bundle holds EXACTLY the quantized f32 bundle
// the same seed would produce (tests/test_torch_native_loader.py).
template <typename Dst>
int sample_crops_impl(void* handle, long batch, long out_size, int augment,
                      unsigned long long seed, Dst* out) {
  if (!handle) return -1;
  Pack* p = static_cast<Pack*>(handle);
  const long H = p->h, W = p->w, C = p->c;
  if (augment && (out_size > H || out_size > W)) return -2;
  const long crop_max_x = augment ? (H - out_size + 1) : 1;
  const long crop_max_y = augment ? (W - out_size + 1) : 1;
  const bool resize = !augment && (out_size != H || out_size != W);
  constexpr bool kF32 = std::is_same<Dst, float>::value;

#pragma omp parallel for schedule(static)
  for (long i = 0; i < batch; ++i) {
    uint64_t state = seed ^ (0x5851f42d4c957f2dULL * (i + 1));
    long idx = rand_below(state, p->n);
    const float* src = p->data + static_cast<size_t>(idx) * H * W * C;
    Dst* dst = out + static_cast<size_t>(i) * out_size * out_size * C;
    if (resize) {
      // non-augmented path: bilinear resize of the whole image, matching
      // the Python provider (data/provider.py:89-101)
      if (kF32) {
        bilinear_resize(src, H, W, C, out_size,
                        reinterpret_cast<float*>(dst));
      } else {
        std::vector<float> tmp(out_size * out_size * C);
        bilinear_resize(src, H, W, C, out_size, tmp.data());
        for (long k = 0; k < out_size * out_size * C; ++k)
          dst[k] = static_cast<Dst>(quantize_u8(tmp[k]));
      }
      continue;
    }
    long sx = 0, sy = 0;
    if (augment) {
      sx = rand_below(state, crop_max_x);
      sy = rand_below(state, crop_max_y);
    }
    bool flip = augment && (splitmix64(state) & 1);
    for (long r = 0; r < out_size; ++r) {
      const float* row = src + ((sx + r) * W + sy) * C;
      Dst* drow = dst + r * out_size * C;
      if (kF32 && !flip) {
        memcpy(drow, row, out_size * C * sizeof(float));
      } else {
        for (long col = 0; col < out_size; ++col) {
          const float* pix = row + (flip ? (out_size - 1 - col) : col) * C;
          if (kF32) {
            memcpy(drow + col * C, pix, C * sizeof(float));
          } else {
            for (long ch = 0; ch < C; ++ch)
              drow[col * C + ch] =
                  static_cast<Dst>(quantize_u8(pix[ch]));
          }
        }
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

int hl_sample_crops(void* handle, long batch, long out_size, int augment,
                    unsigned long long seed, float* out) {
  return sample_crops_impl<float>(handle, batch, out_size, augment, seed,
                                  out);
}

// u8 variant: same crops/flips as hl_sample_crops for the same seed,
// pixels quantized round(clamp(x,0,1)*255) — 4x fewer bytes for the
// host->device bundle upload, dequantized on the device by the streaming
// step (core/steps.py::dequant_stream).  Real-photo packs that originated
// as 8-bit sources round-trip exactly.
int hl_sample_crops_u8(void* handle, long batch, long out_size,
                       int augment, unsigned long long seed,
                       unsigned char* out) {
  return sample_crops_impl<unsigned char>(handle, batch, out_size, augment,
                                          seed, out);
}

void hl_close_pack(void* handle) {
  if (!handle) return;
  Pack* p = static_cast<Pack*>(handle);
  if (p->map) munmap(p->map, p->map_size);
  if (p->fd >= 0) close(p->fd);
  delete p;
}

}  // extern "C"
