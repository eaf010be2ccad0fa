// Native ENVI cube reader: memory-mapped band-window gather to float32 or
// bfloat16 NHWC (the port's own copy of the JAX package's reader).
//
// Role: the hot host-side path of the data pipeline. The reference reads
// whole ~267 MB cubes through Python (spectral's envi.open().load()) and then
// slices and moves axes in numpy; this reader mmaps the raw .dat once and
// materializes ONLY the requested band window, converting dtype and
// interleave (bil/bip/bsq) to the (lines, samples, bands') channel-last
// layout the models consume, parallelized across rows with std::thread.
//
// C ABI only, consumed from Python through ctypes
// (hyperpri_tpu_torch/data/native_io.py, which builds this file with g++ at
// first use into build/native/libhyperpri_io.so).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

enum Interleave { BIL = 0, BIP = 1, BSQ = 2 };

// ENVI data-type codes (those of hyperpri_tpu_torch/data/envi.py).
enum DType {
  U8 = 1,
  I16 = 2,
  I32 = 3,
  F32 = 4,
  F64 = 5,
  U16 = 12,
  U32 = 13,
  I64 = 14,
  U64 = 15,
};

template <typename T>
inline float to_float(const uint8_t* p, bool swap) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  if (swap && sizeof(T) > 1) {
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
    for (size_t i = 0; i < sizeof(T) / 2; ++i) std::swap(b[i], b[sizeof(T) - 1 - i]);
  }
  return static_cast<float>(v);
}

inline float load_as_float(const uint8_t* p, int dtype, bool swap) {
  switch (dtype) {
    case U8:  return to_float<uint8_t>(p, swap);
    case I16: return to_float<int16_t>(p, swap);
    case I32: return to_float<int32_t>(p, swap);
    case F32: return to_float<float>(p, swap);
    case F64: return to_float<double>(p, swap);
    case U16: return to_float<uint16_t>(p, swap);
    case U32: return to_float<uint32_t>(p, swap);
    case I64: return to_float<int64_t>(p, swap);
    case U64: return to_float<uint64_t>(p, swap);
    default:  return 0.0f;
  }
}

inline size_t dtype_size(int dtype) {
  switch (dtype) {
    case U8: return 1;
    case I16: case U16: return 2;
    case I32: case U32: case F32: return 4;
    case F64: case I64: case U64: return 8;
    default: return 0;
  }
}

struct Geometry {
  int lines, samples, bands, band_lo, band_hi, interleave, dtype;
  bool swap;
  size_t esize;

  // byte offset of element (line, band, sample) in the raw file
  inline size_t offset(int line, int band, int sample) const {
    size_t L = line, B = band, S = sample;
    size_t ls = lines, ss = samples, bs = bands;
    switch (interleave) {
      case BIL: return ((L * bs + B) * ss + S) * esize;
      case BIP: return ((L * ss + S) * bs + B) * esize;
      default:  return ((B * ls + L) * ss + S) * esize;  // BSQ
    }
  }
};

// float -> bfloat16 with round-to-nearest-even (numpy/ml_dtypes semantics).
inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  if ((x & 0x7fffffffu) > 0x7f800000u) return static_cast<uint16_t>((x >> 16) | 0x40);
  uint32_t lsb = (x >> 16) & 1u;
  x += 0x7fffu + lsb;
  return static_cast<uint16_t>(x >> 16);
}

struct StoreF32 {
  using Out = float;
  static inline Out cvt(float f) { return f; }
};
struct StoreBF16 {
  using Out = uint16_t;
  static inline Out cvt(float f) { return f32_to_bf16(f); }
};

template <typename Store>
void gather_rows(const uint8_t* base, const Geometry& g,
                 typename Store::Out* out, int line_begin, int line_end) {
  const int nb = g.band_hi - g.band_lo;
  for (int line = line_begin; line < line_end; ++line) {
    typename Store::Out* row_out = out + static_cast<size_t>(line) * g.samples * nb;
    if (g.interleave == BIP && g.dtype == F32 && !g.swap) {
      // fast path: contiguous per-pixel spectra (memcpy for f32 out,
      // tight convert loop for bf16 — both vectorize)
      const uint8_t* src = base + g.offset(line, g.band_lo, 0);
      for (int s = 0; s < g.samples; ++s) {
        const float* sp =
            reinterpret_cast<const float*>(src + (static_cast<size_t>(s) * g.bands) * g.esize);
        typename Store::Out* dp = row_out + static_cast<size_t>(s) * nb;
        for (int b = 0; b < nb; ++b) dp[b] = Store::cvt(sp[b]);
      }
      continue;
    }
    if (g.interleave == BIL && g.dtype == F32 && !g.swap) {
      // fast path: one contiguous span per (line, band); transpose to NHWC
      for (int b = g.band_lo; b < g.band_hi; ++b) {
        const float* src = reinterpret_cast<const float*>(base + g.offset(line, b, 0));
        typename Store::Out* dst = row_out + (b - g.band_lo);
        for (int s = 0; s < g.samples; ++s)
          dst[static_cast<size_t>(s) * nb] = Store::cvt(src[s]);
      }
      continue;
    }
    for (int s = 0; s < g.samples; ++s) {
      for (int b = g.band_lo; b < g.band_hi; ++b) {
        row_out[static_cast<size_t>(s) * nb + (b - g.band_lo)] =
            Store::cvt(load_as_float(base + g.offset(line, b, s), g.dtype, g.swap));
      }
    }
  }
}

}  // namespace

template <typename Store>
int read_slice_impl(const char* dat_path, long header_offset, int lines, int samples,
                    int bands, int dtype_code, int byte_order, int interleave,
                    int band_lo, int band_hi, typename Store::Out* out, int n_threads);

extern "C" {

// Returns 0 on success, negative errno-style codes on failure.
int envi_read_slice(const char* dat_path, long header_offset, int lines, int samples,
                    int bands, int dtype_code, int byte_order, int interleave,
                    int band_lo, int band_hi, float* out, int n_threads) {
  return read_slice_impl<StoreF32>(dat_path, header_offset, lines, samples, bands,
                                   dtype_code, byte_order, interleave, band_lo,
                                   band_hi, out, n_threads);
}

// Same gather, output stored as bfloat16 (uint16 bit pattern, RNE): halves
// the materialized bytes for the bf16 ingest path and skips the
// Python-side f32->bf16 cast on the cold decode.
int envi_read_slice_bf16(const char* dat_path, long header_offset, int lines,
                         int samples, int bands, int dtype_code, int byte_order,
                         int interleave, int band_lo, int band_hi, uint16_t* out,
                         int n_threads) {
  return read_slice_impl<StoreBF16>(dat_path, header_offset, lines, samples, bands,
                                    dtype_code, byte_order, interleave, band_lo,
                                    band_hi, out, n_threads);
}

}  // extern "C"

template <typename Store>
int read_slice_impl(const char* dat_path, long header_offset, int lines, int samples,
                    int bands, int dtype_code, int byte_order, int interleave,
                    int band_lo, int band_hi, typename Store::Out* out, int n_threads) {
  if (band_lo < 0 || band_hi > bands || band_lo >= band_hi) return -22;  // EINVAL
  size_t esize = dtype_size(dtype_code);
  if (esize == 0) return -22;

  int fd = open(dat_path, O_RDONLY);
  if (fd < 0) return -2;  // ENOENT
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -5;
  }
  size_t need = static_cast<size_t>(lines) * samples * bands * esize + header_offset;
  if (static_cast<size_t>(st.st_size) < need) {
    close(fd);
    return -27;  // EFBIG-ish: file too small
  }

  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return -12;
  madvise(map, st.st_size, MADV_SEQUENTIAL);
  const uint8_t* base = static_cast<const uint8_t*>(map) + header_offset;

  // host byte order assumed little-endian (true on all target hosts)
  Geometry g{lines,    samples, bands, band_lo, band_hi,
             interleave, dtype_code, byte_order == 1, esize};

  if (n_threads <= 1 || lines < 2 * n_threads) {
    gather_rows<Store>(base, g, out, 0, lines);
  } else {
    std::vector<std::thread> pool;
    int chunk = (lines + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int lo = t * chunk, hi = std::min(lines, lo + chunk);
      if (lo >= hi) break;
      pool.emplace_back(gather_rows<Store>, base, std::cref(g), out, lo, hi);
    }
    for (auto& th : pool) th.join();
  }

  munmap(map, st.st_size);
  return 0;
}
