// Backward of a 2x2, stride-2 max pool for NHWC bf16 or float32 activations.
//
// Replaces the TPU kernel hyperpri_tpu/ops/pallas/pool_bwd.py:max_pool_2x2_bwd_pallas:
// given x (N, H, W, C) with even H and W and the cotangent g (N, H/2, W/2, C),
// recompute each window's maximum and route g to the FIRST maximal element in
// row-major order (0,0), (0,1), (1,0), (1,1), zero elsewhere. The equality is
// x >= max, so a window of -inf still routes; a window that holds a NaN gets
// no gradient, as the maximum is NaN and no element compares >= to it.
//
// Bound by bytes: x and g are read once and dx written once, (2 + 1/4) elements
// per input element and a handful of compares. The kernel moves bits and
// compares values, so it is exact in either type.
//
// Design: one thread handles one window for a vector of channels (16-byte
// accesses when C fills whole 16-byte groups, else 2 elements or 1),
// consecutive threads on consecutive channel vectors so that every access is
// coalesced. The TPU
// kernel's rolls and parity masks are a workaround for its tiling and have no
// counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// The type of one load of BYTES bytes.
template <int BYTES>
struct Pack;
template <>
struct Pack<16> { using type = uint4; };
template <>
struct Pack<8> { using type = uint2; };
template <>
struct Pack<4> { using type = uint32_t; };
template <>
struct Pack<2> { using type = uint16_t; };

// E is the element's bit pattern: uint16_t for bf16, uint32_t for float32.
__device__ __forceinline__ float bits_to_float(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}
__device__ __forceinline__ float bits_to_float(uint32_t bits) { return __uint_as_float(bits); }

template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS)
pool_bwd_kernel(const E* __restrict__ x, const E* __restrict__ g, E* __restrict__ dx, int H,
                int W, int C, long long total) {
  using P = typename Pack<VEC * static_cast<int>(sizeof(E))>::type;
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int groups = C / VEC;
  const int h2 = H / 2;
  const int w2 = W / 2;
  const int cg = static_cast<int>(idx % groups);
  long long win = idx / groups;
  const int j = static_cast<int>(win % w2);
  win /= w2;
  const int i = static_cast<int>(win % h2);
  const long long n = win / h2;
  const int c = cg * VEC;

  const size_t row0 = ((static_cast<size_t>(n) * H + 2 * i) * W + 2 * j) * C + c;
  const size_t row1 = row0 + static_cast<size_t>(W) * C;
  const size_t goff = ((static_cast<size_t>(n) * h2 + i) * w2 + j) * C + c;
  const size_t offs[4] = {row0, row0 + C, row1, row1 + C};

  union U { P p; E e[VEC]; };
  U xin[4], out[4], gin;
#pragma unroll
  for (int q = 0; q < 4; ++q) xin[q].p = *reinterpret_cast<const P*>(x + offs[q]);
  gin.p = *reinterpret_cast<const P*>(g + goff);

#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = bits_to_float(xin[q].e[k]);
    float m = v[0];  // a maximum that keeps a NaN, as the plain version's does
#pragma unroll
    for (int q = 1; q < 4; ++q) m = (v[q] > m || v[q] != v[q]) ? v[q] : m;
    bool taken = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool first = !taken && v[q] >= m;
      out[q].e[k] = first ? gin.e[k] : static_cast<E>(0);
      taken = taken || first;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) *reinterpret_cast<P*>(dx + offs[q]) = out[q].p;
}

template <typename E, int VEC>
cudaError_t launch(const void* x, const void* g, void* dx, long long N, int H, int W, int C,
                   cudaStream_t stream) {
  const long long total = N * (H / 2) * (W / 2) * (C / VEC);
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  pool_bwd_kernel<E, VEC><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(g), static_cast<E*>(dx), H, W, C, total);
  return cudaGetLastError();
}

template <typename E>
int pool_bwd_impl(const void* x, const void* g, void* dx, int N, int H, int W, int C,
                  void* stream) {
  if (N < 1 || H < 2 || W < 2 || C < 1 || H % 2 != 0 || W % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dx);
  if (C % V == 0 && bits % 16 == 0) return static_cast<int>(launch<E, V>(x, g, dx, N, H, W, C, s));
  if (C % 2 == 0 && bits % (2 * sizeof(E)) == 0)
    return static_cast<int>(launch<E, 2>(x, g, dx, N, H, W, C, s));
  return static_cast<int>(launch<E, 1>(x, g, dx, N, H, W, C, s));
}

}  // namespace

// x, dx: (N, H, W, C) with even H and W; g: (N, H/2, W/2, C), all of one type:
// bf16 for _bf16, float32 for _f32. Returns the cudaError_t of the launch.
extern "C" int max_pool_2x2_bwd_bf16(const void* x, const void* g, void* dx, int N, int H,
                                     int W, int C, void* stream) {
  return pool_bwd_impl<uint16_t>(x, g, dx, N, H, W, C, stream);
}

extern "C" int max_pool_2x2_bwd_f32(const void* x, const void* g, void* dx, int N, int H,
                                    int W, int C, void* stream) {
  return pool_bwd_impl<uint32_t>(x, g, dx, N, H, W, C, stream);
}
