// Probe of the arena output framing: y = 2x written into a larger buffer with
// logical pixel (0,0) at (8,8).
//
// Replaces the TPU probe scripts/probe_element_out.py:run (the JAX package's), whose
// pallas_call writes through Element-indexed output windows at +8 offsets to
// show that a TPU kernel can emit an arena-framed output. Here the same
// contract is a framed store (Frame, conv3x3_common.cuh), the one the conv
// kernels' arena_out mode uses.
//
// Bound. N*H*W*C float32 elements read and written once: bytes, 8 per element.
// Design: one thread per 4-channel group (16-byte loads and stores when C % 4
// == 0 and the pitch keeps rows 16-byte aligned, one element otherwise),
// grid-stride over the logical elements.

#include "conv3x3_common.cuh"

namespace {

using conv3x3::Frame;
using conv3x3::image_offset;

template <int VEC>
__global__ void element_out_kernel(const float* __restrict__ x, float* __restrict__ y,
                                   const Frame fy, int N, int H, int W, int C) {
  const int groups = C / VEC;
  const size_t total = static_cast<size_t>(N) * H * W * groups;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int g = static_cast<int>(i % groups);
    const size_t px = i / groups;
    const int w = static_cast<int>(px % W);
    const int h = static_cast<int>((px / W) % H);
    const int n = static_cast<int>(px / (static_cast<size_t>(W) * H));
    const size_t src = px * C + static_cast<size_t>(g) * VEC;
    const size_t dst = image_offset(fy, n) + (h * fy.cols + w) * fy.pitch + g * VEC;
    if constexpr (VEC == 4) {
      float4 v = *reinterpret_cast<const float4*>(x + src);
      v.x *= 2.0f;
      v.y *= 2.0f;
      v.z *= 2.0f;
      v.w *= 2.0f;
      *reinterpret_cast<float4*>(y + dst) = v;
    } else {
      y[dst] = 2.0f * x[src];
    }
  }
}

}  // namespace

// x: (N, H, W, C) f32; y: the framed output, frame = {rows, cols, pitch, r0,
// c0} (5 ints). Returns the cudaError_t of the launch.
extern "C" int element_out_f32(const void* x, void* y, const int* frame, int N, int H, int W,
                               int C, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || frame == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Frame fy{frame[0], frame[1], frame[2], frame[3], frame[4]};
  if (!conv3x3::frame_ok(fy, H, W, C)) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = C % 4 == 0 && fy.pitch % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = 132 * 8;
  if (wide)
    element_out_kernel<4><<<blocks, threads, 0, s>>>(static_cast<const float*>(x),
                                                      static_cast<float*>(y), fy, N, H, W, C);
  else
    element_out_kernel<1><<<blocks, threads, 0, s>>>(static_cast<const float*>(x),
                                                      static_cast<float*>(y), fy, N, H, W, C);
  return static_cast<int>(cudaGetLastError());
}
