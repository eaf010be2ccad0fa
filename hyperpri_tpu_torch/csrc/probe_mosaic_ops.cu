// Probe of the one-op data movements that pinned the pool backward's
// formulation, one kernel per op on an (8, 16, 128) float32 array.
//
// Replaces the TPU probe scripts/probe_mosaic_ops.py:run_case, whose one-op
// Pallas kernels asked which ops Mosaic compiles (rolls per axis, repeats, a
// -inf select, strided concatenates, stack and broadcast reshapes). Each op
// here is a gather: each output element is read from the element of x that
// the op moves there, so every op is exact and the probe checks each against its
// PyTorch op bit for bit. The pool backward kernel (csrc/pool_bwd.cu, one
// thread a 2x2 window) uses none of them; the probe keeps the question
// answerable on this card.
//
// Bound. 16,384 elements read and written once (128 KiB): bytes, 0.04 us at
// 3.35 TB/s; at this size the launch itself takes longer.
// Design: every op keeps the lane index c (it moves whole 128-float rows, and
// the -inf select is elementwise), so one thread moves four neighbouring
// lanes as one 16-byte float4, gathered from the same source row: 4,096
// threads, 16 blocks of 256, one launch per op as the TPU probe has one
// pallas_call per op. (The first port moved one float a thread with 4-byte
// accesses, 64 blocks.)

#include <cuda_runtime.h>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int A0 = 8, A1 = 16, A2 = 128;  // (outer, sublane, lane) as on the TPU
constexpr int SIZE = A0 * A1 * A2;

enum Op {
  ROLL_AXIS0 = 0,        // jnp.roll(x, 1, 0)
  ROLL_AXIS1,            // jnp.roll(x, 1, 1)
  REPEAT_AXIS0,          // jnp.repeat(x[:4], 2, axis=0)
  REPEAT_AXIS1,          // jnp.repeat(x[:, :8], 2, axis=1)
  NEG_INF_WHERE,         // jnp.where(x > 0, -inf, x)
  STRIDE2_AXIS0,         // jnp.concatenate([x[0::2], x[1::2]], 0)
  STACK_RESHAPE_AXIS0,   // jnp.stack([x[:4], x[4:]], axis=1).reshape(8, 16, 128)
  BCAST_RESHAPE_AXIS1,   // broadcast_to(x[:, :8, None, :], (8, 8, 2, 128)).reshape(8, 16, 128)
};

constexpr int ROW4 = A2 / 4;  // float4s of one row

template <int OP>
__global__ void mosaic_op_kernel(const float4* __restrict__ x, float4* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // float4 index: lanes 4*c4 ..
  if (i >= SIZE / 4) return;
  const int a = i / (A1 * ROW4);
  const int b = (i / ROW4) % A1;
  const int c4 = i % ROW4;
  int sa = a, sb = b;  // the source row of out[a, b, :]
  if constexpr (OP == ROLL_AXIS0) sa = (a + A0 - 1) % A0;
  if constexpr (OP == ROLL_AXIS1) sb = (b + A1 - 1) % A1;
  if constexpr (OP == REPEAT_AXIS0) sa = a / 2;
  if constexpr (OP == REPEAT_AXIS1 || OP == BCAST_RESHAPE_AXIS1) sb = b / 2;
  if constexpr (OP == STRIDE2_AXIS0) sa = a < A0 / 2 ? 2 * a : 2 * (a - A0 / 2) + 1;
  if constexpr (OP == STACK_RESHAPE_AXIS0) sa = (a % 2) * (A0 / 2) + a / 2;
  float4 v = __ldg(x + (sa * A1 + sb) * ROW4 + c4);
  if constexpr (OP == NEG_INF_WHERE) {
    v.x = v.x > 0.0f ? -CUDART_INF_F : v.x;
    v.y = v.y > 0.0f ? -CUDART_INF_F : v.y;
    v.z = v.z > 0.0f ? -CUDART_INF_F : v.z;
    v.w = v.w > 0.0f ? -CUDART_INF_F : v.w;
  }
  y[i] = v;
}

template <int OP>
cudaError_t launch_op(const float* x, float* y, cudaStream_t s) {
  mosaic_op_kernel<OP><<<SIZE / 4 / 256, 256, 0, s>>>(reinterpret_cast<const float4*>(x),
                                                      reinterpret_cast<float4*>(y));
  return cudaGetLastError();
}

}  // namespace

// op: the Op index (the order of the TPU probe's cases); x, y: (8, 16, 128)
// float32, 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int mosaic_op_f32(int op, const void* x, void* y, void* stream) {
  const float* in = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(err);
  switch (op) {
    case ROLL_AXIS0: err = launch_op<ROLL_AXIS0>(in, out, s); break;
    case ROLL_AXIS1: err = launch_op<ROLL_AXIS1>(in, out, s); break;
    case REPEAT_AXIS0: err = launch_op<REPEAT_AXIS0>(in, out, s); break;
    case REPEAT_AXIS1: err = launch_op<REPEAT_AXIS1>(in, out, s); break;
    case NEG_INF_WHERE: err = launch_op<NEG_INF_WHERE>(in, out, s); break;
    case STRIDE2_AXIS0: err = launch_op<STRIDE2_AXIS0>(in, out, s); break;
    case STACK_RESHAPE_AXIS0: err = launch_op<STACK_RESHAPE_AXIS0>(in, out, s); break;
    case BCAST_RESHAPE_AXIS1: err = launch_op<BCAST_RESHAPE_AXIS1>(in, out, s); break;
    default: break;
  }
  return static_cast<int>(err);
}
