// Probe of the one-op data movements that pinned the pool backward's
// formulation, one kernel per op on an (8, 16, 128) float32 array.
//
// Replaces the TPU probe scripts/probe_mosaic_ops.py:run_case, whose one-op
// Pallas kernels asked which ops Mosaic compiles (rolls per axis, repeats, a
// -inf select, strided concatenates, stack and broadcast reshapes). Each op
// here is a gather: thread i writes out[i] from the element of x that the op
// moves there, so every op is exact and the probe checks each against its
// PyTorch op bit for bit. The pool backward kernel (csrc/pool_bwd.cu, one
// thread a 2x2 window) uses none of them; the probe keeps the question
// answerable on this card.
//
// Bound. 16,384 elements read and written once (128 KiB): bytes, and at this
// size the launch itself.
// Design: one thread per output element, 256 threads a block.

#include <cuda_runtime.h>
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

template <int OP>
__global__ void mosaic_op_kernel(const float* __restrict__ x, float* __restrict__ y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= SIZE) return;
  const int a = i / (A1 * A2);
  const int b = (i / A2) % A1;
  const int c = i % A2;
  int sa = a, sb = b;  // the source element of out[a, b, c]
  if constexpr (OP == ROLL_AXIS0) sa = (a + A0 - 1) % A0;
  if constexpr (OP == ROLL_AXIS1) sb = (b + A1 - 1) % A1;
  if constexpr (OP == REPEAT_AXIS0) sa = a / 2;
  if constexpr (OP == REPEAT_AXIS1 || OP == BCAST_RESHAPE_AXIS1) sb = b / 2;
  if constexpr (OP == STRIDE2_AXIS0) sa = a < A0 / 2 ? 2 * a : 2 * (a - A0 / 2) + 1;
  if constexpr (OP == STACK_RESHAPE_AXIS0) sa = (a % 2) * (A0 / 2) + a / 2;
  const float v = x[(sa * A1 + sb) * A2 + c];
  if constexpr (OP == NEG_INF_WHERE) {
    y[i] = v > 0.0f ? -CUDART_INF_F : v;
  } else {
    y[i] = v;
  }
}

template <int OP>
cudaError_t launch_op(const float* x, float* y, cudaStream_t s) {
  mosaic_op_kernel<OP><<<SIZE / 256, 256, 0, s>>>(x, y);
  return cudaGetLastError();
}

}  // namespace

// op: the Op index (the order of the TPU probe's cases); x, y: (8, 16, 128)
// float32. Returns the cudaError_t of the launch.
extern "C" int mosaic_op_f32(int op, const void* x, void* y, void* stream) {
  const float* in = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
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
