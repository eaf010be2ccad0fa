// 3x3 SAME convolution for NHWC bf16 activations with any number of outputs.
//
// Replaces the TPU kernel hyperpri_tpu/ops/pallas/conv3x3.py:conv3x3_bias_act:
//
//     y = act(conv3x3_SAME(act_in(x), w) + b)
//
// with act_in the optional prologue relu(pa*x + pb) (in-image pixels only, the
// SAME border is exact zero), f32 accumulation, the f32 bias added before the
// optional ReLU, one rounding to bf16 at the store, and optionally the
// BatchNorm statistics sum(y), sum(y*y) per output channel taken from the f32
// value before the rounding. It is the route of the layers whose output is
// wider than the packed kernel takes: C, O in {64, 128, 256} at 304x484 and
// 152x242 in a CubeNET training step, forward and adjoint.
//
// Bound. 2*N*H*W*C*O*9 FLOP against (N*H*W*(C + O) + 9*C*O) bf16 elements:
// 9*C*O/(C+O) FLOP per byte is 384 at 64->128, 576 at 128->128 and 1152 at
// 256->256, all above the ~295 FLOP/byte ridge of an H100: bound by operations.
//
// Design: the direct implicit GEMM of conv3x3_common.cuh with the output
// channels tiled over the grid. A block computes an 8x32 pixel tile by 128
// output channels (64 when O <= 64); blockIdx.z walks images and output tiles,
// so every output tile stages the input halo again (C/32 chunks of 10x34x32
// elements, from L2 after the first tile). The weights arrive pre-packed as
// wp[tap][o][c] with O zero-padded to whole tiles and C to a multiple of 32.
// The per-channel sums are per-block partials added in a fixed order by a
// second kernel, never float atomics. Not yet done: sharing one staged halo
// between output tiles, cp.async/TMA staging and wgmma.

#include "conv3x3_common.cuh"

// x: (N, H, W, C) bf16; wp: (9, OP, Cp) bf16 packed weights with OP = n_otiles*NP;
// b: (O,) f32; y: (N, H, W, O) bf16; pa, pb: null or the (C,) f32 prologue
// affine; partial: (partial_rows, 2, OP) f32 scratch and sums: (2, OP) f32, only
// with mode 1 (statistics). Returns the cudaError_t of the launches.
extern "C" int conv3x3_bias_act_bf16(const void* x, const void* wp, const void* b, void* y,
                                     const void* pa, const void* pb, void* partial,
                                     void* sums, int N, int H, int W, int C, int Cp, int O,
                                     int OP, int NP, int relu, int mode, int partial_rows,
                                     void* stream) {
  using namespace conv3x3;
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || O > OP || OP % NP != 0 || Cp < C ||
      Cp % KC != 0 || (mode != MODE_PLAIN && mode != MODE_STATS) ||
      (pa == nullptr) != (pb == nullptr) || (mode == MODE_STATS && relu))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.wp = static_cast<const __nv_bfloat16*>(wp);
  p.bias = static_cast<const float*>(b);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.pa = static_cast<const float*>(pa);
  p.pb = static_cast<const float*>(pb);
  p.r = nullptr;
  p.partial = static_cast<float*>(partial);
  p.x_lanes_zero = false;
  p.d = ConvDims{H, W, C, Cp, O, OP, OP / NP, relu, mode,
                 unframed(H, W, C), unframed(H, W, O), unframed(H, W, O)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sums);
  if (NP == 64) return static_cast<int>(launch_conv<64>(p, N, partial_rows, out, s));
  if (NP == 128) return static_cast<int>(launch_conv<128>(p, N, partial_rows, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
