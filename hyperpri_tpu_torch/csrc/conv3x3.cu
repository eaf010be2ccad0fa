// 3x3 SAME convolution for NHWC bf16 or float32 activations with any number of
// outputs.
//
// Replaces the TPU kernel hyperpri_tpu/ops/pallas/conv3x3.py:conv3x3_bias_act:
//
//     y = act(conv3x3_SAME(act_in(x), w) + b)
//
// with act_in the optional prologue relu(pa*x + pb) (in-image pixels only, the
// SAME border is exact zero), f32 accumulation, the f32 bias added before the
// optional ReLU, one rounding to x's type at the store, and optionally the
// BatchNorm statistics sum(y), sum(y*y) per output channel taken from the f32
// value before the rounding. It is the route of the layers whose output is
// wider than the packed kernel takes: C, O in {64, 128, 256} at 304x484 and
// 152x242 in a CubeNET training step, forward and adjoint.
//
// Bound. 2*N*H*W*C*O*9 FLOP against (N*H*W*(C + O) + 9*C*O) elements:
// 9*C*O/(C+O) FLOP per bf16 byte is 384 at 64->128, 576 at 128->128 and 1152 at
// 256->256, all above the ~295 FLOP/byte ridge of an H100: bound by operations.
// In float32 (half the FLOP per byte, against TF32's ridge of ~148) too.
//
// Design: the direct implicit GEMM of conv3x3_common.cuh (bf16 products, or
// 3xTF32 for float32) with the output channels tiled over the grid. A block
// computes an 8x32 pixel tile by 128 output channels (64 when O <= 64);
// blockIdx.z walks images and output tiles,
// so every output tile stages the input halo again (10x34-pixel chunks of 64
// bytes of channels, from L2 after the first tile). The weights arrive
// pre-packed as wp[tap][o][c] in x's type with O zero-padded to whole tiles
// and C to a whole chunk (32 bf16 or 16 float32 channels).
// The per-channel sums are per-block partials added in a fixed order by a
// second kernel, never float atomics. Not yet done: sharing one staged halo
// between output tiles, cp.async/TMA staging and wgmma.

#include "conv3x3_common.cuh"

namespace {

template <typename T>
int bias_act_impl(const void* x, const void* wp, const void* b, void* y, const void* pa,
                  const void* pb, void* partial, void* sums, int N, int H, int W, int C, int Cp,
                  int O, int OP, int NP, int relu, int mode, int partial_rows, void* stream) {
  using namespace conv3x3;
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || O > OP || OP % NP != 0 || Cp < C ||
      Cp % Elem<T>::KC != 0 || (mode != MODE_PLAIN && mode != MODE_STATS) ||
      (pa == nullptr) != (pb == nullptr) || (mode == MODE_STATS && relu))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams<T> p;
  p.x = static_cast<const T*>(x);
  p.wp = static_cast<const T*>(wp);
  p.bias = static_cast<const float*>(b);
  p.y = static_cast<T*>(y);
  p.pa = static_cast<const float*>(pa);
  p.pb = static_cast<const float*>(pb);
  p.r = nullptr;
  p.partial = static_cast<float*>(partial);
  p.x_lanes_zero = false;
  p.d = ConvDims{H, W, C, Cp, O, OP, OP / NP, relu, mode,
                 unframed(H, W, C), unframed(H, W, O), unframed(H, W, O)};
  return static_cast<int>(launch_conv_np<T>(p, NP, N, partial_rows, static_cast<float*>(sums),
                                            static_cast<cudaStream_t>(stream)));
}

}  // namespace

// x: (N, H, W, C); wp: (9, OP, Cp) packed weights of x's type with OP =
// n_otiles*NP; b: (O,) f32; y: (N, H, W, O) of x's type; pa, pb: null or the
// (C,) f32 prologue affine; partial: (partial_rows, 2, OP) f32 scratch and
// sums: (2, OP) f32, only with mode 1 (statistics). _bf16 takes bf16 tensors,
// _f32 float32 ones. Returns the cudaError_t of the launches.
extern "C" int conv3x3_bias_act_bf16(const void* x, const void* wp, const void* b, void* y,
                                     const void* pa, const void* pb, void* partial,
                                     void* sums, int N, int H, int W, int C, int Cp, int O,
                                     int OP, int NP, int relu, int mode, int partial_rows,
                                     void* stream) {
  return bias_act_impl<__nv_bfloat16>(x, wp, b, y, pa, pb, partial, sums, N, H, W, C, Cp, O,
                                      OP, NP, relu, mode, partial_rows, stream);
}

extern "C" int conv3x3_bias_act_f32(const void* x, const void* wp, const void* b, void* y,
                                    const void* pa, const void* pb, void* partial,
                                    void* sums, int N, int H, int W, int C, int Cp, int O,
                                    int OP, int NP, int relu, int mode, int partial_rows,
                                    void* stream) {
  return bias_act_impl<float>(x, wp, b, y, pa, pb, partial, sums, N, H, W, C, Cp, O, OP, NP,
                              relu, mode, partial_rows, stream);
}
