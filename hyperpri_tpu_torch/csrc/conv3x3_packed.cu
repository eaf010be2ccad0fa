// 3x3 SAME convolution for NHWC bf16 or float32 activations with O <= 128
// outputs, in the modes of a training step.
//
// Replaces the TPU kernel hyperpri_tpu/ops/pallas/conv3x3_packed.py:conv3x3_packed:
//
//     y[n,h,w,o] = act(sum_{dh,dw,c} z[n,h+dh-1,w+dw-1,c] * w[dh,dw,c,o] + b[o])
//
// with zeros outside the image, f32 accumulation, the f32 bias added before the
// ReLU, and one rounding to x's type at the store (none for float32). The modes:
//   - prologue: z = relu(pa*x + pb) per input channel, computed in f32 and
//     rounded to x's type while the halo is staged, for in-image pixels only
//     (the SAME border is exact zero); without pa/pb, z = x;
//   - statistics: also sum(y) and sum(y*y) per output channel over N, H, W,
//     from the f32 accumulator plus bias, before the rounding;
//   - backward epilogue: x is a cotangent, w the flipped and transposed
//     weights, no bias; with dz the accumulator, r the saved producer output
//     and m = (pa*r + pb > 0): stores dx = m*dz*pa and returns dpa = sum m*dz*r,
//     dpb = sum m*dz.
// Framings (the JAX kernel's pre_padded, arena_in, arena_out and arena_g):
// x, y and r are framed views of their buffers, so the host pre-padded ingest
// buffer (logical (0,0) at (1,1), channel pitch 256) and arena buffers
// (logical (0,0) at (8,8)) are read and written in place; staging zero-fills
// everything outside the logical region by select.
// The per-channel sums are per-block partials added in a fixed order by a
// second kernel (conv3x3_common.cuh), never float atomics.
//
// Bound. The work is 2*N*H*W*C*O*9 FLOP against (N*H*W*C + N*H*W*O + 9*C*O)
// elements moved, i.e. about 9*C*O/(C+O) FLOP per bf16 byte. At CubeNET's
// full-resolution layers (608x968, O=64) that is 454 (C=238), 384 (C=128) and
// 288 (C=64) FLOP per byte, against the ~295 FLOP/byte at which an H100's bf16
// tensor cores (989 TFLOP/s dense) and its memory (3.35 TB/s) balance: the
// kernel is bound by operations, and 64->64 sits on the ridge. In float32 the
// bytes double and the tensor rate is TF32's 495 TFLOP/s, of which 3xTF32
// takes three products per multiply: bound by operations again.
//
// Design: the direct implicit GEMM of conv3x3_common.cuh with one output tile
// (NP in {64, 128} columns, O zero-padded to it), bf16 products or 3xTF32 for
// float32. Channels are loaded 16 bytes at a time when C fills whole 16-byte
// groups, two elements at a time when C is even (C = 238 in bf16 gives 476-byte
// pixels, which are only 4-byte aligned), and one element otherwise; the input
// is never padded in device memory. The weights arrive pre-packed by the
// wrapper as wp[tap][o][c] in x's type (tap = 3*dh+dw, C zero-padded to a
// whole 64-byte chunk: 32 bf16 or 16 float32 channels).
// Not yet done: double-buffered cp.async/TMA staging and wgmma, which is what
// the card's full tensor rate needs.

#include "conv3x3_common.cuh"

namespace {

template <typename T>
int packed_impl(const void* x, const void* wp, const void* b, void* y, const void* pa,
                const void* pb, const void* r, void* partial, void* sums, const int* frames,
                int N, int H, int W, int C, int Cp, int O, int NP, int relu, int mode,
                int x_lanes_zero, int partial_rows, void* stream) {
  using namespace conv3x3;
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || O > NP || Cp < C ||
      Cp % Elem<T>::KC != 0 || mode < MODE_PLAIN || mode > MODE_BWD ||
      (pa == nullptr) != (pb == nullptr) ||
      (mode == MODE_BWD && (pa == nullptr || r == nullptr || relu)) ||
      (mode == MODE_STATS && relu) || frames == nullptr ||
      (x_lanes_zero && pa != nullptr && mode != MODE_BWD))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams<T> p;
  p.x = static_cast<const T*>(x);
  p.wp = static_cast<const T*>(wp);
  p.bias = static_cast<const float*>(b);
  p.y = static_cast<T*>(y);
  p.pa = static_cast<const float*>(pa);
  p.pb = static_cast<const float*>(pb);
  p.r = static_cast<const T*>(r);
  p.partial = static_cast<float*>(partial);
  p.x_lanes_zero = x_lanes_zero != 0;
  const Frame fx{frames[0], frames[1], frames[2], frames[3], frames[4]};
  const Frame fy{frames[5], frames[6], frames[7], frames[8], frames[9]};
  const Frame fr{frames[10], frames[11], frames[12], frames[13], frames[14]};
  p.d = ConvDims{H, W, C, Cp, O, NP, 1, relu, mode, fx, fy, fr};
  return static_cast<int>(launch_conv_np<T>(p, NP, N, partial_rows, static_cast<float*>(sums),
                                            static_cast<cudaStream_t>(stream)));
}

}  // namespace

// x: logical (N, H, W, C); wp: (9, NP, Cp) packed weights of x's type; b: (O,)
// f32; y: logical (N, H, W, O) of x's type. pa, pb: null, or the f32 prologue
// affine (C,), or in mode 2 the (O,) affine. r: mode 2 only, logical (N, H, W,
// O) of x's type. frames: 15 ints, the views {rows, cols, pitch, r0, c0} of x, y
// and r (see Frame in conv3x3_common.cuh): the pre-padded ingest buffer, arena
// buffers or plain tensors. x_lanes_zero: x's buffer holds zeros from channel C
// to its pitch (16-byte loads at C = 238). partial: (partial_rows, 2, NP) f32
// scratch and sums: (2, NP) f32, modes 1 and 2 only. NP is 64 (O <= 64) or 128
// (O <= 128); Cp is C rounded up to a whole chunk (32 bf16 or 16 float32
// channels). _bf16 takes bf16 tensors, _f32 float32 ones. Returns the
// cudaError_t of the launches.
extern "C" int conv3x3_packed_bf16(const void* x, const void* wp, const void* b, void* y,
                                   const void* pa, const void* pb, const void* r,
                                   void* partial, void* sums, const int* frames, int N, int H,
                                   int W, int C, int Cp, int O, int NP, int relu, int mode,
                                   int x_lanes_zero, int partial_rows, void* stream) {
  return packed_impl<__nv_bfloat16>(x, wp, b, y, pa, pb, r, partial, sums, frames, N, H, W, C,
                                    Cp, O, NP, relu, mode, x_lanes_zero, partial_rows, stream);
}

extern "C" int conv3x3_packed_f32(const void* x, const void* wp, const void* b, void* y,
                                  const void* pa, const void* pb, const void* r,
                                  void* partial, void* sums, const int* frames, int N, int H,
                                  int W, int C, int Cp, int O, int NP, int relu, int mode,
                                  int x_lanes_zero, int partial_rows, void* stream) {
  return packed_impl<float>(x, wp, b, y, pa, pb, r, partial, sums, frames, N, H, W, C, Cp, O,
                            NP, relu, mode, x_lanes_zero, partial_rows, stream);
}
