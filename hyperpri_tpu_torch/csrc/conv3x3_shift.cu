// 3x3 SAME convolution + bias + optional ReLU for NHWC bf16 or float32
// activations, built from three H-shifted row bands instead of a halo window.
//
// Replaces the TPU kernel
// hyperpri_tpu/ops/pallas/conv3x3_shift.py:conv3x3_bias_act_shift:
//
//     y = act(conv3x3_SAME(x, w) + b)
//
// with float32 accumulation, the float32 bias added before the optional ReLU
// and one rounding to the output type (x's, or float32). It is kernel 2's
// function (csrc/conv3x3.cu) without statistics or prologue, and no model path
// calls it.
//
// Bound. 2*N*H*W*C*O*9 FLOP; this formulation reads the input three times
// (one band per dh), so the bytes it moves are 3*N*H*W*C + N*H*W*O elements
// plus the weights. At the widths of a CubeNET training step (C, O >= 64)
// that is still above the card's ridge: bound by operations.
//
// Design, after the TPU kernel's idea. On the TPU each dh tap is its own
// non-overlapping BlockSpec stream of the padded input (th rows, no halo), so
// Mosaic pipelines three plain DMAs instead of one overlapping window copy.
// Here a block owns an 8x32 output tile by NP output channels (64 when
// O <= 64, else 128, the output tiles on blockIdx.z as in csrc/conv3x3.cu),
// and for each 64-byte chunk of input channels it stages three separate
// (8 rows) x (32+2 columns) bands, band dh holding input rows h0-1+dh ..
// h0+6+dh: no band of one dh overlaps another block's band of the same dh, and
// the block reads 24 input rows where the halo kernel reads 10. The dw taps are
// column offsets into a band in shared memory. The products are
// conv3x3_common.cuh's mma.sync fragments (bf16 m16n8k16, or 3xTF32 on
// m16n8k8 for float32): warp r owns output row h0+r, and the A fragment of tap
// (dh, dw) is row r of band dh shifted by dw columns.
// Not done: cp.async/TMA staging (which would give the three streams their
// pipelining) and wgmma.

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;

constexpr int BAND_PIX = TH * HALO_W;  // one dh band: 8 rows of 34 columns

template <int NP>
constexpr int shift_smem_bytes() {
  return (3 * BAND_PIX + 9 * NP) * ROW_BYTES;
}

template <typename T, typename TO, int NP, int VEC>
__global__ void __launch_bounds__(THREADS, NP == 64 ? 2 : 1)
conv3x3_shift_kernel(const T* __restrict__ x, const T* __restrict__ wp,
                     const float* __restrict__ bias, TO* __restrict__ y, int H, int W, int C,
                     int Cp, int O, int OP, int n_otiles, int relu) {
  constexpr int KC = Elem<T>::KC;
  constexpr int KS = Elem<T>::KS;
  constexpr int MMA_K = Elem<T>::MMA_K;
  constexpr int HALF_K = MMA_K / 2;
  constexpr int TAP_UNROLL = is_f32<T> ? 1 : 9;
  constexpr int NB = NP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* bands = reinterpret_cast<T*>(smem);   // [dh][BAND_PIX][KS]
  T* ws = bands + 3 * BAND_PIX * KS;       // [tap][NP][KS]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z / n_otiles;
  const int o0 = (blockIdx.z % n_otiles) * NP;
  const T* xn = x + static_cast<size_t>(n) * H * W * C;

  float acc[2][NB][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][nb][r] = 0.0f;

  for (int c0 = 0; c0 < Cp; c0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll 1
    for (int dh = 0; dh < 3; ++dh)
      stage_window<T, VEC, KC, KS, TH, HALO_W, false>(bands + dh * BAND_PIX * KS, xn, W * C, C,
                                                       H, W, C, h0 - 1 + dh, w0 - 1, c0,
                                                       nullptr, nullptr);
    load_weights<T, NP>(ws, wp, OP, Cp, o0, c0);
    __syncthreads();

#pragma unroll(TAP_UNROLL)
    for (int t = 0; t < 9; ++t) {
      const int dh = t / 3;
      const int dw = t % 3;
      const T* band = bands + dh * BAND_PIX * KS;
#pragma unroll
      for (int k = 0; k < KC; k += MMA_K) {
        if constexpr (is_f32<T>) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t a[4], a_hi[4], a_lo[4];
            const int px = warp * HALO_W + j * 16 + dw + (lane & 15);
            ldmatrix_x4(a, band + px * KS + k + (lane >> 4) * HALF_K);
            split_tf32(a, a_hi, a_lo);
#pragma unroll
            for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
              uint32_t b[4], b_hi[4], b_lo[4];
              const int row = t * NP + nb2 * 16 + (lane & 7) + ((lane >> 4) << 3);
              ldmatrix_x4(b, ws + row * KS + k + ((lane >> 3) & 1) * HALF_K);
              split_tf32(b, b_hi, b_lo);
              mma_3xtf32(acc[j][2 * nb2], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
              mma_3xtf32(acc[j][2 * nb2 + 1], a_hi, a_lo, b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
            }
          }
        } else {
          uint32_t a[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int px = warp * HALO_W + j * 16 + dw + (lane & 15);
            ldmatrix_x4(a[j], band + px * KS + k + (lane >> 4) * HALF_K);
          }
#pragma unroll
          for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
            uint32_t b[4];
            const int row = t * NP + nb2 * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(b, ws + row * KS + k + ((lane >> 3) & 1) * HALF_K);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mma_bf16_16816(acc[j][2 * nb2], a[j], b[0], b[1]);
              mma_bf16_16816(acc[j][2 * nb2 + 1], a[j], b[2], b[3]);
            }
          }
        }
      }
    }
  }

  // Epilogue: accumulator element r of tile (j, nb) is pixel
  // (lane/4 + 8*(r/2)) of row tile j, output channel o0 + nb*8 + 2*(lane%4) + r%2.
  const int oh = h0 + warp;
  if (oh >= H) return;
  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + j * 16 + (lane >> 2) + half * 8;
      if (ow >= W) continue;
      TO* yp = y + ((static_cast<size_t>(n) * H + oh) * W + ow) * O;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int o = o0 + nb * 8 + (lane & 3) * 2;
        if (o >= O) continue;
        float v0 = acc[j][nb][half * 2] + bias[o];
        if (relu) v0 = fmaxf(v0, 0.0f);
        if (o + 1 < O) {
          float v1 = acc[j][nb][half * 2 + 1] + bias[o + 1];
          if (relu) v1 = fmaxf(v1, 0.0f);
          if (pairs) {
            store_pair(yp + o, v0, v1);
            continue;
          }
          yp[o + 1] = from_f32<TO>(v1);
        }
        yp[o] = from_f32<TO>(v0);
      }
    }
  }
}

template <typename T, typename TO, int NP, int VEC>
cudaError_t launch_vec(const void* x, const void* wp, const void* b, void* y, int N, int H,
                       int W, int C, int Cp, int O, int OP, int relu, cudaStream_t stream) {
  auto kernel = conv3x3_shift_kernel<T, TO, NP, VEC>;
  constexpr int smem = shift_smem_bytes<NP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_otiles = OP / NP;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N * n_otiles);
  if (grid.y > 65535 || N * n_otiles > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wp), static_cast<const float*>(b),
      static_cast<TO*>(y), H, W, C, Cp, O, OP, n_otiles, relu);
  return cudaGetLastError();
}

template <typename T, typename TO, int NP>
cudaError_t launch_np(const void* x, const void* wp, const void* b, void* y, int N, int H, int W,
                      int C, int Cp, int O, int OP, int relu, cudaStream_t stream) {
  constexpr int V = Elem<T>::VEC_MAX;
  const int vec = load_width<T>(x, C, C, false);
  if (vec == V) return launch_vec<T, TO, NP, V>(x, wp, b, y, N, H, W, C, Cp, O, OP, relu, stream);
  if (vec == 2) return launch_vec<T, TO, NP, 2>(x, wp, b, y, N, H, W, C, Cp, O, OP, relu, stream);
  return launch_vec<T, TO, NP, 1>(x, wp, b, y, N, H, W, C, Cp, O, OP, relu, stream);
}

template <typename T, typename TO>
int shift_impl(const void* x, const void* wp, const void* b, void* y, int N, int H, int W, int C,
               int Cp, int O, int OP, int NP, int relu, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || O > OP || OP % NP != 0 || Cp < C ||
      Cp % Elem<T>::KC != 0 || static_cast<long long>(H) * W * (C > O ? C : O) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NP == 64) return static_cast<int>(launch_np<T, TO, 64>(x, wp, b, y, N, H, W, C, Cp, O, OP,
                                                             relu, s));
  if (NP == 128) return static_cast<int>(launch_np<T, TO, 128>(x, wp, b, y, N, H, W, C, Cp, O,
                                                               OP, relu, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (N, H, W, C); wp: (9, OP, Cp) packed weights of x's type with OP a
// multiple of NP (64 or 128) and Cp of the 64-byte chunk; b: (O,) f32; y:
// (N, H, W, O). _bf16 takes bf16 x and writes bf16 y, _bf16_f32 writes float32
// y from bf16 x, _f32 takes and writes float32. Returns the cudaError_t of the
// launch.
extern "C" int conv3x3_shift_bf16(const void* x, const void* wp, const void* b, void* y, int N,
                                  int H, int W, int C, int Cp, int O, int OP, int NP, int relu,
                                  void* stream) {
  return shift_impl<__nv_bfloat16, __nv_bfloat16>(x, wp, b, y, N, H, W, C, Cp, O, OP, NP, relu,
                                                  stream);
}

extern "C" int conv3x3_shift_bf16_f32(const void* x, const void* wp, const void* b, void* y,
                                      int N, int H, int W, int C, int Cp, int O, int OP, int NP,
                                      int relu, void* stream) {
  return shift_impl<__nv_bfloat16, float>(x, wp, b, y, N, H, W, C, Cp, O, OP, NP, relu, stream);
}

extern "C" int conv3x3_shift_f32(const void* x, const void* wp, const void* b, void* y, int N,
                                 int H, int W, int C, int Cp, int O, int OP, int NP, int relu,
                                 void* stream) {
  return shift_impl<float, float>(x, wp, b, y, N, H, W, C, Cp, O, OP, NP, relu, stream);
}
