// Probe: does packing two dh taps into the K axis pay for the C = 64 convs?
//
// Replaces the TPU probe scripts/probe_dh_fold.py:build (its kernels
// _current_kernel and _folded_kernel). Both compute, on a bf16 buffer x that
// is already padded (N, HP, WP, lanes) with the output channels LS = 64,
//
//     out[n, h, w, o] = sum_{dh, dw, c} x[n, h+dh, w+dw, c] * W[dh][c, dw*64 + o]
//
// for an (N, HP-2, WP-8, 64) bf16 output, in float32:
//   - current: x has 128 lanes whose upper 64 are zero, W = w (3, 128, 192)
//     whose rows 64+ are zero: three dh products of K = 128, half of K zero;
//   - folded: x has the 64 real lanes; the K = 128 operand [x(dh0) | x(dh1)]
//     is multiplied by w01 (1, 128, 192), then [x(dh2) | 0] by w2 (1, 128,
//     192) whose rows 64+ are zero: two products of K = 128 instead of three.
// On the TPU the K axis is the 128-lane MXU's, and K = 64 leaves half of each
// pass idle. Here a bf16 mma.sync is m16n8k16: K = 64 would be four steps, so
// the zero half of K is work the card need not have done, and the probe
// times how much of it it pays.
//
// The TPU kernels form P = x_window (TH*72, 128) @ W (128, 192) and end with
// the shifted add P[:, 0:64, 0:64] + P[:, 1:65, 64:128] + P[:, 2:66, 128:192].
// Here accumulator element (pixel w, output o) of the dw-th 64-column group
// takes its A rows from window column w + dw, so that element IS
// P[w + dw, dw*64 + o]: the shifted add happens in the accumulator, with no P
// buffer in shared memory.
//
// Bound. 2*N*HO*WO*64*9*128 FLOP (current; folded 6*128, both with the zero
// halves counted) against the bf16 input and output read and written once:
// bound by operations.
//
// Design. A block owns TH x TW = 8 x 64 output pixels by the 64 outputs; warp
// r owns output row r (four 16-pixel A tiles by eight 8-wide B tiles, 128
// float32 accumulators a thread). K is walked in chunks of 32 lanes (64
// bytes, the conv kernels' staged chunk, conv3x3_common.cuh):
//   - current: per chunk of the 128-lane buffer the (8+2) x (64+2) window and
//     the chunk's nine (dh, dw) weight slices are staged; nine taps;
//   - folded: per chunk of the two K = 128 operands an 8 x (64+2) window of
//     the 64-lane buffer at row offset dh (0 or 1 for [x(dh0) | x(dh1)], 2 or
//     zeros for [x(dh2) | 0]) is staged with the chunk's three dw slices;
//     three taps.
// The wrapper packs the weights as [chunk][tap][o][32 lanes] so that the B
// fragments are ldmatrix rows.

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;
using T = __nv_bfloat16;

constexpr int PTW = 64;             // output columns per block
constexpr int WIN_W = PTW + 2;      // window columns
constexpr int LS = 64;              // output channels
constexpr int KC = 32;              // lanes per staged chunk
constexpr int KS = ROW_BYTES / 2;   // shared row stride in elements (80 bytes)

constexpr int probe_smem_bytes() {
  return ((TH + 2) * WIN_W + 9 * LS) * ROW_BYTES;  // the current kernel's, the larger
}

// Stage the chunk's weights wk[tap][o][KC] (TAPS x 64 rows of 64 bytes).
template <int TAPS>
__device__ __forceinline__ void stage_weights(T* ws, const T* wk) {
  for (int i = threadIdx.x; i < TAPS * LS * 4; i += THREADS) {
    const int row = i / 4;
    const int g = i % 4;
    *reinterpret_cast<uint4*>(ws + row * KS + g * 8) =
        *reinterpret_cast<const uint4*>(wk + row * KC + g * 8);
  }
}

// acc[j][nb] += window rows (warp + dh), columns j*16 + dw .. +16, times the
// tap's 64 x 32 weight slice, for each (dh, dw) of the TAPS taps.
template <int TAPS, int DH_TAPS>
__device__ __forceinline__ void products(float (&acc)[4][8][4], const T* win, const T* ws,
                                         int warp, int lane) {
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const int dh = DH_TAPS ? t / 3 : 0;
    const int dw = t % 3;
#pragma unroll
    for (int k = 0; k < KC; k += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int px = (warp + dh) * WIN_W + j * 16 + dw + (lane & 15);
        ldmatrix_x4(a[j], win + px * KS + k + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t b[4];
        const int row = t * LS + nb2 * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, ws + row * KS + k + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16_16816(acc[j][2 * nb2], a[j], b[0], b[1]);
          mma_bf16_16816(acc[j][2 * nb2 + 1], a[j], b[2], b[3]);
        }
      }
    }
  }
}

template <bool FOLDED>
__global__ void __launch_bounds__(THREADS, 1)
dh_fold_kernel(const T* __restrict__ x, const T* __restrict__ wk, T* __restrict__ y, int HP,
               int WP, int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  T* ws = win + (TH + 2) * WIN_W * KS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * PTW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z;
  const int HO = HP - 2;
  const int WO = WP - 8;
  const T* xn = x + static_cast<size_t>(n) * HP * WP * lanes;

  float acc[4][8][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][nb][r] = 0.0f;

  if constexpr (!FOLDED) {
    for (int chunk = 0; chunk < 4; ++chunk) {
      __syncthreads();
      stage_window<T, 8, KC, KS, TH + 2, WIN_W, false>(win, xn, WP * lanes, lanes, HP, WP,
                                                       lanes, h0, w0, chunk * KC, nullptr,
                                                       nullptr);
      stage_weights<9>(ws, wk + static_cast<size_t>(chunk) * 9 * LS * KC);
      __syncthreads();
      products<9, 1>(acc, win, ws, warp, lane);
    }
  } else {
    for (int step = 0; step < 8; ++step) {   // two K = 128 operands, four chunks each
      const int pass = step / 4;
      const int chunk = step % 4;
      __syncthreads();
      if (pass == 1 && chunk >= 2) {         // [x(dh2) | 0]: the zero half
        for (int i = threadIdx.x; i < TH * WIN_W * 4; i += THREADS)
          *reinterpret_cast<uint4*>(win + (i / 4) * KS + (i % 4) * 8) = make_uint4(0, 0, 0, 0);
      } else {
        const int dh = pass == 0 ? chunk / 2 : 2;
        stage_window<T, 8, KC, KS, TH, WIN_W, false>(win, xn, WP * lanes, lanes, HP, WP, lanes,
                                                     h0 + dh, w0, (chunk % 2) * KC, nullptr,
                                                     nullptr);
      }
      stage_weights<3>(ws, wk + static_cast<size_t>(step) * 3 * LS * KC);
      __syncthreads();
      products<3, 0>(acc, win, ws, warp, lane);
    }
  }

  const int oh = h0 + warp;
  if (oh >= HO) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + j * 16 + (lane >> 2) + half * 8;
      if (ow >= WO) continue;
      T* yp = y + ((static_cast<size_t>(n) * HO + oh) * WO + ow) * LS;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        store_pair(yp + nb * 8 + (lane & 3) * 2, acc[j][nb][half * 2], acc[j][nb][half * 2 + 1]);
    }
  }
}

template <bool FOLDED>
int launch(const void* x, const void* wk, void* y, int N, int HP, int WP, int lanes,
           void* stream) {
  if (N < 1 || HP < 3 || WP < 9 || (HP - 2) % TH != 0 || (WP - 8) % PTW != 0 ||
      lanes != (FOLDED ? 64 : 128) || static_cast<long long>(HP) * WP * lanes >= (1LL << 31) ||
      N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dh_fold_kernel<FOLDED>;
  constexpr int smem = probe_smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((WP - 8) / PTW, (HP - 2) / TH, N);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), static_cast<T*>(y), HP, WP, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, HP, WP, 128) bf16 for _current, (N, HP, WP, 64) for _folded, with
// HP - 2 a multiple of 8 and WP - 8 of 64; wk: the packed weights, bf16
// [chunk][tap][64][32]: (4, 9, 64, 32) for _current (tap = 3*dh + dw), (8, 3,
// 64, 32) for _folded (the four chunks of w01, then of w2; tap = dw); y:
// (N, HP-2, WP-8, 64) bf16. Returns the cudaError_t of the launch.
extern "C" int dh_fold_current(const void* x, const void* wk, void* y, int N, int HP, int WP,
                               void* stream) {
  return launch<false>(x, wk, y, N, HP, WP, 128, stream);
}

extern "C" int dh_fold_folded(const void* x, const void* wk, void* y, int N, int HP, int WP,
                              void* stream) {
  return launch<true>(x, wk, y, N, HP, WP, 64, stream);
}
