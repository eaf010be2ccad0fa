// Weight gradient of a 3x3 SAME convolution for NHWC bf16 or float32
// activations.
//
// Replaces the TPU kernel hyperpri_tpu/ops/pallas/conv3x3_grad.py:conv3x3_wgrad:
//
//     dW[dh,dw,c,o] = sum_{n,h,w} z[n,h+dh-1,w+dw-1,c] * g[n,h,w,o]      (f32)
//
// with z = x, or z = relu(pa*x + pb) recomputed from the raw x while it is
// staged (rounded to x's type, in-image pixels only; outside the image z is
// zero).
// x and g are framed views (the JAX kernel's pre_padded_c, arena_in and
// arena_g): the host pre-padded ingest buffer and arena buffers are read in
// place, and only their logical regions are staged (zero elsewhere, by select).
//
// Bound. 2*N*H*W*9*C*O FLOP against x and g read once and dW written (f32):
// with ~1.18 M pixels at full resolution that is 9*C*O/(C+O) FLOP per bf16
// byte again (454 at 238x64), above the ~295 FLOP/byte ridge of an H100:
// bound by operations; in float32 half of that, against TF32's ~148.
//
// Design. For each tap this is a GEMM with M = C, N = O and the pixels as the
// reduction axis K, which here is the long one. The TPU kernel keeps all of dW
// resident while a sequential grid walks the image; blocks on a GPU run in no
// order, so the reduction is split:
//   - blockIdx = (pixel split, C tile of 64, O tile of 64). A block walks the
//     8x32 pixel tiles of its split; for each it stages the (8+2)x(32+2)x64
//     halo of z and the 8x32x64 tile of g in shared memory (zero outside the
//     image and past C or O, so the loops have no masks);
//   - each of the 8 warps owns 16 input channels by 32 output channels for all
//     nine taps (144 f32 accumulators a thread). Both operands are stored
//     pixel-major. In bf16, ldmatrix.trans builds the m16n8k16 fragments: A =
//     z^T from the tap-shifted halo rows, B = g, shared by the nine taps. In
//     float32 (3xTF32 on m16n8k8) there is no transposing ldmatrix for 32-bit
//     elements: each thread loads its fragment words itself, from rows padded
//     to 72 floats, so the 32 lanes' words fall in 32 distinct banks;
//   - the block writes its (9, 64, 64) partial to partial[split], and
//     reduce_rows_kernel adds the splits in a fixed order: no float atomics,
//     two runs give the same bits.
// The wrapper picks the number of splits so that the grid is about two blocks
// per SM. Not yet done: cp.async/TMA staging that overlaps the loads with the
// products, wgmma, and sharing B fragments across the dw taps.

#include "conv3x3_common.cuh"

namespace {

using namespace conv3x3;

constexpr int CT = 64;       // input channels per block
constexpr int OT = 64;       // output channels per block
constexpr int WS = CT + 8;   // shared row stride in elements (no bank conflicts)

template <typename T>
constexpr int wgrad_smem_bytes() {
  return (HALO_PIX + TH * TW) * WS * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ pa, const float* __restrict__ pb,
                     float* __restrict__ partial, const Frame fx, const Frame fg, int N, int H,
                     int W, int C, int O, int tiles_h, int tiles_w, int tiles_per_split,
                     int xvec, int gvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = reinterpret_cast<T*>(smem);
  T* gs = hs + HALO_PIX * WS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp & 3;   // 16-channel row tile of the block's 64 input channels
  const int wn = warp >> 2;  // 32-channel half of the block's 64 output channels
  const int c0 = blockIdx.y * CT;
  const int o0 = blockIdx.z * OT;
  const int n_tiles = N * tiles_h * tiles_w;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  float acc[9][4][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][nb][r] = 0.0f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int tx = tile % tiles_w;
    const int ty = (tile / tiles_w) % tiles_h;
    const int n = tile / (tiles_w * tiles_h);
    const int h0 = ty * TH;
    const int w0 = tx * TW;
    __syncthreads();  // the previous tile's reads are done
    stage_any<T, CT, WS, TH + 2, HALO_W>(xvec, hs, x + image_offset(fx, n), fx.cols * fx.pitch,
                                         fx.pitch, H, W, C, h0 - 1, w0 - 1, c0, pa, pb);
    stage_any<T, OT, WS, TH, TW>(gvec, gs, g + image_offset(fg, n), fg.cols * fg.pitch,
                                 fg.pitch, H, W, O, h0, w0, o0, nullptr, nullptr);
    __syncthreads();

    if constexpr (is_f32<T>) {
      // m16n8k8 tf32 fragments, K = 8 pixels: thread (gq = lane/4, tq = lane%4)
      // holds A[m][k] = z[pixel k][channel m] at (gq, tq), (gq+8, tq), (gq, tq+4),
      // (gq+8, tq+4) and B[k][n] = g[pixel k][output n] at (tq, gq), (tq+4, gq).
      const uint32_t* hw = reinterpret_cast<const uint32_t*>(hs);
      const uint32_t* gw = reinterpret_cast<const uint32_t*>(gs);
      const int gq = lane >> 2;
      const int tq = lane & 3;
      for (int row = 0; row < TH; ++row) {
#pragma unroll
        for (int kk = 0; kk < TW / 8; ++kk) {  // 8 pixels of the row per MMA step
          uint32_t b_hi[4][2], b_lo[4][2];
          const int pb0 = (row * TW + kk * 8 + tq) * WS + wn * 32 + gq;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            split_tf32(gw[pb0 + nb * 8], b_hi[nb][0], b_lo[nb][0]);
            split_tf32(gw[pb0 + 4 * WS + nb * 8], b_hi[nb][1], b_lo[nb][1]);
          }
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int dh = t / 3;
            const int dw = t % 3;
            const int pa0 = ((row + dh) * HALO_W + kk * 8 + dw + tq) * WS + wm * 16 + gq;
            const uint32_t a[4] = {hw[pa0], hw[pa0 + 8], hw[pa0 + 4 * WS],
                                   hw[pa0 + 4 * WS + 8]};
            uint32_t a_hi[4], a_lo[4];
            split_tf32(a, a_hi, a_lo);
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
              mma_3xtf32(acc[t][nb], a_hi, a_lo, b_hi[nb][0], b_hi[nb][1], b_lo[nb][0],
                         b_lo[nb][1]);
          }
        }
      }
    } else {
      for (int row = 0; row < TH; ++row) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // 16 pixels of the row per MMA step
          // B[k = pixel][n = o]: stored pixel-major, transposed on load. One x4
          // covers 16 pixels by two 8-wide output tiles.
          uint32_t b[2][4];
#pragma unroll
          for (int nb2 = 0; nb2 < 2; ++nb2) {
            const int px = row * TW + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldmatrix_x4_trans(b[nb2], gs + px * WS + wn * 32 + nb2 * 16 + (lane >> 4) * 8);
          }
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const int dh = t / 3;
            const int dw = t % 3;
            // A[m = c][k = pixel] = z^T: halo rows of the tap-shifted pixels.
            uint32_t a[4];
            const int px = (row + dh) * HALO_W + kk * 16 + dw + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4_trans(a, hs + px * WS + wm * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int nb2 = 0; nb2 < 2; ++nb2) {
              mma_bf16_16816(acc[t][2 * nb2], a, b[nb2][0], b[nb2][1]);
              mma_bf16_16816(acc[t][2 * nb2 + 1], a, b[nb2][2], b[nb2][3]);
            }
          }
        }
      }
    }
  }

  // Accumulator element r of (tap, nb) is input channel c0 + wm*16 + lane/4 +
  // 8*(r/2), output channel o0 + wn*32 + nb*8 + 2*(lane%4) + r%2 (the same in
  // the m16n8k16 bf16 and m16n8k8 tf32 layouts).
  float* out = partial + static_cast<size_t>(blockIdx.x) * 9 * C * O;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = c0 + wm * 16 + (lane >> 2) + 8 * (r >> 1);
        const int o = o0 + wn * 32 + nb * 8 + 2 * (lane & 3) + (r & 1);
        if (c < C && o < O) out[(static_cast<size_t>(t) * C + c) * O + o] = acc[t][nb][r];
      }
    }
  }
}

template <typename T>
int wgrad_impl(const void* x, const void* g, const void* pa, const void* pb, void* partial,
               void* dw, const int* frames, int N, int H, int W, int C, int O, int splits,
               int x_lanes_zero, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || splits < 1 || frames == nullptr ||
      (pa == nullptr) != (pb == nullptr) || (x_lanes_zero && pa != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Frame fx{frames[0], frames[1], frames[2], frames[3], frames[4]};
  const Frame fg{frames[5], frames[6], frames[7], frames[8], frames[9]};
  if (!frame_ok(fx, H, W, C) || !frame_ok(fg, H, W, O))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long n_tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  const int c_tiles = (C + CT - 1) / CT;
  const int o_tiles = (O + OT - 1) / OT;
  if (n_tiles > 0x7fffffffLL || c_tiles > 65535 || o_tiles > 65535 ||
      static_cast<long long>(9) * C * O > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_split = static_cast<int>((n_tiles + splits - 1) / splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int smem = wgrad_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, c_tiles, o_tiles);
  conv3x3_wgrad_kernel<T><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(pa),
      static_cast<const float*>(pb), static_cast<float*>(partial), fx, fg, N, H, W, C, O,
      tiles_h, tiles_w, tiles_per_split, load_width<T>(x, C, fx.pitch, x_lanes_zero != 0),
      load_width<T>(g, O, fg.pitch, false));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_rows(static_cast<const float*>(partial),
                                      static_cast<float*>(dw), splits, 9 * C * O, s));
}

}  // namespace

// x: logical (N, H, W, C); g: logical (N, H, W, O) of x's type; frames: 10
// ints, the views {rows, cols, pitch, r0, c0} of x and g (Frame,
// conv3x3_common.cuh); x_lanes_zero: x's buffer holds zeros from channel C to
// its pitch. pa, pb: null or the (C,) f32 prologue affine; partial: (splits, 9,
// C, O) f32 scratch; dw: (9, C, O) f32, tap = 3*dh + dw. _bf16 takes bf16
// tensors, _f32 float32 ones. Returns the cudaError_t of the launches.
extern "C" int conv3x3_wgrad_bf16(const void* x, const void* g, const void* pa,
                                  const void* pb, void* partial, void* dw, const int* frames,
                                  int N, int H, int W, int C, int O, int splits,
                                  int x_lanes_zero, void* stream) {
  return wgrad_impl<__nv_bfloat16>(x, g, pa, pb, partial, dw, frames, N, H, W, C, O, splits,
                                   x_lanes_zero, stream);
}

extern "C" int conv3x3_wgrad_f32(const void* x, const void* g, const void* pa,
                                 const void* pb, void* partial, void* dw, const int* frames,
                                 int N, int H, int W, int C, int O, int splits,
                                 int x_lanes_zero, void* stream) {
  return wgrad_impl<float>(x, g, pa, pb, partial, dw, frames, N, H, W, C, O, splits,
                           x_lanes_zero, stream);
}
