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
// Fold mode (the JAX kernel's y/gsum/gsumsq, conv3x3_grad.py:101-118): g is the
// raw cotangent gy of a statistics conv and y its saved output, framed alike.
// While the g tile is staged, both are masked to zero outside the logical
// image (a frame may hold NaN), then g_eff = (gy + gsum) + (2y)*gsumsq is
// formed in float32 and rounded to T, and the products read that tile. In
// the blocks of C tile 0 each thread also adds the rounded values it stages
// (always the same few channels) into its own db sums in shared memory; at
// the end they are added per channel in a fixed thread order into a
// per-split partial beside dW's, reduced over the splits like dW: no float
// atomics, two runs give the same bits. Its cost against the plain mode is
// the second load and the arithmetic of the synchronous g stage (PERF.md).
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

// The staged x halo and g tile; in fold mode also the block's gsum and gsumsq
// (2 x OT floats) and one slot of per-channel db sums per thread.
template <typename T, bool FOLD>
constexpr int wgrad_smem_bytes() {
  return (HALO_PIX + TH * TW) * WS * static_cast<int>(sizeof(T)) +
         (FOLD ? (2 * OT + THREADS * Elem<T>::VEC_MAX) * 4 : 0);
}

// The raw bits of one element of T, for the 16-byte loads of the fold mode.
template <typename T>
using Bits = typename std::conditional<is_f32<T>, uint32_t, uint16_t>::type;

template <typename T>
__device__ __forceinline__ float bits_to_f32(Bits<T> b) {
  if constexpr (is_f32<T>) return __uint_as_float(b);
  else return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

template <typename T>
__device__ __forceinline__ Bits<T> f32_to_bits(float v) {
  if constexpr (is_f32<T>) return __float_as_uint(v);
  else return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Fold mode's g stage: the (TH, TW, OT) tile of g_eff = (gy + gsum) + (2y)*gsumsq
// at logical (h0, w0, o0) into dst[pixel][WS], computed in float32 from the
// raw gy and y (one framed view: rows row_pitch apart, pixels pitch apart)
// and rounded to T; zero outside the image and past O, where nothing is
// read, so NaN in a frame never reaches the sum. fold_s holds the block's
// gsum and gsumsq (OT each, zero past O). A thread always stages the same VEC
// channels (THREADS is a multiple of OT / VEC), so it keeps their gsum and
// gsumsq in registers for the tile and, when db_slot is not null, adds the
// rounded values it stages into its VEC db sums there. VEC elements per load
// (see load_width); four loads of each operand in flight per thread.
template <typename T, int VEC>
__device__ __forceinline__ void stage_fold(T* __restrict__ dst, const T* __restrict__ gy,
                                           const T* __restrict__ y, int row_pitch, int pitch,
                                           int H, int W, int O, int h0, int w0, int o0,
                                           const float* __restrict__ fold_s,
                                           float* __restrict__ db_slot) {
  using P = typename Packed<VEC * static_cast<int>(sizeof(T))>::type;
  union U {
    P p;
    Bits<T> e[VEC];
  };
  constexpr int GROUPS = OT / VEC;
  static_assert(THREADS % GROUPS == 0, "a thread's channels must not change between loads");
  constexpr int ITERS = TH * TW * GROUPS / THREADS;
  constexpr int BATCH = ITERS < 4 ? ITERS : 4;
  const int grp = threadIdx.x % GROUPS;
  const int c = o0 + grp * VEC;
  float gsv[VEC], gssv[VEC], dbt[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    gsv[e] = fold_s[grp * VEC + e];
    gssv[e] = fold_s[OT + grp * VEC + e];
    dbt[e] = 0.0f;
  }
  const P* __restrict__ gin = reinterpret_cast<const P*>(gy);
  const P* __restrict__ yin = reinterpret_cast<const P*>(y);
#pragma unroll 1
  for (int it0 = 0; it0 < ITERS; it0 += BATCH) {
    U gv[BATCH], yv[BATCH];
    bool inside[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int px = ((it0 + k) * THREADS + threadIdx.x) / GROUPS;
      const int hh = h0 + px / TW;
      const int ww = w0 + px % TW;
      inside[k] = hh < H && ww < W && c < O;
      gv[k].p = P();
      yv[k].p = P();
      if (inside[k]) {
        const int at = (hh * row_pitch + ww * pitch + c) / VEC;
        gv[k].p = gin[at];
        yv[k].p = yin[at];
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int px = ((it0 + k) * THREADS + threadIdx.x) / GROUPS;
      U out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = 0.0f;
        if (inside[k] && c + e < O) {
          const float yy = 2.0f * bits_to_f32<T>(yv[k].e[e]);
          v = __fadd_rn(__fadd_rn(bits_to_f32<T>(gv[k].e[e]), gsv[e]), __fmul_rn(yy, gssv[e]));
        }
        out.e[e] = f32_to_bits<T>(v);
        dbt[e] += bits_to_f32<T>(out.e[e]);
      }
      *reinterpret_cast<P*>(dst + px * WS + grp * VEC) = out.p;
    }
  }
  if (db_slot != nullptr) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) db_slot[e] += dbt[e];
  }
}

// One launch's operands beyond x and g: the fold mode's y (framed like g),
// gsum and gsumsq, all null without it.
template <typename T>
struct Fold {
  const T* y;
  const float* gsum;
  const float* gsumsq;
};

template <typename T, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ pa, const float* __restrict__ pb,
                     const T* __restrict__ y, const float* __restrict__ gsum,
                     const float* __restrict__ gsumsq, float* __restrict__ partial,
                     const Frame fx, const Frame fg, int N, int H, int W, int C, int O,
                     int tiles_h, int tiles_w, int tiles_per_split, int xvec, int gvec) {
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
  // Fold mode: the block's gsum and gsumsq, and in the blocks of C tile 0
  // (which add db) each thread's slot of db sums, zeroed; the tile loop's
  // first barrier orders this before any use.
  const bool db_block = FOLD && blockIdx.y == 0;
  float* fold_s = reinterpret_cast<float*>(gs + TH * TW * WS);
  float* db_s = fold_s + 2 * OT;
  if constexpr (FOLD) {
    for (int i = threadIdx.x; i < 2 * OT; i += THREADS) {
      const int o = o0 + i % OT;
      fold_s[i] = o < O ? __ldg((i < OT ? gsum : gsumsq) + o) : 0.0f;
    }
    for (int i = threadIdx.x; i < THREADS * Elem<T>::VEC_MAX; i += THREADS) db_s[i] = 0.0f;
  }

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
    if constexpr (FOLD) {
      constexpr int V = Elem<T>::VEC_MAX;
      const size_t at = image_offset(fg, n);
      const int rp = fg.cols * fg.pitch;
      float* slot = db_block ? db_s + threadIdx.x * gvec : nullptr;
      if (gvec == V)
        stage_fold<T, V>(gs, g + at, y + at, rp, fg.pitch, H, W, O, h0, w0, o0, fold_s, slot);
      else if (gvec == 2)
        stage_fold<T, 2>(gs, g + at, y + at, rp, fg.pitch, H, W, O, h0, w0, o0, fold_s, slot);
      else
        stage_fold<T, 1>(gs, g + at, y + at, rp, fg.pitch, H, W, O, h0, w0, o0, fold_s, slot);
    } else {
      stage_any<T, OT, WS, TH, TW>(gvec, gs, g + image_offset(fg, n), fg.cols * fg.pitch,
                                   fg.pitch, H, W, O, h0, w0, o0, nullptr, nullptr);
    }
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
  const size_t row = static_cast<size_t>(9) * C * O + (FOLD ? O : 0);
  float* out = partial + blockIdx.x * row;
  if (db_block) {
    // Channel ch's sums sit in the slots of the threads that staged it,
    // threads grp, grp + OT/gvec, ... with grp = ch / gvec: added in order.
    __syncthreads();
    const int ch = threadIdx.x;
    if (ch < OT && o0 + ch < O) {
      const int groups = OT / gvec;
      float total = 0.0f;
      for (int k = ch / gvec; k < THREADS; k += groups) total += db_s[k * gvec + ch % gvec];
      out[static_cast<size_t>(9) * C * O + o0 + ch] = total;
    }
  }
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
int wgrad_impl(const void* x, const void* g, const void* pa, const void* pb, const Fold<T>& fold,
               void* partial, void* out, const int* frames, int N, int H, int W, int C, int O,
               int splits, int x_lanes_zero, void* stream) {
  const bool folded = fold.y != nullptr;
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || splits < 1 || frames == nullptr ||
      (pa == nullptr) != (pb == nullptr) || (x_lanes_zero && pa != nullptr) ||
      folded != (fold.gsum != nullptr) || folded != (fold.gsumsq != nullptr))
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
  const long long cols = static_cast<long long>(9) * C * O + (folded ? O : 0);
  if (n_tiles > 0x7fffffffLL || c_tiles > 65535 || o_tiles > 65535 || cols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_split = static_cast<int>((n_tiles + splits - 1) / splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = folded ? conv3x3_wgrad_kernel<T, true> : conv3x3_wgrad_kernel<T, false>;
  const int smem = folded ? wgrad_smem_bytes<T, true>() : wgrad_smem_bytes<T, false>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int gvec = load_width<T>(g, O, fg.pitch, false);
  if (folded) {
    const int yvec = load_width<T>(fold.y, O, fg.pitch, false);
    gvec = yvec < gvec ? yvec : gvec;
  }
  const dim3 grid(splits, c_tiles, o_tiles);
  kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(pa),
      static_cast<const float*>(pb), fold.y, fold.gsum, fold.gsumsq,
      static_cast<float*>(partial), fx, fg, N, H, W, C, O, tiles_h, tiles_w, tiles_per_split,
      load_width<T>(x, C, fx.pitch, x_lanes_zero != 0), gvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_rows(static_cast<const float*>(partial),
                                      static_cast<float*>(out), splits, static_cast<int>(cols),
                                      s));
}

}  // namespace

// x: logical (N, H, W, C); g: logical (N, H, W, O) of x's type; frames: 10
// ints, the views {rows, cols, pitch, r0, c0} of x and g (Frame,
// conv3x3_common.cuh); x_lanes_zero: x's buffer holds zeros from channel C to
// its pitch. pa, pb: null or the (C,) f32 prologue affine. Fold mode: y, the
// statistics conv's output framed like g, and gsum, gsumsq, (O,) f32; all
// three null without it. partial: (splits, cols) f32 scratch; out: (cols,) f32,
// dW (9, C, O) with tap = 3*dh + dw, then in fold mode db (O,): cols = 9*C*O,
// plus O in fold mode. _bf16 takes bf16 tensors, _f32 float32 ones. Returns
// the cudaError_t of the launches.
extern "C" int conv3x3_wgrad_bf16(const void* x, const void* g, const void* y,
                                  const void* gsum, const void* gsumsq, const void* pa,
                                  const void* pb, void* partial, void* out, const int* frames,
                                  int N, int H, int W, int C, int O, int splits,
                                  int x_lanes_zero, void* stream) {
  using T = __nv_bfloat16;
  const Fold<T> fold{static_cast<const T*>(y), static_cast<const float*>(gsum),
                     static_cast<const float*>(gsumsq)};
  return wgrad_impl<T>(x, g, pa, pb, fold, partial, out, frames, N, H, W, C, O, splits,
                       x_lanes_zero, stream);
}

extern "C" int conv3x3_wgrad_f32(const void* x, const void* g, const void* y,
                                 const void* gsum, const void* gsumsq, const void* pa,
                                 const void* pb, void* partial, void* out, const int* frames,
                                 int N, int H, int W, int C, int O, int splits,
                                 int x_lanes_zero, void* stream) {
  const Fold<float> fold{static_cast<const float*>(y), static_cast<const float*>(gsum),
                         static_cast<const float*>(gsumsq)};
  return wgrad_impl<float>(x, g, pa, pb, fold, partial, out, frames, N, H, W, C, O, splits,
                           x_lanes_zero, stream);
}
