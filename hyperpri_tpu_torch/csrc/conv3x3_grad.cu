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
// Once the g tile is in shared memory, g_eff = (gy + gsum) + (2y)*gsumsq is
// formed in float32 on the tile's in-image pixels (zero elsewhere: a frame
// may hold NaN, and the gsum term would make a zero pixel nonzero) and
// rounded to T, and the products read that tile: the same tile the non-fold
// mode stages from a materialized g_eff, so with the same splits dW has the
// same bits. In the blocks of C tile 0 each thread also adds the rounded
// values it forms (always the same few channels) into db sums in shared
// memory; at the end they are added per channel in a fixed order into a
// per-split partial beside dW's, reduced over the splits like dW: no float
// atomics, two runs give the same bits. All three bodies take it.
//
// Bound. 2*N*H*W*9*C*O FLOP against x and g read once and dW written (f32):
// with ~1.18 M pixels at full resolution that is 9*C*O/(C+O) FLOP per bf16
// byte again (454 at 238x64), above the ~295 FLOP/byte ridge of an H100:
// bound by operations; in float32 half of that, against TF32's ~148.
//
// Design. For each tap this is a GEMM with M = C, N = O and the pixels as the
// reduction axis K, which here is the long one. The TPU kernel keeps all of dW
// resident while a sequential grid walks the image; blocks on a GPU run in no
// order, so the reduction is split: blockIdx = (pixel split, C tile of 64, O
// tile of 64), a block walks the 8x32 pixel tiles of its split and writes its
// (9, 64, 64) partial to partial[split], and reduce_rows_kernel adds the
// splits in a fixed order: no float atomics, two runs give the same bits.
// Three kernel bodies; the wrapper picks one by dtype, mode and layout
// before the launch (ops/kernels/sm90_plan.py), never on a failure.
//
// conv3x3_wgrad_sm90_kernel<FOLD> (bf16, every view with a channel pitch that
// is a multiple of 8: every bf16 call of a training step, the ingest
// buffer's 256-channel pitch included). On the Hopper pieces of
// conv3x3_sm90.cuh:
//   - TMA loads of whole pixel tiles stay in flight: the (8+2)x(32+2) halo of
//     x and the 8x32 tile of g, 64 channels each, into a ring of 3 stages (75
//     KiB each), completed on mbarriers; the tensor maps cover the logical
//     regions of the framed views, so TMA's zero fill gives the SAME border
//     and frames (which may hold NaN) are never read. Thread 0 issues them,
//     each stage's refill as soon as every warp has released the stage;
//   - three warpgroups, one per tap row dh, each holding the accumulators of
//     its three taps for the block's 64 x 64 channels: 3 x 32 floats a
//     thread, 96 in all, where the synchronous kernel's warps held 144 and
//     one block of 8 warps filled an SM. No producer warpgroup: with 512
//     threads ptxas starts a thread at 128 registers and, even with
//     setmaxnreg handing the consumers 152, serialized the MMAs (C7512) and
//     spilled; with 384 it allocates 150, spills nothing and pipelines them;
//   - the products are wgmma m64n64k16: A = z^T, the tap-shifted halo pixels
//     of 16 output pixels, from registers by ldmatrix.trans of the swizzled
//     halo; B = the g tile from shared memory (N-major, 128-byte swizzle),
//     one descriptor for the nine taps;
//   - the prologue z = relu(pa*x + pb) is applied to each landed halo in
//     place (in-image pixels and channels below C only, by affine_relu) by
//     all 384 threads, from a shared-memory copy of the C tile's pa, pb;
//   - one block per SM (3 x 75 KiB of shared memory). A block's float32
//     accumulators chain the K steps of all its pixel tiles, and on
//     one-signed terms (a training step's cotangents) dW's rounding grows
//     with that chain, so the wrapper gives no split more than 19 pixel
//     tiles (sm90_plan.K3_MAX_CHAIN, which bounds the synchronous kernel's
//     splits too), then as many splits as fill the waves of blocks those
//     need (PERF.md §6).
//   Staged bytes per FLOP: (340 + 256) pixels of 128 bytes per
//   2*256*64*64*9 FLOP = 4.04e-3, as in the synchronous kernel; what changed
//   is that the staging of the next tiles overlaps the products.
//   Fold mode: a stage also holds y's 8x32 tile, TMA-loaded beside g's
//   through a map of y's logical region with the same swizzle, so element i
//   of one box is element i of the other. Once a stage has landed, all 384
//   threads form g_eff over the g tile in place (fold_tile_bf16, a phase of
//   its own like the prologue, outside the accumulator loop, where more
//   live registers have made ptxas serialize other bodies' wgmmas; its loop
//   is not unrolled, which cost no time and kept it at 156 registers), then
//   fence the async proxy (the tensor cores read the tile through it) and
//   meet at the consumer barrier. gsum and gsumsq of the O
//   tile sit in shared memory, zero past O, where TMA's zero fill of gy and
//   y makes g_eff zero. Three stages of x + g + y do not fit (333,872
//   bytes): two do (224,288 with gsum, gsumsq and 12 warps' db sums), and a
//   third x + g stage leaves no room for y. On an H100 the fold takes 1.26x
//   the non-fold body's device time at a training step's calls, most of it
//   the pass (PERF.md §6).
//
// conv3x3_wgrad_sm90_f32_kernel<FOLD> (float32, every view with a channel
// pitch that is a multiple of 4: every float32 call of a training step, the
// float32 ingest buffer's 256-channel pitch included). The same blocks,
// splits and warpgroups (dh) in 3xTF32 (conv3x3_sm90.cuh):
//   - the tf32 wgmma (m64n64k8) takes B from shared memory only K-major, and
//     both operands arrive channel-contiguous, so g is transposed: a quarter
//     tile of g (2 pixel rows x 32 pixels x 64 outputs, two TMA boxes) lands
//     in a raw buffer, and 256 threads turn it into g^T, pixels contiguous,
//     128-byte swizzled, split into TF32 hi and lo planes (4x4 blocks a
//     thread, conflict-free 16-byte reads and writes); thread 0 then loads
//     the next quarter's g while the warpgroups compute on this one;
//   - A = z^T from registers: each thread reads its fragment words (channel
//     rows, pixel columns) from the swizzled x halo, which TMA stages for two
//     tiles ahead (two 32-channel boxes a tile, 87 KiB; the prologue applied
//     in place in float32 by all 384 threads, in-image pixels only), and
//     splits them into hi and lo;
//   - each group of 2 K steps (16 pixels) and tap is one chain of 6 wgmmas
//     (lo*hi, hi*lo, hi*hi) into a fresh fragment, added to the tap's
//     accumulators with float32 adds rounded to nearest (K3F_GROUP = 2: a
//     group of 4 needs 32 more A registers than the 168 a thread of a
//     384-thread kernel has beside 96 accumulators and the fragment). On a
//     step's one-signed cotangents dW was within 4.7e-7 of float64 relative
//     to its absolute terms at every float32 shape of both steps, the
//     synchronous kernel within 4.2e-7 (scripts/wgrad_f64_error.py on an
//     H100, PERF.md §6); K3_MAX_CHAIN still bounds a split;
//   - one block per SM (227 KiB of shared memory: two halos, the raw quarter
//     and the two planes). Two block-wide barriers a quarter order the
//     transposition against the products.
//   Bound: operations, at the TF32 rate (three products a term: a ceiling
//   three times the bound). Staged bytes per FLOP: (2 x 340 + 2 x 256)
//   pixels of 128 bytes (x halo and g, 64 channels each) per 2*256*64*64*9
//   FLOP = 8.09e-3, as in the synchronous float32 kernel; what changed is
//   that the staging of the next tiles overlaps the products.
//   Fold mode: only 5,608 bytes are free beside the non-fold layout, less
//   than y's quarter (16 KiB), so the unit of g is one pixel row: gy's and
//   y's rows (8 KiB each) land together in a ring of two 16 KiB raw buffers,
//   the planes hold one row (half the size), and 128 transposers form g_eff
//   in float32 as they read gy and y (k3f_transpose), sum db in their
//   registers and add it into four shared-memory sums each, then split.
//   The rows are multiplied in the non-fold order, so dW keeps its bits.
//   On an H100 it takes 1.10x the non-fold body's device time at a
//   training step's calls (PERF.md §6).
//
// conv3x3_wgrad_kernel<T, FOLD> (views whose pitch TMA cannot take, e.g. C =
// 238 unframed, and `_legacy` calls): synchronous staging.
//   - for each pixel tile the block stages the (8+2)x(32+2)x64 halo of z and
//     the 8x32x64 tile of g in shared memory (zero outside the image and past
//     C or O, so the loops have no masks);
//   - each of the 8 warps owns 16 input channels by 32 output channels for all
//     nine taps (144 f32 accumulators a thread). Both operands are stored
//     pixel-major. In bf16, ldmatrix.trans builds the m16n8k16 fragments: A =
//     z^T from the tap-shifted halo rows, B = g, shared by the nine taps. In
//     float32 (3xTF32 on m16n8k8) there is no transposing ldmatrix for 32-bit
//     elements: each thread loads its fragment words itself, from rows padded
//     to 72 floats, so the 32 lanes' words fall in 32 distinct banks.

#include "conv3x3_common.cuh"
#include "conv3x3_sm90.cuh"

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
// gsum and gsumsq, all null without it (every body).
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

using sm90::HALO_BYTES;
using sm90::HALO_SLOT;
using sm90::TILE_BYTES;

constexpr int K3_CONSUMERS = 384;              // three warpgroups: tap row dh each
constexpr int K3_THREADS = K3_CONSUMERS;       // thread 0 also issues the loads
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_STAGE = HALO_SLOT + TILE_BYTES;  // one pixel tile: x halo and g tile
// Fold mode: a stage also holds the tile of y, and the block the O tile's
// gsum and gsumsq and one row of db sums per warp.
template <bool FOLD>
constexpr int K3_STAGE_BYTES = K3_STAGE + (FOLD ? TILE_BYTES : 0);
constexpr int K3_FOLD_BYTES = 2 * sm90::CHUNK * 4 + K3_WARPS * sm90::CHUNK * 4;

// Shared memory of one block: the ring of stages, the C tile's affine, in
// fold mode gsum, gsumsq and the db sums, and the ring's barriers
// (ops/kernels/sm90_plan.py mirrors this).
template <bool FOLD = false>
constexpr int k3_smem_bytes(int stages) {
  return sm90::ALIGN_SLACK + stages * K3_STAGE_BYTES<FOLD> + 2 * sm90::CHUNK * 4 +
         (FOLD ? K3_FOLD_BYTES : 0) + 2 * stages * 8;
}

// The fold mode's pass over a landed bf16 stage: g_eff = (gy + gsum) +
// (2y)*gsumsq in float32, rounded to bf16, written over the g tile at `gt`
// (y's tile at `yt`; both 8x32 pixels of 64 channels, 128-byte swizzled
// alike, so element i of one is element i of the other), zero outside the
// tile's in-image pixels: TMA's zero fill is not enough, the gsum term makes
// a zero pixel nonzero. Past O, gy and y are TMA's zeros and fold_s (gsum,
// then gsumsq, CHUNK each) holds zeros, so g_eff is zero there. The product
// is taken as y * (2 gsumsq): doubling is exact, so it is the same real
// number as (2y) * gsumsq, rounded once. Thread tid always takes the 8
// channels 8*(tid % 8).. (K3_THREADS is a multiple of 8); with db_w (this
// warp's CHUNK sums, in the blocks that add db) the rounded values are added
// per channel over the thread's pixels, then over the warp's lanes of the
// same channels by fixed shuffles, and lanes 0-7 add them into db_w: no
// atomics, a fixed order.
__device__ __forceinline__ void fold_tile_bf16(unsigned char* gt, const unsigned char* yt,
                                               int h0, int w0, int H, int W,
                                               const float* fold_s, float* db_w, int tid) {
  constexpr int VECS = TH * TW * 8;  // 16-byte vectors of a tile
  const int lc = tid & 7;            // the thread's 8-channel chunk
  float gs[8], gss2[8], db[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 s = reinterpret_cast<const float4*>(fold_s + 8 * lc)[h];
    const float4 q = reinterpret_cast<const float4*>(fold_s + sm90::CHUNK + 8 * lc)[h];
    gs[4 * h] = s.x, gs[4 * h + 1] = s.y, gs[4 * h + 2] = s.z, gs[4 * h + 3] = s.w;
    gss2[4 * h] = 2.0f * q.x, gss2[4 * h + 1] = 2.0f * q.y;
    gss2[4 * h + 2] = 2.0f * q.z, gss2[4 * h + 3] = 2.0f * q.w;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) db[e] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < (VECS + K3_THREADS - 1) / K3_THREADS; ++k) {
    const int v = tid + k * K3_THREADS;
    if (v >= VECS) break;
    const int p = v >> 3;
    const int at = p * sm90::BOX_ROW + ((lc ^ (p & 7)) << 4);
    uint4* const gq = reinterpret_cast<uint4*>(gt + at);
    if (h0 + p / TW >= H || w0 + p % TW >= W) {  // outside the image: zero
      *gq = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const uint4 gv = *gq;
    const uint4 yv = *reinterpret_cast<const uint4*>(yt + at);
    const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
    const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
    uint32_t ow[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // elements 2j (low half) and 2j + 1 (high half)
      const float g0 = __uint_as_float(gw[j] << 16), g1 = __uint_as_float(gw[j] & 0xffff0000u);
      const float y0 = __uint_as_float(yw[j] << 16), y1 = __uint_as_float(yw[j] & 0xffff0000u);
      const float e0 = __fadd_rn(__fadd_rn(g0, gs[2 * j]), __fmul_rn(y0, gss2[2 * j]));
      const float e1 = __fadd_rn(__fadd_rn(g1, gs[2 * j + 1]), __fmul_rn(y1, gss2[2 * j + 1]));
      const __nv_bfloat162 r = __floats2bfloat162_rn(e0, e1);
      ow[j] = *reinterpret_cast<const uint32_t*>(&r);
      db[2 * j] += __uint_as_float(ow[j] << 16);
      db[2 * j + 1] += __uint_as_float(ow[j] & 0xffff0000u);
    }
    *gq = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }
  if (db_w != nullptr) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      db[e] += __shfl_xor_sync(0xffffffffu, db[e], 8);
      db[e] += __shfl_xor_sync(0xffffffffu, db[e], 16);
    }
    if ((tid & 31) < 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) db_w[8 * lc + e] += db[e];
    }
  }
}

// The bf16 weight gradient on Hopper (see the note at the top). blockIdx =
// (pixel split, C tile of 64, O tile of 64); warpgroup dh holds the
// accumulators of taps (dh, 0..2): 3 x 32 floats a thread. FOLD: the fold
// mode, g_eff formed from the raw gy and y in each landed stage
// (fold_tile_bf16), and in the blocks of C tile 0 db summed beside dW.
template <bool FOLD>
__global__ void __launch_bounds__(K3_THREADS, 1)
conv3x3_wgrad_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap gmap,
                          const __grid_constant__ CUtensorMap ymap,
                          const float* __restrict__ pa, const float* __restrict__ pb,
                          const float* __restrict__ gsum, const float* __restrict__ gsumsq,
                          float* __restrict__ partial, int N, int H, int W, int C, int O,
                          int tiles_h, int tiles_w, int tiles_per_split, int stages) {
  using namespace sm90;
  constexpr int STAGE = K3_STAGE_BYTES<FOLD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  float* const pas = reinterpret_cast<float*>(smem + stages * STAGE);  // the C tile's affine
  float* const pbs = pas + CHUNK;
  float* const fold_s = pbs + CHUNK;        // fold mode: gsum, gsumsq of the O tile
  float* const db_s = fold_s + 2 * CHUNK;   // fold mode: CHUNK db sums per warp
  const uint32_t bars = base + stages * STAGE + 2 * CHUNK * 4 + (FOLD ? K3_FOLD_BYTES : 0);
  auto full = [&](int s) { return bars + 8 * s; };  // TMA landed
  auto empty = [&](int s) { return bars + 8 * (stages + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * CHUNK;
  const int o0 = blockIdx.z * CHUNK;
  const int n_tiles = N * tiles_h * tiles_w;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const bool db_block = FOLD && blockIdx.y == 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), K3_CONSUMERS / 32);  // every warp
    }
    fence_barrier_init();
  }
  load_affine(pas, pbs, pa, pb, c0, CHUNK, C, threadIdx.x, K3_THREADS);
  if constexpr (FOLD) {
    load_affine(fold_s, fold_s + CHUNK, gsum, gsumsq, o0, CHUNK, O, threadIdx.x, K3_THREADS);
    for (int i = threadIdx.x; i < K3_WARPS * CHUNK; i += K3_THREADS) db_s[i] = 0.0f;
  }
  __syncthreads();

  // Thread 0 issues the loads of pixel tile i into stage i % stages: the
  // (8+2)x(32+2) halo of x at (h0-1, w0-1) and the 8x32 tile of g (and in
  // fold mode of y), zero outside the logical images.
  auto issue = [&](int i) {
    const int t = t_begin + i;
    const int s = i % stages;
    const int tx = t % tiles_w;
    const int ty = (t / tiles_w) % tiles_h;
    const int n = t / (tiles_w * tiles_h);
    mbar_expect_tx(full(s), HALO_BYTES + (FOLD ? 2 : 1) * TILE_BYTES);
    const uint32_t stage = base + s * STAGE;
    tma_load_4d(stage, &xmap, full(s), c0, tx * TW - 1, ty * TH - 1, n);
    tma_load_4d(stage + HALO_SLOT, &gmap, full(s), o0, tx * TW, ty * TH, n);
    if constexpr (FOLD) tma_load_4d(stage + K3_STAGE, &ymap, full(s), o0, tx * TW, ty * TH, n);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < stages && t_begin + i < t_end; ++i) issue(i);

  {
    const int dh = warp >> 2;  // tap row of this warpgroup
    const int wq = warp & 3;   // 16-channel row block of the warpgroup's 64 channels
    float acc[3][32];
#pragma unroll
    for (int dw = 0; dw < 3; ++dw)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[dw][i] = 0.0f;
    uint32_t a[3][4];  // A operands of one K step (16 pixels), one per tap dw

    for (int t = t_begin; t < t_end; ++t) {
      const int i = t - t_begin;
      const int s = i % stages;
      // Refill the previous tile's stage with tile i - 1 + stages once every
      // warp has released it.
      if (threadIdx.x == 0 && i >= 1 && i - 1 + stages < t_end - t_begin) {
        mbar_wait(empty((i - 1) % stages), ((i - 1) / stages) & 1);
        issue(i - 1 + stages);
      }
      const uint32_t halo = base + s * STAGE;
      const uint32_t gt = halo + HALO_SLOT;
      mbar_wait(full(s), (i / stages) & 1);
      if (pa != nullptr || FOLD) {
        const int tx = t % tiles_w;
        const int ty = (t / tiles_w) % tiles_h;
        if (pa != nullptr)
          prologue_box(reinterpret_cast<__nv_bfloat16*>(smem + s * STAGE), HALO_PIX, HALO_W,
                       ty * TH - 1, tx * TW - 1, H, W, pas, pbs, threadIdx.x, K3_CONSUMERS);
        if constexpr (FOLD)
          fold_tile_bf16(smem + s * STAGE + HALO_SLOT, smem + s * STAGE + K3_STAGE, ty * TH,
                         tx * TW, H, W, fold_s, db_block ? db_s + warp * CHUNK : nullptr,
                         threadIdx.x);
        // the tensor cores read the halo and g_eff through the async proxy
        fence_proxy_async();
        consumer_sync<K3_CONSUMERS>();
      }
#pragma unroll 1
      for (int row = 0; row < TH; ++row) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const int p = (row + dh) * HALO_W + kk * 16 + dw + (lane & 7) + ((lane >> 4) << 3);
            ldsm_x4_trans(a[dw], swizzled(halo, p, 2 * wq + ((lane >> 3) & 1)));
          }
          wgmma_fence();
          const uint64_t desc = desc_sw128(gt + (row * TW + kk * 16) * BOX_ROW, 16, 1024);
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) wgmma_m64n64k16_rs_tb(acc[dw], a[dw], desc);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            fence_regs(acc[dw]);
            fence_regs(a[dw]);
          }
        }
      }
      if (lane == 0) mbar_arrive(empty(s));
    }

    // Accumulator element i of tap (dh, dw) is input channel c0 + 16*wq +
    // lane/4 + 8*((i%4)/2), output channel o0 + 8*(i/4) + 2*(lane%4) + i%2.
    const size_t row = static_cast<size_t>(9) * C * O + (FOLD ? O : 0);
    float* out = partial + blockIdx.x * row;
    if (db_block) {
      // channel o0 + ch: the warps' sums, added in warp order
      __syncthreads();
      const int ch = threadIdx.x;
      if (ch < CHUNK && o0 + ch < O) {
        float total = 0.0f;
        for (int k = 0; k < K3_WARPS; ++k) total += db_s[k * CHUNK + ch];
        out[static_cast<size_t>(9) * C * O + o0 + ch] = total;
      }
    }
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = c0 + 16 * wq + (lane >> 2) + 8 * ((i & 3) >> 1);
        const int o = o0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (c < C && o < O) out[(static_cast<size_t>(3 * dh + dw) * C + c) * O + o] = acc[dw][i];
      }
    }
  }
}

template <bool FOLD>
int wgrad_sm90(const void* x, const void* g, const Fold<__nv_bfloat16>& fold, const void* pa,
               const void* pb, void* partial, void* out, const int* frames, int N, int H, int W,
               int C, int O, int splits, int stages, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || splits < 1 || frames == nullptr ||
      (pa == nullptr) != (pb == nullptr) || stages < 2 ||
      k3_smem_bytes<FOLD>(stages) > sm90::SMEM_LIMIT ||
      (FOLD && (fold.y == nullptr || fold.gsum == nullptr || fold.gsumsq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Frame fx{frames[0], frames[1], frames[2], frames[3], frames[4]};
  const Frame fg{frames[5], frames[6], frames[7], frames[8], frames[9]};
  if (!frame_ok(fx, H, W, C) || !frame_ok(fg, H, W, O))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long n_tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  const int c_tiles = (C + sm90::CHUNK - 1) / sm90::CHUNK;
  const int o_tiles = (O + sm90::CHUNK - 1) / sm90::CHUNK;
  const long long cols = static_cast<long long>(9) * C * O + (FOLD ? O : 0);
  if (n_tiles > 0x7fffffffLL || c_tiles > 65535 || o_tiles > 65535 || cols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, gmap, ymap;
  if (!sm90::nhwc_map(&xmap, x, fx, N, H, W, C, HALO_W, TH + 2) ||
      !sm90::nhwc_map(&gmap, g, fg, N, H, W, O, TW, TH) ||
      !sm90::nhwc_map(&ymap, FOLD ? fold.y : g, fg, N, H, W, O, TW, TH))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_split = static_cast<int>((n_tiles + splits - 1) / splits);
  const int smem = k3_smem_bytes<FOLD>(stages);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_sm90_kernel<FOLD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv3x3_wgrad_sm90_kernel<FOLD><<<dim3(splits, c_tiles, o_tiles), K3_THREADS, smem, s>>>(
      xmap, gmap, ymap, static_cast<const float*>(pa), static_cast<const float*>(pb),
      fold.gsum, fold.gsumsq, static_cast<float*>(partial), N, H, W, C, O, tiles_h, tiles_w,
      tiles_per_split, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_rows(static_cast<const float*>(partial),
                                      static_cast<float*>(out), splits, static_cast<int>(cols),
                                      s));
}

// ---------------------------------------------------------------------------
// The float32 Hopper body (see the note at the top).

using sm90::F32_CHUNK;
using sm90::BOX_ROW;

constexpr int K3F_HSTAGE = 2 * HALO_SLOT;           // a tile's x halo: two 32-channel boxes
constexpr int K3F_HSTAGES = 2;
constexpr int K3F_KBLOCK = 64 * BOX_ROW;            // 64 output rows x 32 pixels (one plane)
// K steps (8 pixels each) chained through the tensor cores into one fresh
// fragment before it is added to the accumulators.
constexpr int K3F_GROUP = 2;
static_assert(4 % K3F_GROUP == 0, "a 32-pixel row splits into whole groups");

// The unit of g that is staged, transposed and multiplied at a time: a
// quarter tile (2 pixel rows) in a 16 KiB raw buffer; in fold mode one
// pixel row of gy and of y, together 16 KiB, in a ring of two such buffers
// (a quarter of both does not fit beside the halos), with its planes half
// as large. Either way a unit's rows are multiplied in the same order, so
// the fold mode's dW has the non-fold mode's bits on the materialized g_eff.
template <bool FOLD>
struct K3F {
  static constexpr int QROWS = FOLD ? 1 : 2;            // pixel rows of a unit
  static constexpr int UNITS = TH / QROWS;              // units of a tile
  static constexpr int RAW_BOX = QROWS * TW * BOX_ROW;  // 32 outputs x the unit's pixels
  static constexpr int RAW = (FOLD ? 4 : 2) * RAW_BOX;  // g's two boxes (and y's)
  static constexpr int RAW_STAGES = FOLD ? 2 : 1;
  static constexpr int PLANE = QROWS * K3F_KBLOCK;      // the unit's g^T, one plane
  static constexpr int TRANSPOSERS = QROWS * 128;       // 4x4 blocks of the unit
  // fold mode: gsum, gsumsq of the O tile and 4 db sums per transposer
  static constexpr int FOLD_BYTES = FOLD ? 2 * 64 * 4 + TRANSPOSERS * 4 * 4 : 0;
};

// Shared memory of one block: the halo ring, the raw ring of g units, the
// unit's g^T hi and lo planes, the C tile's affine, in fold mode gsum,
// gsumsq and the db sums, and the barriers (ops/kernels/sm90_plan.py
// mirrors this).
template <bool FOLD = false>
constexpr int k3f_smem_bytes() {
  using L = K3F<FOLD>;
  return sm90::ALIGN_SLACK + K3F_HSTAGES * K3F_HSTAGE + L::RAW_STAGES * L::RAW + 2 * L::PLANE +
         2 * 2 * F32_CHUNK * 4 + L::FOLD_BYTES + (K3F_HSTAGES + L::RAW_STAGES) * 8;
}

// The transpose-and-split stage: the raw g unit (two TMA boxes, pixel rows
// of 32 outputs, 128-byte swizzled) -> g^T, K-major (a row of 32 pixels per
// output, 128-byte swizzled, one 8 KiB block per pixel row), in TF32 hi and
// lo planes. Thread tid < TRANSPOSERS moves one 4x4 block: outputs 4*ob..,
// pixels 4*pb..; the mapping makes both its 16-byte reads and its 16-byte
// writes conflict-free within each quarter warp.
// Fold mode: the unit is one pixel row, image row h from column w0, and y's
// boxes follow g's. Each value read is g_eff = (gy + gsum) + (2y)*gsumsq in
// float32 (fold_s: gsum, then gsumsq, 64 each, zero past O, where gy and y
// are TMA's zeros), zero at pixels outside the image; with db_slot (the
// thread's 4 sums, in the blocks that add db) the values are added into it
// per output. A thread's outputs never change.
template <bool FOLD>
__device__ __forceinline__ void k3f_transpose(const unsigned char* raw, unsigned char* phi,
                                              unsigned char* plo, int tid, int h, int w0, int H,
                                              int W, const float* fold_s, float* db_slot) {
  constexpr int RAW_BOX = K3F<FOLD>::RAW_BOX;
  const int l8 = tid & 7;
  const int ob = (l8 ^ ((tid >> 3) & 7)) | (((tid >> 6) & 1) << 3);
  const int pb = l8 | (((tid >> 7) & 1) << 3);
  float v[4][4];  // v[pixel][output] of the block
  float4 db = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * pb + i;
    const int at = (ob >> 3) * RAW_BOX + p * BOX_ROW + (((ob & 7) ^ (p & 7)) << 4);
    float4 t = *reinterpret_cast<const float4*>(raw + at);
    if constexpr (FOLD) {
      const float4 y = *reinterpret_cast<const float4*>(raw + 2 * RAW_BOX + at);
      const float4 gs = *reinterpret_cast<const float4*>(fold_s + 4 * ob);
      const float4 gss = *reinterpret_cast<const float4*>(fold_s + 64 + 4 * ob);
      const bool inside = h < H && w0 + p < W;
      auto fold = [&](float gy, float yy, float s, float ss) {
        return inside ? __fadd_rn(__fadd_rn(gy, s), __fmul_rn(2.0f * yy, ss)) : 0.0f;
      };
      t = make_float4(fold(t.x, y.x, gs.x, gss.x), fold(t.y, y.y, gs.y, gss.y),
                      fold(t.z, y.z, gs.z, gss.z), fold(t.w, y.w, gs.w, gss.w));
      db = make_float4(db.x + t.x, db.y + t.y, db.z + t.z, db.w + t.w);
    }
    v[i][0] = t.x;
    v[i][1] = t.y;
    v[i][2] = t.z;
    v[i][3] = t.w;
  }
  if (FOLD && db_slot != nullptr) {
    float4* const d = reinterpret_cast<float4*>(db_slot);
    const float4 s = *d;
    *d = make_float4(s.x + db.x, s.y + db.y, s.z + db.z, s.w + db.w);
  }
  const int kb = pb >> 3;
  const int pc = pb & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = 4 * ob + j;
    const uint32_t col[4] = {__float_as_uint(v[0][j]), __float_as_uint(v[1][j]),
                             __float_as_uint(v[2][j]), __float_as_uint(v[3][j])};
    uint32_t hi[4], lo[4];
    split_tf32(col, hi, lo);
    const int at = kb * K3F_KBLOCK + o * BOX_ROW + ((pc ^ (o & 7)) << 4);
    *reinterpret_cast<uint4*>(phi + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(plo + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The float32 weight gradient on Hopper (see the note at the top). blockIdx
// = (pixel split, C tile of 64, O tile of 64); warpgroup dh holds the
// accumulators of taps (dh, 0..2): 3 x 32 floats a thread. FOLD: the fold
// mode, g_eff formed from the raw gy and y as the transposers read them
// (k3f_transpose), and in the blocks of C tile 0 db summed beside dW.
template <bool FOLD>
__global__ void __launch_bounds__(K3_THREADS, 1)
conv3x3_wgrad_sm90_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap gmap,
                              const __grid_constant__ CUtensorMap ymap,
                              const float* __restrict__ pa, const float* __restrict__ pb,
                              const float* __restrict__ gsum, const float* __restrict__ gsumsq,
                              float* __restrict__ partial, int N, int H, int W, int C, int O,
                              int tiles_h, int tiles_w, int tiles_per_split) {
  using namespace sm90;
  using L = K3F<FOLD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw_base);
  constexpr int RAW_OFF = K3F_HSTAGES * K3F_HSTAGE;
  constexpr int HI_OFF = RAW_OFF + L::RAW_STAGES * L::RAW;
  constexpr int LO_OFF = HI_OFF + L::PLANE;
  float* const pas = reinterpret_cast<float*>(smem + LO_OFF + L::PLANE);  // the C tile's affine
  float* const pbs = pas + 2 * F32_CHUNK;
  float* const fold_s = pbs + 2 * F32_CHUNK;  // fold mode: gsum, gsumsq of the O tile
  float* const db_s = fold_s + 2 * 64;        // fold mode: 4 db sums per transposer
  const uint32_t bars = base + LO_OFF + L::PLANE + 2 * 2 * F32_CHUNK * 4 + L::FOLD_BYTES;
  auto halo_full = [&](int hs) { return bars + 8 * hs; };
  auto raw_full = [&](int r) { return bars + 8 * (K3F_HSTAGES + r); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * 2 * F32_CHUNK;
  const int o0 = blockIdx.z * 2 * F32_CHUNK;
  const int n_tiles = N * tiles_h * tiles_w;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int n_mine = min(n_tiles, t_begin + tiles_per_split) - t_begin;
  const bool db_block = FOLD && blockIdx.y == 0;

  if (threadIdx.x == 0) {
    for (int k = 0; k < K3F_HSTAGES + L::RAW_STAGES; ++k) mbar_init(bars + 8 * k, 1);
    fence_barrier_init();
  }
  load_affine(pas, pbs, pa, pb, c0, 2 * F32_CHUNK, C, threadIdx.x, K3_THREADS);
  if constexpr (FOLD) {
    load_affine(fold_s, fold_s + 64, gsum, gsumsq, o0, 64, O, threadIdx.x, K3_THREADS);
    for (int k = threadIdx.x; k < 4 * L::TRANSPOSERS; k += K3_THREADS) db_s[k] = 0.0f;
  }
  __syncthreads();

  // Thread 0 issues the loads: tile i's (8+2)x(32+2) x halo into halo stage
  // i % 2 (two boxes of 32 channels), and unit u's QROWSx32-pixel g tile (two
  // boxes of 32 outputs; in fold mode y's two boxes after them) into raw
  // stage u % RAW_STAGES; zero outside the logical images.
  auto coords = [&](int i, int& n, int& ty, int& tx) {
    const int t = t_begin + i;
    tx = t % tiles_w;
    ty = (t / tiles_w) % tiles_h;
    n = t / (tiles_w * tiles_h);
  };
  auto issue_halo = [&](int i) {
    int n, ty, tx;
    coords(i, n, ty, tx);
    const int hs = i % K3F_HSTAGES;
    mbar_expect_tx(halo_full(hs), 2 * HALO_BYTES);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      tma_load_4d(base + hs * K3F_HSTAGE + b * HALO_SLOT, &xmap, halo_full(hs),
                  c0 + b * F32_CHUNK, tx * TW - 1, ty * TH - 1, n);
  };
  auto issue_raw = [&](int u) {
    int n, ty, tx;
    coords(u / L::UNITS, n, ty, tx);
    const int r = u % L::RAW_STAGES;
    const uint32_t dst = base + RAW_OFF + r * L::RAW;
    const int row = ty * TH + (u % L::UNITS) * L::QROWS;
    mbar_expect_tx(raw_full(r), L::RAW);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      tma_load_4d(dst + b * L::RAW_BOX, &gmap, raw_full(r), o0 + b * F32_CHUNK, tx * TW, row, n);
      if constexpr (FOLD)
        tma_load_4d(dst + (2 + b) * L::RAW_BOX, &ymap, raw_full(r), o0 + b * F32_CHUNK, tx * TW,
                    row, n);
    }
  };
  const int n_units = n_mine * L::UNITS;
  if (threadIdx.x == 0 && n_mine > 0) {
    for (int i = 0; i < K3F_HSTAGES && i < n_mine; ++i) issue_halo(i);
    for (int u = 0; u < L::RAW_STAGES && u < n_units; ++u) issue_raw(u);
  }

  const int dh = warp >> 2;  // tap row of this warpgroup
  const int wq = warp & 3;   // 16-channel row block of the C tile
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // A[m = channel][k = pixel] = z^T: thread (g, t4) of warp wq holds channels
  // 16wq + g (+8) at pixels t4 (+4) of a K step; both channels lie in box
  // wq / 2 at channel cc (+8) of its 32.
  const int cc = 16 * (wq & 1) + g;
  float acc[3][32];
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[dw][i] = 0.0f;
  float frag[32];
  uint32_t a_hi[K3F_GROUP][4], a_lo[K3F_GROUP][4];

  for (int i = 0; i < n_mine; ++i) {
    const int hs = i % K3F_HSTAGES;
    const unsigned char* const halo = smem + hs * K3F_HSTAGE + (wq >> 1) * HALO_SLOT;
    int n, ty, tx;
    coords(i, n, ty, tx);
    mbar_wait(halo_full(hs), (i / K3F_HSTAGES) & 1);
    if (pa != nullptr) {
#pragma unroll
      for (int b = 0; b < 2; ++b)
        prologue_box_f32(reinterpret_cast<float*>(smem + hs * K3F_HSTAGE + b * HALO_SLOT),
                         HALO_PIX, HALO_W, ty * TH - 1, tx * TW - 1, H, W, pas + b * F32_CHUNK,
                         pbs + b * F32_CHUNK, threadIdx.x, K3_THREADS);
      fence_proxy_async();  // before TMA writes this stage again
    }
#pragma unroll 1
    for (int q = 0; q < L::UNITS; ++q) {
      const int u = i * L::UNITS + q;
      const int r = u % L::RAW_STAGES;
      mbar_wait(raw_full(r), (u / L::RAW_STAGES) & 1);
      if (threadIdx.x < L::TRANSPOSERS)
        k3f_transpose<FOLD>(smem + RAW_OFF + r * L::RAW, smem + HI_OFF, smem + LO_OFF,
                            threadIdx.x, ty * TH + q * L::QROWS, tx * TW, H, W, fold_s,
                            db_block ? db_s + 4 * threadIdx.x : nullptr);
      fence_proxy_async();  // the planes, before the tensor cores read them
      __syncthreads();      // planes written, raw read, the prologue done
      if (threadIdx.x == 0 && u + L::RAW_STAGES < n_units) issue_raw(u + L::RAW_STAGES);
#pragma unroll 1
      for (int r2 = 0; r2 < L::QROWS; ++r2) {
        const int hrow = (q * L::QROWS + r2 + dh) * HALO_W;
#pragma unroll
        for (int grp = 0; grp < 4 / K3F_GROUP; ++grp) {
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
            for (int j = 0; j < K3F_GROUP; ++j) {
              const int p0 = hrow + (grp * K3F_GROUP + j) * 8 + t4 + dw;
              uint32_t a[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int p = p0 + (e >> 1) * 4;
                const int c = cc + (e & 1) * 8;
                a[e] = *reinterpret_cast<const uint32_t*>(
                    halo + p * BOX_ROW + (((c >> 2) ^ (p & 7)) << 4) + (c & 3) * 4);
              }
              split_tf32(a, a_hi[j], a_lo[j]);
            }
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < K3F_GROUP; ++j) {
              const uint32_t k_off = r2 * K3F_KBLOCK + (grp * K3F_GROUP + j) * 32;
              wgmma_3xtf32_step(frag, a_hi[j], a_lo[j], desc_sw128(base + HI_OFF + k_off, 16, 1024),
                                desc_sw128(base + LO_OFF + k_off, 16, 1024), j == 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(frag);
#pragma unroll
            for (int j = 0; j < K3F_GROUP; ++j) {
              fence_regs(a_hi[j]);
              fence_regs(a_lo[j]);
            }
            add_fragment(acc[dw], frag);
          }
        }
      }
      __syncthreads();  // every warpgroup is done with the planes (and, after
                        // the last unit, with the halo stage)
    }
    if (threadIdx.x == 0 && i + K3F_HSTAGES < n_mine) issue_halo(i + K3F_HSTAGES);
  }

  // Accumulator element i of tap (dh, dw) is input channel c0 + 16*wq +
  // lane/4 + 8*((i%4)/2), output channel o0 + 8*(i/4) + 2*(lane%4) + i%2.
  const size_t row = static_cast<size_t>(9) * C * O + (FOLD ? O : 0);
  float* out = partial + blockIdx.x * row;
  if (db_block) {
    // output o0 + ch (ob = ch / 4, element ch % 4): the sums of the eight
    // transposers of ob, one per pixel block, added in pixel order
    __syncthreads();
    const int ch = threadIdx.x;
    if (ch < 64 && o0 + ch < O) {
      const int ob = ch >> 2;
      float total = 0.0f;
      for (int a8 = 0; a8 < 8; ++a8) {
        const int tid = ((ob & 7) ^ a8) | (a8 << 3) | ((ob >> 3) << 6);
        total += db_s[4 * tid + (ch & 3)];
      }
      out[static_cast<size_t>(9) * C * O + o0 + ch] = total;
    }
  }
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = c0 + 16 * wq + g + 8 * ((i & 3) >> 1);
      const int o = o0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      if (c < C && o < O) out[(static_cast<size_t>(3 * dh + dw) * C + c) * O + o] = acc[dw][i];
    }
  }
}

template <bool FOLD>
int wgrad_sm90_f32(const void* x, const void* g, const Fold<float>& fold, const void* pa,
                   const void* pb, void* partial, void* out, const int* frames, int N, int H,
                   int W, int C, int O, int splits, int stages, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || splits < 1 || frames == nullptr ||
      (pa == nullptr) != (pb == nullptr) || stages != K3F_HSTAGES ||
      k3f_smem_bytes<FOLD>() > sm90::SMEM_LIMIT ||
      (FOLD && (fold.y == nullptr || fold.gsum == nullptr || fold.gsumsq == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Frame fx{frames[0], frames[1], frames[2], frames[3], frames[4]};
  const Frame fg{frames[5], frames[6], frames[7], frames[8], frames[9]};
  if (!frame_ok(fx, H, W, C) || !frame_ok(fg, H, W, O))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long n_tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  const int c_tiles = (C + 2 * F32_CHUNK - 1) / (2 * F32_CHUNK);
  const int o_tiles = (O + 2 * F32_CHUNK - 1) / (2 * F32_CHUNK);
  const long long cols = static_cast<long long>(9) * C * O + (FOLD ? O : 0);
  if (n_tiles > 0x7fffffffLL || c_tiles > 65535 || o_tiles > 65535 || cols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int QROWS = K3F<FOLD>::QROWS;
  CUtensorMap xmap, gmap, ymap;
  if (!sm90::nhwc_map_f32(&xmap, x, fx, N, H, W, C, HALO_W, TH + 2) ||
      !sm90::nhwc_map_f32(&gmap, g, fg, N, H, W, O, TW, QROWS) ||
      !sm90::nhwc_map_f32(&ymap, FOLD ? fold.y : g, fg, N, H, W, O, TW, QROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_split = static_cast<int>((n_tiles + splits - 1) / splits);
  const int smem = k3f_smem_bytes<FOLD>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_sm90_f32_kernel<FOLD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv3x3_wgrad_sm90_f32_kernel<FOLD><<<dim3(splits, c_tiles, o_tiles), K3_THREADS, smem, s>>>(
      xmap, gmap, ymap, static_cast<const float*>(pa), static_cast<const float*>(pb),
      fold.gsum, fold.gsumsq, static_cast<float*>(partial), N, H, W, C, O, tiles_h, tiles_w,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_rows(static_cast<const float*>(partial),
                                      static_cast<float*>(out), splits, static_cast<int>(cols),
                                      s));
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

// The Hopper kernel (bf16, no fold mode): x, g, pa, pb, frames, out as above,
// every view with a channel pitch that is a multiple of 8 and a 16-byte
// aligned logical origin (TMA's stride and address rules); partial: (splits,
// 9*C*O) f32; stages: depth of the ring of pixel tiles (2 or 3).
extern "C" int conv3x3_wgrad_sm90_bf16(const void* x, const void* g, const void* pa,
                                       const void* pb, void* partial, void* out,
                                       const int* frames, int N, int H, int W, int C, int O,
                                       int splits, int stages, void* stream) {
  return wgrad_sm90<false>(x, g, Fold<__nv_bfloat16>{}, pa, pb, partial, out, frames, N, H, W, C,
                           O, splits, stages, stream);
}

// The Hopper kernel (float32, no fold mode): as conv3x3_wgrad_sm90_bf16, every
// view with a channel pitch that is a multiple of 4; stages: the depth of the
// ring of x halos (2).
extern "C" int conv3x3_wgrad_sm90_f32(const void* x, const void* g, const void* pa,
                                      const void* pb, void* partial, void* out, const int* frames,
                                      int N, int H, int W, int C, int O, int splits, int stages,
                                      void* stream) {
  return wgrad_sm90_f32<false>(x, g, Fold<float>{}, pa, pb, partial, out, frames, N, H, W, C, O,
                               splits, stages, stream);
}

// The Hopper kernels in fold mode: the arguments of conv3x3_wgrad_bf16 /
// conv3x3_wgrad_f32 (y, gsum and gsumsq not null; y framed like g and 16-byte
// aligned), the views as for conv3x3_wgrad_sm90_bf16 / _f32; partial:
// (splits, 9*C*O + O) f32; out: dW then db; stages: the depth of the ring of
// pixel tiles (bf16: 2, k3_smem_bytes<true>) or of x halos (float32: 2).
extern "C" int conv3x3_wgrad_sm90_fold_bf16(const void* x, const void* g, const void* y,
                                            const void* gsum, const void* gsumsq, const void* pa,
                                            const void* pb, void* partial, void* out,
                                            const int* frames, int N, int H, int W, int C, int O,
                                            int splits, int stages, void* stream) {
  using T = __nv_bfloat16;
  const Fold<T> fold{static_cast<const T*>(y), static_cast<const float*>(gsum),
                     static_cast<const float*>(gsumsq)};
  return wgrad_sm90<true>(x, g, fold, pa, pb, partial, out, frames, N, H, W, C, O, splits, stages,
                          stream);
}

extern "C" int conv3x3_wgrad_sm90_fold_f32(const void* x, const void* g, const void* y,
                                           const void* gsum, const void* gsumsq, const void* pa,
                                           const void* pb, void* partial, void* out,
                                           const int* frames, int N, int H, int W, int C, int O,
                                           int splits, int stages, void* stream) {
  const Fold<float> fold{static_cast<const float*>(y), static_cast<const float*>(gsum),
                         static_cast<const float*>(gsumsq)};
  return wgrad_sm90_f32<true>(x, g, fold, pa, pb, partial, out, frames, N, H, W, C, O, splits,
                              stages, stream);
}
