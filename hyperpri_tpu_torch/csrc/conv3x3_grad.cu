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
// order, so the reduction is split: blockIdx = (pixel split, C tile of 64, O
// tile of 64), a block walks the 8x32 pixel tiles of its split and writes its
// (9, 64, 64) partial to partial[split], and reduce_rows_kernel adds the
// splits in a fixed order: no float atomics, two runs give the same bits.
// Three kernel bodies; the wrapper picks one by dtype, mode and layout
// before the launch (ops/kernels/sm90_plan.py), never on a failure.
//
// conv3x3_wgrad_sm90_kernel (bf16 without the fold mode, every view with a
// channel pitch that is a multiple of 8: every bf16 call of a training step,
// the ingest buffer's 256-channel pitch included). On the Hopper pieces of
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
//
// conv3x3_wgrad_sm90_f32_kernel (float32 without the fold mode, every view
// with a channel pitch that is a multiple of 4: every float32 call of a
// training step, the float32 ingest buffer's 256-channel pitch included). The
// same blocks, splits and warpgroups (dh) in 3xTF32 (conv3x3_sm90.cuh):
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
//
// conv3x3_wgrad_kernel<T, FOLD> (the fold mode, and views whose pitch TMA
// cannot take, e.g. C = 238 unframed): synchronous staging.
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

using sm90::HALO_BYTES;
using sm90::HALO_SLOT;
using sm90::TILE_BYTES;

constexpr int K3_CONSUMERS = 384;              // three warpgroups: tap row dh each
constexpr int K3_THREADS = K3_CONSUMERS;       // thread 0 also issues the loads
constexpr int K3_STAGE = HALO_SLOT + TILE_BYTES;  // one pixel tile: x halo and g tile

// Shared memory of one block: the ring of stages and their barriers
// (ops/kernels/sm90_plan.py mirrors this).
constexpr int k3_smem_bytes(int stages) {
  return sm90::ALIGN_SLACK + stages * K3_STAGE + 2 * sm90::CHUNK * 4 + 2 * stages * 8;
}

// The bf16 weight gradient on Hopper (see the note at the top). blockIdx =
// (pixel split, C tile of 64, O tile of 64); warpgroup dh holds the
// accumulators of taps (dh, 0..2): 3 x 32 floats a thread.
__global__ void __launch_bounds__(K3_THREADS, 1)
conv3x3_wgrad_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap gmap,
                          const float* __restrict__ pa, const float* __restrict__ pb,
                          float* __restrict__ partial, int N, int H, int W, int C, int O,
                          int tiles_h, int tiles_w, int tiles_per_split, int stages) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  float* const pas = reinterpret_cast<float*>(smem + stages * K3_STAGE);  // the C tile's affine
  float* const pbs = pas + CHUNK;
  const uint32_t bars = base + stages * K3_STAGE + 2 * CHUNK * 4;
  auto full = [&](int s) { return bars + 8 * s; };  // TMA landed
  auto empty = [&](int s) { return bars + 8 * (stages + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * CHUNK;
  const int o0 = blockIdx.z * CHUNK;
  const int n_tiles = N * tiles_h * tiles_w;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), K3_CONSUMERS / 32);  // every warp
    }
    fence_barrier_init();
  }
  load_affine(pas, pbs, pa, pb, c0, CHUNK, C, threadIdx.x, K3_THREADS);
  __syncthreads();

  // Thread 0 issues the loads of pixel tile i into stage i % stages: the
  // (8+2)x(32+2) halo of x at (h0-1, w0-1) and the 8x32 tile of g, zero
  // outside the logical images.
  auto issue = [&](int i) {
    const int t = t_begin + i;
    const int s = i % stages;
    const int tx = t % tiles_w;
    const int ty = (t / tiles_w) % tiles_h;
    const int n = t / (tiles_w * tiles_h);
    mbar_expect_tx(full(s), HALO_BYTES + TILE_BYTES);
    const uint32_t stage = base + s * K3_STAGE;
    tma_load_4d(stage, &xmap, full(s), c0, tx * TW - 1, ty * TH - 1, n);
    tma_load_4d(stage + HALO_SLOT, &gmap, full(s), o0, tx * TW, ty * TH, n);
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
      const uint32_t halo = base + s * K3_STAGE;
      const uint32_t gt = halo + HALO_SLOT;
      mbar_wait(full(s), (i / stages) & 1);
      if (pa != nullptr) {
        const int tx = t % tiles_w;
        const int ty = (t / tiles_w) % tiles_h;
        prologue_box(reinterpret_cast<__nv_bfloat16*>(smem + s * K3_STAGE), HALO_PIX, HALO_W,
                     ty * TH - 1, tx * TW - 1, H, W, pas, pbs, threadIdx.x, K3_CONSUMERS);
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
    float* out = partial + static_cast<size_t>(blockIdx.x) * 9 * C * O;
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

int wgrad_sm90(const void* x, const void* g, const void* pa, const void* pb, void* partial,
               void* out, const int* frames, int N, int H, int W, int C, int O, int splits,
               int stages, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || splits < 1 || frames == nullptr ||
      (pa == nullptr) != (pb == nullptr) || stages < 2 ||
      k3_smem_bytes(stages) > sm90::SMEM_LIMIT)
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
  const long long cols = static_cast<long long>(9) * C * O;
  if (n_tiles > 0x7fffffffLL || c_tiles > 65535 || o_tiles > 65535 || cols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, gmap;
  if (!sm90::nhwc_map(&xmap, x, fx, N, H, W, C, HALO_W, TH + 2) ||
      !sm90::nhwc_map(&gmap, g, fg, N, H, W, O, TW, TH))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_split = static_cast<int>((n_tiles + splits - 1) / splits);
  const int smem = k3_smem_bytes(stages);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv3x3_wgrad_sm90_kernel<<<dim3(splits, c_tiles, o_tiles), K3_THREADS, smem, s>>>(
      xmap, gmap, static_cast<const float*>(pa), static_cast<const float*>(pb),
      static_cast<float*>(partial), N, H, W, C, O, tiles_h, tiles_w, tiles_per_split, stages);
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
constexpr int K3F_QROWS = 2;                        // pixel rows of a quarter tile
constexpr int K3F_QUARTERS = TH / K3F_QROWS;
constexpr int K3F_RAW_BOX = K3F_QROWS * TW * BOX_ROW;  // 32 outputs x 64 pixels of g
constexpr int K3F_RAW = 2 * K3F_RAW_BOX;            // the quarter's g, 64 outputs
constexpr int K3F_KBLOCK = 64 * BOX_ROW;            // 64 output rows x 32 pixels (one plane)
constexpr int K3F_PLANE = K3F_QROWS * K3F_KBLOCK;   // the quarter's g^T, one plane
// K steps (8 pixels each) chained through the tensor cores into one fresh
// fragment before it is added to the accumulators.
constexpr int K3F_GROUP = 2;
static_assert(4 % K3F_GROUP == 0, "a 32-pixel row splits into whole groups");
constexpr int K3F_TRANSPOSERS = 256;                // 4x4 blocks of the 64x64 quarter tile

// Shared memory of one block: the halo ring, the raw g quarter, its g^T hi
// and lo planes, the C tile's affine and the barriers (ops/kernels/sm90_plan.py
// mirrors this).
constexpr int k3f_smem_bytes() {
  return sm90::ALIGN_SLACK + K3F_HSTAGES * K3F_HSTAGE + K3F_RAW + 2 * K3F_PLANE +
         2 * 2 * F32_CHUNK * 4 + (K3F_HSTAGES + 1) * 8;
}

// The transpose-and-split stage: the raw g quarter (two TMA boxes, pixel rows
// of 32 outputs, 128-byte swizzled) -> g^T, K-major (a row of 32 pixels per
// output, 128-byte swizzled, one 8 KiB block per pixel row), in TF32 hi and
// lo planes. Thread tid < 256 moves one 4x4 block: outputs 4*ob.., pixels
// 4*pb..; the mapping makes both its 16-byte reads and its 16-byte writes
// conflict-free within each quarter warp.
__device__ __forceinline__ void k3f_transpose(const unsigned char* raw, unsigned char* phi,
                                              unsigned char* plo, int tid) {
  const int l8 = tid & 7;
  const int ob = (l8 ^ ((tid >> 3) & 7)) | (((tid >> 6) & 1) << 3);
  const int pb = l8 | (((tid >> 7) & 1) << 3);
  float v[4][4];  // v[pixel][output] of the block
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * pb + i;
    const float4 t = *reinterpret_cast<const float4*>(raw + (ob >> 3) * K3F_RAW_BOX +
                                                      p * BOX_ROW + (((ob & 7) ^ (p & 7)) << 4));
    v[i][0] = t.x;
    v[i][1] = t.y;
    v[i][2] = t.z;
    v[i][3] = t.w;
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
// accumulators of taps (dh, 0..2): 3 x 32 floats a thread.
__global__ void __launch_bounds__(K3_THREADS, 1)
conv3x3_wgrad_sm90_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap gmap,
                              const float* __restrict__ pa, const float* __restrict__ pb,
                              float* __restrict__ partial, int N, int H, int W, int C, int O,
                              int tiles_h, int tiles_w, int tiles_per_split) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw_base);
  constexpr int RAW_OFF = K3F_HSTAGES * K3F_HSTAGE;
  constexpr int HI_OFF = RAW_OFF + K3F_RAW;
  constexpr int LO_OFF = HI_OFF + K3F_PLANE;
  float* const pas = reinterpret_cast<float*>(smem + LO_OFF + K3F_PLANE);  // the C tile's affine
  float* const pbs = pas + 2 * F32_CHUNK;
  const uint32_t bars = base + LO_OFF + K3F_PLANE + 2 * 2 * F32_CHUNK * 4;
  auto halo_full = [&](int hs) { return bars + 8 * hs; };
  const uint32_t raw_full = bars + 8 * K3F_HSTAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * 2 * F32_CHUNK;
  const int o0 = blockIdx.z * 2 * F32_CHUNK;
  const int n_tiles = N * tiles_h * tiles_w;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int n_mine = min(n_tiles, t_begin + tiles_per_split) - t_begin;

  if (threadIdx.x == 0) {
    for (int hs = 0; hs <= K3F_HSTAGES; ++hs) mbar_init(bars + 8 * hs, 1);
    fence_barrier_init();
  }
  load_affine(pas, pbs, pa, pb, c0, 2 * F32_CHUNK, C, threadIdx.x, K3_THREADS);
  __syncthreads();

  // Thread 0 issues the loads: tile i's (8+2)x(32+2) x halo into halo stage
  // i % 2 (two boxes of 32 channels), and quarter u's 2x32-pixel g tile (two
  // boxes of 32 outputs) into the raw buffer; zero outside the logical images.
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
    coords(u / K3F_QUARTERS, n, ty, tx);
    mbar_expect_tx(raw_full, K3F_RAW);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      tma_load_4d(base + RAW_OFF + b * K3F_RAW_BOX, &gmap, raw_full, o0 + b * F32_CHUNK,
                  tx * TW, ty * TH + (u % K3F_QUARTERS) * K3F_QROWS, n);
  };
  if (threadIdx.x == 0 && n_mine > 0) {
    for (int i = 0; i < K3F_HSTAGES && i < n_mine; ++i) issue_halo(i);
    issue_raw(0);
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
    mbar_wait(halo_full(hs), (i / K3F_HSTAGES) & 1);
    if (pa != nullptr) {
      int n, ty, tx;
      coords(i, n, ty, tx);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        prologue_box_f32(reinterpret_cast<float*>(smem + hs * K3F_HSTAGE + b * HALO_SLOT),
                         HALO_PIX, HALO_W, ty * TH - 1, tx * TW - 1, H, W, pas + b * F32_CHUNK,
                         pbs + b * F32_CHUNK, threadIdx.x, K3_THREADS);
      fence_proxy_async();  // before TMA writes this stage again
    }
#pragma unroll 1
    for (int q = 0; q < K3F_QUARTERS; ++q) {
      const int u = i * K3F_QUARTERS + q;
      mbar_wait(raw_full, u & 1);
      if (threadIdx.x < K3F_TRANSPOSERS)
        k3f_transpose(smem + RAW_OFF, smem + HI_OFF, smem + LO_OFF, threadIdx.x);
      fence_proxy_async();  // the planes, before the tensor cores read them
      __syncthreads();      // planes written, raw read, the prologue done
      if (threadIdx.x == 0 && u + 1 < n_mine * K3F_QUARTERS) issue_raw(u + 1);
#pragma unroll 1
      for (int r = 0; r < K3F_QROWS; ++r) {
        const int hrow = (q * K3F_QROWS + r + dh) * HALO_W;
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
              const uint32_t k_off = r * K3F_KBLOCK + (grp * K3F_GROUP + j) * 32;
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
                        // the last quarter, with the halo stage)
    }
    if (threadIdx.x == 0 && i + K3F_HSTAGES < n_mine) issue_halo(i + K3F_HSTAGES);
  }

  // Accumulator element i of tap (dh, dw) is input channel c0 + 16*wq +
  // lane/4 + 8*((i%4)/2), output channel o0 + 8*(i/4) + 2*(lane%4) + i%2.
  float* out = partial + static_cast<size_t>(blockIdx.x) * 9 * C * O;
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

int wgrad_sm90_f32(const void* x, const void* g, const void* pa, const void* pb, void* partial,
                   void* out, const int* frames, int N, int H, int W, int C, int O, int splits,
                   int stages, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || splits < 1 || frames == nullptr ||
      (pa == nullptr) != (pb == nullptr) || stages != K3F_HSTAGES ||
      k3f_smem_bytes() > sm90::SMEM_LIMIT)
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
  const long long cols = static_cast<long long>(9) * C * O;
  if (n_tiles > 0x7fffffffLL || c_tiles > 65535 || o_tiles > 65535 || cols > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, gmap;
  if (!sm90::nhwc_map_f32(&xmap, x, fx, N, H, W, C, HALO_W, TH + 2) ||
      !sm90::nhwc_map_f32(&gmap, g, fg, N, H, W, O, TW, K3F_QROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_per_split = static_cast<int>((n_tiles + splits - 1) / splits);
  const int smem = k3f_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_sm90_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv3x3_wgrad_sm90_f32_kernel<<<dim3(splits, c_tiles, o_tiles), K3_THREADS, smem, s>>>(
      xmap, gmap, static_cast<const float*>(pa), static_cast<const float*>(pb),
      static_cast<float*>(partial), N, H, W, C, O, tiles_h, tiles_w, tiles_per_split);
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
  return wgrad_sm90(x, g, pa, pb, partial, out, frames, N, H, W, C, O, splits, stages, stream);
}

// The Hopper kernel (float32, no fold mode): as conv3x3_wgrad_sm90_bf16, every
// view with a channel pitch that is a multiple of 4; stages: the depth of the
// ring of x halos (2).
extern "C" int conv3x3_wgrad_sm90_f32(const void* x, const void* g, const void* pa,
                                      const void* pb, void* partial, void* out, const int* frames,
                                      int N, int H, int W, int C, int O, int splits, int stages,
                                      void* stream) {
  return wgrad_sm90_f32(x, g, pa, pb, partial, out, frames, N, H, W, C, O, splits, stages,
                        stream);
}
