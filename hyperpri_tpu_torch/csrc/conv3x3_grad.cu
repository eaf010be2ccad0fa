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
// Two kernel bodies; the wrapper picks one by dtype, mode and layout before
// the launch (ops/kernels/sm90_plan.py), never on a failure.
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
// conv3x3_wgrad_kernel<T, FOLD> (float32, the fold mode, and bf16 views whose
// pitch TMA cannot take, e.g. C = 238 unframed): synchronous staging.
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
//   Not yet done: TMA staging and wgmma for float32 (ROADMAP queue 2b).

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
