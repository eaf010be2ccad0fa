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
// Three kernel bodies; the wrapper picks one by dtype and layout before
// the launch (ops/kernels/sm90_plan.py), never on a failure.
//
// conv3x3_sm90_kernel (bf16 whose channels TMA can address: C % 8 == 0 and
// C <= 256; every bf16 call of a training step). An implicit GEMM, M = output
// pixels, N = output channels, K = 9*C, on the Hopper pieces of
// conv3x3_sm90.cuh:
//   - a block owns an 8x32 pixel tile of one image and ALL output channels:
//     two consumer warpgroups (warp r computes output row r, 2 x 16 pixels)
//     and a producer warpgroup, one warp of which issues the loads (its
//     registers go to the consumers: setmaxnreg 40 / 232). The whole (8+2)x(32+2) input halo, every
//     64-channel chunk of it, is loaded once by TMA (the SAME border and the
//     image edges zero-filled) and stays resident while the block walks its
//     O tiles of 128, so at O = 256 one staged halo feeds both output tiles;
//   - the weights are read in place, w (3, 3, C, O) HWIO with the outputs
//     contiguous (no packing pass; TMA zero-fills past C and O), and stream
//     through a ring of 16 KiB stages, one (O tile, chunk, tap) slice of 64
//     inputs x 128 outputs each (two boxes of 64 x 64), filled by TMA and
//     completed on mbarriers: while the consumers compute on one stage the
//     next ones are in flight;
//   - the products are wgmma m64n128k16, A = the tap-shifted halo pixels from
//     registers (ldmatrix from the swizzled halo), B = the weight slice from
//     shared memory (N-major), float32 accumulators in registers (2 x 64 a
//     thread);
//   - the prologue is applied to each halo chunk once it has landed, in place,
//     in-image pixels and channels below C only, by affine_relu, by the
//     producer warpgroup's three idle warps while the consumers compute on
//     the chunks before it (a second barrier per chunk says it is done);
//   - the epilogue stores y and, for the statistics, sums each thread's
//     pixels, the lanes by shuffles and the eight warps in order into one
//     partial row per block, added over the blocks in a fixed order by
//     reduce_rows_kernel: no float atomics, two runs give the same bits.
//   Bytes staged per MMA (bf16 halo and weight bytes per FLOP of a block).
//   The synchronous kernel: (340 + 9*128) rows of 64 bytes per
//   2*256*128*9*32 FLOP = 5.06e-3 B/FLOP at every width (77% of it weights;
//   the halo staged again per output tile). This kernel: at O = 128 the
//   same, (340 + 9*128) rows of 128 bytes per 2*256*128*9*64 FLOP =
//   5.06e-3, since an 8x32 tile still reads every weight slice from L2; at
//   O = 256, one halo for both output tiles, (340 + 2*9*128)*128 bytes per
//   twice those FLOP = 4.48e-3. Not yet done: fewer weight bytes per MMA at
//   O = 128 (a larger pixel tile per weight slice, or persistent blocks
//   that keep two tiles' halos resident; ROADMAP queue 2b).
//
// conv3x3_sm90_f32_kernel (float32 with C % 4 == 0, O % 4 == 0 and C <= 256:
// every float32 call of a training step). The same implicit GEMM and block
// shape in 3xTF32 (conv3x3_sm90.cuh):
//   - the tf32 wgmma (m64n64k8) takes B from shared memory only K-major, so
//     the weights are first split by split_weights_tf32_kernel
//     (conv3x3_sm90.cuh, shared with conv3x3_packed's and the shift conv's
//     float32 bodies) into two
//     planes (2, 9, O, C), hi and lo, the input channels contiguous; TMA
//     loads a (tap, 32-channel chunk) slice of 64 outputs from each plane
//     (16 KiB) into a ring of up to 8 stages;
//   - a float32 halo is 174 KiB at C = 128 and 348 KiB at C = 256, so it
//     cannot stay resident: it streams through a ring of two 32-channel
//     chunks (43.5 KiB each, one 128-byte box row a pixel), filled by TMA,
//     the prologue applied in place by the producer warpgroup's idle warps,
//     released by the consumers after the chunk's ninth tap;
//   - loop order: O tile of 64 outer, then chunk, then tap, so each thread
//     holds the accumulators of one O tile only (2 m-tiles x 32 floats) and
//     the halo is staged again from L2 for every O tile;
//   - A = the tap-shifted halo pixels by ldmatrix (the b16 ldmatrix of 32-bit
//     words gives the tf32 A fragment), split into hi and lo in registers;
//     each (tap, chunk) slice and m-tile is one chain of 4 K steps (12
//     wgmmas: lo*hi, hi*lo, hi*hi) into a fresh fragment, which is added to
//     the accumulators with float32 adds rounded to nearest (F32_GROUP = 4,
//     the whole slice; chip_smoke.py's phase c found every output and sum
//     within 2.0e-7 of the sum of its absolute terms on an H100, PERF.md §6);
//   - epilogue and statistics as in the bf16 kernel, per O tile of 64.
//   Bound: operations, at the TF32 rate; three TF32 products a float32
//   product make the ceiling three times that bound. Bytes staged per FLOP
//   (of the conv, one product a term): (340 pixels x 128 bytes of halo + 9 x
//   16 KiB of weight planes) per 2*256*64*9*32 FLOP = 2.02e-2 B/FLOP, 77% of
//   it weights, all from L2 (the synchronous float32 kernel stages 1.01e-2:
//   128 outputs a tile, the weights split in registers). Not yet done: a
//   larger pixel tile per weight slice, which would halve the weight bytes.
//
// conv3x3_kernel<T, NP, VEC> (bf16 and float32 layouts neither Hopper body
// takes, e.g. C = 238 unframed): the synchronous direct implicit GEMM of
// conv3x3_common.cuh (bf16 mma.sync products, or 3xTF32 for float32) with
// the output channels tiled over the grid. A block computes an 8x32 pixel
// tile by 128 output channels (64 when O <= 64); blockIdx.z walks images and
// output tiles, so every output tile stages the input halo again (10x34-pixel
// chunks of 64 bytes of channels, from L2 after the first tile). The weights
// arrive packed as wp[tap][o][c] in x's type with O zero-padded to whole
// tiles and C to a whole chunk (32 bf16 or 16 float32 channels). The
// per-channel sums are per-block partials added in a fixed order by a second
// kernel.

#include "conv3x3_common.cuh"
#include "conv3x3_sm90.cuh"

namespace {

using conv3x3::sm90::HALO_BYTES;
using conv3x3::sm90::HALO_SLOT;

constexpr int K2_CONSUMERS = 256;              // two warpgroups, warp r: output row r
constexpr int K2_THREADS = K2_CONSUMERS + 128;  // and the producer warpgroup
constexpr int K2_PRODUCER_REGS = 40;           // setmaxnreg: 128*40 + 256*232 <= 64K
constexpr int K2_CONSUMER_REGS = 232;
constexpr int K2_PROLOGUE_THREADS = 96;        // the producer warpgroup's other warps
constexpr int K2_N = conv3x3::sm90::BF16_N;    // output channels of one pass (O tile)
constexpr int K2_WSTAGE = conv3x3::sm90::BF16_WSTAGE;  // one (O tile, chunk, tap) slice
constexpr int K2_MAX_CHUNKS = 4;               // C <= 256: the halo stays resident
constexpr int K2_RED_FLOATS = conv3x3::TH * K2_N;  // one statistic of the 8 warps
static_assert(K2_RED_FLOATS >= 2 * K2_MAX_CHUNKS * 64, "the affine fits the statistics buffer");

struct Sm90Dims {
  int H, W, C, O, OP, n_chunks, n_otiles, relu, mode, stages;  // OP = n_otiles * K2_N
};

// Shared memory of one block: the resident halo chunks, the weight ring, the
// statistics' cross-warp buffer and the barriers (ops/kernels/sm90_plan.py
// mirrors this).
constexpr int k2_smem_bytes(int n_chunks, int stages) {
  return conv3x3::sm90::ALIGN_SLACK + n_chunks * HALO_SLOT + stages * K2_WSTAGE +
         K2_RED_FLOATS * 4 + (2 * K2_MAX_CHUNKS + 2 * stages) * 8;
}

// The bf16 forward conv on Hopper (see the note at the top).
__global__ void __launch_bounds__(K2_THREADS, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, const float* __restrict__ pa,
                    const float* __restrict__ pb, float* __restrict__ partial,
                    const Sm90Dims d) {
  using namespace conv3x3;
  using namespace conv3x3::sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t ring = base + d.n_chunks * HALO_SLOT;
  float* const red = reinterpret_cast<float*>(smem + d.n_chunks * HALO_SLOT + d.stages * K2_WSTAGE);
  const uint32_t bars = ring + d.stages * K2_WSTAGE + K2_RED_FLOATS * 4;
  auto halo_full = [&](int ch) { return bars + 8 * ch; };                  // TMA landed
  auto halo_ready = [&](int ch) { return bars + 8 * (K2_MAX_CHUNKS + ch); };  // prologue done
  auto w_full = [&](int s) { return bars + 8 * (2 * K2_MAX_CHUNKS + s); };
  auto w_empty = [&](int s) { return bars + 8 * (2 * K2_MAX_CHUNKS + d.stages + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int ch = 0; ch < d.n_chunks; ++ch) {
      mbar_init(halo_full(ch), 1);
      mbar_init(halo_ready(ch), K2_PROLOGUE_THREADS);
    }
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), K2_CONSUMERS / 32);  // every consumer warp
    }
    fence_barrier_init();
  }
  // The prologue's affine for every channel, until the epilogue (which runs
  // after the last chunk's prologue) takes the buffer for the statistics.
  float* const pas = red;
  float* const pbs = red + K2_MAX_CHUNKS * CHUNK;
  load_affine(pas, pbs, pa, pb, 0, d.n_chunks * CHUNK, d.C, threadIdx.x, K2_THREADS);
  __syncthreads();

  const int per_otile = d.n_chunks * 9;
  const int total = d.n_otiles * per_otile;
  const bool prologue = pa != nullptr;
  if (warp >= K2_CONSUMERS / 32) {
    // Producer warpgroup. One thread issues the loads: halo chunk 0, then the
    // weight slices in the consumers' order (O tile, chunk, tap), each halo
    // chunk one chunk ahead of use. With the prologue, the other three warps
    // apply it to each halo chunk once it has landed, while the consumers
    // compute on the chunks before it.
    setmaxnreg_dec<K2_PRODUCER_REGS>();
    if (warp > K2_CONSUMERS / 32 && prologue) {
      const int tid = threadIdx.x - K2_CONSUMERS - 32;
      for (int ch = 0; ch < d.n_chunks; ++ch) {
        mbar_wait(halo_full(ch), 0);
        prologue_box(reinterpret_cast<__nv_bfloat16*>(smem + ch * HALO_SLOT), HALO_PIX, HALO_W,
                     h0 - 1, w0 - 1, d.H, d.W, pas + ch * CHUNK, pbs + ch * CHUNK, tid,
                     K2_PROLOGUE_THREADS);
        fence_proxy_async();
        mbar_arrive(halo_ready(ch));
      }
    }
    if (warp == K2_CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(halo_full(0), HALO_BYTES);
      tma_load_4d(base, &xmap, halo_full(0), 0, w0 - 1, h0 - 1, n);
      for (int it = 0; it < total; ++it) {
        const int ot = it / per_otile;
        const int ch = (it % per_otile) / 9;
        const int tap = it % 9;
        if (ot == 0 && tap == 0 && ch + 1 < d.n_chunks) {
          mbar_expect_tx(halo_full(ch + 1), HALO_BYTES);
          tma_load_4d(base + (ch + 1) * HALO_SLOT, &xmap, halo_full(ch + 1), (ch + 1) * CHUNK,
                      w0 - 1, h0 - 1, n);
        }
        const int s = it % d.stages;
        mbar_wait(w_empty(s), ((it / d.stages) & 1) ^ 1);
        mbar_expect_tx(w_full(s), K2_WSTAGE);
        load_slice_bf16(ring + s * K2_WSTAGE, &wmap, w_full(s), ot * K2_N, ch * CHUNK, tap);
      }
    }
  } else {
    setmaxnreg_inc<K2_CONSUMER_REGS>();
    const int wrow = warp;  // output row h0 + wrow; warpgroup warp / 4
    const int oh = h0 + wrow;
    const int g = lane >> 2;
    const int q = lane & 3;
    float acc[2][64];
    int it = 0;
    for (int ot = 0; ot < d.n_otiles; ++ot) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;
      for (int ch = 0; ch < d.n_chunks; ++ch) {
        const uint32_t halo = base + ch * HALO_SLOT;
        if (ot == 0) mbar_wait(prologue ? halo_ready(ch) : halo_full(ch), 0);
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % d.stages;
          tap_bf16(acc, halo, wrow, tap / 3, tap % 3, ring + s * K2_WSTAGE, w_full(s),
                   (it / d.stages) & 1, lane);
          if (lane == 0) mbar_arrive(w_empty(s));
        }
      }

      // Epilogue of O tile ot (store_tile: O % 8 == 0, so channel pairs).
      const int o0 = ot * K2_N;
      store_tile<__nv_bfloat16, K2_N>(acc, y + static_cast<size_t>(n) * d.H * d.W * d.O, bias,
                                      oh, w0, o0, d.H, d.W, d.O, d.relu, lane);
      if (d.mode == MODE_STATS) {
        // sum(v) then sum(v*v), v = acc + bias unrounded: each thread's four
        // pixels, the eight lanes of a channel pair by shuffles, the eight
        // warps in order; one partial row (2, OP) per block.
        const size_t block_lin =
            (static_cast<size_t>(n) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll 1
        for (int st = 0; st < 2; ++st) {
#pragma unroll
          for (int nb = 0; nb < K2_N / 8; ++nb) {
            const int o = o0 + nb * 8 + 2 * q;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float s = 0.0f;
              if (o + e < d.O && oh < d.H) {
                const float bo = bias[o + e];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                  for (int half = 0; half < 2; ++half) {
                    if (w0 + mt * 16 + g + half * 8 >= d.W) continue;
                    const float v = acc[mt][nb * 4 + half * 2 + e] + bo;
                    s += st == 0 ? v : v * v;
                  }
                }
              }
              s += __shfl_xor_sync(0xffffffffu, s, 4);
              s += __shfl_xor_sync(0xffffffffu, s, 8);
              s += __shfl_xor_sync(0xffffffffu, s, 16);
              if (lane < 4) red[wrow * K2_N + nb * 8 + lane * 2 + e] = s;
            }
          }
          consumer_sync<K2_CONSUMERS>();
          if (threadIdx.x < K2_N) {
            float total_s = 0.0f;
#pragma unroll
            for (int wq = 0; wq < TH; ++wq) total_s += red[wq * K2_N + threadIdx.x];
            partial[(block_lin * 2 + st) * d.OP + o0 + threadIdx.x] = total_s;
          }
          consumer_sync<K2_CONSUMERS>();
        }
      }
    }
  }
}

int bias_act_sm90(const void* x, const void* w, const void* b, void* y, const void* pa,
                  const void* pb, void* partial, void* sums, int N, int H, int W, int C, int O,
                  int relu, int mode, int stages, int partial_rows, void* stream) {
  using namespace conv3x3;
  const int n_chunks = (C + sm90::CHUNK - 1) / sm90::CHUNK;
  const int n_otiles = (O + K2_N - 1) / K2_N;
  const int OP = n_otiles * K2_N;
  if (N < 1 || H < 1 || W < 1 || C < 1 || C % 8 != 0 || n_chunks > K2_MAX_CHUNKS || O < 1 ||
      O % 8 != 0 || (mode != MODE_PLAIN && mode != MODE_STATS) ||
      (pa == nullptr) != (pb == nullptr) ||
      (mode == MODE_STATS && relu) || stages < 2 ||
      k2_smem_bytes(n_chunks, stages) > sm90::SMEM_LIMIT || !frame_ok(unframed(H, W, C), H, W, C))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  const long long rows = static_cast<long long>(grid.x) * grid.y * grid.z;
  if (grid.y > 65535 || grid.z > 65535 ||
      (mode == MODE_STATS && (partial_rows != rows || partial == nullptr || sums == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  if (!sm90::nhwc_map(&xmap, x, unframed(H, W, C), N, H, W, C, HALO_W, TH + 2) ||
      !sm90::weight_map_bf16(&wmap, w, C, O))
    return static_cast<int>(cudaErrorInvalidValue);
  const Sm90Dims d{H, W, C, O, OP, n_chunks, n_otiles, relu, mode, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<float*>(partial);
  const int smem = k2_smem_bytes(n_chunks, stages);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_sm90_kernel<<<grid, K2_THREADS, smem, s>>>(
      xmap, wmap, static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y),
      static_cast<const float*>(pa), static_cast<const float*>(pb), part, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode == MODE_PLAIN) return static_cast<int>(err);
  return static_cast<int>(reduce_rows(part, static_cast<float*>(sums), static_cast<int>(rows),
                                      2 * OP, s));
}

// ---------------------------------------------------------------------------
// The float32 Hopper body (see the note at the top).

using conv3x3::sm90::F32_CHUNK;
using conv3x3::sm90::F32_GROUP;
using conv3x3::sm90::F32_WSTAGE;

constexpr int K2F_N = conv3x3::sm90::F32_N;        // output channels of one pass (O tile)
constexpr int K2F_HSTAGES = 2;                     // halo ring: one 32-channel chunk a stage
constexpr int K2F_MAX_C = 256;
constexpr int K2F_RED_FLOATS = conv3x3::TH * K2F_N;  // one statistic of the 8 warps
constexpr int K2F_AFFINE_FLOATS = 2 * K2F_MAX_C;

// Shared memory of one block: the halo ring, the weight ring, the statistics'
// cross-warp buffer, the prologue's affine and the barriers
// (ops/kernels/sm90_plan.py mirrors this).
constexpr int k2f_smem_bytes(int stages) {
  return conv3x3::sm90::ALIGN_SLACK + K2F_HSTAGES * HALO_SLOT + stages * F32_WSTAGE +
         (K2F_RED_FLOATS + K2F_AFFINE_FLOATS) * 4 + (3 * K2F_HSTAGES + 2 * stages) * 8;
}

// The float32 forward conv on Hopper (see the note at the top).
__global__ void __launch_bounds__(K2_THREADS, 1)
conv3x3_sm90_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                        float* __restrict__ y, const float* __restrict__ pa,
                        const float* __restrict__ pb, float* __restrict__ partial,
                        const Sm90Dims d) {
  using namespace conv3x3;
  using namespace conv3x3::sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t ring = base + K2F_HSTAGES * HALO_SLOT;
  float* const red =
      reinterpret_cast<float*>(smem + K2F_HSTAGES * HALO_SLOT + d.stages * F32_WSTAGE);
  float* const pas = red + K2F_RED_FLOATS;
  float* const pbs = pas + K2F_MAX_C;
  const uint32_t bars = ring + d.stages * F32_WSTAGE + (K2F_RED_FLOATS + K2F_AFFINE_FLOATS) * 4;
  auto halo_full = [&](int hs) { return bars + 8 * hs; };                     // TMA landed
  auto halo_ready = [&](int hs) { return bars + 8 * (K2F_HSTAGES + hs); };    // prologue done
  auto halo_empty = [&](int hs) { return bars + 8 * (2 * K2F_HSTAGES + hs); };
  auto w_full = [&](int s) { return bars + 8 * (3 * K2F_HSTAGES + s); };
  auto w_empty = [&](int s) { return bars + 8 * (3 * K2F_HSTAGES + d.stages + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z;

  if (threadIdx.x == 0) {
    for (int hs = 0; hs < K2F_HSTAGES; ++hs) {
      mbar_init(halo_full(hs), 1);
      mbar_init(halo_ready(hs), K2_PROLOGUE_THREADS);
      mbar_init(halo_empty(hs), K2_CONSUMERS / 32);  // every consumer warp
    }
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), K2_CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  load_affine(pas, pbs, pa, pb, 0, d.n_chunks * F32_CHUNK, d.C, threadIdx.x, K2_THREADS);
  __syncthreads();

  // The walk: O tile, then 32-channel chunk (one halo fill each), then tap
  // (one weight slice each); the halo is staged again for every O tile.
  const int n_fills = d.n_otiles * d.n_chunks;
  const bool prologue = pa != nullptr;
  if (warp >= K2_CONSUMERS / 32) {
    // Producer warpgroup: one thread issues the loads in the consumers'
    // order; with the prologue, the other three warps apply it to each halo
    // fill once it has landed.
    setmaxnreg_dec<K2_PRODUCER_REGS>();
    if (warp > K2_CONSUMERS / 32 && prologue) {
      const int tid = threadIdx.x - K2_CONSUMERS - 32;
      for (int f = 0; f < n_fills; ++f) {
        const int hs = f % K2F_HSTAGES;
        const int ch = f % d.n_chunks;
        mbar_wait(halo_full(hs), (f / K2F_HSTAGES) & 1);
        prologue_box_f32(reinterpret_cast<float*>(smem + hs * HALO_SLOT), HALO_PIX, HALO_W,
                         h0 - 1, w0 - 1, d.H, d.W, pas + ch * F32_CHUNK, pbs + ch * F32_CHUNK,
                         tid, K2_PROLOGUE_THREADS);
        fence_proxy_async();
        mbar_arrive(halo_ready(hs));
      }
    }
    if (warp == K2_CONSUMERS / 32 && lane == 0) {
      for (int it = 0; it < n_fills * 9; ++it) {
        const int f = it / 9;
        const int tap = it % 9;
        const int ot = f / d.n_chunks;
        const int ch = f % d.n_chunks;
        if (tap == 0) {
          const int hs = f % K2F_HSTAGES;
          mbar_wait(halo_empty(hs), ((f / K2F_HSTAGES) & 1) ^ 1);
          mbar_expect_tx(halo_full(hs), HALO_BYTES);
          tma_load_4d(base + hs * HALO_SLOT, &xmap, halo_full(hs), ch * F32_CHUNK, w0 - 1,
                      h0 - 1, n);
        }
        const int s = it % d.stages;
        mbar_wait(w_empty(s), ((it / d.stages) & 1) ^ 1);
        mbar_expect_tx(w_full(s), F32_WSTAGE);
        load_slice_f32(ring + s * F32_WSTAGE, &wmap, w_full(s), ot * K2F_N, ch * F32_CHUNK, tap);
      }
    }
  } else {
    setmaxnreg_inc<K2_CONSUMER_REGS>();
    const int wrow = warp;  // output row h0 + wrow; warpgroup warp / 4
    const int oh = h0 + wrow;
    const int g = lane >> 2;
    const int q = lane & 3;
    // Two m-tiles of 64 pixels (16-column halves of the warpgroup's four
    // rows), each with its float32 accumulators and the fragment of its
    // current K-step group. Both m-tiles' chains are one commit group,
    // waited for at once: while a warpgroup adds its two fragments, the
    // other consumer warpgroup's chains keep the tensor cores busy. (Adding
    // one m-tile's fragment while the other's chain is in flight made ptxas
    // serialize the wgmmas, C7514, and ran slower.)
    float acc[2][32], frag[2][32];
    uint32_t a_hi[2][F32_GROUP][4], a_lo[2][F32_GROUP][4];
    int it = 0;
    for (int ot = 0; ot < d.n_otiles; ++ot) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
      for (int ch = 0; ch < d.n_chunks; ++ch) {
        const int f = ot * d.n_chunks + ch;
        const int hs = f % K2F_HSTAGES;
        const uint32_t halo = base + hs * HALO_SLOT;
        mbar_wait(prologue ? halo_ready(hs) : halo_full(hs), (f / K2F_HSTAGES) & 1);
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % d.stages;
          tap_f32(acc, frag, a_hi, a_lo, halo, wrow, tap / 3, tap % 3, ring + s * F32_WSTAGE,
                  w_full(s), (it / d.stages) & 1, lane);
          if (lane == 0) {
            mbar_arrive(w_empty(s));
            if (tap == 8) mbar_arrive(halo_empty(hs));
          }
        }
      }

      // Epilogue of O tile ot (store_tile: O % 4 == 0, so channel pairs).
      const int o0 = ot * K2F_N;
      store_tile<float, K2F_N>(acc, y + static_cast<size_t>(n) * d.H * d.W * d.O, bias, oh, w0,
                               o0, d.H, d.W, d.O, d.relu, lane);
      if (d.mode == MODE_STATS) {
        // sum(v) then sum(v*v), v = acc + bias: each thread's four pixels,
        // the eight lanes of a channel pair by shuffles, the eight warps in
        // order; one partial row (2, OP) per block.
        const size_t block_lin =
            (static_cast<size_t>(n) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll 1
        for (int st = 0; st < 2; ++st) {
#pragma unroll
          for (int nb = 0; nb < K2F_N / 8; ++nb) {
            const int o = o0 + nb * 8 + 2 * q;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float sum = 0.0f;
              if (o + e < d.O && oh < d.H) {
                const float bo = bias[o + e];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                  for (int half = 0; half < 2; ++half) {
                    if (w0 + mt * 16 + g + half * 8 >= d.W) continue;
                    const float v = acc[mt][nb * 4 + half * 2 + e] + bo;
                    sum += st == 0 ? v : v * v;
                  }
                }
              }
              sum += __shfl_xor_sync(0xffffffffu, sum, 4);
              sum += __shfl_xor_sync(0xffffffffu, sum, 8);
              sum += __shfl_xor_sync(0xffffffffu, sum, 16);
              if (lane < 4) red[wrow * K2F_N + nb * 8 + lane * 2 + e] = sum;
            }
          }
          consumer_sync<K2_CONSUMERS>();
          if (threadIdx.x < K2F_N) {
            float total_s = 0.0f;
#pragma unroll
            for (int wq = 0; wq < TH; ++wq) total_s += red[wq * K2F_N + threadIdx.x];
            partial[(block_lin * 2 + st) * d.OP + o0 + threadIdx.x] = total_s;
          }
          consumer_sync<K2_CONSUMERS>();
        }
      }
    }
  }
}

int bias_act_sm90_f32(const void* x, const void* w, void* planes, const void* b, void* y,
                      const void* pa, const void* pb, void* partial, void* sums, int N, int H,
                      int W, int C, int O, int relu, int mode, int stages, int partial_rows,
                      void* stream) {
  using namespace conv3x3;
  const int n_chunks = (C + F32_CHUNK - 1) / F32_CHUNK;
  const int n_otiles = (O + K2F_N - 1) / K2F_N;
  const int OP = n_otiles * K2F_N;
  if (N < 1 || H < 1 || W < 1 || C < 1 || C % 4 != 0 || C > K2F_MAX_C || O < 1 || O % 4 != 0 ||
      planes == nullptr || (mode != MODE_PLAIN && mode != MODE_STATS) ||
      (pa == nullptr) != (pb == nullptr) || (mode == MODE_STATS && relu) || stages < 2 ||
      k2f_smem_bytes(stages) > sm90::SMEM_LIMIT || !frame_ok(unframed(H, W, C), H, W, C) ||
      9LL * C * O > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  const long long rows = static_cast<long long>(grid.x) * grid.y * grid.z;
  if (grid.y > 65535 || grid.z > 65535 ||
      (mode == MODE_STATS && (partial_rows != rows || partial == nullptr || sums == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = sm90::split_weights_tf32(static_cast<const float*>(w),
                                             static_cast<float*>(planes), C, O, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xmap, wmap;
  if (!sm90::nhwc_map_f32(&xmap, x, unframed(H, W, C), N, H, W, C, HALO_W, TH + 2) ||
      !sm90::planes_map_f32(&wmap, planes, C, O))
    return static_cast<int>(cudaErrorInvalidValue);
  const Sm90Dims d{H, W, C, O, OP, n_chunks, n_otiles, relu, mode, stages};
  auto* part = static_cast<float*>(partial);
  const int smem = k2f_smem_bytes(stages);
  err = cudaFuncSetAttribute(conv3x3_sm90_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_sm90_f32_kernel<<<grid, K2_THREADS, smem, s>>>(
      xmap, wmap, static_cast<const float*>(b), static_cast<float*>(y),
      static_cast<const float*>(pa), static_cast<const float*>(pb), part, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode == MODE_PLAIN) return static_cast<int>(err);
  return static_cast<int>(reduce_rows(part, static_cast<float*>(sums), static_cast<int>(rows),
                                      2 * OP, s));
}

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

// The Hopper kernel (bf16): x (N, H, W, C) with C % 8 == 0 and C <= 256; w:
// (3, 3, C, O) bf16 HWIO weights, read in place, with O % 8 == 0; b, y, pa,
// pb as above; partial: (partial_rows, 2, OP) and sums: (2, OP) with OP = O
// rounded up to 128, partial_rows = N * ceil(H/8) * ceil(W/32); stages:
// weight ring depth.
extern "C" int conv3x3_bias_act_sm90_bf16(const void* x, const void* w, const void* b, void* y,
                                          const void* pa, const void* pb, void* partial,
                                          void* sums, int N, int H, int W, int C, int O,
                                          int relu, int mode, int stages, int partial_rows,
                                          void* stream) {
  return bias_act_sm90(x, w, b, y, pa, pb, partial, sums, N, H, W, C, O, relu, mode, stages,
                       partial_rows, stream);
}

// The Hopper kernel (float32): x (N, H, W, C) with C % 4 == 0 and C <= 256;
// w: (3, 3, C, O) float32 HWIO weights with O % 4 == 0; planes: (2, 9, O, C)
// float32 scratch, which the call fills with the weights' TF32 halves before
// the conv reads them by TMA; b, y, pa, pb as above; partial: (partial_rows,
// 2, OP) and sums: (2, OP) with OP = O rounded up to 64, partial_rows = N *
// ceil(H/8) * ceil(W/32); stages: weight ring depth.
extern "C" int conv3x3_bias_act_sm90_f32(const void* x, const void* w, void* planes,
                                         const void* b, void* y, const void* pa, const void* pb,
                                         void* partial, void* sums, int N, int H, int W, int C,
                                         int O, int relu, int mode, int stages, int partial_rows,
                                         void* stream) {
  return bias_act_sm90_f32(x, w, planes, b, y, pa, pb, partial, sums, N, H, W, C, O, relu, mode,
                           stages, partial_rows, stream);
}

// The weight split alone (what conv3x3_bias_act_sm90_f32 runs first, and
// conv3x3_packed_sm90_f32 with a channel pitch of whole 32-channel chunks),
// to hold it against its plain version: w (3, 3, C, O) float32 -> planes
// (2, 9, O, Cp), zero from channel C to the pitch Cp >= C.
extern "C" int conv3x3_split_weights_tf32(const void* w, void* planes, int C, int O, int Cp,
                                          void* stream) {
  if (C < 1 || O < 1 || Cp < C || 9LL * Cp * O > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(conv3x3::sm90::split_weights_tf32(
      static_cast<const float*>(w), static_cast<float*>(planes), C, O, Cp,
      static_cast<cudaStream_t>(stream)));
}
