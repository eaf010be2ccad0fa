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
// (logical (0,0) at (8,8)) are read and written in place; only the logical
// region of a framed input is ever read.
// The per-channel sums are per-pixel-tile partials (one row per 8x32 tile)
// added in a fixed order by a second kernel (conv3x3_common.cuh), never float
// atomics, so two runs give the same bits whichever block took which tile.
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
// Three kernel bodies; the wrapper picks one before the launch
// (ops/kernels/sm90_plan.py packed_plan), never on a failure.
//
// conv3x3_packed_sm90_kernel<NP, TU, RESIDENT> (bf16 views TMA can address:
// every stride a multiple of 16 bytes, O % 8 == 0, C <= 256; all nine packed
// calls of the product loop's step and three of a served cube's four). An
// implicit GEMM (M = output pixels, N = NP output channels, K = 9*C) on the
// Hopper pieces of conv3x3_sm90.cuh:
//   - persistent blocks, one per SM (the rings fill its shared memory), each
//     walking the call's work units in a static order: unit u, u + grid, ...
//     A unit is TU vertically adjacent 8x32 pixel tiles of one image;
//   - the (8*TU+2)x(32+2) halo of each 64-channel chunk of a unit comes by TMA
//     into a ring of halo stages completed on mbarriers. The tensor map covers
//     the logical view of x (the frame's strides, the logical origin as its
//     base, C channels, not the pitch), so TMA's zero fill gives the SAME
//     border, the lanes from C up to the pitch and the frames: a frame holding
//     NaN is never read. The next units' halos are in flight while the
//     consumers compute on the current one;
//   - the weights are read in place, w (3, 3, C, O) HWIO with the outputs
//     contiguous, by TMA (no packing pass; zero past C and O). Where all
//     9*C*NP of them fit beside the halo ring (C <= 64 at NP = 64, 72 KiB:
//     inc2 and up4.conv2 forward, both backward epilogues) the block loads
//     them once and keeps them for all its units (RESIDENT); wider C streams
//     (chunk, tap) slices of 64 x NP through a ring of its own, and at NP = 64
//     each slice feeds a unit of two tiles (TU = 2: 16x32 pixels);
//   - products: two consumer warpgroups, warp r computing row r of each of
//     the unit's tiles (two 16-pixel halves per row), wgmma m64n64k16 (NP =
//     64) or m64n128k16 (NP = 128) with float32 accumulators in registers; A =
//     the tap-shifted halo pixels from registers (ldmatrix of the swizzled
//     halo), loaded one K step ahead into a second register set while the
//     previous step's MMAs run, B = the weight slice from shared memory;
//   - a producer warpgroup gives its registers to the consumers (setmaxnreg
//     40 / 232): one thread issues the TMA loads, and with the prologue its
//     three other warps apply relu(pa*x + pb) to each landed halo chunk, in
//     place, to in-image pixels and channels below C only (affine_relu, as
//     the plain version rounds it);
//   - epilogues from the accumulators: act(acc + b) stored into y's frame;
//     the statistics summed per thread, the lanes of a channel pair by
//     shuffles and the eight warps in order into one partial row per tile;
//     the backward epilogue reads the r values of a thread's outputs before
//     the products start (NP = 64), forms m, stores dx = m*dz*pa and sums
//     dpa, dpb per tile the same way.
//   Bytes staged per MMA (bf16 halo and weight bytes per FLOP of a block).
//   The synchronous kernel: (340 + 9*NP) rows of 64 bytes per
//   2*256*NP*9*32 FLOP = 6.2e-3 B/FLOP at NP = 64 (weights read again from L2
//   for every tile). This kernel: resident weights, 340 rows of 128 bytes per
//   2*256*64*9*64 FLOP = 2.3e-3; streamed at NP = 64, (612 + 9*64) rows of
//   128 bytes per 2*512*64*9*64 FLOP = 4.0e-3; at NP = 128, (340 + 9*128)
//   rows per 2*256*128*9*64 FLOP = 5.1e-3.
//   Not yet done: overlapping a unit's epilogue with the next unit's MMAs
//   (two consumer warpgroups on alternate units).
//
// conv3x3_packed_sm90_f32_kernel (float32 views TMA can address: a channel
// pitch that is a multiple of 4, C <= 256, O even; every float32 call of the
// UNET and CubeNET-64 steps, the first conv through the float32 ingest
// buffer's 1,024-byte pixels included). The implicit GEMM of
// conv3x3_sm90_f32_kernel (conv3x3.cu) in 3xTF32 on wgmma.m64n64k8.tf32,
// with kernel 1's views, modes and persistent walk:
//   - the weights are split first (split_weights_tf32_kernel,
//     conv3x3_sm90.cuh) into K-major TF32 hi and lo planes (2, 9, O, Cp)
//     whose channel pitch Cp is C rounded up to whole 32-channel chunks, zero
//     past C: a plane row of C = 238 floats (952 bytes) is no TMA stride, one
//     of 256 is. TMA loads a (tap, chunk) slice of 64 outputs from each
//     plane (16 KiB) into a ring of up to 8 stages;
//   - a work unit is one 8x32 pixel tile by one O tile of 64 outputs (two
//     units a tile at NP = 128, adjacent in the walk, so the second reads
//     the halo from L2); persistent blocks, one per SM, walk the units in
//     a static order, and the producer runs on into the next unit while the
//     consumers finish this one: its first halo chunk and weight slices land
//     during the epilogue;
//   - the halo of each (unit, 32-channel chunk) comes by TMA through the
//     tensor map of x's logical view (frames and channels past C zero-filled,
//     a NaN frame never read) into a ring of two 43.5 KiB stages; with the
//     prologue the producer warpgroup's three other warps apply relu(pa*x +
//     pb) in float32 to in-image pixels of each landed chunk;
//   - products as in conv3x3_sm90_f32_kernel: two consumer warpgroups, warp
//     r computing row r of the tile (two m-tiles of 16 pixels), A by ldmatrix
//     from the swizzled halo split into hi and lo in registers, each (tap,
//     chunk) slice and m-tile one chain of 4 K steps (12 wgmmas: lo*hi,
//     hi*lo, hi*hi) into a fresh fragment added to the float32 accumulators
//     with adds rounded to nearest (a chain of 32 channels, 288 slices a
//     unit at C = 256; chip_smoke.py's phase c found every output and sum
//     within 2.4e-7 of the sum of its absolute terms on an H100, and a
//     float32 training step's logits 0.47-0.53x as far from float64 as
//     cuDNN's float32 route, PERF.md §6);
//   - epilogue per unit from the accumulators, stored into y's frame in
//     channel pairs; the backward epilogue reads r after the products (a
//     float32 r tile would not fit beside the accumulators, the fragments
//     and the A halves), one channel pair a thread, so a warp's loads cover
//     whole 32-byte sectors; one partial row (2, NP) per 8x32 tile, each
//     unit writing its O tile's columns.
//   Bytes staged per FLOP (of the conv, one product a term): (340 pixels x
//   128 bytes of halo + 9 x 16 KiB of weight planes) per 2*256*64*9*32 FLOP
//   = 2.02e-2 B/FLOP, 77% of it weights, all from L2, at NP = 64 and 128
//   alike (the synchronous float32 kernel: (340 + 9*NP) rows of 64 bytes per
//   2*256*NP*9*16 FLOP = 1.24e-2 at NP = 64, 1.01e-2 at NP = 128).
//
// conv3x3_kernel<T, NP, VEC> (layouts neither Hopper body takes: C = 238
// unframed gives 476-byte bf16 or 952-byte float32 pixels): the synchronous direct implicit
// GEMM of conv3x3_common.cuh with one output tile (NP in {64, 128} columns, O
// zero-padded to it), bf16 products or 3xTF32 for float32. Channels are
// loaded 16 bytes at a time when C fills whole 16-byte groups, two elements at
// a time when C is even, and one element otherwise; the input is never padded
// in device memory, and staging zero-fills everything outside the logical
// region by select. The weights arrive pre-packed by the wrapper as
// wp[tap][o][c] in x's type (tap = 3*dh+dw, C zero-padded to a whole 64-byte
// chunk: 32 bf16 or 16 float32 channels).

#include "conv3x3_common.cuh"
#include "conv3x3_sm90.cuh"

namespace {

using conv3x3::sm90::BOX_ROW;
using conv3x3::sm90::CHUNK;

constexpr int K1_CONSUMERS = 256;               // two warpgroups, warp r: row r of each tile
constexpr int K1_THREADS = K1_CONSUMERS + 128;  // and the producer warpgroup
constexpr int K1_PRODUCER_REGS = 40;            // setmaxnreg: 128*40 + 256*232 <= 64K
constexpr int K1_CONSUMER_REGS = 232;
constexpr int K1_PROLOGUE_THREADS = 96;         // the producer warpgroup's other warps
constexpr int K1_MAX_CHUNKS = 4;                // C <= 256 (the affine buffer)
constexpr int K1_WBOX = CHUNK * BOX_ROW;        // one weight box: 64 inputs x 64 outputs
constexpr int K1_AFFINE_BYTES = 2 * K1_MAX_CHUNKS * CHUNK * 4;  // the prologue's pa, pb

struct PackedSm90Dims {
  int H, W, C, O, n_chunks, tiles_h, tiles_w, units_h, n_units, relu, mode, hstages, wstages;
  conv3x3::Frame fy, fr;  // the views of y and (MODE_BWD) r
};

constexpr int k1_halo_bytes(int tu) { return (conv3x3::TH * tu + 2) * conv3x3::HALO_W * BOX_ROW; }
constexpr int k1_halo_slot(int tu) { return (k1_halo_bytes(tu) + 1023) / 1024 * 1024; }
constexpr int k1_red_floats(int np, int tu) { return 2 * tu * conv3x3::TH * np; }

// Shared memory of one block: the weights (all 9*n_chunks slices of 64 x NP,
// or a ring of wstages), the halo ring, the per-tile reduction buffer, the
// prologue's affine and the barriers (ops/kernels/sm90_plan.py mirrors this).
constexpr int k1_smem_bytes(int np, int tu, bool resident, int n_chunks, int hstages,
                            int wstages) {
  return conv3x3::sm90::ALIGN_SLACK + (resident ? 9 * n_chunks : wstages) * np * BOX_ROW +
         hstages * k1_halo_slot(tu) + k1_red_floats(np, tu) * 4 + K1_AFFINE_BYTES +
         (2 * (resident ? 1 : wstages) + 3 * hstages) * 8;
}

// The bf16 conv on Hopper (see the note at the top). NP: output channels of
// the tile (64 or 128); TU: 8x32 pixel tiles of a work unit (1, or 2 at NP =
// 64 with streamed weights); RESIDENT: the weights stay in shared memory.
template <int NP, int TU, bool RESIDENT>
__global__ void __launch_bounds__(K1_THREADS, 1)
conv3x3_packed_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                           const float* __restrict__ pa, const float* __restrict__ pb,
                           const __nv_bfloat16* __restrict__ r, float* __restrict__ partial,
                           const PackedSm90Dims d) {
  using namespace conv3x3;
  using namespace conv3x3::sm90;
  constexpr int MT = 2 * TU;          // m-tiles of a warp: TU rows x two 16-pixel halves
  constexpr int NACC = NP / 2;        // accumulators of one m64 x NP wgmma per thread
  constexpr int NB = NP / 8;          // 8-column blocks of the tile
  constexpr int HROWS = TH * TU + 2;  // halo rows of a unit
  constexpr int HBYTES = HROWS * HALO_W * BOX_ROW;
  constexpr int HSLOT = (HBYTES + 1023) / 1024 * 1024;
  constexpr int WSLICE = NP * BOX_ROW;  // one (chunk, tap) slice: 64 inputs x NP outputs
  constexpr int RED = 2 * TU * TH * NP;
  constexpr bool PREFETCH_R = NP == 64 && TU == 1;  // r held in registers over the products
  static_assert(2 * TU * NP <= K1_CONSUMERS, "one consumer thread per partial column");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const int wslots = RESIDENT ? 9 * d.n_chunks : d.wstages;
  const int wbars = RESIDENT ? 1 : d.wstages;
  const uint32_t wbase = base;
  const int halo_off = wslots * WSLICE;
  const uint32_t hbase = base + halo_off;
  const int red_off = halo_off + d.hstages * HSLOT;
  float* const red = reinterpret_cast<float*>(smem + red_off);
  float* const pas = red + RED;
  float* const pbs = pas + K1_MAX_CHUNKS * CHUNK;
  const uint32_t bars = base + red_off + RED * 4 + K1_AFFINE_BYTES;
  auto w_full = [&](int s) { return bars + 8 * s; };
  auto w_empty = [&](int s) { return bars + 8 * (wbars + s); };
  auto h_full = [&](int s) { return bars + 8 * (2 * wbars + s); };                 // TMA landed
  auto h_ready = [&](int s) { return bars + 8 * (2 * wbars + d.hstages + s); };    // prologue done
  auto h_empty = [&](int s) { return bars + 8 * (2 * wbars + 2 * d.hstages + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool prologue = pa != nullptr && d.mode != MODE_BWD;
  // unit u: image n, first pixel row h0, first column w0 (x fastest)
  auto unit_origin = [&](int u, int& n, int& h0, int& w0) {
    const int t = u / d.tiles_w;
    w0 = (u - t * d.tiles_w) * TW;
    h0 = (t % d.units_h) * (TH * TU);
    n = t / d.units_h;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < wbars; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), K1_CONSUMERS / 32);  // every consumer warp
    }
    for (int s = 0; s < d.hstages; ++s) {
      mbar_init(h_full(s), 1);
      mbar_init(h_ready(s), K1_PROLOGUE_THREADS);
      mbar_init(h_empty(s), K1_CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  if (prologue) load_affine(pas, pbs, pa, pb, 0, d.n_chunks * CHUNK, d.C, threadIdx.x, K1_THREADS);
  __syncthreads();

  if (warp >= K1_CONSUMERS / 32) {
    // Producer warpgroup. One thread issues the loads in the consumers'
    // order: resident weights once, then per (unit, chunk) the halo and, when
    // streamed, the nine weight slices of that chunk.
    setmaxnreg_dec<K1_PRODUCER_REGS>();
    if (warp == K1_CONSUMERS / 32) {
      if (lane != 0) return;
      if (RESIDENT) {
        mbar_expect_tx(w_full(0), 9 * d.n_chunks * WSLICE);
        for (int ch = 0; ch < d.n_chunks; ++ch)
          for (int tap = 0; tap < 9; ++tap)
#pragma unroll
            for (int half = 0; half < NP / 64; ++half)
              tma_load_3d(wbase + (ch * 9 + tap) * WSLICE + half * K1_WBOX, &wmap, w_full(0),
                          half * 64, ch * CHUNK, tap);
      }
      int k = 0, wk = 0;
      for (int u = blockIdx.x; u < d.n_units; u += gridDim.x) {
        int n, h0, w0;
        unit_origin(u, n, h0, w0);
        for (int ch = 0; ch < d.n_chunks; ++ch, ++k) {
          const int hs = k % d.hstages;
          mbar_wait(h_empty(hs), ((k / d.hstages) & 1) ^ 1);
          mbar_expect_tx(h_full(hs), HBYTES);
          tma_load_4d(hbase + hs * HSLOT, &xmap, h_full(hs), ch * CHUNK, w0 - 1, h0 - 1, n);
          if (!RESIDENT) {
            for (int tap = 0; tap < 9; ++tap, ++wk) {
              const int ws = wk % d.wstages;
              mbar_wait(w_empty(ws), ((wk / d.wstages) & 1) ^ 1);
              mbar_expect_tx(w_full(ws), WSLICE);
              // w[tap][c][o]: 64 rows (c) of 64 outputs per box
#pragma unroll
              for (int half = 0; half < NP / 64; ++half)
                tma_load_3d(wbase + ws * WSLICE + half * K1_WBOX, &wmap, w_full(ws), half * 64,
                            ch * CHUNK, tap);
            }
          }
        }
      }
    } else if (prologue) {
      // The prologue on each landed halo chunk, in the same order.
      const int tid = threadIdx.x - K1_CONSUMERS - 32;
      int k = 0;
      for (int u = blockIdx.x; u < d.n_units; u += gridDim.x) {
        int n, h0, w0;
        unit_origin(u, n, h0, w0);
        for (int ch = 0; ch < d.n_chunks; ++ch, ++k) {
          const int hs = k % d.hstages;
          mbar_wait(h_full(hs), (k / d.hstages) & 1);
          prologue_box(reinterpret_cast<__nv_bfloat16*>(smem + halo_off + hs * HSLOT),
                       HROWS * HALO_W, HALO_W, h0 - 1, w0 - 1, d.H, d.W, pas + ch * CHUNK,
                       pbs + ch * CHUNK, tid, K1_PROLOGUE_THREADS);
          fence_proxy_async();
          mbar_arrive(h_ready(hs));
        }
      }
    }
    return;
  }

  setmaxnreg_inc<K1_CONSUMER_REGS>();
  const int g = lane >> 2;
  const int q = lane & 3;
  if (RESIDENT) mbar_wait(w_full(0), 0);
  float acc[MT][NACC];
  uint32_t a[2][MT][4];  // A operands of two K steps: the one in flight and the next
  uint32_t rv[PREFETCH_R ? 2 : 1][2][PREFETCH_R ? NB : 1];  // bf16 pairs of r
  // A of K step s (tap s/4, 16 channels from 16*(s%4) of the chunk): 16
  // pixels of this warp's row in each half of each tile row, shifted by the tap.
  auto load_a = [&](uint32_t (&dst)[MT][4], uint32_t halo, int s) {
    const int dh = s / 12;
    const int dw = (s / 4) % 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int p = ((mt >> 1) * TH + warp + dh) * HALO_W + (mt & 1) * 16 + dw + (lane & 15);
      ldsm_x4(dst[mt], swizzled(halo, p, (s % 4) * 2 + (lane >> 4)));
    }
  };
  int k = 0, wk = 0;
  for (int u = blockIdx.x; u < d.n_units; u += gridDim.x) {
    int n, h0, w0;
    unit_origin(u, n, h0, w0);
    if constexpr (PREFETCH_R) {
      if (d.mode == MODE_BWD) {
        const __nv_bfloat16* rn = r + image_offset(d.fr, n);
        const int oh = h0 + warp;
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ow = w0 + half * 16 + g + hh * 8;
            const bool in = oh < d.H && ow < d.W;
            const __nv_bfloat16* rp = rn + (oh * d.fr.cols + ow) * d.fr.pitch;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              const int o = nb * 8 + 2 * q;
              rv[half][hh][nb] =
                  in && o < d.O ? __ldg(reinterpret_cast<const unsigned int*>(rp + o)) : 0u;
            }
          }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[mt][i] = 0.0f;

    for (int ch = 0; ch < d.n_chunks; ++ch, ++k) {
      const int hs = k % d.hstages;
      mbar_wait(prologue ? h_ready(hs) : h_full(hs), (k / d.hstages) & 1);
      const uint32_t halo = hbase + hs * HSLOT;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[1][mt][e] = 0u;
      load_a(a[0], halo, 0);
      uint32_t slice = 0;
      // The 36 K steps of the chunk (9 taps x 4 x 16 channels), one commit
      // each: while a step's MMAs run, the next step's A loads.
#pragma unroll
      for (int s = 0; s < 36; ++s) {
        const int tap = s / 4;
        if (s % 4 == 0) {
          if (RESIDENT) {
            slice = wbase + (ch * 9 + tap) * WSLICE;
          } else {
            const int ws = wk % d.wstages;
            mbar_wait(w_full(ws), (wk / d.wstages) & 1);
            slice = wbase + ws * WSLICE;
          }
        }
        wgmma_fence();
        // B: 16 rows (c) of the slice's 64-output boxes
        const uint64_t desc = desc_sw128(slice + (s % 4) * 16 * BOX_ROW, K1_WBOX, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (NP == 64)
            wgmma_m64n64k16_rs_tb(acc[mt], a[s & 1][mt], desc);
          else
            wgmma_m64n128k16_rs_tb(acc[mt], a[s & 1][mt], desc);
        }
        wgmma_commit();
        // The previous step's MMAs are complete: its A registers, and at a
        // tap's first step the previous tap's weight slice, are free.
        wgmma_wait<1>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(a[(s + 1) & 1][mt]);
        if (!RESIDENT && s % 4 == 0 && tap > 0 && lane == 0)
          mbar_arrive(w_empty((wk - 1) % d.wstages));
        if (s + 1 < 36) load_a(a[(s + 1) & 1], halo, s + 1);
        if (!RESIDENT && s % 4 == 3) ++wk;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        fence_regs(acc[mt]);
        fence_regs(a[0][mt]);
        fence_regs(a[1][mt]);
      }
      if (lane == 0) {
        mbar_arrive(h_empty(hs));
        if (!RESIDENT) mbar_arrive(w_empty((wk - 1) % d.wstages));
      }
    }

    // Epilogue of the unit. Accumulator element i of m-tile mt = (j, half) is
    // pixel column w0 + 16*half + g + 8*((i%4)/2) of row h0 + 8*j + warp,
    // output channel 8*(i/4) + 2q + i%2 (the m16n8 layout of each 8-column
    // block). Modes: MODE_PLAIN y = act(acc + b); MODE_STATS y = acc + b and
    // the sums of y, y*y from the unrounded value; MODE_BWD dz = acc, m =
    // (pa*r + pb > 0), dx = m*dz*pa and the sums of m*dz*r, m*dz.
    __nv_bfloat16* const yn = y + image_offset(d.fy, n);
    const __nv_bfloat16* const rn = r + (d.mode == MODE_BWD ? image_offset(d.fr, n) : 0);
#pragma unroll
    for (int j = 0; j < TU; ++j) {
      const int oh = h0 + j * TH + warp;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int o = nb * 8 + 2 * q;
        const bool o_in = o < d.O;  // O % 8 == 0: o + 1 < O too
        float c0[2] = {0.0f, 0.0f}, c1[2] = {0.0f, 0.0f};  // bias, or pa and pb
        if (o_in) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (d.mode == MODE_BWD) {
              c0[e] = __ldg(pa + o + e);
              c1[e] = __ldg(pb + o + e);
            } else {
              c0[e] = __ldg(bias + o + e);
            }
          }
        }
        float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ow = w0 + half * 16 + g + hh * 8;
            if (!o_in || oh >= d.H || ow >= d.W) continue;
            float out[2];
            if (d.mode == MODE_BWD) {
              uint32_t rr2;
              if constexpr (PREFETCH_R)
                rr2 = rv[half][hh][nb];
              else
                rr2 = __ldg(reinterpret_cast<const unsigned int*>(
                    rn + (oh * d.fr.cols + ow) * d.fr.pitch + o));
              const float2 rr =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rr2));
              const float rre[2] = {rr.x, rr.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const bool m = __fadd_rn(__fmul_rn(rre[e], c0[e]), c1[e]) > 0.0f;
                const float mdz = m ? acc[j * 2 + half][nb * 4 + hh * 2 + e] : 0.0f;
                out[e] = mdz * c0[e];
                s[0][e] += mdz * rre[e];
                s[1][e] += mdz;
              }
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                out[e] = acc[j * 2 + half][nb * 4 + hh * 2 + e] + c0[e];
                if (d.relu) out[e] = fmaxf(out[e], 0.0f);
                s[0][e] += out[e];
                s[1][e] += out[e] * out[e];
              }
            }
            store_pair(yn + (oh * d.fy.cols + ow) * d.fy.pitch + o, out[0], out[1]);
          }
        }
        if (d.mode != MODE_PLAIN) {
#pragma unroll
          for (int st = 0; st < 2; ++st)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = s[st][e];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (lane < 4) red[((st * TU + j) * TH + warp) * NP + nb * 8 + lane * 2 + e] = v;
            }
        }
      }
    }
    if (d.mode != MODE_PLAIN) {
      // one partial row (2, NP) per 8x32 tile: the eight warps in order
      consumer_sync<K1_CONSUMERS>();
      if (threadIdx.x < 2 * TU * NP) {
        const int st = threadIdx.x / (TU * NP);
        const int j = (threadIdx.x / NP) % TU;
        const int col = threadIdx.x % NP;
        const int ty = h0 / TH + j;
        if (ty < d.tiles_h) {
          float total = 0.0f;
#pragma unroll
          for (int wq = 0; wq < TH; ++wq) total += red[((st * TU + j) * TH + wq) * NP + col];
          const size_t tile = (static_cast<size_t>(n) * d.tiles_h + ty) * d.tiles_w + w0 / TW;
          partial[(tile * 2 + st) * NP + col] = total;
        }
      }
      consumer_sync<K1_CONSUMERS>();
    }
  }
}

template <int NP, int TU, bool RESIDENT>
cudaError_t launch_packed_sm90(const CUtensorMap& xmap, const CUtensorMap& wmap,
                               const float* bias, __nv_bfloat16* y, const float* pa,
                               const float* pb, const __nv_bfloat16* r, float* partial,
                               const PackedSm90Dims& d, int grid, int smem, cudaStream_t s) {
  auto kernel = conv3x3_packed_sm90_kernel<NP, TU, RESIDENT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, K1_THREADS, smem, s>>>(xmap, wmap, bias, y, pa, pb, r, partial, d);
  return cudaGetLastError();
}

int packed_sm90(const void* x, const void* w, const void* b, void* y, const void* pa,
                const void* pb, const void* r, void* partial, void* sums, const int* frames,
                int N, int H, int W, int C, int O, int NP, int tile_rows, int resident,
                int hstages, int wstages, int grid, int relu, int mode, int partial_rows,
                void* stream) {
  using namespace conv3x3;
  const int TU = tile_rows / TH;
  const int n_chunks = (C + CHUNK - 1) / CHUNK;
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || O % 8 != 0 || O > NP ||
      (NP != 64 && NP != 128) || tile_rows % TH != 0 || (TU != 1 && TU != 2) ||
      n_chunks > K1_MAX_CHUNKS || grid < 1 || hstages < 2 ||
      (!resident && wstages < 2) || (TU == 2 && (NP != 64 || resident || mode == MODE_BWD)) ||
      (resident && NP != 64) || mode < MODE_PLAIN || mode > MODE_BWD ||
      (pa == nullptr) != (pb == nullptr) ||
      (mode == MODE_BWD && (pa == nullptr || r == nullptr || relu)) ||
      (mode == MODE_STATS && relu) || frames == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = k1_smem_bytes(NP, TU, resident != 0, n_chunks, hstages, wstages);
  if (smem > sm90::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const Frame fx{frames[0], frames[1], frames[2], frames[3], frames[4]};
  const Frame fy{frames[5], frames[6], frames[7], frames[8], frames[9]};
  const Frame fr{frames[10], frames[11], frames[12], frames[13], frames[14]};
  if (!frame_ok(fx, H, W, C) || !frame_ok(fy, H, W, O) || fy.pitch % 2 != 0 ||
      (mode == MODE_BWD && (!frame_ok(fr, H, W, O) || fr.pitch % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int units_h = (H + tile_rows - 1) / tile_rows;
  const long long tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  const long long units = static_cast<long long>(N) * units_h * tiles_w;
  if (units > 0x7fffffffLL || (mode != MODE_PLAIN && (partial_rows != tiles ||
                                                      partial == nullptr || sums == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  // w (3, 3, C, O) as dims (O, C, 9): the output channels contiguous, zero
  // past O and C
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(C), 9};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(O) * 2,
                                  static_cast<cuuint64_t>(O) * C * 2};
  const cuuint32_t wbox[3] = {64, static_cast<cuuint32_t>(CHUNK), 1};
  if (!sm90::nhwc_map(&xmap, x, fx, N, H, W, C, HALO_W, tile_rows + 2) ||
      !sm90::encode_bf16(&wmap, w, 3, wdims, wstrides, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const PackedSm90Dims d{H,    W,    C,       O,       n_chunks, tiles_h, tiles_w, units_h,
                         static_cast<int>(units), relu, mode, hstages, wstages, fy, fr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bias = static_cast<const float*>(b);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const auto* paf = static_cast<const float*>(pa);
  const auto* pbf = static_cast<const float*>(pb);
  const auto* rb = static_cast<const __nv_bfloat16*>(r);
  auto* part = static_cast<float*>(partial);
  cudaError_t err;
  if (resident)
    err = launch_packed_sm90<64, 1, true>(xmap, wmap, bias, yb, paf, pbf, rb, part, d, grid,
                                          smem, s);
  else if (NP == 128)
    err = launch_packed_sm90<128, 1, false>(xmap, wmap, bias, yb, paf, pbf, rb, part, d, grid,
                                            smem, s);
  else if (TU == 2)
    err = launch_packed_sm90<64, 2, false>(xmap, wmap, bias, yb, paf, pbf, rb, part, d, grid,
                                           smem, s);
  else
    err = launch_packed_sm90<64, 1, false>(xmap, wmap, bias, yb, paf, pbf, rb, part, d, grid,
                                           smem, s);
  if (err != cudaSuccess || mode == MODE_PLAIN) return static_cast<int>(err);
  return static_cast<int>(reduce_rows(part, static_cast<float*>(sums), partial_rows, 2 * NP, s));
}

// ---------------------------------------------------------------------------
// The float32 Hopper body (see the note at the top).

using conv3x3::sm90::F32_CHUNK;
using conv3x3::sm90::F32_GROUP;
using conv3x3::sm90::F32_N;
using conv3x3::sm90::F32_PLANE;
using conv3x3::sm90::F32_UNITS;
using conv3x3::sm90::F32_WSTAGE;

constexpr int K1F_HSTAGES = 2;                           // halo ring: one 32-channel chunk a stage
constexpr int K1F_MAX_C = 256;                           // the prologue's affine buffer
constexpr int K1F_RED_FLOATS = 2 * conv3x3::TH * F32_N;  // both sums of the 8 warps
constexpr int K1F_AFFINE_FLOATS = 2 * K1F_MAX_C;
// 8-column blocks of r a thread of the backward epilogue loads at once: 32
// registers beside the 64 accumulators (all 8, 64 registers, spilled 144
// bytes and ran the 64->64 bwd_x call 12% slower on an H100)
constexpr int K1F_R_BLOCKS = 4;

struct PackedSm90F32Dims {
  int H, W, C, O, NP, n_chunks, n_otiles, tiles_h, tiles_w, n_units, relu, mode, wstages;
  conv3x3::Frame fy, fr;  // the views of y and (MODE_BWD) r
};

// Shared memory of one block: the halo ring, the weight ring, the sums'
// cross-warp buffer, the prologue's affine and the barriers
// (ops/kernels/sm90_plan.py mirrors this).
constexpr int k1f_smem_bytes(int wstages) {
  return conv3x3::sm90::ALIGN_SLACK + K1F_HSTAGES * conv3x3::sm90::HALO_SLOT +
         wstages * F32_WSTAGE + (K1F_RED_FLOATS + K1F_AFFINE_FLOATS) * 4 +
         (3 * K1F_HSTAGES + 2 * wstages) * 8;
}

// The float32 conv on Hopper (see the note at the top). A work unit is one
// 8x32 pixel tile by one O tile of 64 outputs.
__global__ void __launch_bounds__(K1_THREADS, 1)
conv3x3_packed_sm90_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap wmap,
                               const float* __restrict__ bias, float* __restrict__ y,
                               const float* __restrict__ pa, const float* __restrict__ pb,
                               const float* __restrict__ r, float* __restrict__ partial,
                               const PackedSm90F32Dims d) {
  using namespace conv3x3;
  using namespace conv3x3::sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t ring = base + K1F_HSTAGES * HALO_SLOT;
  float* const red =
      reinterpret_cast<float*>(smem + K1F_HSTAGES * HALO_SLOT + d.wstages * F32_WSTAGE);
  float* const pas = red + K1F_RED_FLOATS;
  float* const pbs = pas + K1F_MAX_C;
  const uint32_t bars =
      ring + d.wstages * F32_WSTAGE + (K1F_RED_FLOATS + K1F_AFFINE_FLOATS) * 4;
  auto halo_full = [&](int s) { return bars + 8 * s; };                   // TMA landed
  auto halo_ready = [&](int s) { return bars + 8 * (K1F_HSTAGES + s); };  // prologue done
  auto halo_empty = [&](int s) { return bars + 8 * (2 * K1F_HSTAGES + s); };
  auto w_full = [&](int s) { return bars + 8 * (3 * K1F_HSTAGES + s); };
  auto w_empty = [&](int s) { return bars + 8 * (3 * K1F_HSTAGES + d.wstages + s); };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool prologue = pa != nullptr && d.mode != MODE_BWD;
  // unit u: O tile ot of pixel tile t = u / n_otiles (image n, first row h0,
  // first column w0; x fastest), so a tile's O tiles run side by side
  auto unit_origin = [&](int u, int& n, int& h0, int& w0, int& ot) {
    const int t = u / d.n_otiles;
    ot = u - t * d.n_otiles;
    const int tr = t / d.tiles_w;
    w0 = (t - tr * d.tiles_w) * TW;
    h0 = (tr % d.tiles_h) * TH;
    n = tr / d.tiles_h;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < K1F_HSTAGES; ++s) {
      mbar_init(halo_full(s), 1);
      mbar_init(halo_ready(s), K1_PROLOGUE_THREADS);
      mbar_init(halo_empty(s), K1_CONSUMERS / 32);  // every consumer warp
    }
    for (int s = 0; s < d.wstages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), K1_CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  if (prologue)
    load_affine(pas, pbs, pa, pb, 0, d.n_chunks * F32_CHUNK, d.C, threadIdx.x, K1_THREADS);
  __syncthreads();

  if (warp >= K1_CONSUMERS / 32) {
    // Producer warpgroup. One thread issues the loads in the consumers'
    // order: per (unit, 32-channel chunk) the halo, then the chunk's nine
    // weight slices of the unit's O tile; the rings carry it into the next
    // unit while the consumers finish this one. With the prologue, the other
    // three warps apply it to each landed halo chunk.
    setmaxnreg_dec<K1_PRODUCER_REGS>();
    if (warp == K1_CONSUMERS / 32) {
      if (lane != 0) return;
      int f = 0, it = 0;
      for (int u = blockIdx.x; u < d.n_units; u += gridDim.x) {
        int n, h0, w0, ot;
        unit_origin(u, n, h0, w0, ot);
        for (int ch = 0; ch < d.n_chunks; ++ch, ++f) {
          const int hs = f % K1F_HSTAGES;
          mbar_wait(halo_empty(hs), ((f / K1F_HSTAGES) & 1) ^ 1);
          mbar_expect_tx(halo_full(hs), HALO_BYTES);
          tma_load_4d(base + hs * HALO_SLOT, &xmap, halo_full(hs), ch * F32_CHUNK, w0 - 1, h0 - 1,
                      n);
          for (int tap = 0; tap < 9; ++tap, ++it) {
            const int s = it % d.wstages;
            mbar_wait(w_empty(s), ((it / d.wstages) & 1) ^ 1);
            mbar_expect_tx(w_full(s), F32_WSTAGE);
            // planes (2, 9, O, Cp): 64 output rows of 32 channels per box
#pragma unroll
            for (int plane = 0; plane < 2; ++plane)
              tma_load_4d(ring + s * F32_WSTAGE + plane * F32_PLANE, &wmap, w_full(s),
                          ch * F32_CHUNK, ot * F32_N, tap, plane);
          }
        }
      }
    } else if (prologue) {
      const int tid = threadIdx.x - K1_CONSUMERS - 32;
      int f = 0;
      for (int u = blockIdx.x; u < d.n_units; u += gridDim.x) {
        int n, h0, w0, ot;
        unit_origin(u, n, h0, w0, ot);
        for (int ch = 0; ch < d.n_chunks; ++ch, ++f) {
          const int hs = f % K1F_HSTAGES;
          mbar_wait(halo_full(hs), (f / K1F_HSTAGES) & 1);
          prologue_box_f32(reinterpret_cast<float*>(smem + hs * HALO_SLOT), HALO_PIX, HALO_W,
                           h0 - 1, w0 - 1, d.H, d.W, pas + ch * F32_CHUNK, pbs + ch * F32_CHUNK,
                           tid, K1_PROLOGUE_THREADS);
          fence_proxy_async();
          mbar_arrive(halo_ready(hs));
        }
      }
    }
    return;
  }

  setmaxnreg_inc<K1_CONSUMER_REGS>();
  const int g = lane >> 2;
  const int q = lane & 3;
  // Two m-tiles of 64 pixels (the 16-column halves of the warpgroup's four
  // rows), each with its float32 accumulators and the fragment of its
  // current K-step group; both m-tiles' chains are one commit group, waited
  // for at once (as in conv3x3_sm90_f32_kernel).
  float acc[2][32], frag[2][32];
  uint32_t a_hi[2][F32_GROUP][4], a_lo[2][F32_GROUP][4];
  int f = 0, it = 0;
  for (int u = blockIdx.x; u < d.n_units; u += gridDim.x) {
    int n, h0, w0, ot;
    unit_origin(u, n, h0, w0, ot);
    const int o0 = ot * F32_N;
    const float* const rn = r + (d.mode == MODE_BWD ? image_offset(d.fr, n) : 0);
    if (d.mode == MODE_BWD) {
      // the unit's r into L2 while the products run: thread t the 64
      // channels of pixel t of the tile (two 128-byte lines)
      const int ph = h0 + threadIdx.x / TW;
      const int pw = w0 + threadIdx.x % TW;
      if (ph < d.H && pw < d.W) {
        const float* p = rn + (ph * d.fr.cols + pw) * d.fr.pitch + o0;
        prefetch_l2(p);
        if (o0 + 32 < d.O) prefetch_l2(p + 32);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
    for (int ch = 0; ch < d.n_chunks; ++ch, ++f) {
      const int hs = f % K1F_HSTAGES;
      const uint32_t halo = base + hs * HALO_SLOT;
      mbar_wait(prologue ? halo_ready(hs) : halo_full(hs), (f / K1F_HSTAGES) & 1);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++it) {
        const int dh = tap / 3;
        const int dw = tap % 3;
        const int s = it % d.wstages;
        const uint32_t stage = ring + s * F32_WSTAGE;
#pragma unroll
        for (int unit = 0; unit < F32_UNITS; ++unit) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            load_a_f32(a_hi[mt], a_lo[mt], halo, warp, dh, dw, mt, unit, lane);
          if (unit == 0) mbar_wait(w_full(s), (it / d.wstages) & 1);
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) chain_f32(frag[mt], a_hi[mt], a_lo[mt], stage, unit);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            fence_regs(frag[mt]);
            fence_a(a_hi[mt]);
            fence_a(a_lo[mt]);
            add_fragment(acc[mt], frag[mt]);
          }
          if (unit == F32_UNITS - 1 && lane == 0) {
            mbar_arrive(w_empty(s));
            if (tap == 8) mbar_arrive(halo_empty(hs));
          }
        }
      }
    }

    // Epilogue of the unit. Accumulator element i of m-tile mt is pixel
    // column w0 + 16*mt + g + 8*((i%4)/2) of row h0 + warp, output channel
    // o0 + 8*(i/4) + 2q + i%2. Modes: MODE_PLAIN y = act(acc + b);
    // MODE_STATS y = acc + b and the sums of y, y*y; MODE_BWD dz = acc, m =
    // (pa*r + pb > 0), dx = m*dz*pa and the sums of m*dz*r, m*dz, the
    // thread's r loaded K1F_R_BLOCKS 8-column blocks at a time, all loads of
    // a batch issued before their use (channel pairs: a warp's load covers
    // whole 32-byte sectors).
    const int oh = h0 + warp;
    float* const yn = y + image_offset(d.fy, n);
    float2 rv[2][2][K1F_R_BLOCKS];
#pragma unroll
    for (int nb = 0; nb < F32_N / 8; ++nb) {
      const int o = o0 + nb * 8 + 2 * q;
      const bool o_in = o < d.O;  // O is even: o + 1 < O too
      if (d.mode == MODE_BWD && nb % K1F_R_BLOCKS == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ow = w0 + mt * 16 + g + hh * 8;
            const float* rp = rn + (oh * d.fr.cols + ow) * d.fr.pitch + o;
#pragma unroll
            for (int k = 0; k < K1F_R_BLOCKS; ++k)
              rv[mt][hh][k] = oh < d.H && ow < d.W && o + 8 * k < d.O
                                  ? __ldg(reinterpret_cast<const float2*>(rp + 8 * k))
                                  : make_float2(0.0f, 0.0f);
          }
      }
      float c0[2] = {0.0f, 0.0f}, c1[2] = {0.0f, 0.0f};  // bias, or pa and pb
      if (o_in) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (d.mode == MODE_BWD) {
            c0[e] = __ldg(pa + o + e);
            c1[e] = __ldg(pb + o + e);
          } else {
            c0[e] = __ldg(bias + o + e);
          }
        }
      }
      float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int ow = w0 + mt * 16 + g + hh * 8;
          if (!o_in || oh >= d.H || ow >= d.W) continue;
          float out[2];
          if (d.mode == MODE_BWD) {
            const float2 rr = rv[mt][hh][nb % K1F_R_BLOCKS];
            const float rre[2] = {rr.x, rr.y};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool m = __fadd_rn(__fmul_rn(rre[e], c0[e]), c1[e]) > 0.0f;
              const float mdz = m ? acc[mt][nb * 4 + hh * 2 + e] : 0.0f;
              out[e] = mdz * c0[e];
              s[0][e] += mdz * rre[e];
              s[1][e] += mdz;
            }
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              out[e] = acc[mt][nb * 4 + hh * 2 + e] + c0[e];
              if (d.relu) out[e] = fmaxf(out[e], 0.0f);
              s[0][e] += out[e];
              s[1][e] += out[e] * out[e];
            }
          }
          store_pair(yn + (oh * d.fy.cols + ow) * d.fy.pitch + o, out[0], out[1]);
        }
      }
      if (d.mode != MODE_PLAIN) {
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = s[st][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (lane < 4) red[(st * TH + warp) * F32_N + nb * 8 + lane * 2 + e] = v;
          }
      }
    }
    if (d.mode != MODE_PLAIN) {
      // the unit's columns of its tile's partial row (2, NP): the eight warps
      // in order
      consumer_sync<K1_CONSUMERS>();
      if (threadIdx.x < 2 * F32_N) {
        const int st = threadIdx.x / F32_N;
        const int col = threadIdx.x % F32_N;
        float total = 0.0f;
#pragma unroll
        for (int wq = 0; wq < TH; ++wq) total += red[(st * TH + wq) * F32_N + col];
        const size_t tile =
            (static_cast<size_t>(n) * d.tiles_h + h0 / TH) * d.tiles_w + w0 / TW;
        partial[(tile * 2 + st) * d.NP + o0 + col] = total;
      }
      consumer_sync<K1_CONSUMERS>();
    }
  }
}

int packed_sm90_f32(const void* x, const void* w, void* planes, const void* b, void* y,
                    const void* pa, const void* pb, const void* r, void* partial, void* sums,
                    const int* frames, int N, int H, int W, int C, int O, int NP, int wstages,
                    int grid, int relu, int mode, int partial_rows, void* stream) {
  using namespace conv3x3;
  const int n_chunks = (C + F32_CHUNK - 1) / F32_CHUNK;
  const int Cp = n_chunks * F32_CHUNK;  // the planes' channel pitch: whole chunks
  const int n_otiles = NP / F32_N;
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > K1F_MAX_C || O < 1 || O % 2 != 0 || O > NP ||
      (NP != 64 && NP != 128) || grid < 1 || wstages < 2 || planes == nullptr ||
      mode < MODE_PLAIN || mode > MODE_BWD || (pa == nullptr) != (pb == nullptr) ||
      (mode == MODE_BWD && (pa == nullptr || r == nullptr || relu)) ||
      (mode == MODE_STATS && relu) || frames == nullptr || 9LL * Cp * O > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = k1f_smem_bytes(wstages);
  if (smem > sm90::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const Frame fx{frames[0], frames[1], frames[2], frames[3], frames[4]};
  const Frame fy{frames[5], frames[6], frames[7], frames[8], frames[9]};
  const Frame fr{frames[10], frames[11], frames[12], frames[13], frames[14]};
  if (!frame_ok(fx, H, W, C) || !frame_ok(fy, H, W, O) || fy.pitch % 2 != 0 ||
      (mode == MODE_BWD && (!frame_ok(fr, H, W, O) || fr.pitch % 2 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  const long long units = tiles * n_otiles;
  if (units > 0x7fffffffLL ||
      (mode != MODE_PLAIN && (partial_rows != tiles || partial == nullptr || sums == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = sm90::split_weights_tf32(static_cast<const float*>(w),
                                             static_cast<float*>(planes), C, O, Cp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xmap, wmap;
  // planes (2, 9, O, Cp) as dims (Cp, O, 9, 2): the input channels
  // contiguous (K-major), zero past O
  const cuuint64_t wdims[4] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(O), 9, 2};
  const cuuint64_t wstrides[3] = {static_cast<cuuint64_t>(Cp) * 4,
                                  static_cast<cuuint64_t>(O) * Cp * 4,
                                  static_cast<cuuint64_t>(9) * O * Cp * 4};
  const cuuint32_t wbox[4] = {static_cast<cuuint32_t>(F32_CHUNK), F32_N, 1, 1};
  if (!sm90::nhwc_map_f32(&xmap, x, fx, N, H, W, C, HALO_W, TH + 2) ||
      !sm90::encode_f32(&wmap, planes, 4, wdims, wstrides, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const PackedSm90F32Dims d{H,       W,       C,    O,    NP,      n_chunks, n_otiles, tiles_h,
                            tiles_w, static_cast<int>(units), relu, mode, wstages, fy,
                            fr};
  auto* part = static_cast<float*>(partial);
  err = cudaFuncSetAttribute(conv3x3_packed_sm90_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_packed_sm90_f32_kernel<<<grid, K1_THREADS, smem, s>>>(
      xmap, wmap, static_cast<const float*>(b), static_cast<float*>(y),
      static_cast<const float*>(pa), static_cast<const float*>(pb),
      static_cast<const float*>(r), part, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode == MODE_PLAIN) return static_cast<int>(err);
  return static_cast<int>(reduce_rows(part, static_cast<float*>(sums), partial_rows, 2 * NP, s));
}

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

// The Hopper kernel (bf16): x framed by frames[0:5] with C <= 256 and a pitch
// that is a multiple of 8, w: (3, 3, C, O) bf16 HWIO weights, read in place,
// with O % 8 == 0 and O <= NP; b, y, pa, pb, r, frames, partial and sums as
// above (y's and r's pitches even), partial_rows = N * ceil(H/8) * ceil(W/32).
// The plan (ops/kernels/sm90_plan.py packed_plan): NP (64 or 128), tile_rows
// (8 or 16: pixel rows of a work unit), resident (weights kept in shared
// memory), hstages (halo ring depth), wstages (weight ring depth when
// streamed), grid (persistent blocks).
extern "C" int conv3x3_packed_sm90_bf16(const void* x, const void* w, const void* b, void* y,
                                        const void* pa, const void* pb, const void* r,
                                        void* partial, void* sums, const int* frames, int N,
                                        int H, int W, int C, int O, int NP, int tile_rows,
                                        int resident, int hstages, int wstages, int grid,
                                        int relu, int mode, int partial_rows, void* stream) {
  return packed_sm90(x, w, b, y, pa, pb, r, partial, sums, frames, N, H, W, C, O, NP, tile_rows,
                     resident, hstages, wstages, grid, relu, mode, partial_rows, stream);
}

// The Hopper kernel (float32): x framed by frames[0:5] with C <= 256 and a
// pitch that is a multiple of 4, w: (3, 3, C, O) float32 HWIO weights with O
// even and O <= NP; planes: (2, 9, O, Cp) float32 scratch with Cp = C
// rounded up to 32, which the call fills with the weights' TF32 halves (zero
// past C) before the conv reads them by TMA; b, y, pa, pb, r, frames,
// partial and sums as above (y's and r's pitches even), partial_rows = N *
// ceil(H/8) * ceil(W/32). The plan (ops/kernels/sm90_plan.py packed_plan):
// NP (64 or 128: one or two O tiles of 64, each its own work unit), wstages
// (weight ring depth), grid (persistent blocks).
extern "C" int conv3x3_packed_sm90_f32(const void* x, const void* w, void* planes, const void* b,
                                       void* y, const void* pa, const void* pb, const void* r,
                                       void* partial, void* sums, const int* frames, int N, int H,
                                       int W, int C, int O, int NP, int wstages, int grid,
                                       int relu, int mode, int partial_rows, void* stream) {
  return packed_sm90_f32(x, w, planes, b, y, pa, pb, r, partial, sums, frames, N, H, W, C, O, NP,
                         wstages, grid, relu, mode, partial_rows, stream);
}
