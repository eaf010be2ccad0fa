// Probe: does packing two dh taps into the K axis pay for the C = 64 convs?
//
// Replaces the TPU probe scripts/probe_dh_fold.py:build (its kernels
// _current_kernel and _folded_kernel). Both compute, on a bf16 buffer x that
// is already padded (N, HP, WP, lanes) with the output channels LS = 64,
//
//     out[n, h, w, o] = sum_{dh, dw, c} x[n, h+dh, w+dw, c] * W[dh][c, dw*64 + o]
//
// for an (N, HP-2, WP-8, 64) bf16 output, in float32, rounded once:
//   - current: x has 128 lanes whose upper 64 are zero, W = w (3, 128, 192)
//     whose rows 64+ are zero: three dh products of K = 128, half of K zero;
//   - folded: x has the 64 real lanes; the K = 128 operand [x(dh0) | x(dh1)]
//     is multiplied by w01 (1, 128, 192), then [x(dh2) | 0] by w2 (1, 128,
//     192) whose rows 64+ are zero: two products of K = 128 instead of three.
// On the TPU the K axis is the 128-lane MXU's, and K = 64 leaves half of each
// pass idle. Here a bf16 MMA step is k16: K = 64 would be four steps, so the
// zero half of K is work the card need not have done, and the probe times how
// much of it it pays. Both bodies keep the products the TPU probe times, the
// zero halves included (the zero lanes of x128 and rows of w are read as
// input, never assumed zero), since the difference between the two kernels is
// the probe's result. k16 steps of an 8x32-pixel tile (per m-tile of 64
// pixels and 64 outputs): current 72 (3 dh x 3 dw x 8), folded 48 (2 passes
// x 3 dw x 8), the 64-lane function itself 36.
//
// The TPU kernels form P = x_window (TH*72, 128) @ W (128, 192) and end with
// the shifted add P[:, 0:64, 0:64] + P[:, 1:65, 64:128] + P[:, 2:66, 128:192].
// Here accumulator element (pixel w, output o) of the dw-th 64-column group
// takes its A rows from window column w + dw, so that element IS
// P[w + dw, dw*64 + o]: the shifted add happens in the accumulator, with no P
// buffer in shared memory.
//
// Bound (as chip_smoke.py's phase f computes it). The function's operations,
// 2*N*HO*WO*64*9*64 = 9.18e10 at the probe's shape (N = 2, HO = 608, WO =
// 1024), take 0.093 ms at 989 TFLOP/s; each kernel's own bytes (its x, its
// weights and the output, each once) 0.144 ms (current: 322 MB of x128) and
// 0.096 ms (folded: 161 MB of x64) at 3.35 TB/s: bound by bytes. Current's own
// products, the zero half counted, take 0.186 ms at peak, folded's 0.124.
//
// Two kernel bodies; the wrapper picks one before the launch
// (ops/kernels/sm90_plan.py dh_fold_plan), never on a failure.
//
// dh_fold_sm90_kernel<FOLDED> (16-byte aligned weights, every call of the
// probe): the Hopper pieces of conv3x3_sm90.cuh with kernel 2's block
// (csrc/conv3x3.cu) and the shift conv's persistent walk
// (csrc/conv3x3_shift.cu):
//   - two consumer warpgroups (warp r computes output row r of an 8x32 pixel
//     tile, two m-tiles of 16 pixels by the 64 outputs: 64 float32
//     accumulators a thread) and a producer warpgroup, one thread of which
//     issues the TMA loads (setmaxnreg 40 / 232);
//   - persistent blocks, one per SM, walk the tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ... (4,864 tiles at the probe's shape, about 37
//     a block), so one tile's epilogue overlaps the next tile's loads;
//   - staging: a TMA box of 64 channels x 34 columns x 10 rows of the
//     pre-padded buffer, 128-byte swizzled, one 44,032-byte slot, in a ring
//     of three. Nothing is zero-filled: the buffer is padded already. The
//     three dh bands are row offsets 0, 1, 2 into the box, so folded's
//     [x(dh0) | x(dh1)] is just which box rows each k16 step's ldmatrix reads
//     (the TPU kernel's lane concatenation, cat_ref, disappears); current
//     stages two boxes a tile, lanes 0-63 and 64-127;
//   - weights read in place by TMA, no packing pass: W (taps, 128, 192) has
//     o contiguous, kernel 2's "tb" form, mapped as dims (192, 128, taps) with
//     boxes of 64 outputs x 64 channels (8 KiB); a dw group is the box's o
//     offset dw*64. Folded keeps its twelve boxes (w01 and w2, two maps,
//     98,304 bytes) resident, loaded once a block. Current's eighteen
//     (147,456 bytes) do not fit beside a ring of two 128-lane halo stages
//     (236,544 bytes with the slack, over the 232,448 a block may use), so
//     its (chunk, dh, dw) slices stream through a ring of twelve 8 KiB stages
//     (every block reads the same 147 KB, which stay in L2) and its 64-lane
//     halo chunks through the ring of three slots. The other choice, resident
//     weights beside a single halo slot, would serialize the box loads (43 KB
//     from device memory each) with the products. The layout is fixed and the
//     same in both kernels: three halo slots, twelve weight slots, a full
//     and an empty barrier each, k7_smem_bytes() = 231,664 bytes;
//   - products: wgmma m64n64k16, A (the box pixels of this warp's output row
//     at row offset dh and column offset dw) from registers by ldmatrix, B (a
//     64-channel x 64-output weight box) from shared memory; for folded's
//     [x(dh2) | 0] the zero half of A is zero registers, its wgmmas issued.
//     A tile is a fixed sequence of units (one 64-channel K range against
//     one weight box, eight wgmmas: 18 for current, 12 for folded), fully
//     unrolled: each warpgroup keeps one unit's wgmmas in flight while it
//     loads the next unit's A into a second register set, so its tensor
//     cores need not wait for the ldmatrix loads, and waits for a unit only
//     before releasing its weight slot. The accumulators are zeroed and
//     pinned before the first unit's fence: ptxas otherwise found the zeroing
//     moved past it and injected a warpgroup wait and arrive (C7517, C7519);
//   - epilogue: each accumulator rounded once to bf16 and stored as channel
//     pairs from registers; no atomics, so two runs give the same bits.
//   Bytes staged per FLOP of the products a tile issues: current, 2 boxes of
//   43,520 bytes and 18 slices of 8 KiB per 72 k16 steps of 2*256*64*16 FLOP
//   = 6.2e-3 B/FLOP, 63% of it weights from L2; folded, one box per 48 steps
//   (its weights once a block) = 1.8e-3.
//
// dh_fold_kernel<FOLDED> (the synchronous body, for unaligned weights and
// the private _legacy comparison; x must be 16-byte aligned): a block owns
// TH x TW = 8 x 64 output pixels by the 64 outputs; warp r owns output row r
// (four 16-pixel A tiles by eight 8-wide B tiles, 128 float32 accumulators a
// thread), with mma.sync m16n8k16 products. K is walked in chunks of 32
// lanes (64 bytes, the conv kernels' staged chunk, conv3x3_common.cuh),
// between two __syncthreads each:
//   - current: per chunk of the 128-lane buffer the (8+2) x (64+2) window and
//     the chunk's nine (dh, dw) weight slices are staged; nine taps;
//   - folded: per chunk of the two K = 128 operands an 8 x (64+2) window of
//     the 64-lane buffer at row offset dh (0 or 1 for [x(dh0) | x(dh1)], 2 or
//     zeros for [x(dh2) | 0]) is staged with the chunk's three dw slices;
//     three taps.
// Its wrapper packs the weights as [chunk][tap][o][32 lanes] so that the B
// fragments are ldmatrix rows.

#include "conv3x3_common.cuh"
#include "conv3x3_sm90.cuh"

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

// ---------------------------------------------------------------------------
// The Hopper body (see the note at the top).

constexpr int K7_CONSUMERS = 256;               // two warpgroups, warp r: output row r
constexpr int K7_THREADS = K7_CONSUMERS + 128;  // and the producer warpgroup
constexpr int K7_PRODUCER_REGS = 40;            // setmaxnreg: 128*40 + 256*232 <= 64K
constexpr int K7_CONSUMER_REGS = 232;
constexpr int K7_HSTAGES = 3;                   // halo ring: one 64-lane box a slot
constexpr int K7_WSLOTS = 12;                   // folded's resident boxes, current's ring
constexpr int K7_WBOX = sm90::CHUNK * LS * 2;   // 64 channels x 64 outputs (8 KiB)
constexpr int K7_HALO = sm90::HALO_SLOT;        // 64 channels x 34 columns x 10 rows
constexpr int K7_RING = K7_HSTAGES * K7_HALO;   // offsets from the 1 KiB aligned base
constexpr int K7_BARS = K7_RING + K7_WSLOTS * K7_WBOX;
constexpr int K7_WTOTAL = 3 * LS;               // W's columns: dw groups of 64 outputs
static_assert(K7_HALO % 1024 == 0 && K7_WBOX % 1024 == 0, "slots on 1 KiB boundaries");

// Shared memory of one block, either kernel: the halo ring, the weight slots
// and a full and an empty barrier for each (ops/kernels/sm90_plan.py mirrors
// this).
constexpr int k7_smem_bytes() {
  return sm90::ALIGN_SLACK + K7_BARS + 2 * (K7_HSTAGES + K7_WSLOTS) * 8;
}
static_assert(k7_smem_bytes() <= sm90::SMEM_LIMIT, "one block's shared memory");

struct DhDims {
  int HO, WO, tiles_w, tiles_h, tiles;
};

// Ring geometry. The block's f-th halo box sits in slot f % 3, phase
// (f / 3) % 2; current's it-th weight slice in slot it % 12, phase (it / 12)
// % 2; folded's twelve boxes land once on w_full(0). A consumer waits for a
// phase of a full barrier, the producer for the other phase of the empty one
// (a fresh barrier completes it at once).
__device__ __forceinline__ uint32_t halo_full(uint32_t base, int s) {
  return base + K7_BARS + 8 * s;
}
__device__ __forceinline__ uint32_t halo_empty(uint32_t base, int s) {
  return base + K7_BARS + 8 * (K7_HSTAGES + s);
}
__device__ __forceinline__ uint32_t w_full(uint32_t base, int s) {
  return base + K7_BARS + 8 * (2 * K7_HSTAGES + s);
}
__device__ __forceinline__ uint32_t w_empty(uint32_t base, int s) {
  return base + K7_BARS + 8 * (2 * K7_HSTAGES + K7_WSLOTS + s);
}
__device__ __forceinline__ uint32_t w_slot(uint32_t base, int s) {
  return base + K7_RING + s * K7_WBOX;
}
// folded's resident box of pass p (0: w01, 1: w2), K half k (64 rows) and dw
__device__ __forceinline__ int folded_slot(int pass, int half, int dw) {
  return (pass * 2 + half) * 3 + dw;
}

// Tile u of the walk: (image, first output row, first output column), the
// columns fastest.
struct Tile {
  int n, h0, w0;
};

__device__ __forceinline__ Tile tile_at(const DhDims& d, int u) {
  const int tx = u % d.tiles_w;
  const int t = u / d.tiles_w;
  return Tile{t / d.tiles_h, (t % d.tiles_h) * TH, tx * TW};
}

// The producer thread. Folded: its twelve weight boxes once, then one halo
// box a tile. Current: per tile and 64-lane chunk the halo box, then the
// chunk's nine (dh, dw) weight slices in the consumers' order. Both run
// ahead as far as the rings allow, into the next tile while the consumers
// store this one.
template <bool FOLDED>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* xmap,
                                        const CUtensorMap* wmap0, const CUtensorMap* wmap1,
                                        const DhDims& d) {
  using namespace conv3x3::sm90;
  if constexpr (FOLDED) {
    mbar_expect_tx(w_full(base, 0), K7_WSLOTS * K7_WBOX);
    for (int pass = 0; pass < 2; ++pass)
      for (int half = 0; half < 2; ++half)
        for (int dw = 0; dw < 3; ++dw)
          tma_load_3d(w_slot(base, folded_slot(pass, half, dw)), pass ? wmap1 : wmap0,
                      w_full(base, 0), dw * LS, half * CHUNK, 0);
  }
  constexpr int CHUNKS = FOLDED ? 1 : 2;
  int f = 0, it = 0;
  for (int u = blockIdx.x; u < d.tiles; u += gridDim.x) {
    const Tile t = tile_at(d, u);
    for (int ch = 0; ch < CHUNKS; ++ch, ++f) {
      const int hs = f % K7_HSTAGES;
      mbar_wait(halo_empty(base, hs), ((f / K7_HSTAGES) & 1) ^ 1);
      mbar_expect_tx(halo_full(base, hs), HALO_BYTES);
      tma_load_4d(base + hs * K7_HALO, xmap, halo_full(base, hs), ch * CHUNK, t.w0, t.h0, t.n);
      if constexpr (!FOLDED) {
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % K7_WSLOTS;
          mbar_wait(w_empty(base, s), ((it / K7_WSLOTS) & 1) ^ 1);
          mbar_expect_tx(w_full(base, s), K7_WBOX);
          tma_load_3d(w_slot(base, s), wmap0, w_full(base, s), (tap % 3) * LS, ch * CHUNK,
                      tap / 3);
        }
      }
    }
  }
}

// A of one 64-channel K range: the 16 pixels of this warp's output row
// `wrow` in each 16-column half, at box row wrow + dh and column offset dw, as
// four k16 steps, by ldmatrix from the swizzled box; or (zero) zero registers,
// the zero half of folded's [x(dh2) | 0].
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4][4], uint32_t box, int wrow, int dh,
                                       int dw, bool zero, int lane) {
  using namespace conv3x3::sm90;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = (wrow + dh) * HALO_W + mt * 16 + dw + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (zero) {
        a[mt][kk][0] = a[mt][kk][1] = a[mt][kk][2] = a[mt][kk][3] = 0u;
      } else {
        ldsm_x4(a[mt][kk], swizzled(box, p, kk * 2 + (lane >> 4)));
      }
    }
  }
}

// acc += A * B, B the 64-channel x 64-output weight box at `slot`: eight
// wgmma m64n64k16 (four k16 steps by two m-tiles), committed as one group and
// not waited for.
__device__ __forceinline__ void issue_unit(float (&acc)[2][32], const uint32_t (&a)[2][4][4],
                                           uint32_t slot) {
  using namespace conv3x3::sm90;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // B: 16 rows (channels) of the box
    const uint64_t desc = desc_sw128(slot + kk * 16 * BOX_ROW, K7_WBOX, 1024);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) wgmma_m64n64k16_rs_tb(acc[mt], a[mt][kk], desc);
  }
  wgmma_commit();
}

// The units of a tile, each one 64-channel K range of A against one weight
// box (eight wgmmas). Current: unit j = 9 * chunk + 3 * dh + dw of the
// tile's two halo boxes, its weights the next slice of the ring. Folded:
// unit j = 6 * pass + 2 * dw + half, A rows dh = 2 * pass + half of the one
// box (pass 1, half 1: zeros), its weights resident box folded_slot(pass,
// half, dw).
template <bool FOLDED>
struct TileUnits {
  static constexpr int COUNT = FOLDED ? 12 : 18;
  __device__ static constexpr int chunk(int j) { return FOLDED ? 0 : j / 9; }
  __device__ static constexpr int dh(int j) { return FOLDED ? 2 * (j / 6) + j % 2 : (j % 9) / 3; }
  __device__ static constexpr int dw(int j) { return FOLDED ? (j % 6) / 2 : j % 3; }
  __device__ static constexpr bool zero(int j) { return FOLDED && j / 6 == 1 && j % 2 == 1; }
  __device__ static constexpr bool chunk_start(int j) { return FOLDED ? j == 0 : j % 9 == 0; }
  __device__ static constexpr bool chunk_end(int j) { return FOLDED ? j == 11 : j % 9 == 8; }
};

// The dh-fold probe on Hopper (see the note at the top). wmap1: w2's map
// (folded), unused by current.
template <bool FOLDED>
__global__ void __launch_bounds__(K7_THREADS, 1)
dh_fold_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap0,
                    const __grid_constant__ CUtensorMap wmap1, T* __restrict__ y,
                    const DhDims d) {
  using namespace conv3x3::sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K7_HSTAGES; ++s) {
      mbar_init(halo_full(base, s), 1);
      mbar_init(halo_empty(base, s), K7_CONSUMERS / 32);  // every consumer warp
    }
    for (int s = 0; s < K7_WSLOTS; ++s) {
      mbar_init(w_full(base, s), 1);
      mbar_init(w_empty(base, s), K7_CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warp >= K7_CONSUMERS / 32) {
    setmaxnreg_dec<K7_PRODUCER_REGS>();
    if (warp == K7_CONSUMERS / 32 && lane == 0) produce<FOLDED>(base, &xmap, &wmap0, &wmap1, d);
    return;
  }
  setmaxnreg_inc<K7_CONSUMER_REGS>();
  using U = TileUnits<FOLDED>;
  const int g = lane >> 2;
  const int q = lane & 3;
  float acc[2][32];
  uint32_t a[2][2][4][4];  // two A sets: unit j's loads overlap unit j - 1's wgmmas
  int f = 0, it = 0;       // halo boxes and streamed weight slices of the walk so far
  for (int u = blockIdx.x; u < d.tiles; u += gridDim.x) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
      fence_regs(acc[mt]);  // zeroed before the first wgmma's fence
    }
    // Step j loads A of unit j, waits for its weights and issues its wgmmas,
    // then waits until unit j - 1's are complete (one group stays in flight)
    // and releases unit j - 1's weight slice and, after a chunk's last unit,
    // its halo box.
#pragma unroll
    for (int j = 0; j <= U::COUNT; ++j) {
      if (j < U::COUNT) {
        const int hf = f + U::chunk(j);  // the unit's halo box in the walk
        const int hs = hf % K7_HSTAGES;
        if (U::chunk_start(j)) mbar_wait(halo_full(base, hs), (hf / K7_HSTAGES) & 1);
        load_a(a[j & 1], base + hs * K7_HALO, warp, U::dh(j), U::dw(j), U::zero(j), lane);
        if constexpr (FOLDED) {
          if (j == 0) mbar_wait(w_full(base, 0), 0);
          issue_unit(acc, a[j & 1], w_slot(base, folded_slot(j / 6, j % 2, U::dw(j))));
        } else {
          const int s = (it + j) % K7_WSLOTS;
          mbar_wait(w_full(base, s), ((it + j) / K7_WSLOTS) & 1);
          issue_unit(acc, a[j & 1], w_slot(base, s));
        }
      }
      if (j > 0) {
        if (j < U::COUNT)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(a[(j - 1) & 1][mt][kk]);
        if (lane == 0) {
          if (!FOLDED) mbar_arrive(w_empty(base, (it + j - 1) % K7_WSLOTS));
          if (U::chunk_end(j - 1))
            mbar_arrive(halo_empty(base, (f + U::chunk(j - 1)) % K7_HSTAGES));
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) fence_regs(acc[mt]);
    f += U::chunk(U::COUNT - 1) + 1;
    if (!FOLDED) it += U::COUNT;

    // Epilogue: accumulator element i of m-tile mt is pixel column w0 + mt*16
    // + g + 8*((i%4)/2), output channel 8*(i/4) + 2q + i%2; rounded once.
    const Tile t = tile_at(d, u);
    T* const yr = y + ((static_cast<size_t>(t.n) * d.HO + t.h0 + warp) * d.WO + t.w0) * LS;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        T* const yp = yr + (mt * 16 + g + half * 8) * LS + 2 * q;
#pragma unroll
        for (int nb = 0; nb < LS / 8; ++nb)
          store_pair(yp + nb * 8, acc[mt][nb * 4 + half * 2], acc[mt][nb * 4 + half * 2 + 1]);
      }
  }
}

// W (taps, 128, 192) bf16, read in place, as dims (192, 128, taps): the
// outputs contiguous; boxes of 64 outputs x 64 channels of one tap.
bool weight_map(CUtensorMap* map, const void* w, int taps) {
  const cuuint64_t dims[3] = {K7_WTOTAL, 2 * sm90::CHUNK, static_cast<cuuint64_t>(taps)};
  const cuuint64_t strides[2] = {K7_WTOTAL * 2, K7_WTOTAL * 2 * sm90::CHUNK * 2};
  const cuuint32_t box[3] = {LS, sm90::CHUNK, 1};
  return sm90::encode_bf16(map, w, 3, dims, strides, box);
}

template <bool FOLDED>
int launch_sm90(const void* x, const void* w0, const void* w1, void* y, int N, int HP, int WP,
                int blocks, void* stream) {
  const int lanes = FOLDED ? 64 : 128;
  const int HO = HP - 2;
  const int WO = WP - 8;
  if (N < 1 || HO < TH || WO < TW || HO % TH != 0 || WO % TW != 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(N) * (HO / TH) * (WO / TW);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap0, wmap1;
  if (!sm90::nhwc_map(&xmap, x, unframed(HP, WP, lanes), N, HP, WP, lanes, HALO_W, TH + 2) ||
      !weight_map(&wmap0, w0, FOLDED ? 1 : 3) ||
      !weight_map(&wmap1, FOLDED ? w1 : w0, FOLDED ? 1 : 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const DhDims d{HO, WO, WO / TW, HO / TH, static_cast<int>(tiles)};
  auto kernel = dh_fold_sm90_kernel<FOLDED>;
  constexpr int smem = k7_smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles < blocks ? tiles : blocks));
  kernel<<<grid, K7_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap0, wmap1, static_cast<T*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The synchronous body. x: (N, HP, WP, 128) bf16 for _current, (N, HP, WP,
// 64) for _folded, with HP - 2 a multiple of 8 and WP - 8 of 64; wk: the
// packed weights, bf16 [chunk][tap][64][32]: (4, 9, 64, 32) for _current
// (tap = 3*dh + dw), (8, 3, 64, 32) for _folded (the four chunks of w01, then
// of w2; tap = dw); y: (N, HP-2, WP-8, 64) bf16. Returns the cudaError_t of
// the launch.
extern "C" int dh_fold_current(const void* x, const void* wk, void* y, int N, int HP, int WP,
                               void* stream) {
  return launch<false>(x, wk, y, N, HP, WP, 128, stream);
}

extern "C" int dh_fold_folded(const void* x, const void* wk, void* y, int N, int HP, int WP,
                              void* stream) {
  return launch<true>(x, wk, y, N, HP, WP, 64, stream);
}

// The Hopper body: x as above (HP - 2 a multiple of 8, WP - 8 of 32), 16-byte
// aligned; w (3, 128, 192) bf16, or w01 and w2 (1, 128, 192), read in place;
// y: (N, HP-2, WP-8, 64) bf16; blocks: the persistent blocks to launch (at
// most one per 8x32 tile). Returns the cudaError_t of the launch.
extern "C" int dh_fold_sm90_current(const void* x, const void* w, void* y, int N, int HP, int WP,
                                    int blocks, void* stream) {
  return launch_sm90<false>(x, w, nullptr, y, N, HP, WP, blocks, stream);
}

extern "C" int dh_fold_sm90_folded(const void* x, const void* w01, const void* w2, void* y,
                                   int N, int HP, int WP, int blocks, void* stream) {
  return launch_sm90<true>(x, w01, w2, y, N, HP, WP, blocks, stream);
}
