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
// The TPU kernel's idea. Each dh tap is its own non-overlapping BlockSpec
// stream of the padded input (th rows, no halo), so Mosaic pipelines three
// plain DMAs instead of one overlapping window copy. Here a block owns an
// 8x32 output tile, and band dh of a channel chunk holds input rows
// h0-1+dh .. h0+6+dh and columns w0-1 .. w0+32 (8 x 34 pixels): no band of one
// dh overlaps another block's band of the same dh, and the block reads 24
// input rows where a halo kernel reads 10. The dw taps are column offsets
// into a band. Three kernel bodies; the wrapper picks one by dtype and layout
// before the launch (ops/kernels/sm90_plan.py shift_plan), never on a
// failure.
//
// conv3x3_shift_sm90_kernel (bf16 with C % 8 == 0 and O % 8 == 0, output
// bf16 or float32) and conv3x3_shift_sm90_f32_kernel (float32 with C % 4 ==
// 0 and O % 4 == 0): an implicit GEMM, M = output pixels, N = output
// channels, K = 9*C, with kernel 2's block shape and roles and the Hopper
// pieces of conv3x3_sm90.cuh:
//   - two consumer warpgroups (warp r computes output row r, 2 x 16 pixels)
//     and a producer warpgroup, one thread of which issues the TMA loads
//     (setmaxnreg 40 / 232);
//   - each band is one TMA box of 8 rows x 34 columns x one 128-byte chunk of
//     channels (64 bf16 or 32 float32), 34,816 bytes, 128-byte swizzled, read
//     through a tensor map with a box height of 8 (the halo kernels' is 10);
//     TMA zero-fills rows, columns and channels outside the image, which is
//     the SAME border exactly. The bands stream through a ring of three
//     slots, one per dh, each completed on an mbarrier and released by the
//     consumers after the band's third dw tap. The producer issues each
//     band and then its three slices, in the consumers' order, as far ahead
//     as the rings allow: a band waits for the release of the band three
//     before it (its slot), its slices for that of the band two before it
//     (their stages), so while the consumers work on one band the next band
//     with its slices and the band after it are in flight;
//   - the weights stream through a ring of six 16 KiB stages, the (O tile,
//     chunk, tap) slices of two bands; the layout is fixed, so every ring
//     address and barrier is a constant offset from one shared base. bf16:
//     read in place from w (3, 3, C, O), no packing pass, slices of 64
//     inputs x 128 outputs (load_slice_bf16). float32: the wrapper first
//     splits w into K-major TF32 hi and lo planes (2, 9, O, C)
//     (split_weights_tf32_kernel; the tf32 wgmma reads B only K-major),
//     slices of 32 inputs x 64 outputs from each plane (load_slice_f32);
//   - products: bf16, wgmma m64n128k16 with A (the band's pixels at column
//     offset dw) from registers by ldmatrix and B from shared memory
//     (tap_bf16); float32, 3xTF32 on wgmma m64n64k8, one chain of four K steps
//     a tap into a fresh fragment, added to the accumulators with adds rounded
//     to nearest (tap_f32, F32_GROUP), kernel 2's float32 arithmetic;
//   - persistent blocks, one per SM, walk work units of one pixel tile by
//     one O tile of 128 (bf16) or 64 (float32) outputs: units blockIdx.x,
//     blockIdx.x + gridDim.x, ..., the O tiles of a pixel tile adjacent. At
//     O = 256 in bf16 the second O tile's unit stages the bands again, from
//     L2, since its neighbour block reads them at the same time: keeping both
//     tiles' accumulators would take 256 floats a thread beside the A
//     registers, past the 232 that setmaxnreg grants the consumers. Units of
//     one O tile also make more of them than whole tiles would, so the last
//     wave of the 132 SMs is fuller; and the producer runs into the next
//     unit's bands and slices while the consumers store this one. (A first
//     version ran one unit a block with no loop around the accumulators:
//     ptxas, at its 168 registers a thread of a 384-thread block with 128
//     accumulators, spilled 120 bytes and serialized the wgmmas, C7512; the
//     same code inside a loop over units, as kernel 2's O-tile walk, does
//     neither.)
//   - epilogue: bias, optional ReLU, one rounding to the output type, channel
//     pairs stored from registers (store_tile); no atomics, so two runs give
//     the same bits.
//   Bytes staged per FLOP of a block (bands and weight slices, all from L2
//   after their first read). bf16, per 64-channel chunk: 3 bands x 272 pixels
//   x 128 bytes + 9 x 16 KiB of weights per 2*256*128*9*64 FLOP = 6.67e-3
//   B/FLOP, 1.32x kernel 2's Hopper body at O = 128 (5.06e-3): the TPU
//   kernel's "~3x input traffic", paid in L2. float32, per 32-channel chunk
//   and O tile of 64: the same bytes per 2*256*64*9*32 FLOP = 2.67e-2 B/FLOP
//   (kernel 2's float32 body 2.02e-2). Shared memory: 3 bands (102 KiB) and
//   6 slices (96 KiB), 199 KiB (k6_smem_bytes, mirrored by
//   sm90_plan.k6_smem_bytes; bands and slices have the same bytes in both
//   dtypes, so the two bodies share the sum).
//
// conv3x3_shift_kernel<T, TO, NP, VEC> (the synchronous body, for layouts
// TMA cannot address, e.g. C = 238 bf16 (476-byte pixels) or C = 61, and
// for the private _legacy comparison): a block owns an 8x32 tile by NP output
// channels (64 when O <= 64, else 128, the output tiles on blockIdx.z) and for
// each 64-byte chunk of input channels stages the three bands with plain
// loads, then the chunk's nine packed weight slices (wp[tap][o][c] in x's
// type), between two __syncthreads; the products are conv3x3_common.cuh's
// mma.sync fragments (bf16 m16n8k16, or 3xTF32 on m16n8k8 for float32): warp
// r owns output row h0+r, and the A fragment of tap (dh, dw) is row r of band
// dh shifted by dw columns.

#include "conv3x3_common.cuh"
#include "conv3x3_sm90.cuh"

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


// ---------------------------------------------------------------------------
// The Hopper bodies (see the note at the top).

constexpr int K6_CONSUMERS = 256;               // two warpgroups, warp r: output row r
constexpr int K6_THREADS = K6_CONSUMERS + 128;  // and the producer warpgroup
constexpr int K6_PRODUCER_REGS = 40;            // setmaxnreg: 128*40 + 256*232 <= 64K
constexpr int K6_CONSUMER_REGS = 232;
constexpr int K6_BAND_BYTES = TH * HALO_W * conv3x3::sm90::BOX_ROW;  // 8 x 34 pixels
constexpr int K6_BSTAGES = 3;                   // band ring: one slot per dh
constexpr int K6_WSTAGES = 6;                   // weight ring: the slices of two bands
constexpr int K6_WSTAGE = conv3x3::sm90::BF16_WSTAGE;  // one weight slice
constexpr int K6_RING = K6_BSTAGES * K6_BAND_BYTES;    // offsets from the 1 KiB aligned base
constexpr int K6_BARS = K6_RING + K6_WSTAGES * K6_WSTAGE;
static_assert(K6_BAND_BYTES % 1024 == 0, "every band slot starts on a 1 KiB boundary");
static_assert(conv3x3::sm90::F32_WSTAGE == K6_WSTAGE, "both dtypes' slices take one stage");

struct ShiftDims {
  int H, W, O, n_chunks, n_otiles, tiles_w, tiles_h, units, relu;
};

// Shared memory of one block, either dtype: the band ring, the weight ring and
// a full and an empty barrier for each of their stages (ops/kernels/
// sm90_plan.py mirrors this).
constexpr int k6_smem_bytes() {
  return conv3x3::sm90::ALIGN_SLACK + K6_RING + K6_WSTAGES * K6_WSTAGE +
         2 * (K6_BSTAGES + K6_WSTAGES) * 8;
}

// Ring geometry, all offsets from the block's 1 KiB aligned shared base. The
// block's f-th band (chunk f / 3 of its walk, dh f % 3) sits in slot dh,
// which each chunk fills once, so its phase is the chunk's parity; slice it =
// 3f + dw sits in stage it % 6, phase (it / 6) % 2. A consumer waits for that
// phase of the full barrier, the producer for the other phase of the empty
// one (a fresh barrier completes it at once).
__device__ __forceinline__ uint32_t band_full(uint32_t base, int dh) {
  return base + K6_BARS + 8 * dh;
}
__device__ __forceinline__ uint32_t band_empty(uint32_t base, int dh) {
  return base + K6_BARS + 8 * (K6_BSTAGES + dh);
}
__device__ __forceinline__ uint32_t w_full(uint32_t base, int s) {
  return base + K6_BARS + 8 * (2 * K6_BSTAGES + s);
}
__device__ __forceinline__ uint32_t w_empty(uint32_t base, int s) {
  return base + K6_BARS + 8 * (2 * K6_BSTAGES + K6_WSTAGES + s);
}

// The block's aligned shared base, its barriers initialised.
__device__ __forceinline__ uint32_t init_rings(unsigned char* smem_raw) {
  using namespace conv3x3::sm90;
  const uint32_t raw = conv3x3::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    for (int dh = 0; dh < K6_BSTAGES; ++dh) {
      mbar_init(band_full(base, dh), 1);
      mbar_init(band_empty(base, dh), K6_CONSUMERS / 32);  // every consumer warp
    }
    for (int s = 0; s < K6_WSTAGES; ++s) {
      mbar_init(w_full(base, s), 1);
      mbar_init(w_empty(base, s), K6_CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  return base;
}

// Work unit u: the 8x32 pixel tile and O tile of NT outputs, the O tiles of
// a pixel tile adjacent in the walk (so the blocks that share its bands run
// together and the second read of a band hits L2).
struct Unit {
  int n, h0, w0, o0;
};

template <int NT>
__device__ __forceinline__ Unit unit_at(const ShiftDims& d, int u) {
  const int ot = u % d.n_otiles;
  int t = u / d.n_otiles;
  const int tx = t % d.tiles_w;
  t /= d.tiles_w;
  return Unit{t / d.tiles_h, (t % d.tiles_h) * TH, tx * TW, ot * NT};
}

// The producer thread: for each unit of the block's walk (units blockIdx.x,
// blockIdx.x + gridDim.x, ...) and each band of it, in the consumers' order,
// the band (one box of 8 rows x 34 columns x KC channels, origin
// (chunk * KC, w0 - 1, h0 - 1 + dh, n)) and the weight slices of its three
// taps. It runs ahead as far as the rings allow, into the next unit while
// the consumers store this one.
template <bool F32>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* xmap,
                                        const CUtensorMap* wmap, const ShiftDims& d) {
  using namespace conv3x3::sm90;
  constexpr int KC = F32 ? F32_CHUNK : CHUNK;  // channels of a chunk
  constexpr int NT = F32 ? F32_N : BF16_N;     // outputs of an O tile
  int f = 0;                                   // bands of the walk so far
  for (int u = blockIdx.x; u < d.units; u += gridDim.x) {
    const Unit t = unit_at<NT>(d, u);
    for (int b = 0; b < 3 * d.n_chunks; ++b, ++f) {
      const int dh = b % 3;
      const int c0 = (b / 3) * KC;
      mbar_wait(band_empty(base, dh), ((f / 3) & 1) ^ 1);
      mbar_expect_tx(band_full(base, dh), K6_BAND_BYTES);
      tma_load_4d(base + dh * K6_BAND_BYTES, xmap, band_full(base, dh), c0, t.w0 - 1,
                  t.h0 - 1 + dh, t.n);
      for (int dw = 0; dw < 3; ++dw) {
        const int it = 3 * f + dw;
        const int s = it % K6_WSTAGES;
        const uint32_t stage = base + K6_RING + s * K6_WSTAGE;
        mbar_wait(w_empty(base, s), ((it / K6_WSTAGES) & 1) ^ 1);
        mbar_expect_tx(w_full(base, s), K6_WSTAGE);
        if constexpr (F32)
          load_slice_f32(stage, wmap, w_full(base, s), t.o0, c0, dh * 3 + dw);
        else
          load_slice_bf16(stage, wmap, w_full(base, s), t.o0, c0, dh * 3 + dw);
      }
    }
  }
}

// The consumers' walk over the same units: per unit, zero the accumulators
// (zero()), then for each band and tap dw tap(band address, dw, weight
// stage, its full barrier, phase), releasing the stage and, after the third
// tap, the band; then store(unit). (The walk is also what keeps ptxas from
// spilling: a consumer body with no loop around its accumulators, one unit
// a block, spilled 120 bytes and had its wgmmas serialized, C7512.)
template <int NT, typename Zero, typename Tap, typename Store>
__device__ __forceinline__ void consume(uint32_t base, const ShiftDims& d, int lane, Zero zero,
                                        Tap tap, Store store) {
  using namespace conv3x3::sm90;
  int f = 0;
  for (int u = blockIdx.x; u < d.units; u += gridDim.x) {
    zero();
    for (int b = 0; b < 3 * d.n_chunks; ++b, ++f) {
      const int dh = b % 3;
      mbar_wait(band_full(base, dh), (f / 3) & 1);
      const int first = 3 * (f & 1);  // the band's three stages
#pragma unroll 1
      for (int dw = 0; dw < 3; ++dw) {
        const int s = first + dw;
        tap(base + dh * K6_BAND_BYTES, dw, base + K6_RING + s * K6_WSTAGE, w_full(base, s),
            (f >> 1) & 1);
        if (lane == 0) mbar_arrive(w_empty(base, s));
      }
      if (lane == 0) mbar_arrive(band_empty(base, dh));
    }
    store(unit_at<NT>(d, u));
  }
}

// The bf16 shift conv on Hopper, output TO (bf16 or float32).
template <typename TO>
__global__ void __launch_bounds__(K6_THREADS, 1)
conv3x3_shift_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const float* __restrict__ bias, TO* __restrict__ y, const ShiftDims d) {
  using namespace conv3x3::sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = init_rings(smem_raw);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= K6_CONSUMERS / 32) {
    setmaxnreg_dec<K6_PRODUCER_REGS>();
    if (warp == K6_CONSUMERS / 32 && lane == 0) produce<false>(base, &xmap, &wmap, d);
    return;
  }
  setmaxnreg_inc<K6_CONSUMER_REGS>();
  float acc[2][64];
  consume<BF16_N>(
      base, d, lane,
      [&] {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[mt][i] = 0.0f;
      },
      [&](uint32_t band, int dw, uint32_t stage, uint32_t full, uint32_t parity) {
        tap_bf16(acc, band, warp, 0, dw, stage, full, parity, lane);
      },
      [&](const Unit& t) {
        store_tile<TO, BF16_N>(acc, y + static_cast<size_t>(t.n) * d.H * d.W * d.O, bias,
                               t.h0 + warp, t.w0, t.o0, d.H, d.W, d.O, d.relu, lane);
      });
}

// The float32 shift conv on Hopper (3xTF32), B from the weights' TF32 planes.
__global__ void __launch_bounds__(K6_THREADS, 1)
conv3x3_shift_sm90_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const float* __restrict__ bias, float* __restrict__ y,
                              const ShiftDims d) {
  using namespace conv3x3::sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = init_rings(smem_raw);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= K6_CONSUMERS / 32) {
    setmaxnreg_dec<K6_PRODUCER_REGS>();
    if (warp == K6_CONSUMERS / 32 && lane == 0) produce<true>(base, &xmap, &wmap, d);
    return;
  }
  setmaxnreg_inc<K6_CONSUMER_REGS>();
  float acc[2][32], frag[2][32];
  uint32_t a_hi[2][F32_GROUP][4], a_lo[2][F32_GROUP][4];
  consume<F32_N>(
      base, d, lane,
      [&] {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
      },
      [&](uint32_t band, int dw, uint32_t stage, uint32_t full, uint32_t parity) {
        tap_f32(acc, frag, a_hi, a_lo, band, warp, 0, dw, stage, full, parity, lane);
      },
      [&](const Unit& t) {
        store_tile<float, F32_N>(acc, y + static_cast<size_t>(t.n) * d.H * d.W * d.O, bias,
                                 t.h0 + warp, t.w0, t.o0, d.H, d.W, d.O, d.relu, lane);
      });
}

// w: the bf16 weights (3, 3, C, O) (bf16 x) or their TF32 planes (2, 9, O,
// C) (float32 x).
template <typename T, typename TO>
int shift_sm90(const void* x, const void* w, const void* b, void* y, int N, int H, int W, int C,
               int O, int relu, int blocks, void* stream) {
  using namespace conv3x3;
  constexpr bool F32 = is_f32<T>;
  constexpr int KC = F32 ? sm90::F32_CHUNK : sm90::CHUNK;
  constexpr int NT = F32 ? sm90::F32_N : sm90::BF16_N;
  constexpr int ALIGN = F32 ? 4 : 8;   // channels of 16 bytes: TMA strides, channel pairs
  if (N < 1 || H < 1 || W < 1 || C < 1 || C % ALIGN != 0 || O < 1 || O % ALIGN != 0 ||
      k6_smem_bytes() > sm90::SMEM_LIMIT ||
      !frame_ok(unframed(H, W, C), H, W, C) || !frame_ok(unframed(H, W, O), H, W, O) ||
      9LL * C * O > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_otiles = (O + NT - 1) / NT;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const long long units = static_cast<long long>(N) * tiles_h * tiles_w * n_otiles;
  if (blocks < 1 || units >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  const bool maps = F32 ? sm90::nhwc_map_f32(&xmap, x, unframed(H, W, C), N, H, W, C, HALO_W, TH) &&
                              sm90::planes_map_f32(&wmap, w, C, O)
                        : sm90::nhwc_map(&xmap, x, unframed(H, W, C), N, H, W, C, HALO_W, TH) &&
                              sm90::weight_map_bf16(&wmap, w, C, O);
  if (!maps) return static_cast<int>(cudaErrorInvalidValue);
  const ShiftDims d{H, W, O, (C + KC - 1) / KC, n_otiles, tiles_w, tiles_h,
                    static_cast<int>(units), relu};
  const dim3 grid(static_cast<unsigned>(units < blocks ? units : blocks));
  const int smem = k6_smem_bytes();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  cudaError_t err;
  if constexpr (F32) {
    err = cudaFuncSetAttribute(conv3x3_shift_sm90_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_shift_sm90_f32_kernel<<<grid, K6_THREADS, smem, s>>>(xmap, wmap, bf,
                                                                 static_cast<float*>(y), d);
  } else {
    err = cudaFuncSetAttribute(conv3x3_shift_sm90_kernel<TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_shift_sm90_kernel<TO><<<grid, K6_THREADS, smem, s>>>(xmap, wmap, bf,
                                                                 static_cast<TO*>(y), d);
  }
  return static_cast<int>(cudaGetLastError());
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

// The Hopper bodies: x (N, H, W, C) with C % 8 == 0 (bf16) or C % 4 == 0
// (float32) and O likewise; w: the (3, 3, C, O) bf16 weights, read in place
// (_bf16, _bf16_f32), or the (2, 9, O, C) TF32 hi and lo planes of the
// float32 weights (_f32; conv3x3_split_weights_tf32 in conv3x3.cu writes
// them); b: (O,) f32; y: (N, H, W, O) of the entry's output type; blocks:
// the persistent blocks to launch (at most one per work unit). Returns the
// cudaError_t of the launch.
extern "C" int conv3x3_shift_sm90_bf16(const void* x, const void* w, const void* b, void* y,
                                       int N, int H, int W, int C, int O, int relu, int blocks,
                                       void* stream) {
  return shift_sm90<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, N, H, W, C, O, relu, blocks,
                                                  stream);
}

extern "C" int conv3x3_shift_sm90_bf16_f32(const void* x, const void* w, const void* b, void* y,
                                           int N, int H, int W, int C, int O, int relu,
                                           int blocks, void* stream) {
  return shift_sm90<__nv_bfloat16, float>(x, w, b, y, N, H, W, C, O, relu, blocks, stream);
}

extern "C" int conv3x3_shift_sm90_f32(const void* x, const void* planes, const void* b, void* y,
                                      int N, int H, int W, int C, int O, int relu, int blocks,
                                      void* stream) {
  return shift_sm90<float, float>(x, planes, b, y, N, H, W, C, O, relu, blocks, stream);
}
