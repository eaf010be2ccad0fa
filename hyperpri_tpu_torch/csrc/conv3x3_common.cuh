// Device code shared by the 3x3 convolution kernels: conv3x3_packed.cu,
// conv3x3.cu (forward and adjoint convs) and conv3x3_grad.cu (weight gradient).
//
// All of them read NHWC bf16 activations without any padded copy in device
// memory: a block stages a window of pixels (zero outside the image and past
// the last channel) into shared memory, optionally applying the BatchNorm
// affine + ReLU prologue z = relu(pa*x + pb) on the way, and feeds bf16
// mma.sync m16n8k16 products with float32 accumulators from it.
//
// Every activation operand is a framed view (struct Frame): its logical
// (H, W, C) tensor may sit at a row and column offset inside a larger buffer
// with a wider channel pitch. That is how the JAX package's framings map
// here: the host pre-padded ingest buffer (logical (0,0) at (1,1), channel
// pitch 256), the arena buffers that hand a conv's output to the next kernel
// without a slice or pad pass (logical (0,0) at (8,8)), and plain tensors
// (offset 0, pitch C). Staging reads only the logical region and zero-fills
// everything else by select, never by multiplying, so a frame holding NaN
// never reaches a product.
//
// Per-channel sums (BatchNorm statistics, affine gradients, weight-gradient
// partials) are never accumulated with float atomics: every block writes its
// partial sums to a float32 buffer and reduce_rows_kernel adds the rows in a
// fixed order, so two runs on the same inputs give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3 {

constexpr int TH = 8;           // output rows per block, one warp each
constexpr int TW = 32;          // output columns per block: two 16-row MMA tiles
constexpr int KC = 32;          // input channels staged per step (forward)
constexpr int KS = KC + 8;      // shared row stride in elements (80 bytes)
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;
constexpr int THREADS = TH * 32;

// Epilogue modes of the forward kernel.
constexpr int MODE_PLAIN = 0;   // y = act(acc + bias)
constexpr int MODE_STATS = 1;   // y = acc + bias, plus sum(y) and sum(y*y) per channel
constexpr int MODE_BWD = 2;     // affine + ReLU backward on the accumulator (no bias)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// relu(a*x + b) as the plain PyTorch version computes it: a float32 product
// rounded, then a float32 sum rounded (no fused multiply-add), NaN kept.
__device__ __forceinline__ float affine_relu(float x, float a, float b) {
  const float v = __fadd_rn(__fmul_rn(x, a), b);
  return v < 0.0f ? 0.0f : v;
}

__device__ __forceinline__ uint32_t affine_relu_pair(uint32_t packed, const float* pa,
                                                     const float* pb, int c) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  const __nv_bfloat162 z = __floats2bfloat162_rn(
      affine_relu(v.x, __ldg(pa + c), __ldg(pb + c)),
      affine_relu(v.y, __ldg(pa + c + 1), __ldg(pb + c + 1)));
  return *reinterpret_cast<const uint32_t*>(&z);
}

// A framed NHWC view: element c of logical pixel (n, h, w) lives at
// ((n*rows + r0 + h)*cols + c0 + w)*pitch + c of the buffer. An unframed
// (N, H, W, C) tensor is {H, W, C, 0, 0}.
struct Frame {
  int rows, cols, pitch, r0, c0;
};

// Offset of image n's logical pixel (0, 0). Within an image the kernels index
// in 32-bit ints, (h * cols + w) * pitch + c: a framed image must hold fewer
// than 2^31 elements (frame_ok).
__host__ __device__ __forceinline__ size_t image_offset(const Frame& f, int n) {
  return ((static_cast<size_t>(n) * f.rows + f.r0) * f.cols + f.c0) *
         static_cast<size_t>(f.pitch);
}

inline Frame unframed(int H, int W, int C) { return Frame{H, W, C, 0, 0}; }

// A frame is usable for a logical (H, W, C) tensor when it covers it and an
// image of it is indexable in 32 bits.
inline bool frame_ok(const Frame& f, int H, int W, int C) {
  return f.r0 >= 0 && f.c0 >= 0 && f.rows >= f.r0 + H && f.cols >= f.c0 + W && f.pitch >= C &&
         static_cast<long long>(f.rows) * f.cols * f.pitch < (1LL << 31);
}

template <int VEC>
struct Packed;
template <>
struct Packed<8> { using type = uint4; };
template <>
struct Packed<2> { using type = uint32_t; };
template <>
struct Packed<1> { using type = uint16_t; };

__device__ __forceinline__ uint16_t affine_relu_one(uint16_t bits, const float* pa,
                                                    const float* pb, int c) {
  const float x = __uint_as_float(static_cast<uint32_t>(bits) << 16);
  const __nv_bfloat16 z = __float2bfloat16_rn(affine_relu(x, __ldg(pa + c), __ldg(pb + c)));
  return *reinterpret_cast<const uint16_t*>(&z);
}

// Stage src[h_start : h_start+ROWS, w_start : w_start+COLS, c0 : c0+NCH] of
// one logical (H, W, C) image into dst[pixel][STRIDE], zero outside the image
// and past C. src points at the image's logical pixel (0, 0); rows are
// row_pitch elements apart and pixels pitch. VEC elements per load (f.pitch % VEC == 0,
// c0 % VEC == 0, and either C % VEC == 0 or the buffer's lanes from C to the
// next multiple of VEC are zero, see load_width). With
// PRO, in-image elements become relu(pa[c]*x + pb[c]) rounded to bf16; the
// zero border stays exact zero. The trip count is a compile-time constant and
// the loads of a batch are all issued before the first of them is used, so a
// thread keeps up to 16 loads in flight. blockDim.x == THREADS.
template <int VEC, int NCH, int STRIDE, int ROWS, int COLS, bool PRO>
__device__ __forceinline__ void stage_window(__nv_bfloat16* __restrict__ dst,
                                             const __nv_bfloat16* __restrict__ src,
                                             int row_pitch, int pitch, int H, int W, int C,
                                             int h_start, int w_start, int c0,
                                             const float* __restrict__ pa,
                                             const float* __restrict__ pb) {
  using P = typename Packed<VEC>::type;
  constexpr int GROUPS = NCH / VEC;
  constexpr int TOTAL = ROWS * COLS * GROUPS;
  constexpr int ITERS = (TOTAL + THREADS - 1) / THREADS;
  constexpr int BATCHES = (ITERS + 15) / 16;   // equal batches of at most 16 loads
  constexpr int BATCH = (ITERS + BATCHES - 1) / BATCHES;
  const P* __restrict__ in = reinterpret_cast<const P*>(src);
#pragma unroll 1
  for (int it0 = 0; it0 < ITERS; it0 += BATCH) {
    P v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = (it0 + k) * THREADS + threadIdx.x;
      const int px = i / GROUPS;
      const int g = i - px * GROUPS;
      const int hh = h_start + px / COLS;
      const int ww = w_start + px % COLS;
      const int c = c0 + g * VEC;
      const bool inside = i < TOTAL && hh >= 0 && hh < H && ww >= 0 && ww < W && c < C;
      v[k] = P();
      if (inside) v[k] = in[(hh * row_pitch + ww * pitch + c) / VEC];
      if constexpr (PRO) {
        if (inside) {
          if constexpr (VEC == 8) {
            v[k].x = affine_relu_pair(v[k].x, pa, pb, c);
            v[k].y = affine_relu_pair(v[k].y, pa, pb, c + 2);
            v[k].z = affine_relu_pair(v[k].z, pa, pb, c + 4);
            v[k].w = affine_relu_pair(v[k].w, pa, pb, c + 6);
          } else if constexpr (VEC == 2) {
            v[k] = affine_relu_pair(v[k], pa, pb, c);
          } else {
            v[k] = affine_relu_one(v[k], pa, pb, c);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = (it0 + k) * THREADS + threadIdx.x;
      if (i < TOTAL) {
        const int px = i / GROUPS;
        const int g = i - px * GROUPS;
        *reinterpret_cast<P*>(dst + px * STRIDE + g * VEC) = v[k];
      }
    }
  }
}

// stage_window with the load width and the prologue chosen at run time
// (uniform over the block, decided outside the unrolled loops).
template <int NCH, int STRIDE, int ROWS, int COLS, int VEC>
__device__ __forceinline__ void stage_pro(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row_pitch, int pitch, int H, int W, int C,
                                          int h_start, int w_start, int c0, const float* pa,
                                          const float* pb) {
  if (pa != nullptr)
    stage_window<VEC, NCH, STRIDE, ROWS, COLS, true>(dst, src, row_pitch, pitch, H, W, C,
                                                     h_start, w_start, c0, pa, pb);
  else
    stage_window<VEC, NCH, STRIDE, ROWS, COLS, false>(dst, src, row_pitch, pitch, H, W, C,
                                                      h_start, w_start, c0, pa, pb);
}

template <int NCH, int STRIDE, int ROWS, int COLS>
__device__ __forceinline__ void stage_any(int vec, __nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row_pitch, int pitch,
                                          int H, int W, int C, int h_start, int w_start,
                                          int c0, const float* pa, const float* pb) {
  if (vec == 8)
    stage_pro<NCH, STRIDE, ROWS, COLS, 8>(dst, src, row_pitch, pitch, H, W, C, h_start,
                                          w_start, c0, pa, pb);
  else if (vec == 2)
    stage_pro<NCH, STRIDE, ROWS, COLS, 2>(dst, src, row_pitch, pitch, H, W, C, h_start,
                                          w_start, c0, pa, pb);
  else
    stage_pro<NCH, STRIDE, ROWS, COLS, 1>(dst, src, row_pitch, pitch, H, W, C, h_start,
                                          w_start, c0, pa, pb);
}

// Widest load a framed bf16 view at `ptr` allows: 8, 2 or 1 elements. A load
// may reach past the last logical channel only when `lanes_zero` says the
// buffer holds zeros there (the pre-padded ingest buffer: C = 238 in a
// 256-channel pitch then takes 16-byte loads).
inline int load_width(const void* ptr, int C, int pitch, bool lanes_zero) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ptr);
  if (pitch % 8 == 0 && addr % 16 == 0 && (C % 8 == 0 || lanes_zero)) return 8;
  if (pitch % 2 == 0 && addr % 4 == 0 && (C % 2 == 0 || lanes_zero)) return 2;
  return 1;
}

// out[col] = sum over rows of partial[row][col], in a fixed order: thread
// (tx, ty) adds rows ty, ty + blockDim.y, ... of its column, then the
// blockDim.y partial sums are added in order. blockDim = (32, <= 32).
__global__ void reduce_rows_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int rows, int cols) {
  __shared__ float red[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (col < cols) {
#pragma unroll 4
    for (int r = threadIdx.y; r < rows; r += blockDim.y)
      s += partial[static_cast<size_t>(r) * cols + col];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float total = red[0][threadIdx.x];
    for (int r = 1; r < static_cast<int>(blockDim.y); ++r) total += red[r][threadIdx.x];
    out[col] = total;
  }
}

inline cudaError_t reduce_rows(const float* partial, float* out, int rows, int cols,
                               cudaStream_t stream) {
  int by = 1;
  while (by < 32 && by * 8 < rows) by *= 2;
  const dim3 block(32, by);
  reduce_rows_kernel<<<(cols + 31) / 32, block, 0, stream>>>(partial, out, rows, cols);
  return cudaGetLastError();
}

struct ConvDims {
  int H, W, C, Cp, O, OP, n_otiles, relu, mode;
  Frame fx, fy, fr;  // the views of x, y and (MODE_BWD) r
};

// One launch of the forward kernel, as the entry points fill it in.
struct ConvParams {
  const __nv_bfloat16* x;   // logical (N, H, W, C), framed by d.fx
  const __nv_bfloat16* wp;  // (9, OP, Cp) packed weights
  const float* bias;        // (O,)
  __nv_bfloat16* y;         // logical (N, H, W, O), framed by d.fy
  const float* pa;          // prologue affine (C,), or in MODE_BWD the (O,) affine
  const float* pb;
  const __nv_bfloat16* r;   // MODE_BWD: the saved producer output, framed by d.fr
  float* partial;           // reducing modes: (blocks, 2, OP)
  bool x_lanes_zero;        // x's buffer is zero from channel C on (load_width)
  ConvDims d;
};

template <int NP>
constexpr int conv_smem_bytes() {
  return (HALO_PIX + 9 * NP) * KS * static_cast<int>(sizeof(__nv_bfloat16));
}

// Stage wp[tap][o0 : o0+NP][c0 : c0+KC] into ws[tap*NP + o][KS] (16-byte
// loads; the packed weights are zero-padded, so no bounds checks are needed).
template <int NP>
__device__ __forceinline__ void load_weights(__nv_bfloat16* ws, const __nv_bfloat16* wp,
                                             int OP, int Cp, int o0, int c0) {
  constexpr int GROUPS = KC / 8;
  for (int i = threadIdx.x; i < 9 * NP * GROUPS; i += THREADS) {
    const int row = i / GROUPS;
    const int g = i - row * GROUPS;
    const int tap = row / NP;
    const int o = row - tap * NP;
    *reinterpret_cast<uint4*>(ws + row * KS + g * 8) = *reinterpret_cast<const uint4*>(
        wp + (static_cast<size_t>(tap) * OP + o0 + o) * Cp + c0 + g * 8);
  }
}

// A direct implicit GEMM (M = output pixels, N = output channels, K = 9*C).
// A block owns an 8x32 output tile of image n and the NP output channels from
// o0 = otile*NP; blockIdx = (W tile, H tile, n*n_otiles + otile). Each of its 8
// warps owns one output row (two 16-pixel MMA row tiles) by NP columns, with
// the f32 accumulators in registers. The input channels are walked in chunks
// of 32: the (8+2)x(32+2)x32 input halo and the 9x32xNP weight slice are
// staged in shared memory and the nine taps are nine shifted views of the
// halo, read by ldmatrix from rows padded to 80 bytes (no bank conflicts).
// VEC is the load width of the input (8, 2 or 1 elements, see load_width).
// The pointers are kernel parameters of their own, not members of a struct,
// so that the compiler knows they point to global memory and do not alias.
template <int NP, int VEC>
__global__ void __launch_bounds__(THREADS, NP == 64 ? 2 : 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
               const float* __restrict__ pa, const float* __restrict__ pb,
               const __nv_bfloat16* __restrict__ res, float* __restrict__ partial,
               const ConvDims p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = hs + HALO_PIX * KS;

  constexpr int NB = NP / 8;  // 8-wide MMA column tiles
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z / p.n_otiles;
  const int o0 = (blockIdx.z % p.n_otiles) * NP;
  const bool prologue = pa != nullptr && p.mode != MODE_BWD;
  const __nv_bfloat16* xn = x + image_offset(p.fx, n);

  float acc[2][NB][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][nb][r] = 0.0f;

  for (int c0 = 0; c0 < p.Cp; c0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
    stage_pro<KC, KS, TH + 2, HALO_W, VEC>(hs, xn, p.fx.cols * p.fx.pitch, p.fx.pitch, p.H,
                                           p.W, p.C, h0 - 1, w0 - 1, c0,
                                           prologue ? pa : nullptr, prologue ? pb : nullptr);
    load_weights<NP>(ws, wp, p.OP, p.Cp, o0, c0);
    __syncthreads();

#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dh = t / 3;
      const int dw = t % 3;
#pragma unroll
      for (int k = 0; k < KC; k += 16) {
        // A: 16 consecutive output pixels of this warp's row, shifted by the tap.
        uint32_t a[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int px = (warp + dh) * HALO_W + j * 16 + dw + (lane & 15);
          ldmatrix_x4(a[j], hs + px * KS + k + (lane >> 4) * 8);
        }
        // B: two 8-wide output-channel tiles per ldmatrix.
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          uint32_t b[4];
          const int row = t * NP + nb2 * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(b, ws + row * KS + k + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16_16816(acc[j][2 * nb2], a[j], b[0], b[1]);
            mma_bf16_16816(acc[j][2 * nb2 + 1], a[j], b[2], b[3]);
          }
        }
      }
    }
  }

  // Epilogue: accumulator element r of tile (j, nb) is pixel
  // (lane/4 + 8*(r/2)) of row tile j, output channel o0 + nb*8 + 2*(lane%4) + r%2.
  const int oh = h0 + warp;
  // o even, so a pair is in range and, with an even pitch, 4-byte aligned
  const bool pairs = (p.O & 1) == 0 && (p.fy.pitch & 1) == 0;
  __nv_bfloat16* const yn = y + image_offset(p.fy, n);

  if (p.mode == MODE_PLAIN) {
    if (oh >= p.H) return;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = w0 + j * 16 + (lane >> 2) + half * 8;
        if (ow >= p.W) continue;
        __nv_bfloat16* yp = yn + (oh * p.fy.cols + ow) * p.fy.pitch;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int o = o0 + nb * 8 + (lane & 3) * 2;
          if (o >= p.O) continue;
          float v0 = acc[j][nb][half * 2] + bias[o];
          if (p.relu) v0 = fmaxf(v0, 0.0f);
          if (pairs) {
            float v1 = acc[j][nb][half * 2 + 1] + bias[o + 1];
            if (p.relu) v1 = fmaxf(v1, 0.0f);
            *reinterpret_cast<__nv_bfloat162*>(yp + o) = __floats2bfloat162_rn(v0, v1);
          } else {
            yp[o] = __float2bfloat16_rn(v0);
            if (o + 1 < p.O) {
              float v1 = acc[j][nb][half * 2 + 1] + bias[o + 1];
              if (p.relu) v1 = fmaxf(v1, 0.0f);
              yp[o + 1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }
    return;
  }

  // Reducing modes. Each thread sums its four pixels of a channel pair, the
  // eight lanes that share the pair are added by shuffles, the eight warps
  // through shared memory in warp order, and the block writes one row of
  // `partial`: (2, OP) sums that reduce_rows_kernel adds over the blocks.
  //   MODE_STATS: v = acc + bias is stored rounded; sums of v and v*v, taken
  //     from the unrounded float32 value.
  //   MODE_BWD: dz = acc, m = (pa*r + pb > 0), dx = m*dz*pa is stored; sums of
  //     m*dz*r (dpa) and m*dz (dpb).
  __syncthreads();  // every warp is done with the staged tiles: reuse them
  float* red = reinterpret_cast<float*>(smem);  // [warp][2][NP]
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int o = o0 + nb * 8 + (lane & 3) * 2;
    float s[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    float bias_or_pa[2] = {0.0f, 0.0f};
    float pbv[2] = {0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (o + e < p.O) {
        bias_or_pa[e] = p.mode == MODE_STATS ? bias[o + e] : pa[o + e];
        if (p.mode == MODE_BWD) pbv[e] = pb[o + e];
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = w0 + j * 16 + (lane >> 2) + half * 8;
        if (oh >= p.H || ow >= p.W || o >= p.O) continue;
        const int ypix = (oh * p.fy.cols + ow) * p.fy.pitch;
        float out[2] = {0.0f, 0.0f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (o + e >= p.O) continue;
          const float v = acc[j][nb][half * 2 + e];
          if (p.mode == MODE_STATS) {
            out[e] = v + bias_or_pa[e];
            s[0][e] += out[e];
            s[1][e] += out[e] * out[e];
          } else {
            const float rr = __bfloat162float(
                res[image_offset(p.fr, n) + (oh * p.fr.cols + ow) * p.fr.pitch + o + e]);
            const bool m = __fadd_rn(__fmul_rn(rr, bias_or_pa[e]), pbv[e]) > 0.0f;
            const float mdz = m ? v : 0.0f;
            out[e] = mdz * bias_or_pa[e];
            s[0][e] += mdz * rr;
            s[1][e] += mdz;
          }
        }
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(yn + ypix + o) =
              __floats2bfloat162_rn(out[0], out[1]);
        } else {
          yn[ypix + o] = __float2bfloat16_rn(out[0]);
          if (o + 1 < p.O) yn[ypix + o + 1] = __float2bfloat16_rn(out[1]);
        }
      }
    }
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[st][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) red[(warp * 2 + st) * NP + nb * 8 + lane * 2 + e] = v;
      }
    }
  }
  __syncthreads();
  const size_t block_lin =
      (static_cast<size_t>(n) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int i = threadIdx.x; i < 2 * NP; i += THREADS) {
    const int st = i / NP;
    const int ch = i - st * NP;
    float total = 0.0f;
    for (int wq = 0; wq < TH; ++wq) total += red[(wq * 2 + st) * NP + ch];
    partial[(block_lin * 2 + st) * p.OP + o0 + ch] = total;
  }
}

// Launch the forward kernel and, in the reducing modes, the fixed-order sum of
// the blocks' partials into sums (2, OP). `partial_rows` is the row count the
// caller allocated `partial` with; it must equal the number of pixel tiles.
template <int NP, int VEC>
cudaError_t launch_conv_vec(const ConvParams& p, int N, int partial_rows, float* sums,
                            cudaStream_t stream) {
  auto kernel = conv3x3_kernel<NP, VEC>;
  constexpr int smem = conv_smem_bytes<NP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const ConvDims& d = p.d;
  if (!frame_ok(d.fx, d.H, d.W, d.C) || !frame_ok(d.fy, d.H, d.W, d.O) ||
      (d.mode == MODE_BWD && !frame_ok(d.fr, d.H, d.W, d.O)))
    return cudaErrorInvalidValue;
  const dim3 grid((d.W + TW - 1) / TW, (d.H + TH - 1) / TH, N * d.n_otiles);
  const long long tiles = static_cast<long long>(grid.x) * grid.y * N;
  if (grid.y > 65535 || N * d.n_otiles > 65535) return cudaErrorInvalidValue;
  if (d.mode != MODE_PLAIN && (partial_rows != tiles || p.partial == nullptr || sums == nullptr))
    return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, stream>>>(p.x, p.wp, p.bias, p.y, p.pa, p.pb, p.r, p.partial, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.mode == MODE_PLAIN) return err;
  return reduce_rows(p.partial, sums, partial_rows, 2 * d.OP, stream);
}

template <int NP>
cudaError_t launch_conv(const ConvParams& p, int N, int partial_rows, float* sums,
                        cudaStream_t stream) {
  const int vec = load_width(p.x, p.d.C, p.d.fx.pitch, p.x_lanes_zero);
  if (vec == 8) return launch_conv_vec<NP, 8>(p, N, partial_rows, sums, stream);
  if (vec == 2) return launch_conv_vec<NP, 2>(p, N, partial_rows, sums, stream);
  return launch_conv_vec<NP, 1>(p, N, partial_rows, sums, stream);
}

}  // namespace conv3x3
