// Device code shared by the 3x3 convolution kernels: conv3x3_packed.cu,
// conv3x3.cu (forward and adjoint convs) and conv3x3_grad.cu (weight gradient).
//
// All of them read NHWC activations of one element type T, bf16 or float32,
// without any padded copy in device memory: a block stages a window of pixels
// (zero outside the image and past the last channel) into shared memory,
// optionally applying the BatchNorm affine + ReLU prologue z = relu(pa*x + pb)
// on the way, and feeds tensor-core products with float32 accumulators from
// it:
//   - bf16: one mma.sync m16n8k16 bf16 product per fragment pair;
//   - float32: 3xTF32 on mma.sync m16n8k8. Each operand is split into
//     hi = tf32(a) (round to nearest) and lo = tf32(a - hi), and the product is
//     computed as lo*hi + hi*lo + hi*hi: about 2^-21 relative per product,
//     where a single TF32 product would be off by about 2^-11. lo*lo (2^-22)
//     is dropped. Each K step's three products start from a zero fragment,
//     which is added to the float32 accumulator by rounded float adds
//     (mma_3xtf32).
// A shared-memory row is 80 bytes for both types (32 bf16 or 16 float32
// channels of a chunk plus 16 bytes of padding), so the ldmatrix row reads are
// conflict-free and the fragment addressing is the same in bytes: an m16n8k16
// bf16 fragment and an m16n8k8 tf32 fragment both cover 32 bytes of K.
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

#include <type_traits>

namespace conv3x3 {

constexpr int TH = 8;           // output rows per block, one warp each
constexpr int TW = 32;          // output columns per block: two 16-row MMA tiles
constexpr int ROW_BYTES = 80;   // shared row stride: a 64-byte chunk + 16 bytes
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;
constexpr int THREADS = TH * 32;

// Per element type: KC channels per staged chunk (64 bytes), KS the shared row
// stride in elements (80 bytes), MMA_K the channels of one MMA's K (32 bytes),
// VEC_MAX the elements of a 16-byte load.
template <typename T>
struct Elem {
  static constexpr int SIZE = static_cast<int>(sizeof(T));
  static constexpr int KC = 64 / SIZE;
  static constexpr int KS = ROW_BYTES / SIZE;
  static constexpr int MMA_K = 32 / SIZE;
  static constexpr int VEC_MAX = 16 / SIZE;
};

template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;

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

__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_rna(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

// A float32 fragment register (its bits) -> its TF32 high part and the TF32
// rounding of the remainder. f - hi is exact: both lie within a factor of 2.
__device__ __forceinline__ void split_tf32(uint32_t bits, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(bits);
  hi = tf32_rna(f);
  lo = tf32_rna(__fsub_rn(f, __uint_as_float(hi)));
}

template <int R>
__device__ __forceinline__ void split_tf32(const uint32_t (&v)[R], uint32_t (&hi)[R],
                                           uint32_t (&lo)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) split_tf32(v[i], hi[i], lo[i]);
}

// acc += a*b in 3xTF32: the two cross terms, then the large one, into a fresh
// fragment, which is then added to acc with float32 adds rounded to nearest.
// The tensor cores' accumulation does not round to nearest: with the whole K
// chained through it, a UNET step's logits at 608x968 were 1.2e-5 (rel L2)
// from float64, against 2.9e-6 for cuDNN + autograd in float32; from a fresh
// fragment each chain is one K step long, and the logits 1.7e-6 (chip_smoke.py
// phase j on an H100 80GB HBM3 at 700 W; PERF.md).
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32_1688(d, a_lo, b0_hi, b1_hi);
  mma_tf32_1688(d, a_hi, b0_lo, b1_lo);
  mma_tf32_1688(d, a_hi, b0_hi, b1_hi);
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = __fadd_rn(acc[r], d[r]);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// Two neighbouring outputs, 4-byte (bf16) or 8-byte (float32) aligned.
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
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

// The type of one load of BYTES bytes.
template <int BYTES>
struct Packed;
template <>
struct Packed<16> { using type = uint4; };
template <>
struct Packed<8> { using type = uint2; };
template <>
struct Packed<4> { using type = uint32_t; };
template <>
struct Packed<2> { using type = uint16_t; };

__device__ __forceinline__ uint16_t affine_relu_one(uint16_t bits, const float* pa,
                                                    const float* pb, int c) {
  const float x = __uint_as_float(static_cast<uint32_t>(bits) << 16);
  const __nv_bfloat16 z = __float2bfloat16_rn(affine_relu(x, __ldg(pa + c), __ldg(pb + c)));
  return *reinterpret_cast<const uint16_t*>(&z);
}

// The prologue on VEC float32 elements packed in P. At float32 the rounding
// to x's dtype is the identity.
template <int VEC, typename P>
__device__ __forceinline__ P affine_relu_f32(P v, const float* pa, const float* pb, int c) {
  union U {
    P p;
    float e[VEC];
  } u;
  u.p = v;
#pragma unroll
  for (int k = 0; k < VEC; ++k) u.e[k] = affine_relu(u.e[k], __ldg(pa + c + k), __ldg(pb + c + k));
  return u.p;
}

// Stage src[h_start : h_start+ROWS, w_start : w_start+COLS, c0 : c0+NCH] of
// one logical (H, W, C) image into dst[pixel][STRIDE], zero outside the image
// and past C. src points at the image's logical pixel (0, 0); rows are
// row_pitch elements apart and pixels pitch. VEC elements per load (f.pitch % VEC == 0,
// c0 % VEC == 0, and either C % VEC == 0 or the buffer's lanes from C to the
// next multiple of VEC are zero, see load_width). With
// PRO, in-image elements become relu(pa[c]*x + pb[c]) rounded to T; the
// zero border stays exact zero. The trip count is a compile-time constant and
// the loads of a batch are all issued before the first of them is used, so a
// thread keeps up to 16 loads in flight. blockDim.x == THREADS.
template <typename T, int VEC, int NCH, int STRIDE, int ROWS, int COLS, bool PRO>
__device__ __forceinline__ void stage_window(T* __restrict__ dst, const T* __restrict__ src,
                                             int row_pitch, int pitch, int H, int W, int C,
                                             int h_start, int w_start, int c0,
                                             const float* __restrict__ pa,
                                             const float* __restrict__ pb) {
  using P = typename Packed<VEC * static_cast<int>(sizeof(T))>::type;
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
          if constexpr (is_f32<T>) {
            v[k] = affine_relu_f32<VEC>(v[k], pa, pb, c);
          } else if constexpr (VEC == 8) {
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
template <typename T, int NCH, int STRIDE, int ROWS, int COLS, int VEC>
__device__ __forceinline__ void stage_pro(T* dst, const T* src, int row_pitch, int pitch, int H,
                                          int W, int C, int h_start, int w_start, int c0,
                                          const float* pa, const float* pb) {
  if (pa != nullptr)
    stage_window<T, VEC, NCH, STRIDE, ROWS, COLS, true>(dst, src, row_pitch, pitch, H, W, C,
                                                        h_start, w_start, c0, pa, pb);
  else
    stage_window<T, VEC, NCH, STRIDE, ROWS, COLS, false>(dst, src, row_pitch, pitch, H, W, C,
                                                         h_start, w_start, c0, pa, pb);
}

template <typename T, int NCH, int STRIDE, int ROWS, int COLS>
__device__ __forceinline__ void stage_any(int vec, T* dst, const T* src, int row_pitch,
                                          int pitch, int H, int W, int C, int h_start,
                                          int w_start, int c0, const float* pa, const float* pb) {
  constexpr int V = Elem<T>::VEC_MAX;
  if (vec == V)
    stage_pro<T, NCH, STRIDE, ROWS, COLS, V>(dst, src, row_pitch, pitch, H, W, C, h_start,
                                             w_start, c0, pa, pb);
  else if (vec == 2)
    stage_pro<T, NCH, STRIDE, ROWS, COLS, 2>(dst, src, row_pitch, pitch, H, W, C, h_start,
                                             w_start, c0, pa, pb);
  else
    stage_pro<T, NCH, STRIDE, ROWS, COLS, 1>(dst, src, row_pitch, pitch, H, W, C, h_start,
                                             w_start, c0, pa, pb);
}

// Widest load a framed view of T at `ptr` allows: 16 bytes (8 bf16 or 4
// float32), 2 elements or 1. A load may reach past the last logical channel
// only when `lanes_zero` says the buffer holds zeros there (the pre-padded
// ingest buffer: C = 238 in a 256-channel pitch then takes 16-byte loads).
template <typename T>
inline int load_width(const void* ptr, int C, int pitch, bool lanes_zero) {
  constexpr int V = Elem<T>::VEC_MAX;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ptr);
  if (pitch % V == 0 && addr % 16 == 0 && (C % V == 0 || lanes_zero)) return V;
  if (pitch % 2 == 0 && addr % (2 * sizeof(T)) == 0 && (C % 2 == 0 || lanes_zero)) return 2;
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
template <typename T>
struct ConvParams {
  const T* x;               // logical (N, H, W, C), framed by d.fx
  const T* wp;              // (9, OP, Cp) packed weights
  const float* bias;        // (O,)
  T* y;                     // logical (N, H, W, O), framed by d.fy
  const float* pa;          // prologue affine (C,), or in MODE_BWD the (O,) affine
  const float* pb;
  const T* r;               // MODE_BWD: the saved producer output, framed by d.fr
  float* partial;           // reducing modes: (blocks, 2, OP)
  bool x_lanes_zero;        // x's buffer is zero from channel C on (load_width)
  ConvDims d;
};

template <int NP>
constexpr int conv_smem_bytes() {
  return (HALO_PIX + 9 * NP) * ROW_BYTES;
}

// Stage wp[tap][o0 : o0+NP][c0 : c0+KC] into ws[tap*NP + o][KS] (16-byte
// loads; the packed weights are zero-padded, so no bounds checks are needed).
template <typename T, int NP>
__device__ __forceinline__ void load_weights(T* ws, const T* wp, int OP, int Cp, int o0,
                                             int c0) {
  constexpr int V = Elem<T>::VEC_MAX;
  constexpr int KS = Elem<T>::KS;
  constexpr int GROUPS = Elem<T>::KC / V;
  for (int i = threadIdx.x; i < 9 * NP * GROUPS; i += THREADS) {
    const int row = i / GROUPS;
    const int g = i - row * GROUPS;
    const int tap = row / NP;
    const int o = row - tap * NP;
    *reinterpret_cast<uint4*>(ws + row * KS + g * V) = *reinterpret_cast<const uint4*>(
        wp + (static_cast<size_t>(tap) * OP + o0 + o) * Cp + c0 + g * V);
  }
}

// A direct implicit GEMM (M = output pixels, N = output channels, K = 9*C).
// A block owns an 8x32 output tile of image n and the NP output channels from
// o0 = otile*NP; blockIdx = (W tile, H tile, n*n_otiles + otile). Each of its 8
// warps owns one output row (two 16-pixel MMA row tiles) by NP columns, with
// the f32 accumulators in registers. The input channels are walked in chunks
// of 64 bytes (32 bf16 or 16 float32): the (8+2)x(32+2) input halo and the
// 9xNP weight slice of a chunk are staged in shared memory and the nine taps
// are nine shifted views of the halo, read by ldmatrix from rows padded to 80
// bytes (no bank conflicts). For float32, ldmatrix's 16-bit 8x8 tiles are
// 8x4 tiles of 32-bit words, which is the m16n8k8 tf32 fragment layout of A
// (pixel rows, channels contiguous) and of B (output-channel rows).
// VEC is the load width of the input (see load_width).
// The pointers are kernel parameters of their own, not members of a struct,
// so that the compiler knows they point to global memory and do not alias.
template <typename T, int NP, int VEC>
__global__ void __launch_bounds__(THREADS, NP == 64 ? 2 : 1)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wp,
               const float* __restrict__ bias, T* __restrict__ y,
               const float* __restrict__ pa, const float* __restrict__ pb,
               const T* __restrict__ res, float* __restrict__ partial, const ConvDims p) {
  constexpr int KC = Elem<T>::KC;
  constexpr int KS = Elem<T>::KS;
  constexpr int MMA_K = Elem<T>::MMA_K;
  constexpr int HALF_K = MMA_K / 2;  // 16 bytes: the second 8x8 tile along K
  constexpr int TAP_UNROLL = is_f32<T> ? 1 : 9;
  extern __shared__ __align__(16) unsigned char smem[];
  T* hs = reinterpret_cast<T*>(smem);
  T* ws = hs + HALO_PIX * KS;

  constexpr int NB = NP / 8;  // 8-wide MMA column tiles
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z / p.n_otiles;
  const int o0 = (blockIdx.z % p.n_otiles) * NP;
  const bool prologue = pa != nullptr && p.mode != MODE_BWD;
  const T* xn = x + image_offset(p.fx, n);

  float acc[2][NB][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][nb][r] = 0.0f;

  for (int c0 = 0; c0 < p.Cp; c0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
    stage_pro<T, KC, KS, TH + 2, HALO_W, VEC>(hs, xn, p.fx.cols * p.fx.pitch, p.fx.pitch, p.H,
                                              p.W, p.C, h0 - 1, w0 - 1, c0,
                                              prologue ? pa : nullptr, prologue ? pb : nullptr);
    load_weights<T, NP>(ws, wp, p.OP, p.Cp, o0, c0);
    __syncthreads();

    // float32 keeps the tap loop rolled: unrolled, its hoisted fragment
    // loads and splits spill past the register budget.
#pragma unroll(TAP_UNROLL)
    for (int t = 0; t < 9; ++t) {
      const int dh = t / 3;
      const int dw = t % 3;
#pragma unroll
      for (int k = 0; k < KC; k += MMA_K) {
        // A: 16 consecutive output pixels of this warp's row, shifted by the tap.
        uint32_t a[2][4];
        if constexpr (is_f32<T>) {
          // One 16-pixel tile at a time, its A fragment split once and each
          // B fragment split again per tile: the hi and lo halves of all
          // fragments at once do not fit beside the accumulators.
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int px = (warp + dh) * HALO_W + j * 16 + dw + (lane & 15);
            ldmatrix_x4(a[j], hs + px * KS + k + (lane >> 4) * HALF_K);
            uint32_t a_hi[4], a_lo[4];
            split_tf32(a[j], a_hi, a_lo);
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
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int px = (warp + dh) * HALO_W + j * 16 + dw + (lane & 15);
            ldmatrix_x4(a[j], hs + px * KS + k + (lane >> 4) * HALF_K);
          }
          // B: two 8-wide output-channel tiles per ldmatrix.
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
  // o even, so a pair is in range and, with an even pitch, aligned
  const bool pairs = (p.O & 1) == 0 && (p.fy.pitch & 1) == 0;
  T* const yn = y + image_offset(p.fy, n);

  if (p.mode == MODE_PLAIN) {
    if (oh >= p.H) return;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ow = w0 + j * 16 + (lane >> 2) + half * 8;
        if (ow >= p.W) continue;
        T* yp = yn + (oh * p.fy.cols + ow) * p.fy.pitch;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int o = o0 + nb * 8 + (lane & 3) * 2;
          if (o >= p.O) continue;
          float v0 = acc[j][nb][half * 2] + bias[o];
          if (p.relu) v0 = fmaxf(v0, 0.0f);
          if (pairs) {
            float v1 = acc[j][nb][half * 2 + 1] + bias[o + 1];
            if (p.relu) v1 = fmaxf(v1, 0.0f);
            store_pair(yp + o, v0, v1);
          } else {
            yp[o] = from_f32<T>(v0);
            if (o + 1 < p.O) {
              float v1 = acc[j][nb][half * 2 + 1] + bias[o + 1];
              if (p.relu) v1 = fmaxf(v1, 0.0f);
              yp[o + 1] = from_f32<T>(v1);
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
            const float rr = to_f32<T>(
                res[image_offset(p.fr, n) + (oh * p.fr.cols + ow) * p.fr.pitch + o + e]);
            const bool m = __fadd_rn(__fmul_rn(rr, bias_or_pa[e]), pbv[e]) > 0.0f;
            const float mdz = m ? v : 0.0f;
            out[e] = mdz * bias_or_pa[e];
            s[0][e] += mdz * rr;
            s[1][e] += mdz;
          }
        }
        if (pairs) {
          store_pair(yn + ypix + o, out[0], out[1]);
        } else {
          yn[ypix + o] = from_f32<T>(out[0]);
          if (o + 1 < p.O) yn[ypix + o + 1] = from_f32<T>(out[1]);
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
template <typename T, int NP, int VEC>
cudaError_t launch_conv_vec(const ConvParams<T>& p, int N, int partial_rows, float* sums,
                            cudaStream_t stream) {
  auto kernel = conv3x3_kernel<T, NP, VEC>;
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

template <typename T, int NP>
cudaError_t launch_conv(const ConvParams<T>& p, int N, int partial_rows, float* sums,
                        cudaStream_t stream) {
  constexpr int V = Elem<T>::VEC_MAX;
  const int vec = load_width<T>(p.x, p.d.C, p.d.fx.pitch, p.x_lanes_zero);
  if (vec == V) return launch_conv_vec<T, NP, V>(p, N, partial_rows, sums, stream);
  if (vec == 2) return launch_conv_vec<T, NP, 2>(p, N, partial_rows, sums, stream);
  return launch_conv_vec<T, NP, 1>(p, N, partial_rows, sums, stream);
}

// Launch the forward kernel for NP in {64, 128}.
template <typename T>
cudaError_t launch_conv_np(const ConvParams<T>& p, int NP, int N, int partial_rows,
                           float* sums, cudaStream_t stream) {
  if (NP == 64) return launch_conv<T, 64>(p, N, partial_rows, sums, stream);
  if (NP == 128) return launch_conv<T, 128>(p, N, partial_rows, sums, stream);
  return cudaErrorInvalidValue;
}

}  // namespace conv3x3
