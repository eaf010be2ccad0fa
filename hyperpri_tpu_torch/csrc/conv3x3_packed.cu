// 3x3 SAME convolution + bias (+ReLU) for NHWC bf16 activations, O <= 128.
//
// Replaces the TPU kernel hyperpri_tpu/ops/pallas/conv3x3_packed.py:conv3x3_packed
// (forward, bias + optional ReLU mode):
//
//     y[n,h,w,o] = act(sum_{dh,dw,c} x[n,h+dh-1,w+dw-1,c] * w[dh,dw,c,o] + b[o])
//
// with zeros outside the image, f32 accumulation, the f32 bias added before the
// ReLU, and one rounding to bf16 at the store.
//
// Bound. The work is 2*N*H*W*C*O*9 FLOP against (N*H*W*C + N*H*W*O + 9*C*O)
// bf16 elements moved, i.e. about 9*C*O/(C+O) FLOP per byte. At CubeNET's
// full-resolution layers (608x968, O=64) that is 454 (C=238), 384 (C=128) and
// 288 (C=64) FLOP per byte, against the ~295 FLOP/byte at which an H100's bf16
// tensor cores (989 TFLOP/s dense) and its memory (3.35 TB/s) balance: the
// kernel is bound by operations, and 64->64 sits on the ridge.
//
// Design (a direct implicit GEMM; M = output pixels, N = O, K = 9*C):
//   - a block owns an 8x32 output tile and all O outputs; each of its 8 warps
//     owns one output row (two 16-pixel MMA row tiles) by all O columns, with
//     the f32 accumulators in registers;
//   - the input channels are walked in chunks of 32: the (8+2)x(32+2)x32 input
//     halo and the 9x32xO weight slice are staged in shared memory, and the 9
//     taps become 9 shifted views of the same halo (no im2col in memory);
//   - the products are bf16 mma.sync m16n8k16 with f32 accumulation, fed by
//     ldmatrix from shared rows padded to 80 bytes (no bank conflicts);
//   - the SAME border, the ragged last W tile and the channel tail past C are
//     zero-filled in the halo, so the inner loop has no masks;
//   - channels are loaded 16 bytes at a time when C % 8 == 0, 4 bytes when C is
//     even (C = 238 gives 476-byte pixels, which are only 4-byte aligned), and
//     one element otherwise; the input is never padded in device memory.
// The weights arrive pre-packed by the wrapper as wp[tap][o][c] (tap = 3*dh+dw,
// O zero-padded to NP in {64, 128}, C zero-padded to a multiple of 32).
// Not yet done: double-buffered cp.async/TMA staging and wgmma, which is what
// the card's full tensor rate needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;           // output rows per block, one warp each
constexpr int TW = 32;          // output columns per block: two 16-row MMA tiles
constexpr int KC = 32;          // input channels staged per step
constexpr int KS = KC + 8;      // shared row stride in elements (80 bytes)
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;
constexpr int THREADS = TH * 32;

template <int NP>
constexpr int smem_bytes() {
  return (HALO_PIX + 9 * NP) * KS * static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// Stage x[n, h0-1 : h0+TH+1, w0-1 : w0+TW+1, c0 : c0+KC] into hs[pixel][KS],
// zero outside the image and past C. VEC elements per load (C % VEC == 0).
template <int VEC>
__device__ __forceinline__ void load_halo(__nv_bfloat16* hs, const __nv_bfloat16* x,
                                          int n, int H, int W, int C,
                                          int h0, int w0, int c0) {
  constexpr int GROUPS = KC / VEC;
  for (int i = threadIdx.x; i < HALO_PIX * GROUPS; i += THREADS) {
    const int p = i / GROUPS;
    const int g = i - p * GROUPS;
    const int hh = h0 - 1 + p / HALO_W;
    const int ww = w0 - 1 + p % HALO_W;
    const int c = c0 + g * VEC;
    const bool inside = hh >= 0 && hh < H && ww >= 0 && ww < W && c < C;
    __nv_bfloat16* dst = hs + p * KS + g * VEC;
    const size_t off = inside ? ((static_cast<size_t>(n) * H + hh) * W + ww) * C + c : 0;
    if constexpr (VEC == 8) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (inside) v = *reinterpret_cast<const uint4*>(x + off);
      *reinterpret_cast<uint4*>(dst) = v;
    } else if constexpr (VEC == 2) {
      uint32_t v = 0u;
      if (inside) v = *reinterpret_cast<const uint32_t*>(x + off);
      *reinterpret_cast<uint32_t*>(dst) = v;
    } else {
      *dst = inside ? x[off] : __float2bfloat16_rn(0.0f);
    }
  }
}

// Stage wp[tap][0:NP][c0 : c0+KC] into ws[tap*NP + o][KS] (16-byte loads; the
// packed weights are zero-padded, so no bounds checks are needed).
template <int NP>
__device__ __forceinline__ void load_weights(__nv_bfloat16* ws, const __nv_bfloat16* wp,
                                             int Cp, int c0) {
  constexpr int GROUPS = KC / 8;
  for (int i = threadIdx.x; i < 9 * NP * GROUPS; i += THREADS) {
    const int row = i / GROUPS;
    const int g = i - row * GROUPS;
    *reinterpret_cast<uint4*>(ws + row * KS + g * 8) =
        *reinterpret_cast<const uint4*>(wp + static_cast<size_t>(row) * Cp + c0 + g * 8);
  }
}

template <int NP, int VEC>
__global__ void __launch_bounds__(THREADS, NP == 64 ? 2 : 1)
conv3x3_packed_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wp,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y,
                      int H, int W, int C, int Cp, int O, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = hs + HALO_PIX * KS;

  constexpr int NB = NP / 8;  // 8-wide MMA column tiles
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * TW;
  const int h0 = blockIdx.y * TH;
  const int n = blockIdx.z;

  float acc[2][NB][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][nb][r] = 0.0f;

  for (int c0 = 0; c0 < Cp; c0 += KC) {
    __syncthreads();  // the previous chunk's reads are done
    load_halo<VEC>(hs, x, n, H, W, C, h0, w0, c0);
    load_weights<NP>(ws, wp, Cp, c0);
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
          const int p = (warp + dh) * HALO_W + j * 16 + dw + (lane & 15);
          ldmatrix_x4(a[j], hs + p * KS + k + (lane >> 4) * 8);
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
  // (lane/4 + 8*(r/2)) of row tile j, output channel nb*8 + 2*(lane%4) + r%2.
  const int oh = h0 + warp;
  if (oh >= H) return;
  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + j * 16 + (lane >> 2) + half * 8;
      if (ow >= W) continue;
      __nv_bfloat16* yp = y + ((static_cast<size_t>(n) * H + oh) * W + ow) * O;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int o = nb * 8 + (lane & 3) * 2;
        if (o >= O) continue;
        float v0 = acc[j][nb][half * 2] + bias[o];
        if (relu) v0 = fmaxf(v0, 0.0f);
        if (pairs) {  // O even: o + 1 < O and the pair is 4-byte aligned
          float v1 = acc[j][nb][half * 2 + 1] + bias[o + 1];
          if (relu) v1 = fmaxf(v1, 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(yp + o) = __floats2bfloat162_rn(v0, v1);
        } else {
          yp[o] = __float2bfloat16_rn(v0);
          if (o + 1 < O) {
            float v1 = acc[j][nb][half * 2 + 1] + bias[o + 1];
            if (relu) v1 = fmaxf(v1, 0.0f);
            yp[o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

template <int NP, int VEC>
cudaError_t launch(const void* x, const void* wp, const void* b, void* y, int N, int H,
                   int W, int C, int Cp, int O, int relu, cudaStream_t stream) {
  auto kernel = conv3x3_packed_kernel<NP, VEC>;
  constexpr int smem = smem_bytes<NP>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), H, W, C, Cp, O, relu);
  return cudaGetLastError();
}

template <int NP>
cudaError_t dispatch_vec(const void* x, const void* wp, const void* b, void* y, int N,
                         int H, int W, int C, int Cp, int O, int relu,
                         cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (C % 8 == 0 && addr % 16 == 0)
    return launch<NP, 8>(x, wp, b, y, N, H, W, C, Cp, O, relu, stream);
  if (C % 2 == 0 && addr % 4 == 0)
    return launch<NP, 2>(x, wp, b, y, N, H, W, C, Cp, O, relu, stream);
  return launch<NP, 1>(x, wp, b, y, N, H, W, C, Cp, O, relu, stream);
}

}  // namespace

// x: (N, H, W, C) bf16; wp: (9, NP, Cp) bf16 packed weights; b: (O,) f32;
// y: (N, H, W, O) bf16. NP is 64 (O <= 64) or 128 (O <= 128); Cp is C rounded
// up to a multiple of 32. Returns the cudaError_t of the launch.
extern "C" int conv3x3_packed_bf16(const void* x, const void* wp, const void* b, void* y,
                                   int N, int H, int W, int C, int Cp, int O, int NP,
                                   int relu, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1 || O > NP || Cp < C || Cp % KC != 0 ||
      (H + TH - 1) / TH > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NP == 64) return static_cast<int>(dispatch_vec<64>(x, wp, b, y, N, H, W, C, Cp, O, relu, s));
  if (NP == 128) return static_cast<int>(dispatch_vec<128>(x, wp, b, y, N, H, W, C, Cp, O, relu, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
