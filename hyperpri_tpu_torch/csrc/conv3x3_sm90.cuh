// Hopper (sm_90a) building blocks of the conv kernels redesigned for the
// H100: conv3x3_packed_sm90_kernel and conv3x3_packed_sm90_f32_kernel
// (conv3x3_packed.cu, conv3x3_packed, bf16 and float32),
// conv3x3_sm90_kernel and conv3x3_sm90_f32_kernel (conv3x3.cu,
// conv3x3_bias_act, bf16 and float32), conv3x3_wgrad_sm90_kernel and
// conv3x3_wgrad_sm90_f32_kernel (conv3x3_grad.cu, conv3x3_wgrad) and
// conv3x3_shift_sm90_kernel and conv3x3_shift_sm90_f32_kernel
// (conv3x3_shift.cu, conv3x3_bias_act_shift, bf16 and float32).
//
//   - Staging is asynchronous: one thread keeps TMA loads
//     (cp.async.bulk.tensor) in flight into a ring of shared-memory stages,
//     each completed on an mbarrier; the warpgroups that compute wait on a
//     stage's "full" barrier and release it on its "empty" barrier. (In
//     conv3x3_sm90_kernel that thread is in a producer warpgroup, which
//     hands its registers to the consumers with setmaxnreg.)
//   - Activation boxes are read through a tensor map on the logical
//     (N, H, W, C) region of their buffer: the frame's strides, the logical
//     origin as the base address. TMA zero-fills every element outside it,
//     so the SAME border costs nothing and a frame holding NaN is never read.
//     The maps are encoded on the host with cuTensorMapEncodeTiled, obtained
//     through cudaGetDriverEntryPoint (no link against libcuda), and passed
//     to the kernels as __grid_constant__ parameters.
//   - A staged pixel is one 128-byte row of 64 bf16 channels, written with
//     TMA's 128-byte swizzle: the 16-byte chunk j of box row p sits at chunk
//     j ^ (p % 8) of that row (every box starts on a 1 KiB boundary). Eight
//     consecutive pixels then cover all 32 banks, so the ldmatrix reads of a
//     tap-shifted run of pixels are conflict-free, and the same layout is the
//     canonical 128-byte-swizzled operand layout of wgmma.
//   - Products are warpgroup MMAs (wgmma.mma_async) with float32 accumulators
//     in registers. The tap shift is one pixel, which a shared-memory
//     descriptor cannot express, so the tap-shifted operand is loaded with
//     ldmatrix from the staged box into the A-register layout (per warp the
//     mma.sync m16n8k16 A fragment); the unshifted operand is read by the
//     tensor cores from shared memory through a descriptor.
//   - Float32 (3xTF32, as conv3x3_common.cuh describes): a staged pixel is one
//     128-byte row of 32 float32 channels, swizzled alike. The tf32 wgmma is
//     m64nNk8 (a K step is 8 floats, 32 bytes) and reads B from shared memory
//     only K-major (the descriptor's transpose bits exist for f16/bf16 only),
//     so the shared-memory operand is laid out K-major in two planes, hi =
//     tf32(v) and lo = tf32(v - hi); the register operand is split in
//     registers. Each product is lo*hi + hi*lo + hi*hi into a fresh fragment
//     (scale-d = 0 on its first wgmma) that chains a few K steps only and is
//     then added to the float32 accumulators with adds rounded to nearest: the
//     tensor cores' own accumulation truncates, and a long chain through it
//     drifts on one-signed terms (conv3x3_common.cuh, mma_3xtf32).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "conv3x3_common.cuh"

namespace conv3x3 {
namespace sm90 {

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use
constexpr int CHUNK = 64;           // channels of one staged box row
constexpr int BOX_ROW = 128;        // its bytes
constexpr int HALO_BYTES = HALO_PIX * BOX_ROW;                 // (8+2) x (32+2) pixels
constexpr int HALO_SLOT = (HALO_BYTES + 1023) / 1024 * 1024;   // 1 KiB aligned
constexpr int TILE_BYTES = TH * TW * BOX_ROW;                  // 8 x 32 pixels
constexpr int ALIGN_SLACK = 1024;   // the dynamic base is rounded up to 1 KiB
constexpr int F32_CHUNK = BOX_ROW / 4;  // float32 channels of one staged box row (32)

// ---------------------------------------------------------------------------
// mbarriers, TMA, fences

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive once and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity. A
// wait of more than 2^26 polls (seconds; a kernel here runs milliseconds)
// traps, so that a lost arrival fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Bring the 128-byte line holding `p` into L2 (no fault, no register).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier 1 among the consumer warps only (the producer warp never joins).
template <int THREADS_>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS_) : "memory");
}

// Warp-specialised register budgets: the producer warpgroup gives up
// registers, the consumer warpgroups take them (whole warpgroups, in one
// branch each that never rejoins the other).
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// Operands

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Shared address of the 16-byte chunk `chunk` (8 channels) of row p of a
// swizzled box at `box`.
__device__ __forceinline__ uint32_t swizzled(uint32_t box, int p, int chunk) {
  return box + p * BOX_ROW + ((chunk ^ (p & 7)) << 4);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled MN-major operand at
// `addr` (one 128-byte row of 64 M or N elements per K, as TMA writes a box
// whose inner dimension is M or N): sbo = 1024, the stride between groups of
// 8 K rows; lbo the stride between 64-wide blocks along M or N (unused for a
// 64-wide operand).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup's MMAs are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers at this point of the instruction stream: the accumulators
// are read only after the wait that completes the MMAs writing them, and
// the A registers stay untouched until the MMAs reading them are complete.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d += A * B, m64n128k16: A (64 x 16) from registers in the mma.sync A
// fragment layout (warp w of the warpgroup holds rows 16w..16w+15), B
// (16 x 128) N-major ("transposed": N contiguous) in shared memory (desc_b).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A * B, m64n64k16: A from registers as above, B (16 x 64) N-major in
// shared memory (desc_b).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d = A * B + (scale_d ? d : 0), m64n64k8 in tf32: A (64 x 8) from registers
// in the mma.sync m16n8k8 tf32 A fragment layout (warp w of the warpgroup
// holds rows 16w..16w+15), B (8 x 64) K-major in shared memory (desc_b: 64
// rows of 128-byte-swizzled K, the K step's 32 bytes at the start address).
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// One 3xTF32 K step into the fragment d: lo(A)*hi(B) + hi(A)*lo(B) +
// hi(A)*hi(B), B's planes at desc_hi and desc_lo; `first` starts the chain
// (scale-d = 0 on its first wgmma).
__device__ __forceinline__ void wgmma_3xtf32_step(float (&d)[32], const uint32_t (&a_hi)[4],
                                                  const uint32_t (&a_lo)[4], uint64_t desc_hi,
                                                  uint64_t desc_lo, bool first) {
  wgmma_m64n64k8_tf32_rs(d, a_lo, desc_hi, first ? 0 : 1);
  wgmma_m64n64k8_tf32_rs(d, a_hi, desc_lo, 1);
  wgmma_m64n64k8_tf32_rs(d, a_hi, desc_hi, 1);
}

// acc += frag with float32 adds rounded to nearest.
template <int R>
__device__ __forceinline__ void add_fragment(float (&acc)[R], const float (&frag)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], frag[i]);
}

// ---------------------------------------------------------------------------
// Float32 forward convs (conv3x3_sm90_f32_kernel in conv3x3.cu,
// conv3x3_packed_sm90_f32_kernel in conv3x3_packed.cu): the A operand from a
// staged 32-channel halo chunk, the B operand a (tap, chunk) slice of 64
// outputs in K-major TF32 hi and lo planes, and the weight split that writes
// those planes.

constexpr int F32_N = 64;                   // output channels of a weight slice
constexpr int F32_PLANE = F32_N * BOX_ROW;  // one slice, one plane (8 KiB)
constexpr int F32_WSTAGE = 2 * F32_PLANE;   // its hi and lo planes
// K steps (8 channels each) chained through the tensor cores into one fresh
// fragment before it is added to the accumulators; a (tap, chunk) slice holds
// 4, so F32_UNITS fragments a slice and m-tile.
constexpr int F32_GROUP = 4;
constexpr int F32_UNITS = 4 / F32_GROUP;
static_assert(4 % F32_GROUP == 0, "a slice's K steps split into whole groups");

// planes[plane][tap][o][c] = hi (plane 0) and lo (plane 1) of w[tap][c][o]
// (w HWIO (3, 3, C, O) float32) for c < C, and zero for C <= c < Cp: the
// weights K-major in TF32 halves with a channel pitch of Cp, as the tf32
// wgmma reads B; split_tf32 of conv3x3_common.cuh.
__global__ void split_weights_tf32_kernel(const float* __restrict__ w, float* __restrict__ planes,
                                          int C, int O, int Cp) {
  const int total = 9 * Cp * O;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int c = i % Cp;
    const int o = (i / Cp) % O;
    const int tap = i / (Cp * O);
    uint32_t hi = 0, lo = 0;
    if (c < C) split_tf32(__float_as_uint(w[(tap * C + c) * O + o]), hi, lo);
    planes[i] = __uint_as_float(hi);
    planes[total + i] = __uint_as_float(lo);
  }
}

inline cudaError_t split_weights_tf32(const float* w, float* planes, int C, int O, int Cp,
                                      cudaStream_t s) {
  const int total = 9 * Cp * O;
  const int blocks = (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024;
  split_weights_tf32_kernel<<<blocks, 256, 0, s>>>(w, planes, C, O, Cp);
  return cudaGetLastError();
}

// A of m-tile mt for K steps unit*F32_GROUP.. of a staged 32-channel halo
// chunk: the 16 pixels of this warp's output row `wrow`, shifted by the tap
// (dh, dw), split into TF32 halves. The b16 ldmatrix of 32-bit words gives
// the m16n8k8 tf32 A fragment (conv3x3_common.cuh, conv3x3_kernel).
__device__ __forceinline__ void load_a_f32(uint32_t (&a_hi)[F32_GROUP][4],
                                           uint32_t (&a_lo)[F32_GROUP][4], uint32_t halo,
                                           int wrow, int dh, int dw, int mt, int unit, int lane) {
  const int p = (wrow + dh) * HALO_W + mt * 16 + dw + (lane & 15);
#pragma unroll
  for (int j = 0; j < F32_GROUP; ++j) {
    uint32_t r[4];
    ldsm_x4(r, swizzled(halo, p, (unit * F32_GROUP + j) * 2 + (lane >> 4)));
    split_tf32(r, a_hi[j], a_lo[j]);
  }
}

// The fragment d of K steps unit*F32_GROUP.. of the weight slice at `stage`
// (hi plane, then lo plane; 64 output rows of 128-byte-swizzled K each).
__device__ __forceinline__ void chain_f32(float (&d)[32], const uint32_t (&a_hi)[F32_GROUP][4],
                                          const uint32_t (&a_lo)[F32_GROUP][4], uint32_t stage,
                                          int unit) {
#pragma unroll
  for (int j = 0; j < F32_GROUP; ++j) {
    const uint32_t k_off = (unit * F32_GROUP + j) * 32;
    wgmma_3xtf32_step(d, a_hi[j], a_lo[j], desc_sw128(stage + k_off, 16, 1024),
                      desc_sw128(stage + F32_PLANE + k_off, 16, 1024), j == 0);
  }
}

template <int K>
__device__ __forceinline__ void fence_a(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int j = 0; j < K; ++j) fence_regs(a[j]);
}

// One tap of a float32 forward conv whose warp r computes output row r (two
// m-tiles of 16 pixels): A from the staged 32-channel box `box` (load_a_f32;
// a dh band is a box of rows wrow + 0), wait for the weight slice at `stage`
// (its full barrier `full` in phase `parity`), one chain a K-step group and
// m-tile into a fresh fragment, waited for, then added to the accumulators.
// The caller declares the fragments and A registers, and releases the stage.
__device__ __forceinline__ void tap_f32(float (&acc)[2][32], float (&frag)[2][32],
                                        uint32_t (&a_hi)[2][F32_GROUP][4],
                                        uint32_t (&a_lo)[2][F32_GROUP][4], uint32_t box,
                                        int wrow, int dh, int dw, uint32_t stage, uint32_t full,
                                        uint32_t parity, int lane) {
#pragma unroll
  for (int unit = 0; unit < F32_UNITS; ++unit) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) load_a_f32(a_hi[mt], a_lo[mt], box, wrow, dh, dw, mt, unit, lane);
    if (unit == 0) mbar_wait(full, parity);
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
  }
}

// TMA load of the (tap, 32-channel chunk) slice of 64 outputs from o0 of
// the planes (2, 9, O, C) into `dst`: the hi plane, then the lo plane.
__device__ __forceinline__ void load_slice_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int o0, int c0, int tap) {
#pragma unroll
  for (int plane = 0; plane < 2; ++plane)
    tma_load_4d(dst + plane * F32_PLANE, map, bar, c0, o0, tap, plane);
}

// ---------------------------------------------------------------------------
// Bf16 forward convs (conv3x3_sm90_kernel in conv3x3.cu,
// conv3x3_shift_sm90_kernel in conv3x3_shift.cu): the A operand from a
// staged 64-channel box of HALO_W-pixel rows, the B operand a (tap, chunk)
// slice of 64 inputs x 128 outputs of w (3, 3, C, O) read in place.

constexpr int BF16_N = 128;                      // output channels of a slice (O tile)
constexpr int BF16_WSTAGE = CHUNK * 2 * BF16_N;  // one slice (16 KiB)
constexpr int BF16_WBOX = BF16_WSTAGE / 2;       // its TMA box: 64 inputs x 64 outputs

// TMA load of the (tap, 64-channel chunk) slice of 128 outputs from o0:
// w[tap][c][o], 64 rows (c) of 64 outputs a box, two boxes.
__device__ __forceinline__ void load_slice_bf16(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int o0, int c0, int tap) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
    tma_load_3d(dst + half * BF16_WBOX, map, bar, o0 + half * (BF16_N / 2), c0, tap);
}

// One tap of a bf16 forward conv whose warp r computes output row r: A, the
// 16 pixels of this warp's row `wrow` in each 16-column half, shifted by the
// tap (dh, dw), 64 channels as four k16 steps, by ldmatrix from the
// swizzled box (a dh band is a box of rows wrow + 0); wait for the weight
// slice at `stage` (its full barrier `full` in phase `parity`); acc += A * B
// by eight wgmma m64n128k16, waited for. The caller releases the stage.
__device__ __forceinline__ void tap_bf16(float (&acc)[2][64], uint32_t box, int wrow, int dh,
                                         int dw, uint32_t stage, uint32_t full, uint32_t parity,
                                         int lane) {
  uint32_t a[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = (wrow + dh) * HALO_W + mt * 16 + dw + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[mt][kk], swizzled(box, p, kk * 2 + (lane >> 4)));
  }
  mbar_wait(full, parity);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // B: 16 rows (c) of the slice's two 64-output boxes
    const uint64_t desc = desc_sw128(stage + kk * 16 * BOX_ROW, BF16_WBOX, 1024);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) wgmma_m64n128k16_rs_tb(acc[mt], a[mt][kk], desc);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    fence_regs(acc[mt]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[mt][kk]);
  }
}

// Epilogue of one O tile of N outputs from o0 (O even), for output row oh of
// image yn (H, W, O): accumulator element i of m-tile mt is pixel column
// w0 + mt*16 + g + 8*((i%4)/2), output channel o0 + 8*(i/4) + 2q + i%2 (the
// m16n8 layout of each 8-column block); v = acc + bias in float32, ReLU if
// relu, rounded once to TO and stored as channel pairs.
template <typename TO, int N>
__device__ __forceinline__ void store_tile(const float (&acc)[2][N / 2], TO* yn,
                                           const float* bias, int oh, int w0, int o0, int H,
                                           int W, int O, int relu, int lane) {
  if (oh >= H) return;
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = w0 + mt * 16 + g + half * 8;
      if (ow >= W) continue;
      TO* yp = yn + static_cast<size_t>(oh * W + ow) * O;
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb) {
        const int o = o0 + nb * 8 + 2 * q;
        if (o >= O) continue;  // O is even: o + 1 < O too
        float v0 = acc[mt][nb * 4 + half * 2] + bias[o];
        float v1 = acc[mt][nb * 4 + half * 2 + 1] + bias[o + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        store_pair(yp + o, v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The prologue on a staged box, after it has landed

// z = relu(pa*x + pb) in place on a swizzled box of `rows` pixels, `box_w` a
// row, whose first pixel is image pixel (h_start, w_start), holding the 64
// channels from c0. pas, pbs: the affine of those 64 channels in shared
// memory, zero from channel C on (16-byte aligned). Only pixels inside the
// H x W image change, each channel as affine_relu computes it (float32
// product rounded, then the sum rounded, then ReLU, rounded to bf16); past C
// that gives relu(0*0 + 0) = 0, and the zeros TMA filled in outside the
// image stay exact zeros. Threads tid = 0..nthreads-1 share the work.
__device__ __forceinline__ uint32_t affine_relu_pair(uint32_t packed, float a0, float a1,
                                                     float b0, float b1) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&packed));
  const __nv_bfloat162 z =
      __floats2bfloat162_rn(affine_relu(v.x, a0, b0), affine_relu(v.y, a1, b1));
  return *reinterpret_cast<const uint32_t*>(&z);
}

__device__ __forceinline__ void prologue_box(__nv_bfloat16* box, int rows, int box_w,
                                             int h_start, int w_start, int H, int W,
                                             const float* pas, const float* pbs, int tid,
                                             int nthreads) {
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int p = i >> 3;
    const int hh = h_start + p / box_w;
    const int ww = w_start + p % box_w;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    const int lc = ((i & 7) ^ (p & 7)) << 3;  // the vector's first channel - c0
    uint4* q = reinterpret_cast<uint4*>(box + p * CHUNK + (i & 7) * 8);
    const float4 a0 = *reinterpret_cast<const float4*>(pas + lc);
    const float4 a1 = *reinterpret_cast<const float4*>(pas + lc + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(pbs + lc);
    const float4 b1 = *reinterpret_cast<const float4*>(pbs + lc + 4);
    uint4 v = *q;
    v.x = affine_relu_pair(v.x, a0.x, a0.y, b0.x, b0.y);
    v.y = affine_relu_pair(v.y, a0.z, a0.w, b0.z, b0.w);
    v.z = affine_relu_pair(v.z, a1.x, a1.y, b1.x, b1.y);
    v.w = affine_relu_pair(v.w, a1.z, a1.w, b1.z, b1.w);
    *q = v;
  }
}

// The same on a swizzled float32 box (32 channels a pixel): z =
// relu(pa*x + pb) in float32, kept unrounded. pas, pbs: the affine of the
// box's 32 channels (16-byte aligned, zero from channel C on).
__device__ __forceinline__ void prologue_box_f32(float* box, int rows, int box_w, int h_start,
                                                 int w_start, int H, int W, const float* pas,
                                                 const float* pbs, int tid, int nthreads) {
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int p = i >> 3;
    const int hh = h_start + p / box_w;
    const int ww = w_start + p % box_w;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    const int lc = ((i & 7) ^ (p & 7)) << 2;  // the vector's first channel in the box
    float4* q = reinterpret_cast<float4*>(box + p * F32_CHUNK + (i & 7) * 4);
    const float4 a = *reinterpret_cast<const float4*>(pas + lc);
    const float4 b = *reinterpret_cast<const float4*>(pbs + lc);
    float4 v = *q;
    v.x = affine_relu(v.x, a.x, b.x);
    v.y = affine_relu(v.y, a.y, b.y);
    v.z = affine_relu(v.z, a.z, b.z);
    v.w = affine_relu(v.w, a.w, b.w);
    *q = v;
  }
}

// Copy the prologue affine of channels [c_first, c_first + n) into shared
// memory (pas[k], pbs[k] for channel c_first + k), zero from channel C on and
// without a prologue. Threads tid = 0..nthreads-1 share the work.
__device__ __forceinline__ void load_affine(float* pas, float* pbs, const float* pa,
                                            const float* pb, int c_first, int n, int C, int tid,
                                            int nthreads) {
  for (int k = tid; k < n; k += nthreads) {
    const int c = c_first + k;
    const bool on = pa != nullptr && c < C;
    pas[k] = on ? __ldg(pa + c) : 0.0f;
    pbs[k] = on ? __ldg(pb + c) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A tensor map of `rank` dims (innermost first; strides in bytes of dims
// 1..rank-1) with a 128-byte-swizzled box, zero fill out of bounds.
inline bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type, const void* origin,
                         int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(origin) % 16 != 0) return false;
  for (int i = 0; i < rank - 1; ++i)
    if (strides[i] % 16 != 0) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(origin), dims,
                strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool encode_bf16(CUtensorMap* map, const void* origin, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, origin, rank, dims, strides, box);
}

inline bool encode_f32(CUtensorMap* map, const void* origin, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, origin, rank, dims, strides, box);
}

// The map of a framed NHWC bf16 view: dims (C, W, H, N) of the logical
// region, strides of the buffer, base at image 0's logical pixel (0, 0);
// boxes of 64 channels x box_w x box_h pixels of one image.
inline bool nhwc_map(CUtensorMap* map, const void* buf, const Frame& f, int N, int H, int W,
                     int C, int box_w, int box_h) {
  const cuuint64_t pix = static_cast<cuuint64_t>(f.pitch) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {pix, pix * f.cols, pix * f.cols * f.rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(CHUNK), static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const char* origin = static_cast<const char*>(buf) + image_offset(f, 0) * 2;
  return encode_bf16(map, origin, 4, dims, strides, box);
}

// The same for a float32 view: boxes of 32 channels (128 bytes) x box_w x
// box_h pixels of one image.
inline bool nhwc_map_f32(CUtensorMap* map, const void* buf, const Frame& f, int N, int H, int W,
                         int C, int box_w, int box_h) {
  const cuuint64_t pix = static_cast<cuuint64_t>(f.pitch) * 4;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {pix, pix * f.cols, pix * f.cols * f.rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(F32_CHUNK), static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), 1};
  const char* origin = static_cast<const char*>(buf) + image_offset(f, 0) * 4;
  return encode_f32(map, origin, 4, dims, strides, box);
}

// The map of bf16 weights w (3, 3, C, O), read in place, as dims (O, C, 9):
// the output channels contiguous, zero past O and C; boxes of 64 outputs x
// 64 input channels of one tap (load_slice_bf16).
inline bool weight_map_bf16(CUtensorMap* map, const void* w, int C, int O) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(O), static_cast<cuuint64_t>(C), 9};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(O) * 2,
                                 static_cast<cuuint64_t>(O) * C * 2};
  const cuuint32_t box[3] = {BF16_N / 2, static_cast<cuuint32_t>(CHUNK), 1};
  return encode_bf16(map, w, 3, dims, strides, box);
}

// The map of the TF32 planes (2, 9, O, C) of float32 weights as dims (C, O,
// 9, 2): the input channels contiguous (K-major), zero past C and O; boxes
// of 32 channels x 64 outputs of one tap and plane (load_slice_f32).
inline bool planes_map_f32(CUtensorMap* map, const void* planes, int C, int O) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(O), 9, 2};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 4,
                                 static_cast<cuuint64_t>(O) * C * 4,
                                 static_cast<cuuint64_t>(9) * O * C * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(F32_CHUNK), F32_N, 1, 1};
  return encode_f32(map, planes, 4, dims, strides, box);
}

}  // namespace sm90
}  // namespace conv3x3
