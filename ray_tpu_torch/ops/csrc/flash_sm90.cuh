// Hopper tensor-core building blocks of the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): swizzled shared-memory tiles filled by
// cp.async, wgmma shared-memory descriptors, warpgroup matrix products
// (wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate) with B always from
// shared memory and A from shared memory or registers, and the re-layout of
// an fp32 accumulator into a bf16 register A operand.
//
// Warpgroup fragment of an m64nN fp32 accumulator d[N / 2]: thread (warp w
// of the warpgroup, lane) holds rows 16 w + lane / 4 (half 0) and that + 8
// (half 1); entry i is row half (i >> 1) & 1, column 8 (i >> 2) +
// 2 (lane % 4) + (i & 1). The four lanes of a row are lane ^ 1, lane ^ 2.
// The same thread/element map is the bf16 A operand of m64k16 from
// registers, so P or dS goes from an accumulator to an A operand by packing
// neighbour pairs (to_a) with no data exchange.
//
// Loads use cp.async from every thread of the CTA into the layout that a
// TMA load with SWIZZLE_128B would write, so no tensor map is built on the
// host and no mbarrier wait can stall a CTA for good. A producer warp with
// TMA and mbarrier rings (and setmaxnreg) is the next step for speed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups (the CTA size unless a kernel says otherwise)
constexpr int kWgRows = 64;    // rows of one warpgroup's products
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // scores are kept in log2 units: exp(x) = 2^(x log2 e)
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A tile of ROWS rows x D bf16 is D / 64 column blocks of ROWS rows x 128
// bytes; in each row the eight 16-byte chunks are permuted by the 128-byte
// swizzle (chunk c of row r at c ^ (r % 8)), the layout that TMA's
// SWIZZLE_128B writes and wgmma's 128-byte-swizzle descriptors read. Tiles
// start on 1024-byte boundaries, since the swizzle follows address bits.
template <int ROWS>
__device__ __forceinline__ uint32_t swizzled(int r, int chunk) {
  return (chunk >> 3) * (ROWS * 128) + r * 128 + (((chunk & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's completed cp.async writes become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start copying rows [row0, row0 + ROWS) of a row-major bf16 matrix (row
// stride ld elements) into the swizzled tile at dst; rows at or past n_rows
// are zero-filled and not read. Every thread of the CTA (NT threads) calls it.
template <int ROWS, int D, int NT = kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, long long ld, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert((ROWS * kChunks) % NT == 0, "tile split over the CTA");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + swizzled<ROWS>(r, c), ok ? src + (row0 + r) * ld + c * 8 : src, ok);
  }
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand: rows [r0, ...) of a ROWS-row tile at depth slice kk (16
// elements of D): 8-row groups 1024 bytes apart; the slice is 32 bytes
// into the swizzled row of its 64-column block.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return make_desc(tile + (kk >> 2) * (ROWS * 128) + r0 * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand: the tile is B with K = its rows and N = its D columns;
// slice kk is rows [16 kk, 16 kk + 16). 8-row groups 1024 bytes apart
// (stride offset), 64-column blocks ROWS * 128 bytes apart (leading offset).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[m64 x N] (scale_d ? d + : ) A B^T for one k16 slice, A and B in shared memory (K-major)
template <int N>
__device__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
// d[m64 x N] += A B for one k16 slice, A bf16 in registers, B in shared memory (MN-major)
template <int N>
__device__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Start d = A B^T over depth D: A is rows [a_r0, a_r0 + 64) of an A_ROWS
// tile, B all N rows of an N-row tile, both K-major. Started products run
// between wg_fence() and wg_commit(); wg_wait_all()'s return completes them.
template <int N, int D, int A_ROWS>
__device__ __forceinline__ void start_ss(float (&d)[N / 2], uint32_t a, int a_r0, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_ss<N>(d, desc_k<A_ROWS>(a, a_r0, kk), desc_k<N>(b, 0, kk), kk > 0);
}

// Start d[m64 x D] += A B: A is [64 x K] as bf16 register fragments (K / 16
// slices), B the K-row x D tile at b, read MN-major.
template <int D, int K>
__device__ __forceinline__ void start_rs(float (&d)[D / 2], const uint32_t (&a)[K / 16][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) mma_rs<D>(d, a[kk], desc_mn<K>(b, kk));
}

// one product, completed
template <int N, int D, int A_ROWS>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], uint32_t a, int a_r0, uint32_t b) {
  pin(d);
  wg_fence();
  start_ss<N, D, A_ROWS>(d, a, a_r0, b);
  wg_commit();
  wg_wait_all();
  pin(d);
}

template <int D, int K>
__device__ __forceinline__ void gemm_rs(float (&d)[D / 2], const uint32_t (&a)[K / 16][4], uint32_t b) {
  pin(d);
  wg_fence();
  start_rs<D, K>(d, a, b);
  wg_commit();
  wg_wait_all();
  pin(d);
}

// two independent products in one wgmma group, completed
template <int N, int D, int A_ROWS>
__device__ __forceinline__ void gemm_ss2(float (&d1)[N / 2], uint32_t a1, float (&d2)[N / 2], uint32_t a2,
                                         int a_r0, uint32_t b1, uint32_t b2) {
  pin(d1);
  pin(d2);
  wg_fence();
  start_ss<N, D, A_ROWS>(d1, a1, a_r0, b1);
  start_ss<N, D, A_ROWS>(d2, a2, a_r0, b2);
  wg_commit();
  wg_wait_all();
  pin(d1);
  pin(d2);
}

template <int D, int K>
__device__ __forceinline__ void gemm_rs2(float (&d1)[D / 2], const uint32_t (&a1)[K / 16][4], uint32_t b1,
                                         float (&d2)[D / 2], const uint32_t (&a2)[K / 16][4], uint32_t b2) {
  pin(d1);
  pin(d2);
  wg_fence();
  start_rs<D, K>(d1, a1, b1);
  start_rs<D, K>(d2, a2, b2);
  wg_commit();
  wg_wait_all();
  pin(d1);
  pin(d2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An m64nN fp32 accumulator as the bf16 A operand of N / 16 k16 slices
// (each value rounded to bf16, where the Pallas kernels cast p and dS).
template <int N>
__device__ __forceinline__ void to_a(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// column of accumulator entry i (within its n-tile) and its row half
__device__ __forceinline__ int frag_col(int i, int lane) { return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1); }
__device__ __forceinline__ int frag_half(int i) { return (i >> 1) & 1; }
// the thread's row (half 0 or 1) inside its warpgroup's 64
__device__ __forceinline__ int frag_row(int half) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * half;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write the thread's two rows of an m64 x D accumulator times mul[half] as
// bf16 to row_ptr(half) (nullptr: row skipped).
template <int D, typename RowPtr>
__device__ __forceinline__ void store_rows(const float (&d)[D / 2], const float (&mul)[2], RowPtr row_ptr) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    bf16* dst = row_ptr(half);
    if (dst == nullptr) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(d[4 * j + 2 * half] * mul[half], d[4 * j + 2 * half + 1] * mul[half]);
  }
}

// 1024-byte-aligned start of the dynamic shared memory (plans add 1024
// bytes of slack), as a shared-space address and a generic pointer
struct SmemBase {
  uint32_t addr;
  uint8_t* ptr;
  __device__ __forceinline__ SmemBase(uint8_t* raw) {
    const uint32_t a = smem_u32(raw);
    addr = (a + 1023u) & ~1023u;
    ptr = raw + (addr - a);
  }
};

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace sm90
