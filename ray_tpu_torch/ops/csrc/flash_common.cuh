// Shared core of the flash-attention training kernels (flash_fwd.cu,
// flash_bwd.cu): 64 x 64 tiles of scores computed on fp32 CUDA cores from
// operands staged in shared memory.
//
// Thread map (256 threads, 8 warps): thread (tr, tc) = (tid / 16, tid % 16).
//  * A score tile S[r][c] (64 rows x 64 columns): the thread owns rows
//    tr + 16 i and columns tc + 16 j (i, j < 4). The 16 threads of one row
//    group sit in one half-warp, so a row reduction is four xor-shuffles.
//  * An output tile O[r][d] (64 rows x D): rows tr + 16 i, features
//    64 jj + 4 tc + e (e < 4, jj < D / 64), i.e. one 16-byte vector per
//    (row, jj); a quarter-warp then reads 8 consecutive vectors of a row,
//    conflict-free.
// Operands of a dot over D sit in rows padded to D + 4 floats: 16-byte
// vector reads of 8 different rows (one per lane of a quarter-warp) then
// fall in 8 disjoint groups of 4 banks.
//
// Masking follows ray_tpu/ops/flash.py: each row r carries lim[r], the
// last kv position it may see (causal: min(Sk - 1, q_offset + q); else
// Sk - 1; -1 for rows past Sq), and optionally a segment id. A kv
// position is in the row's window when pos <= lim[r], and valid when it
// is in the window and of the row's segment.
#pragma once

#include "attention_common.cuh"

namespace rtf {

using rtt::load16;
using rtt::store;
using rtt::VecOf;

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows and columns of a score tile
constexpr int kPer = kTile / 16;   // rows (and score columns) per thread
constexpr int kPS = kTile + 4;     // row stride of a score tile in shared memory
constexpr float kNegInf = -1e30f;  // the Pallas kernels' finite mask value

constexpr int kPad = 4;            // floats of padding after each operand row

__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

// Round to the input dtype and back, where the reference casts p or dS
// to the input dtype before a product.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage 64 rows of D elements into dst (row stride ld floats) as fp32.
// row_src(r) gives row r's first element, or nullptr for a zero row.
template <typename T, int D, typename RowSrc>
__device__ __forceinline__ void stage_rows(float* dst, int ld, RowSrc row_src) {
  constexpr int kVec = VecOf<T>::n;
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    const T* src = row_src(r);
    float x[kVec];
    if (src != nullptr) {
      load16(src + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * ld + c + e] = x[e];
  }
}

// acc[i][j] = sum_d A[tr + 16 i][d] * B[tc + 16 j][d]; A and B rows padded.
template <int D>
__device__ __forceinline__ void dot_rows(const float* A, const float* B, int tr, int tc,
                                         float (&acc)[kPer][kPer]) {
  constexpr int ld = D + kPad;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = *reinterpret_cast<const float4*>(A + (tr + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tc + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][4 jj + e] += sum_t P[tr + 16 i][t] * M[t][64 jj + 4 tc + e]
// (P a score tile, stride kPS; M rows of D features, stride ldm).
template <int D>
__device__ __forceinline__ void mul_tile(const float* P, const float* M, int ldm, int tr, int tc,
                                         float (&acc)[kPer][D / 16]) {
#pragma unroll 2
  for (int t = 0; t < kTile; t += 4) {
    float4 p[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) p[i] = *reinterpret_cast<const float4*>(P + (tr + 16 * i) * kPS + t);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 m = *reinterpret_cast<const float4*>(M + (t + tt) * ldm + 64 * jj + 4 * tc);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const float pv = (&p[i].x)[tt];
          acc[i][4 * jj + 0] = fmaf(pv, m.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(pv, m.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(pv, m.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(pv, m.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }
}

// acc[i][4 jj + e] += sum_r P[r][tr + 16 i] * M[r][64 jj + 4 tc + e]
// (the transposed product: the thread's rows are columns of P).
template <int D>
__device__ __forceinline__ void mul_tile_t(const float* P, const float* M, int ldm, int tr, int tc,
                                           float (&acc)[kPer][D / 16]) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float p[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) p[i] = P[r * kPS + tr + 16 * i];
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      const float4 m = *reinterpret_cast<const float4*>(M + r * ldm + 64 * jj + 4 * tc);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        acc[i][4 * jj + 0] = fmaf(p[i], m.x, acc[i][4 * jj + 0]);
        acc[i][4 * jj + 1] = fmaf(p[i], m.y, acc[i][4 * jj + 1]);
        acc[i][4 * jj + 2] = fmaf(p[i], m.z, acc[i][4 * jj + 2]);
        acc[i][4 * jj + 3] = fmaf(p[i], m.w, acc[i][4 * jj + 3]);
      }
    }
  }
}

// Write the thread's rows of an output tile: row r goes to dst_row(r)
// (nullptr: skipped), scaled by mul[i].
template <typename T, int D, typename RowDst>
__device__ __forceinline__ void write_rows(const float (&acc)[kPer][D / 16], const float (&mul)[kPer],
                                           int tr, int tc, RowDst dst_row) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    T* dst = dst_row(tr + 16 * i);
    if (dst == nullptr) continue;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) store(dst + 64 * jj + 4 * tc + e, acc[i][4 * jj + e] * mul[i]);
  }
}

// Window / validity of score element (row r, kv position pos).
struct RowMask {
  const int* lim;   // [kTile] last visible kv position per row, -1: none
  const int* qseg;  // [kTile] or nullptr
  const int* kseg;  // [kTile] segment per tile column, or nullptr
  __device__ __forceinline__ bool in_window(int r, int pos) const { return pos <= lim[r]; }
  __device__ __forceinline__ bool valid(int r, int c, int pos) const {
    return pos <= lim[r] && (qseg == nullptr || qseg[r] == kseg[c]);
  }
};

}  // namespace rtf
