// CUDA-core attention over the paged cache, and helpers the serving
// kernels share. `attend` serves the fp32 prefill chunks of the ragged
// kernel (ragged_attention.cu); decode rows go to the split-KV core
// (decode_split.cuh) and bf16 chunks to the tensor cores. In `attend`, up
// to R query rows of ONE kv head attend over one sequence's kv positions
// [0, kv_end), read through its block-table row from the head-major paged
// cache [KVH, num_slots, D].
//
// Bound on an H100: bytes. Decode and short-query attention do about one
// multiply-add per K/V element they read (G query rows per kv head), far
// below the ~295 FLOP/byte ridge, so the time is the K/V pages read from
// HBM. The design reads every page of a (sequence, kv head) once per CTA
// with 16-byte vector loads, keeps the query rows, the page tile and the
// online-softmax state on chip (shared memory and registers), and writes
// each output row once. The Pallas kernels' sequential page grid axis and
// the VMEM scratch they carry across it become the kv loop inside one CTA.
//
// Layout and numerics follow ray_tpu/ops/paged_attention.py:
//  * slot = block_tables[b, pos / block_size] * block_size + pos % block_size;
//  * q is scaled by 1/sqrt(D) before the dot product, softmax in fp32;
//  * the finite NEG_INF sentinel (-1e30) masks scores, and masked
//    positions contribute exactly 0;
//  * a row that sees no position (ctx = 0) writes 0 (the Pallas `safe_l`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr int kThreads = 128;              // 4 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // kv positions per loop step (one per lane)
constexpr float kNegInf = -1e30f;

template <typename T> struct VecOf;        // 16-byte vector of T
template <> struct VecOf<float> { static constexpr int n = 4; };

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory plan, in 4-byte words. The K tile rows are padded to D + 1
// words so the 32 lanes of a warp, each reading its own kv position at
// the same feature, hit 32 different banks.
template <int D, int R>
struct Smem {
  static constexpr int q = 0;                          // [R][D] scaled query rows
  static constexpr int k = q + R * D;                  // [kTile][D + 1]
  static constexpr int v = k + kTile * (D + 1);        // [kTile][D]
  static constexpr int p = v + kTile * D;              // [R][kTile] probabilities
  static constexpr int alpha = p + R * kTile;          // [R] rescale of this step
  static constexpr int l = alpha + R;                  // [R] final denominators
  static constexpr int pos = l + R;                    // [R] int: last visible kv position
  static constexpr int off = ((pos + R + 1) / 2) * 2;  // [R] int64: row offset in q/out
  static constexpr int words = off + 2 * R;
  static constexpr size_t bytes = size_t(words) * 4;
};

// The caller has written, for each of the first n_rows rows, its element
// offset into q/out (both [*, H, D] row-major) to off_s and the last kv
// position it may see to pos_s, then synchronised. Every thread of the CTA
// must call this with the same arguments.
template <typename T, int D, int R>
__device__ __forceinline__ void attend(float* smem, const T* __restrict__ q, T* __restrict__ out,
                                       int n_rows, int kv_end, const T* __restrict__ k_head,
                                       const T* __restrict__ v_head,
                                       const int* __restrict__ bt_row, int block_size) {
  using S = Smem<D, R>;
  constexpr int kVec = VecOf<T>::n;
  constexpr int kChunks = D / kVec;          // 16-byte chunks per row
  constexpr int kRpw = R / kWarps;           // score rows per warp
  constexpr int kRstep = kThreads / D;       // PV: rows r0, r0 + kRstep, ...
  constexpr int kRpt = R / kRstep;           // PV accumulators per thread
  static_assert(R % kWarps == 0 && R % kRstep == 0, "row tiling");

  float* q_s = smem + S::q;
  float* k_s = smem + S::k;
  float* v_s = smem + S::v;
  float* p_s = smem + S::p;
  float* alpha_s = smem + S::alpha;
  float* l_s = smem + S::l;
  const int* pos_s = reinterpret_cast<const int*>(smem + S::pos);
  const long long* off_s = reinterpret_cast<const long long*>(smem + S::off);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float scale = 1.0f / sqrtf(float(D));

  // query rows, pre-scaled as the Pallas kernel scales them
  for (int i = tid; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    float x[kVec];
    if (r < n_rows) {
      load16(q + off_s[r] + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) q_s[r * D + c + e] = x[e] * scale;
  }

  float m[kRpw], l[kRpw], acc[kRpt];
#pragma unroll
  for (int k = 0; k < kRpw; ++k) { m[k] = kNegInf; l[k] = 0.f; }
#pragma unroll
  for (int k = 0; k < kRpt; ++k) acc[k] = 0.f;
  const int d_col = tid % D;
  const int r0 = tid / D;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // q_s written / the previous step's readers are done

    // gather this step's K and V through the block table; positions at or
    // past kv_end are never looked up (their table entries may be padding
    // that names another sequence's block) and are zero-filled
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int t = i / kChunks;
      const int c = (i % kChunks) * kVec;
      const int pos = kv0 + t;
      float kx[kVec], vx[kVec];
      if (pos < kv_end) {
        const size_t slot = size_t(bt_row[pos / block_size]) * block_size + pos % block_size;
        load16(k_head + slot * D + c, kx);
        load16(v_head + slot * D + c, vx);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) { kx[e] = 0.f; vx[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[t * (D + 1) + c + e] = kx[e];
        v_s[t * D + c + e] = vx[e];
      }
    }
    __syncthreads();

    // scores: warp w owns rows w, w + 4, ...; lane owns kv position kv0 + lane
    const int pos = kv0 + lane;
    float s[kRpw];
#pragma unroll
    for (int k = 0; k < kRpw; ++k) s[k] = 0.f;
    const float* k_row = k_s + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = k_row[d];
#pragma unroll
      for (int k = 0; k < kRpw; ++k) s[k] += q_s[(warp + k * kWarps) * D + d] * kd;
    }
    // online softmax update, one row per (warp, k); the row state is
    // replicated in every lane of its warp
#pragma unroll
    for (int k = 0; k < kRpw; ++k) {
      const int r = warp + k * kWarps;
      const bool ok = r < n_rows && pos < kv_end && pos <= pos_s[r];
      const float sv = ok ? s[k] : kNegInf;
      const float m_new = fmaxf(m[k], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[k] - m_new);
      l[k] = alpha * l[k] + warp_sum(p);
      m[k] = m_new;
      p_s[r * kTile + lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha[r] + sum_t p[r][t] * V[t][d]
#pragma unroll
    for (int k = 0; k < kRpt; ++k) acc[k] *= alpha_s[r0 + k * kRstep];
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      const float vt = v_s[t * D + d_col];
#pragma unroll
      for (int k = 0; k < kRpt; ++k) acc[k] += p_s[(r0 + k * kRstep) * kTile + t] * vt;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kRpw; ++k) l_s[warp + k * kWarps] = l[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int r = r0 + k * kRstep;
    if (r < n_rows) {
      const float lr = l_s[r];
      store(out + off_s[r] + d_col, acc[k] / (lr == 0.f ? 1.f : lr));
    }
  }
}

// Raise a kernel's dynamic shared memory limit where its plan needs more
// than the default 48 KB.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace rtt
