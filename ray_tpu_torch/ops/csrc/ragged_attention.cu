// Ragged paged attention for Hopper (sm_90a): mixed prefill + decode.
//
// Replaces the Pallas TPU kernel `_ragged_attn_kernel` / `ragged_attention_pallas`
// (ray_tpu/ops/ragged.py:97,190). Query rows arrive packed, [T, H, D],
// sequence b owning rows [cu_q_lens[b], cu_q_lens[b + 1]). Query j of
// sequence b sits at absolute position ctx_b - q_len_b + j and attends kv
// positions p <= that position and p < ctx_b, over b's pages of the
// head-major cache through its block-table row. GQA is folded into rows
// as the Pallas wrapper folds it: the G query heads of one kv head and
// the q_len queries of one sequence form q_len * G rows, row = j * G + g.
// A q_len = 0 sequence writes nothing; packed rows past cu_q_lens[B] are
// never written (the wrapper allocates the output zeroed, as the Pallas
// output block is zeroed at its first visit).
//
// Two kinds of sequence, each served by its own kernels, all launched over
// the whole batch on one stream; each CTA reads its sequence's q_len on the
// device and exits when the sequence is not its kind, so nothing is read
// back to the host:
//  * q_len = 1, a decode row: the split-KV decode core of the paged kernel
//    (decode_split.cuh: ragged_attention_decode_kernel, then
//    ragged_attention_combine_kernel when there are several splits), so a
//    decode-only batch gives the paged kernel's bits. Bound: bytes.
//  * q_len >= 2, a prefill chunk (or a spec verify):
//      - bf16: ragged_attention_chunk_kernel on the tensor cores. One CTA
//        per (64-row folded tile, kv head, sequence); the Q tile is
//        gathered row by row, and the K/V tiles of 64 positions through
//        the block table, by cp.async into 128-byte-swizzled tiles (3-stage
//        rings, two tiles ahead); S = Q K^T and O += P V run on wgmma
//        (flash_sm90.cuh) with the online softmax in log2 units on the
//        accumulator fragment and the causal-at-absolute-position mask
//        only on tiles that cross a row's limit. Two warpgroups each walk
//        half of the tile's kv range and merge at the end. q stays
//        unscaled in bf16 and the fp32 scores are scaled, as the plain
//        version scales them; p is rounded to bf16 before PV. A chunk's
//        tiles re-read its pages (from L2 mostly). Bound: bytes at the
//        engine's chunk sizes.
//      - fp32: ragged_attention_kernel, the CUDA-core kernel of
//        attention_common.cuh (32 folded rows a CTA), unchanged.
// Tiles are counted from max_q_len; a CTA strides over a longer
// sequence's remaining tiles, so it is still served in full. Chunk tiles
// are issued heaviest first (a chunk's last rows see the most positions).
//
// C interface as in paged_attention.cu.

#include "decode_split.cuh"

namespace {

using rtt::kThreads;
using rtt::Smem;

constexpr int kRows = 32;  // packed rows per CTA tile of the fp32 chunk kernel

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache, const int* __restrict__ block_tables,
                        const int* __restrict__ cu_q_lens, const int* __restrict__ context_lens,
                        T* __restrict__ out, int H, int KVH, int num_slots, int max_blocks,
                        int block_size) {
  extern __shared__ __align__(16) float smem[];
  using S = Smem<D, kRows>;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int q_start = cu_q_lens[b];
  const int q_len = cu_q_lens[b + 1] - q_start;
  if (q_len == 1) return;  // a decode row: the split-KV decode kernel's
  const int ctx = context_lens[b];
  const int rows = max(q_len, 0) * G;
  const int n_tiles = (rows + kRows - 1) / kRows;
  int* pos_s = reinterpret_cast<int*>(smem + S::pos);
  long long* off_s = reinterpret_cast<long long*>(smem + S::off);
  const size_t head = size_t(kvh) * num_slots * D;
  const int* bt_row = block_tables + size_t(b) * max_blocks;

  for (int z = blockIdx.z; z < n_tiles; z += gridDim.z) {
    const int row0 = z * kRows;
    const int n_rows = min(kRows, rows - row0);
    __syncthreads();  // the previous tile's readers of pos_s / off_s are done
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const int row = row0 + r;
      const int j = row / G;
      pos_s[r] = ctx - q_len + j;
      off_s[r] = (static_cast<long long>(q_start + j) * H + kvh * G + row % G) * D;
    }
    __syncthreads();
    // the last position any row of this tile sees, capped by the context
    // and by the block table's width
    const int j_last = (row0 + n_rows - 1) / G;
    int kv_end = min(ctx, ctx - q_len + j_last + 1);
    kv_end = max(0, min(kv_end, max_blocks * block_size));
    rtt::attend<T, D, kRows>(smem, q, out, n_rows, kv_end, k_cache + head, v_cache + head, bt_row,
                             block_size);
  }
}

template <int D>
cudaError_t launch_fp32_chunks(const void* q, const void* k, const void* v, const void* bt,
                               const void* cu, const void* ctx, void* out, int B, int H, int KVH,
                               int num_slots, int max_blocks, int block_size, int max_q_len,
                               cudaStream_t stream) {
  auto kernel = ragged_attention_kernel<float, D>;
  const size_t smem = Smem<D, kRows>::bytes;
  cudaError_t err = rtt::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = H / KVH;
  const long long tiles = (static_cast<long long>(max_q_len) * G + kRows - 1) / kRows;
  const int z = static_cast<int>(tiles < 1 ? 1 : (tiles > 65535 ? 65535 : tiles));
  kernel<<<dim3(KVH, B, z), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(cu), static_cast<const int*>(ctx),
      static_cast<float*>(out), H, KVH, num_slots, max_blocks, block_size);
  return cudaGetLastError();
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(rtd::kThreads, 2)
ragged_attention_decode_kernel(const rtd::DecodeArgs a) {
  extern __shared__ __align__(128) uint8_t decode_smem[];
  rtd::decode_split<T, D, R>(a, decode_smem);
}

template <typename T, int D>
__global__ void __launch_bounds__(D) ragged_attention_combine_kernel(const rtd::DecodeArgs a) {
  rtd::combine_splits<T, D>(a);
}

struct RaggedDecode {
  template <typename T, int D, int R>
  static cudaError_t run(const rtd::DecodeArgs& a, int B, cudaStream_t s) {
    return rtd::launch_decode<T, D, R>(ragged_attention_decode_kernel<T, D, R>,
                                       ragged_attention_combine_kernel<T, D>, a, B, s);
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// bf16 prefill chunks on the tensor cores
// ---------------------------------------------------------------------------

namespace sm90 {

// Two warpgroups share one 64-row q tile and each walks half of its kv
// tiles with a ring of its own; their softmax states merge at the end, so
// a tile deep in a long context takes half as many steps one after another.
constexpr int kChunkWgs = 2;
constexpr int kChunkThreads = kChunkWgs * rtd::kThreads;
constexpr int kTileRows = 64;  // folded q rows and kv positions per tile

template <int D>
struct ChunkPlan {  // byte offsets from the 1024-aligned base
  using KV = rtd::Ring<bf16, D, kTileRows>;
  static constexpr int ring = rtd::kStages * KV::stage;  // one K (or V) ring
  static constexpr int q = 0;                            // [64][D]
  static constexpr int k = q + kTileRows * D * 2;        // per warpgroup: K ring, V ring
  static constexpr int bytes = k + kChunkWgs * 2 * ring + 1024;
  static constexpr int merge = rtd::kThreads * (D / 2 + 4) * 4;  // warpgroup 1's state
  static_assert(merge <= kChunkWgs * 2 * ring, "merge fits the rings");
};

struct ChunkParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* bt;
  const int* cu;
  const int* ctx;
  bf16* out;
  int H, KVH, num_slots, max_blocks, block_size, bs_shift;
  float scale;
};

// a barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(rtd::kThreads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kChunkThreads, 1) ragged_attention_chunk_kernel(const ChunkParams p) {
  using P = ChunkPlan<D>;
  constexpr int BM = kTileRows, BN = kTileRows;
  extern __shared__ uint8_t smem_raw[];
  const SmemBase sm(smem_raw);

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int q_start = p.cu[b];
  const int q_len = p.cu[b + 1] - q_start;
  if (q_len < 2) return;  // decode rows: the split-KV kernel; q_len 0: nothing
  const int G = p.H / p.KVH;
  const int ctx = p.ctx[b];
  const int rows = q_len * G;
  const int n_q_tiles = (rows + BM - 1) / BM;
  const int bs = p.block_size;
  const int kv_cap = p.max_blocks * bs;  // positions past the table's width do not exist
  const size_t head = size_t(kvh) * p.num_slots * D;
  const int* bt_row = p.bt + size_t(b) * p.max_blocks;
  const long long q_ld = static_cast<long long>(p.H) * D;
  const int tid = threadIdx.x, wg = tid / rtd::kThreads, wtid = tid % rtd::kThreads;
  const int lane = tid & 31;
  const float scale2 = p.scale * kLog2e;
  const uint32_t q_s = sm.addr + P::q;
  const uint32_t k_s = sm.addr + P::k + wg * 2 * P::ring, v_s = k_s + P::ring;
  float* merge = reinterpret_cast<float*>(sm.ptr + P::k) + wtid * (D / 2 + 4);

  for (int z = blockIdx.z; z < n_q_tiles; z += gridDim.z) {
    const int row0 = (n_q_tiles - 1 - z) * BM;  // the last rows (most positions) first
    const int n_rows = min(BM, rows - row0);
    const int j_first = row0 / G, j_last = (row0 + n_rows - 1) / G;
    // kv positions any row of the tile sees: [0, kv_end); every position
    // up to lim_first is seen by every row
    const int kv_end = max(0, min(min(ctx, ctx - q_len + j_last + 1), kv_cap));
    const int lim_first = min(ctx - q_len + j_first, kv_cap - 1);
    const int n_kv = (kv_end + BN - 1) / BN;
    // this warpgroup's kv tiles [j0, j1)
    const int j0 = wg == 0 ? 0 : (n_kv + 1) / 2, j1 = wg == 0 ? (n_kv + 1) / 2 : n_kv;

    __syncthreads();  // the previous tile's readers of q_s, the rings and the merge are done
#pragma unroll
    for (int it = 0; it < BM * (D / 8) / kChunkThreads; ++it) {
      const int i = tid + it * kChunkThreads;
      const int r = i / (D / 8), c = i % (D / 8);
      const int row = row0 + r;
      const bool ok = row < rows;
      const bf16* src =
          ok ? p.q + (q_start + row / G) * q_ld + (kvh * G + row % G) * D + c * 8 : p.q;
      cp_async16(q_s + swizzled<BM>(r, c), src, ok);
    }
    // K/V tiles gathered through the block table (the block ids of a tile
    // are loaded one tile ahead of its copies)
    const typename P::KV ring{p.k + head, p.v + head, bt_row, bs, p.bs_shift, 0, kv_end,
                              k_s, v_s, wtid};
    int pg[P::KV::NR];
    if (j0 < j1) {
      ring.fetch(j0, pg);
      ring.issue(j0, pg);
    }
    cp_async_commit();  // with the q tile
    if (j0 + 1 < j1) {
      ring.fetch(j0 + 1, pg);
      ring.issue(j0 + 1, pg);
    }
    cp_async_commit();
    if (j0 + 2 < j1) ring.fetch(j0 + 2, pg);
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();  // the q tile (every thread's part of it) is in

    // each thread's two rows: the last position each sees (rows past the
    // sequence take the tile's bound; they are not written)
    int row[2], lim[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      row[hf] = row0 + frag_row(hf);
      lim[hf] = row[hf] < rows ? min(ctx - q_len + row[hf] / G, kv_cap - 1) : kv_end - 1;
    }
    // m: running max in log2 units; l: this thread's share of the row sum
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    for (int j = j0; j < j1; ++j) {
      cp_async_wait<1>();
      fence_async_smem();
      wg_barrier(wg);  // tile j in; every thread of the warpgroup is done with tile j - 1
      if (j + 2 < j1) ring.issue(j + 2, pg);  // into tile j - 1's stage
      cp_async_commit();
      if (j + 3 < j1) ring.fetch(j + 3, pg);
      const int st = j % rtd::kStages, kv0 = j * BN;
      float s[BN / 2];
      gemm_ss<BN, D, BM>(s, q_s, 0, k_s + st * P::KV::stage);

      const bool edge = kv0 + BN - 1 > lim_first;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = minus_inf();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          if (frag_half(i) != hf) continue;
          float x = s[i] * scale2;
          if (edge && kv0 + frag_col(i, lane) > lim[hf]) x = minus_inf();  // never visited
          s[i] = x;
          mx = fmaxf(mx, x);
        }
        const float m_new = fmaxf(m[hf], quad_max(mx));  // finite: m starts at NEG_INF
        const float alpha = exp2f(m[hf] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          if (frag_half(i) != hf) continue;
          s[i] = exp2f(s[i] - m_new);  // -inf -> 0
          rs += s[i];
        }
        l[hf] = l[hf] * alpha + rs;
        m[hf] = m_new;
#pragma unroll
        for (int i = 0; i < D / 2; ++i)
          if (frag_half(i) == hf) o[i] *= alpha;
      }
      uint32_t pa[BN / 16][4];
      to_a<BN>(s, pa);
      gemm_rs<D, BN>(o, pa, v_s + st * P::KV::stage);
    }
    cp_async_wait<0>();  // nothing in flight into the rings past this tile

    // warpgroup 1 hands its state to warpgroup 0 (same rows, same fragment
    // map), which merges the two halves and writes the rows
    __syncthreads();  // both warpgroups are done with their rings
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) merge[i] = o[i];
      merge[D / 2] = m[0];
      merge[D / 2 + 1] = m[1];
      merge[D / 2 + 2] = l[0];
      merge[D / 2 + 3] = l[1];
    }
    __syncthreads();
    if (wg == 0) {
      float a0[2], a1[2], inv[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float m1 = merge[D / 2 + hf];
        const float mm = fmaxf(m[hf], m1);
        a0[hf] = exp2f(m[hf] - mm);  // a half that saw nothing: NEG_INF -> 0
        a1[hf] = exp2f(m1 - mm);
        const float lr = quad_sum(l[hf] * a0[hf] + merge[D / 2 + 2 + hf] * a1[hf]);
        inv[hf] = 1.f / (lr == 0.f ? 1.f : lr);  // a row that saw nothing -> 0
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = o[i] * a0[frag_half(i)] + merge[i] * a1[frag_half(i)];
      store_rows<D>(o, inv, [&](int hf) -> bf16* {
        const int r = row[hf];
        return r < rows ? p.out + (q_start + r / G) * q_ld + (kvh * G + r % G) * D : nullptr;
      });
    }
  }
}

template <int D>
cudaError_t launch_chunks(const ChunkParams& p, int B, int max_q_len, cudaStream_t stream) {
  auto kernel = ragged_attention_chunk_kernel<D>;
  constexpr int smem = ChunkPlan<D>::bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (static_cast<long long>(max_q_len) * (p.H / p.KVH) + kTileRows - 1) / kTileRows;
  const int z = static_cast<int>(tiles < 1 ? 1 : (tiles > 65535 ? 65535 : tiles));
  // tiles are the slowest grid axis: every sequence's heaviest tile starts first
  kernel<<<dim3(p.KVH, B, z), kChunkThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/out [T, H, D] (out pre-zeroed),
// caches [KVH, num_slots, D] (one layer), block_tables [B, max_blocks],
// cu_q_lens [B + 1], context_lens [B], all int32 and contiguous; workspace
// fp32 [B, H, splits, D + 2] for the decode rows when splits > 1, else null.
int ragged_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                            const void* block_tables, const void* cu_q_lens,
                            const void* context_lens, void* out, int B, int H, int KVH, int D,
                            int num_slots, int max_blocks, int block_size, int max_q_len,
                            int splits, void* workspace, int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || block_size <= 0 || max_q_len < 1) return cudaErrorInvalidValue;
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cu = static_cast<const int*>(cu_q_lens);
  const int* ctx = static_cast<const int*>(context_lens);
  const int shift = rtd::pow2_shift(block_size);
  const rtd::DecodeArgs a{q, k_cache, v_cache, bt, ctx, cu, out, static_cast<float*>(workspace),
                          H, KVH, num_slots, max_blocks, block_size, splits, shift};
  cudaError_t err = rtd::dispatch_decode<RaggedDecode>(dtype, D, a, B, s);
  if (err != cudaSuccess) return err;
  if (dtype == 1) {
    const sm90::ChunkParams p{static_cast<const sm90::bf16*>(q),
                              static_cast<const sm90::bf16*>(k_cache),
                              static_cast<const sm90::bf16*>(v_cache), bt, cu, ctx,
                              static_cast<sm90::bf16*>(out), H, KVH, num_slots, max_blocks,
                              block_size, shift, 1.0f / sqrtf(static_cast<float>(D))};
    return D == 64 ? sm90::launch_chunks<64>(p, B, max_q_len, s)
                   : sm90::launch_chunks<128>(p, B, max_q_len, s);
  }
  return D == 64 ? launch_fp32_chunks<64>(q, k_cache, v_cache, block_tables, cu_q_lens,
                                          context_lens, out, B, H, KVH, num_slots, max_blocks,
                                          block_size, max_q_len, s)
                 : launch_fp32_chunks<128>(q, k_cache, v_cache, block_tables, cu_q_lens,
                                           context_lens, out, B, H, KVH, num_slots, max_blocks,
                                           block_size, max_q_len, s);
}

const char* ragged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
