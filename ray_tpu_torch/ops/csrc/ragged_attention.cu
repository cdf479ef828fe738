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
// Bound: bytes for decode rows and short chunks, as for the paged decode
// kernel (attention_common.cuh). One CTA per (kv head, sequence, tile of
// R = 32 packed rows); it walks the sequence's pages only up to the last
// position any row of its tile can see, so a tile of early prompt rows
// stops early. A sequence with q_len * G > R rows is served by several
// CTAs that each read its pages, so long prefill chunks re-read K/V (from
// L2 mostly); a later PR moves them to wgmma tiles. The per-sequence
// q_len is read at run time: the grid's third axis is sized from
// max_q_len and each CTA strides over tiles, so a longer sequence is still
// served in full.
//
// C interface as in paged_attention.cu.

#include "attention_common.cuh"

namespace {

using rtt::kThreads;
using rtt::Smem;

constexpr int kRows = 32;  // packed rows per CTA tile

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bt, const void* cu,
                   const void* ctx, void* out, int B, int H, int KVH, int num_slots,
                   int max_blocks, int block_size, int max_q_len, cudaStream_t stream) {
  auto kernel = ragged_attention_kernel<T, D>;
  const size_t smem = Smem<D, kRows>::bytes;
  cudaError_t err = rtt::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = H / KVH;
  const long long tiles = (static_cast<long long>(max_q_len) * G + kRows - 1) / kRows;
  const int z = static_cast<int>(tiles < 1 ? 1 : (tiles > 65535 ? 65535 : tiles));
  kernel<<<dim3(KVH, B, z), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(cu), static_cast<const int*>(ctx),
      static_cast<T*>(out), H, KVH, num_slots, max_blocks, block_size);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pick_dim(int D, const void* q, const void* k, const void* v, const void* bt,
                     const void* cu, const void* ctx, void* out, int B, int H, int KVH,
                     int num_slots, int max_blocks, int block_size, int max_q_len,
                     cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, k, v, bt, cu, ctx, out, B, H, KVH, num_slots, max_blocks, block_size, max_q_len, s);
  if (D == 128)
    return launch<T, 128>(q, k, v, bt, cu, ctx, out, B, H, KVH, num_slots, max_blocks, block_size, max_q_len, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/out [T, H, D] (out pre-zeroed),
// caches [KVH, num_slots, D] (one layer), block_tables [B, max_blocks],
// cu_q_lens [B + 1], context_lens [B], all int32 and contiguous.
int ragged_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                            const void* block_tables, const void* cu_q_lens,
                            const void* context_lens, void* out, int B, int H, int KVH, int D,
                            int num_slots, int max_blocks, int block_size, int max_q_len,
                            int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || block_size <= 0 || max_q_len < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pick_dim<float>(D, q, k_cache, v_cache, block_tables, cu_q_lens, context_lens, out, B,
                           H, KVH, num_slots, max_blocks, block_size, max_q_len, s);
  if (dtype == 1)
    return pick_dim<__nv_bfloat16>(D, q, k_cache, v_cache, block_tables, cu_q_lens, context_lens,
                                   out, B, H, KVH, num_slots, max_blocks, block_size, max_q_len, s);
  return cudaErrorInvalidValue;
}

const char* ragged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
