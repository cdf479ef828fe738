// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_attn_kernel` / `paged_attention_pallas`
// (ray_tpu/ops/paged_attention.py:74,141): one query token per sequence
// attends over its pages of the head-major cache [KVH, num_slots, D]
// through the block table, GQA group per (sequence, kv head), fp32 online
// softmax, mask pos < ctx, scale 1/sqrt(D), pages past the context never
// read, and 0 for a pad row with ctx = 0.
//
// Bound: bytes (see attention_common.cuh). One CTA per (sequence, kv head)
// reads each of that head's ceil(ctx / block_size) pages exactly once and
// serves all G = H / KVH query heads of the group from it, so the K/V
// bytes read equal the bytes the function must read. Each page of one kv
// head is a contiguous block_size x D tile, loaded 16 bytes per thread.
// A later PR splits long contexts over several CTAs (split-KV) to fill the
// card when B * KVH is below the SM count.
//
// C interface (bound with ctypes, launched on the caller's stream, no
// allocation): returns the cudaError_t of the launch; an unsupported
// dtype / head_dim / group size returns cudaErrorInvalidValue.

#include "attention_common.cuh"

namespace {

using rtt::kThreads;
using rtt::Smem;

template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                       const T* __restrict__ v_cache, const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens, T* __restrict__ out, int H, int KVH,
                       int num_slots, int max_blocks, int block_size) {
  extern __shared__ __align__(16) float smem[];
  using S = Smem<D, R>;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KVH;
  const int ctx = context_lens[b];
  int* pos_s = reinterpret_cast<int*>(smem + S::pos);
  long long* off_s = reinterpret_cast<long long*>(smem + S::off);
  for (int r = threadIdx.x; r < R; r += kThreads) {
    pos_s[r] = ctx - 1;
    off_s[r] = (static_cast<long long>(b) * H + kvh * G + r) * D;
  }
  __syncthreads();
  // positions past the block table's width do not exist (the reference
  // gathers max_blocks * block_size positions)
  const int kv_end = max(0, min(ctx, max_blocks * block_size));
  const size_t head = size_t(kvh) * num_slots * D;
  rtt::attend<T, D, R>(smem, q, out, G, kv_end, k_cache + head, v_cache + head,
                       block_tables + size_t(b) * max_blocks, block_size);
}

template <typename T, int D, int R>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bt, const void* ctx,
                   void* out, int B, int H, int KVH, int num_slots, int max_blocks,
                   int block_size, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, D, R>;
  const size_t smem = Smem<D, R>::bytes;
  cudaError_t err = rtt::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, KVH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(bt), static_cast<const int*>(ctx), static_cast<T*>(out), H, KVH,
      num_slots, max_blocks, block_size);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t pick_rows(int G, const void* q, const void* k, const void* v, const void* bt,
                      const void* ctx, void* out, int B, int H, int KVH, int num_slots,
                      int max_blocks, int block_size, cudaStream_t s) {
  if (G <= 4) return launch<T, D, 4>(q, k, v, bt, ctx, out, B, H, KVH, num_slots, max_blocks, block_size, s);
  if (G <= 8) return launch<T, D, 8>(q, k, v, bt, ctx, out, B, H, KVH, num_slots, max_blocks, block_size, s);
  if (G <= 16) return launch<T, D, 16>(q, k, v, bt, ctx, out, B, H, KVH, num_slots, max_blocks, block_size, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t pick_dim(int D, int G, const void* q, const void* k, const void* v, const void* bt,
                     const void* ctx, void* out, int B, int H, int KVH, int num_slots,
                     int max_blocks, int block_size, cudaStream_t s) {
  if (D == 64) return pick_rows<T, 64>(G, q, k, v, bt, ctx, out, B, H, KVH, num_slots, max_blocks, block_size, s);
  if (D == 128) return pick_rows<T, 128>(G, q, k, v, bt, ctx, out, B, H, KVH, num_slots, max_blocks, block_size, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers to
// contiguous tensors: q/out [B, H, D], caches [KVH, num_slots, D] (one
// layer), block_tables [B, max_blocks] int32, context_lens [B] int32.
int paged_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                           const void* block_tables, const void* context_lens, void* out, int B,
                           int H, int KVH, int D, int num_slots, int max_blocks, int block_size,
                           int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || block_size <= 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int G = H / KVH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pick_dim<float>(D, G, q, k_cache, v_cache, block_tables, context_lens, out, B, H, KVH,
                           num_slots, max_blocks, block_size, s);
  if (dtype == 1)
    return pick_dim<__nv_bfloat16>(D, G, q, k_cache, v_cache, block_tables, context_lens, out, B,
                                   H, KVH, num_slots, max_blocks, block_size, s);
  return cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
