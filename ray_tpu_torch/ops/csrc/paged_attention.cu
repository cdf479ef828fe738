// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_attn_kernel` / `paged_attention_pallas`
// (ray_tpu/ops/paged_attention.py:74,141): one query token per sequence
// attends over its pages of the head-major cache [KVH, num_slots, D]
// through the block table, GQA group per (sequence, kv head), fp32 online
// softmax, mask pos < ctx, scale 1/sqrt(D), pages past the context never
// read, and 0 for a pad row with ctx = 0.
//
// Bound: bytes. Design: split-KV flash-decoding (decode_split.cuh). The
// Pallas kernel walks a sequence's pages along a sequential grid axis; here
// the pages of each (sequence, kv head) are cut into `splits` ranges, one
// CTA each, so B x KVH x splits CTAs keep every SM streaming pages through
// a cp.async ring; paged_attention_combine_kernel merges the splits.
//
// C interface (bound with ctypes, launched on the caller's stream, no
// allocation): returns the cudaError_t of the launch; an unsupported
// dtype / head_dim, or a split count that does not match the workspace,
// returns cudaErrorInvalidValue.

#include "decode_split.cuh"

namespace {

template <typename T, int D, int R>
__global__ void __launch_bounds__(rtd::kThreads, 2)
paged_attention_split_kernel(const rtd::DecodeArgs a) {
  extern __shared__ __align__(128) uint8_t decode_smem[];
  rtd::decode_split<T, D, R>(a, decode_smem);
}

template <typename T, int D>
__global__ void __launch_bounds__(D) paged_attention_combine_kernel(const rtd::DecodeArgs a) {
  rtd::combine_splits<T, D>(a);
}

struct Paged {
  template <typename T, int D, int R>
  static cudaError_t run(const rtd::DecodeArgs& a, int B, cudaStream_t s) {
    return rtd::launch_decode<T, D, R>(paged_attention_split_kernel<T, D, R>,
                                       paged_attention_combine_kernel<T, D>, a, B, s);
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. All pointers are device pointers to
// contiguous tensors: q/out [B, H, D], caches [KVH, num_slots, D] (one
// layer), block_tables [B, max_blocks] int32, context_lens [B] int32;
// workspace fp32 [B, H, splits, D + 2] when splits > 1, else null.
int paged_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                           const void* block_tables, const void* context_lens, void* out, int B,
                           int H, int KVH, int D, int num_slots, int max_blocks, int block_size,
                           int splits, void* workspace, int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || block_size <= 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const rtd::DecodeArgs a{q, k_cache, v_cache, static_cast<const int*>(block_tables),
                          static_cast<const int*>(context_lens), nullptr, out,
                          static_cast<float*>(workspace), H, KVH, num_slots, max_blocks,
                          block_size, splits, rtd::pow2_shift(block_size)};
  return rtd::dispatch_decode<Paged>(dtype, D, a, B, static_cast<cudaStream_t>(stream));
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
