// Flash-attention backward for Hopper (sm_90a): two deterministic kernels.
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/flash.py's backward:
// `_bwd_fused_kernel` (:491, the default when the whole kv sequence is one
// block), and `_dq_kernel` (:251) + `_dkv_kernel` (:323) (used when the
// kv sequence spans several blocks). The fused-versus-split choice there
// follows TPU VMEM limits; here one design serves every length:
//
//  * flash_dkv_kernel: one CTA per (kv tile of 64, kv head, batch). It
//    loops over the G query heads of the group and over the q tiles from
//    the causal diagonal on, recomputes p = exp(s - lse), and accumulates
//    dV += p^T dO and dK += dS^T q in registers, then writes each once.
//    The group sum of GQA happens inside the CTA, in a fixed order, so no
//    atomics and the result is the same run to run.
//  * flash_dq_kernel: one CTA per (q tile, kv head, batch) with the G
//    heads folded into its 64 rows as in the forward; it loops over the
//    kv tiles up to its causal limit and accumulates dQ += dS k.
// with dP = dO V^T and dS = p * (dP - delta) * scale, delta = rowsum(dO * O)
// - dlse computed by the caller (the reference computes it outside every
// pallas_call too). p and dS are rounded to the input dtype before their
// products, where the Pallas kernels cast them. Entries outside a row's
// window or segment give p = 0, so a fully-masked row has zero gradient,
// as in the Pallas backward.
//
// Bound on an H100: operations (2.5x the forward's FLOPs at the same
// bytes: s and dP in both kernels, plus the three gradient products).
// Both kernels run on fp32 CUDA cores with 16-byte shared-memory reads;
// s and dP are computed twice (once per kernel), the price of having no
// atomics.
//
// The design above is the fp32 pair, kept for fp32 inputs. bf16 inputs go
// to sm90::flash_dkv_kernel and sm90::flash_dq_kernel below, on the tensor
// cores, with the same two-kernel, atomic-free structure (deterministic).
//
// bf16 design. Bound at the training shape: operations, 10 * D FLOPs per
// visible pair (the minimum: s, dP, dV, dK, dQ), 43 GFLOP against 989
// TFLOP/s of dense bf16 (0.043 ms). This design does 14 * D (s and dP in
// both kernels). Every product is a warpgroup wgmma.mma_async (bf16 in,
// fp32 accumulators in registers) from 128-byte-swizzled shared-memory
// tiles filled by cp.async, two stages so the next tile is in flight while
// the current one is computed; every second product takes its A operand
// (p^T, dS^T or dS, rounded to bf16 where the Pallas kernels cast them)
// from the registers of the first:
//  * sm90::flash_dkv_kernel: one CTA per (kv tile, kv head, batch), 64 kv
//    rows per warpgroup (one warpgroup at D 64, so that three CTAs share
//    an SM; two at D 128), kv tile 0 first. It walks the group's G
//    heads and, from the causal diagonal on, their 64-row q tiles:
//    S^T = K Q^T and dP^T = V dO^T (m64n64k16, K-major operands), then
//    dV += P^T dO and dK += dS^T Q (m64nDk16, register A, dO / Q read
//    MN-major). The GQA sum is this loop's fixed order.
//  * sm90::flash_dq_kernel: one CTA of two warpgroups per (128 q rows, q
//    head, batch; two CTAs an SM at D 64), q tiles in reverse (the most
//    causal work first), over
//    64-row kv tiles up to the causal limit: S = Q K^T, dP = dO V^T, then
//    dQ += dS K (register A, K read MN-major).
// The mask is evaluated only on tiles that cross the diagonal, a segment,
// Sq or Sk.
//
// C interface (ctypes, caller's stream, no allocation): returns the
// cudaError_t of the launches.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace rtf;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* d_o;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const int* qseg;
  const int* kseg;
  void* dq;
  void* dk;
  void* dv;
  int Sq, Sk, H, KVH, q_offset, causal;
  float scale;
};

// The shared-memory plan of both kernels: four operand tiles, two score
// tiles, and per-row / per-column scalars.
template <int D>
struct BwdSmem {
  static constexpr int ld = D + kPad;
  static constexpr int a = 0;                  // [64][ld]
  static constexpr int b = a + kTile * ld;     // [64][ld]
  static constexpr int c = b + kTile * ld;     // [64][ld]
  static constexpr int d = c + kTile * ld;     // [64][ld]
  static constexpr int p = d + kTile * ld;     // [64][kPS]
  static constexpr int ds = p + kTile * kPS;   // [64][kPS]
  static constexpr int lse = ds + kTile * kPS; // [64]
  static constexpr int delta = lse + kTile;    // [64]
  static constexpr int lim = delta + kTile;    // int [64]
  static constexpr int qseg = lim + kTile;     // int [64]
  static constexpr int kseg = qseg + kTile;    // int [64]
  static constexpr size_t bytes = size_t(kseg + kTile) * 4;
};

// p and dS of one 64 x 64 tile (rows: q, columns: kv) into p_s / ds_s,
// from the staged q, dO (rows) and K, V (columns).
template <typename T, int D>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* do_s, const float* k_s,
                                         const float* v_s, const float* lse_s,
                                         const float* delta_s, const RowMask& mask, int kv0,
                                         float scale, int tr, int tc, float* p_s, float* ds_s) {
  float s[kPer][kPer], dp[kPer][kPer];
  dot_rows<D>(q_s, k_s, tr, tc, s);
  dot_rows<D>(do_s, v_s, tr, tc, dp);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tr + 16 * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tc + 16 * j;
      float p = 0.f, ds = 0.f;
      if (mask.valid(r, c, kv0 + c)) {
        p = expf(s[i][j] * scale - lse_s[r]);
        ds = p * (dp[i][j] - delta_s[r]) * scale;
      }
      if (p_s != nullptr) p_s[r * kPS + c] = round_to<T>(p);
      ds_s[r * kPS + c] = round_to<T>(ds);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  using S = BwdSmem<D>;
  float* k_s = smem + S::a;
  float* v_s = smem + S::b;
  float* q_s = smem + S::c;
  float* do_s = smem + S::d;
  float* p_s = smem + S::p;
  float* ds_s = smem + S::ds;
  float* lse_s = smem + S::lse;
  float* delta_s = smem + S::delta;
  int* lim_s = reinterpret_cast<int*>(smem + S::lim);
  int* qseg_s = reinterpret_cast<int*>(smem + S::qseg);
  int* kseg_s = reinterpret_cast<int*>(smem + S::kseg);

  const int G = a.H / a.KVH;
  const int kv0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const bool has_seg = a.qseg != nullptr;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* d_o = static_cast<const T*>(a.d_o);

  auto kv_row = [&](int t) -> long long {
    const int pos = kv0 + t;
    if (pos >= a.Sk) return -1;
    return ((static_cast<long long>(b) * a.Sk + pos) * a.KVH + kvh) * D;
  };
  stage_rows<T, D>(k_s, S::ld, [&](int t) -> const T* {
    const long long off = kv_row(t);
    return off < 0 ? nullptr : k + off;
  });
  stage_rows<T, D>(v_s, S::ld, [&](int t) -> const T* {
    const long long off = kv_row(t);
    return off < 0 ? nullptr : v + off;
  });
  if (has_seg && tid < kTile) {
    const int pos = kv0 + tid;
    kseg_s[tid] = pos < a.Sk ? a.kseg[static_cast<long long>(b) * a.Sk + pos] : 0;
  }
  const RowMask mask{lim_s, has_seg ? qseg_s : nullptr, kseg_s};

  float dk[kPer][D / 16], dv[kPer][D / 16];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal: only query positions with q_offset + q >= kv0 see this tile
  const int q_start = a.causal ? max(0, kv0 - a.q_offset) : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = q_start; q0 < a.Sq; q0 += kTile) {
      __syncthreads();  // previous q tile's readers are done
      auto q_row = [&](int r) -> long long {
        const int qi = q0 + r;
        if (qi >= a.Sq) return -1;
        return ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * D;
      };
      stage_rows<T, D>(q_s, S::ld, [&](int r) -> const T* {
        const long long off = q_row(r);
        return off < 0 ? nullptr : q + off;
      });
      stage_rows<T, D>(do_s, S::ld, [&](int r) -> const T* {
        const long long off = q_row(r);
        return off < 0 ? nullptr : d_o + off;
      });
      if (tid < kTile) {
        const int qi = q0 + tid;
        const bool ok = qi < a.Sq;
        const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + qi;
        lim_s[tid] = ok ? (a.causal ? min(a.Sk - 1, a.q_offset + qi) : a.Sk - 1) : -1;
        lse_s[tid] = ok ? a.lse[row] : 0.f;
        delta_s[tid] = ok ? a.delta[row] : 0.f;
        qseg_s[tid] = (has_seg && ok) ? a.qseg[static_cast<long long>(b) * a.Sq + qi] : 0;
      }
      __syncthreads();
      p_and_ds<T, D>(q_s, do_s, k_s, v_s, lse_s, delta_s, mask, kv0, a.scale, tr, tc, p_s, ds_s);
      __syncthreads();
      mul_tile_t<D>(p_s, do_s, S::ld, tr, tc, dv);
      mul_tile_t<D>(ds_s, q_s, S::ld, tr, tc, dk);
    }
  }

  const float one[kPer] = {1.f, 1.f, 1.f, 1.f};
  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
  write_rows<T, D>(dk, one, tr, tc, [&](int t) -> T* {
    const long long off = kv_row(t);
    return off < 0 ? nullptr : dk_out + off;
  });
  write_rows<T, D>(dv, one, tr, tc, [&](int t) -> T* {
    const long long off = kv_row(t);
    return off < 0 ? nullptr : dv_out + off;
  });
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  using S = BwdSmem<D>;
  float* q_s = smem + S::a;
  float* do_s = smem + S::b;
  float* k_s = smem + S::c;
  float* v_s = smem + S::d;
  float* ds_s = smem + S::ds;
  float* lse_s = smem + S::lse;
  float* delta_s = smem + S::delta;
  int* lim_s = reinterpret_cast<int*>(smem + S::lim);
  int* qseg_s = reinterpret_cast<int*>(smem + S::qseg);
  int* kseg_s = reinterpret_cast<int*>(smem + S::kseg);

  const int G = a.H / a.KVH;
  const int BQ = kTile / G;
  const int q0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const bool has_seg = a.qseg != nullptr;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  // row r -> (query position q0 + r % BQ, head kvh * G + r / BQ), as the forward
  auto q_row = [&](int r) -> long long {
    const int qi = q0 + r % BQ;
    if (qi >= a.Sq) return -1;
    return ((static_cast<long long>(b) * a.Sq + qi) * a.H + kvh * G + r / BQ) * D;
  };
  stage_rows<T, D>(q_s, S::ld, [&](int r) -> const T* {
    const long long off = q_row(r);
    return off < 0 ? nullptr : static_cast<const T*>(a.q) + off;
  });
  stage_rows<T, D>(do_s, S::ld, [&](int r) -> const T* {
    const long long off = q_row(r);
    return off < 0 ? nullptr : static_cast<const T*>(a.d_o) + off;
  });
  if (tid < kTile) {
    const int qi = q0 + tid % BQ;
    const bool ok = qi < a.Sq;
    const long long row = (static_cast<long long>(b) * a.H + kvh * G + tid / BQ) * a.Sq + qi;
    lim_s[tid] = ok ? (a.causal ? min(a.Sk - 1, a.q_offset + qi) : a.Sk - 1) : -1;
    lse_s[tid] = ok ? a.lse[row] : 0.f;
    delta_s[tid] = ok ? a.delta[row] : 0.f;
    qseg_s[tid] = (has_seg && ok) ? a.qseg[static_cast<long long>(b) * a.Sq + qi] : 0;
  }
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Sk, a.q_offset + q_last + 1) : a.Sk;
  const RowMask mask{lim_s, has_seg ? qseg_s : nullptr, kseg_s};

  float dq[kPer][D / 16];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[i][c] = 0.f;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();
    auto kv_row = [&](int t) -> long long {
      const int pos = kv0 + t;
      if (pos >= kv_end) return -1;
      return ((static_cast<long long>(b) * a.Sk + pos) * a.KVH + kvh) * D;
    };
    stage_rows<T, D>(k_s, S::ld, [&](int t) -> const T* {
      const long long off = kv_row(t);
      return off < 0 ? nullptr : k + off;
    });
    stage_rows<T, D>(v_s, S::ld, [&](int t) -> const T* {
      const long long off = kv_row(t);
      return off < 0 ? nullptr : v + off;
    });
    if (has_seg && tid < kTile) {
      const int pos = kv0 + tid;
      kseg_s[tid] = pos < a.Sk ? a.kseg[static_cast<long long>(b) * a.Sk + pos] : 0;
    }
    __syncthreads();
    p_and_ds<T, D>(q_s, do_s, k_s, v_s, lse_s, delta_s, mask, kv0, a.scale, tr, tc, nullptr, ds_s);
    __syncthreads();
    mul_tile<D>(ds_s, k_s, S::ld, tr, tc, dq);
  }

  const float one[kPer] = {1.f, 1.f, 1.f, 1.f};
  T* dq_out = static_cast<T*>(a.dq);
  write_rows<T, D>(dq, one, tr, tc, [&](int r) -> T* {
    const long long off = q_row(r);
    return off < 0 ? nullptr : dq_out + off;
  });
}

template <typename T, int D>
cudaError_t launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::bytes;
  auto dkv = flash_dkv_kernel<T, D>;
  auto dq = flash_dq_kernel<T, D>;
  cudaError_t err = rtt::set_smem(dkv, smem);
  if (err == cudaSuccess) err = rtt::set_smem(dq, smem);
  if (err != cudaSuccess) return err;
  if (a.Sk > 0) {
    dkv<<<dim3((a.Sk + kTile - 1) / kTile, a.KVH, B), kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (a.Sq > 0) {
    const int BQ = kTile / (a.H / a.KVH);
    dq<<<dim3((a.Sq + BQ - 1) / BQ, a.KVH, B), kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t pick_dim(int D, const BwdArgs& a, int B, cudaStream_t s) {
  if (D == 64) return launch<T, 64>(a, B, s);
  if (D == 128) return launch<T, 128>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace sm90 {

// Tiles streamed through a ring of three stages, loaded one tile ahead: the
// stage refilled at step j held tile j - 2, which every thread finished
// before passing step j - 1's barrier, so one barrier a step suffices and
// the two warpgroups can drift up to a step apart.
constexpr int kStages = 3;

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* d_o;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const int* qseg;
  const int* kseg;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Sq, Sk, H, KVH, q_offset, causal;
  float scale;
};

// D 64: one warpgroup a CTA and three CTAs an SM (168 registers a thread);
// D 128: two warpgroups a CTA, one CTA an SM.
template <int D>
struct DkvPlan {  // byte offsets from the 1024-aligned base
  static constexpr int WGS = D == 64 ? 1 : 2;    // warpgroups per CTA
  static constexpr int NT = 128 * WGS;           // threads per CTA
  static constexpr int MIN_CTAS = D == 64 ? 3 : 1;
  static constexpr int BK = WGS * kWgRows;       // kv rows per CTA
  static constexpr int BQ = 64;                  // q rows per tile
  static constexpr int k = 0;                          // [BK][D]
  static constexpr int v = k + BK * D * 2;             // [BK][D]
  static constexpr int q = v + BK * D * 2;                   // kStages of [BQ][D]
  static constexpr int d_o = q + kStages * BQ * D * 2;       // kStages of [BQ][D]
  static constexpr int lse = d_o + kStages * BQ * D * 2;     // float [kStages][BQ]
  static constexpr int delta = lse + kStages * BQ * 4;       // float [kStages][BQ]
  static constexpr int qseg = delta + kStages * BQ * 4;      // int [kStages][BQ]
  static constexpr int bytes = qseg + kStages * BQ * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(DkvPlan<D>::NT, DkvPlan<D>::MIN_CTAS)
    flash_dkv_kernel(const BwdParams p) {
  using P = DkvPlan<D>;
  constexpr int BK = P::BK, BQ = P::BQ, NT = P::NT, kStage = BQ * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const SmemBase sm(smem_raw);
  const uint32_t k_s = sm.addr + P::k, v_s = sm.addr + P::v;
  const uint32_t q_s = sm.addr + P::q, do_s = sm.addr + P::d_o;
  float* lse_s = reinterpret_cast<float*>(sm.ptr + P::lse);
  float* delta_s = reinterpret_cast<float*>(sm.ptr + P::delta);
  int* qseg_s = reinterpret_cast<int*>(sm.ptr + P::qseg);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  // kv tiles are the slowest grid axis: tile 0, which the most q tiles see, first
  const int kv0 = blockIdx.z * BK, kvh = blockIdx.x, b = blockIdx.y;
  const int G = p.H / p.KVH;
  const long long q_ld = static_cast<long long>(p.H) * D, kv_ld = static_cast<long long>(p.KVH) * D;
  const long long kv_base = (static_cast<long long>(b) * p.Sk * p.KVH + kvh) * D;
  const bool has_seg = p.qseg != nullptr;
  // causal: only query positions with q_offset + q >= kv0 see this tile
  const int qt0 = (p.causal ? max(0, kv0 - p.q_offset) : 0) / BQ;
  const int per_head = max(0, (p.Sq + BQ - 1) / BQ - qt0);
  const int n_items = G * per_head;  // (head, q tile) pairs, head-major

  auto prefetch = [&](int it) {
    const int st = it % kStages, h = kvh * G + it / per_head, qq0 = (qt0 + it % per_head) * BQ;
    const long long q_base = (static_cast<long long>(b) * p.Sq * p.H + h) * D;
    load_tile<BQ, D, NT>(q_s + st * kStage, p.q + q_base, q_ld, qq0, p.Sq);
    load_tile<BQ, D, NT>(do_s + st * kStage, p.d_o + q_base, q_ld, qq0, p.Sq);
    if (tid < BQ) {
      const int qi = qq0 + tid;
      const bool ok = qi < p.Sq;
      const long long row = (static_cast<long long>(b) * p.H + h) * p.Sq + qi;
      lse_s[st * BQ + tid] = ok ? p.lse[row] * kLog2e : 0.f;  // log2 units
      delta_s[st * BQ + tid] = ok ? p.delta[row] : 0.f;
      qseg_s[st * BQ + tid] = (has_seg && ok) ? p.qseg[static_cast<long long>(b) * p.Sq + qi] : 0;
    }
  };
  load_tile<BK, D, NT>(k_s, p.k + kv_base, kv_ld, kv0, p.Sk);
  load_tile<BK, D, NT>(v_s, p.v + kv_base, kv_ld, kv0, p.Sk);
  if (n_items > 0) prefetch(0);
  cp_async_commit();

  const int wk0 = kv0 + wg * kWgRows;  // the warpgroup's first kv row
  int kr[2], kseg[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    kr[hf] = wk0 + frag_row(hf);
    kseg[hf] = (has_seg && kr[hf] < p.Sk) ? p.kseg[static_cast<long long>(b) * p.Sk + kr[hf]] : 0;
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const float scale2 = p.scale * kLog2e;  // p = 2^(s scale log2 e - lse log2 e)

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) {
      prefetch(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();  // tile `it` is in; every thread is done with tile it - 2
    const int st = it % kStages, qq0 = (qt0 + it % per_head) * BQ;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    const int* qseg_t = qseg_s + st * BQ;
    float s[BQ / 2], dp[BQ / 2];  // S^T and dP^T: rows kv, columns q
    gemm_ss2<BQ, D, BK>(s, k_s, dp, v_s, wg * kWgRows, q_s + st * kStage, do_s + st * kStage);

    const bool edge = has_seg || qq0 + BQ > p.Sq ||
                      (p.causal && wk0 + kWgRows - 1 > p.q_offset + qq0);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = frag_col(i, lane), hf = frag_half(i);
      bool ok = true;
      if (edge) {
        const int qi = qq0 + c;
        ok = qi < p.Sq && (!p.causal || kr[hf] <= p.q_offset + qi) &&
             (!has_seg || kseg[hf] == qseg_t[c]);
      }
      const float pv = ok ? exp2f(fmaf(s[i], scale2, -lse_t[c])) : 0.f;
      s[i] = pv;
      dp[i] = pv * (dp[i] - delta_t[c]) * p.scale;
    }
    uint32_t a_p[BQ / 16][4], a_ds[BQ / 16][4];
    to_a<BQ>(s, a_p);
    to_a<BQ>(dp, a_ds);
    gemm_rs2<D, BQ>(dv, a_p, do_s + st * kStage, dk, a_ds, q_s + st * kStage);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk, one, [&](int hf) -> bf16* {
    return kr[hf] < p.Sk ? p.dk + kv_base + kr[hf] * kv_ld : nullptr;
  });
  store_rows<D>(dv, one, [&](int hf) -> bf16* {
    return kr[hf] < p.Sk ? p.dv + kv_base + kr[hf] * kv_ld : nullptr;
  });
}

template <int D>
struct DqPlan {  // byte offsets from the 1024-aligned base
  static constexpr int BM = 2 * kWgRows;  // q rows per CTA
  static constexpr int BN = 64;           // kv rows per tile
  static constexpr int q = 0;                          // [BM][D]
  static constexpr int d_o = q + BM * D * 2;           // [BM][D]
  static constexpr int k = d_o + BM * D * 2;                 // kStages of [BN][D]
  static constexpr int v = k + kStages * BN * D * 2;         // kStages of [BN][D]
  static constexpr int kseg = v + kStages * BN * D * 2;      // int [kStages][BN]
  static constexpr int bytes = kseg + kStages * BN * 4 + 1024;
};

// D 64: two CTAs per SM (128 registers a thread)
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1) flash_dq_kernel(const BwdParams p) {
  using P = DqPlan<D>;
  constexpr int BM = P::BM, BN = P::BN, kStage = BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const SmemBase sm(smem_raw);
  const uint32_t q_s = sm.addr + P::q, do_s = sm.addr + P::d_o;
  const uint32_t k_s = sm.addr + P::k, v_s = sm.addr + P::v;
  int* kseg_s = reinterpret_cast<int*>(sm.ptr + P::kseg);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  // q tiles are the slowest grid axis, launched in reverse: the most causal work first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (p.H / p.KVH);
  const long long q_ld = static_cast<long long>(p.H) * D, kv_ld = static_cast<long long>(p.KVH) * D;
  const long long q_base = (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  const long long kv_base = (static_cast<long long>(b) * p.Sk * p.KVH + kvh) * D;
  const bool has_seg = p.qseg != nullptr;
  const int kv_end = p.causal ? min(p.Sk, p.q_offset + min(q0 + BM, p.Sq)) : p.Sk;
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  auto prefetch = [&](int j) {
    const int st = j % kStages;
    load_tile<BN, D>(k_s + st * kStage, p.k + kv_base, kv_ld, j * BN, p.Sk);
    load_tile<BN, D>(v_s + st * kStage, p.v + kv_base, kv_ld, j * BN, p.Sk);
    if (has_seg && tid < BN) {
      const int pos = j * BN + tid;
      kseg_s[st * BN + tid] = pos < p.Sk ? p.kseg[static_cast<long long>(b) * p.Sk + pos] : 0;
    }
  };
  load_tile<BM, D>(q_s, p.q + q_base, q_ld, q0, p.Sq);
  load_tile<BM, D>(do_s, p.d_o + q_base, q_ld, q0, p.Sq);
  if (n_tiles > 0) prefetch(0);
  cp_async_commit();

  const int wrow0 = q0 + wg * kWgRows;
  int row[2], lim[2], qseg[2];
  float lse[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = wrow0 + frag_row(hf);
    const bool ok = row[hf] < p.Sq;
    const long long r = (static_cast<long long>(b) * p.H + h) * p.Sq + row[hf];
    lim[hf] = ok ? (p.causal ? min(p.Sk - 1, p.q_offset + row[hf]) : p.Sk - 1) : -1;
    qseg[hf] = (has_seg && ok) ? p.qseg[static_cast<long long>(b) * p.Sq + row[hf]] : 0;
    lse[hf] = ok ? p.lse[r] * kLog2e : 0.f;  // log2 units
    delta[hf] = ok ? p.delta[r] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float scale2 = p.scale * kLog2e;  // p = 2^(s scale log2 e - lse log2 e)

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      prefetch(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();  // tile j is in; every thread is done with tile j - 2
    const int st = j % kStages, kv0 = j * BN;
    const int* ks = kseg_s + st * BN;
    float s[BN / 2], dp[BN / 2];
    gemm_ss2<BN, D, BM>(s, q_s, dp, do_s, wg * kWgRows, k_s + st * kStage, v_s + st * kStage);

    const bool edge = has_seg || kv0 + BN > p.Sk || wrow0 + kWgRows > p.Sq ||
                      (p.causal && kv0 + BN - 1 > p.q_offset + wrow0);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int c = frag_col(i, lane), hf = frag_half(i);
      const bool ok = !edge || (kv0 + c <= lim[hf] && (!has_seg || qseg[hf] == ks[c]));
      const float pv = ok ? exp2f(fmaf(s[i], scale2, -lse[hf])) : 0.f;
      s[i] = pv * (dp[i] - delta[hf]) * p.scale;
    }
    uint32_t a[BN / 16][4];
    to_a<BN>(s, a);
    gemm_rs<D, BN>(dq, a, k_s + st * kStage);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, one, [&](int hf) -> bf16* {
    return row[hf] < p.Sq ? p.dq + q_base + row[hf] * q_ld : nullptr;
  });
}

template <int D>
cudaError_t launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  auto dkv = flash_dkv_kernel<D>;
  auto dq = flash_dq_kernel<D>;
  constexpr int dkv_smem = DkvPlan<D>::bytes, dq_smem = DqPlan<D>::bytes;
  cudaError_t err = allow_smem(dkv, dkv_smem);
  if (err == cudaSuccess) err = allow_smem(dq, dq_smem);
  if (err != cudaSuccess) return err;
  if (p.Sk > 0) {
    const int BK = DkvPlan<D>::BK;
    dkv<<<dim3(p.KVH, B, (p.Sk + BK - 1) / BK), DkvPlan<D>::NT, dkv_smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (p.Sq > 0) {
    const int BM = DqPlan<D>::BM;
    dq<<<dim3(p.H, B, (p.Sq + BM - 1) / BM), kThreads, dq_smem, stream>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace sm90

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, d_o, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, KVH, D]; lse, delta [B, H, Sq] fp32; qseg/kseg int32 or null.
int flash_bwd_launch(const void* q, const void* k, const void* v, const void* d_o,
                     const void* lse, const void* delta, const void* qseg, const void* kseg,
                     void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH, int D,
                     int q_offset, int causal, float scale, int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {  // bf16: the tensor-core kernels, any whole GQA group
    using sm90::bf16;
    const sm90::BwdParams p{
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(d_o), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const int*>(qseg),
        static_cast<const int*>(kseg), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Sq, Sk, H, KVH, q_offset, causal, scale};
    return D == 64 ? sm90::launch_bwd<64>(p, B, s) : sm90::launch_bwd<128>(p, B, s);
  }
  // fp32: the CUDA-core kernels, whose folded dQ tile needs the group to divide 64
  if (dtype != 0 || kTile % (H / KVH) != 0) return cudaErrorInvalidValue;
  BwdArgs a{q, k, v, d_o, static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const int*>(qseg), static_cast<const int*>(kseg), dq, dk, dv,
            Sq, Sk, H, KVH, q_offset, causal, scale};
  return pick_dim<float>(D, a, B, s);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
