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
// atomics. wgmma tiles are the later step.
//
// C interface (ctypes, caller's stream, no allocation): returns the
// cudaError_t of the launches.

#include "flash_common.cuh"

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

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, d_o, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, KVH, D]; lse, delta [B, H, Sq] fp32; qseg/kseg int32 or null.
int flash_bwd_launch(const void* q, const void* k, const void* v, const void* d_o,
                     const void* lse, const void* delta, const void* qseg, const void* kseg,
                     void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH, int D,
                     int q_offset, int causal, float scale, int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || kTile % (H / KVH) != 0) return cudaErrorInvalidValue;
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  BwdArgs a{q, k, v, d_o, static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const int*>(qseg), static_cast<const int*>(kseg), dq, dk, dv,
            Sq, Sk, H, KVH, q_offset, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pick_dim<float>(D, a, B, s);
  if (dtype == 1) return pick_dim<__nv_bfloat16>(D, a, B, s);
  return cudaErrorInvalidValue;
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
