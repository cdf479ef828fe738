// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (ray_tpu/ops/flash.py:143,
// called from `_fwd_call`, :464): causal or bidirectional GQA attention
// with an fp32 online softmax over kv tiles, returning o (input dtype) and
// the per-row log-sum-exp (fp32), with segment ids, a static q_offset and
// the finite NEG_INF mask of the reference.
//
// Layout: q and o [B, Sq, H, D], k and v [B, Sk, KVH, D], all contiguous
// (read in place, no transposes or padding); lse [B, H, Sq]; segments
// [B, Sq] and [B, Sk] int32 or null.
//
// Design. One CTA per (q tile, kv head, batch). The tile's 64 rows are
// 64 / G query positions of each of the G query heads that share the kv
// head (row = g * (64 / G) + i), as the Pallas wrapper folds the group,
// so each K/V tile is read from memory once for the whole group. The
// Pallas kernel carries m, l and acc in VMEM scratch across a sequential
// kv grid axis; Hopper CTAs run in no order, so here the CTA walks its kv
// tiles itself, up to its last row's causal limit, with m and l in
// registers (replicated across the 16 threads of a row) and the output
// accumulator in registers. QK^T and PV run on fp32 CUDA cores from
// operands staged in shared memory; for bf16 inputs p is rounded to bf16
// before PV, where the Pallas kernel casts it.
//
// Bound on an H100: operations. At the training shape (B 8, S 1024,
// H 16, KVH 8, D 64, causal) the kernel does 4 * D FLOPs per visible
// (row, kv) pair, ~17 GFLOP per call against ~50 MB of q/k/v/o traffic,
// far above the ~295 FLOP/byte ridge of bf16 tensor cores. This simple
// version runs those FLOPs on CUDA cores (67 TFLOP/s fp32 peak), with
// 16-byte shared-memory reads (8 vector loads per 64 FMAs); wgmma tiles
// from TMA-staged operands are the later step.
//
// Masking. A row that sees kv positions but none of its segment gets, as
// the Pallas kernel gives it, p = exp(NEG_INF - NEG_INF) = 1 at each: the
// mean of V over its window [0, lim] and lse ~ NEG_INF. Positions past
// the row's causal limit or past Sk are outside the window and count
// nowhere, so the result does not depend on the tiling. A row whose
// window is empty returns 0 with lse = NEG_INF.
//
// C interface (ctypes, caller's stream, no allocation): returns the
// cudaError_t of the launch; an unsupported dtype / head_dim / group
// returns cudaErrorInvalidValue.

#include "flash_common.cuh"

namespace {

using namespace rtf;

template <int D>
struct FwdSmem {
  static constexpr int ld = D + kPad;
  static constexpr int q = 0;                       // [64][ld] query rows
  static constexpr int k = q + kTile * ld;          // [64][ld] K tile
  static constexpr int v = k + kTile * ld;          // [64][D]  V tile
  static constexpr int p = v + kTile * D;           // [64][kPS] probabilities
  static constexpr int lim = p + kTile * kPS;       // int [64]
  static constexpr int qseg = lim + kTile;          // int [64]
  static constexpr int kseg = qseg + kTile;         // int [64]
  static constexpr size_t bytes = size_t(kseg + kTile) * 4;
};

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* qseg;
  const int* kseg;
  void* o;
  float* lse;
  int Sq, Sk, H, KVH, q_offset, causal;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  using S = FwdSmem<D>;
  float* q_s = smem + S::q;
  float* k_s = smem + S::k;
  float* v_s = smem + S::v;
  float* p_s = smem + S::p;
  int* lim_s = reinterpret_cast<int*>(smem + S::lim);
  int* qseg_s = reinterpret_cast<int*>(smem + S::qseg);
  int* kseg_s = reinterpret_cast<int*>(smem + S::kseg);

  const int G = a.H / a.KVH;
  const int BQ = kTile / G;  // query positions per tile
  const int q0 = blockIdx.x * BQ;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const bool has_seg = a.qseg != nullptr;

  // row r -> (query position q0 + r % BQ, head kvh * G + r / BQ)
  auto q_row = [&](int r) -> long long {
    const int qi = q0 + r % BQ;
    if (qi >= a.Sq) return -1;
    return ((static_cast<long long>(b) * a.Sq + qi) * a.H + kvh * G + r / BQ) * D;
  };
  stage_rows<T, D>(q_s, S::ld, [&](int r) -> const T* {
    const long long off = q_row(r);
    return off < 0 ? nullptr : q + off;
  });
  if (tid < kTile) {
    const int qi = q0 + tid % BQ;
    int lim = -1;
    if (qi < a.Sq) lim = a.causal ? min(a.Sk - 1, a.q_offset + qi) : a.Sk - 1;
    lim_s[tid] = lim;
    qseg_s[tid] = (has_seg && qi < a.Sq) ? a.qseg[static_cast<long long>(b) * a.Sq + qi] : 0;
  }
  // kv positions any row of this tile may see: [0, kv_end)
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int kv_end = a.causal ? min(a.Sk, a.q_offset + q_last + 1) : a.Sk;
  const RowMask mask{lim_s, has_seg ? qseg_s : nullptr, kseg_s};

  float m[kPer], l[kPer], acc[kPer][D / 16];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();  // previous tile's readers are done (and q_s / lim_s written)
    auto kv_row = [&](int t) -> long long {
      const int pos = kv0 + t;
      if (pos >= kv_end) return -1;
      return ((static_cast<long long>(b) * a.Sk + pos) * a.KVH + kvh) * D;
    };
    stage_rows<T, D>(k_s, S::ld, [&](int t) -> const T* {
      const long long off = kv_row(t);
      return off < 0 ? nullptr : k + off;
    });
    stage_rows<T, D>(v_s, D, [&](int t) -> const T* {
      const long long off = kv_row(t);
      return off < 0 ? nullptr : v + off;
    });
    if (has_seg && tid < kTile) {
      const int pos = kv0 + tid;
      kseg_s[tid] = pos < a.Sk ? a.kseg[static_cast<long long>(b) * a.Sk + pos] : 0;
    }
    __syncthreads();

    float s[kPer][kPer];
    dot_rows<D>(q_s, k_s, tr, tc, s);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = tr + 16 * i;
      float mx = minus_inf();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tc + 16 * j;
        const int pos = kv0 + c;
        // outside the window: -inf (never visited); masked inside: NEG_INF
        const float sv = !mask.in_window(r, pos) ? minus_inf()
                         : mask.valid(r, c, pos) ? s[i][j] * a.scale : kNegInf;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));  // finite: m starts at NEG_INF
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = expf(s[i][j] - m_new);  // -inf -> 0
        rs += p;
        p_s[r * kPS + tc + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + group16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mul_tile<D>(p_s, v_s, D, tr, tc, acc);
  }

  float inv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float safe_l = l[i] == 0.f ? 1.f : l[i];  // rows that saw nothing -> 0
    inv[i] = 1.f / safe_l;
    const int r = tr + 16 * i;
    const long long off = q_row(r);
    if (tc == 0 && off >= 0) {
      const int qi = q0 + r % BQ;
      const int h = kvh * G + r / BQ;
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qi] = m[i] + logf(safe_l);
    }
  }
  T* o = static_cast<T*>(a.o);
  write_rows<T, D>(acc, inv, tr, tc, [&](int r) -> T* {
    const long long off = q_row(r);
    return off < 0 ? nullptr : o + off;
  });
}

template <typename T, int D>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const size_t smem = FwdSmem<D>::bytes;
  cudaError_t err = rtt::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int BQ = kTile / (a.H / a.KVH);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.KVH, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pick_dim(int D, const FwdArgs& a, int B, cudaStream_t s) {
  if (D == 64) return launch<T, 64>(a, B, s);
  if (D == 128) return launch<T, 128>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Device pointers; qseg/kseg may be null
// (no segments). q_offset is the absolute position of query row 0.
int flash_fwd_launch(const void* q, const void* k, const void* v, const void* qseg,
                     const void* kseg, void* o, void* lse, int B, int Sq, int Sk, int H, int KVH,
                     int D, int q_offset, int causal, float scale, int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || kTile % (H / KVH) != 0) return cudaErrorInvalidValue;
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  FwdArgs a{q, k, v, static_cast<const int*>(qseg), static_cast<const int*>(kseg), o,
            static_cast<float*>(lse), Sq, Sk, H, KVH, q_offset, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pick_dim<float>(D, a, B, s);
  if (dtype == 1) return pick_dim<__nv_bfloat16>(D, a, B, s);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
