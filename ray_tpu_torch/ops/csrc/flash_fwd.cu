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
// operands staged in shared memory (templated on the input type, built for
// fp32 only).
//
// Bound on an H100: operations. At the training shape (B 8, S 1024,
// H 16, KVH 8, D 64, causal) the kernel does 4 * D FLOPs per visible
// (row, kv) pair, ~17 GFLOP per call against ~50 MB of q/k/v/o traffic,
// far above the ~295 FLOP/byte ridge of bf16 tensor cores. This simple
// version runs those FLOPs on CUDA cores (67 TFLOP/s fp32 peak), with
// 16-byte shared-memory reads (8 vector loads per 64 FMAs). It stays on
// CUDA cores: no tensor-core type keeps fp32 inputs exact (TF32 keeps
// about three digits).
//
// Masking. A row that sees kv positions but none of its segment gets, as
// the Pallas kernel gives it, p = exp(NEG_INF - NEG_INF) = 1 at each: the
// mean of V over its window [0, lim] and lse ~ NEG_INF. Positions past
// the row's causal limit or past Sk are outside the window and count
// nowhere, so the result does not depend on the tiling. A row whose
// window is empty returns 0 with lse = NEG_INF.
//
// The design above is the fp32 kernel, kept for fp32 inputs. bf16 inputs
// go to sm90::flash_fwd_kernel below, on the tensor cores.
//
// bf16 design (sm90::flash_fwd_kernel). Bound at the training shape:
// operations, 17.2 GFLOP of QK^T and PV over the visible pairs against
// 989 TFLOP/s of dense bf16 (0.017 ms), so the kernel's work is to keep
// the tensor cores fed. One CTA of two warpgroups per (128-row q tile, q
// head, batch); each warpgroup owns 64 rows. q tiles are the slowest grid
// axis, launched in reverse, so the tiles with the most causal work start
// first. GQA is not folded: the CTA reads its kv head's tiles, and the G
// heads of a group reuse them from L2 (K + V of the training shape is
// 16.8 MB of the 50 MB L2), so any whole group works. Per kv tile (64
// rows at D 64, two CTAs an SM; 128 rows at D 128):
//   * K and V arrive by cp.async into 128-byte-swizzled tiles, a ring of
//     three stages: tile j + 1 is in flight while tile j is computed;
//   * S = Q K^T as wgmma.mma_async m64nNk16 with both operands K-major
//     in shared memory, fp32 accumulators in registers;
//   * the online softmax runs on the accumulator fragment (row max and sum
//     over the four lanes of a row), in log2 units (exp2 of the scaled
//     score less the running max); the window / segment mask is applied
//     only to tiles that cross the causal diagonal, a segment, or Sk;
//   * p is rounded to bf16 in registers and is the register A operand of
//     O += P V (wgmma.mma_async m64nDk16 with V MN-major from shared
//     memory), as the Pallas kernel casts p before its PV dot.
// The masking rules are the fp32 kernel's, stated above.
//
// C interface (ctypes, caller's stream, no allocation): returns the
// cudaError_t of the launch; an unsupported dtype / head_dim / group
// returns cudaErrorInvalidValue.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace sm90 {

struct FwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int* qseg;
  const int* kseg;
  bf16* o;
  float* lse;
  int Sq, Sk, H, KVH, q_offset, causal;
  float scale;
};

// K/V tiles stream through a ring of three stages, loaded one tile ahead:
// the stage refilled at step j held tile j - 2, which every thread finished
// before passing step j - 1's barrier, so one barrier a step suffices and
// the two warpgroups can drift up to a step apart.
constexpr int kStages = 3;

// D 64: 64-row kv tiles and two CTAs an SM (128 registers a thread);
// D 128: 128-row kv tiles, one CTA an SM.
template <int D>
struct FwdPlan {  // byte offsets from the 1024-aligned base
  static constexpr int BM = 2 * kWgRows;  // q rows per CTA
  static constexpr int BN = D == 64 ? 64 : 128;  // kv rows per tile
  static constexpr int MIN_CTAS = D == 64 ? 2 : 1;
  static constexpr int q = 0;                                // [BM][D]
  static constexpr int k = q + BM * D * 2;                   // kStages of [BN][D]
  static constexpr int v = k + kStages * BN * D * 2;         // kStages of [BN][D]
  static constexpr int kseg = v + kStages * BN * D * 2;      // int [kStages][BN]
  static constexpr int bytes = kseg + kStages * BN * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, FwdPlan<D>::MIN_CTAS) flash_fwd_kernel(const FwdParams p) {
  using P = FwdPlan<D>;
  constexpr int BM = P::BM, BN = P::BN, kStage = BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const SmemBase sm(smem_raw);
  const uint32_t q_s = sm.addr + P::q, k_s = sm.addr + P::k, v_s = sm.addr + P::v;
  int* kseg_s = reinterpret_cast<int*>(sm.ptr + P::kseg);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  // q tiles are the slowest grid axis, launched in reverse: the most causal work first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (p.H / p.KVH);
  const long long q_ld = static_cast<long long>(p.H) * D, kv_ld = static_cast<long long>(p.KVH) * D;
  const bf16* qb = p.q + (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  const bf16* kb = p.k + (static_cast<long long>(b) * p.Sk * p.KVH + kvh) * D;
  const bf16* vb = p.v + (static_cast<long long>(b) * p.Sk * p.KVH + kvh) * D;
  const bool has_seg = p.qseg != nullptr;
  // kv positions any row of this tile may see: [0, kv_end)
  const int kv_end = p.causal ? min(p.Sk, p.q_offset + min(q0 + BM, p.Sq)) : p.Sk;
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  auto prefetch = [&](int j) {
    const int st = j % kStages;
    load_tile<BN, D>(k_s + st * kStage, kb, kv_ld, j * BN, p.Sk);
    load_tile<BN, D>(v_s + st * kStage, vb, kv_ld, j * BN, p.Sk);
    if (has_seg && tid < BN) {
      const int pos = j * BN + tid;
      kseg_s[st * BN + tid] = pos < p.Sk ? p.kseg[static_cast<long long>(b) * p.Sk + pos] : 0;
    }
  };
  load_tile<BM, D>(q_s, qb, q_ld, q0, p.Sq);
  if (n_tiles > 0) prefetch(0);
  cp_async_commit();

  const int wrow0 = q0 + wg * kWgRows;  // the warpgroup's first row
  int row[2], lim[2], qseg[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = wrow0 + frag_row(hf);
    const bool ok = row[hf] < p.Sq;
    lim[hf] = ok ? (p.causal ? min(p.Sk - 1, p.q_offset + row[hf]) : p.Sk - 1) : -1;
    qseg[hf] = (has_seg && ok) ? p.qseg[static_cast<long long>(b) * p.Sq + row[hf]] : 0;
  }
  // m: running max in log2 units (the masks' NEG_INF stays as it is, so
  // NEG_INF - NEG_INF is still exactly 0); l: this thread's share of the row sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

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
    float s[BN / 2];
    gemm_ss<BN, D, BM>(s, q_s, wg * kWgRows, k_s + st * kStage);

    const bool edge = has_seg || kv0 + BN > p.Sk || (p.causal && kv0 + BN - 1 > p.q_offset + wrow0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = minus_inf();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (frag_half(i) != hf) continue;
        const int c = frag_col(i, lane);
        float x = s[i] * scale2;
        if (edge) {
          // outside the window: -inf (never visited); masked inside: NEG_INF
          x = kv0 + c > lim[hf] ? minus_inf() : (has_seg && qseg[hf] != ks[c]) ? kNegInf : x;
        }
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
    gemm_rs<D, BN>(o, pa, v_s + st * kStage);
  }

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float lr = quad_sum(l[hf]);
    const float safe_l = lr == 0.f ? 1.f : lr;  // rows that saw nothing -> 0
    inv[hf] = 1.f / safe_l;
    if (row[hf] < p.Sq && (lane & 3) == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row[hf]] =
          (m[hf] == kNegInf ? kNegInf : m[hf] * kLn2) + logf(safe_l);
  }
  bf16* ob = p.o + (static_cast<long long>(b) * p.Sq * p.H + h) * D;
  store_rows<D>(o, inv, [&](int hf) -> bf16* {
    return row[hf] < p.Sq ? ob + row[hf] * q_ld : nullptr;
  });
}

template <int D>
cudaError_t launch_fwd(const FwdParams& p, int B, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  constexpr int smem = FwdPlan<D>::bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int BM = FwdPlan<D>::BM;
  kernel<<<dim3(p.H, B, (p.Sq + BM - 1) / BM), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sm90

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Device pointers; qseg/kseg may be null
// (no segments). q_offset is the absolute position of query row 0.
int flash_fwd_launch(const void* q, const void* k, const void* v, const void* qseg,
                     const void* kseg, void* o, void* lse, int B, int Sq, int Sk, int H, int KVH,
                     int D, int q_offset, int causal, float scale, int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0) return cudaErrorInvalidValue;
  if ((qseg == nullptr) != (kseg == nullptr)) return cudaErrorInvalidValue;
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {  // bf16: the tensor-core kernel, any whole GQA group
    const sm90::FwdParams p{static_cast<const sm90::bf16*>(q), static_cast<const sm90::bf16*>(k),
                            static_cast<const sm90::bf16*>(v), static_cast<const int*>(qseg),
                            static_cast<const int*>(kseg), static_cast<sm90::bf16*>(o),
                            static_cast<float*>(lse), Sq, Sk, H, KVH, q_offset, causal, scale};
    return D == 64 ? sm90::launch_fwd<64>(p, B, s) : sm90::launch_fwd<128>(p, B, s);
  }
  // fp32: the CUDA-core kernel, whose folded tile needs the group to divide 64
  if (dtype != 0 || kTile % (H / KVH) != 0) return cudaErrorInvalidValue;
  FwdArgs a{q, k, v, static_cast<const int*>(qseg), static_cast<const int*>(kseg), o,
            static_cast<float*>(lse), Sq, Sk, H, KVH, q_offset, causal, scale};
  return pick_dim<float>(D, a, B, s);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
