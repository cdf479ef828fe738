// Split-KV paged decode attention for Hopper (sm_90a): the core of the
// paged decode kernel (paged_attention.cu) and of the decode rows
// (q_len = 1) of the ragged kernel (ragged_attention.cu). Both libraries
// compile this one code path, so a decode-only ragged batch gives the same
// bits as the paged kernel on the same inputs.
//
// What it computes (ray_tpu/ops/paged_attention.py): the G = H / KVH query
// heads of one kv head attend, for one sequence, over kv positions
// [0, min(ctx, max_blocks * block_size)), read through the sequence's
// block-table row from the head-major cache [KVH, num_slots, D]:
// slot = block_tables[b, pos / block_size] * block_size + pos % block_size.
// Scale 1/sqrt(D), fp32 softmax, the finite NEG_INF, and 0 for a row that
// sees no position (ctx = 0, the Pallas `safe_l`). Table entries at or past
// the context are never read.
//
// Bound on an H100: bytes. Each K/V element read feeds G multiply-adds
// (about G/2 per byte), far under the card's ridge, so the kernel's work
// is to keep enough bytes in flight on every SM and to spend few
// instructions on each byte.
//
// Design.
//  * Grid (split, kv head x row block, sequence). The number of splits is
//    fixed by the host from shapes alone (ops/paged_attention.py
//    `num_splits`); each sequence divides its own ceil(ctx / block_size)
//    pages evenly over them on the device, so nothing is read back and a
//    split with no pages writes m = NEG_INF, l = 0.
//  * A CTA of 4 warps streams its page range in tiles of 128 bytes of
//    every head_dim column (64 positions in bf16, 32 in fp32) through a
//    3-stage cp.async ring, two tiles ahead of the math, in the input type,
//    into 128-byte-swizzled tiles (conflict-free for rows read 8 at a
//    time). The block ids of a tile's pages are loaded into registers one
//    tile before its copies are issued, so no copy waits on the table.
//  * Each warp owns a quarter of every tile's positions and keeps its own
//    online-softmax state (max and sum in log2 units, and a D-wide
//    accumulator per row) in registers: no barrier is needed for the
//    softmax. At the end the four warps' states merge through shared
//    memory in warp order.
//      - bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate). The
//        group's rows, padded to 16 (row blocks of 16 for larger groups),
//        are the A operand of S = Q K^T, unscaled, with K fed by ldmatrix;
//        the scores are scaled in fp32 as the plain version scales them,
//        and p is rounded to bf16 as the A operand of O += P V (V by
//        ldmatrix.trans).
//      - fp32: CUDA cores (no tensor-core type keeps fp32 exact). Rows of
//        R = 4, 8 or 16; NP lanes share one position's scores, each a
//        D / NP slice, against q rows pre-scaled into log2 units in shared
//        memory; in PV a lane owns D / 32 output columns.
//  * With one split the CTA writes the output; otherwise it writes its
//    unnormalised accumulator and (m, l) to the fp32 workspace
//    [B, H, splits, D + 2], and a second small kernel merges the splits in
//    split order (deterministic: no atomics anywhere).
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "flash_sm90.cuh"

namespace rtd {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kMmaRows = 16;   // rows of the bf16 path's row block (the mma's m)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct DecodeArgs {
  const void* q;         // paged: [B, H, D]; ragged: packed [T, H, D]
  const void* k;         // [KVH, num_slots, D]
  const void* v;
  const int* bt;         // [B, max_blocks]
  const int* ctx;        // [B]
  const int* cu;         // ragged: cu_q_lens [B + 1] (only q_len = 1 rows); paged: null
  void* out;             // same layout as q
  float* ws;             // [B, H, splits, D + 2], or null with one split
  int H, KVH, num_slots, max_blocks, block_size, splits;
  int bs_shift;          // log2(block_size) when it is a power of two, else -1
};

// log2(n) for a power of two, else -1 (a shift then replaces the division
// in every slot lookup)
inline int pow2_shift(int n) {
  if (n <= 0 || (n & (n - 1))) return -1;
  int s = 0;
  while ((1 << s) < n) ++s;
  return s;
}

// K and V tiles of TN kv positions x D of one kv head, gathered through a
// block-table row into a ring of kStages swizzled stages (sm90::swizzled,
// the layout wgmma and ldmatrix read). Each of the kThreads threads that
// fill a ring (tid = its index among them) copies NR 16-byte chunks of a
// tile; fetch() loads the block ids of its chunks' rows (-1 at or past hi,
// never read), issue() starts the copies (zero-filling rows at or past hi).
template <typename T, int D, int TN>
struct Ring {
  static constexpr int VEC = 16 / sizeof(T);          // elements per chunk
  static constexpr int CH = D / VEC;                  // chunks per row
  static constexpr int NR = TN * CH / kThreads;       // chunks per thread
  static constexpr int stage = TN * D * sizeof(T);    // bytes of one K (or V) tile
  static_assert((TN * CH) % kThreads == 0, "tile split over the CTA");
  const T* kh;
  const T* vh;
  const int* bt_row;
  int bs, shift, lo, hi;
  uint32_t k_s, v_s;  // shared-space addresses of the two rings
  int tid;

  __device__ __forceinline__ void fetch(int j, int (&pg)[NR]) const {
#pragma unroll
    for (int it = 0; it < NR; ++it) {
      const int pos = lo + j * TN + (tid + it * kThreads) / CH;
      pg[it] = pos < hi ? bt_row[shift >= 0 ? pos >> shift : pos / bs] : -1;
    }
  }
  __device__ __forceinline__ void issue(int j, const int (&pg)[NR]) const {
    const uint32_t kd = k_s + (j % kStages) * stage, vd = v_s + (j % kStages) * stage;
#pragma unroll
    for (int it = 0; it < NR; ++it) {
      const int i = tid + it * kThreads;
      const int t = i / CH, c = i % CH;
      const int pos = lo + j * TN + t;
      const bool ok = pg[it] >= 0;
      size_t off = 0;
      if (ok) {
        const int in_page = shift >= 0 ? (pos & (bs - 1)) : pos % bs;
        off = (size_t(pg[it]) * bs + in_page) * D + c * VEC;
      }
      const uint32_t o = sm90::swizzled<TN>(t, c);
      sm90::cp_async16(kd + o, kh + off, ok);
      sm90::cp_async16(vd + o, vh + off, ok);
    }
  }
};

// q_len = 1 rows only; the output row of sequence b, or -1
__device__ __forceinline__ long long decode_row(const DecodeArgs& a, int b) {
  if (a.cu == nullptr) return b;
  const int q0 = a.cu[b];
  return a.cu[b + 1] - q0 == 1 ? q0 : -1;
}

// What one CTA serves: rows [g0, g0 + n_rows) of kv head kvh's group for
// output row `row`, kv positions [lo, hi) of sequence blockIdx.z.
struct Work {
  long long row;
  int kvh, g0, n_rows, lo, hi, n_tiles;
};

template <int R, int TN>
__device__ __forceinline__ bool plan_work(const DecodeArgs& a, Work& wk) {
  const int b = blockIdx.z;
  wk.row = decode_row(a, b);
  if (wk.row < 0) return false;  // not a decode row (uniform over the CTA)
  const int G = a.H / a.KVH;
  const int n_rb = (G + R - 1) / R;
  wk.kvh = blockIdx.y / n_rb;
  wk.g0 = (blockIdx.y % n_rb) * R;
  wk.n_rows = min(R, G - wk.g0);
  // this split's pages: an even share of the sequence's own page count
  const int bs = a.block_size;
  const int kv_end = max(0, min(a.ctx[b], a.max_blocks * bs));
  const int pages = (kv_end + bs - 1) / bs;
  const int per = (pages + a.splits - 1) / a.splits;
  wk.lo = min(int(blockIdx.x) * per, pages) * bs;
  wk.hi = min(wk.lo + per * bs, kv_end);
  wk.n_tiles = wk.hi > wk.lo ? (wk.hi - wk.lo + TN - 1) / TN : 0;
  return true;
}

template <typename T, int D, int TN>
__device__ __forceinline__ Ring<T, D, TN> make_ring(const DecodeArgs& a, const Work& wk,
                                                    uint32_t k_s, uint32_t v_s) {
  const size_t head = size_t(wk.kvh) * a.num_slots * D;
  return Ring<T, D, TN>{static_cast<const T*>(a.k) + head, static_cast<const T*>(a.v) + head,
                        a.bt + size_t(blockIdx.z) * a.max_blocks, a.block_size, a.bs_shift,
                        wk.lo, wk.hi, k_s, v_s, int(threadIdx.x)};
}

// Merge the four warps' states (mw/lw [kWarps][R], aw [kWarps][R][D], in
// shared memory and synchronised) in warp order, and write the output rows
// (one split) or this split's partials to the workspace.
template <typename T, int D, int R>
__device__ __forceinline__ void finish(const DecodeArgs& a, const Work& wk, const float* mw,
                                       const float* lw, const float* aw) {
  const int G = a.H / a.KVH;
  for (int i = threadIdx.x; i < wk.n_rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) M = fmaxf(M, mw[u * R + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      const float e = exp2f(mw[u * R + r] - M);
      L = fmaf(lw[u * R + r], e, L);
      O = fmaf(aw[(u * R + r) * D + d], e, O);
    }
    const long long h = wk.kvh * G + wk.g0 + r;
    if (a.ws == nullptr) {
      rtt::store(static_cast<T*>(a.out) + (wk.row * a.H + h) * D + d, O / (L == 0.f ? 1.f : L));
    } else {
      float* wp = a.ws + ((size_t(blockIdx.z) * a.H + h) * a.splits + blockIdx.x) * (D + 2);
      wp[d] = O;
      if (d == 0) {
        wp[D] = M;
        wp[D + 1] = L;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c[m16 x n8] += a[m16 x k16] b[k16 x n8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
struct MmaPlan {  // byte offsets from the 1024-aligned base
  static constexpr int TN = 64;
  using KV = Ring<bf16, D, TN>;
  static constexpr int k = 0;
  static constexpr int v = k + kStages * KV::stage;
  static constexpr int q = v + kStages * KV::stage;      // bf16 [16][D], swizzled
  static constexpr int bytes = q + kMmaRows * D * 2 + 1024;
  static constexpr int merge = (2 * kWarps * kMmaRows + kWarps * kMmaRows * D) * 4;
  static_assert(merge <= q, "merge fits the ring");
};

// Fragment map of an m16n8 accumulator c[4]: c[e] is row g + 8 (e >> 1) and
// column 2 t + (e & 1) of its n-tile, g = lane / 4, t = lane % 4.
template <int D>
__device__ __forceinline__ void decode_split_mma(const DecodeArgs& a, uint8_t* smem_raw) {
  using P = MmaPlan<D>;
  constexpr int TN = P::TN, R = kMmaRows;
  Work wk;
  if (!plan_work<R, TN>(a, wk)) return;
  const sm90::SmemBase sm(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, tq = lane & 3, grp = lane >> 3;
  const auto ring = make_ring<bf16, D, TN>(a, wk, sm.addr + P::k, sm.addr + P::v);

  int pg[P::KV::NR];
  if (wk.n_tiles > 0) {
    ring.fetch(0, pg);
    ring.issue(0, pg);
  }
  sm90::cp_async_commit();
  if (wk.n_tiles > 1) {
    ring.fetch(1, pg);
    ring.issue(1, pg);
  }
  sm90::cp_async_commit();
  if (wk.n_tiles > 2) ring.fetch(2, pg);

  // the group's rows, unscaled, padded to 16 with zeros
  const uint32_t q_s = sm.addr + P::q;
  {
    const bf16* qp = static_cast<const bf16*>(a.q) + (wk.row * a.H + wk.kvh * (a.H / a.KVH) + wk.g0) * D;
    for (int i = tid; i < R * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = i % (D / 8);
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < wk.n_rows) x = *reinterpret_cast<const uint4*>(qp + r * D + c * 8);
      *reinterpret_cast<uint4*>(sm.ptr + P::q + sm90::swizzled<R>(r, c)) = x;
    }
  }
  __syncthreads();
  uint32_t qa[D / 16][4];  // A fragments of S = Q K^T
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(q_s + sm90::swizzled<R>((lane & 7) + (grp & 1) * 8, 2 * kk + (grp >> 1)), qa[kk]);

  const float scale2 = rsqrtf(float(D)) * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int t0 = w * 16;  // the warp's positions within a tile

  for (int j = 0; j < wk.n_tiles; ++j) {
    sm90::cp_async_wait<1>();
    __syncthreads();  // tile j in; every warp is done with tile j - 1
    if (j + 2 < wk.n_tiles) ring.issue(j + 2, pg);  // into tile j - 1's stage
    sm90::cp_async_commit();
    if (j + 3 < wk.n_tiles) ring.fetch(j + 3, pg);
    const uint32_t ks = ring.k_s + (j % kStages) * P::KV::stage;
    const uint32_t vs = ring.v_s + (j % kStages) * P::KV::stage;

    // S[16 rows x the warp's 16 positions], two n-tiles of 8 positions
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      ldsm_x4(ks + sm90::swizzled<TN>(t0 + (lane & 7) + (grp >> 1) * 8, 2 * kk + (grp & 1)), kb);
      mma16816(s[0], qa[kk], kb[0], kb[1]);
      mma16816(s[1], qa[kk], kb[2], kb[3]);
    }

    // online softmax, one state per row half (rows g and g + 8)
    const int pos0 = wk.lo + j * TN + t0 + 2 * tq;
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = pos0 + 8 * n + e < wk.hi;
          const float x = ok ? s[n][2 * h + e] * scale2 : kNegInf;
          s[n][2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[h], sm90::quad_max(mx));
      alpha[h] = exp2f(m[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = pos0 + 8 * n + e < wk.hi;
          const float p = ok ? exp2f(s[n][2 * h + e] - m_new) : 0.f;
          s[n][2 * h + e] = p;
          rs += p;
        }
      l[h] = l[h] * alpha[h] + rs;
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

    // O += P V: P (bf16) is the A operand over the warp's 16 positions
    const uint32_t pa[4] = {sm90::pack_bf16(s[0][0], s[0][1]), sm90::pack_bf16(s[0][2], s[0][3]),
                            sm90::pack_bf16(s[1][0], s[1][1]), sm90::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t vb[4];
      ldsm_x4_t(vs + sm90::swizzled<TN>(t0 + (lane & 7) + (grp & 1) * 8, 2 * dd + (grp >> 1)), vb);
      mma16816(o[2 * dd], pa, vb[0], vb[1]);
      mma16816(o[2 * dd + 1], pa, vb[2], vb[3]);
    }
  }

  sm90::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* mw = reinterpret_cast<float*>(sm.ptr);  // [kWarps][16]
  float* lw = mw + kWarps * R;                   // [kWarps][16]
  float* aw = lw + kWarps * R;                   // [kWarps][16][D]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lr = sm90::quad_sum(l[h]);
    if (tq == 0) {
      mw[w * R + g + 8 * h] = m[h];
      lw[w * R + g + 8 * h] = lr;
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) aw[(w * R + g + 8 * (e >> 1)) * D + 8 * n + 2 * tq + (e & 1)] = o[n][e];
  __syncthreads();
  finish<bf16, D, R>(a, wk, mw, lw, aw);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

template <int D, int R>
struct FmaPlan {  // byte offsets from the 1024-aligned base
  static constexpr int TN = 32;                     // kv positions per tile
  using KV = Ring<float, D, TN>;
  static constexpr int PW = TN / kWarps;            // positions per warp per tile
  static constexpr int NP = 32 / PW;                // lanes sharing one position in the scores
  static constexpr int DPL = D / NP;                // score columns per lane
  static constexpr int QLD = D + 4 * NP;            // q row stride (floats): one 16-byte pad per part
  static constexpr int k = 0;
  static constexpr int v = k + kStages * KV::stage;
  static constexpr int q = v + kStages * KV::stage;  // fp32 [R][QLD]
  static constexpr int p = q + R * QLD * 4;          // fp32 [kWarps][R][PW] probabilities
  static constexpr int bytes = p + kWarps * R * PW * 4 + 1024;
  static constexpr int merge = (2 * kWarps * R + kWarps * R * D) * 4;
  static_assert(DPL % 4 == 0, "whole chunks per lane");
  static_assert(merge <= q, "merge fits the ring");
};

template <int D, int R>
__device__ __forceinline__ void decode_split_fma(const DecodeArgs& a, uint8_t* smem_raw) {
  using P = FmaPlan<D, R>;
  constexpr int TN = P::TN, PW = P::PW, DL = D / 32;
  Work wk;
  if (!plan_work<R, TN>(a, wk)) return;
  const sm90::SmemBase sm(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const auto ring = make_ring<float, D, TN>(a, wk, sm.addr + P::k, sm.addr + P::v);

  int pg[P::KV::NR];
  if (wk.n_tiles > 0) {
    ring.fetch(0, pg);
    ring.issue(0, pg);
  }
  sm90::cp_async_commit();
  if (wk.n_tiles > 1) {
    ring.fetch(1, pg);
    ring.issue(1, pg);
  }
  sm90::cp_async_commit();
  if (wk.n_tiles > 2) ring.fetch(2, pg);

  // query rows, scaled into log2 units; part p of a row is shifted 16 bytes
  // so the NP parts read by one instruction sit in different banks
  float* q_s = reinterpret_cast<float*>(sm.ptr + P::q);
  const float qscale = rsqrtf(float(D)) * kLog2e;
  const float* qp = static_cast<const float*>(a.q) + (wk.row * a.H + wk.kvh * (a.H / a.KVH) + wk.g0) * D;
  for (int i = tid; i < R * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < wk.n_rows) rtt::load16(qp + r * D + c, x);
    float* dst = q_s + r * P::QLD + c + (c / P::DPL) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = x[e] * qscale;
  }

  const int tw = lane % PW;      // this lane's position among its warp's PW
  const int tl = w * PW + tw;    // ... within the tile
  const int part = lane / PW;    // its slice of the score columns
  float* p_s = reinterpret_cast<float*>(sm.ptr + P::p) + w * R * PW;
  float m[R], l[R], acc[R][DL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[r][d] = 0.f;
  }

  for (int j = 0; j < wk.n_tiles; ++j) {
    sm90::cp_async_wait<1>();
    __syncthreads();  // tile j (and q_s) in; every warp is done with tile j - 1
    if (j + 2 < wk.n_tiles) ring.issue(j + 2, pg);  // into tile j - 1's stage
    sm90::cp_async_commit();
    if (j + 3 < wk.n_tiles) ring.fetch(j + 3, pg);
    const uint8_t* ks = sm.ptr + P::k + (j % kStages) * P::KV::stage;
    const uint8_t* vs = sm.ptr + P::v + (j % kStages) * P::KV::stage;

    // scores of this lane's position, over its D / NP slice, summed over the NP lanes
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < P::DPL / 4; ++cc) {
      const int c = part * (P::DPL / 4) + cc;
      float kx[4];
      rtt::load16(reinterpret_cast<const float*>(ks + sm90::swizzled<TN>(tl, c)), kx);
      const float* qc = q_s + c * 4 + part * 4;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qc + r * P::QLD);
        s[r] = fmaf(qv.x, kx[0], s[r]);
        s[r] = fmaf(qv.y, kx[1], s[r]);
        s[r] = fmaf(qv.z, kx[2], s[r]);
        s[r] = fmaf(qv.w, kx[3], s[r]);
      }
    }
#pragma unroll
    for (int o = PW; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);

    // online softmax over the warp's PW positions (state replicated in its lanes)
    const bool ok = wk.lo + j * TN + tl < wk.hi;
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sv = ok ? s[r] : kNegInf;
      float mx = sv;
#pragma unroll
      for (int o = 1; o < PW; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float p = ok ? exp2f(sv - m_new) : 0.f;
      alpha[r] = exp2f(m[r] - m_new);
      l[r] = l[r] * alpha[r] + (part == 0 ? p : 0.f);  // one lane per position counts it
      m[r] = m_new;
      s[r] = p;
    }
    __syncwarp();  // the warp's reads of the previous tile's p_s are done
    if (part == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) p_s[r * PW + tw] = s[r];
    }
    __syncwarp();

    // acc[r][:] = acc * alpha + sum over the warp's positions of p * V
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[r][d] *= alpha[r];
    const int col = lane * DL;
#pragma unroll
    for (int t = 0; t < PW; t += 4) {
      float vx[4][DL];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* src = reinterpret_cast<const float*>(vs + sm90::swizzled<TN>(w * PW + t + u, col / 4));
        if constexpr (DL == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vx[u][0] = x.x; vx[u][1] = x.y; vx[u][2] = x.z; vx[u][3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src + col % 4);
          vx[u][0] = x.x; vx[u][1] = x.y;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(p_s + r * PW + t);
        const float pu[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int d = 0; d < DL; ++d) acc[r][d] = fmaf(pu[u], vx[u][d], acc[r][d]);
      }
    }
  }

  sm90::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* mw = reinterpret_cast<float*>(sm.ptr);  // [kWarps][R]
  float* lw = mw + kWarps * R;                   // [kWarps][R]
  float* aw = lw + kWarps * R;                   // [kWarps][R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lr = rtt::warp_sum(l[r]);
    if (lane == 0) {
      mw[w * R + r] = m[r];
      lw[w * R + r] = lr;
    }
#pragma unroll
    for (int d = 0; d < DL; ++d) aw[(w * R + r) * D + lane * DL + d] = acc[r][d];
  }
  __syncthreads();
  finish<float, D, R>(a, wk, mw, lw, aw);
}

template <typename T, int D, int R>
__device__ __forceinline__ void decode_split(const DecodeArgs& a, uint8_t* smem) {
  if constexpr (std::is_same_v<T, bf16>) {
    decode_split_mma<D>(a, smem);
  } else {
    decode_split_fma<D, R>(a, smem);
  }
}

template <typename T, int D, int R>
constexpr int decode_smem_bytes() {
  if constexpr (std::is_same_v<T, bf16>) {
    return MmaPlan<D>::bytes;
  } else {
    return FmaPlan<D, R>::bytes;
  }
}

// Merge the splits of (sequence blockIdx.y, head blockIdx.x), one thread a column.
template <typename T, int D>
__device__ __forceinline__ void combine_splits(const DecodeArgs& a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long row = decode_row(a, b);
  if (row < 0) return;
  const float* wp = a.ws + (size_t(b) * a.H + h) * a.splits * (D + 2);
  float M = kNegInf;
  for (int s = 0; s < a.splits; ++s) M = fmaxf(M, wp[s * (D + 2) + D]);
  float L = 0.f, O = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const float e = exp2f(wp[s * (D + 2) + D] - M);  // an empty split: NEG_INF -> 0
    L = fmaf(wp[s * (D + 2) + D + 1], e, L);
    O = fmaf(wp[s * (D + 2) + d], e, O);
  }
  rtt::store(static_cast<T*>(a.out) + (row * a.H + h) * D + d, O / (L == 0.f ? 1.f : L));
}

// Launch a library's split kernel (and its combine kernel when the
// workspace is set) for row blocks of R.
template <typename T, int D, int R, typename SplitKernel, typename CombineKernel>
cudaError_t launch_decode(SplitKernel split_kernel, CombineKernel combine_kernel,
                          const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = decode_smem_bytes<T, D, R>();
  cudaError_t err = sm90::allow_smem(split_kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.KVH;
  split_kernel<<<dim3(a.splits, a.KVH * ((G + R - 1) / R), B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.ws == nullptr) return err;
  combine_kernel<<<dim3(a.H, B), D, 0, stream>>>(a);
  return cudaGetLastError();
}

// dtype 0 = float32, 1 = bfloat16; calls L::run<T, D, R>(a, B, stream)
// with R the row block: 16 (the mma's m) in bf16; in fp32 the smallest of
// 4, 8, 16 that holds the group (16-row blocks beyond).
template <typename L>
cudaError_t dispatch_decode(int dtype, int D, const DecodeArgs& a, int B, cudaStream_t s) {
  if (a.splits < 1 || a.splits > 65535 || (a.splits > 1) != (a.ws != nullptr))
    return cudaErrorInvalidValue;
  const int G = a.H / a.KVH;
  if (dtype == 1 && D == 64) return L::template run<bf16, 64, kMmaRows>(a, B, s);
  if (dtype == 1 && D == 128) return L::template run<bf16, 128, kMmaRows>(a, B, s);
  auto rows = [&](auto d) -> cudaError_t {
    constexpr int Dc = decltype(d)::value;
    if (G <= 4) return L::template run<float, Dc, 4>(a, B, s);
    if (G <= 8) return L::template run<float, Dc, 8>(a, B, s);
    return L::template run<float, Dc, 16>(a, B, s);
  };
  if (dtype == 0 && D == 64) return rows(std::integral_constant<int, 64>{});
  if (dtype == 0 && D == 128) return rows(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

}  // namespace rtd
