// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in, bf16
// dQ / dK / dV out, float32 accumulation.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel`
// (lhrs_bot_tpu/ops/attention.py:291) and `_flash_bwd_dkv_kernel` (:357),
// driven by `_flash_attention_bwd_pallas` (:429). Same semantics and the
// same two-pass split: from the forward's output O and float32 log-sum-exp
// (B, H, Sq), and delta = rowsum(dO * O) in float32 (computed by the caller,
// as XLA computes it there), each kernel recomputes P = exp(s * scale - lse)
// under the forward's masks: top-left causal (kv_id <= q_id), kv_mask
// (B, Skv), packing segment ids (B, S) (i attends j iff seg[i] == seg[j] >
// 0), and the ragged tails. A row with no valid key has lse = 1e30, so its P
// underflows to 0 without a special case. Rows past Sq contribute nothing to
// dK / dV.
//
// Rounding points, as the TPU kernels take them: dP = dO V^T is a float32
// sum of products of bf16 values (wgmma bf16 x bf16 -> f32 gives it up to
// summation order); dS = P * (dP - delta) * scale in float32, rounded to
// bf16 only as the operand of the dQ (dS K) and dK (dS^T Q) products. The
// TPU's dV = P^T dO multiplies the float32 P (`:412-414`); here P is split
// into bf16 halves hi + lo (lo = bf16(P - hi)) and both halves go through
// the tensor cores, which keeps 16 bits of P's mantissa instead of bf16's 8.
// P is computed with a base-2 exponent, the scale and log2 e folded into
// one multiply (as the forward does).
//
// No atomics: the dQ kernel owns its q rows and the dK/dV kernel its kv
// rows, so every output element is one thread's sum in a fixed order and
// repeated runs are bit-identical.
//
// What bounds them on the H100: at the decoder's training shape (H32, D128,
// S 2048-2620, causal) five S x S x D products per head (QK^T, dO V^T and dS
// K in the dQ pass; the same two recomputed, P^T dO twice and dS^T Q in the
// dK/dV pass), so the passes are compute-bound, and only wgmma reaches the
// tensor cores' rate; the exponentials and masks between the products run
// on the CUDA cores and have to overlap another CTA's products. At the
// perceiver's shapes (Sq <= 64, Skv <= 320, D64) they are short and bound by
// launch and load latency. With packed segments or a padded batch most
// causal tile pairs hold no pair that attends.
//
// Design: a CTA is one warpgroup (128 threads) over 64 rows, and two share
// an SM (three for dQ at D64). A CTA of more warps gets fewer registers: an
// SM's four schedulers each hold 16,384 of them, and a 9-warp CTA puts 3
// warps on one, so ptxas holds it to 168 a thread; at D128 the dK/dV
// accumulators alone take 128, and such a CTA spilled (PERF.md). So there is
// no producer warp: after a barrier that shows a stage free, thread 0 issues
// its TMA copies and threads 0-63 its rows' cp.async copies, all completing
// on the stage's mbarrier. TMA copies the operand tiles through 4-D tensor
// maps (D, S, H, B), in 128-byte swizzle, rows past S as zeros; cp.async
// copies each tile's rows of lse, delta, segment ids and kv_mask, which
// start anywhere (a 1-D TMA box of them that started unaligned trapped on
// an H100). The
// warpgroup issues wgmma.mma_async: the score products with B from shared
// memory, K-major over D; the gradient products with the probabilities or
// dS from registers (re-packed as bf16 A fragments) and the other operand
// MN-major.
//  - dQ: one CTA per (batch * head, 64-row q tile), the heaviest causal
//    tiles first. Q is loaded once by TMA, dO once into registers as the A
//    fragments of dP = dO V^T, which leaves room for three K stages beside
//    two V stages: each K tile is requested two tiles before it is needed,
//    though its stage is busy until dS K retires. A tile's S = Q K^T and
//    dP = dO V^T, then its dQ += dS K, each retire before the next is
//    issued: issuing the next tile's S and dP beside dS K, as the forward
//    overlaps its products, made ptxas serialize the wgmmas (C7514) and
//    ran 6-18% slower on an H100 (PERF.md); the other CTA on the SM fills
//    the gaps.
//  - dK/dV: one CTA per (batch * head, 64-row kv tile), the low kv tiles
//    first; K and V loaded once, one ring of Q and dO tiles with their rows'
//    lse, delta and segment ids. The warpgroup computes S^T = K Q^T and
//    dP^T = V dO^T, forms P^T (hi, lo) and dS^T in registers and issues
//    dV += P^T dO (twice) and dK += dS^T Q.
// Tile pairs that no pair can attend are skipped: the caller passes a byte
// table of the pairs to run, built by `ops/attention.py`'s `bwd_tile_table`
// (above the causal diagonal, or the q tile's and the kv tile's ranges of
// segment ids disjoint, which covers a kv tile of masked keys and a q tile
// of segment 0), and both kernels run exactly the pairs it sets, each CTA
// walking its own row of it: (q tile, kv tile) for dQ, the transpose for
// dK/dV. Every pair the rule skips would add exactly 0;
// a CTA with no tile writes zeros. Waits trap after 2^26 spins, so a
// protocol fault is a launch error, not a hung card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kTile = 64;      // rows of every q and kv tile
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* lse;        // (B, H, Sq)
  const float* delta;      // (B, H, Sq)
  const uint8_t* kv_mask;  // (B, Skv) or null
  const int* seg;          // (B, S) or null
  // the tile pairs to run: (B, nq, nk) for dQ, its transpose (B, nk, nq)
  // for dK/dV, so that each CTA reads a row
  const uint8_t* runs;
  const __nv_bfloat16* dout;  // (B, H, Sq, D)
  __nv_bfloat16* out0;     // dQ, or dK
  __nv_bfloat16* out1;     // dV
  int B, H, Sq, Skv, causal, nq, nk;
  float scale, scale_log2;  // sm_scale, sm_scale * log2(e)
};

// The TMA maps of the four (B, H, S, D) operands.
enum { kMapQ, kMapDo, kMapK, kMapV, kMaps };
struct Maps {
  CUtensorMap m[kMaps];
};

// The first tile at or after i (of n) that runs in a row of the run table,
// or -1. Every lane of the warp calls it alike: each reads one byte of 32
// and the warp's vote picks the first. (A scalar walk, or the vote kept
// across calls, made ptxas serialize the wgmmas, C7514: PERF.md.)
__device__ __forceinline__ int next_run(const uint8_t* row, int i, int n) {
  const int lane = threadIdx.x & 31;
  for (; i < n; i += 32) {
    const bool set = i + lane < n && row[i + lane] != 0;
    const unsigned votes = __ballot_sync(0xffffffffu, set);
    if (votes != 0) return i + __ffs(votes) - 1;
  }
  return -1;
}

// The first kv tile at or after ik that q tile iq runs (its row of the dQ
// table), or -1.
__device__ __forceinline__ int next_kv_tile(const Params& p, int b, int iq,
                                            int ik) {
  return next_run(p.runs + ((size_t)b * p.nq + iq) * p.nk, ik, p.nk);
}

// The first q tile at or after iq that kv tile ik runs (its row of the
// dK/dV table, the transpose), or -1.
__device__ __forceinline__ int next_q_tile(const Params& p, int b, int ik,
                                           int iq) {
  return next_run(p.runs + ((size_t)b * p.nk + ik) * p.nq, iq, p.nq);
}

// 4 bytes global -> shared, asynchronously; only `bytes` (0-4) of them read,
// the rest zero-filled (src must be a valid address even for 0).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// An arrival on `bar` once this thread's cp.async copies have landed (the
// barrier's count includes it).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   sm90::smem_u32(bar))
               : "memory");
}

// Threads copying a stage's rows (one each), each arriving on its barrier
// beside thread 0's TMA arrival.
constexpr int kRowThreads = kTile;
constexpr int kFullCount = 1 + kRowThreads;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d = A B^T over D for two 64-row K-major tiles of D / 64 column blocks
// (64 rows x 128 bytes each); no commit.
template <int D>
__device__ __forceinline__ void mma_abt(float (&d)[kTile / 2],
                                        const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kTile * 128 + (kk % 4) * 32;
    sm90::wgmma_bf16_ss_m64n64k16(d, sm90::desc_sw128(a + off, 16, 1024),
                                  sm90::desc_sw128(b + off, 16, 1024),
                                  kk > 0);
  }
}

// d += A B for A (64 x 64) as bf16 register fragments and B a 64-row tile
// whose rows are A's columns, read MN-major (D contiguous); k step j2 reads
// rows [16 j2, 16 j2 + 16), the 64-column blocks 64 * 128 bytes apart; no
// fence or commit.
template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2],
                                       uint32_t (&a)[kTile / 16][4],
                                       const uint8_t* b) {
#pragma unroll
  for (int j2 = 0; j2 < kTile / 16; ++j2) {
    const uint64_t db = sm90::desc_sw128(b + j2 * 16 * 128, kTile * 128, 1024);
    if constexpr (D == 64)
      sm90::wgmma_bf16_rs_m64n64k16(d, a[j2], db);
    else
      sm90::wgmma_bf16_rs_m64n128k16(d, a[j2], db);
  }
}

// A 64 x 64 tile of accumulators as bf16 A fragments: element i of a wgmma
// tile sits at row g + 8 * ((i >> 1) & 1) of the warp's 16 and column
// 8 * (i >> 2) + 2t + (i & 1); k step j2 covers columns [16 j2, 16 j2 + 16).
__device__ __forceinline__ void pack_frag(uint32_t (&f)[kTile / 16][4],
                                          const float (&x)[kTile / 2]) {
#pragma unroll
  for (int j2 = 0; j2 < kTile / 16; ++j2)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      f[j2][q] = pack_bf16(x[8 * j2 + 2 * q], x[8 * j2 + 2 * q + 1]);
}

template <int D>
__device__ __forceinline__ void zero(float (&d)[D / 2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) d[i] = 0.f;
}

// Writes the warpgroup's 64 rows of a bf16 (rows, D) output from its
// accumulators; rows at or past n_rows are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2],
                                           const int (&row)[2], int n_rows,
                                           int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < n_rows)
        *reinterpret_cast<uint32_t*>(out + (size_t)row[r] * D + c) =
            pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------------------
// dQ = sum over kv tiles of bf16(dS) K
// ---------------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int kMinBlocks = D == 128 ? 2 : 3;
  static constexpr int kKStages = 3, kVStages = 2;
  static constexpr int kTileBytes = kTile * D * 2;
  // a K stage's rows: segment ids, then the kv_mask bytes as the 17 aligned
  // words that cover them
  static constexpr int kKeyBytes = kTile * 4 + 128;
  static constexpr int kSmem = 1024 + (1 + kKStages + kVStages) * kTileBytes +
                               kKStages * kKeyBytes +
                               (kKStages + kVStages + 1) * 8;
};

// Q, kKStages K tiles and kVStages V tiles (each D / 64 column blocks of
// 64 rows x 128 bytes), each K stage's rows' segment ids and mask bytes,
// and the barriers.
template <int D>
struct DqSmem {
  using C = DqCfg<D>;
  uint8_t* q;
  uint8_t* ring;  // K stages, then V stages
  uint8_t* keys;  // (kKStages, kKeyBytes)
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* q_full;

  __device__ explicit DqSmem(uint8_t* raw) {
    q = align1024(raw);
    ring = q + C::kTileBytes;
    keys = ring + (C::kKStages + C::kVStages) * C::kTileBytes;
    full_k = reinterpret_cast<uint64_t*>(keys + C::kKStages * C::kKeyBytes);
    full_v = full_k + C::kKStages;
    q_full = full_v + C::kVStages;
  }
  __device__ uint8_t* k(int s) const { return ring + s * C::kTileBytes; }
  __device__ uint8_t* v(int s) const {
    return ring + (C::kKStages + s) * C::kTileBytes;
  }
  __device__ int* kseg(int s) const {
    return reinterpret_cast<int*>(keys + s * C::kKeyBytes);
  }
  __device__ uint8_t* kmask(int s) const {
    return keys + s * C::kKeyBytes + kTile * 4;
  }
};

// Threads 0-63, after a barrier that shows K stage s free: kv tile ik's K
// (thread 0, TMA) and its rows' segment ids and kv_mask bytes (cp.async)
// into the stage. The mask bytes [o, o + 64) of the flat (B * Skv) array,
// o = b * Skv + kv0, arrive as the 17 words from o & ~3.
template <int D>
__device__ __forceinline__ void dq_load_k(const Params& p, const Maps& m,
                                          const DqSmem<D>& sm, int s, int ik,
                                          int b, int hd) {
  const int kv0 = ik * kTile, tid = threadIdx.x;
  uint64_t* bar = &sm.full_k[s];
  if (tid == 0) {
    sm90::mbar_arrive_tx(bar, DqCfg<D>::kTileBytes);
    for (int cb = 0; cb < D / 64; ++cb)
      sm90::tma_load_4d(sm.k(s) + cb * kTile * 128, &m.m[kMapK], bar,
                        cb * 64, kv0, hd, b);
  }
  if (p.seg != nullptr) {
    const size_t i = (size_t)b * p.Skv + kv0 + tid;
    const bool in = kv0 + tid < p.Skv;
    cp_async4(sm.kseg(s) + tid, in ? p.seg + i : p.seg, in ? 4 : 0);
  }
  if (p.kv_mask != nullptr && tid <= kTile / 4) {
    const long long w = (((long long)b * p.Skv + kv0) & ~3LL) + 4 * tid;
    const long long left = (long long)p.B * p.Skv - w;
    const int bytes = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
    cp_async4(sm.kmask(s) + 4 * tid, bytes > 0 ? p.kv_mask + w : p.kv_mask,
              bytes);
  }
  cp_async_arrive(bar);
}

template <int D>
__device__ __forceinline__ void dq_load_v(const Maps& m, const DqSmem<D>& sm,
                                          int s, int ik, int b, int hd) {
  sm90::mbar_arrive_tx(&sm.full_v[s], DqCfg<D>::kTileBytes);
  for (int cb = 0; cb < D / 64; ++cb)
    sm90::tma_load_4d(sm.v(s) + cb * kTile * 128, &m.m[kMapV], &sm.full_v[s],
                      cb * 64, ik * kTile, hd, b);
}

// S = Q K^T (Q from shared memory) and dP = dO V^T (dO from registers) for
// one K and V stage, one commit group.
template <int D>
__device__ __forceinline__ void dq_issue_s_dp(float (&sc)[kTile / 2],
                                              float (&dp)[kTile / 2],
                                              uint32_t (&dof)[D / 16][4],
                                              const DqSmem<D>& sm, int sk,
                                              int sv) {
  sm90::fence_regs(sc);
  sm90::fence_regs(dp);
  sm90::fence_regs(dof);
  sm90::wgmma_fence();
  mma_abt<D>(sc, sm.q, sm.k(sk));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_bf16_rs_m64n64k16_kmajor(
        dp, dof[kk],
        sm90::desc_sw128(sm.v(sv) + (kk / 4) * kTile * 128 + (kk % 4) * 32,
                         16, 1024),
        kk > 0);
  sm90::wgmma_commit();
}

// dS = P (dP - delta) scale in place of the scores, P = 2^(s scale log2 e -
// lse log2 e) under the masks; the kv_mask byte of column c is kmask[moff
// + c].
template <bool kSeg>
__device__ __forceinline__ void dq_ds(
    float (&sc)[kTile / 2], const float (&dp)[kTile / 2], const int* kseg,
    const uint8_t* kmask, int moff, int kv0, bool need_mask, const Params& p,
    const int (&qrow)[2], const int (&segq)[2], const float (&lse2)[2],
    const float (&dlt)[2], int t) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e >> 1;
      float x = sc[i] * p.scale_log2 - lse2[r];
      if (need_mask) {
        const int col = 8 * j + 2 * t + (e & 1);
        const bool ok = kv0 + col < p.Skv &&
                        (p.kv_mask == nullptr || kmask[moff + col] != 0) &&
                        (!kSeg || (segq[r] > 0 && kseg[col] == segq[r])) &&
                        (!p.causal || kv0 + col <= qrow[r]);
        x = ok ? x : kNegInf;
      }
      sc[i] = ex2(x) * (dp[i] - dlt[r]) * p.scale;
    }
  }
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, DqCfg<D>::kMinBlocks)
    flash_bwd_dq_kernel(const __grid_constant__ Maps m, const Params p) {
  using C = DqCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const DqSmem<D> sm(smem_raw);
  const int bh = blockIdx.x, b = bh / p.H, hd = bh % p.H;
  const int iq = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int q0 = iq * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = threadIdx.x == 0, rows = threadIdx.x < kRowThreads;
  if (leader) {
    for (int s = 0; s < C::kKStages; ++s)
      sm90::mbar_init(&sm.full_k[s], kFullCount);
    for (int s = 0; s < C::kVStages; ++s) sm90::mbar_init(&sm.full_v[s], 1);
    sm90::mbar_init(sm.q_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // the kv tiles this CTA runs: ik the current one, load the next to copy
  // (running tile j sits in K stage j % 3 and V stage j % 2; K stages are
  // filled two tiles ahead, V stages one)
  int ik = next_kv_tile(p, b, iq, 0);
  int load = ik;
  if (ik >= 0) {
    if (leader) {
      sm90::mbar_arrive_tx(sm.q_full, C::kTileBytes);
      for (int cb = 0; cb < D / 64; ++cb)
        sm90::tma_load_4d(sm.q + cb * kTile * 128, &m.m[kMapQ], sm.q_full,
                          cb * 64, q0, hd, b);
    }
    for (int n = 0; n < 2 && load >= 0; ++n) {
      if (rows) dq_load_k<D>(p, m, sm, n, load, b, hd);
      if (leader) dq_load_v<D>(m, sm, n, load, b, hd);
      load = next_kv_tile(p, b, iq, load + 1);
    }
  }

  const int qrow[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float lse2[2], dlt[2];
  int segq[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows past Sq are not written
    const bool in = qrow[r] < p.Sq;
    const size_t i = (size_t)bh * p.Sq + qrow[r];
    lse2[r] = in ? p.lse[i] * kLog2e : 0.f;
    dlt[r] = in ? p.delta[i] : 0.f;
    if (kSeg && in) segq[r] = p.seg[(size_t)b * p.Sq + qrow[r]];
  }
  float acc[D / 2];
  zero<D>(acc);
  float sc[kTile / 2], dp[kTile / 2];
  uint32_t dsf[kTile / 16][4];
  // dO rows as the A fragments of dP = dO V^T: k step kk covers columns
  // [16 kk, 16 kk + 16), fragment q the row g + 8 (q & 1), columns 16 kk +
  // 2t + 8 (q >> 1) and the next
  uint32_t dof[D / 16][4];
  const __nv_bfloat16* dor = p.dout + (size_t)bh * p.Sq * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = qrow[q & 1], col = 16 * kk + 2 * t + 8 * (q >> 1);
      dof[kk][q] = row < p.Sq ? *reinterpret_cast<const uint32_t*>(
                                    dor + (size_t)row * D + col)
                              : 0u;
    }
  const bool any_mask = p.kv_mask != nullptr || kSeg;
  if (ik >= 0) {
    sm90::mbar_wait(sm.q_full, 0);
    sm90::mbar_wait(&sm.full_k[0], 0);
    sm90::mbar_wait(&sm.full_v[0], 0);
    dq_issue_s_dp<D>(sc, dp, dof, sm, 0, 0);
    for (int i = 0;; ++i) {
      const int sk = i % C::kKStages, sv = i % C::kVStages;
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      // K stage of tile i + 2 (last held by tile i - 1, whose dS K is done)
      // and V stage of tile i + 2 (tile i's, whose dP is done) are free
      __syncthreads();
      if (load >= 0) {
        if (rows) dq_load_k<D>(p, m, sm, (i + 2) % C::kKStages, load, b, hd);
        if (leader) dq_load_v<D>(m, sm, sv, load, b, hd);
      }
      const int kv0 = ik * kTile;
      const bool need_mask = any_mask || kv0 + kTile > p.Skv ||
                             (p.causal && kv0 + kTile - 1 > q0);
      dq_ds<kSeg>(sc, dp, sm.kseg(sk), sm.kmask(sk),
                  (int)(((long long)b * p.Skv + kv0) & 3), kv0, need_mask, p,
                  qrow, segq, lse2, dlt, t);
      pack_frag(dsf, sc);
      sm90::fence_regs(dsf);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      mma_rs<D>(acc, dsf, sm.k(sk));
      sm90::wgmma_commit();
      if (load >= 0) load = next_kv_tile(p, b, iq, load + 1);
      ik = next_kv_tile(p, b, iq, ik + 1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(dsf);
      if (ik < 0) break;
      const int sk2 = (i + 1) % C::kKStages, sv2 = (i + 1) % C::kVStages;
      sm90::mbar_wait(&sm.full_k[sk2], ((i + 1) / C::kKStages) & 1);
      sm90::mbar_wait(&sm.full_v[sv2], ((i + 1) / C::kVStages) & 1);
      dq_issue_s_dp<D>(sc, dp, dof, sm, sk2, sv2);
    }
  }
  store_rows<D>(p.out0 + (size_t)bh * p.Sq * D, acc, qrow, p.Sq, t);
}

// ---------------------------------------------------------------------------
// dV = sum over q tiles of P^T dO (P as hi + lo bf16), dK of bf16(dS)^T Q
// ---------------------------------------------------------------------------

template <int D>
struct DkvCfg {
  static constexpr int kMinBlocks = 2;
  static constexpr int kStages = 2;
  static constexpr int kTileBytes = kTile * D * 2;  // K, V, a Q or dO tile
  // a stage's rows: lse, delta and segment ids
  static constexpr int kRowBytes = 3 * kTile * 4;
  static constexpr int kSmem = 1024 + (2 + 2 * kStages) * kTileBytes +
                               kStages * kRowBytes + (kStages + 1) * 8;
};

// K, V, kStages Q tiles and kStages dO tiles (each D / 64 column blocks of
// 64 rows x 128 bytes), each stage's rows' lse, delta and segment ids, and
// the barriers.
template <int D>
struct DkvSmem {
  using C = DkvCfg<D>;
  uint8_t* k;
  uint8_t* v;
  uint8_t* ring;  // Q stages, then dO stages
  uint8_t* rows;  // (kStages, kRowBytes)
  uint64_t* full;
  uint64_t* kv_full;

  __device__ explicit DkvSmem(uint8_t* raw) {
    k = align1024(raw);
    v = k + C::kTileBytes;
    ring = v + C::kTileBytes;
    rows = ring + 2 * C::kStages * C::kTileBytes;
    full = reinterpret_cast<uint64_t*>(rows + C::kStages * C::kRowBytes);
    kv_full = full + C::kStages;
  }
  __device__ uint8_t* q(int s) const { return ring + s * C::kTileBytes; }
  __device__ uint8_t* dout(int s) const {
    return ring + (C::kStages + s) * C::kTileBytes;
  }
  __device__ float* lse(int s) const {
    return reinterpret_cast<float*>(rows + s * C::kRowBytes);
  }
  __device__ float* delta(int s) const { return lse(s) + kTile; }
  __device__ int* seg(int s) const {
    return reinterpret_cast<int*>(lse(s) + 2 * kTile);
  }
};

// Threads 0-63, after a barrier that shows stage s free: q tile iq's Q and
// dO (thread 0, TMA) and its rows' lse, delta and segment ids (cp.async;
// rows past Sq as zeros) into the stage.
template <int D>
__device__ __forceinline__ void dkv_load_q(const Params& p, const Maps& m,
                                           const DkvSmem<D>& sm, int s,
                                           int iq, int b, int hd, int bh) {
  const int q0 = iq * kTile, tid = threadIdx.x;
  uint64_t* bar = &sm.full[s];
  if (tid == 0) {
    sm90::mbar_arrive_tx(bar, 2 * DkvCfg<D>::kTileBytes);
    for (int cb = 0; cb < D / 64; ++cb) {
      sm90::tma_load_4d(sm.q(s) + cb * kTile * 128, &m.m[kMapQ], bar,
                        cb * 64, q0, hd, b);
      sm90::tma_load_4d(sm.dout(s) + cb * kTile * 128, &m.m[kMapDo], bar,
                        cb * 64, q0, hd, b);
    }
  }
  const bool in = q0 + tid < p.Sq;
  const size_t i = (size_t)bh * p.Sq + q0 + tid;
  cp_async4(sm.lse(s) + tid, in ? p.lse + i : p.lse, in ? 4 : 0);
  cp_async4(sm.delta(s) + tid, in ? p.delta + i : p.delta, in ? 4 : 0);
  if (p.seg != nullptr) {
    const size_t j = (size_t)b * p.Sq + q0 + tid;
    cp_async4(sm.seg(s) + tid, in ? p.seg + j : p.seg, in ? 4 : 0);
  }
  cp_async_arrive(bar);
}

// P^T and dS^T of one tile in place of S^T and dP^T, under the masks: kv
// row krow[r], q column q0 + c.
template <bool kSeg>
__device__ __forceinline__ void dkv_p_ds(
    float (&st)[kTile / 2], float (&dpt)[kTile / 2], const float* lse,
    const float* dlt, const int* qseg, int q0, bool need_mask,
    const Params& p, const int (&krow)[2], const int (&kkey)[2], int t) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e >> 1;
      const int c = 8 * j + 2 * t + (e & 1);
      float x = st[i] * p.scale_log2 - lse[c] * kLog2e;
      if (need_mask) {
        const bool ok = q0 + c < p.Sq && kkey[r] >= 0 &&
                        (!kSeg || (qseg[c] > 0 && qseg[c] == kkey[r])) &&
                        (!p.causal || krow[r] <= q0 + c);
        x = ok ? x : kNegInf;
      }
      const float pv = ex2(x);
      st[i] = pv;
      dpt[i] = pv * (dpt[i] - dlt[c]) * p.scale;
    }
  }
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, DkvCfg<D>::kMinBlocks)
    flash_bwd_dkv_kernel(const __grid_constant__ Maps m, const Params p) {
  using C = DkvCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const DkvSmem<D> sm(smem_raw);
  const int bh = blockIdx.x, b = bh / p.H, hd = bh % p.H;
  const int ik = blockIdx.y;  // low kv tiles see the most q tiles: first
  const int kv0 = ik * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = threadIdx.x == 0, rows = threadIdx.x < kRowThreads;
  if (leader) {
    for (int s = 0; s < C::kStages; ++s)
      sm90::mbar_init(&sm.full[s], kFullCount);
    sm90::mbar_init(sm.kv_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // the q tiles this CTA runs: iq the current one, load the next to copy
  int iq = next_q_tile(p, b, ik, 0);
  int load = iq;
  if (iq >= 0) {
    if (leader) {
      sm90::mbar_arrive_tx(sm.kv_full, 2 * C::kTileBytes);
      for (int cb = 0; cb < D / 64; ++cb) {
        sm90::tma_load_4d(sm.k + cb * kTile * 128, &m.m[kMapK], sm.kv_full,
                          cb * 64, kv0, hd, b);
        sm90::tma_load_4d(sm.v + cb * kTile * 128, &m.m[kMapV], sm.kv_full,
                          cb * 64, kv0, hd, b);
      }
    }
    for (int s = 0; s < C::kStages && load >= 0; ++s) {
      if (rows) dkv_load_q<D>(p, m, sm, s, load, b, hd, bh);
      load = next_q_tile(p, b, ik, load + 1);
    }
  }

  const int krow[2] = {kv0 + 16 * warp + g, kv0 + 16 * warp + g + 8};
  int kkey[2];  // -1: no query attends the row; else its segment id or 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = (size_t)b * p.Skv + krow[r];
    kkey[r] = krow[r] >= p.Skv || (p.kv_mask != nullptr && !p.kv_mask[i])
                  ? -1
                  : (kSeg ? p.seg[i] : 0);
  }
  float dk[D / 2], dv[D / 2];
  zero<D>(dk);
  zero<D>(dv);
  const bool any_mask = p.kv_mask != nullptr || kSeg;
  if (iq >= 0) sm90::mbar_wait(sm.kv_full, 0);
  for (int it = 0; iq >= 0; iq = next_q_tile(p, b, ik, iq + 1), ++it) {
    const int s = it % C::kStages;
    sm90::mbar_wait(&sm.full[s], (it / C::kStages) & 1);
    float st[kTile / 2], dpt[kTile / 2];
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
    mma_abt<D>(st, sm.k, sm.q(s));
    mma_abt<D>(dpt, sm.v, sm.dout(s));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    const int q0 = iq * kTile;
    const bool need_mask = any_mask || q0 + kTile > p.Sq ||
                           (p.causal && kv0 + kTile - 1 > q0);
    dkv_p_ds<kSeg>(st, dpt, sm.lse(s), sm.delta(s), sm.seg(s), q0, need_mask,
                   p, krow, kkey, t);
    uint32_t phi[kTile / 16][4], plo[kTile / 16][4], dsf[kTile / 16][4];
    pack_frag(phi, st);
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i)
      st[i] -= __bfloat162float(__float2bfloat16_rn(st[i]));
    pack_frag(plo, st);
    pack_frag(dsf, dpt);
    sm90::fence_regs(phi);
    sm90::fence_regs(plo);
    sm90::fence_regs(dsf);
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::wgmma_fence();
    mma_rs<D>(dv, phi, sm.dout(s));
    mma_rs<D>(dv, plo, sm.dout(s));
    mma_rs<D>(dk, dsf, sm.q(s));
    sm90::wgmma_commit();
    if (it >= C::kStages - 1 && load >= 0)  // the tile refilled below
      load = next_q_tile(p, b, ik, load + 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::fence_regs(phi);  // read by the products until they retire
    sm90::fence_regs(plo);
    sm90::fence_regs(dsf);
    __syncthreads();  // the stage is free: refill it
    if (rows && load >= 0) dkv_load_q<D>(p, m, sm, s, load, b, hd, bh);
  }
  store_rows<D>(p.out0 + (size_t)bh * p.Skv * D, dk, krow, p.Skv, t);
  store_rows<D>(p.out1 + (size_t)bh * p.Skv * D, dv, krow, p.Skv, t);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The TMA map of a contiguous (B, H, S, D) bf16 operand, read in boxes of
// 64 columns x 64 rows of one head.
bool operand_map(CUtensorMap* map, const void* base, int B, int H, int S,
                 int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  // a dimension of size 1 is never stepped: give it a stride TMA takes
  const cuuint64_t strides[3] = {
      S > 1 ? (cuuint64_t)D * 2 : 16,
      H > 1 ? (cuuint64_t)S * D * 2 : 16,
      B > 1 ? (cuuint64_t)H * S * D * 2 : 16};
  const cuuint32_t box[4] = {64, (cuuint32_t)kTile, 1, 1};
  return sm90::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                               dims, strides, box);
}

bool make_maps(Maps* m, const void* q, const void* k, const void* v,
               const void* dout, int B, int H, int Sq, int Skv, int D) {
  return operand_map(&m->m[kMapQ], q, B, H, Sq, D) &&
         operand_map(&m->m[kMapDo], dout, B, H, Sq, D) &&
         operand_map(&m->m[kMapK], k, B, H, Skv, D) &&
         operand_map(&m->m[kMapV], v, B, H, Skv, D);
}

template <typename Kernel>
int launch(Kernel kernel, int smem, dim3 grid, const Maps& m, const Params& p,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(m, p);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_dq(const Maps& m, const Params& p, int BH, cudaStream_t stream) {
  const dim3 grid(BH, p.nq);
  if (p.seg != nullptr)
    return launch(flash_bwd_dq_kernel<D, true>, DqCfg<D>::kSmem, grid, m, p,
                  stream);
  return launch(flash_bwd_dq_kernel<D, false>, DqCfg<D>::kSmem, grid, m, p,
                stream);
}

template <int D>
int dispatch_dkv(const Maps& m, const Params& p, int BH,
                 cudaStream_t stream) {
  const dim3 grid(BH, p.nk);
  if (p.seg != nullptr)
    return launch(flash_bwd_dkv_kernel<D, true>, DkvCfg<D>::kSmem, grid, m,
                  p, stream);
  return launch(flash_bwd_dkv_kernel<D, false>, DkvCfg<D>::kSmem, grid, m, p,
                stream);
}

bool bad_shape(int B, int H, int Sq, int Skv, int D, const void* seg,
               const void* runs) {
  return runs == nullptr || B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 ||
         B * H > 65535 ||
         (D != 64 && D != 128) || (seg != nullptr && Sq != Skv) ||
         (Sq + kTile - 1) / kTile > 65535 || (Skv + kTile - 1) / kTile > 65535;
}

Params make_params(const void* lse, const void* delta, const void* kv_mask,
                   const void* seg, const void* runs, const void* dout,
                   void* out0, void* out1, int B, int H, int Sq, int Skv,
                   int causal, float sm_scale) {
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.seg = static_cast<const int*>(seg);
  p.runs = static_cast<const uint8_t*>(runs);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.out0 = static_cast<__nv_bfloat16*>(out0);
  p.out1 = static_cast<__nv_bfloat16*>(out1);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.nq = (Sq + kTile - 1) / kTile;
  p.nk = (Skv + kTile - 1) / kTile;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  return p;
}

}  // namespace

// q, dout (B,H,Sq,D), k, v (B,H,Skv,D): contiguous bf16, 16-byte aligned.
// lse, delta (B,H,Sq) contiguous float32. kv_mask (B,Skv) bytes (0 =
// masked) or null; seg (B,S) int32 with S = Sq = Skv, or null. runs
// (B, ceil(Sq/64), ceil(Skv/64)) bytes: nonzero for each (64-row q tile,
// 64-row kv tile) pair to run, the others skipped (a pair skipped must hold
// no pair that attends). dq (B,H,Sq,D) contiguous bf16 output. D is 64 or
// 128. Returns cudaError_t.
extern "C" int lhrs_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* kv_mask,
                                 const void* seg, const void* runs, void* dq,
                                 int B, int H, int Sq, int Skv, int D,
                                 int causal, float sm_scale, void* stream) {
  Maps m;
  if (bad_shape(B, H, Sq, Skv, D, seg, runs) ||
      !make_maps(&m, q, k, v, dout, B, H, Sq, Skv, D))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(lse, delta, kv_mask, seg, runs, dout, dq,
                               nullptr, B, H, Sq, Skv, causal, sm_scale);
  auto* st = static_cast<cudaStream_t>(stream);
  if (D == 128) return dispatch_dq<128>(m, p, B * H, st);
  return dispatch_dq<64>(m, p, B * H, st);
}

// As lhrs_flash_bwd_dq, but runs is (B, ceil(Skv/64), ceil(Sq/64)): the
// transpose of dQ's table, a row a kv tile. dk, dv (B,H,Skv,D) contiguous
// bf16 outputs.
extern "C" int lhrs_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* kv_mask, const void* seg,
                                  const void* runs, void* dk, void* dv, int B,
                                  int H, int Sq, int Skv, int D, int causal,
                                  float sm_scale, void* stream) {
  Maps m;
  if (bad_shape(B, H, Sq, Skv, D, seg, runs) ||
      !make_maps(&m, q, k, v, dout, B, H, Sq, Skv, D))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(lse, delta, kv_mask, seg, runs, dout, dk, dv,
                               B, H, Sq, Skv, causal, sm_scale);
  auto* st = static_cast<cudaStream_t>(stream);
  if (D == 128) return dispatch_dkv<128>(m, p, B * H, st);
  return dispatch_dkv<64>(m, p, B * H, st);
}
