// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 or float32 out,
// f32 softmax.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (lhrs_bot_tpu/ops/attention.py:84,
// called through `_flash_attention_pallas` :178). Same semantics: optional
// kv_mask (B, Skv), top-left causal mask (kv_id <= q_id), rows with no valid
// key give exactly 0. Optional sequence-packing segment ids (B, S): position
// i attends j iff seg[i] == seg[j] > 0, combined with the masks above
// (`:139-145`); and an optional float32 log-sum-exp output (B, H, Sq) for
// the backward, m + log(l) per row and 1e30 for a row with no valid key, so
// that exp(s - lse) underflows to 0 there (`:172-175`). Null pointers mean
// "not given": the serving and vision launches are unchanged.
// Also the per-head attention inside the fused W8A8 vision blocks
// (lhrs_bot_tpu/ops/vit_block.py:111/:132, perceiver_block.py:53), whose
// output stays float32 until it is quantized: the float32-output variant
// (template flag) serves them. q, k, v and o are addressed through (batch,
// head, row) element strides, so the vision blocks read Q, K and V in place
// from their (tokens, 3 * width) projection and write the output
// token-major, (B, S, H, D), as the next projection reads it.
// The TPU vision kernels round the NORMALISED probabilities to bf16 before
// P V (their `jnn` and `exp2_pre` softmax modes, vit_block.py:75-86; the
// perceiver block and the split form's XLA attention always), where the
// online softmax below rounds the unnormalised ones and divides at the end
// (their `exp2_post` mode). A second template flag, kNorm, serves them: a
// first pass over the K tiles takes each row's max m and sum l, then the
// main loop computes P = exp2(s - m) / l, rounds it to bf16 and accumulates
// P V with no rescaling and no division at the end. The first pass repeats
// the Q K^T products (half the flops) but reads no V, and the vision key
// rows are at most 320 long (5 tiles); PERF.md has its time beside plain
// K1's. Only the vision blocks launch it; the decoder's and training's
// instantiations are unchanged.
//
// What bounds it on the H100: at the decoder-prefill shape (H32, D128, S up
// to 2191, causal) the two matrix products are compute-bound (about 4*S*S*D
// flops per head against 4*S*D bytes, 989 TFLOP/s dense bf16), and only
// wgmma reaches that rate; the softmax between the products (an exp and a
// few float32 operations a score) runs on the CUDA cores and has to overlap
// them. At the ViT/perceiver shapes (S <= 320, D64) a CTA has a few kv
// tiles, and the time goes to the latency of its loads, so several CTAs
// have to share an SM.
//
// Design: one CTA per (batch*head, 64-row q tile), the heaviest causal
// tiles scheduled first, of one consumer warpgroup and one producer warp.
// The producer loads the Q tile once and keeps two rings of two stages in
// flight, 64-row K tiles and V tiles, each as soon as the consumers release
// the stage: TMA copies each 64-column block of a tile into 128-byte
// swizzled shared memory (rows past S arrive as zeros), and the warp's
// lanes write each kv row's key (-1 masked or past Skv, else its segment id
// or 0) beside the K tile before arriving on its "full" mbarrier. The
// consumer computes S = Q K^T with wgmma.mma_async m64n64k16 from shared
// memory (both operands K-major over D) and O += P V with wgmma m64nDk16
// taking P from registers (the score accumulators after the softmax,
// re-packed as bf16 A fragments) and V MN-major through the descriptor's
// transpose bit. Tile i's S and tile i-1's P V are issued together, and
// tile i's mask, scale and online softmax (float32 registers, base-2
// exponent, the scale and log2 e folded into one multiply) run while P V
// retires; the output rows are rescaled after it. A CTA is small (160
// threads, 80 KB of shared memory at D128, 40 KB at D64) so that two (D128)
// or three (D64) share an SM: one CTA's softmax, loads and epilogue then
// overlap another's products. On an H100 this beat CTAs of two consumer
// warpgroups over 128 q rows (one an SM; ptxas holds 384 threads to 168
// registers a thread, setmaxnreg or not, and 128-row kv tiles spill there)
// at every shape (PERF.md). Causal CTAs stop at the diagonal tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The CTA's geometry: one consumer warpgroup over 64 q rows, kv tiles of
// 64 rows and a producer warp (160 threads), so that several CTAs share an
// SM and one's loads and softmax overlap another's products: three at D64
// (the vision towers; ptxas then keeps a thread to 128 registers), two at
// D128 (the decoder; 168).
template <int D>
struct Cfg {
  static constexpr int kBQ = 64;  // q rows a CTA
  static constexpr int kBN = 64;  // kv rows a stage
  static constexpr int kThreads = 128 + 32;
  static constexpr int kMinBlocks = D == 128 ? 2 : 3;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes +
                               kStages * kBN * 4 + (4 * kStages + 1) * 8;
};

struct Strides {  // element strides of a (B, H, S, D) operand; D is unit
  long long b, h, s;
};

struct Params {
  const uint8_t* kv_mask;  // (B, Skv) or null
  const int* seg;          // (B, S) or null
  void* o;
  float* lse;              // (B, H, Sq) or null
  int H, Sq, Skv, causal;
  int fault;               // kNorm: 1 skips the normalisation (checks only)
  float scale_log2;        // sm_scale * log2(e)
  Strides os;
};

// Shared memory of one CTA: the Q tile, kStages K tiles and kStages V tiles,
// the keys of each K stage's kv rows and the barriers. A tile is stored as
// D / 64 column blocks of rows x 128 bytes.
template <int D>
struct Smem {
  using C = Cfg<D>;
  uint8_t* q;
  uint8_t* ring;  // K tiles, then V tiles
  int* keys;      // (kStages, kBN)
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty_k;
  uint64_t* empty_v;
  uint64_t* q_full;

  __device__ explicit Smem(uint8_t* raw) {
    q = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    ring = q + C::kQBytes;
    keys = reinterpret_cast<int*>(ring + 2 * kStages * C::kTileBytes);
    full_k = reinterpret_cast<uint64_t*>(keys + kStages * C::kBN);
    full_v = full_k + kStages;
    empty_k = full_v + kStages;
    empty_v = empty_k + kStages;
    q_full = empty_v + kStages;
  }
  __device__ uint8_t* k(int s) const { return ring + s * C::kTileBytes; }
  __device__ uint8_t* v(int s) const {
    return ring + (kStages + s) * C::kTileBytes;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for the CTA's 64 rows and one K stage (committed, not waited
// for).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<D>::kBN / 2],
                                         const uint8_t* sq,
                                         const uint8_t* sk) {
  using C = Cfg<D>;
  sm90::fence_regs(sc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cb = kk / 4, kc = (kk % 4) * 32;
    sm90::wgmma_bf16_ss_m64n64k16(
        sc, sm90::desc_sw128(sq + cb * C::kBQ * 128 + kc, 16, 1024),
        sm90::desc_sw128(sk + cb * C::kBN * 128 + kc, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
}

// O += P V for one V stage: V is the MN-major B operand (D contiguous); k
// step j2 reads kv rows [16 j2, 16 j2 + 16), the 64-column blocks kBN * 128
// bytes apart (committed, not waited for).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pf)[Cfg<D>::kBN / 16][4],
                                         const uint8_t* sv) {
  constexpr int kBN = Cfg<D>::kBN;
  sm90::fence_regs(pf);
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int j2 = 0; j2 < kBN / 16; ++j2) {
    const uint64_t dv = sm90::desc_sw128(sv + j2 * 16 * 128, kBN * 128, 1024);
    if constexpr (D == 64)
      sm90::wgmma_bf16_rs_m64n64k16(acc, pf[j2], dv);
    else
      sm90::wgmma_bf16_rs_m64n128k16(acc, pf[j2], dv);
  }
  sm90::wgmma_commit();
}

// Mask, scale and the online softmax of one tile of scores, in place: sc
// becomes the (unnormalised) probabilities. Updates the running max m
// (units of log2) and the partial row sums l, and gives the factor alpha
// the output rows are to be rescaled by. Element i of a wgmma tile sits at
// row g + 8 * ((i >> 1) & 1) of the warp's 16 and column 8 * (i >> 2) + 2t
// + (i & 1).
template <int N, bool kSeg>
__device__ __forceinline__ void online_softmax(
    float (&sc)[N], const int* key, int kv0, bool need_mask, int causal,
    const int (&qrow)[2], const int (&segq)[2], float scale_log2, int t,
    float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = sc[4 * j + e] * scale_log2;
      if (need_mask) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int kc = key[col];
        const bool ok = (kSeg ? segq[r] > 0 && kc == segq[r] : kc >= 0) &&
                        (!causal || kv0 + col <= qrow[r]);
        x = ok ? x : kNegInf;
      }
      sc[4 * j + e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
    // a row with no valid key so far keeps m = kNegInf; its masked scores
    // must still give exp 0, not exp(0)
    base[r] = m[r] == kNegInf ? 0.f : m[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sc[i] = ex2(sc[i] - base[(i >> 1) & 1]);
    l[(i >> 1) & 1] += sc[i];
  }
}

// kNorm: the normalised probabilities of one tile, in place, from each
// row's final max (`base`, in units of log2; 0 for a row with no valid key)
// and the reciprocal of its sum (`inv`, 0 for such a row): masked scores
// give 0.
template <int N, bool kSeg>
__device__ __forceinline__ void normalized_probs(
    float (&sc)[N], const int* key, int kv0, bool need_mask, int causal,
    const int (&qrow)[2], const int (&segq)[2], float scale_log2, int t,
    const float (&base)[2], const float (&inv)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = sc[4 * j + e] * scale_log2;
      if (need_mask) {  // as online_softmax masks
        const int col = 8 * j + 2 * t + (e & 1);
        const int kc = key[col];
        const bool ok = (kSeg ? segq[r] > 0 && kc == segq[r] : kc >= 0) &&
                        (!causal || kv0 + col <= qrow[r]);
        x = ok ? x : kNegInf;
      }
      sc[4 * j + e] = ex2(x - base[r]) * inv[r];
    }
  }
}

// The probabilities as bf16 A fragments: k step j2 covers kv columns
// [16 j2, 16 j2 + 16), fragment q of it the elements 8 j2 + 2q, + 1.
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[N / 8][4],
                                       const float (&sc)[N]) {
#pragma unroll
  for (int j2 = 0; j2 < N / 8; ++j2)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pf[j2][q] = pack_bf16(sc[8 * j2 + 2 * q], sc[8 * j2 + 2 * q + 1]);
}

__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(bar);
}

// The consumer warpgroup: q rows [q0, q0 + 64). The loop keeps the tensor
// cores busy across the softmax: tile i's S = Q K^T and tile i-1's O += P V
// are issued together, and the softmax of tile i runs while P V retires.
// With kNorm a first pass over the K ring (the producer loads every K tile
// twice) fixes each row's max and sum before that loop.
template <int D, bool kF32Out, bool kSeg, bool kLse, bool kNorm>
__device__ __forceinline__ void consume(const Params& p, const Smem<D>& sm,
                                        int b, int hd, int bh, int q0,
                                        int n_tiles, int warp, int lane) {
  constexpr int kBN = Cfg<D>::kBN;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g;
  const int qrow[2] = {row0, row0 + 8};
  int segq[2] = {0, 0};  // rows past Sq are segment 0: they attend nothing
  if (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < p.Sq) segq[r] = p.seg[(size_t)b * p.Sq + qrow[r]];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in units of log2
  float l[2] = {0.f, 0.f};          // per-thread partial row sums
  float sc[kBN / 2], alpha[2];
  uint32_t pf[kBN / 16][4];
  // the masks are needed on a tile with a kv_mask, segments, rows past Skv
  // or columns past the CTA's first row (causal)
  const bool any_mask = p.kv_mask != nullptr || kSeg;
  const auto need_mask = [&](int kv0) {
    return any_mask || kv0 + kBN > p.Skv || (p.causal && kv0 + kBN - 1 > q0);
  };
  sm90::mbar_wait(sm.q_full, 0);

  // kNorm: the row's final max (base) and the reciprocal of its sum (inv);
  // it0 K tiles pass through the ring before the main loop
  float base[2], inv[2];
  const int it0 = kNorm ? n_tiles : 0;
  if constexpr (kNorm) {
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages, kv0 = i * kBN;
      sm90::mbar_wait(&sm.full_k[s], (i / kStages) & 1);
      issue_qk<D>(sc, sm.q, sm.k(s));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      online_softmax<kBN / 2, kSeg>(sc, sm.keys + s * kBN, kv0,
                                    need_mask(kv0), p.causal, qrow, segq,
                                    p.scale_log2, t, m, l, alpha);
      warp_arrive(&sm.empty_k[s], lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = p.fault ? 1.f : l[r] > 0.f ? 1.f / l[r] : 0.f;
      base[r] = m[r] == kNegInf ? 0.f : m[r];
    }
  }

  const int s0 = it0 % kStages;
  sm90::mbar_wait(&sm.full_k[s0], (it0 / kStages) & 1);
  issue_qk<D>(sc, sm.q, sm.k(s0));
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  if constexpr (kNorm)
    normalized_probs<kBN / 2, kSeg>(sc, sm.keys + s0 * kBN, 0, need_mask(0),
                                    p.causal, qrow, segq, p.scale_log2, t,
                                    base, inv);
  else
    online_softmax<kBN / 2, kSeg>(sc, sm.keys + s0 * kBN, 0, need_mask(0),
                                  p.causal, qrow, segq, p.scale_log2, t, m, l,
                                  alpha);
  warp_arrive(&sm.empty_k[s0], lane);
  pack_p(pf, sc);
  for (int i = 1; i < n_tiles; ++i) {
    const int it = it0 + i, s = it % kStages, sp = (i - 1) % kStages,
              kv0 = i * kBN;
    sm90::mbar_wait(&sm.full_k[s], (it / kStages) & 1);
    issue_qk<D>(sc, sm.q, sm.k(s));
    sm90::mbar_wait(&sm.full_v[sp], ((i - 1) / kStages) & 1);
    issue_pv<D>(acc, pf, sm.v(sp));
    sm90::wgmma_wait<1>();  // S of tile i is done; P V of tile i-1 runs on
    sm90::fence_regs(sc);
    if constexpr (kNorm)
      normalized_probs<kBN / 2, kSeg>(sc, sm.keys + s * kBN, kv0,
                                      need_mask(kv0), p.causal, qrow, segq,
                                      p.scale_log2, t, base, inv);
    else
      online_softmax<kBN / 2, kSeg>(sc, sm.keys + s * kBN, kv0,
                                    need_mask(kv0), p.causal, qrow, segq,
                                    p.scale_log2, t, m, l, alpha);
    warp_arrive(&sm.empty_k[s], lane);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    warp_arrive(&sm.empty_v[sp], lane);
    if constexpr (!kNorm) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    }
    pack_p(pf, sc);
  }
  const int last = (n_tiles - 1) % kStages;
  sm90::mbar_wait(&sm.full_v[last], ((n_tiles - 1) / kStages) & 1);
  issue_pv<D>(acc, pf, sm.v(last));
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // kNorm: P was normalised already, the output takes no 1 / l
  if constexpr (kNorm) {
    inv[0] = inv[1] = 1.f;
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
      if (kLse && t == 0 && qrow[r] < p.Sq)
        p.lse[(size_t)bh * p.Sq + qrow[r]] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : 1e30f;
    }
  }
  const size_t ob = b * p.os.b + hd * p.os.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] >= p.Sq) continue;
      const size_t i = ob + (size_t)qrow[r] * p.os.s + c;
      const float v0 = acc[4 * j + 2 * r] * inv[r];
      const float v1 = acc[4 * j + 2 * r + 1] * inv[r];
      if (kF32Out)
        *reinterpret_cast<float2*>(static_cast<float*>(p.o) + i) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.o) + i) =
            pack_bf16(v0, v1);
    }
  }
}

// The producer warp: Q once, then each kv tile's keys and K into a K stage
// and its V into a V stage, each stage as soon as the consumers have
// released it. With kNorm every K tile (and its keys) goes through the K
// ring twice, V only in the second pass.
template <int D, bool kSeg, bool kNorm>
__device__ __forceinline__ void produce(const Params& p, const Smem<D>& sm,
                                        const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int b, int hd,
                                        int q0, int n_tiles, int lane) {
  using C = Cfg<D>;
  if (lane == 0) {
    sm90::mbar_arrive_tx(sm.q_full, C::kQBytes);
    for (int cb = 0; cb < D / 64; ++cb)
      sm90::tma_load_4d(sm.q + cb * C::kBQ * 128, tm_q, sm.q_full, cb * 64,
                        q0, hd, b);
  }
  const int first_v = kNorm ? n_tiles : 0;  // the K load that V joins
  for (int it = 0; it < first_v + n_tiles; ++it) {
    const int s = it % kStages,
              kv0 = (it < first_v ? it : it - first_v) * C::kBN;
    const uint32_t parity = ((it / kStages) & 1) ^ 1;
    sm90::mbar_wait(&sm.empty_k[s], parity);
    for (int c = lane; c < C::kBN; c += 32) {
      const int kv = kv0 + c;
      int key = -1;
      if (kv < p.Skv &&
          (p.kv_mask == nullptr || p.kv_mask[(size_t)b * p.Skv + kv]))
        key = kSeg ? p.seg[(size_t)b * p.Skv + kv] : 0;
      sm.keys[s * C::kBN + c] = key;
    }
    if (lane == 0) {  // its arrival also counts the tile's bytes
      sm90::mbar_arrive_tx(&sm.full_k[s], C::kTileBytes);
      for (int cb = 0; cb < D / 64; ++cb)
        sm90::tma_load_4d(sm.k(s) + cb * C::kBN * 128, tm_k, &sm.full_k[s],
                          cb * 64, kv0, hd, b);
    } else {
      sm90::mbar_arrive(&sm.full_k[s]);  // releases this lane's keys
    }
    if (lane == 0 && it >= first_v) {
      const int iv = it - first_v, sv = iv % kStages;
      sm90::mbar_wait(&sm.empty_v[sv], ((iv / kStages) & 1) ^ 1);
      sm90::mbar_arrive_tx(&sm.full_v[sv], C::kTileBytes);
      for (int cb = 0; cb < D / 64; ++cb)
        sm90::tma_load_4d(sm.v(sv) + cb * C::kBN * 128, tm_v, &sm.full_v[sv],
                          cb * 64, kv0, hd, b);
    }
  }
}

template <int D, bool kF32Out, bool kSeg, bool kLse, bool kNorm>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  using C = Cfg<D>;
  constexpr int kConsumerWarps = 4;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  const int bh = blockIdx.x;
  const int b = bh / p.H, hd = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;  // heaviest first
  const int kv_end = p.causal ? min(p.Skv, q0 + C::kBQ) : p.Skv;
  const int n_tiles = (kv_end + C::kBN - 1) / C::kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full_k[s], 32);
      sm90::mbar_init(&sm.full_v[s], 1);
      sm90::mbar_init(&sm.empty_k[s], kConsumerWarps);
      sm90::mbar_init(&sm.empty_v[s], kConsumerWarps);
    }
    sm90::mbar_init(sm.q_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps)
    produce<D, kSeg, kNorm>(p, sm, &tm_q, &tm_k, &tm_v, b, hd, q0, n_tiles,
                            lane);
  else
    consume<D, kF32Out, kSeg, kLse, kNorm>(p, sm, b, hd, bh, q0, n_tiles,
                                           warp, lane);
}

template <int D, bool kF32Out, bool kSeg, bool kLse, bool kNorm = false>
int launch(const CUtensorMap* maps, const Params& p, dim3 grid,
           cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_fwd_kernel<D, kF32Out, kSeg, kLse, kNorm>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(maps[0], maps[1], maps[2],
                                                  p);
  return (int)cudaGetLastError();
}

// Segments and the LSE take a bf16 output only, and no normalize.
template <int D>
int dispatch(const CUtensorMap* maps, const Params& p, int B, int out_f32,
             int normalize, cudaStream_t stream) {
  const dim3 grid(B * p.H, (p.Sq + Cfg<D>::kBQ - 1) / Cfg<D>::kBQ);
  const bool seg = p.seg != nullptr, lse = p.lse != nullptr;
  if (normalize) {
    if (seg || lse) return (int)cudaErrorInvalidValue;
    if (out_f32) return launch<D, true, false, false, true>(maps, p, grid,
                                                            stream);
    return launch<D, false, false, false, true>(maps, p, grid, stream);
  }
  if (out_f32) {
    if (seg || lse) return (int)cudaErrorInvalidValue;
    return launch<D, true, false, false>(maps, p, grid, stream);
  }
  if (seg && lse) return launch<D, false, true, true>(maps, p, grid, stream);
  if (seg) return launch<D, false, true, false>(maps, p, grid, stream);
  if (lse) return launch<D, false, false, true>(maps, p, grid, stream);
  return launch<D, false, false, false>(maps, p, grid, stream);
}

// The TMA map of a (B, H, S, D) bf16 operand with element strides st[0..2]
// (batch, head, row), read in boxes of 64 columns x `rows` rows of one head.
bool operand_map(CUtensorMap* map, const void* base, int B, int H, int S,
                 int D, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  // a dimension of size 1 is never stepped: give it a stride TMA takes
  const cuuint64_t strides[3] = {
      S > 1 ? (cuuint64_t)st[2] * 2 : 16, H > 1 ? (cuuint64_t)st[1] * 2 : 16,
      B > 1 ? (cuuint64_t)st[0] * 2 : 16};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return sm90::make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base,
                               dims, strides, box);
}

}  // namespace

// q (B,H,Sq,D), k/v (B,H,Skv,D), o (B,H,Sq,D): bf16 (o float32 when
// out_f32), unit stride along D, the other strides in `strides` (12 element
// strides: batch, head, row of q, k, v, o; multiples of 8, 16-byte aligned
// bases). kv_mask: (B,Skv) bytes (0 = masked) or null. seg: (B,S) int32
// segment ids with S = Sq = Skv, or null. lse: (B,H,Sq) float32 output, or
// null. Segments and the LSE take a bf16 output only. normalize: round the
// normalised probabilities (kNorm; no segments, no LSE); fault 1 then skips
// the normalisation (a planted fault for checks). Returns cudaError_t.
extern "C" int lhrs_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kv_mask, const void* seg, void* o,
                              void* lse, int B, int H, int Sq, int Skv, int D,
                              int causal, float sm_scale, const void* strides,
                              int out_f32, int normalize, int fault,
                              void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || (D != 64 && D != 128) ||
      (seg != nullptr && Sq != Skv))
    return (int)cudaErrorInvalidValue;
  const auto* st = static_cast<const long long*>(strides);
  constexpr int bq = Cfg<64>::kBQ, bn = Cfg<64>::kBN;  // as Cfg<128>'s
  if ((Sq + bq - 1) / bq > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  if (!operand_map(&maps[0], q, B, H, Sq, D, st, bq) ||
      !operand_map(&maps[1], k, B, H, Skv, D, st + 3, bn) ||
      !operand_map(&maps[2], v, B, H, Skv, D, st + 6, bn))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.seg = static_cast<const int*>(seg);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.fault = fault;
  p.scale_log2 = sm_scale * kLog2e;
  p.os = Strides{st[9], st[10], st[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (D == 128) return dispatch<128>(maps, p, B, out_f32, normalize, cs);
  return dispatch<64>(maps, p, B, out_f32, normalize, cs);
}
