// K1's tiles (flash_fwd.cu): the CTA geometry (one consumer warpgroup over
// 64 q rows, 64-row kv tiles, a producer warp), its shared memory (a Q
// tile, two-stage K and V rings, the keys of each K stage), the two wgmma
// products of a tile (S = Q K^T from shared memory; O += P V with P from
// registers) and the online softmax of one tile of scores; and what the
// normalize-first kernels (flash_fwd_norm.cu) share with it: the packing
// of probabilities into bf16 A fragments, exp2, the barrier arrival of a
// warp and the TMA map of a (B, H, S, D) operand read through element
// strides. flash_fwd.cu's header has K1's design and what bounds it.

#pragma once

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
