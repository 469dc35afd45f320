// Chained int8 (and bf16) product probe, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels that benchmarks/int8_probe.py runs
// through `_pl_repeat` (:95, pallas_call at :101): `_k_int8` (:117),
// `_k_int8_req` (:131), `_k_int8_lhsT` (:147), `_k_int8_alt` (:161) and
// `_k_bf16` (:189). Grid step i takes its own (M, K) activation block of xg
// and the NDOTS resident (K, N) weights and writes acc[:8, :128] + sum(acc)
// as its (8, 128) output. On the TPU the five were five MXU forms; here they
// are two computations, which `chain_form` (lhrs_bot_tpu_torch/benchmarks/
// int8_probe.py) picks with the orientation of the window:
//   accumulate (int8, int8_lhsT, bf16): acc = sum_i x . w_i, int32 (float32
//       of bf16 operands for bf16). int8_lhsT's (N, M) accumulator
//       sum_i w_i^T . x^T is its transpose, so its window is acc[:128, :8]^T
//       and its total the same;
//   requant (int8_req, int8_alt): the chain h <- requant(h . w_i), with
//       f = acc * (1/127), per-row s = amax / 127 (1 where amax is 0),
//       h = clip(rint(f / s), +-127), acc the last product. int8_alt's
//       transposed products w^T . h^T, requantized per column, are the
//       transposes of h . w requantized per row, so its chain is
//       int8_req's bit for bit; at odd NDOTS its last product is the
//       transposed one and its window is acc[:128, :8]^T.
// Integer sums wrap modulo 2^32, as JAX's int32 sum does (wgmma's s32
// accumulation and the unsigned atomics both wrap), so any order of the
// partial sums gives the same bits.
//
// What bounds it on the H100: operations (2 M N K NDOTS a grid step, at the
// 1,979 TOP/s int8 / 989 TFLOP/s bf16 dense peaks). The weights (NDOTS K N
// elements) stay in the 50 MB L2, but each CTA streams all NDOTS of them
// past its 128 rows, so the L2 carries (g M / 128) NDOTS K N elements a
// call: 4 GiB for the probe's int8 shape, 7.7 TB/s at the int8 peak. Only
// wgmma reaches the tensor cores' rate, and int8 wgmma takes only K-major
// operands, which is why every variant is computed in the (M, N) form.
//
// Design. Each kernel's consumer warpgroups run wgmma on 128-byte K slices
// that TMA copies into 128-byte swizzled shared memory through a ring,
// announced on "full" mbarriers and handed back on "empty" ones once the
// wgmmas that read them have retired; one producer thread issues the
// copies. The weights are read as (N, K) rows, K contiguous
// (`weight_storage`: the transposed view of a contiguous (NDOTS, N, K)
// tensor), as kernel B reads them.
//   The accumulating kernel: a CTA of two consumer warpgroups (64 rows
// each) and a producer warp owns a 128 x 256 output tile of one block and
// sums all NDOTS products into one register accumulator (wgmma m64n256k32
// s8 / m64n256k16 bf16, 128 registers a thread). Its loop runs K slices
// outside and the NDOTS weights inside, so one 16 KB activation slice (two
// slots) serves NDOTS weight tiles (a 6-stage ring of 32 KB): x is read
// once a tile, and the bf16 block, 256 KB, never needs to be resident. (A
// cluster of 2 CTAs along M sharing each weight tile by TMA multicast ran
// 2.3x slower on an H100, whose L2 feeds single CTAs at 6.5 TB/s: PERF.md,
// row 15.) The CTA holding rows 0-127
// and columns 0-255 of a block writes its window (rows 0-7, or for lhsT
// the transposed columns 0-7); every CTA adds its part of sum(acc) with one
// atomic.
//   The requantized kernel: requantization is per row over all N columns,
// and the int32 rows of one 128-row product do not fit one CTA's
// registers, so N is split across a cluster of C = N / 256 CTAs over the
// same 128 rows. Each keeps the whole int8 h (128 x K, K = N <= 1024) in
// shared memory, and streams its 256 columns of w_i as 16 KB tiles of 128
// columns, each read by the two of its four consumer warpgroups that own
// that column half (one per 64-row half: m64n128k32, 64 accumulators a
// thread). After each product a warpgroup takes its rows' partial max|acc|
// within the quads and sends it to every CTA of the cluster by
// st.async, completing on the receivers' mbarrier (a rank has sent all its
// rows only once its wgmmas stopped reading h). Each CTA then forms the
// rows' scales (rowquant.cuh: the exact quotient from one RN reciprocal a
// row), writes its 256 columns' codes into its own h at their 128-byte
// swizzled positions (fence.proxy.async before the wgmmas and bulk copies
// read them), and sends that 32 KB to every peer by one bulk copy each,
// completing on the peer's mbarrier; the producer meanwhile streams the
// next product's first weight tiles. The producer is a warpgroup that
// hands its registers over (setmaxnreg: 24 for it, 112 for each consumer
// thread); with two consumer warpgroups of 128 accumulators each, the
// requantization spilled even at 240. The window and total come from the
// last product, as in the accumulating kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rowquant.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBM = 128;                   // rows of a CTA
constexpr int kSlice = 128;                // bytes of K a tile row holds
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kWarps = kConsumers / 32;
constexpr int kTile = kBM * kSlice;        // 128 rows of one K slice: 16 KB
constexpr float kInv127 = (float)(1.0 / 127.0);

// the accumulating kernel: 128 x 256 tiles, a 6-stage ring of 32 KB
constexpr int kAccN = 256;
constexpr int kAccStages = 6;
constexpr int kAccW = kAccN * kSlice;
constexpr int kAccRing = 2 * kTile + kAccStages * kAccW;
constexpr int kAccSmem = 1024 + kAccRing + (2 * kAccStages + 4) * 8 +
                         kWarps * 4;

// the requantized kernel: 256 columns a CTA, a 5-stage ring of 16 KB, h
// resident; a producer warpgroup, whose thread 0 issues the loads and which
// hands its registers to four consumer warpgroups, one for each (64-row
// half, 128-column half). setmaxnreg moves registers within the CTA's
// pool, which the launch sizes at 640 x (registers at launch): 640 x 96
// (ptxas's limit for 640 threads) holds 128 x 24 + 512 x 112, not 120 for
// the consumers. A pool too small would leave setmaxnreg.inc waiting for
// ever, so the host refuses to launch a build that gives fewer (req_pool_ok)
constexpr int kReqN = 256;
constexpr int kReqStages = 5;
constexpr int kMaxCluster = 4;  // N <= 1024
constexpr int kProducers = 128;
constexpr int kReqConsumers = 512;
constexpr int kReqThreads = kProducers + kReqConsumers;
constexpr int kProducerRegs = 24, kConsumerRegs = 112;
// its small state first, at fixed offsets: the barriers, the consumers'
// sums, the row maxima of each (rank, column half); then h (nk K slices)
// and the ring
constexpr int kReqBars = 3 * kReqStages + 2;
constexpr int kReqHead = 6144;  // 1024-aligned
static_assert(kReqBars * 8 + kReqConsumers / 32 * 4 +
                      2 * kMaxCluster * kBM * 4 <=
                  kReqHead,
              "the requantized kernel's small state must fit its head");
__host__ __device__ constexpr int req_smem(int nk) {
  return 1024 + kReqHead + nk * kTile + kReqStages * kTile;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ unsigned add_wrap(unsigned a, unsigned b) {
  return a + b;
}
__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }

// The consumers' sum of `part` (wrapping for integers) into *total: one
// atomic a CTA. ctid: the consumer thread's index, of `consumers`.
template <typename Sum>
__device__ void add_to_total(Sum part, Sum* red, Sum* total, int ctid,
                             int consumers) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    part = add_wrap(part, __shfl_xor_sync(0xffffffffu, part, o));
  if ((ctid & 31) == 0) red[ctid >> 5] = part;
  sm90::bar_sync(1, consumers);
  if (ctid == 0) {
    Sum s = red[0];
    for (int i = 1; i < consumers / 32; ++i) s = add_wrap(s, red[i]);
    atomicAdd(total, s);
  }
}

// Element e of a thread's m64nN wgmma accumulator lies in row r_lo + 8
// ((e >> 1) & 1) of the CTA's 128 (r_lo = 64 wg + 16 (warp % 4) + lane / 4)
// and column 8 (e >> 2) + 2 (lane % 4) + (e & 1) of the tile.
__device__ __forceinline__ int acc_row(int r_lo, int e) {
  return r_lo + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

// Window element of tile element (r, c) of a block's rows 0-127 and columns
// 0-127: (r, c) < (8, 128), or transposed (c, r).
template <typename Out, typename Acc>
__device__ __forceinline__ void window(Out* win, int r, int c, bool trans,
                                       Acc v) {
  const int wr = trans ? c : r, wc = trans ? r : c;
  if (wr < 8 && wc < 128) win[wr * 128 + wc] = (Out)v;
}

// ---- the accumulating kernel (int8, int8_lhsT, bf16) -----------------------

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    accumulate_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w, void* win,
                      void* total, int M, int N, int Kb, int ndots,
                      int trans) {
  using Acc = typename std::conditional<kBf16, float, int>::type;
  using Sum = typename std::conditional<kBf16, float, unsigned>::type;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align1024(smem_raw);  // two activation slices
  uint8_t* sw = sa + 2 * kTile;       // the weight ring
  uint64_t* full = reinterpret_cast<uint64_t*>(sa + kAccRing);
  uint64_t* empty = full + kAccStages;
  uint64_t* a_full = empty + kAccStages;
  uint64_t* a_empty = a_full + 2;
  Sum* red = reinterpret_cast<Sum*>(a_empty + 2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_m = M / kBM;
  const int gi = blockIdx.x / tiles_m, m0 = (blockIdx.x % tiles_m) * kBM;
  const int n0 = blockIdx.y * kAccN;
  const int nk = Kb / kSlice;

  if (tid == 0) {
    for (int s = 0; s < kAccStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kWarps);
    }
    for (int j = 0; j < 2; ++j) {
      sm90::mbar_init(&a_full[j], 1);
      sm90::mbar_init(&a_empty[j], kWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer: one thread issues
    if (lane == 0) {
      int it = 0;
      for (int kt = 0; kt < nk; ++kt) {
        const int as = kt & 1;
        sm90::mbar_wait(&a_empty[as], ((kt >> 1) & 1) ^ 1);
        sm90::mbar_arrive_tx(&a_full[as], kTile);
        sm90::tma_load_2d(sa + as * kTile, &tm_x, &a_full[as], kt * kSlice,
                          gi * M + m0);
        for (int d = 0; d < ndots; ++d, ++it) {
          const int s = it % kAccStages;
          sm90::mbar_wait(&empty[s], ((it / kAccStages) & 1) ^ 1);
          sm90::mbar_arrive_tx(&full[s], kAccW);
          sm90::tma_load_2d(sw + s * kAccW, &tm_w, &full[s], kt * kSlice,
                            d * N + n0);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  Acc acc[kAccN / 2];
#pragma unroll
  for (int e = 0; e < kAccN / 2; ++e) acc[e] = 0;
  int it = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int as = kt & 1;
    sm90::mbar_wait(&a_full[as], (kt >> 1) & 1);
    const uint8_t* a = sa + as * kTile + wg * 64 * kSlice;
    for (int d = 0; d < ndots; ++d, ++it) {
      const int s = it % kAccStages;
      sm90::mbar_wait(&full[s], (it / kAccStages) & 1);
      const uint8_t* w = sw + s * kAccW;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 32; ++kk) {
        const uint64_t da = sm90::desc_sw128(a + kk * 32, 16, 1024);
        const uint64_t dw = sm90::desc_sw128(w + kk * 32, 16, 1024);
        if constexpr (kBf16)
          sm90::wgmma_bf16_ss_m64n256k16(acc, da, dw, 1);
        else
          sm90::wgmma_s8_m64n256k32(acc, da, dw, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous stage's products have retired
      sm90::fence_regs(acc);
      if (it > 0 && lane == 0) {
        sm90::mbar_arrive(&empty[(it - 1) % kAccStages]);
        if (d == 0) sm90::mbar_arrive(&a_empty[(kt - 1) & 1]);
      }
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  const int r_lo = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  Sum part = 0;
#pragma unroll
  for (int e = 0; e < kAccN / 2; ++e) part = add_wrap(part, (Sum)acc[e]);
  if (m0 == 0 && n0 == 0) {
    Sum* wi = static_cast<Sum*>(win) + (size_t)gi * 8 * 128;
#pragma unroll
    for (int e = 0; e < kAccN / 2; ++e)
      window(wi, acc_row(r_lo, e), acc_col(lane, e), trans, acc[e]);
  }
  add_to_total(part, red, static_cast<Sum*>(total) + gi, tid, kConsumers);
}

// ---- the requantized kernel (int8_req, int8_alt) ------------------------

// The scale of a row whose max |acc| is `maxabs`: amax = max |f| =
// RN(RN(maxabs) * (1/127)) (f = RN(acc * (1/127)) is monotone in |acc|),
// s = RN(amax / 127), 1 where amax is 0. amax is 0 or at least 1/127, so s
// >= 2^-14 and needs none of rowquant.cuh's pre-scaling.
__device__ __forceinline__ float chain_scale(int maxabs) {
  const float amax = __fmul_rn(__int2float_rn(maxabs), kInv127);
  return amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
}

// The int8 code of acc in a row of scale s, y = RN(1 / s): rint(RN(acc *
// (1/127)) / s), the quotient correctly rounded (rowquant.cuh), |code| <=
// 127, rounded half to even by adding 1.5 * 2^23, whose low byte is then
// the code.
__device__ __forceinline__ uint32_t code_of(int acc, float s, float y) {
  const float f = __fmul_rn(__int2float_rn(acc), kInv127);
  return __float_as_uint(__fadd_rn(quotient_steps(f, s, y), 12582912.f)) &
         0xffu;
}

__global__ void __launch_bounds__(kReqThreads, 1)
    requant_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   unsigned* __restrict__ win, unsigned* __restrict__ total,
                   int M, int N, int ndots, int trans) {
  extern __shared__ uint8_t smem_raw[];
  const int nk = N / kSlice;  // K == N: h's K slices
  const int C = N / kReqN;    // the cluster's CTAs
  uint8_t* base = align1024(smem_raw);
  // a slot's "full" barrier for each column half: the two halves take
  // alternate stages, and a waiter must see every phase of its barrier
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // [half][slot]
  uint64_t* empty = full + 2 * kReqStages;
  uint64_t* h_full = empty + kReqStages;
  uint64_t* amax_full = h_full + 1;
  unsigned* red = reinterpret_cast<unsigned*>(full + kReqBars);
  uint32_t* amax_in = red + kReqConsumers / 32;  // [rank][half][row]
  uint8_t* sh = base + kReqHead;  // h, nk slices of 128 rows
  uint8_t* sw = sh + nk * kTile;  // the weight ring

  const uint32_t rank = sm90::cluster_rank();
  const int tiles_m = M / kBM;
  const uint32_t amax_bytes = 2 * C * kBM * 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kReqStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&full[kReqStages + s], 1);
      sm90::mbar_init(&empty[s], kWarps);  // the two warpgroups of a half
    }
    sm90::mbar_init(h_full, 1);
    sm90::mbar_init(amax_full, 1);
    sm90::mbar_fence_init();
    if (ndots > 1) sm90::mbar_arrive_tx(amax_full, amax_bytes);
  }
  sm90::cluster_arrive();  // the peers' barriers exist before any
  sm90::cluster_wait();    // st.async or bulk copy reaches them

  if (threadIdx.x < kProducers) {  // the producer warpgroup: one thread
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int col0 = rank * kReqN;  // this CTA's columns of every product
      sm90::mbar_arrive_tx(h_full, nk * kTile);  // h_0: x's rows
      for (int kt = 0; kt < nk; ++kt)
        sm90::tma_load_2d(sh + kt * kTile, &tm_x, h_full, kt * kSlice,
                          blockIdx.y * kBM);
      int it = 0;  // then every product's weights: each K slice of both
      for (int i = 0; i < ndots; ++i)  // column halves in turn
        for (int kt = 0; kt < nk; ++kt)
          for (int half = 0; half < 2; ++half, ++it) {
            const int s = it % kReqStages;
            uint64_t* f = &full[half * kReqStages + s];
            sm90::mbar_wait(&empty[s], ((it / kReqStages) & 1) ^ 1);
            sm90::mbar_arrive_tx(f, kTile);
            sm90::tma_load_2d(sw + s * kTile, &tm_w, f, kt * kSlice,
                              i * N + col0 + half * 128);
          }
    }
    sm90::cluster_arrive();
    sm90::cluster_wait();
    return;
  }
  sm90::setmaxnreg_inc<kConsumerRegs>();

  const int ctid = threadIdx.x - kProducers, warp = ctid >> 5;
  const int lane = ctid & 31, wg = warp >> 2;
  const int rows = wg & 1, half = wg >> 1;  // 64-row and 128-column halves
  const int r_lo = rows * 64 + (warp & 3) * 16 + (lane >> 2);
  int acc[64];
  for (int i = 0;; ++i) {
    // h_i complete: x's rows (phase 0), then the peers' columns of each
    // requantization (C - 1 bulk copies of 32 KB); this CTA's own columns
    // were written by the consumers before their last barrier
    sm90::mbar_wait(h_full, i & 1);
    if (ctid == 0 && i + 1 < ndots)
      sm90::mbar_arrive_tx(h_full, (C - 1) * 2 * kTile);
    for (int kt = 0; kt < nk; ++kt) {
      // this half's stage: its slot's barrier of the half completes once
      // every 2 kReqStages stages
      const int st = (i * nk + kt) * 2 + half;
      const int s = st % kReqStages;
      sm90::mbar_wait(&full[half * kReqStages + s],
                      (st / (2 * kReqStages)) & 1);
      const uint8_t* a = sh + kt * kTile + rows * 64 * kSlice;
      const uint8_t* w = sw + s * kTile;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 32; ++kk)
        sm90::wgmma_s8_m64n128k32(acc,
                                  sm90::desc_sw128(a + kk * 32, 16, 1024),
                                  sm90::desc_sw128(w + kk * 32, 16, 1024),
                                  kt | kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(acc);
      if (kt > 0 && lane == 0)  // the half's previous stage has retired
        sm90::mbar_arrive(&empty[(st - 2) % kReqStages]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0)
      sm90::mbar_arrive(&empty[((i * nk + nk - 1) * 2 + half) % kReqStages]);
    if (i + 1 == ndots) break;

    // the rows' max |acc| over this warpgroup's 128 columns, to every
    // CTA's slot of (rank, half): lane q of a quad sends both its rows to
    // rank q
    int mx[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 64; ++e)
      mx[(e >> 1) & 1] = max(mx[(e >> 1) & 1], abs(acc[e]));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = max(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    if ((lane & 3) < C)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sm90::st_async_b32(&amax_in[(rank * 2 + half) * kBM + r_lo + 8 * h],
                           mx[h], amax_full, lane & 3);
    sm90::mbar_wait(amax_full, i & 1);
    if (ctid == 0 && i + 2 < ndots)
      sm90::mbar_arrive_tx(amax_full, amax_bytes);

    float sc[2], y[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = 0;
      for (int r = 0; r < 2 * C; ++r)
        m = max(m, (int)amax_in[r * kBM + r_lo + 8 * h]);
      sc[h] = chain_scale(m);
      y[h] = __frcp_rn(sc[h]);
    }
    // this warpgroup's codes, K slice 2 rank + half of h_{i+1}, at the
    // swizzled positions the next product's descriptors read: a pair of
    // columns a store, a warp's 8 rows on 8 distinct 16-byte chunks. Rows
    // r_lo and r_lo + 8 share their swizzle (row % 8); column 8 j + 2 (lane
    // % 4) lies in chunk j / 2 at byte 8 (j % 2) + 2 (lane % 4)
    uint8_t* rowp = sh + (2 * rank + half) * kTile + r_lo * kSlice +
                    2 * (lane & 3);
    const int swz = (r_lo & 7) << 4;
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int h = (e >> 1) & 1, j = e >> 2;
      const uint32_t pair = code_of(acc[e], sc[h], y[h]) |
                            (code_of(acc[e + 1], sc[h], y[h]) << 8);
      *reinterpret_cast<uint16_t*>(rowp + h * 8 * kSlice +
                                   (((j >> 1) << 4) ^ swz) + 8 * (j & 1)) =
          (uint16_t)pair;
      // blocks of 4 codes: ptxas interleaves no more, and spills nothing
      if (e % 4 == 2) __syncwarp();
    }
    sm90::fence_proxy_async();  // the codes, to the wgmmas and bulk copies
    sm90::bar_sync(1, kReqConsumers);
    if (ctid == 0)  // every peer has sent its maxima: its wgmmas are done
      for (int r = 0; r < C; ++r)
        if (r != (int)rank)
          sm90::bulk_copy_to_peer(sh + 2 * rank * kTile,
                                  sh + 2 * rank * kTile, 2 * kTile, h_full,
                                  r);
  }

  unsigned part = 0;
#pragma unroll
  for (int e = 0; e < 64; ++e) part += (unsigned)acc[e];
  const int gi = blockIdx.y / tiles_m;  // the block; its rows 0-127 first
  if (rank == 0 && half == 0 && blockIdx.y % tiles_m == 0) {
    unsigned* wi = win + (size_t)gi * 8 * 128;
#pragma unroll
    for (int e = 0; e < 64; ++e)  // columns 0-127
      window(wi, acc_row(r_lo, e), acc_col(lane, e), trans, acc[e]);
  }
  add_to_total(part, red, total + gi, ctid, kReqConsumers);
  sm90::cluster_arrive();  // every bulk copy out of this CTA has landed
  sm90::cluster_wait();
}

// out = window + the grid step's total, wrapping for the integer variants.
__global__ void chain_finish(void* win, const void* total, int g, int bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g * 8 * 128) return;
  if (bf16)
    static_cast<float*>(win)[i] += static_cast<const float*>(total)[i >> 10];
  else
    static_cast<unsigned*>(win)[i] +=
        static_cast<const unsigned*>(total)[i >> 10];
}

// Whether the requantized kernel's launch pool holds the registers its
// warpgroups take by setmaxnreg: read from the build once.
bool req_pool_ok() {
  static const bool ok = [] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, requant_kernel) == cudaSuccess &&
           attr.numRegs * kReqThreads >=
               kProducers * kProducerRegs + kReqConsumers * kConsumerRegs;
  }();
  return ok;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int cluster,
                   int smem, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x (g, M, K) int8 or bf16; w (ndots, N, K) of its dtype (the transposed
// storage of the (ndots, K, N) weights); win (g, 8, 128) int32 / float32
// output; total (g,) zeroed scratch of the same type; Kb = K bytes. requant
// 0: the accumulating kernel; requant 1 (int8 only): the requantized chain,
// K == N <= 1024, on clusters of N / 256 CTAs. trans: the window taken as
// acc[:128, :8]^T. M % 128, N % 256 and Kb % 128 == 0. Returns
// cudaError_t (cudaErrorInvalidValue also for a requantized kernel built
// with too few registers at launch for its hand-over).
extern "C" int lhrs_int8_chain(const void* x, const void* w, void* win,
                               void* total, int g, int M, int N, int Kb,
                               int ndots, int requant, int trans, int bf16,
                               void* stream) {
  if (g <= 0 || M <= 0 || M % kBM || N <= 0 || N % kAccN || Kb <= 0 ||
      Kb % kSlice || ndots <= 0 || (long long)ndots * N > (1ll << 30) ||
      (long long)g * M > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  const int tiles = g * (M / kBM), cluster = N / kReqN;
  if (requant) {
    if (bf16 || Kb != N || cluster > kMaxCluster || tiles > 65535 ||
        !req_pool_ok())
      return (int)cudaErrorInvalidValue;
  } else if (N / kAccN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  // TMA boxes of 128 bytes of K by 128 rows of x, and by 128 (requant) or
  // 256 weight rows
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)Kb, (cuuint64_t)g * M};
  const cuuint64_t w_dims[2] = {(cuuint64_t)Kb, (cuuint64_t)ndots * N};
  const cuuint64_t strides[1] = {(cuuint64_t)Kb};
  const cuuint32_t x_box[2] = {kSlice, kBM};
  const cuuint32_t w_box[2] = {kSlice, (cuuint32_t)(requant ? 128 : kAccN)};
  if (!sm90::make_tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, x,
                             x_dims, strides, x_box) ||
      !sm90::make_tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w,
                             w_dims, strides, w_box))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (requant) {
    err = launch(requant_kernel, dim3(cluster, tiles), kReqThreads, cluster,
                 req_smem(Kb / kSlice), st, tm_x, tm_w,
                 static_cast<unsigned*>(win), static_cast<unsigned*>(total),
                 M, N, ndots, trans);
  } else {
    err = launch(bf16 ? accumulate_kernel<true> : accumulate_kernel<false>,
                 dim3(tiles, N / kAccN), kThreads, 1, kAccSmem, st, tm_x,
                 tm_w, win, total, M, N, Kb, ndots, trans);
  }
  if (err != cudaSuccess) return (int)err;
  const int n = g * 8 * 128;
  chain_finish<<<(n + 255) / 256, 256, 0, st>>>(win, total, g, bf16);
  return (int)cudaGetLastError();
}
