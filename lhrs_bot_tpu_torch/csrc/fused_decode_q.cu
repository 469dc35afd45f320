// Fused decode append + single-query attention over a stacked int8 KV cache
// with float32 scale planes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel_q` of `fused_decode_attention_q`
// (lhrs_bot_tpu/ops/fused_decode.py:222, called at :444 / :464) in its
// `int8_dots=False` form. Same semantics: the new token's int8 K/V row of
// (layer, b, h) and its two f32 scales are written in place at row
// lengths[b] of the (L, B, H, S_max, D) cache and its (L, B, H, S_max)
// planes, then the query attends over rows [0, lengths[b]] with an f32
// online softmax. Dequantization folds into the softmax as in the TPU
// kernel: q * sm_scale is rounded to bf16 once (fused_decode.py:332, :338);
// a score is the f32 dot of that with the key's codes (exact in bf16) times
// the key's scale; p * v_scale is rounded to bf16 before the PV product
// (:429) while the denominator sums p without v_scale (:435); the output is
// acc / l.
//
// What bounds it on the H100: device-memory bandwidth. Each (b, h) streams
// 2 * (len + 1) * (D + 4) bytes of codes and scales, far below the card's
// ridge point; int8 halves the bf16 kernel's (fused_decode.cu) cache bytes.
//
// Design: decode_split.cuh, shared with K2 (fused_decode.cu). The rows of
// a (b, h) are split across a cluster of C CTAs (C from
// `ops.fused_decode.decode_split_plan`: all of the grid's CTAs resident at
// once), each streaming its share of codes and scales through a ring of
// bulk copies into shared memory (3 stages of 16 KB of K codes, 16 KB of V
// codes and their scales), and rank 0 merges the CTAs' softmax states
// over distributed shared memory in the same launch. Inside a CTA the walk
// and the arithmetic are the one-CTA kernel's, so C = 1 gives its bits:
// eight lanes a key row, each with D / 8 codes; 32 key groups, each with
// its own running max, sum and accumulator slice. The codes become floats
// by a byte permute and a subtraction (`codes_to_float`), not the
// integer-to-float conversion, whose quarter rate would bound the kernel.
// What bounds it: at B = 1-2 its walk's instructions (half the bytes of K2
// take as long to walk), then a fixed ~5.5 us a launch (PERF.md section
// 6). A row whose length leaves no room (lengths[b] >= S) writes nothing
// and returns NaN, as K2 does.
//
// The int8-dots variant (5b: kernel fused_decode_q_int8dots_kernel, entry
// lhrs_fused_decode_q_int8dots) replaces the same kernel with
// `int8_dots=True` (fused_decode.py:332-336, :374-379, :417-426): q *
// sm_scale is quantized per head to int8 in float32 (absmax / 127 + 1e-12,
// the quotient by __fdiv_rn and rintf); the rows are walked in blocks of
// `block_s` (a runtime argument, part of the result); in each block the
// scores are exact int32 __dp4a dots of the q codes with the key codes
// (8 lanes a row) times q's scale times the key's; the block's max updates
// the running max, p = exp(s - m) and p * v_scale is quantized per head
// over the WHOLE block; P.V is an exact int32 __dp4a sum per column (four
// rows' value bytes transposed into one word per column), scaled by p's
// scale in float32 and added to the accumulator after alpha, as on the
// TPU; the denominator sums the float p, not the codes.
//
// Its design: decode_split.cuh's cluster and bulk-copy ring, with the
// split taken inside each block. A cluster of C CTAs (grid (C, H, B), C
// from `ops.fused_decode.int8dots_split_plan`) walks a head's blocks
// together; rank r takes the r-th part of every block (parts of
// ceil(rows / C) rounded up to 4 rows, so each starts at a multiple of 4
// rows: the P.V quads and 16 bytes of scales). A producer warp streams the
// part's K rows (with both scales) and V rows through 4 stages of 1-D bulk
// copies on mbarriers, so the next rows are in flight while a block's
// reductions run. The ranks exchange, over
// distributed shared memory, (1) their part's score max, (2) their part's
// absmax of p * v_scale and sum of p, (3) their int32 P.V columns, which
// rank 0 sums in rank order into acc. Each exchange is an asynchronous
// store into the peers' shared memory that completes as transaction bytes
// on the receiver's mbarrier (st.async, as a bulk copy completes): no
// release or fence on the sender's side, whose cluster-scope cost was a
// quarter of the kernel's time, and the producer warp never waits on it.
// Each block's exchanges overlap the next block's K pass and this block's
// V pass (the ring streams K rows of block i + 1 before V rows of block
// i), and the barriers and slots alternate by block parity. So the q codes,
// every p code, every block scale and every int32 sum are the unsplit
// kernel's at every C: only the sum of p could change with the order, and
// it is taken in float64 (rounded to float32 once a block), so l is the
// same at every C too. Splitting whole blocks across ranks instead would
// quantize p against another running max: other codes. The rank whose part
// holds row len takes the new row and scales from k_new / v_new into shared
// memory and writes them to the cache after its walk (a bulk copy must not
// read a generic store). With block_s % 4 != 0 or S % 4 != 0 the scales are
// read from device memory instead of copied. Bytes-bound: the cache bytes
// are read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace int8dots {

using decode_split::kBlock;
using decode_split::kGroups;
using decode_split::kLanesPerKey;
using decode_split::kMaxSplits;
using decode_split::kStageBytes;
using decode_split::kThreads;

constexpr int kWarps = kThreads / 32;  // consumer warps
constexpr int kRingStages = 4;         // a block's K and V chunks in flight
constexpr int kMaxBlock = 4096;        // block_s at most
constexpr float kNegInf = -1e30f;
// fault: a planted error for the check that must see it fail
constexpr int kFaultPeerSums = 1;  // rank 0 leaves the last rank's P.V out

struct Args {
  const __nv_bfloat16* q;     // (B, H, 1, D)
  const int8_t* k_new;        // (B, H, 1, D)
  const float* k_new_scale;   // (B, H, 1)
  const int8_t* v_new;
  const float* v_new_scale;
  int8_t* k_cache;            // (L, B, H, S, D)
  int8_t* v_cache;
  float* k_scale;             // (L, B, H, S)
  float* v_scale;
  const int* lengths;         // (B,)
  __nv_bfloat16* out;         // (B, H, 1, D)
  int layer, B, H, S;
  float sm_scale;
  int block_s, fault;
};

// A rank's part of a block: its absmax of p * v_scale and its sum of p.
struct alignas(16) AbsSum {
  float amax, pad;
  double sum;
};

// Shared memory of one CTA, fixed part: the ring (a K stage holds a chunk
// of K rows and both of its scale rows, a V stage V rows), the new K / V
// rows and scales, q's codes, the per-warp partials of the three
// reductions, the slots the ranks write each other (two sets, by block
// parity; x_pv only in rank 0), the ring's barriers and the exchanges'
// (two of each, by block parity).
// Then, sized by a rank's part of a block: its scores (p * v_scale once
// known) and v scales for two blocks, its p codes.
template <int D>
struct Layout {
  static constexpr int R = kStageBytes / D;  // rows a chunk: 128 or 256
  static constexpr int kScaleBytes = R * 4;
  static constexpr int kStage = kStageBytes + 2 * kScaleBytes;
  static constexpr int kNew = kRingStages * kStage;
  static constexpr int kQ = kNew + 2 * D + 16;
  static constexpr int kRedMax = kQ + D;
  static constexpr int kRedSum = kRedMax + kWarps * 4;
  static constexpr int kRedPv = kRedSum + kWarps * 16;
  static constexpr int kXMax = kRedPv + kWarps * D * 4;
  static constexpr int kXSum = kXMax + 2 * kMaxSplits * 4;
  static constexpr int kXPv = kXSum + 2 * kMaxSplits * 16;
  static constexpr int kBars = kXPv + 2 * kMaxSplits * D * 4;
  static constexpr int kFixed =
      (kBars + (2 * kRingStages + 6) * 8 + 15) / 16 * 16;
  static_assert(kRedSum % 16 == 0 && kXSum % 16 == 0, "AbsSum alignment");
  static_assert(kXPv % 16 == 0, "int4 slots");
};

// Rows of a rank's part of a block of block_s rows, at most.
__host__ __device__ __forceinline__ int part_max(int block_s, int splits) {
  return ((block_s + splits - 1) / splits + 3) / 4 * 4;
}

template <int D>
__host__ __device__ __forceinline__ int smem_bytes(int block_s, int splits) {
  return Layout<D>::kFixed + (17 * part_max(block_s, splits) + 15) / 16 * 16;
}

template <int D>
__global__ void __launch_bounds__(kBlock, 2)
    fused_decode_q_int8dots_kernel(const Args a) {
  using L = Layout<D>;
  constexpr int kDims = D / kLanesPerKey;  // code bytes of a row a lane
  constexpr int kWords = kDims / 4;
  constexpr int R = L::R;
  constexpr int kKeys = R / kGroups;        // K rows of a chunk a group
  constexpr int kQuads = R / 4 / kGroups;   // V quads of a chunk a group
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* s_new = smem + L::kNew;  // K row, V row, their scales
  float* s_new_scale = reinterpret_cast<float*>(s_new + 2 * D);
  const uint32_t* q8 = reinterpret_cast<const uint32_t*>(smem + L::kQ);
  float* red_max = reinterpret_cast<float*>(smem + L::kRedMax);
  AbsSum* red_sum = reinterpret_cast<AbsSum*>(smem + L::kRedSum);
  int* red_pv = reinterpret_cast<int*>(smem + L::kRedPv);
  float* x_max = reinterpret_cast<float*>(smem + L::kXMax);
  AbsSum* x_sum = reinterpret_cast<AbsSum*>(smem + L::kXSum);  // 16 B
  int* x_pv = reinterpret_cast<int*>(smem + L::kXPv);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kRingStages;
  uint64_t* bar_max = empty + kRingStages;  // two each, by block parity
  uint64_t* bar_sum = bar_max + 2;
  uint64_t* bar_pv = bar_max + 4;
  const int csize = gridDim.x, rank = blockIdx.x;
  const int pm = part_max(a.block_s, csize);
  float* s_row = reinterpret_cast<float*>(smem + L::kFixed);  // [2][pm]
  float* s_vs = s_row + 2 * pm;                               // [2][pm]
  int8_t* p8 = reinterpret_cast<int8_t*>(s_vs + 2 * pm);      // [pm]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * a.H + h;
  const size_t row = bh * D;  // q / k_new / v_new / out
  const int len = a.lengths[b];
  if (len < 0 || len >= a.S) {  // no room for the append: flag, never write
    if (rank == 0 && tid < D) a.out[row + tid] = __float2bfloat16(nanf(""));
    return;
  }
  const int n_valid = len + 1, bs = a.block_s;
  const int n_blocks = (n_valid + bs - 1) / bs;
  // rows [p0, p0 + pn) of block blk (from its start) are this rank's
  auto part = [&](int blk, int& p0, int& pn) {
    const int rows = min(bs, n_valid - blk * bs);
    const int ps = ((rows + csize - 1) / csize + 3) / 4 * 4;
    p0 = min(rank * ps, rows);
    pn = min(p0 + ps, rows) - p0;
  };
  int last0, last_n;
  part(n_blocks - 1, last0, last_n);
  last0 += (n_blocks - 1) * bs;
  const bool appends = len >= last0 && len < last0 + last_n;
  const size_t plane = ((size_t)a.layer * a.B + b) * a.H + h;
  int8_t* kc = a.k_cache + plane * a.S * D;
  int8_t* vc = a.v_cache + plane * a.S * D;
  float* ksc = a.k_scale + plane * a.S;
  float* vsc = a.v_scale + plane * a.S;
  const bool copy_scales = a.S % 4 == 0 && bs % 4 == 0;

  if (tid == kThreads) {
#pragma unroll
    for (int i = 0; i < kRingStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kWarps);
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) sm90::mbar_init(&bar_max[i], 1);
  }
  if (tid == 0 || tid == kThreads) sm90::mbar_fence_init();
  sm90::cluster_arrive_relaxed();  // started, barriers initialised
  __syncthreads();

  if (tid >= kThreads) {
    // The producer: the chunks of the part's K rows (with both scales) of
    // block 0, then for each block those of block + 1's K rows and of its
    // own V rows, in the consumers' order. Row len is never copied: its
    // rank takes it from k_new / v_new.
    if (tid == kThreads) {
      int t = 0;
      auto stream = [&](int blk, int pass) {
        int p0, pn;
        part(blk, p0, pn);
        const int base = blk * bs + p0;
        for (int c = 0; c * R < pn; ++c, ++t) {
          const int slot = t % kRingStages;
          if (t >= kRingStages)
            sm90::mbar_wait(&empty[slot], ((t / kRingStages) & 1) ^ 1);
          const int r0 = base + c * R, n = min(R, pn - c * R);
          const uint32_t cb = max(0, min(r0 + n, len) - r0) * D;
          const uint32_t sb = pass == 0 && copy_scales ? (n + 3) / 4 * 16 : 0;
          unsigned char* st = ring + slot * L::kStage;
          sm90::mbar_arrive_tx(&full[slot], cb + 2 * sb);
          if (cb)
            sm90::bulk_load_1d(st, (pass ? vc : kc) + (size_t)r0 * D, cb,
                               &full[slot]);
          if (sb) {
            sm90::bulk_load_1d(st + kStageBytes, ksc + r0, sb, &full[slot]);
            sm90::bulk_load_1d(st + kStageBytes + L::kScaleBytes, vsc + r0,
                               sb, &full[slot]);
          }
        }
      };
      stream(0, 0);
      for (int blk = 0; blk < n_blocks; ++blk) {
        if (blk + 1 < n_blocks) stream(blk + 1, 0);
        stream(blk, 1);
      }
    }
    __syncwarp();
    sm90::cluster_wait();
    return;
  }

  const int sub = tid & (kLanesPerKey - 1);  // code slice of this lane
  const int grp = tid / kLanesPerKey;        // row group
  if (appends && tid < D) {
    reinterpret_cast<int8_t*>(s_new)[tid] = a.k_new[row + tid];
    reinterpret_cast<int8_t*>(s_new)[D + tid] = a.v_new[row + tid];
  }
  if (appends && tid == 0) {
    s_new_scale[0] = a.k_new_scale[bh];
    s_new_scale[1] = a.v_new_scale[bh];
  }
  // q * sm_scale to int8 codes, one scale for the head
  const float qf =
      tid < D ? __fmul_rn(__bfloat162float(a.q[row + tid]), a.sm_scale) : 0.f;
  float qa = fabsf(qf);
#pragma unroll
  for (int o = 16; o; o >>= 1)
    qa = fmaxf(qa, __shfl_xor_sync(0xffffffffu, qa, o));
  if (lane == 0) red_max[warp] = qa;
  sm90::bar_sync(1, kThreads);
  qa = red_max[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) qa = fmaxf(qa, red_max[i]);
  const float q_qs = __fadd_rn(__fdiv_rn(qa, 127.f), 1e-12f);
  if (tid < D)
    reinterpret_cast<int8_t*>(smem + L::kQ)[tid] =
        (int8_t)rintf(__fdiv_rn(qf, q_qs));
  sm90::bar_sync(1, kThreads);  // q codes and the new row in place
  int qw[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) qw[i] = (int)q8[sub * kWords + i];
  sm90::cluster_wait();  // every CTA of the cluster has started

  int t = 0;  // the ring's chunk
  // K: each row's exact int32 dot with q's codes (8 lanes a row), times the
  // two scales; the part's scores and v scales of block blk to its buffer,
  // then the part's max into every rank's slot (threads 0..C-1, one a rank)
  auto k_pass = [&](int blk) {
    int p0, pn;
    part(blk, p0, pn);
    const int base = blk * bs + p0;
    float* srow = s_row + (blk & 1) * pm;
    float* svs = s_vs + (blk & 1) * pm;
    float bm = kNegInf;
    for (int c = 0; c * R < pn; ++c, ++t) {
      const int slot = t % kRingStages;
      sm90::mbar_wait(&full[slot], (t / kRingStages) & 1);
      const unsigned char* st = ring + slot * L::kStage;
      const float* st_ks = reinterpret_cast<const float*>(st + kStageBytes);
      const float* st_vs = st_ks + R;
      const int r0 = base + c * R, n = min(R, pn - c * R);
      uint32_t kw[kKeys][kWords];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int jl = u * kGroups + grp;
        decode_split::load_slice<kWords>(
            r0 + jl == len ? s_new : st + jl * D, sub, kw[u]);
      }
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        int dot = 0;
#pragma unroll
        for (int i = 0; i < kWords; ++i)
          dot = __dp4a((int)kw[u][i], qw[i], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        const int jl = u * kGroups + grp, j = r0 + jl;
        if (jl < n) {
          float ks, vs;
          if (j == len) {
            ks = s_new_scale[0];
            vs = s_new_scale[1];
          } else if (copy_scales) {
            ks = st_ks[jl];
            vs = st_vs[jl];
          } else {
            ks = ksc[j];
            vs = vsc[j];
          }
          const float s = __fmul_rn(__fmul_rn(__int2float_rn(dot), q_qs), ks);
          bm = fmaxf(bm, s);
          if (sub == 0) {
            srow[c * R + jl] = s;
            svs[c * R + jl] = vs;
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[slot]);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
    if (lane == 0) red_max[warp] = bm;
    sm90::bar_sync(1, kThreads);  // the scores and the warps' maxima
    const int q = blk & 1;
    if (tid == 0) sm90::mbar_arrive_tx(&bar_max[q], csize * 4);
    if (tid < csize) {
      float v = red_max[0];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) v = fmaxf(v, red_max[i]);
      sm90::st_async_b32(x_max + q * kMaxSplits + rank, __float_as_uint(v),
                         &bar_max[q], tid);
    }
  };

  // rank 0: block blk's int32 P.V columns, every rank's, into acc
  float acc = 0.f;  // column tid (< D), rank 0
  auto take_pv = [&](int blk, float alpha, float p_qs) {
    if (rank == 0 && tid < D) {
      const int q = blk & 1;
      sm90::mbar_wait(&bar_pv[q], (blk >> 1) & 1);
      int tot = 0;
      for (int r = 0; r < csize; ++r)
        if (!(a.fault == kFaultPeerSums && csize > 1 && r == csize - 1))
          tot += x_pv[(q * kMaxSplits + r) * D + tid];
      acc = __fadd_rn(__fmul_rn(acc, alpha),
                      __fmul_rn(__int2float_rn(tot), p_qs));
    }
  };

  // Each block's exchanges overlap the next block's K pass and this
  // block's V pass: the block's max was sent by the previous iteration,
  // its p scale and sum are sent before the next block's K pass, and rank
  // 0 sums its P.V one block later.
  k_pass(0);
  float m = kNegInf, l = 0.f, alpha_prev = 0.f, pqs_prev = 0.f;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int ph = blk & 1;
    int p0, pn;
    part(blk, p0, pn);
    const int base = blk * bs + p0;
    float* srow = s_row + ph * pm;
    const float* svs = s_vs + ph * pm;

    // (1) the block's max, every rank's
    sm90::mbar_wait(&bar_max[ph], (blk >> 1) & 1);
    float bmax = kNegInf;
    for (int r = 0; r < csize; ++r)
      bmax = fmaxf(bmax, x_max[ph * kMaxSplits + r]);
    const float new_m = fmaxf(m, bmax);
    const float alpha = expf(m - new_m);

    // (2) p and p * v_scale of the part; its absmax of p * v_scale and sum
    // of p into every rank's slot
    float pmax = 0.f;
    double psum = 0.0;
    for (int r = tid; r < pn; r += kThreads) {
      const float p = expf(srow[r] - new_m);
      const float ps = __fmul_rn(p, svs[r]);
      psum += (double)p;
      pmax = fmaxf(pmax, fabsf(ps));
      srow[r] = ps;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    }
    if (lane == 0) red_sum[warp] = AbsSum{pmax, 0.f, psum};
    sm90::bar_sync(1, kThreads);
    if (tid == 0) sm90::mbar_arrive_tx(&bar_sum[ph], csize * 16);
    if (tid < csize) {
      float amax = red_sum[0].amax;
      double sum = red_sum[0].sum;
#pragma unroll
      for (int i = 1; i < kWarps; ++i) {
        amax = fmaxf(amax, red_sum[i].amax);
        sum += red_sum[i].sum;
      }
      const unsigned long long bits = __double_as_longlong(sum);
      sm90::st_async_v4(x_sum + ph * kMaxSplits + rank,
                        make_uint4(__float_as_uint(amax), 0u, (uint32_t)bits,
                                   (uint32_t)(bits >> 32)),
                        &bar_sum[ph], tid);
    }

    if (blk + 1 < n_blocks) k_pass(blk + 1);
    if (blk > 0) take_pv(blk - 1, alpha_prev, pqs_prev);

    sm90::mbar_wait(&bar_sum[ph], (blk >> 1) & 1);
    float gmax = 0.f;
    double gsum = 0.0;
    for (int r = 0; r < csize; ++r) {
      gmax = fmaxf(gmax, x_sum[ph * kMaxSplits + r].amax);
      gsum += x_sum[ph * kMaxSplits + r].sum;
    }
    const float p_qs = __fadd_rn(__fdiv_rn(gmax, 127.f), 1e-12f);
    l = __fadd_rn(__fmul_rn(l, alpha), __double2float_rn(gsum));
    for (int r = tid; r < pn; r += kThreads)
      p8[r] = (int8_t)rintf(__fdiv_rn(srow[r], p_qs));
    sm90::bar_sync(1, kThreads);  // the part's p codes are in place

    // (3) V: P.V four rows at a time, each lane's value bytes transposed
    // into one word per column (rows past the part load as 0, so the codes
    // read with them count for nothing)
    int pacc[kDims];
#pragma unroll
    for (int i = 0; i < kDims; ++i) pacc[i] = 0;
    for (int c = 0; c * R < pn; ++c, ++t) {
      const int slot = t % kRingStages;
      sm90::mbar_wait(&full[slot], (t / kRingStages) & 1);
      const unsigned char* st = ring + slot * L::kStage;
      const int r0 = base + c * R, n = min(R, pn - c * R);
#pragma unroll
      for (int qq = 0; qq < kQuads; ++qq) {
        const int ql = (qq * kGroups + grp) * 4;
        if (ql < n) {
          const int pp = *reinterpret_cast<const int*>(p8 + c * R + ql);
          uint32_t v4[4][kWords];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rl = ql + j;
            if (r0 + rl == len) {
              decode_split::load_slice<kWords>(s_new + D, sub, v4[j]);
            } else if (rl < n) {
              decode_split::load_slice<kWords>(st + rl * D, sub, v4[j]);
            } else {
#pragma unroll
              for (int w = 0; w < kWords; ++w) v4[j][w] = 0u;
            }
          }
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            const uint32_t t0 = __byte_perm(v4[0][w], v4[1][w], 0x5140);
            const uint32_t t1 = __byte_perm(v4[2][w], v4[3][w], 0x5140);
            const uint32_t t2 = __byte_perm(v4[0][w], v4[1][w], 0x7362);
            const uint32_t t3 = __byte_perm(v4[2][w], v4[3][w], 0x7362);
            pacc[4 * w + 0] = __dp4a((int)__byte_perm(t0, t1, 0x5410), pp,
                                     pacc[4 * w + 0]);
            pacc[4 * w + 1] = __dp4a((int)__byte_perm(t0, t1, 0x7632), pp,
                                     pacc[4 * w + 1]);
            pacc[4 * w + 2] = __dp4a((int)__byte_perm(t2, t3, 0x5410), pp,
                                     pacc[4 * w + 2]);
            pacc[4 * w + 3] = __dp4a((int)__byte_perm(t2, t3, 0x7632), pp,
                                     pacc[4 * w + 3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[slot]);
    }
    // the part's int32 P.V columns: the warp's 4 groups, the CTA's 8
    // warps, then (warp 0, 4 columns a lane) into rank 0's slot
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      pacc[i] += __shfl_xor_sync(0xffffffffu, pacc[i], 8);
      pacc[i] += __shfl_xor_sync(0xffffffffu, pacc[i], 16);
    }
    if (lane < kLanesPerKey) {
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        red_pv[warp * D + sub * kDims + i] = pacc[i];
    }
    sm90::bar_sync(1, kThreads);
    if (rank == 0 && tid == 0)
      sm90::mbar_arrive_tx(&bar_pv[ph], csize * D * 4);
    if (warp == 0 && lane < D / 4) {
      uint4 tot = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint4 v = reinterpret_cast<const uint4*>(red_pv + w * D)[lane];
        tot.x += v.x, tot.y += v.y, tot.z += v.z, tot.w += v.w;
      }
      sm90::st_async_v4(x_pv + (ph * kMaxSplits + rank) * D + 4 * lane, tot,
                        &bar_pv[ph], 0);
    }
    alpha_prev = alpha;
    pqs_prev = p_qs;
    m = new_m;
  }
  take_pv(n_blocks - 1, alpha_prev, pqs_prev);

  // the appended row and its scales, now that this CTA's copies are done
  if (appends && tid < D) {
    kc[(size_t)len * D + tid] = reinterpret_cast<const int8_t*>(s_new)[tid];
    vc[(size_t)len * D + tid] =
        reinterpret_cast<const int8_t*>(s_new)[D + tid];
  }
  if (appends && tid == 0) {
    ksc[len] = s_new_scale[0];
    vsc[len] = s_new_scale[1];
  }
  if (rank == 0 && tid < D)
    a.out[row + tid] = __float2bfloat16(__fdiv_rn(acc, l));
}

// Launch (or, with max_clusters, ask how many clusters of `splits` CTAs
// can be resident at once). Returns cudaError_t.
template <int D>
int launch(const Args& a, int splits, cudaStream_t st, int* max_clusters) {
  auto* kernel = fused_decode_q_int8dots_kernel<D>;
  static bool sized = false;  // one opt-in a kernel, for the largest block
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<D>(kMaxBlock, 1));
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.H, a.B);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem_bytes<D>(a.block_s, splits);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters,
                                               (const void*)kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int dispatch(const Args& a, int L, int D, int splits, void* stream,
             int* max_clusters) {
  if (a.layer < 0 || a.layer >= L || a.B <= 0 || a.B > 65535 || a.H <= 0 ||
      a.H > 65535 || a.S <= 0 || a.block_s <= 0 || a.block_s > a.S ||
      a.block_s > kMaxBlock ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(a, splits, st, max_clusters);
  if (D == 128) return launch<128>(a, splits, st, max_clusters);
  return (int)cudaErrorInvalidValue;
}

}  // namespace int8dots

// q/out (B,H,1,D) bf16; k_new/v_new (B,H,1,D) int8; k_new_scale/v_new_scale
// (B,H,1) f32; caches (L,B,H,S,D) int8; scale planes (L,B,H,S) f32; lengths
// (B,) int32 on the device. All contiguous, 16-byte aligned. splits: the
// cluster's CTAs (1, 2, 4 or 8). fault: 0, or a planted error for a check.
// Returns cudaError_t.
extern "C" int lhrs_fused_decode_q(const void* q, const void* k_new,
                                   const void* k_new_scale, const void* v_new,
                                   const void* v_new_scale, void* k_cache,
                                   void* v_cache, void* k_scale,
                                   void* v_scale, const void* lengths,
                                   void* out, int layer, int L, int B, int H,
                                   int S, int D, float sm_scale, int splits,
                                   int fault, void* stream) {
  decode_split::Args a{static_cast<const __nv_bfloat16*>(q),
                       k_new,
                       v_new,
                       static_cast<const float*>(k_new_scale),
                       static_cast<const float*>(v_new_scale),
                       k_cache,
                       v_cache,
                       static_cast<float*>(k_scale),
                       static_cast<float*>(v_scale),
                       static_cast<const int*>(lengths),
                       static_cast<__nv_bfloat16*>(out),
                       layer,
                       B,
                       H,
                       S,
                       sm_scale,
                       fault};
  return decode_split::dispatch<decode_split::Int8Rows>(a, L, D, splits,
                                                        stream, nullptr);
}

// How many clusters of `splits` CTAs of the D = 64 or 128 kernel can be
// resident on the device at once, into *count. Returns cudaError_t.
extern "C" int lhrs_fused_decode_q_max_clusters(int D, int splits,
                                                int* count) {
  decode_split::Args a{};
  a.B = a.H = a.S = 1;
  return decode_split::dispatch<decode_split::Int8Rows>(a, 1, D, splits,
                                                        nullptr, count);
}

// The int8-dots variant (5b): the same arguments but splits and fault,
// then block_s (1..min(S, 4096)), splits (1, 2, 4 or 8), fault (0, or a
// planted error for a check). Returns cudaError_t.
extern "C" int lhrs_fused_decode_q_int8dots(
    const void* q, const void* k_new, const void* k_new_scale,
    const void* v_new, const void* v_new_scale, void* k_cache, void* v_cache,
    void* k_scale, void* v_scale, const void* lengths, void* out, int layer,
    int L, int B, int H, int S, int D, float sm_scale, int block_s,
    int splits, int fault, void* stream) {
  int8dots::Args a{static_cast<const __nv_bfloat16*>(q),
                   static_cast<const int8_t*>(k_new),
                   static_cast<const float*>(k_new_scale),
                   static_cast<const int8_t*>(v_new),
                   static_cast<const float*>(v_new_scale),
                   static_cast<int8_t*>(k_cache),
                   static_cast<int8_t*>(v_cache),
                   static_cast<float*>(k_scale),
                   static_cast<float*>(v_scale),
                   static_cast<const int*>(lengths),
                   static_cast<__nv_bfloat16*>(out),
                   layer,
                   B,
                   H,
                   S,
                   sm_scale,
                   block_s,
                   fault};
  return int8dots::dispatch(a, L, D, splits, stream, nullptr);
}

// How many clusters of `splits` CTAs of the D = 64 or 128 int8-dots kernel
// with blocks of block_s rows can be resident on the device at once, into
// *count. Returns cudaError_t.
extern "C" int lhrs_fused_decode_q_int8dots_max_clusters(int D, int block_s,
                                                         int splits,
                                                         int* count) {
  int8dots::Args a{};
  a.B = a.H = 1;
  a.S = a.block_s = block_s;
  return int8dots::dispatch(a, 1, D, splits, nullptr, count);
}
