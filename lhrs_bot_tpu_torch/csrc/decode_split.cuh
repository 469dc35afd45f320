// Split decode attention for Hopper (sm_90a): the design that the
// contiguous-cache decode kernels share, K2 (fused_decode.cu, bf16 cache)
// and K4 (fused_decode_q.cu, int8 cache with float32 scale planes, bf16
// dots), and the paged int8 kernel (paged_decode_q.cu, the same rows held
// in the pages of a pool). One launch appends the new token's K/V row (and
// scales) of (layer, b, h) at row lengths[b] and attends the query over
// rows [0, lengths[b]] with an f32 online softmax.
//
// What bounds it on the H100: device-memory bandwidth. A head streams
// 2 * (len + 1) * D * elt bytes (+ 8 a row of scales for int8) for
// 4 * (len + 1) * D flops, far below the ridge point. Two things kept the
// one-CTA-per-(b, h) kernels from that bound: 32-64 CTAs at B = 1-2 on a
// 132-SM card, and loads issued and then consumed in lockstep. So:
//
// 1. The rows of a (b, h) are split across a thread-block cluster of C CTAs
//    (grid (C, H, B), cluster (C, 1, 1), C in {1, 2, 4, 8}, picked in
//    Python by `ops.fused_decode.decode_split_plan` so that the grid's CTAs
//    are all resident at once). Each CTA reads lengths[b] and takes its
//    share of rows [0, len] on the device: whole blocks of kShareRows
//    (128), the same count for every rank, so a head's shares are balanced
//    whatever its length; trailing ranks may be empty and still take part
//    in the cluster's barriers.
// 2. A producer warp streams the share's K and V rows (and, int8, the scale
//    planes) into a ring of kStages stages of shared memory with 1-D bulk
//    copies completing on mbarriers; 256 consumer threads walk each stage
//    while the next ones are in flight, then release it.
// 3. Inside a CTA the walk and the arithmetic are the one-CTA kernels'
//    (and the paged kernels', paged_decode.cu): 8 lanes a key, each lane
//    D / 8 dims; key j goes to group j % 32 (a share starts at a multiple
//    of 128), each group walks its keys in increasing order; q * sm_scale
//    is rounded to bf16 once; bf16: p rounded to bf16 before PV; int8: the
//    score is dot(q_bf16, codes) * k_scale, bf16(p * v_scale) goes into PV
//    and the denominator sums p. Each CTA folds its 32 group states in the
//    one-CTA kernels' order into one (max, sum, acc[D]) and writes it into
//    its slot of rank 0's shared memory (distributed shared memory); after
//    one cluster barrier rank 0 folds the C slots in rank order and writes
//    bf16(acc / l), while the other CTAs leave: no CTA's shared memory is
//    read after it exits. Each CTA arrives (relaxed) at a first barrier on
//    entry and waits on it before writing to rank 0, so rank 0 has started.
//    With C = 1 the fold of one state is exact (a factor exp(0) = 1), so
//    the kernel gives the one-CTA kernel's bits. No scratch in device
//    memory, no atomics, no second kernel.
// 4. No bulk copy covers row len. The CTA whose share holds it takes the
//    new row (and scales) from k_new / v_new into shared memory for its
//    walk and writes it to the cache after the walk: the cluster's other
//    CTAs are not ordered after a write, and a generic store read back by
//    a bulk copy would need a proxy fence. A row with len < 0 or len >= S
//    writes nothing and gives NaN; every CTA of the cluster reads the same
//    lengths[b], so all of them leave before the first barrier.
//
// 5. Where the rows come from is a policy of the producer (`Contiguous`,
//    `Paged`); the consumers see a stage of rows either way. A paged row j
//    is offset j % page of page table[b, j / page] of the (L, N, H, page,
//    D) pool. Before its first copy each CTA stages its share's page ids in
//    shared memory and checks EVERY valid page id of the row (the first
//    ceil((len + 1) / page) entries) against [0, N): all ranks of a cluster
//    see the same ids, so they all leave before the first cluster barrier
//    when one is bad (NaN out, nothing written), and none waits for a rank
//    that left. A stage that spans several pages takes one bulk copy a
//    page piece, all on the stage's barrier; pages are multiples of 16
//    rows and stages start at multiples of 128, so every piece (and its
//    scales) starts 16-byte aligned, and only the piece that ends at row
//    len pads its scales, inside its own page. No page past the last
//    valid one is read.
//
// Alignment: K/V rows are D * elt bytes (64-256), so every row starts 16-
// byte aligned and a stage of rows moves a multiple of 16 bytes. A scale
// stage (4 bytes a row) starts at a multiple of 4 rows and is padded to 16
// bytes; when S % 4 == 0 the planes are 16-byte aligned and the padding
// stays inside the plane (at most up to row len, which only this CTA
// writes, after its walk). For S % 4 != 0 the consumers read the scales
// from device memory instead (a slower path no caller of the engine takes).
//
// Bounds on the design (H100, PERF.md section 6): a ring of 3 stages of
// 16 KB of K rows and 16 KB of V rows (103-106 KB a CTA with the folds and
// the new rows) and 288 threads at 95-96 registers leave room for 2 CTAs
// an SM, so B * H * C up to 264 runs in one wave. A GPC holds fewer
// clusters of 4 or 8 than its SMs would allow (62 and 30 resident, not 66
// and 33), so the plan takes C = 2 at B * H = 32-128 (the sweep's best).
// There the bf16 kernel streams at the memory's rate after a fixed ~5 us a
// launch; the int8 one by its walk's instructions (half the bytes take as
// long as the bf16 kernel's: the code conversions and the 8 lanes'
// redundant softmax are the parent's arithmetic, kept for C = 1's bits).
// Shared memory reads
// of the bf16 D = 128 rows (32 bytes a lane) are split so that a row's 8
// lanes touch each bank once.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace decode_split {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;          // consumers: 32 key groups of 8 lanes
constexpr int kBlock = kThreads + 32;  // and one producer warp
constexpr int kLanesPerKey = 8;
constexpr int kGroups = kThreads / kLanesPerKey;
constexpr int kShareRows = 128;  // shares start at multiples of this
constexpr int kMaxSplits = 8;
constexpr int kStages = 3;
constexpr int kStageBytes = 16384;  // of K rows in a stage, and of V rows
constexpr float kNegInf = -1e30f;
// fault: a planted error for the check that must see it fail
constexpr int kFaultPeerState = 1;  // rank 0 leaves the last rank out

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The 4 int8 codes of a word as exact floats, without the quarter-rate
// integer-to-float conversion: each code, offset by 128, goes into the low
// mantissa byte of 2^23 (one byte permute), and one subtraction removes
// 2^23 + 128.
__device__ __forceinline__ void codes_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;  // signed code c -> byte c + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.0f;
}

// K2's rows: bf16, no scales.
struct Bf16Rows {
  using Elem = __nv_bfloat16;
  static constexpr int kElt = 2;
  static constexpr bool kScales = false;
};

// K4's rows: int8 codes with a float32 scale a row.
struct Int8Rows {
  using Elem = int8_t;
  static constexpr int kElt = 1;
  static constexpr bool kScales = true;
};

constexpr int kMaxPages = 2048;  // page-table entries of one row

struct Args {
  const __nv_bfloat16* q;       // (B, H, 1, D)
  const void* k_new;            // (B, H, 1, D)
  const void* v_new;
  const float* k_new_scale;     // (B, H, 1), int8 only
  const float* v_new_scale;
  void* k_cache;                // (L, B, H, S, D), or the pool
  void* v_cache;
  float* k_scale;               // (L, B, H, S), int8 only; or scale pages
  float* v_scale;
  const int* lengths;           // (B,)
  __nv_bfloat16* out;           // (B, H, 1, D)
  int layer, B, H, S;           // paged: S = P * page
  float sm_scale;
  int fault;
};

// The paged kernel's arguments: Args with the pools in k_cache .. v_scale
// (and S = P * page), then the page table and its sizes.
struct PagedArgs : Args {
  const int* table;             // (B, P) page ids
  int N, page, P;               // pool pages, rows a page, table entries
};

// Rows of a contiguous (L, B, H, S, D) cache with (L, B, H, S) planes.
// (Its kernel takes the plain Args: the contiguous kernels' parameters,
// and so their code, are what they were before the paged source.)
struct Contiguous {
  static constexpr bool kPaged = false;
  using A = Args;
};

// Rows in the pages of an (L, N, H, page, D) pool with (L, N, H, page)
// scale pages, named by the (B, P) page table.
struct Paged {
  static constexpr bool kPaged = true;
  using A = PagedArgs;
};

// Shared memory of one CTA: the ring (its first bytes hold the 32 group
// states once the walk is done), the ranks' folded states (rank 0's are
// read), the new K and V rows, a row of zeros and the new scales, the
// ring's barriers, and (paged) the share's page ids.
template <class P, int D, class Src = Contiguous>
struct Layout {
  static constexpr int kRowBytes = D * P::kElt;
  static constexpr int kStageRows = kStageBytes / kRowBytes;  // 64-256
  static constexpr int kScaleBytes = P::kScales ? kStageRows * 4 : 0;
  static constexpr int kStage = 2 * kStageBytes + 2 * kScaleBytes;
  static constexpr int kRing = kStages * kStage;
  // each rank's folded state, in rank 0: acc[D], max, sum, padding
  static constexpr int kFold = kMaxSplits * (D + 4) * 4;
  static constexpr int kNew = 3 * kRowBytes + 16;  // new K, V; zeros
  static constexpr int kPageIds = Src::kPaged ? kMaxPages * 4 : 0;
  static constexpr int kSmem = kRing + kFold + kNew + 2 * kStages * 8 +
                               kPageIds;
  static_assert(kGroups * (D + 2) * 4 <= kRing, "states must fit the ring");
  static_assert(kStageRows % kGroups == 0 && kStageRows % 4 == 0, "stage");
};

// One lane's D / 8 elements of a row in shared memory, as 32-bit words.
// Lanes 4-7 of a 256-byte row load their two 16-byte words in the other
// order, so the 8 lanes of a row touch each of the 32 banks once per load.
template <int kWords>
__device__ __forceinline__ void load_slice(const unsigned char* row, int sub,
                                           uint32_t (&w)[kWords]) {
  const unsigned char* p = row + sub * kWords * 4;
  if constexpr (kWords == 8) {
    const int first = (sub >> 2) & 1;
    const uint4 a = reinterpret_cast<const uint4*>(p)[first];
    const uint4 b = reinterpret_cast<const uint4*>(p)[first ^ 1];
    const uint4 lo = first ? b : a, hi = first ? a : b;
    w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
    w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
  } else if constexpr (kWords == 4) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  } else {
    static_assert(kWords == 2, "a lane holds 8, 16 or 32 bytes of a row");
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x, w[1] = a.y;
  }
}

// A lane's slice as floats: bf16 values, or int8 codes.
template <class P, int kWords>
__device__ __forceinline__ void slice_to_float(const uint32_t (&w)[kWords],
                                               float* f) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (P::kScales) {
      codes_to_float(w[i], f + 4 * i);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// Paged: the pool row of position j of head h's row, offset j % page of
// its page, which s_pages holds at j / page - page0.
__device__ __forceinline__ size_t page_row(const PagedArgs& a,
                                           const int* s_pages, int page0,
                                           int h, int j) {
  const int pj = j / a.page;
  return (((size_t)a.layer * a.N + s_pages[pj - page0]) * a.H + h) * a.page +
         (j - pj * a.page);
}

template <class P, class Src, int D>
__global__ void __launch_bounds__(kBlock, 2)
    split_decode_kernel(const typename Src::A a) {
  using L = Layout<P, D, Src>;
  using Elem = typename P::Elem;
  constexpr int kDims = D / kLanesPerKey;          // elements a lane
  constexpr int kWords = kDims * P::kElt / 4;      // 32-bit words a lane
  constexpr int R = L::kStageRows;
  constexpr int kKeys = R / kGroups;               // keys a group a stage
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* fold = reinterpret_cast<float*>(smem + L::kRing);
  unsigned char* s_new = smem + L::kRing + L::kFold;
  const unsigned char* s_zero = s_new + 2 * L::kRowBytes;
  float* s_new_scale = reinterpret_cast<float*>(s_new + 3 * L::kRowBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_new + L::kNew);
  uint64_t* empty = full + kStages;
  int* s_pages = reinterpret_cast<int*>(empty + kStages);  // paged only

  const int rank = blockIdx.x, csize = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * a.H + h;
  const size_t row = bh * D;  // q / k_new / v_new / out
  const int sub = tid & (kLanesPerKey - 1);  // dim slice of this lane
  const int grp = tid / kLanesPerKey;        // key group
  float qv[kDims];                           // q * sm_scale, bf16-rounded
  if (tid < kThreads) {
    const uint4* qp = reinterpret_cast<const uint4*>(a.q + row + sub * kDims);
#pragma unroll
    for (int i = 0; i < kDims / 8; ++i) {
      const uint4 w = qp[i];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qv[i * 8 + j] = bf16_round(__bfloat162float(e[j]) * a.sm_scale);
    }
  }
  const int len = a.lengths[b];
  if (len < 0 || len >= a.S) {  // no room for the append: flag, never write
    if (rank == 0 && tid < D) a.out[row + tid] = __float2bfloat16(nanf(""));
    return;
  }
  if constexpr (!Src::kPaged) sm90::cluster_arrive_relaxed();  // started
  const int n_valid = len + 1;
  const int share =
      ((n_valid + kShareRows - 1) / kShareRows + csize - 1) / csize *
      kShareRows;
  const int s0 = min(rank * share, n_valid);
  const int s1 = min(s0 + share, n_valid);
  // paged: the share's page ids into shared memory, every valid id of the
  // row checked by every rank (the same decision in all of them)
  int page0 = 0;  // the share's first page
  if constexpr (Src::kPaged) {
    page0 = s0 / a.page;
    const int np_valid = (len + a.page) / a.page;
    const int np_share = s1 > s0 ? (s1 - 1) / a.page - page0 + 1 : 0;
    bool bad = false;
    for (int i = tid; i < np_valid; i += kBlock) {
      const int pg = a.table[(size_t)b * a.P + i];
      bad = bad || pg < 0 || pg >= a.N;
      if (i >= page0 && i - page0 < np_share) s_pages[i - page0] = pg;
    }
    if (__syncthreads_or(bad)) {  // a page outside the pool: never write
      if (rank == 0 && tid < D) a.out[row + tid] = __float2bfloat16(nanf(""));
      return;
    }
    sm90::cluster_arrive_relaxed();  // this CTA has started
  }
  const bool appends = len >= s0 && len < s1;  // row len is in this share
  const int copy_end = min(s1, len);           // rows from the cache
  const int n_stages = (s1 - s0 + R - 1) / R;
  // contiguous: the (layer, b, h) plane; paged: the pools, whose rows
  // `page_row` names
  const size_t plane =
      Src::kPaged ? 0 : ((size_t)a.layer * a.B + b) * a.H + h;
  Elem* kc = static_cast<Elem*>(a.k_cache) + plane * a.S * D;
  Elem* vc = static_cast<Elem*>(a.v_cache) + plane * a.S * D;
  float* ksc = P::kScales ? a.k_scale + plane * a.S : nullptr;
  float* vsc = P::kScales ? a.v_scale + plane * a.S : nullptr;
  const bool copy_scales = P::kScales && (Src::kPaged || a.S % 4 == 0);
  const Elem* kn = static_cast<const Elem*>(a.k_new) + row;
  const Elem* vn = static_cast<const Elem*>(a.v_new) + row;

  // The producer: one elected lane inits the ring's barriers and keeps the
  // ring full, the first stages before the CTA's first barrier.
  auto produce = [&](int t) {
    const int slot = t % kStages;
    if (t >= kStages)  // the consumers have released the slot's last use
      sm90::mbar_wait(&empty[slot], ((t / kStages) & 1) ^ 1);
    const int r0 = s0 + t * R;
    const int n = max(0, min(r0 + R, copy_end) - r0);
    const uint32_t kv_bytes = n * L::kRowBytes;
    const uint32_t sc_bytes = copy_scales ? (n + 3) / 4 * 16 : 0;
    unsigned char* st = ring + slot * L::kStage;
    sm90::mbar_arrive_tx(&full[slot], 2 * (kv_bytes + sc_bytes));
    if constexpr (Src::kPaged) {
      // one copy a page piece; every piece but the one ending at row len
      // is whole 16-row groups, so the bytes sum to the announced ones
      for (int r = r0; r < r0 + n;) {
        const int e = min(r0 + n, (r / a.page + 1) * a.page);
        const size_t pr = page_row(a, s_pages, page0, h, r);
        const uint32_t rb = (e - r) * L::kRowBytes;
        unsigned char* dst = st + (r - r0) * L::kRowBytes;
        sm90::bulk_load_1d(dst, kc + pr * D, rb, &full[slot]);
        sm90::bulk_load_1d(dst + kStageBytes, vc + pr * D, rb, &full[slot]);
        if (sc_bytes) {
          const uint32_t sb = (e - r + 3) / 4 * 16;
          unsigned char* sdst = st + 2 * kStageBytes + (r - r0) * 4;
          sm90::bulk_load_1d(sdst, ksc + pr, sb, &full[slot]);
          sm90::bulk_load_1d(sdst + L::kScaleBytes, vsc + pr, sb,
                             &full[slot]);
        }
        r = e;
      }
    } else if (n > 0) {
      sm90::bulk_load_1d(st, kc + (size_t)r0 * D, kv_bytes, &full[slot]);
      sm90::bulk_load_1d(st + kStageBytes, vc + (size_t)r0 * D, kv_bytes,
                         &full[slot]);
      if (sc_bytes) {
        sm90::bulk_load_1d(st + 2 * kStageBytes, ksc + r0, sc_bytes,
                           &full[slot]);
        sm90::bulk_load_1d(st + 2 * kStageBytes + L::kScaleBytes, vsc + r0,
                           sc_bytes, &full[slot]);
      }
    }
  };
  if (tid == kThreads) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], kThreads / 32);
    }
    sm90::mbar_fence_init();
    for (int t = 0; t < min(n_stages, kStages); ++t) produce(t);
  }
  if (appends && tid < D) {
    reinterpret_cast<Elem*>(s_new)[tid] = kn[tid];
    reinterpret_cast<Elem*>(s_new + L::kRowBytes)[tid] = vn[tid];
  }
  if (P::kScales && appends && tid == 0) {
    s_new_scale[0] = a.k_new_scale[bh];
    s_new_scale[1] = a.v_new_scale[bh];
  }
  if (tid < L::kRowBytes / 4)
    reinterpret_cast<uint32_t*>(s_new + 2 * L::kRowBytes)[tid] = 0u;
  __syncthreads();

  float m = kNegInf, l = 0.f, acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  // A stage's scores: each key's dot, then the 8-lane reductions, so that
  // the keys' independent chains overlap; the int8 rows' scales go to ks,
  // vs. Rows past the share's end score garbage, which is not used.
  auto score = [&](int t, float(&s)[kKeys], float(&ks)[kKeys],
                   float(&vs)[kKeys]) {
    const unsigned char* st = ring + (t % kStages) * L::kStage;
    const float* st_ks = reinterpret_cast<const float*>(st + 2 * kStageBytes);
    const float* st_vs = st_ks + L::kStageRows;
    const int r0 = s0 + t * R;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int jl = u * kGroups + grp, j = r0 + jl;
      uint32_t kw[kWords];
      load_slice<kWords>(j == len ? s_new : st + jl * L::kRowBytes, sub, kw);
      if constexpr (P::kScales) {
        if (j == len) {
          ks[u] = s_new_scale[0];
          vs[u] = s_new_scale[1];
        } else if (copy_scales) {
          ks[u] = st_ks[jl];
          vs[u] = st_vs[jl];
        } else {
          ks[u] = j < s1 ? ksc[j] : 0.f;
          vs[u] = j < s1 ? vsc[j] : 0.f;
        }
      }
      float kf[kDims];
      slice_to_float<P>(kw, kf);
      s[u] = 0.f;
#pragma unroll
      for (int x = 0; x < kDims; ++x) s[u] += qv[x] * kf[x];
    }
#pragma unroll
    for (int o = 1; o < kLanesPerKey; o <<= 1)
#pragma unroll
      for (int u = 0; u < kKeys; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
  };
  // A stage's online softmax, key after key, without branches: a key past
  // the share's end scores -inf against a zero row, so it leaves m, l and
  // acc as they were (alpha = 1, p = 0).
  auto update = [&](int t, const float(&s)[kKeys], const float(&ks)[kKeys],
                    const float(&vs)[kKeys]) {
    const unsigned char* st = ring + (t % kStages) * L::kStage;
    const int r0 = s0 + t * R;
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const int jl = u * kGroups + grp, j = r0 + jl;
      const bool valid = j < s1;
      uint32_t vw[kWords];
      load_slice<kWords>(j == len ? s_new + L::kRowBytes
                         : valid ? st + kStageBytes + jl * L::kRowBytes
                                 : s_zero,
                         sub, vw);
      float su = s[u], vsu = 0.f;
      if constexpr (P::kScales) {
        su *= ks[u];
        vsu = valid ? vs[u] : 0.f;
      }
      su = valid ? su : -INFINITY;
      const float m_new = fmaxf(m, su);
      const float alpha = __expf(m - m_new);
      const float p = __expf(su - m_new);
      const float pw = P::kScales ? bf16_round(p * vsu) : bf16_round(p);
      l = l * alpha + p;
      float vf[kDims];
      slice_to_float<P>(vw, vf);
#pragma unroll
      for (int x = 0; x < kDims; ++x) acc[x] = acc[x] * alpha + pw * vf[x];
      m = m_new;
    }
  };

  if (tid >= kThreads) {
    if (tid == kThreads)
      for (int t = kStages; t < n_stages; ++t) produce(t);
  } else {
    for (int t = 0; t < n_stages; ++t) {
      sm90::mbar_wait(&full[t % kStages], (t / kStages) & 1);
      float s[kKeys], ks[kKeys], vs[kKeys];
      score(t, s, ks, vs);
      update(t, s, ks, vs);
      __syncwarp();
      if ((tid & 31) == 0) sm90::mbar_arrive(&empty[t % kStages]);
    }
  }
  __syncthreads();  // the ring is read: it holds the group states now

  float* st_m = reinterpret_cast<float*>(ring);
  float* st_l = st_m + kGroups;
  float* st_acc = st_l + kGroups;  // [kGroups][D]
  if (tid < kThreads) {
    if (sub == 0) {
      st_m[grp] = m;
      st_l[grp] = l;
    }
#pragma unroll
    for (int i = 0; i < kDims; ++i) st_acc[grp * D + sub * kDims + i] = acc[i];
  }
  // the appended row and its scales, now that this CTA's walk is done
  if constexpr (Src::kPaged) {
    if (appends) {
      const size_t at = page_row(a, s_pages, page0, h, len);
      if (tid < D) {
        kc[at * D + tid] = kn[tid];
        vc[at * D + tid] = vn[tid];
      }
      if (tid == 0) {
        ksc[at] = a.k_new_scale[bh];
        vsc[at] = a.v_new_scale[bh];
      }
    }
  } else {
    if (appends && tid < D) {
      kc[(size_t)len * D + tid] = kn[tid];
      vc[(size_t)len * D + tid] = vn[tid];
    }
    if (P::kScales && appends && tid == 0) {
      ksc[len] = a.k_new_scale[bh];
      vsc[len] = a.v_new_scale[bh];
    }
  }
  __syncthreads();
  // Fold the 32 group states in the one-CTA kernels' order, into this
  // rank's slot of rank 0's shared memory (every rank has started: the
  // wait ends the barrier each CTA arrived at on entry).
  sm90::cluster_wait();
  if (tid < D) {
    float mx = kNegInf;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) mx = fmaxf(mx, st_m[gi]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      const float sc = __expf(st_m[gi] - mx);  // 0 for groups with no key
      den += st_l[gi] * sc;
      num += st_acc[gi * D + tid] * sc;
    }
    float* slot = cg::this_cluster().map_shared_rank(fold, 0) +
                  rank * (D + 4);
    slot[tid] = num;
    if (tid == 0) {
      slot[D] = mx;
      slot[D + 1] = den;
    }
  }
  // Every rank's fold is in rank 0's shared memory; the others may leave.
  sm90::cluster_arrive();
  sm90::cluster_wait();
  if (rank == 0 && tid < D) {
    float pm[kMaxSplits], pl[kMaxSplits], pn[kMaxSplits];
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      pm[p] = kNegInf;
      pl[p] = pn[p] = 0.f;
      if (p < csize && !(a.fault == kFaultPeerState && csize > 1 &&
                         p == csize - 1)) {
        const float* f = fold + p * (D + 4);
        pm[p] = f[D];
        pl[p] = f[D + 1];
        pn[p] = f[tid];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) mx = fmaxf(mx, pm[p]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      const float sc = __expf(pm[p] - mx);  // 1 for the largest, 0 if empty
      den += pl[p] * sc;
      num += pn[p] * sc;
    }
    a.out[row + tid] = __float2bfloat16(num / den);
  }
}

// Launch (or, with max_clusters, ask how many clusters of `splits` CTAs can
// be resident at once: cudaOccupancyMaxActiveClusters). Returns cudaError_t.
template <class P, class Src, int D>
int launch(const typename Src::A& a, int splits, cudaStream_t st,
           int* max_clusters) {
  auto* kernel = split_decode_kernel<P, Src, D>;
  constexpr int kSmem = Layout<P, D, Src>::kSmem;
  static bool sized = false;  // one opt-in a kernel
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.H, a.B);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = kSmem;
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

// Checks the shape and the cluster size, then launches the D = 64 or 128
// kernel on `stream` (or answers the occupancy query).
template <class P, class Src = Contiguous>
int dispatch(const typename Src::A& a, int L, int D, int splits,
             void* stream, int* max_clusters) {
  if (a.layer < 0 || a.layer >= L || a.B <= 0 || a.B > 65535 || a.H <= 0 ||
      a.H > 65535 || a.S <= 0 ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8))
    return (int)cudaErrorInvalidValue;
  if constexpr (Src::kPaged) {
    if (a.N <= 0 || a.page < 16 || a.page > 256 || a.page % 16 ||
        a.P <= 0 || a.P > kMaxPages || a.S != a.P * a.page)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<P, Src, 64>(a, splits, st, max_clusters);
  if (D == 128) return launch<P, Src, 128>(a, splits, st, max_clusters);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode_split
