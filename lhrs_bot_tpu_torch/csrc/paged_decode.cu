// Paged decode append + single-query attention over a shared KV page pool,
// for Hopper (sm_90a): a bf16 pool and an int8 pool with float32 scale
// pages, from one template.
//
// Replaces the Pallas TPU kernels `_kernel_p` of `paged_fused_decode`
// (lhrs_bot_tpu/ops/paged_fused.py:213, called at :496) and `_kernel_pq` of
// `paged_fused_decode_q` (:52, called at :412). Same semantics: pools are
// (L, N_pages, H, page, D), page 0 the null page; for each row b of layer
// `layer`, the new token's K/V row (and, int8, its two scales) is written in
// place at position lengths[b], i.e. page table[b, lengths[b] / page],
// offset lengths[b] % page; then the query attends over the lengths[b] + 1
// positions of the row, walking its pages through the table, with an f32
// online softmax. Columns at or past lengths[b] + 1 are masked, and no page
// past ceil((lengths[b] + 1) / page) is read. Roundings are the TPU
// kernels': q * sm_scale in f32, rounded to bf16 (:130, :268); bf16 pool:
// p rounded to bf16 before the PV product (:315); int8 pool: scores times
// the key's scale in f32 (:174), p * v_scale rounded to bf16 (:198); the
// denominator sums p unrounded; the output is acc / l in f32, then bf16.
//
// What bounds it on the H100: device-memory bandwidth. Each (b, h) streams
// the K and V rows (and, int8, the scales) of its lengths[b] + 1 valid
// positions once: 2 * (len + 1) * D * 2 bytes (bf16) or 2 * (len + 1) *
// (D + 4) bytes (int8), for 4 * (len + 1) * D flops. The bound of a call is
// those bytes over all (b, h) over 3.35 TB/s.
//
// Design: the contiguous kernels' (fused_decode.cu, fused_decode_q.cu), with
// the row's page ids staged in shared memory. One CTA of 256 threads per
// (b, h). The CTA first reads the page ids of its valid pages from the
// table, each once (there is no scalar prefetch on this card), and checks
// them; then it appends the new row into its page and synchronises, so it
// reads the row it wrote like any other. The TPU kernel's race patch
// (paged_fused.py:155-163: its append write-back could race its page DMA)
// has no counterpart: nothing else writes that row, since the rows of
// different heads never overlap and a row's append page is its own. Eight
// lanes share one key row (16-byte loads, or 8-byte for int8 at D = 64); 32
// key groups keep 4 keys of K and V in flight, each with its own running
// max, sum and accumulator slice, merged through shared memory at the end.
// Key j's row is page s_pages[j / page], offset j % page, so any page size
// that is a multiple of 16 (up to 256) works, the CPU tests' page of 16
// included; the TPU's sublane windows, DMA ring and page >= 128 floor are
// layout and do not carry over. What limits it: one CTA per (b, h) is
// latency-bound at small B, as fused_decode.cu is (256 CTAs at B = 8, H =
// 32, on 132 SMs); splitting the sequence across CTAs is later work.
//
// Ghost rows: an idle slot's table row is all null pages, so its append
// lands in page 0, and several idle rows may write page 0 at once. That
// race is benign: page 0 is never read by a live row, and an idle row's
// output is discarded. A row whose length leaves no room (lengths[b] <
// 0 or >= P * page), or whose valid pages name a page outside [0, N),
// writes nothing and returns NaN, so no input makes the kernel write
// outside the pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerKey = 8;
constexpr int kGroups = kThreads / kLanesPerKey;  // 32 keys in flight per step
constexpr int kUnroll = 4;
constexpr int kMaxPages = 2048;  // page-table entries of one row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The 4 int8 codes of a word as exact floats (fused_decode_q.cu): each code,
// offset by 128, goes into the low mantissa byte of 2^23 by one byte
// permute, and one subtraction removes 2^23 + 128.
__device__ __forceinline__ void codes_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.0f;
}

// kBytes bytes of one lane's slice of a row as kBytes / sizeof(T) floats.
template <bool kInt8, int kBytes>
__device__ __forceinline__ void slice_to_float(const void* r, float* f) {
  if constexpr (kInt8) {
    const uint32_t* w = static_cast<const uint32_t*>(r);
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) codes_to_float(w[i], f + 4 * i);
  } else {
    const __nv_bfloat16* e = static_cast<const __nv_bfloat16*>(r);
#pragma unroll
    for (int i = 0; i < kBytes / 2; ++i) f[i] = __bfloat162float(e[i]);
  }
}

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const void* __restrict__ k_new,
                        const float* __restrict__ k_new_scale,
                        const void* __restrict__ v_new,
                        const float* __restrict__ v_new_scale, void* k_pages,
                        void* v_pages, float* k_scale, float* v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int layer, int N,
                        int H, int page, int P, float sm_scale) {
  using T = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  constexpr int kDims = D / kLanesPerKey;               // elements per lane
  constexpr int kBytes = kDims * (int)sizeof(T);        // 8, 16 or 32
  using VecT = typename std::conditional<(kBytes >= 16), uint4, uint2>::type;
  constexpr int kVec = kBytes / (int)sizeof(VecT);      // loads per slice
  __shared__ float s_m[kGroups], s_l[kGroups];
  __shared__ float s_acc[kGroups][D];
  __shared__ int s_pages[kMaxPages];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  const size_t row = bh * D;  // q / k_new / v_new / out
  const int len = lengths[b];
  bool bad = len < 0 || len >= P * page;
  const int n_valid = len + 1;
  const int np_valid = bad ? 0 : (n_valid + page - 1) / page;
  for (int i = tid; i < np_valid; i += kThreads) {
    const int pg = table[(size_t)b * P + i];
    s_pages[i] = pg;
    bad = bad || pg < 0 || pg >= N;
  }
  if (__syncthreads_or(bad)) {  // no room or a page outside the pool
    if (tid < D) out[row + tid] = __float2bfloat16(nanf(""));
    return;
  }
  T* kp = static_cast<T*>(k_pages);
  T* vp = static_cast<T*>(v_pages);
  // first (layer, page, h) row of a page, in rows of D elements
  const size_t head = ((size_t)layer * N * H + h) * (size_t)page;
  const size_t page_stride = (size_t)H * page;

  // Append, then make the row visible to the whole CTA before reading it.
  {
    const int ap_j = len / page;
    const size_t r = head + s_pages[ap_j] * page_stride + (len - ap_j * page);
    if (tid < D) {
      kp[r * D + tid] = static_cast<const T*>(k_new)[row + tid];
      vp[r * D + tid] = static_cast<const T*>(v_new)[row + tid];
    }
    if constexpr (kInt8) {
      if (tid == 0) {
        k_scale[r] = k_new_scale[bh];
        v_scale[r] = v_new_scale[bh];
      }
    }
  }
  __syncthreads();

  const int sub = tid & (kLanesPerKey - 1);  // dim slice of this lane
  const int grp = tid / kLanesPerKey;        // key group
  float qv[kDims];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(q + row + sub * kDims);
#pragma unroll
    for (int i = 0; i < kDims / 8; ++i) {
      const uint4 w = qp[i];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qv[i * 8 + j] = bf16_round(__bfloat162float(e[j]) * sm_scale);
    }
  }

  float m = kNegInf, l = 0.f, acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  for (int base = 0; base < n_valid; base += kGroups * kUnroll) {
    VecT kr[kUnroll][kVec], vr[kUnroll][kVec];
    float ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + grp;
      ks[u] = vs[u] = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) kr[u][i] = vr[u][i] = VecT{};
      if (j < n_valid) {
        const int pj = j / page;
        const size_t r = head + s_pages[pj] * page_stride + (j - pj * page);
        const size_t at = r * D + sub * kDims;
        const VecT* kv = reinterpret_cast<const VecT*>(kp + at);
        const VecT* vv = reinterpret_cast<const VecT*>(vp + at);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          kr[u][i] = kv[i];
          vr[u][i] = vv[i];
        }
        if constexpr (kInt8) {
          ks[u] = k_scale[r];
          vs[u] = v_scale[r];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + grp;
      float kf[kDims];
      slice_to_float<kInt8, kBytes>(kr[u], kf);
      float s = 0.f;
#pragma unroll
      for (int x = 0; x < kDims; ++x) s += qv[x] * kf[x];
      // reduce over the 8 lanes of this key (all lanes take part)
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (j < n_valid) {
        if constexpr (kInt8) s *= ks[u];
        const float m_new = fmaxf(m, s);
        const float alpha = __expf(m - m_new);
        const float p = __expf(s - m_new);
        const float pw = kInt8 ? bf16_round(p * vs[u]) : bf16_round(p);
        l = l * alpha + p;
        float vf[kDims];
        slice_to_float<kInt8, kBytes>(vr[u], vf);
#pragma unroll
        for (int x = 0; x < kDims; ++x) acc[x] = acc[x] * alpha + pw * vf[x];
        m = m_new;
      }
    }
  }

  // Merge the 32 group states.
  if (sub == 0) {
    s_m[grp] = m;
    s_l[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < kDims; ++i) s_acc[grp][sub * kDims + i] = acc[i];
  __syncthreads();
  if (tid < D) {
    float mx = kNegInf;
    for (int gi = 0; gi < kGroups; ++gi) mx = fmaxf(mx, s_m[gi]);
    float den = 0.f, num = 0.f;
    for (int gi = 0; gi < kGroups; ++gi) {
      const float sc = __expf(s_m[gi] - mx);  // 0 for groups with no key
      den += s_l[gi] * sc;
      num += s_acc[gi][tid] * sc;
    }
    out[row + tid] = __float2bfloat16(num / den);
  }
}

bool bad_shape(int layer, int L, int N, int B, int H, int page, int P) {
  return layer < 0 || layer >= L || N <= 0 || B <= 0 || B > 65535 ||
         H <= 0 || H > 65535 || page < 16 || page > 256 || page % 16 ||
         P <= 0 || P > kMaxPages;
}

template <bool kInt8>
int launch(const void* q, const void* k_new, const void* k_new_scale,
           const void* v_new, const void* v_new_scale, void* k_pages,
           void* v_pages, void* k_scale, void* v_scale, const void* table,
           const void* lengths, void* out, int layer, int L, int N, int B,
           int H, int page, int P, int D, float sm_scale, void* stream) {
  if (bad_shape(layer, L, N, B, H, page, P))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kns = static_cast<const float*>(k_new_scale);
  const auto* vns = static_cast<const float*>(v_new_scale);
  auto* ks = static_cast<float*>(k_scale);
  auto* vs = static_cast<float*>(v_scale);
  const auto* tp = static_cast<const int*>(table);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64)
    paged_decode_kernel<64, kInt8><<<grid, kThreads, 0, st>>>(
        qp, k_new, kns, v_new, vns, k_pages, v_pages, ks, vs, tp, lp, op,
        layer, N, H, page, P, sm_scale);
  else if (D == 128)
    paged_decode_kernel<128, kInt8><<<grid, kThreads, 0, st>>>(
        qp, k_new, kns, v_new, vns, k_pages, v_pages, ks, vs, tp, lp, op,
        layer, N, H, page, P, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// q/k_new/v_new/out (B,H,1,D) bf16; pools (L,N,H,page,D) bf16; table (B,P)
// and lengths (B,) int32 on the device. All contiguous, 16-byte aligned.
// Returns cudaError_t.
extern "C" int lhrs_paged_decode_bf16(const void* q, const void* k_new,
                                      const void* v_new, void* k_pages,
                                      void* v_pages, const void* table,
                                      const void* lengths, void* out,
                                      int layer, int L, int N, int B, int H,
                                      int page, int P, int D, float sm_scale,
                                      void* stream) {
  return launch<false>(q, k_new, nullptr, v_new, nullptr, k_pages, v_pages,
                       nullptr, nullptr, table, lengths, out, layer, L, N, B,
                       H, page, P, D, sm_scale, stream);
}

// q/out (B,H,1,D) bf16; k_new/v_new (B,H,1,D) int8; k_new_scale/v_new_scale
// (B,H,1) f32; pools (L,N,H,page,D) int8; scale pools (L,N,H,page) f32;
// table (B,P) and lengths (B,) int32 on the device. All contiguous, 16-byte
// aligned. Returns cudaError_t.
extern "C" int lhrs_paged_decode_q(const void* q, const void* k_new,
                                   const void* k_new_scale, const void* v_new,
                                   const void* v_new_scale, void* k_pages,
                                   void* v_pages, void* k_scale, void* v_scale,
                                   const void* table, const void* lengths,
                                   void* out, int layer, int L, int N, int B,
                                   int H, int page, int P, int D,
                                   float sm_scale, void* stream) {
  return launch<true>(q, k_new, k_new_scale, v_new, v_new_scale, k_pages,
                      v_pages, k_scale, v_scale, table, lengths, out, layer,
                      L, N, B, H, page, P, D, sm_scale, stream);
}
