// Paged decode append + single-query attention over a shared bf16 KV page
// pool, for Hopper (sm_90a). (The int8 pool's kernel is paged_decode_q.cu,
// on the split design of decode_split.cuh.)
//
// Replaces the Pallas TPU kernel `_kernel_p` of `paged_fused_decode`
// (lhrs_bot_tpu/ops/paged_fused.py:213, called at :496). Same semantics:
// pools are (L, N_pages, H, page, D), page 0 the null page; for each row b
// of layer `layer`, the new token's K/V row is written in place at position
// lengths[b], i.e. page table[b, lengths[b] / page], offset lengths[b] %
// page; then the query attends over the lengths[b] + 1 positions of the
// row, walking its pages through the table, with an f32 online softmax.
// Columns at or past lengths[b] + 1 are masked, and no page past
// ceil((lengths[b] + 1) / page) is read. Roundings are the TPU kernel's: q
// * sm_scale in f32, rounded to bf16 (:268); p rounded to bf16 before the
// PV product (:315); the denominator sums p unrounded; the output is acc /
// l in f32, then bf16.
//
// What bounds it on the H100: device-memory bandwidth. Each (b, h) streams
// the K and V rows of its lengths[b] + 1 valid positions once: 2 * (len +
// 1) * D * 2 bytes, for 4 * (len + 1) * D flops. The bound of a call is
// those bytes over all (b, h) over 3.35 TB/s.
//
// Design: the one-CTA-per-(b, h) decode kernel, with the row's page ids
// staged in shared memory. One CTA of 256 threads per (b, h). The CTA first
// reads the page ids of its valid pages from the table, each once (there
// is no scalar prefetch on this card), and checks them; then it appends
// the new row into its page and synchronises, so it reads the row it wrote
// like any other. The TPU kernel's race patch (paged_fused.py:155-163: its
// append write-back could race its page DMA) has no counterpart: nothing
// else writes that row, since the rows of different heads never overlap
// and a row's append page is its own. Eight lanes share one key row
// (16-byte loads); 32 key groups keep 4 keys of K and V in flight, each
// with its own running max, sum and accumulator slice, merged through
// shared memory at the end. Key j's row is page s_pages[j / page], offset
// j % page, so any page size that is a multiple of 16 (up to 256) works,
// the CPU tests' page of 16 included; the TPU's sublane windows, DMA ring
// and page >= 128 floor are layout and do not carry over. What limits it:
// one CTA per (b, h) is latency-bound at small B (256 CTAs at B = 8, H =
// 32, on 132 SMs); it runs at about half its bound (PERF.md section 6),
// so it was left on this design when the int8 kernel moved to the split.
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

// kBytes bytes of one lane's slice of a row as kBytes / 2 floats.
template <int kBytes>
__device__ __forceinline__ void slice_to_float(const void* r, float* f) {
  const __nv_bfloat16* e = static_cast<const __nv_bfloat16*>(r);
#pragma unroll
  for (int i = 0; i < kBytes / 2; ++i) f[i] = __bfloat162float(e[i]);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_new,
                        const __nv_bfloat16* __restrict__ v_new,
                        __nv_bfloat16* k_pages, __nv_bfloat16* v_pages,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int layer, int N,
                        int H, int page, int P, float sm_scale) {
  using T = __nv_bfloat16;
  constexpr int kDims = D / kLanesPerKey;               // elements per lane
  constexpr int kBytes = kDims * (int)sizeof(T);        // 16 or 32
  using VecT = uint4;
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
  T* kp = k_pages;
  T* vp = v_pages;
  // first (layer, page, h) row of a page, in rows of D elements
  const size_t head = ((size_t)layer * N * H + h) * (size_t)page;
  const size_t page_stride = (size_t)H * page;

  // Append, then make the row visible to the whole CTA before reading it.
  {
    const int ap_j = len / page;
    const size_t r = head + s_pages[ap_j] * page_stride + (len - ap_j * page);
    if (tid < D) {
      kp[r * D + tid] = k_new[row + tid];
      vp[r * D + tid] = v_new[row + tid];
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
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + grp;
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
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + grp;
      float kf[kDims];
      slice_to_float<kBytes>(kr[u], kf);
      float s = 0.f;
#pragma unroll
      for (int x = 0; x < kDims; ++x) s += qv[x] * kf[x];
      // reduce over the 8 lanes of this key (all lanes take part)
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (j < n_valid) {
        const float m_new = fmaxf(m, s);
        const float alpha = __expf(m - m_new);
        const float p = __expf(s - m_new);
        const float pw = bf16_round(p);
        l = l * alpha + p;
        float vf[kDims];
        slice_to_float<kBytes>(vr[u], vf);
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
  if (bad_shape(layer, L, N, B, H, page, P))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kn = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vn = static_cast<const __nv_bfloat16*>(v_new);
  auto* kp = static_cast<__nv_bfloat16*>(k_pages);
  auto* vp = static_cast<__nv_bfloat16*>(v_pages);
  const auto* tp = static_cast<const int*>(table);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64)
    paged_decode_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kn, vn, kp, vp, tp, lp, op, layer, N, H, page, P, sm_scale);
  else if (D == 128)
    paged_decode_kernel<128><<<grid, kThreads, 0, st>>>(
        qp, kn, vn, kp, vp, tp, lp, op, layer, N, H, page, P, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
