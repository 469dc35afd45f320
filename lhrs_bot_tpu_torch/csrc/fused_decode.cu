// Fused decode append + single-query attention over a stacked bf16 KV cache,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of `fused_decode_attention`
// (lhrs_bot_tpu/ops/fused_decode.py:43, called at :201). Same semantics: the
// new K/V row of (layer, b, h) is written in place at row lengths[b] of the
// (L, B, H, S_max, D) cache, then the query attends over rows
// [0, lengths[b]] with an f32 online softmax; q is scaled by sm_scale and
// rounded to bf16 before the dot, and probabilities are rounded to bf16
// before the PV product, as in the TPU kernel.
//
// What bounds it on the H100: device-memory bandwidth. Each (b, h) streams
// 2 * (len+1) * D * 2 bytes of cache for 4 * (len+1) * D flops, far below the
// card's ridge point. The layer index and the lengths are read on the device,
// so a decode step needs no host synchronisation and the stacked cache is
// never copied.
//
// Design: one CTA of 256 threads per (b, h). Eight lanes share one key row
// (16-byte loads, so a warp reads four consecutive rows as one contiguous
// 1 KB span); the CTA keeps 32 key groups, and each group loads 4 keys' K and
// V rows before it computes, to keep enough bytes in flight. Every group
// holds its own running max, sum and D-wide accumulator slice; the 32 partial
// states are merged through shared memory at the end. One CTA per (b, h)
// leaves SMs idle at small batch; splitting the sequence across CTAs is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerKey = 8;
constexpr int kGroups = kThreads / kLanesPerKey;  // 32 keys in flight per step
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_decode_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_new,
                        const __nv_bfloat16* __restrict__ v_new,
                        __nv_bfloat16* k_cache, __nv_bfloat16* v_cache,
                        const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int layer, int B,
                        int H, int S, float sm_scale) {
  constexpr int kDims = D / kLanesPerKey;  // dims per lane
  constexpr int kVec = kDims / 8;          // uint4 per lane per row
  __shared__ float s_m[kGroups], s_l[kGroups];
  __shared__ float s_acc[kGroups][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row = ((size_t)b * H + h) * D;  // q / k_new / v_new / out
  const int len = lengths[b];
  if (len < 0 || len >= S) {  // no room for the append: flag, never write
    if (tid < D) out[row + tid] = __float2bfloat16(nanf(""));
    return;
  }
  const size_t head = (((size_t)layer * B + b) * H + h) * (size_t)S * D;
  __nv_bfloat16* kc = k_cache + head;
  __nv_bfloat16* vc = v_cache + head;

  // Append, then make the row visible to the whole CTA before reading it.
  if (tid < D) {
    kc[(size_t)len * D + tid] = k_new[row + tid];
    vc[(size_t)len * D + tid] = v_new[row + tid];
  }
  __syncthreads();

  const int sub = tid & (kLanesPerKey - 1);  // dim slice of this lane
  const int grp = tid / kLanesPerKey;        // key group
  float qv[kDims];
  {
    const uint4* qp = reinterpret_cast<const uint4*>(q + row + sub * kDims);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const uint4 w = qp[i];
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qv[i * 8 + j] = __bfloat162float(
            __float2bfloat16(__bfloat162float(e[j]) * sm_scale));
    }
  }

  float m = kNegInf, l = 0.f, acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  const int n_valid = len + 1;
  for (int base = 0; base < n_valid; base += kGroups * kUnroll) {
    uint4 kr[kUnroll][kVec], vr[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + grp;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        kr[u][i] = vr[u][i] = make_uint4(0, 0, 0, 0);
        if (j < n_valid) {
          kr[u][i] = reinterpret_cast<const uint4*>(
              kc + (size_t)j * D + sub * kDims)[i];
          vr[u][i] = reinterpret_cast<const uint4*>(
              vc + (size_t)j * D + sub * kDims)[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + grp;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&kr[u][i]);
#pragma unroll
        for (int x = 0; x < 8; ++x) s += qv[i * 8 + x] * __bfloat162float(e[x]);
      }
      // reduce over the 8 lanes of this key (all lanes take part)
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (j < n_valid) {
        const float m_new = fmaxf(m, s);
        const float alpha = __expf(m - m_new);
        const float p = __expf(s - m_new);
        const float pb = __bfloat162float(__float2bfloat16(p));
        l = l * alpha + p;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const __nv_bfloat16* e =
              reinterpret_cast<const __nv_bfloat16*>(&vr[u][i]);
#pragma unroll
          for (int x = 0; x < 8; ++x)
            acc[i * 8 + x] = acc[i * 8 + x] * alpha + pb * __bfloat162float(e[x]);
        }
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

}  // namespace

// q/k_new/v_new/out (B,H,1,D), caches (L,B,H,S,D): contiguous bf16, 16-byte
// aligned; lengths (B,) int32 on the device. Returns cudaError_t.
extern "C" int lhrs_fused_decode_bf16(const void* q, const void* k_new,
                                      const void* v_new, void* k_cache,
                                      void* v_cache, const void* lengths,
                                      void* out, int layer, int L, int B,
                                      int H, int S, int D, float sm_scale,
                                      void* stream) {
  if (layer < 0 || layer >= L || B <= 0 || H <= 0 || S <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kn = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vn = static_cast<const __nv_bfloat16*>(v_new);
  auto* kc = static_cast<__nv_bfloat16*>(k_cache);
  auto* vc = static_cast<__nv_bfloat16*>(v_cache);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64)
    fused_decode_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kn, vn, kc, vc, lp, op, layer, B, H, S, sm_scale);
  else if (D == 128)
    fused_decode_kernel<128><<<grid, kThreads, 0, st>>>(
        qp, kn, vn, kc, vc, lp, op, layer, B, H, S, sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
