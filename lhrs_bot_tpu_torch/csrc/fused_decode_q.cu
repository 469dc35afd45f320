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
// Design: K2's (fused_decode.cu). One CTA of 256 threads per (b, h); the
// CTA appends the row and its scales first, then `__syncthreads()`, so every
// thread reads the new row and scales from the cache (the cache pointers
// are not read-only). Eight lanes share one key row, each loading its
// D / 8 codes with one 16-byte (D = 128) or 8-byte (D = 64) load; 32 key
// groups keep 4 keys of K and V rows in flight, each group with its own
// running max, sum and accumulator slice, merged through shared memory at
// the end. The codes become floats by a byte permute and a subtraction
// (`codes_to_float`), not the integer-to-float conversion, whose quarter
// rate would bound the kernel on the few SMs that one CTA per (b, h) uses
// at small batch. A row whose length leaves no room (lengths[b] >= S)
// writes nothing and returns NaN, as K2 does.

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

template <int Bytes>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
};
template <>
struct Vec<8> {
  using T = uint2;
};

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_decode_q_kernel(const __nv_bfloat16* __restrict__ q,
                          const int8_t* __restrict__ k_new,
                          const float* __restrict__ k_new_scale,
                          const int8_t* __restrict__ v_new,
                          const float* __restrict__ v_new_scale,
                          int8_t* k_cache, int8_t* v_cache, float* k_scale,
                          float* v_scale, const int* __restrict__ lengths,
                          __nv_bfloat16* __restrict__ out, int layer, int B,
                          int H, int S, float sm_scale) {
  constexpr int kDims = D / kLanesPerKey;  // codes per lane per row
  using VecT = typename Vec<kDims>::T;
  __shared__ float s_m[kGroups], s_l[kGroups];
  __shared__ float s_acc[kGroups][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  const size_t row = bh * D;  // q / k_new / v_new / out
  const int len = lengths[b];
  if (len < 0 || len >= S) {  // no room for the append: flag, never write
    if (tid < D) out[row + tid] = __float2bfloat16(nanf(""));
    return;
  }
  const size_t plane = ((size_t)layer * B + b) * H + h;
  int8_t* kc = k_cache + plane * S * D;
  int8_t* vc = v_cache + plane * S * D;
  float* ksc = k_scale + plane * S;
  float* vsc = v_scale + plane * S;

  // Append codes and scales, then make them visible to the whole CTA.
  if (tid < D) {
    kc[(size_t)len * D + tid] = k_new[row + tid];
    vc[(size_t)len * D + tid] = v_new[row + tid];
  }
  if (tid == 0) {
    ksc[len] = k_new_scale[bh];
    vsc[len] = v_new_scale[bh];
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

  const int n_valid = len + 1;
  for (int base = 0; base < n_valid; base += kGroups * kUnroll) {
    VecT kr[kUnroll], vr[kUnroll];
    float ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + grp;
      kr[u] = vr[u] = VecT{};
      ks[u] = vs[u] = 0.f;
      if (j < n_valid) {
        kr[u] = *reinterpret_cast<const VecT*>(kc + (size_t)j * D +
                                               sub * kDims);
        vr[u] = *reinterpret_cast<const VecT*>(vc + (size_t)j * D +
                                               sub * kDims);
        ks[u] = ksc[j];
        vs[u] = vsc[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + grp;
      const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kr[u]);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kDims / 4; ++i) {
        float kf[4];
        codes_to_float(kw[i], kf);
#pragma unroll
        for (int x = 0; x < 4; ++x) s += qv[i * 4 + x] * kf[x];
      }
      // reduce over the 8 lanes of this key (all lanes take part)
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (j < n_valid) {
        s *= ks[u];
        const float m_new = fmaxf(m, s);
        const float alpha = __expf(m - m_new);
        const float p = __expf(s - m_new);
        const float pv = bf16_round(p * vs[u]);
        l = l * alpha + p;
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(&vr[u]);
#pragma unroll
        for (int i = 0; i < kDims / 4; ++i) {
          float vf[4];
          codes_to_float(vw[i], vf);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc[i * 4 + x] = acc[i * 4 + x] * alpha + pv * vf[x];
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

// q/out (B,H,1,D) bf16; k_new/v_new (B,H,1,D) int8; k_new_scale/v_new_scale
// (B,H,1) f32; caches (L,B,H,S,D) int8; scale planes (L,B,H,S) f32; lengths
// (B,) int32 on the device. All contiguous, 16-byte aligned. Returns
// cudaError_t.
extern "C" int lhrs_fused_decode_q(const void* q, const void* k_new,
                                   const void* k_new_scale, const void* v_new,
                                   const void* v_new_scale, void* k_cache,
                                   void* v_cache, void* k_scale,
                                   void* v_scale, const void* lengths,
                                   void* out, int layer, int L, int B, int H,
                                   int S, int D, float sm_scale,
                                   void* stream) {
  if (layer < 0 || layer >= L || B <= 0 || H <= 0 || S <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kn = static_cast<const int8_t*>(k_new);
  const auto* kns = static_cast<const float*>(k_new_scale);
  const auto* vn = static_cast<const int8_t*>(v_new);
  const auto* vns = static_cast<const float*>(v_new_scale);
  auto* kc = static_cast<int8_t*>(k_cache);
  auto* vc = static_cast<int8_t*>(v_cache);
  auto* ks = static_cast<float*>(k_scale);
  auto* vs = static_cast<float*>(v_scale);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 64)
    fused_decode_q_kernel<64><<<grid, kThreads, 0, st>>>(
        qp, kn, kns, vn, vns, kc, vc, ks, vs, lp, op, layer, B, H, S,
        sm_scale);
  else if (D == 128)
    fused_decode_q_kernel<128><<<grid, kThreads, 0, st>>>(
        qp, kn, kns, vn, vns, kc, vc, ks, vs, lp, op, layer, B, H, S,
        sm_scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
