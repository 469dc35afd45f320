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
// The int8-dots variant (kernel fused_decode_q_int8dots_kernel, entry
// lhrs_fused_decode_q_int8dots) replaces the same kernel with
// `int8_dots=True` (fused_decode.py:332-336, :374-379, :417-426): q *
// sm_scale is quantized per head to int8 in float32 (absmax / 127 + 1e-12,
// the quotient by __fdiv_rn and rintf); the rows are walked in blocks of
// `block_s` (a runtime argument, part of the result); in each block the
// scores are exact int32 __dp4a dots of the q codes with the key codes
// (8 lanes a row) times q's scale times the key's, held in shared memory;
// the block's max updates the running max, p = exp(s - m) and p * v_scale
// is quantized per head over the WHOLE block (its absmax is reduced before
// any code is taken, so the row stays in shared memory); P.V is an exact
// int32 __dp4a sum per column (four rows' value bytes transposed into one
// word per column), scaled by p's scale in float32 and added to the
// accumulator after alpha, as on the TPU; the denominator sums the float
// p, not the codes. Still bytes-bound: the cache bytes are read once. It
// keeps the one-CTA-per-(b, h) design: the CTA appends the row and its
// scales first, then `__syncthreads()`, so every thread reads the new row
// and scales from the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"

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

// Block-wide max and sum over the CTA's 256 threads (in a fixed order);
// every thread calls them, and every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // the previous reduction's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = fmaxf(v, red[i]);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v += red[i];
  return v;
}

// Bytes of dynamic shared memory the int8-dots variant takes for a block:
// the block's float scores / probabilities, then its int8 codes (3 bytes
// past the last code are read with it, as part of a 4-row word).
__host__ __device__ __forceinline__ int score_bytes(int block_s) {
  return (block_s * 4 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int int8dots_smem(int block_s) {
  return score_bytes(block_s) + (block_s + 15) / 16 * 16 + 16;
}

// The int8-dots attention of one (b, h) over rows [0, n_valid) of its
// appended cache; writes the D outputs.
template <int D>
__device__ void attend_int8_dots(const __nv_bfloat16* __restrict__ q,
                                 const int8_t* kc, const int8_t* vc,
                                 const float* ksc, const float* vsc,
                                 int n_valid, int block_s, float sm_scale,
                                 __nv_bfloat16* __restrict__ out) {
  constexpr int kDims = D / kLanesPerKey;  // codes per lane per row
  constexpr int kWords = kDims / 4;
  using VecT = typename Vec<kDims>::T;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float red[kThreads / 32];
  __shared__ uint32_t q8[D / 4];
  __shared__ int pv_part[kGroups][D];
  float* s_row = reinterpret_cast<float*>(dyn);
  int8_t* p8 = reinterpret_cast<int8_t*>(dyn + score_bytes(block_s));

  const int tid = threadIdx.x;
  const int sub = tid & (kLanesPerKey - 1), grp = tid / kLanesPerKey;

  // q * sm_scale to int8 codes, one scale for the head
  const float qf =
      tid < D ? __fmul_rn(__bfloat162float(q[tid]), sm_scale) : 0.f;
  const float q_qs =
      __fadd_rn(__fdiv_rn(block_max(fabsf(qf), red), 127.f), 1e-12f);
  if (tid < D)
    reinterpret_cast<int8_t*>(q8)[tid] = (int8_t)rintf(__fdiv_rn(qf, q_qs));
  __syncthreads();
  int qw[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) qw[i] = (int)q8[sub * kWords + i];

  float m = kNegInf, l = 0.f, acc = 0.f;  // acc: column tid (< D)
  for (int start = 0; start < n_valid; start += block_s) {
    const int rows = min(block_s, n_valid - start);
    const int8_t* kb = kc + (size_t)start * D + sub * kDims;
    const int8_t* vb = vc + (size_t)start * D + sub * kDims;

    // scores: the exact int32 dot of a row's codes with q's, 8 lanes a row
    for (int r0 = 0; r0 < rows; r0 += kGroups * kUnroll) {
      VecT kr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kGroups + grp;
        kr[u] = r < rows ? *reinterpret_cast<const VecT*>(kb + (size_t)r * D)
                         : VecT{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kGroups + grp;
        const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kr[u]);
        int dot = 0;
#pragma unroll
        for (int i = 0; i < kWords; ++i) dot = __dp4a((int)kw[i], qw[i], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        if (r < rows && sub == 0)
          s_row[r] = __fmul_rn(__fmul_rn(__int2float_rn(dot), q_qs),
                               ksc[start + r]);
      }
    }
    __syncthreads();

    // online max; p and p * v_scale; the block's p scale from its absmax
    float bm = kNegInf;
    for (int r = tid; r < rows; r += kThreads) bm = fmaxf(bm, s_row[r]);
    const float new_m = fmaxf(m, block_max(bm, red));
    const float alpha = expf(m - new_m);
    float psum = 0.f, pmax = 0.f;
    for (int r = tid; r < rows; r += kThreads) {
      const float p = expf(s_row[r] - new_m);
      const float ps = __fmul_rn(p, vsc[start + r]);
      psum += p;
      pmax = fmaxf(pmax, fabsf(ps));
      s_row[r] = ps;
    }
    const float p_qs =
        __fadd_rn(__fdiv_rn(block_max(pmax, red), 127.f), 1e-12f);
    psum = block_sum(psum, red);
    for (int r = tid; r < rows; r += kThreads)
      p8[r] = (int8_t)rintf(__fdiv_rn(s_row[r], p_qs));
    __syncthreads();

    // P.V: four rows at a time, each lane's value bytes transposed into
    // one word per column (rows past the block's end load as 0, so the
    // code bytes read with them count for nothing)
    int pacc[kDims];
#pragma unroll
    for (int i = 0; i < kDims; ++i) pacc[i] = 0;
    const int quads = (rows + 3) / 4;
    for (int qd = grp; qd < quads; qd += kGroups) {
      const int r = qd * 4;
      const int pp = *reinterpret_cast<const int*>(p8 + r);
      VecT v4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v4[j] = r + j < rows
                    ? *reinterpret_cast<const VecT*>(vb + (size_t)(r + j) * D)
                    : VecT{};
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const uint32_t a0 = reinterpret_cast<const uint32_t*>(&v4[0])[w];
        const uint32_t a1 = reinterpret_cast<const uint32_t*>(&v4[1])[w];
        const uint32_t a2 = reinterpret_cast<const uint32_t*>(&v4[2])[w];
        const uint32_t a3 = reinterpret_cast<const uint32_t*>(&v4[3])[w];
        const uint32_t t0 = __byte_perm(a0, a1, 0x5140);
        const uint32_t t1 = __byte_perm(a2, a3, 0x5140);
        const uint32_t t2 = __byte_perm(a0, a1, 0x7362);
        const uint32_t t3 = __byte_perm(a2, a3, 0x7362);
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
#pragma unroll
    for (int i = 0; i < kDims; ++i) pv_part[grp][sub * kDims + i] = pacc[i];
    __syncthreads();
    if (tid < D) {
      int tot = 0;
      for (int gi = 0; gi < kGroups; ++gi) tot += pv_part[gi][tid];
      acc = __fadd_rn(__fmul_rn(acc, alpha),
                      __fmul_rn(__int2float_rn(tot), p_qs));
    }
    l = __fadd_rn(__fmul_rn(l, alpha), psum);
    m = new_m;
    __syncthreads();  // s_row, p8 and pv_part are the next block's
  }
  if (tid < D) out[tid] = __float2bfloat16(__fdiv_rn(acc, l));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fused_decode_q_int8dots_kernel(const __nv_bfloat16* __restrict__ q,
                                   const int8_t* __restrict__ k_new,
                                   const float* __restrict__ k_new_scale,
                                   const int8_t* __restrict__ v_new,
                                   const float* __restrict__ v_new_scale,
                                   int8_t* k_cache, int8_t* v_cache,
                                   float* k_scale, float* v_scale,
                                   const int* __restrict__ lengths,
                                   __nv_bfloat16* __restrict__ out, int layer,
                                   int B, int H, int S, float sm_scale,
                                   int block_s) {
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
  attend_int8_dots<D>(q + row, kc, vc, ksc, vsc, len + 1, block_s, sm_scale,
                      out + row);
}

}  // namespace

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

// The int8-dots variant: the same arguments but splits and fault, then
// block_s (1..S; at most 4096 keeps the shared memory under 48 KB).
// Returns cudaError_t.
extern "C" int lhrs_fused_decode_q_int8dots(
    const void* q, const void* k_new, const void* k_new_scale,
    const void* v_new, const void* v_new_scale, void* k_cache, void* v_cache,
    void* k_scale, void* v_scale, const void* lengths, void* out, int layer,
    int L, int B, int H, int S, int D, float sm_scale, int block_s,
    void* stream) {
  if (layer < 0 || layer >= L || B <= 0 || H <= 0 || S <= 0 || B > 65535 ||
      block_s <= 0 || block_s > S || block_s > 4096)
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
  const int smem = int8dots_smem(block_s);
  if (D == 64)
    fused_decode_q_int8dots_kernel<64><<<grid, kThreads, smem, st>>>(
        qp, kn, kns, vn, vns, kc, vc, ks, vs, lp, op, layer, B, H, S,
        sm_scale, block_s);
  else if (D == 128)
    fused_decode_q_int8dots_kernel<128><<<grid, kThreads, smem, st>>>(
        qp, kn, kns, vn, vns, kc, vc, ks, vs, lp, op, layer, B, H, S,
        sm_scale, block_s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
