// Kernel A: float32 LayerNorm (or none) + symmetric per-row int8
// quantization, for Hopper (sm_90a).
//
// Replaces the `_ln_f32` + `_quant_act` stages inside the Pallas TPU kernels
// of the W8A8 vision tower: `_vit_block_kernel` / `_vit_block_grouped_kernel`
// (lhrs_bot_tpu/ops/vit_block.py:111, :132; helpers :95-108), the split
// form's `_vit_qkv_kernel` (:319) and `_vit_post_kernel` (:338), and
// `_perceiver_block_kernel` (lhrs_bot_tpu/ops/perceiver_block.py:53;
// helpers :41-50). Also `quantize_activation` (lhrs_bot_tpu/ops/quant.py:116)
// in quantize-only mode. Per row of width W:
//   LayerNorm mode: mu = mean(x); var = mean((x - mu)^2);
//                   h = (x - mu) * rsqrt(var + eps) * gamma + beta
//   quantize-only:  h = x
//   then amax = max|h|, s = amax / 127 (1 where amax == 0),
//   q = clip(round_half_even(h / s), -127, 127).
// The quotient is an IEEE division (__fdiv_rn), not a multiply by a
// reciprocal, and rintf rounds half to even as jnp.round does, so the
// quantize-only mode is bit-identical to its plain version.
//
// What bounds it on the H100: device-memory bandwidth. It reads W elements
// (2 or 4 bytes) and writes W bytes + one float per row, with a few flops
// each; at the ViT's M = B*257 rows it is a streaming pass.
//
// Design: one CTA of 256 threads owns one row, so the row's mean, variance
// and amax are exact block reductions (warp shuffles, then 8 partials in
// shared memory) and no second pass over device memory is needed: the row
// is staged once as float32 in dynamic shared memory (W * 4 bytes, W up to
// 12032, which covers the ViT's 4096-wide FC output and LLaMA's 11008), and
// the normalisation and the quantization read it from there. The
// float32 products are written with __fmul_rn / __fadd_rn so the compiler
// cannot contract them into FMAs that the plain version does not do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 12032;  // 47 KB of float32 row + the partials: within
                                // the 48 KB a launch may take without opt-in

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w)
    v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

template <bool kF32In>
__global__ void __launch_bounds__(kThreads)
    ln_quant_kernel(const void* __restrict__ x, long long x_stride,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ q,
                    float* __restrict__ s, int W, float eps) {
  extern __shared__ float row[];
  __shared__ float red[kThreads / 32];
  const size_t r = blockIdx.x;
  const bool ln = gamma != nullptr;

  float acc = 0.f;  // sum (LayerNorm) or amax (quantize-only)
  for (int i = threadIdx.x; i < W; i += kThreads) {
    float v;
    if (kF32In)
      v = static_cast<const float*>(x)[r * x_stride + i];
    else
      v = __bfloat162float(
          static_cast<const __nv_bfloat16*>(x)[r * x_stride + i]);
    row[i] = v;
    acc = ln ? acc + v : fmaxf(acc, fabsf(v));
  }
  float amax;
  if (ln) {
    const float mu = __fdiv_rn(block_reduce(acc, red, false), (float)W);
    float sq = 0.f;
    for (int i = threadIdx.x; i < W; i += kThreads) {
      const float d = __fsub_rn(row[i], mu);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float var = __fdiv_rn(block_reduce(sq, red, false), (float)W);
    const float rs = rsqrtf(__fadd_rn(var, eps));
    float m = 0.f;
    for (int i = threadIdx.x; i < W; i += kThreads) {
      const float n = __fmul_rn(__fsub_rn(row[i], mu), rs);
      const float h = __fadd_rn(__fmul_rn(n, gamma[i]), beta[i]);
      row[i] = h;
      m = fmaxf(m, fabsf(h));
    }
    amax = block_reduce(m, red, true);
  } else {
    amax = block_reduce(acc, red, true);
  }
  const float sc = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const float c = fminf(fmaxf(rintf(__fdiv_rn(row[i], sc)), -127.f), 127.f);
    q[r * W + i] = static_cast<int8_t>(c);
  }
  if (threadIdx.x == 0) s[r] = sc;
}

}  // namespace

// x: M rows of W elements (bf16, or float32 when x_f32), row stride x_stride
// elements, unit column stride. gamma/beta: float32 (W) for the LayerNorm
// mode, both null for quantize-only. q: (M, W) int8 contiguous; s: (M)
// float32. Returns cudaError_t.
extern "C" int lhrs_ln_quant(const void* x, int x_f32, long long x_stride,
                             const void* gamma, const void* beta, void* q,
                             void* s, int M, int W, float eps, void* stream) {
  if (M <= 0 || W <= 0 || W > kMaxW || (gamma == nullptr) != (beta == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)W * sizeof(float);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  if (x_f32)
    ln_quant_kernel<true><<<M, kThreads, smem, st>>>(x, x_stride, g, b, qp, sp,
                                                     W, eps);
  else
    ln_quant_kernel<false><<<M, kThreads, smem, st>>>(x, x_stride, g, b, qp,
                                                      sp, W, eps);
  return (int)cudaGetLastError();
}
