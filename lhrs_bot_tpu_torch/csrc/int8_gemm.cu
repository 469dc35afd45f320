// Kernel B: int8 x int8 -> int32 GEMM with a float32 epilogue, for Hopper
// (sm_90a).
//
// Replaces the int8 MXU contractions and their f32 dequantization epilogues
// inside the Pallas TPU kernels of the W8A8 vision tower:
// `_vit_block_kernel` / `_vit_block_grouped_kernel`
// (lhrs_bot_tpu/ops/vit_block.py:111, :132: QKV, O, FC, proj), the split
// form's `_vit_qkv_kernel` (:319) and `_vit_post_kernel` (:338), and
// `_perceiver_block_kernel` (lhrs_bot_tpu/ops/perceiver_block.py:53: q, kv,
// O, FC, proj); also the int8 product of `w8a8_matmul`
// (lhrs_bot_tpu/ops/quant.py:121), which the JAX package leaves to XLA.
//
//   acc[m, n] = sum_k A[m, k] * W[k, n]   (int32, exact)
//   ws-first:  v = (acc * (w_scale[n] * c[n])) * x_scale[m]
//   x-first:   v = (acc * x_scale[m]) * w_scale[n]
//   [round_mid: v = bf16(v)]  [+ bias[n] (* c[n])]  [* out_mult]
//   [QuickGELU | erf GELU | tanh GELU]  [+ residual[m, n]]  -> bf16 / f32
// with c[n] = q_fold for n < n_fold and 1 otherwise (the softmax scale
// folded into the Q columns of the ViT block's QKV projection). Each variant
// is one of the TPU kernels' (or XLA's) orders of float32 operations; the
// products and sums are written with __fmul_rn / __fadd_rn so none is
// contracted into an FMA the plain version does not do. out_kind 2 writes
// the raw int32 accumulators, for the exactness check.
//
// What bounds it on the H100: at the ViT's M = B*257 rows (B = 64: 16448)
// and K, N of 1024-4096 the product is compute-bound (2*M*N*K int8
// operations against M*K + N*K input bytes, 1979 TOP/s dense), and only
// wgmma reaches the int8 tensor-core rate; the output (M*N bf16 or float32)
// is the largest byte stream, so the epilogue has to store it in full,
// contiguous lines. At B = 1 (M = 257) the grid has too few CTAs to fill
// 132 SMs and load latency dominates.
//
// Design: a CTA of two consumer warpgroups and a producer warp computes a
// 128 x 128 output tile. The producer keeps a ring of 3 stages in flight,
// each a 128-byte K slice of the A tile and of the weight tile (128 rows
// each), copied by TMA into 128-byte swizzled shared memory and announced
// on the stage's "full" mbarrier; rows past M or N and bytes past K arrive
// as zeros, so every M, any N that is a multiple of 8 and any K that is a
// multiple of 64 run the same loop. Each consumer warpgroup owns 64 rows and
// issues wgmma.mma_async m64n128k32 (s8 x s8 -> s32) with both operands read
// from shared memory through descriptors, 64 int32 accumulators a thread; a
// stage goes back to the producer (its "empty" mbarrier) once the products
// that read it have retired, while the next stage's products run. For 8-bit
// types wgmma takes only K-major operands: A is (M, K) row-major and the
// weight is read as (N, K) row-major (K contiguous per output column), which
// the port keeps as the storage of every packed weight, the JAX (K, N)
// layout being its transposed view. After the last stage the ring is free:
// the accumulators go to shared memory as int32 rows, and the epilogue reads
// them back one 4-column group a thread, so that a warp reads and writes a
// whole 128-column row segment (the residual too); the row scale and the
// tile's column factors (w_scale * c, bias * c) are loaded into shared
// memory once. The epilogue (float32 arithmetic, the GELUs' transcendental
// functions, an output of up to 4 bytes an element) leaves the tensor cores
// idle, so a CTA is kept small enough (98 KB of shared memory, at most 112
// registers a thread) that two share an SM and one's epilogue runs beside
// the other's products. On an H100 this tiling beat a 128 x 256 tile with
// one CTA an SM at four of the tower's five shapes (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// A CTA computes a 128 x 128 output tile with two consumer warpgroups and
// one producer warp, through a ring of 3 stages of 32 KB; 98 KB of shared
// memory and at most 112 registers a thread let two CTAs share an SM, so
// that one CTA's epilogue overlaps the other's products.
constexpr int kBM = 128, kBN = 128, kBK = 128;  // kBK: bytes of K a stage
constexpr int kStages = 3;
constexpr int kConsumers = 256;                // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;      // and the producer warp
constexpr int kABytes = kBM * kBK;
constexpr int kStageBytes = kABytes + kBN * kBK;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kLdc = kBN + 8;  // int32 words a staged row: 2-way free stores
constexpr int kSmem =
    1024 + kRingBytes + 2 * kStages * 8 + (kBM + 2 * kBN) * 4;
static_assert(kBM * kLdc * 4 <= kRingBytes, "staged tile must fit the ring");

struct Epilogue {
  const float* x_scale;  // (M)
  const float* w_scale;  // (N)
  const float* bias;     // (N) or null
  const void* residual;  // (M, N) contiguous, or null
  int res_f32;
  int ws_first;
  float q_fold;
  int n_fold;
  int round_mid;
  float out_mult;
  int act;       // 0 none, 1 QuickGELU, 2 erf GELU, 3 tanh GELU
  int out_kind;  // 0 bf16, 1 float32, 2 raw int32
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogue of one element up to (not including) the residual. xs is
// x_scale[m]; ca and cb the column factors: w_scale[n] (* c[n] when
// ws_first) and bias[n] (* c[n] when ws_first, 0 without a bias).
__device__ __forceinline__ float epilogue(int acc, float xs, float ca,
                                          float cb, const Epilogue& e) {
  const float a = __int2float_rn(acc);
  float v = e.ws_first ? __fmul_rn(__fmul_rn(a, ca), xs)
                       : __fmul_rn(__fmul_rn(a, xs), ca);
  if (e.round_mid) v = bf16_round(v);
  if (e.bias != nullptr) v = __fadd_rn(v, cb);
  if (e.out_mult != 1.f) v = __fmul_rn(v, e.out_mult);
  if (e.act == 1) {
    // __frcp_rn(x) is 1 / x correctly rounded, as __fdiv_rn(1, x)
    v = __fmul_rn(v, __frcp_rn(__fadd_rn(1.f, expf(-__fmul_rn(1.702f, v)))));
  } else if (e.act == 2) {
    v = __fmul_rn(__fmul_rn(0.5f, v),
                  __fadd_rn(1.f, erff(__fmul_rn(v, 0.70710678118654752f))));
  } else if (e.act == 3) {
    const float u = __fmul_rn(
        0.7978845608028654f,
        __fadd_rn(v, __fmul_rn(0.044715f, __fmul_rn(__fmul_rn(v, v), v))));
    v = __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, tanhf(u)));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_w,
                     void* __restrict__ out, int M, int N, int K,
                     Epilogue e) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRingBytes);
  uint64_t* empty = full + kStages;
  float* s_xs = reinterpret_cast<float*>(empty + kStages);
  float* s_ca = s_xs + kBM;
  float* s_cb = s_ca + kBN;

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kt_n = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);
    }
    sm90::mbar_fence_init();
  }
  // the epilogue's row and column factors, once per tile
  if (tid < kBN) {
    const int n = n0 + tid;
    float ca = 0.f, cb = 0.f;
    if (n < N) {
      const float c = n < e.n_fold ? e.q_fold : 1.f;
      ca = e.ws_first ? __fmul_rn(e.w_scale[n], c) : e.w_scale[n];
      if (e.bias != nullptr)
        cb = e.ws_first ? __fmul_rn(e.bias[n], c) : e.bias[n];
    }
    s_ca[tid] = ca;
    s_cb[tid] = cb;
  }
  if (tid < kBM) s_xs[tid] = m0 + tid < M ? e.x_scale[m0 + tid] : 0.f;
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer warp: one thread issues
    if (lane == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % kStages;
        sm90::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        uint8_t* st = ring + s * kStageBytes;
        sm90::mbar_arrive_tx(&full[s], kStageBytes);
        sm90::tma_load_2d(st, &tm_a, &full[s], kt * kBK, m0);
        sm90::tma_load_2d(st + kABytes, &tm_w, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  // consumer warpgroups: rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp >> 2;
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % kStages;
    sm90::mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* sa = ring + s * kStageBytes + wg * 64 * kBK;
    const uint8_t* sw = ring + s * kStageBytes + kABytes;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const uint64_t da = sm90::desc_sw128(sa + kk * 32, 16, 1024);
      const uint64_t dw = sm90::desc_sw128(sw + kk * 32, 16, 1024);
      sm90::wgmma_s8_m64n128k32(acc, da, dw, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the previous stage's products have retired
    sm90::fence_regs(acc);
    if (kt > 0 && lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::bar_sync(1, kConsumers);  // no product reads the ring any more

  // accumulators -> shared int32 rows. Element i of the wgmma tile sits at
  // row g + 8 * ((i >> 1) & 1) of the warp's 16, column 8 * (i >> 2) + 2t +
  // (i & 1); each thread stores its pairs as int2.
  int* staged = reinterpret_cast<int*>(ring);
  {
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(&staged[(r0 + 8 * h) * kLdc + 8 * j + c0]) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  sm90::bar_sync(1, kConsumers);

  // epilogue and stores: a 4-column group a thread, a warp on 128 contiguous
  // columns of one row
  constexpr int kGroups = kBN / 4;
  for (int u = tid; u < kBM * kGroups; u += kConsumers) {
    const int r = u / kGroups, c = (u % kGroups) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;  // N is a multiple of 8: all 4 or none
    const int4 a = *reinterpret_cast<const int4*>(&staged[r * kLdc + c]);
    const size_t i = (size_t)m * N + n;
    if (e.out_kind == 2) {
      *reinterpret_cast<int4*>(static_cast<int*>(out) + i) = a;
      continue;
    }
    const float xs = s_xs[r];
    const float4 ca = *reinterpret_cast<const float4*>(&s_ca[c]);
    const float4 cb = *reinterpret_cast<const float4*>(&s_cb[c]);
    float v[4] = {epilogue(a.x, xs, ca.x, cb.x, e),
                  epilogue(a.y, xs, ca.y, cb.y, e),
                  epilogue(a.z, xs, ca.z, cb.z, e),
                  epilogue(a.w, xs, ca.w, cb.w, e)};
    if (e.residual != nullptr) {
      float res[4];
      if (e.res_f32) {
        const float4 t =
            *reinterpret_cast<const float4*>(static_cast<const float*>(
                                                 e.residual) + i);
        res[0] = t.x, res[1] = t.y, res[2] = t.z, res[3] = t.w;
      } else {
        const uint2 t = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(e.residual) + i);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
        res[0] = __low2float(lo), res[1] = __high2float(lo);
        res[2] = __low2float(hi), res[3] = __high2float(hi);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __fadd_rn(v[q], res[q]);
    }
    if (e.out_kind == 1) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + i) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 t;
      t.x = *reinterpret_cast<const uint32_t*>(&lo);
      t.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) = t;
    }
  }
}

}  // namespace

// A: (M, K) int8, row stride lda (a multiple of 16), 16-byte aligned. Wt:
// (N, K) int8 contiguous, 16-byte aligned. x_scale (M), w_scale (N), bias
// (N) float32; residual (M, N) contiguous bf16 or float32 (res_f32) with a
// 16-byte aligned base, or null. out: (M, N) contiguous, bf16 / float32 /
// int32 by out_kind. K a multiple of 64, N of 8. Returns cudaError_t.
extern "C" int lhrs_int8_gemm(const void* A, long long lda, const void* Wt,
                              const void* x_scale, const void* w_scale,
                              const void* bias, const void* residual,
                              int res_f32, int ws_first, float q_fold,
                              int n_fold, int round_mid, float out_mult,
                              int act, int out_kind, void* out, int M, int N,
                              int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 64 || N % 8 || lda % 16 || lda < K ||
      act < 0 || act > 3 || out_kind < 0 || out_kind > 2 ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  Epilogue e;
  e.x_scale = static_cast<const float*>(x_scale);
  e.w_scale = static_cast<const float*>(w_scale);
  e.bias = static_cast<const float*>(bias);
  e.residual = residual;
  e.res_f32 = res_f32;
  e.ws_first = ws_first;
  e.q_fold = q_fold;
  e.n_fold = n_fold;
  e.round_mid = round_mid;
  e.out_mult = out_mult;
  e.act = act;
  e.out_kind = out_kind;
  // TMA boxes: 128 bytes of K by 128 rows of A / of the weight
  CUtensorMap tm_a, tm_w;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_strides[1] = {(cuuint64_t)lda};
  const cuuint32_t a_box[2] = {kBK, kBM};
  const cuuint64_t w_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t w_strides[1] = {(cuuint64_t)K};
  const cuuint32_t w_box[2] = {kBK, kBN};
  if (!sm90::make_tensor_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, A,
                             a_dims, a_strides, a_box) ||
      !sm90::make_tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, Wt,
                             w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(tm_a, tm_w, out, M,
                                                          N, K, e);
  return (int)cudaGetLastError();
}
