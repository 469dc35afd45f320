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
// and K, N of 1024-4096 the products are compute-bound (2*M*N*K int8 ops
// against M*K + N*K input bytes); at B = 1 (M = 257) the grid has too few
// CTAs to fill 132 SMs and launch/load latency dominates.
//
// Design: a CTA of 8 warps computes a 128 x 128 output tile; each warp owns
// 64 x 32 of it as 4 x 4 tiles of mma.sync.m16n8k32 (s8 x s8 -> s32), 64
// int32 accumulators a thread. A is (M, K) row-major; the weight is read as
// (N, K) row-major (K contiguous per output column, the layout the s8 B
// fragment wants: ldmatrix cannot transpose bytes), which the port keeps as
// the storage of every packed weight, the JAX (K, N) layout being its
// transposed view. 64-byte K slices of both tiles are double-buffered in
// shared memory with cp.async (16-byte chunks, rows past M or N
// zero-filled); rows are padded to 80 bytes so the fragment reads of a warp
// hit 32 distinct banks. Fragments are plain 32-bit shared loads. wgmma/TMA
// pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLds = kBK + 16;  // padded shared row, bytes
constexpr int kThreads = 256;   // 8 warps: 2 along M x 4 along N

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

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 128) x bytes [k0, k0 + 64) of a (rows, K) int8 matrix
// with row stride ld into a padded shared tile; rows past `rows` read row 0
// with a zero byte count, i.e. zeros.
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          long long ld, int row0, int rows,
                                          int k0) {
#pragma unroll
  for (int i = threadIdx.x; i < 128 * (kBK / 16); i += kThreads) {
    const int r = i / (kBK / 16), c = i % (kBK / 16);
    const bool ok = row0 + r < rows;
    const int8_t* g = src + (ok ? (size_t)(row0 + r) * ld : 0) + k0 + c * 16;
    cp_async16(dst + r * kLds + c * 16, g, ok);
  }
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float epilogue(int acc, int m, int n,
                                          const Epilogue& e, int N) {
  const float a = __int2float_rn(acc);
  const float c = n < e.n_fold ? e.q_fold : 1.f;
  float v;
  if (e.ws_first)
    v = __fmul_rn(__fmul_rn(a, __fmul_rn(e.w_scale[n], c)), e.x_scale[m]);
  else
    v = __fmul_rn(__fmul_rn(a, e.x_scale[m]), e.w_scale[n]);
  if (e.round_mid) v = bf16_round(v);
  if (e.bias != nullptr)
    v = __fadd_rn(v, e.ws_first ? __fmul_rn(e.bias[n], c) : e.bias[n]);
  if (e.out_mult != 1.f) v = __fmul_rn(v, e.out_mult);
  if (e.act == 1) {
    v = __fmul_rn(v, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, v)))));
  } else if (e.act == 2) {
    v = __fmul_rn(__fmul_rn(0.5f, v),
                  __fadd_rn(1.f, erff(__fmul_rn(v, 0.70710678118654752f))));
  } else if (e.act == 3) {
    const float u = __fmul_rn(
        0.7978845608028654f,
        __fadd_rn(v, __fmul_rn(0.044715f, __fmul_rn(__fmul_rn(v, v), v))));
    v = __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, tanhf(u)));
  }
  if (e.residual != nullptr) {
    const size_t i = (size_t)m * N + n;
    v = __fadd_rn(v, e.res_f32
                         ? static_cast<const float*>(e.residual)[i]
                         : __bfloat162float(static_cast<const __nv_bfloat16*>(
                               e.residual)[i]));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const int8_t* __restrict__ A, long long lda,
                     const int8_t* __restrict__ Wt, void* __restrict__ out,
                     int M, int N, int K, Epilogue e) {
  __shared__ __align__(16) int8_t sA[2][kBM * kLds];
  __shared__ __align__(16) int8_t sB[2][kBN * kLds];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int kt_n = K / kBK;
  load_tile(sA[0], A, lda, m0, M, 0);
  load_tile(sB[0], Wt, K, n0, N, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_n) {
      load_tile(sA[st ^ 1], A, lda, m0, M, (kt + 1) * kBK);
      load_tile(sB[st ^ 1], Wt, K, n0, N, (kt + 1) * kBK);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = sA[st] + (wm * 64 + mi * 16 + g) * kLds + kk + 4 * t;
        af[mi][0] = lds32(p);
        af[mi][1] = lds32(p + 8 * kLds);
        af[mi][2] = lds32(p + 16);
        af[mi][3] = lds32(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = sB[st] + (wn * 32 + ni * 8 + g) * kLds + kk + 4 * t;
        bf[ni][0] = lds32(p);
        bf[ni][1] = lds32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();  // the stage is refilled by the next iteration's loads
  }

  // Element e of tile (mi, ni) sits at row g + 8 * (e >> 1), column 2t +
  // (e & 1); the two columns of a row are stored together.
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn * 32 + ni * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
        if (m >= M) continue;
        const int c0 = acc[mi][ni][2 * h], c1 = acc[mi][ni][2 * h + 1];
        const size_t i = (size_t)m * N + n;
        if (e.out_kind == 2) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + i) =
              make_int2(c0, c1);
          continue;
        }
        const float v0 = epilogue(c0, m, n, e, N);
        const float v1 = epilogue(c1, m, n + 1, e, N);
        if (e.out_kind == 1)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + i) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// A: (M, K) int8, row stride lda (a multiple of 16), 16-byte aligned. Wt:
// (N, K) int8 contiguous. x_scale (M), w_scale (N), bias (N) float32;
// residual (M, N) contiguous bf16 or float32 (res_f32), or null. out: (M, N)
// contiguous, bf16 / float32 / int32 by out_kind. K a multiple of 64, N of
// 8. Returns cudaError_t.
extern "C" int lhrs_int8_gemm(const void* A, long long lda, const void* Wt,
                              const void* x_scale, const void* w_scale,
                              const void* bias, const void* residual,
                              int res_f32, int ws_first, float q_fold,
                              int n_fold, int round_mid, float out_mult,
                              int act, int out_kind, void* out, int M, int N,
                              int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8 || lda % 16 || lda < K ||
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
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(A), lda, static_cast<const int8_t*>(Wt), out,
      M, N, K, e);
  return (int)cudaGetLastError();
}
