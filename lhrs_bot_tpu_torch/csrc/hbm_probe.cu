// Device-memory read probe, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of benchmarks/hbm_peak_probe.py:
// `pallas_reader` (:41, pallas_call at :68) and `pallas_dual_reader` (:83,
// :116), which stream one or two arrays from HBM through double-buffered
// block copies to measure the read rate the chip can reach. On the TPU the
// DMA of whole blocks does the reading and a max over each block's first
// row only keeps the loop live; here a load whose value feeds nothing is
// removed by the compiler, so every element goes into the result: the max
// of x, or max(x) + max(y) for two arrays, as float32.
//
// What bounds it on the H100: bytes, by design (3.35 TB/s on the data
// sheet); one max per element is far below any compute limit.
//
// Design: a grid of `ctas` CTAs of 256 threads strides over the 16-byte
// words of the array(s); each thread issues `unroll` 16-byte loads (of x,
// and as many of y) before it reduces any, so 16 * unroll bytes per array
// are in flight per thread. int8 words reduce with the byte-wise signed
// max (__vmaxs4), bf16 words with __hmax2. Each CTA writes its two maxima
// to `partial`; a second kernel of one CTA reduces them into out[0]. The
// wrapper's sweep over CTAs per SM and unroll stands in for the TPU
// probe's block_rows / slots, which are its pipelining and not its result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Running max of one stream of 16-byte words, in the word's own format.
template <bool Bf16>
struct MaxAcc;

template <>
struct MaxAcc<false> {  // int8: four words of byte-wise maxima
  uint32_t m[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};
  __device__ __forceinline__ void add(const uint4& w) {
    m[0] = __vmaxs4(m[0], w.x);
    m[1] = __vmaxs4(m[1], w.y);
    m[2] = __vmaxs4(m[2], w.z);
    m[3] = __vmaxs4(m[3], w.w);
  }
  __device__ __forceinline__ float value() const {
    int best = -128;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        best = max(best, (int)(int8_t)((m[i] >> (8 * b)) & 0xff));
    return (float)best;
  }
};

template <>
struct MaxAcc<true> {  // bf16: four pairs of maxima
  __nv_bfloat162 m[4];
  __device__ MaxAcc() {
    const __nv_bfloat16 lo = __ushort_as_bfloat16((unsigned short)0xff80u);
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = __halves2bfloat162(lo, lo);
  }
  __device__ __forceinline__ void add(const uint4& w) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = __hmax2(m[i], p[i]);
  }
  __device__ __forceinline__ float value() const {
    float best = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      best = fmaxf(best, fmaxf(__low2float(m[i]), __high2float(m[i])));
    return best;
  }
};

__device__ __forceinline__ float cta_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = fmaxf(v, red[i]);
  return v;
}

template <bool Bf16, bool Dual, int Unroll>
__global__ void __launch_bounds__(kThreads)
    hbm_read_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
                    long long n16, float* __restrict__ partial) {
  __shared__ float red[kThreads / 32];
  MaxAcc<Bf16> ax, ay;
  const long long step = (long long)gridDim.x * kThreads * Unroll;
  for (long long base = (long long)blockIdx.x * kThreads * Unroll +
                        threadIdx.x;
       base < n16; base += step) {
    uint4 wx[Unroll], wy[Unroll];
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n16) {
        wx[u] = x[i];
        if (Dual) wy[u] = y[i];
      }
    }
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      if (base + (long long)u * kThreads < n16) {
        ax.add(wx[u]);
        if (Dual) ay.add(wy[u]);
      }
    }
  }
  const float mx = cta_max(ax.value(), red);
  const float my = Dual ? cta_max(ay.value(), red) : 0.f;
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = mx;
    partial[2 * blockIdx.x + 1] = my;
  }
}

__global__ void __launch_bounds__(kThreads)
    hbm_read_finish(const float* __restrict__ partial, int ctas, int dual,
                    float* __restrict__ out) {
  __shared__ float red[kThreads / 32];
  float mx = -INFINITY, my = -INFINITY;
  for (int i = threadIdx.x; i < ctas; i += kThreads) {
    mx = fmaxf(mx, partial[2 * i]);
    my = fmaxf(my, partial[2 * i + 1]);
  }
  mx = cta_max(mx, red);
  my = cta_max(my, red);
  if (threadIdx.x == 0) out[0] = dual ? mx + my : mx;
}

template <bool Bf16, bool Dual>
int launch(const uint4* x, const uint4* y, long long n16, int unroll,
           int ctas, float* partial, cudaStream_t st) {
  switch (unroll) {
    case 1:
      hbm_read_kernel<Bf16, Dual, 1><<<ctas, kThreads, 0, st>>>(x, y, n16,
                                                                partial);
      break;
    case 2:
      hbm_read_kernel<Bf16, Dual, 2><<<ctas, kThreads, 0, st>>>(x, y, n16,
                                                                partial);
      break;
    case 4:
      hbm_read_kernel<Bf16, Dual, 4><<<ctas, kThreads, 0, st>>>(x, y, n16,
                                                                partial);
      break;
    case 8:
      hbm_read_kernel<Bf16, Dual, 8><<<ctas, kThreads, 0, st>>>(x, y, n16,
                                                                partial);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x and (or null) y: n16 16-byte words each, int8 or (bf16 != 0) bf16,
// 16-byte aligned; unroll 1, 2, 4 or 8; ctas >= 1; partial holds 2 * ctas
// floats; out one float. Returns cudaError_t.
extern "C" int lhrs_hbm_read(const void* x, const void* y, long long n16,
                             int bf16, int unroll, int ctas, void* partial,
                             void* out, void* stream) {
  if (n16 <= 0 || ctas <= 0 || ctas > (1 << 20))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint4*>(x);
  const auto* yp = static_cast<const uint4*>(y);
  auto* pp = static_cast<float*>(partial);
  const bool dual = y != nullptr;
  int err;
  if (bf16)
    err = dual ? launch<true, true>(xp, yp, n16, unroll, ctas, pp, st)
               : launch<true, false>(xp, yp, n16, unroll, ctas, pp, st);
  else
    err = dual ? launch<false, true>(xp, yp, n16, unroll, ctas, pp, st)
               : launch<false, false>(xp, yp, n16, unroll, ctas, pp, st);
  if (err) return err;
  hbm_read_finish<<<1, kThreads, 0, st>>>(pp, ctas, dual ? 1 : 0,
                                          static_cast<float*>(out));
  return (int)cudaGetLastError();
}
