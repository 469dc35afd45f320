// Chained int8 (and bf16) product probe, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels that benchmarks/int8_probe.py runs
// through `_pl_repeat` (:95, pallas_call at :101): `_k_int8` (:117),
// `_k_int8_req` (:131), `_k_int8_lhsT` (:147), `_k_int8_alt` (:161) and
// `_k_bf16` (:189). Grid step i takes its own (M, K) activation block of xg
// and the NDOTS resident (K, N) weights and writes acc[:8, :128] + sum(acc)
// as its (8, 128) output, where acc is
//   variant 0 (int8):    sum_i x . w_i, int32;
//   variant 1 (int8_req): the chain h <- requant(h . w_i) (f = acc * (1/127),
//                        per-row s = amax / 127 or 1, h = clip(round(f / s),
//                        +-127)), acc the last product;
//   variant 2 (int8_lhsT): sum_i w_i^T . x^T, an (N, M) int32 accumulator;
//   variant 3 (int8_alt): the requantized chain with the even products in
//                        the transposed form w^T . h^T (requantized per
//                        column, i.e. per row m of h) and the odd ones in
//                        the plain form;
//   variant 4 (bf16):    sum_i x . w_i in float32 of bf16 operands.
// Integer sums wrap modulo 2^32, as JAX's int32 sum does, so any order of
// the partial sums gives the same bits.
//
// What bounds it on the H100: operations (2 M N K NDOTS a grid step, at the
// 1,979 TOP/s int8 / 989 TFLOP/s bf16 dense peaks), since the weights
// (NDOTS K N bytes) stay in the 50 MB L2 across CTAs.
//
// Design: every requantization is local to a row m (the alt variant's
// per-column step is per m too), so one CTA owns 32 rows of one grid step's
// activation block, kept in shared memory, and runs the whole chain on
// them. A CTA of 8 warps computes 128 output columns at a time, 16 a warp,
// with mma.sync m16n8k32 (s8 -> s32) or m16n8k16 (bf16 -> f32), whose
// fragments take the same bytes; the weights are read as (N, K) rows, K
// contiguous (the transposed view of a contiguous (N, K) tensor, as kernel
// B reads them), in 64-byte K slices double-buffered with cp.async. The
// transposed form swaps the operands: the weight tile is the A fragment
// (16 n rows), the activations the B fragment (8 m columns). The
// accumulating variants keep the 128 columns' sums in registers across all
// NDOTS products; the chained ones store each product's int32 rows in
// shared memory (32 x N) until the rows are requantized into the next
// activation. Each CTA adds its part of sum(acc) to the grid step's total
// with one atomic; a second kernel adds the total to the (8, 128) window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;       // rows m of a CTA
constexpr int kBN = 128;        // output columns per pass, 16 a warp
constexpr int kBK = 64;         // bytes of K per staged weight tile
constexpr int kLdw = kBK + 16;  // padded weight tile row, bytes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum { kInt8 = 0, kInt8Req = 1, kInt8LhsT = 2, kInt8Alt = 3, kBf16 = 4 };

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Weight rows [n0, n0 + 128) x bytes [k0, k0 + 64) of a (N, Kb) matrix into
// a padded shared tile, 16 bytes a copy.
__device__ __forceinline__ void load_w(unsigned char* dst,
                                       const unsigned char* w, int Kb, int n0,
                                       int k0) {
#pragma unroll
  for (int i = threadIdx.x; i < kBN * (kBK / 16); i += kThreads) {
    const int r = i / (kBK / 16), c = i % (kBK / 16);
    const uint32_t s =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * kLdw + c * 16));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(w + (size_t)(n0 + r) * Kb + k0 + c * 16));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc += the products of the CTA's 32 activation rows h (row stride ldh
// bytes) with weight rows [n0, n0 + 128) of w (N, Kb). The warp's 16
// columns: plain form, acc[(mi * 2 + ni) * 4 + e] is row mi * 16 + g +
// 8 (e >> 1), column 16 warp + 8 ni + 2 t + (e & 1); transposed form,
// acc[mj * 4 + e] is column 16 warp + g + 8 (e >> 1), row 8 mj + 2 t +
// (e & 1).
template <typename Acc, bool Trans>
__device__ void chunk_products(Acc acc[16], const unsigned char* h, int ldh,
                               const unsigned char* w, int Kb, int n0,
                               unsigned char* sw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nk = Kb / kBK;
  load_w(sw, w, Kb, n0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    unsigned char* cur = sw + (kt & 1) * kBN * kLdw;
    if (kt + 1 < nk) {
      load_w(sw + ((kt + 1) & 1) * kBN * kLdw, w, Kb, n0, (kt + 1) * kBK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      const int hk = kt * kBK + kk + 4 * t;
      if constexpr (!Trans) {
        uint32_t a[2][4], b[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const unsigned char* p = h + (mi * 16 + g) * ldh + hk;
          a[mi][0] = lds32(p);
          a[mi][1] = lds32(p + 8 * ldh);
          a[mi][2] = lds32(p + 16);
          a[mi][3] = lds32(p + 8 * ldh + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const unsigned char* p = cur + (warp * 16 + ni * 8 + g) * kLdw +
                                   kk + 4 * t;
          b[ni][0] = lds32(p);
          b[ni][1] = lds32(p + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            mma(acc + (mi * 2 + ni) * 4, a[mi], b[ni]);
      } else {
        uint32_t a[4], b[4][2];
        const unsigned char* p = cur + (warp * 16 + g) * kLdw + kk + 4 * t;
        a[0] = lds32(p);
        a[1] = lds32(p + 8 * kLdw);
        a[2] = lds32(p + 16);
        a[3] = lds32(p + 8 * kLdw + 16);
#pragma unroll
        for (int mj = 0; mj < 4; ++mj) {
          const unsigned char* q = h + (mj * 8 + g) * ldh + hk;
          b[mj][0] = lds32(q);
          b[mj][1] = lds32(q + 16);
        }
#pragma unroll
        for (int mj = 0; mj < 4; ++mj) mma(acc + mj * 4, a, b[mj]);
      }
    }
    __syncthreads();  // the stage is refilled two iterations on
  }
}

// Row m (of the CTA's 32) and column n (of the pass's 128) of acc[i].
template <bool Trans>
__device__ __forceinline__ void coords(int i, int& m, int& n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, e = i & 3;
  if (!Trans) {
    const int mi = i >> 3, ni = (i >> 2) & 1;
    m = mi * 16 + g + 8 * (e >> 1);
    n = warp * 16 + ni * 8 + 2 * t + (e & 1);
  } else {
    m = (i >> 2) * 8 + 2 * t + (e & 1);
    n = warp * 16 + g + 8 * (e >> 1);
  }
}

__device__ __forceinline__ unsigned add_wrap(unsigned a, unsigned b) {
  return a + b;
}
__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }

// The CTA's sum of `part` (wrapping for integers) into *total.
template <typename Sum>
__device__ void add_to_total(Sum part, Sum* total) {
  __shared__ Sum red[kWarps];
#pragma unroll
  for (int o = 16; o; o >>= 1)
    part = add_wrap(part, __shfl_xor_sync(0xffffffffu, part, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    Sum s = red[0];
    for (int i = 1; i < kWarps; ++i) s = add_wrap(s, red[i]);
    atomicAdd(total, s);
  }
}

// Window element (r, c) < (8, 128) of the grid step's output: plain form
// (m, n) = (r, c); transposed (lhsT) form (n, m) = (r, c).
template <typename Out, typename Acc>
__device__ __forceinline__ void window(Out* win, int gm, int gn, bool lhsT,
                                       Acc v) {
  const int r = lhsT ? gn : gm, c = lhsT ? gm : gn;
  if (r < 8 && c < 128) win[r * 128 + c] = (Out)v;
}

// One grid step of the accumulating variants (int8, int8_lhsT, bf16).
template <typename Acc, typename Sum, bool Trans>
__device__ void accumulate(const unsigned char* h, int ldh,
                           const unsigned char* w, Sum* win, Sum* total,
                           int m0, int N, int Kb, int ndots,
                           unsigned char* sw) {
  Sum part = 0;
  for (int n0 = 0; n0 < N; n0 += kBN) {
    Acc acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0;
    for (int d = 0; d < ndots; ++d)
      chunk_products<Acc, Trans>(acc, h, ldh, w + (size_t)d * N * Kb, Kb, n0,
                                 sw);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int m, n;
      coords<Trans>(i, m, n);
      part = add_wrap(part, (Sum)acc[i]);
      window(win, m0 + m, n0 + n, Trans, acc[i]);
    }
  }
  add_to_total(part, total);
}

// One grid step of the requantized chains (int8_req, int8_alt); K == N.
__device__ void chain(unsigned char* h, int ldh, const unsigned char* w,
                      unsigned* win, unsigned* total, int m0, int N,
                      int ndots, bool alt, unsigned char* sw, int* accs) {
  const float inv127 = (float)(1.0 / 127.0);
  for (int d = 0; d < ndots; ++d) {
    const bool trans = alt && d % 2 == 0;
    for (int n0 = 0; n0 < N; n0 += kBN) {
      int acc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0;
      const unsigned char* wd = w + (size_t)d * N * N;
      if (trans)
        chunk_products<int, true>(acc, h, ldh, wd, N, n0, sw);
      else
        chunk_products<int, false>(acc, h, ldh, wd, N, n0, sw);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        int m, n;
        if (trans)
          coords<true>(i, m, n);
        else
          coords<false>(i, m, n);
        accs[m * N + n0 + n] = acc[i];
      }
    }
    __syncthreads();
    if (d + 1 == ndots) break;
    // requantize each row into the next activation: 8 threads a row
    const int row = threadIdx.x >> 3, part = threadIdx.x & 7;
    const int* ar = accs + row * N;
    float amax = 0.f;
    for (int n = part; n < N; n += 8)
      amax = fmaxf(amax, fabsf(__fmul_rn(__int2float_rn(ar[n]), inv127)));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 4));
    const float s = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
    for (int n = part; n < N; n += 8) {
      const float f = __fmul_rn(__int2float_rn(ar[n]), inv127);
      const float qv = fminf(fmaxf(rintf(__fdiv_rn(f, s)), -127.f), 127.f);
      h[row * ldh + n] = (unsigned char)(int8_t)qv;
    }
    __syncthreads();
  }
  unsigned part = 0;
  for (int i = threadIdx.x; i < kRows * N; i += kThreads) {
    const int m = i / N, n = i - m * N;
    part += (unsigned)accs[i];
    window(win, m0 + m, n, false, (unsigned)accs[i]);
  }
  add_to_total(part, total);
}

// Dynamic shared memory: the CTA's activation rows, the two weight stages
// and, for the chains, the 32 x N int32 products.
__host__ __device__ __forceinline__ int ldh_of(int Kb) { return Kb + 16; }
__host__ __device__ __forceinline__ int smem_of(int Kb, int N, int chained) {
  return kRows * ldh_of(Kb) + 2 * kBN * kLdw + (chained ? kRows * N * 4 : 0);
}

__global__ void __launch_bounds__(kThreads)
    chain_kernel(const unsigned char* __restrict__ x,
                 const unsigned char* __restrict__ w, void* win, void* total,
                 int M, int N, int Kb, int ndots, int variant) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldh = ldh_of(Kb);
  unsigned char* h = smem;
  unsigned char* sw = smem + kRows * ldh;
  int* accs = reinterpret_cast<int*>(sw + 2 * kBN * kLdw);
  const int gi = blockIdx.y, m0 = blockIdx.x * kRows;

  const unsigned char* xs = x + ((size_t)gi * M + m0) * Kb;
  for (int i = threadIdx.x; i < kRows * (Kb / 16); i += kThreads) {
    const int r = i / (Kb / 16), c = i % (Kb / 16);
    *reinterpret_cast<uint4*>(h + r * ldh + c * 16) =
        *reinterpret_cast<const uint4*>(xs + (size_t)r * Kb + c * 16);
  }
  __syncthreads();
  unsigned* wi = static_cast<unsigned*>(win) + (size_t)gi * 8 * 128;
  unsigned* ti = static_cast<unsigned*>(total) + gi;
  switch (variant) {
    case kInt8:
      accumulate<int, unsigned, false>(h, ldh, w, wi, ti, m0, N, Kb, ndots,
                                       sw);
      break;
    case kInt8LhsT:
      accumulate<int, unsigned, true>(h, ldh, w, wi, ti, m0, N, Kb, ndots,
                                      sw);
      break;
    case kBf16:
      accumulate<float, float, false>(
          h, ldh, w, static_cast<float*>(win) + (size_t)gi * 8 * 128,
          static_cast<float*>(total) + gi, m0, N, Kb, ndots, sw);
      break;
    default:
      chain(h, ldh, w, wi, ti, m0, N, ndots, variant == kInt8Alt, sw, accs);
  }
}

// out = window + the grid step's total, wrapping for the integer variants.
__global__ void chain_finish(void* win, const void* total, int g, int bf16) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g * 8 * 128) return;
  if (bf16)
    static_cast<float*>(win)[i] += static_cast<const float*>(total)[i >> 10];
  else
    static_cast<unsigned*>(win)[i] +=
        static_cast<const unsigned*>(total)[i >> 10];
}

}  // namespace

// x (g, M, K) int8 or bf16; w (ndots, N, K) of its dtype (the transposed
// storage of the (ndots, K, N) weights); win (g, 8, 128) int32 / float32
// output; total (g,) zeroed scratch of the same type; Kb = K bytes. M % 32,
// N % 128, Kb % 64 == 0; the window needs M >= 8 (lhsT: M >= 128) and
// N >= 128 (lhsT: N >= 8); the chains need K == N. Returns cudaError_t.
extern "C" int lhrs_int8_chain(const void* x, const void* w, void* win,
                               void* total, int g, int M, int N, int Kb,
                               int ndots, int variant, void* stream) {
  if (g <= 0 || g > 65535 || M <= 0 || M % kRows || N <= 0 || N % kBN ||
      Kb <= 0 || Kb % kBK || ndots <= 0 || variant < 0 || variant > 4)
    return (int)cudaErrorInvalidValue;
  const int chained = variant == kInt8Req || variant == kInt8Alt;
  if (chained && Kb != N) return (int)cudaErrorInvalidValue;
  const int smem = smem_of(Kb, N, chained);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  chain_kernel<<<dim3(M / kRows, g), kThreads, smem, st>>>(
      static_cast<const unsigned char*>(x), static_cast<const unsigned char*>(w),
      win, total, M, N, Kb, ndots, variant);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = g * 8 * 128;
  chain_finish<<<(n + 255) / 256, 256, 0, st>>>(win, total, g,
                                                variant == kBf16);
  return (int)cudaGetLastError();
}
