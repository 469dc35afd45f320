// Kernel A: float32 LayerNorm (or none) + symmetric per-row int8
// quantization, for Hopper (sm_90a).
//
// Replaces the `_ln_f32` + `_quant_act` stages inside the Pallas TPU kernels
// of the W8A8 vision tower: `_vit_block_kernel` / `_vit_block_grouped_kernel`
// (lhrs_bot_tpu/ops/vit_block.py:111, :132; helpers :95-108), the split
// form's `_vit_qkv_kernel` (:319) and `_vit_post_kernel` (:338), and
// `_perceiver_block_kernel` (lhrs_bot_tpu/ops/perceiver_block.py:53;
// helpers :41-50). Also `quantize_activation` (lhrs_bot_tpu/ops/quant.py:111)
// in quantize-only mode: the int8 cache's new K/V rows. Per row of width W:
//   LayerNorm mode: mu = mean(x); var = mean((x - mu)^2);
//                   h = (x - mu) * rsqrt(var + eps) * gamma + beta
//   quantize-only:  h = x
//   then amax = max|h|, s = amax / 127 (1 where amax == 0),
//   q = clip(round_half_even(h / s), -127, 127).
// The quotient is rounded as an IEEE division is (rowquant.cuh), not a
// multiply by a reciprocal, and the codes round half to even as jnp.round
// does, so the quantize-only mode is bit-identical to its plain version.
//
// What bounds it on the H100: device-memory bandwidth where the work per
// element is small. It reads W elements (2 or 4 bytes) and writes W bytes
// + one float per row: at the ViT's 16448 x 1024 bf16 rows 50 MB, 15 us at
// 3.35 TB/s. The LayerNorm adds three dependent row reductions and about a
// dozen float32 operations an element, and that arithmetic, not the
// bytes, sets its time (LN1 reads 40% of its bound, the quantize-only
// pass at the same shape 69%).
//
// Design. The row lives in registers: a group of `lanes` threads owns a
// row, each lane 16-element chunks of it (chunk j of the row goes to lane
// j % lanes, so adjacent lanes read adjacent addresses), loaded as 16-byte
// words (two for bf16, four for float32) and held as loaded, converted to
// float32 where used; the codes go out as one 16-byte word a chunk. The
// row is read from device memory once and nothing is staged in shared
// memory. The group's width is planned from W by `ops/ln_quant.py`
// `row_plan` and passed in: 8 lanes for the KV rows (W = 128, 32 rows a
// CTA), one warp for W <= 1024 (8 rows a CTA), 128 to 512 threads for the
// 4096-wide float32 rows and single rows of 4096 and 11008 (measured: at
// LN1, 16 lanes a row take 8% longer than 32, 64 lanes 15%, 128 lanes 78%).
// A reduction is a butterfly of warp shuffles inside the group; only a
// group of several warps exchanges its warps' partials, once per
// reduction, through a slot of shared memory of its own (one barrier, no
// second one: no slot is reused). The LayerNorm's output is held in
// registers between the amax and the codes; gamma and beta are read four
// at a time. A CTA holds 256 / lanes rows (at least one), so M = 16448
// rows of 1024 give 2,056 CTAs for 132 SMs. Lanes past the row's end, and
// rows past M, load zeros and store nothing; a chunk that the row's end
// cuts is loaded and stored element by element, and codes go out element
// by element where W is not a multiple of 16. Widths up to 512 x 4 x 16 =
// 32768 fit (up to four chunks a lane). The quotient h / s is
// `rowquant.cuh`'s, the IEEE quotient's bits without a division an
// element. The float32 products are written with __fmul_rn / __fadd_rn so
// the compiler cannot contract them into FMAs that the plain version does
// not do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rowquant.cuh"

namespace {

constexpr int kVec = 16;          // elements a lane takes at a time
constexpr int kMaxLanes = 512;    // threads of the widest row group
constexpr int kMaxChunks = 4;     // chunks a lane holds
constexpr int kMinThreads = 256;  // a CTA of narrow groups holds 256 / lanes

__device__ __forceinline__ float combine(float a, float b, bool is_max) {
  return is_max ? fmaxf(a, b) : a + b;
}

// The reduction of v over the lanes of one row group. Groups of up to 32
// lanes are aligned parts of a warp: shuffles only. Wider groups add their
// warps' partials, read from `red` (a slot used by this reduction alone) in
// one fixed order.
__device__ __forceinline__ float group_reduce(float v, bool is_max,
                                              int lanes, float* red) {
  const int width = lanes < 32 ? lanes : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < width) v = combine(v, __shfl_xor_sync(0xffffffffu, v, o), is_max);
  if (lanes <= 32) return v;
  const int warp = threadIdx.x >> 5, warps = lanes >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const float* mine = red + (warp / warps) * warps;
  v = mine[0];
  for (int w = 1; w < warps; ++w) v = combine(v, mine[w], is_max);
  return v;
}

// 32-bit words a 16-element chunk takes in registers: the row is held as
// it was loaded (bf16 pairs or float32), converted where it is used
template <bool kF32In>
constexpr int kWords = kF32In ? kVec : kVec / 2;

template <bool kF32In>
__device__ __forceinline__ void load_chunk(const void* row, int col, int W,
                                           uint32_t (&raw)[kWords<kF32In>]) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(
      static_cast<const char*>(row) + (size_t)col * (kF32In ? 4 : 2));
  if (col + kVec <= W) {
#pragma unroll
    for (int i = 0; i < kWords<kF32In> / 4; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      raw[4 * i] = u.x;
      raw[4 * i + 1] = u.y;
      raw[4 * i + 2] = u.z;
      raw[4 * i + 3] = u.w;
    }
  } else if (kF32In) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) raw[i] = col + i < W ? __ldg(p + i) : 0u;
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const uint32_t lo = col + 2 * i < W ? __ldg(h + 2 * i) : 0u;
      const uint32_t hi = col + 2 * i + 1 < W ? __ldg(h + 2 * i + 1) : 0u;
      raw[i] = lo | hi << 16;
    }
  }
}

// element i of a chunk as float32 (a bf16 pair's lower half comes first)
template <bool kF32In>
__device__ __forceinline__ float elem(const uint32_t (&raw)[kWords<kF32In>],
                                      int i) {
  if (kF32In) return __uint_as_float(raw[i]);
  const uint32_t w = raw[i >> 1];
  return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
}

// 4 gamma / beta values (zeros past the row's end); `vec`: 16-byte aligned
// and inside the row
__device__ __forceinline__ void load_affine4(const float* __restrict__ p,
                                             int col, int W, bool vec,
                                             float (&v)[4]) {
  if (vec) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p + col));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = col + i < W ? __ldg(p + col + i) : 0.f;
  }
}

template <bool kF32In, int kChunks, bool kLN>
__global__ void __launch_bounds__(kMaxLanes,
                                  (kChunks * kWords<kF32In> <= 16 ? 2 : 1))
    ln_quant_kernel(const void* __restrict__ x, long long x_stride,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, int8_t* __restrict__ q,
                    float* __restrict__ s, int M, int W, int lanes,
                    float eps) {
  constexpr int kW = kWords<kF32In>;
  __shared__ float red[3][kMaxLanes / 32];
  const int lane = threadIdx.x & (lanes - 1);
  const int rows = blockDim.x / lanes, group = threadIdx.x / lanes;
  const bool vec_gb = kLN && ((reinterpret_cast<uintptr_t>(gamma) |
                               reinterpret_cast<uintptr_t>(beta)) & 15) == 0;
  const long long r = (long long)blockIdx.x * rows + group;
  // Launched as a programmatic dependent of the kernel before it on the
  // stream, the CTA may start while that kernel finishes: wait for it
  // before reading x or writing anything.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  uint32_t raw[kChunks][kW];  // this lane's chunks, zeros past M and W
  const void* row = static_cast<const char*>(x) +
                    (r < M ? r : 0) * x_stride * (kF32In ? 4 : 2);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (c * lanes + lane) * kVec;
    if (r < M && col < W) {
      load_chunk<kF32In>(row, col, W, raw[c]);
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i) raw[c][i] = 0u;  // reads as 0.0
    }
  }
  // the next kernel on the stream may start its launch now
  asm volatile("griddepcontrol.launch_dependents;");

  // h = the LayerNorm of x, or x; zeros past the row's end. The
  // LayerNorm converts the row to float32 once and forms h in place (held
  // for the codes); without it h is x, converted where it is used. A chunk
  // the row's end does not cut skips the per-element masks.
  float hv[kLN ? kChunks : 1][kVec];
  float amax = 0.f;
  if (kLN) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        hv[c][i] = elem<kF32In>(raw[c], i);
        acc += hv[c][i];
      }
    const float mu =
        __fdiv_rn(group_reduce(acc, false, lanes, red[0]), (float)W);
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * lanes + lane) * kVec;
      if (col + kVec <= W) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = __fsub_rn(hv[c][i], mu);
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float d = col + i < W ? __fsub_rn(hv[c][i], mu) : 0.f;
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      }
    }
    const float var = __fdiv_rn(group_reduce(sq, false, lanes, red[1]),
                                (float)W);
    const float rs = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * lanes + lane) * kVec;
      if (col >= W) continue;  // hv is 0 there and is not stored
      const bool full = col + kVec <= W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float g[4], b[4];
        const bool vec = vec_gb && (full || col + 4 * j + 4 <= W);
        load_affine4(gamma, col + 4 * j, W, vec, g);
        load_affine4(beta, col + 4 * j, W, vec, b);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float& h = hv[c][4 * j + i];
          h = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(h, mu), rs), g[i]),
                        b[i]);
          if (!full && col + 4 * j + i >= W) h = 0.f;
          amax = fmaxf(amax, fabsf(h));
        }
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        amax = fmaxf(amax, fabsf(elem<kF32In>(raw[c], i)));
  }
  amax = group_reduce(amax, true, lanes, red[kLN ? 2 : 0]);
  if (r < M) {
    const RowScale sc = row_scale(amax);
    int8_t* qrow = q + r * W;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = (c * lanes + lane) * kVec;
      if (col >= W) continue;
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = kLN ? hv[kLN ? c : 0][4 * j + i]
                     : elem<kF32In>(raw[c], 4 * j + i);
        o[j] = row_codes4(h, sc);
      }
      if (W % kVec == 0) {  // a 16-byte aligned word of codes
        *reinterpret_cast<uint4*>(qrow + col) =
            make_uint4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          if (col + i < W)
            qrow[col + i] = static_cast<int8_t>(o[i / 4] >> (8 * (i % 4)));
      }
    }
    if (lane == 0) s[r] = sc.s;
  }
}

template <bool kF32In, bool kLN, int kChunks>
int launch_one(long long ctas, int threads, cudaStream_t st, const void* x,
               long long x_stride, const float* g, const float* b, int8_t* q,
               float* s, int M, int W, int lanes, float eps) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, ln_quant_kernel<kF32In, kChunks, kLN>, x,
                         x_stride, g, b, q, s, M, W, lanes, eps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <bool kF32In, bool kLN>
int launch(int chunks, long long ctas, int threads, cudaStream_t st,
           const void* x, long long x_stride, const float* g, const float* b,
           int8_t* q, float* s, int M, int W, int lanes, float eps) {
  switch (chunks) {
#define LNQ_CASE(n)                                                         \
  case n:                                                                   \
    return launch_one<kF32In, kLN, n>(ctas, threads, st, x, x_stride, g, b, \
                                      q, s, M, W, lanes, eps);
    LNQ_CASE(1) LNQ_CASE(2) LNQ_CASE(3) LNQ_CASE(4)
#undef LNQ_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: M rows of W elements (bf16, or float32 when x_f32), row stride x_stride
// elements (a multiple of 8), unit column stride, 16-byte aligned base.
// gamma/beta: float32 (W) for the LayerNorm mode, both null for
// quantize-only. q: (M, W) int8 contiguous; s: (M) float32. lanes / chunks:
// the row group's threads (a power of two from 8 to 512) and the 16-element
// chunks each lane holds (1 to 4), with lanes * chunks * 16 >= W, from
// `row_plan`. Returns cudaError_t.
extern "C" int lhrs_ln_quant(const void* x, int x_f32, long long x_stride,
                             const void* gamma, const void* beta, void* q,
                             void* s, int M, int W, int lanes, int chunks,
                             float eps, void* stream) {
  if (M <= 0 || W <= 0 || (gamma == nullptr) != (beta == nullptr) ||
      lanes < 8 || lanes > kMaxLanes || (lanes & (lanes - 1)) ||
      chunks < 1 || chunks > kMaxChunks ||
      (long long)lanes * chunks * kVec < W ||
      (long long)lanes * (chunks - 1) * kVec >= W || x_stride < W ||
      x_stride % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  const int threads = lanes > kMinThreads ? lanes : kMinThreads;
  const int rows = threads / lanes;
  const long long ctas = ((long long)M + rows - 1) / rows;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  if (x_f32 && g)
    return launch<true, true>(chunks, ctas, threads, st, x, x_stride, g, b,
                              qp, sp, M, W, lanes, eps);
  if (x_f32)
    return launch<true, false>(chunks, ctas, threads, st, x, x_stride, g, b,
                               qp, sp, M, W, lanes, eps);
  if (g)
    return launch<false, true>(chunks, ctas, threads, st, x, x_stride, g, b,
                               qp, sp, M, W, lanes, eps);
  return launch<false, false>(chunks, ctas, threads, st, x, x_stride, g, b,
                              qp, sp, M, W, lanes, eps);
}
