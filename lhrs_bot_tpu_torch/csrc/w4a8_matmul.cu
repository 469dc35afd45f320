// W4A8 matmul for decode over one layer of a stacked halves-packed int4
// weight, for Hopper (sm_90a): one clustered launch a projection, which can
// quantize its own activation.
//
// Replaces the Pallas TPU kernel `_kernel` of `w4a8_matmul_stacked`
// (lhrs_bot_tpu/ops/w4_matmul.py:43, called at :94 through `w4a8_project`
// :145) and, in the fused mode, the `quantize_activation` that feeds it
// (lhrs_bot_tpu/ops/quant.py:111). Same semantics: out[b, n] =
// cast((acc[b, n] * w_scale[n]) * x_scale[b]) with the int32 accumulator
// acc = sum_r xlo[b, r] * lo(W[r, n]) + sum_r xhi[b, r] * hi(W[r, n]) over
// the layer's (K/2, N) int8 slice, whose low nibble holds weight row r and
// high nibble row K/2 + r. Two modes of one kernel (template flag kFused):
//   (a) pre-quantized: int8 halves xlo / xhi and float32 x_scale are given
//       (`w4a8_matmul_stacked`);
//   (b) fused: the bf16 or float32 activation x (B, K) is given, and the
//       kernel forms its per-row amax, s = amax / 127 (1 where amax is 0)
//       and codes clip(rint(x / s), +-127) with an IEEE division, as kernel
//       A's quantize-only mode does (`w4a8_project`).
// amax is order-free and the integer sums are exact, so both modes are
// bit-identical to the plain `quantize_activation` + `w4a8_matmul_plain`
// (lhrs_bot_tpu_torch/ops/w4_matmul.py), whatever the cluster size.
//
// What bounds it on the H100: device-memory bandwidth. At decode batch
// (B <= 8) each packed byte feeds 2 * B multiply-adds: at most 16 int8
// operations a byte, against the 590 a byte (1979 TOP/s over 3.35 TB/s)
// at which the int8 tensor cores would become the limit, so wgmma, whose
// tile is 64 rows of activations, would idle 56 of them and move no fewer
// bytes; the weight stream (K/2 * N bytes, 8.4-22.5 MB a call) is the
// cost, 2.5-6.7 us at 3.35 TB/s. A launch, a partial-sum round trip
// through device memory and a separate quantize launch are of that order,
// so the design keeps all three out.
//
// Design. A CTA of 8 warps owns 128 output columns; 8 lanes span them,
// each lane 16 adjacent columns, read as one 16-byte word per packed row,
// and a warp's 4 lane rows take 4 different 4-row groups, so a CTA takes
// 128 packed rows a step and each lane keeps three 4-row groups (64 bytes
// each; two at B > 4) of loads in flight in registers, a ring that
// rotates through unrolled slots. A 4x4 byte transpose (__byte_perm) turns
// 4 rows x 4 columns into 4 per-column words of 4 rows, and __dp4a
// multiplies them by the 4 matching int8 activations, which the CTA reads
// from shared memory. The nibbles are never sign-extended: byte
// (w << 4) & 0xF0 is 16 * lo and w & 0xF0 is 16 * hi as int8, so the
// accumulator holds 16 * acc (|16 * acc| < 2^28 at K = 11008) and one exact
// arithmetic shift recovers acc. The 4 lane rows meet by shuffles, the 8
// warps in shared memory. The register ring was measured against no TMA
// ring: at B = 1 it streams the extra 14.1 MB of 4096 -> 11008 over
// 4096 -> 4096 at 2.6 TB/s, and what separates the kernel from its bound
// is a floor of about 5 us a launch (a 0.5 MB weight at K = 256 takes
// 4.5-5.6 us), which a TMA ring would not remove.
//   K/2 is split across a thread-block cluster of C CTAs (C <= 8, along
// grid.y, chunks of whole 128-row steps, `ops/w4_matmul.py` `w4a8_plan`).
// The wrapper takes the largest C whose clusters all fit on the card at
// once (`pick_cluster` over cudaOccupancyMaxActiveClusters, which this
// file answers): a second wave of clusters costs a whole cluster's time.
// Both modes copy their chunk of the activation into shared memory with
// cp.async, every copy in flight at once. In the fused mode each CTA then
// forms its chunk's |x| max of each row (both halves), and after a cluster
// barrier reads its peers' maxima through distributed shared memory, all
// at once; then it forms the scale and its chunk's codes. The exchange is
// kept over a redundant read of the whole row by every CTA: the fused mode
// costs 0.7-1.3 us over mode (a) at B = 1 in all. After the dp4a loop each
// CTA's int32 sums sit in its shared memory; after a second cluster
// barrier each CTA adds, over distributed shared memory, every CTA's sums
// for its share of the outputs, applies the float32 epilogue and stores
// them; a last barrier keeps each CTA's shared memory alive until its
// peers have read it. No second kernel, no partial sums in device memory,
// no quantize launch. Activation rows go 8 to a cluster (grid.z), so a
// batch above 8 runs several clusters a column block.
//   The kernel is launched as a programmatic dependent of the one before
// it on the stream (cudaLaunchAttributeProgrammaticStreamSerialization):
// its CTAs may start, and put their weight loads in flight, while that
// kernel finishes; `griddepcontrol.wait` comes before anything it may
// have written is read or any output is written.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rowquant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLaneCols = 16;   // columns a lane: one 16-byte word a row
constexpr int kCols = 128;      // output columns a CTA: 8 lanes x 16
constexpr int kStepRows = 128;  // packed rows a CTA takes a step: 32 groups
// 4-row groups a lane keeps in flight: fewer where 8 rows' accumulators
// (8 x 16 registers) take the room
__host__ __device__ constexpr int depth_for(int nb) {
  return nb <= 4 ? 3 : 2;
}
constexpr int kMaxRows = 8;     // activation rows a cluster
constexpr int kMaxCluster = 8;
constexpr int kMaxChunk = 2048;  // packed rows a CTA
// fault: a planted error for the checks that must see it fail
constexpr int kFaultPeerAmax = 1;  // rank 1's amax left out of the exchange
constexpr int kFaultPeerSums = 2;  // the last rank's sums left out

// c[j] = bytes (a0[j], a1[j], a2[j], a3[j]): column j of 4 rows.
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);
  const uint32_t t1 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t t2 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// one 4-row group of the lane's 16 columns, zeros past the chunk's end
__device__ __forceinline__ void load_group(uint4 (&dst)[4],
                                           const int8_t* __restrict__ w,
                                           int rr, int row_end, int N,
                                           int col, bool col_ok) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = col_ok && rr < row_end
                 ? __ldg(reinterpret_cast<const uint4*>(
                       w + (size_t)(rr + i) * N + col))
                 : make_uint4(0u, 0u, 0u, 0u);
}

// An activation unit: 4 elements, as loaded (bf16 pairs or float32)
template <bool kF32X>
struct Unit {
  uint32_t w[kF32X ? 4 : 2];
  __device__ __forceinline__ float operator[](int i) const {
    if (kF32X) return __uint_as_float(w[i]);
    const uint32_t v = w[i >> 1];  // a pair's lower half comes first
    return __uint_as_float(i & 1 ? v & 0xffff0000u : v << 16);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory: this CTA's int32 sums [NB][kCols] (read by its peers),
// then the activation codes [NB][2][chunk / 4] words, which the warps'
// partial sums [kWarps][NB][kCols] replace after the loop, then, in the
// fused mode, the chunk's activation as loaded [NB][2][chunk] (xbytes an
// element).
__host__ __device__ constexpr size_t codes_bytes(int nb, int chunk) {
  return (size_t)nb * 2 * chunk > (size_t)kWarps * nb * kCols * 4
             ? (size_t)nb * 2 * chunk
             : (size_t)kWarps * nb * kCols * 4;
}

__host__ __device__ constexpr size_t smem_bytes(int nb, int chunk,
                                                int xbytes) {
  return (size_t)nb * kCols * 4 + codes_bytes(nb, chunk) +
         (size_t)nb * 2 * chunk * xbytes;
}

// CTAs an SM the registers must allow: the accumulators grow with NB
__host__ __device__ constexpr int min_ctas(int nb) {
  return nb == 1 ? 3 : nb <= 4 ? 2 : 1;
}

// an asynchronous copy of `kBytes` (4, 8 or 16) from device memory into
// shared memory, through L1
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <int NB, bool kFused, bool kF32X>
__global__ void __launch_bounds__(kThreads, min_ctas(NB))
    w4a8_kernel(const void* __restrict__ x, const int8_t* __restrict__ xhi,
                const float* __restrict__ xs, const int8_t* __restrict__ w,
                const float* __restrict__ ws, void* __restrict__ out, int B,
                int K2, int N, int x_stride, int chunk, int out_f32,
                int fault) {
  extern __shared__ int4 smem4[];
  int* s_sum = reinterpret_cast<int*>(smem4);
  int* s_x = s_sum + NB * kCols;
  __shared__ float s_wmax[NB][kWarps];  // each warp's |x| max of each row
  __shared__ float s_amax[NB];          // the chunk's, read by the peers
  __shared__ float s_scale[NB];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + (lane & 7) * kLaneCols;
  const bool col_ok = col < N;
  const int row_begin = rank * chunk;
  const int row_end = min(row_begin + chunk, K2);
  const int words = (row_end - row_begin) >> 2;
  const int b0 = blockIdx.z * NB;
  const int nb = min(NB, B - b0);

  constexpr int kDepth = depth_for(NB);
  // the weight stream starts before the activation is ready
  int r = row_begin + 4 * (warp * 4 + (lane >> 3));
  uint4 buf[kDepth][4];
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    load_group(buf[d], w, r + d * kStepRows, row_end, N, col, col_ok);
  // Launched as a programmatic dependent of the kernel before it on the
  // stream, the CTA may start while that kernel still runs: the weights
  // and their scales are read-only, so their loads go first, and nothing
  // the kernel before may write (the activation, its scales, the output's
  // memory) is touched before this wait.
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // the activation as units of 4 elements: unit t is row t / (2 * words)
  // of the group, its chunk's low half for u = t % (2 * words) < words and
  // its high half (K2 on) for the rest. Both modes copy them into shared
  // memory with cp.async, every copy in flight at once.
  const int units = NB * 2 * words;
  if (kFused) {
    // the chunk's activation into shared memory, every unit's copy in
    // flight at once; rows past the batch read as zeros
    Unit<kF32X>* s_raw = reinterpret_cast<Unit<kF32X>*>(
        reinterpret_cast<char*>(s_x) + codes_bytes(NB, chunk));
    for (int t = threadIdx.x; t < units; t += kThreads) {
      const int b = t / (2 * words), u = t % (2 * words);
      if (b < nb) {
        const int c = (u < words ? 0 : K2 - 4 * words) + row_begin + 4 * u;
        const size_t i = (size_t)(b0 + b) * x_stride + c;
        cp_async<sizeof(Unit<kF32X>)>(
            s_raw + t, static_cast<const char*>(x) + i * (kF32X ? 4 : 2));
      } else {
#pragma unroll
        for (int k = 0; k < (kF32X ? 4 : 2); ++k) s_raw[t].w[k] = 0u;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // the chunk's |x| max of each row: each warp's, then the CTA's
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float m = 0.f;
      for (int u0 = 0; u0 < 2 * words; u0 += kThreads) {
        const int u = u0 + threadIdx.x;
        if (u < 2 * words) {
          const Unit<kF32X> e = s_raw[b * 2 * words + u];
          m = fmaxf(m, fmaxf(fmaxf(fabsf(e[0]), fabsf(e[1])),
                             fmaxf(fabsf(e[2]), fabsf(e[3]))));
        }
      }
      m = warp_max(m);
      if (lane == 0) s_wmax[b][warp] = m;
    }
    __syncthreads();
    if (threadIdx.x < NB) {
      float m = s_wmax[threadIdx.x][0];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) m = fmaxf(m, s_wmax[threadIdx.x][i]);
      s_amax[threadIdx.x] = m;
    }
    cluster.sync();  // every CTA's chunk maxima are written
    if (threadIdx.x < NB) {
      // all the peers' maxima requested at once
      float peer[kMaxCluster];
#pragma unroll
      for (int p = 0; p < kMaxCluster; ++p)
        peer[p] = p < csize && !(fault == kFaultPeerAmax && p == 1)
                      ? *cluster.map_shared_rank(&s_amax[threadIdx.x], p)
                      : 0.f;
      float m = 0.f;
#pragma unroll
      for (int p = 0; p < kMaxCluster; ++p) m = fmaxf(m, peer[p]);
      s_scale[threadIdx.x] = row_scale(m).s;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < units; t += kThreads) {
      const Unit<kF32X> e = s_raw[t];
      const RowScale sc = row_scale_of(s_scale[t / (2 * words)]);
      const float h[4] = {e[0], e[1], e[2], e[3]};
      s_x[t] = (int)row_codes4(h, sc);  // rows past the batch: x = 0, codes 0
    }
  } else {
    const int8_t* xlo = static_cast<const int8_t*>(x);
    for (int t = threadIdx.x; t < units; t += kThreads) {
      const int b = t / (2 * words), u = t % (2 * words);
      if (b < nb) {
        const int8_t* src = u < words ? xlo : xhi;
        const int c = row_begin + 4 * (u < words ? u : u - words);
        cp_async<4>(s_x + t, src + (size_t)(b0 + b) * x_stride + c);
      } else {
        s_x[t] = 0;
      }
    }
    if (threadIdx.x < NB)
      s_scale[threadIdx.x] = threadIdx.x < nb ? xs[b0 + threadIdx.x] : 0.f;
    cp_async_wait_all();
  }
  __syncthreads();

  int acc[NB][kLaneCols];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[b][c] = 0;

  // one 4-row group: 16 columns x 4 rows of each half against the rows'
  // 4 activation codes of each half
  auto dot = [&](const uint4 (&g)[4], int rr) {
    const int wi = (rr - row_begin) >> 2;
    int xl[NB], xh[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      xl[b] = s_x[b * 2 * words + wi];
      xh[b] = s_x[b * 2 * words + words + wi];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t lo[4], hi[4], cl[4], ch[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t a = word_of(g[i], q);
        lo[i] = (a << 4) & 0xF0F0F0F0u;  // 16 * low nibble
        hi[i] = a & 0xF0F0F0F0u;         // 16 * high nibble
      }
      transpose4(lo, cl);
      transpose4(hi, ch);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[b][4 * q + c] = __dp4a((int)cl[c], xl[b], acc[b][4 * q + c]);
          acc[b][4 * q + c] = __dp4a((int)ch[c], xh[b], acc[b][4 * q + c]);
        }
    }
  };
  // the ring rotates through the unrolled slots: each group is used, then
  // its registers take the group kDepth steps on
  for (; r < row_end; r += kDepth * kStepRows) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int rr = r + d * kStepRows;
      if (rr < row_end) {
        dot(buf[d], rr);
        load_group(buf[d], w, rr + kDepth * kStepRows, row_end, N, col,
                   col_ok);
      }
    }
  }

  // the next kernel on the stream may start its own prologue now
  asm volatile("griddepcontrol.launch_dependents;");

  // the warp's 4 lane rows hold the same columns: shuffles; then the 8
  // warps in shared memory (over the codes, which every warp is done with)
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      acc[b][c] += __shfl_xor_sync(0xffffffffu, acc[b][c], 8);
      acc[b][c] += __shfl_xor_sync(0xffffffffu, acc[b][c], 16);
    }
  __syncthreads();
  int* s_red = s_x;  // [kWarps][NB][kCols]
  if (lane < 8) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c)
        s_red[(warp * NB + b) * kCols + lane * kLaneCols + c] = acc[b][c];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NB * kCols; t += kThreads) {
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += s_red[wi * NB * kCols + t];
    s_sum[t] = sum;
  }
  cluster.sync();  // every CTA's sums are in its shared memory

  // each rank finishes its share of the (NB, kCols) outputs
  const int share = (NB * kCols + csize - 1) / csize;
  const int t_end = min((rank + 1) * share, NB * kCols);
  for (int t = rank * share + threadIdx.x; t < t_end; t += kThreads) {
    const int b = t / kCols, n = col0 + t % kCols;
    if (b >= nb || n >= N) continue;
    // all the CTAs' sums requested at once
    int part[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p)
      part[p] = p < csize && !(fault == kFaultPeerSums && p == csize - 1 &&
                               csize > 1)
                    ? *cluster.map_shared_rank(s_sum + t, p)
                    : 0;
    int sum = 0;
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) sum += part[p];
    sum >>= 4;  // exact: every term is a multiple of 16
    const float v = (float)sum * ws[n] * s_scale[b];
    const size_t i = (size_t)(b0 + b) * N + n;
    if (out_f32)
      static_cast<float*>(out)[i] = v;
    else
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  }
  cluster.sync();  // the peers have read this CTA's sums
}

struct Args {
  const void* x;
  const int8_t* xhi;
  const float* xs;
  const int8_t* w;
  const float* ws;
  void* out;
  int B, K2, N, x_stride, chunk, out_f32, fault;
};

template <int NB, bool kFused, bool kF32X>
int run(const Args& a, int cluster, cudaStream_t st, int* max_clusters) {
  auto* kernel = w4a8_kernel<NB, kFused, kF32X>;
  static bool sized = false;  // one opt-in a kernel, for the largest chunk
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(NB, kMaxChunk, kFused ? (kF32X ? 4 : 2) : 0));
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kCols - 1) / kCols, cluster,
                     (a.B + NB - 1) / NB);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      smem_bytes(NB, a.chunk, kFused ? (kF32X ? 4 : 2) : 0);
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = max_clusters ? 1 : 2;
  if (max_clusters)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters,
                                               (const void*)kernel, &cfg);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, a.x, a.xhi, a.xs, a.w, a.ws, a.out,
                         a.B, a.K2, a.N, a.x_stride, a.chunk, a.out_f32,
                         a.fault);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <bool kFused, bool kF32X>
int dispatch(const Args& a, int cluster, cudaStream_t st, int* max_clusters) {
  switch (a.B < kMaxRows ? a.B : kMaxRows) {
#define W4A8_CASE(n) \
  case n:            \
    return run<n, kFused, kF32X>(a, cluster, st, max_clusters);
    W4A8_CASE(1) W4A8_CASE(2) W4A8_CASE(3) W4A8_CASE(4)
    W4A8_CASE(5) W4A8_CASE(6) W4A8_CASE(7) W4A8_CASE(8)
#undef W4A8_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int launch(const Args& a, bool fused, bool x_f32, int cluster, void* stream,
           int* max_clusters) {
  const int min_stride = fused ? 2 * a.K2 : a.K2;
  if (a.B <= 0 || a.K2 <= 0 || a.N <= 0 || a.K2 % 4 || a.N % kLaneCols ||
      a.x_stride < min_stride || a.x_stride % 4 || cluster < 1 ||
      cluster > kMaxCluster || a.chunk <= 0 || a.chunk % kStepRows ||
      a.chunk > kMaxChunk || (long long)cluster * a.chunk < a.K2 ||
      (long long)(cluster - 1) * a.chunk >= a.K2 ||
      (a.B + kMaxRows - 1) / kMaxRows > 65535 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 ||
      reinterpret_cast<uintptr_t>(a.w) % 16 || (!fused && !a.xhi) ||
      (!fused && !a.xs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fused) return dispatch<false, false>(a, cluster, st, max_clusters);
  return x_f32 ? dispatch<true, true>(a, cluster, st, max_clusters)
               : dispatch<true, false>(a, cluster, st, max_clusters);
}

}  // namespace

// Mode (a). xlo/xhi (B, K/2) int8 with rows x_stride bytes apart (the two
// halves of one (B, K) activation, or two arrays), xs (B, 1) f32, w (K/2, N)
// int8 (the layer's slice), ws (1, N) f32, out (B, N) bf16 or f32
// (out_f32), contiguous but for x's rows, 16-byte aligned. cluster / chunk:
// CTAs along K/2 and packed rows each (a multiple of 128, at most 2048),
// from `w4a8_plan`. fault: 0, or a planted error for a check. Returns
// cudaError_t.
extern "C" int lhrs_w4a8_matmul(const void* xlo, const void* xhi,
                                const void* xs, const void* w,
                                const void* ws, void* out, int B, int K2,
                                int N, int x_stride, int cluster, int chunk,
                                int out_f32, int fault, void* stream) {
  const Args a{xlo, static_cast<const int8_t*>(xhi),
               static_cast<const float*>(xs), static_cast<const int8_t*>(w),
               static_cast<const float*>(ws), out, B, K2, N, x_stride,
               chunk, out_f32, fault};
  return launch(a, false, false, cluster, stream, nullptr);
}

// Mode (b). x (B, 2 * K2) bf16, or float32 when x_f32, rows x_stride
// elements apart; the rest as mode (a).
extern "C" int lhrs_w4a8_project(const void* x, int x_f32, const void* w,
                                 const void* ws, void* out, int B, int K2,
                                 int N, int x_stride, int cluster, int chunk,
                                 int out_f32, int fault, void* stream) {
  const Args a{x, nullptr, nullptr, static_cast<const int8_t*>(w),
               static_cast<const float*>(ws), out, B, K2, N, x_stride,
               chunk, out_f32, fault};
  return launch(a, true, x_f32 != 0, cluster, stream, nullptr);
}

// How many clusters of the fused (or, fused = 0, the pre-quantized) kernel
// can be resident at once on the device for this launch, into *count
// (cudaOccupancyMaxActiveClusters). Returns cudaError_t.
extern "C" int lhrs_w4a8_max_clusters(int fused, int x_f32, int B, int K2,
                                      int N, int cluster, int chunk,
                                      int* count) {
  // a shape-only query: aligned stand-in pointers pass the checks
  static int4 dummy;
  const Args a{&dummy, reinterpret_cast<const int8_t*>(&dummy),
               reinterpret_cast<const float*>(&dummy),
               reinterpret_cast<const int8_t*>(&dummy),
               reinterpret_cast<const float*>(&dummy), &dummy, B, K2, N,
               fused ? 2 * K2 : K2, chunk, 0, 0};
  return launch(a, fused != 0, x_f32 != 0, cluster, nullptr, count);
}
