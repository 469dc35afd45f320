// W4A8 matmul for decode over one layer of a stacked halves-packed int4
// weight, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of `w4a8_matmul_stacked`
// (lhrs_bot_tpu/ops/w4_matmul.py:43, called at :94 through `w4a8_project`
// :145). Same semantics: out[b, n] = cast((acc[b, n] * w_scale[n]) *
// x_scale[b]) with the int32 accumulator acc = sum_r xlo[b, r] * lo(W[r, n])
// + sum_r xhi[b, r] * hi(W[r, n]) over the layer's (K/2, N) int8 slice,
// whose low nibble holds weight row r and high nibble row K/2 + r. The
// integer sums are exact, so the result is bit-identical to the plain
// version (lhrs_bot_tpu_torch/ops/w4_matmul.py `w4a8_matmul_plain`).
//
// What bounds it on the H100: device-memory bandwidth. At decode batch
// (B <= 8) each packed byte feeds 2 * B multiply-adds, so the weight stream
// (K/2 * N bytes, read once per call) is the cost.
//
// Design: a CTA of 8 warps owns 128 output columns; each lane owns 4
// adjacent columns and reads one 32-bit word per packed row, so a warp's
// load is one contiguous 128-byte span. The 8 warps take interleaved 4-row
// groups of the CTA's slice of K/2 and keep 4 groups (16 loads a lane) in
// flight. A 4x4 byte transpose (__byte_perm) turns 4 rows x 4 columns into
// 4 per-column words of 4 rows, and __dp4a multiplies them by the 4
// matching int8 activations. The nibbles are never sign-extended: byte
// (w << 4) & 0xF0 is 16 * lo and w & 0xF0 is 16 * hi as int8, so the
// accumulator holds 16 * acc (|16 * acc| < 2^28 at K = 11008) and one exact
// arithmetic shift recovers acc. The 8 warps' sums meet in shared memory.
// When the columns alone give too few CTAs for 132 SMs, K/2 is split across
// CTAs (grid.y); each writes its exact int32 partial sums and a second
// kernel adds them and applies the float32 epilogue, so the result does not
// depend on the split. Activation rows go 8 to a CTA (grid.z).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;    // output columns per CTA: 32 lanes x 4
constexpr int kUnroll = 4;    // 4-row groups in flight per warp
constexpr int kMaxRows = 8;   // activation rows per CTA

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

__device__ __forceinline__ void store(void* out, size_t i, float v,
                                      int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
    w4a8_kernel(const uint32_t* __restrict__ xlo,
                const uint32_t* __restrict__ xhi,
                const float* __restrict__ xs, const int8_t* __restrict__ w,
                const float* __restrict__ ws, int* __restrict__ partial,
                void* __restrict__ out, int B, int K2, int N, int x_stride,
                int chunk, int out_f32) {
  __shared__ int s_acc[kWarps][NB][kCols];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + lane * 4;
  const int row_begin = blockIdx.y * chunk;
  const int row_end = min(row_begin + chunk, K2);
  const int b0 = blockIdx.z * NB;
  const int xw = x_stride / 4;  // activation words per row

  int acc[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0;

  if (col < N) {
    for (int r = row_begin + warp * 4; r < row_end;
         r += kWarps * 4 * kUnroll) {
      uint32_t wr[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * kWarps * 4;  // row_end is a multiple of 4
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wr[u][i] = rr < row_end
                         ? __ldg(reinterpret_cast<const uint32_t*>(
                               w + (size_t)(rr + i) * N + col))
                         : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * kWarps * 4;
        if (rr >= row_end) break;
        uint32_t lo[4], hi[4], cl[4], ch[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = (wr[u][i] << 4) & 0xF0F0F0F0u;  // 16 * low nibble
          hi[i] = wr[u][i] & 0xF0F0F0F0u;         // 16 * high nibble
        }
        transpose4(lo, cl);
        transpose4(hi, ch);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          int xl = 0, xh = 0;
          if (b0 + b < B) {
            xl = (int)__ldg(xlo + (size_t)(b0 + b) * xw + rr / 4);
            xh = (int)__ldg(xhi + (size_t)(b0 + b) * xw + rr / 4);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[b][c] = __dp4a((int)cl[c], xl, acc[b][c]);
            acc[b][c] = __dp4a((int)ch[c], xh, acc[b][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) s_acc[warp][b][lane * 4 + c] = acc[b][c];
  __syncthreads();
  for (int t = threadIdx.x; t < NB * kCols; t += kThreads) {
    const int b = t / kCols, c = t % kCols;
    const int n = col0 + c;
    if (n >= N || b0 + b >= B) continue;
    int sum = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += s_acc[wi][b][c];
    sum >>= 4;  // exact: every term is a multiple of 16
    const size_t i = (size_t)(b0 + b) * N + n;
    if (gridDim.y == 1)
      store(out, i, (float)sum * ws[n] * xs[b0 + b], out_f32);
    else
      partial[(size_t)blockIdx.y * B * N + i] = sum;
  }
}

// out[b, n] from the split-K partial sums: exact int32 total, then the
// float32 epilogue of the single-pass kernel.
__global__ void w4a8_epilogue(const int* __restrict__ partial,
                              const float* __restrict__ xs,
                              const float* __restrict__ ws,
                              void* __restrict__ out, int B, int N,
                              int ksplit, int out_f32) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * N) return;
  const int b = (int)(i / N), n = (int)(i % N);
  int sum = 0;
  for (int k = 0; k < ksplit; ++k) sum += partial[(size_t)k * B * N + i];
  store(out, i, (float)sum * ws[n] * xs[b], out_f32);
}

template <int NB>
void launch(dim3 grid, cudaStream_t st, const void* xlo, const void* xhi,
            const void* xs, const void* w, const void* ws, void* partial,
            void* out, int B, int K2, int N, int x_stride, int chunk,
            int out_f32) {
  w4a8_kernel<NB><<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(xlo), static_cast<const uint32_t*>(xhi),
      static_cast<const float*>(xs), static_cast<const int8_t*>(w),
      static_cast<const float*>(ws), static_cast<int*>(partial), out, B, K2,
      N, x_stride, chunk, out_f32);
}

}  // namespace

// xlo/xhi (B, K/2) int8 with rows x_stride bytes apart (the two halves of
// one (B, K) activation, or two contiguous arrays), xs (B, 1) f32, w
// (K/2, N) int8 (the layer's slice), ws (1, N) f32, out (B, N) bf16 or f32
// (out_f32), 16-byte aligned on the device, contiguous but for x's rows;
// partial (ksplit, B, N) int32 scratch when ksplit > 1. chunk: packed rows
// per CTA along K/2, a multiple of 32. Returns cudaError_t.
extern "C" int lhrs_w4a8_matmul(const void* xlo, const void* xhi,
                                const void* xs, const void* w,
                                const void* ws, void* partial, void* out,
                                int B, int K2, int N, int x_stride,
                                int ksplit, int chunk, int out_f32,
                                void* stream) {
  if (B <= 0 || K2 <= 0 || N <= 0 || K2 % 4 || N % 4 || x_stride < K2 ||
      x_stride % 4 || ksplit < 1 ||
      ksplit > 65535 || chunk <= 0 || chunk % (4 * kWarps) ||
      (long long)ksplit * chunk < K2 ||
      (long long)(ksplit - 1) * chunk >= K2 || (ksplit > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  const int nb = B < kMaxRows ? B : kMaxRows;
  if ((B + nb - 1) / nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kCols - 1) / kCols, ksplit, (B + nb - 1) / nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nb) {
#define W4A8_CASE(n)                                                     \
  case n:                                                                \
    launch<n>(grid, st, xlo, xhi, xs, w, ws, partial, out, B, K2, N,     \
              x_stride, chunk, out_f32);                                 \
    break;
    W4A8_CASE(1) W4A8_CASE(2) W4A8_CASE(3) W4A8_CASE(4)
    W4A8_CASE(5) W4A8_CASE(6) W4A8_CASE(7) W4A8_CASE(8)
#undef W4A8_CASE
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ksplit == 1) return (int)err;
  const long long total = (long long)B * N;
  w4a8_epilogue<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const int*>(partial), static_cast<const float*>(xs),
      static_cast<const float*>(ws), out, B, N, ksplit, out_f32);
  return (int)cudaGetLastError();
}
