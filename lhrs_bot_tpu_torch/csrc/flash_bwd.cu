// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in, bf16
// dQ / dK / dV out, float32 accumulation.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel`
// (lhrs_bot_tpu/ops/attention.py:291) and `_flash_bwd_dkv_kernel` (:357),
// driven by `_flash_attention_bwd_pallas` (:429). Same semantics and the
// same two-pass split: from the forward's output O and float32 log-sum-exp
// (B, H, Sq), and delta = rowsum(dO * O) in float32 (computed by the caller,
// as XLA computes it there), each kernel recomputes P = exp(s * scale - lse)
// under the forward's masks: top-left causal (kv_id <= q_id), kv_mask
// (B, Skv), packing segment ids (B, S) (i attends j iff seg[i] == seg[j] >
// 0), and the ragged tails. A row with no valid key has lse = 1e30, so its P
// underflows to 0 without a special case.
//
// Rounding points, as the TPU kernels take them: dP = dO V^T is a float32
// sum of products of bf16 values (mma.sync bf16 x bf16 -> f32 gives it up to
// summation order); dS = P * (dP - delta) * scale in float32, rounded to
// bf16 only as the operand of the dQ (dS K) and dK (dS^T Q) products. The
// TPU's dV = P^T dO multiplies the float32 P (`:412-414`); here P is split
// into bf16 halves hi + lo (lo = bf16(P - hi)) and both halves go through
// the tensor cores, which keeps 16 bits of P's mantissa instead of bf16's 8.
//
// No atomics: the dQ kernel owns its q rows and the dK/dV kernel its kv
// rows, so every output element is one thread's sum in a fixed order and
// repeated runs are bit-identical.
//
// What bounds them on the H100: at the decoder's training shape (H32, D128,
// S 2048-2620, causal) five S x S x D products per head (QK^T, dO V^T and dS
// K in the dQ pass; the same two recomputed, P^T dO twice and dS^T Q in the
// dK/dV pass), so the passes are compute-bound; at the perceiver's shapes
// (Sq <= 64, Skv <= 320, D64) they are short and bound by launch and load
// latency.
//
// Design: 4 warps per CTA, mma.sync m16n8k16 (wgmma / TMA pipelining is
// later work). dQ: one CTA per (64-row q tile, batch*head); Q and dO stay in
// shared memory, the loop over 64-row K/V tiles runs inside the CTA in place
// of the TPU's sequential kv grid axis; each warp owns 16 q rows, its dQ
// accumulator in registers. dK/dV: one CTA per (64-row kv tile,
// batch*head); K and V stay in shared memory, 32-row Q / dO tiles stream
// through; each warp owns 16 kv rows and computes S^T = K Q^T directly, so
// P^T and dS^T come out of the accumulators already in A-fragment layout.
// Causal CTAs skip the tiles strictly above the diagonal in both passes.
// Rows are padded by 8 elements in shared memory so fragment reads hit
// distinct banks; ragged tails are zero-filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kRows = 64;      // rows a CTA owns (q rows for dQ, kv for dKV)
constexpr int kBK = 64;        // kv rows per tile in the dQ pass
constexpr int kBQ = 32;        // q rows per tile in the dK/dV pass

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + ROWS) of a contiguous (rows, D) bf16 matrix into shared
// memory with row stride LD; rows at or past `rows` are zero-filled.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D +
                                            c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// A fragment (16 x 16, row-major) of rows r, r + 8 and columns c0 .. c0 + 15
// of a shared-memory matrix with row stride LD; r = warp row base + g.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int r, int c) {
  a[0] = ld32(s + r * LD + c);
  a[1] = ld32(s + (r + 8) * LD + c);
  a[2] = ld32(s + r * LD + c + 8);
  a[3] = ld32(s + (r + 8) * LD + c + 8);
}

// B fragment (16 x 8) whose k index runs along the rows of a shared-memory
// matrix: rows k0 + 2t, +1, +8, +9, column n = c + g.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t b[2],
                                            const __nv_bfloat16* s, int k0,
                                            int t, int col) {
  const __nv_bfloat16* p = s + (k0 + t * 2) * LD + col;
  b[0] = pack_raw(p[0], p[LD]);
  b[1] = pack_raw(p[8 * LD], p[9 * LD]);
}

// ---------------------------------------------------------------------------
// dQ = sum over kv tiles of bf16(dS) K
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const uint8_t* __restrict__ kv_mask,
                        const int* __restrict__ seg,
                        __nv_bfloat16* __restrict__ dq, int H, int Sq,
                        int Skv, int causal, float sm_scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kRows * LD;
  __nv_bfloat16* sK = sdO + kRows * LD;
  __nv_bfloat16* sV = sK + kBK * LD;
  int* sSeg = reinterpret_cast<int*>(sV + kBK * LD);
  uint8_t* sValid = reinterpret_cast<uint8_t*>(sSeg + kBK);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = qt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Skv * D;

  load_tile<D, LD, kRows>(sQ, q + qoff, q0, Sq);
  load_tile<D, LD, kRows>(sdO, dout + qoff, q0, Sq);

  const int r0 = warp * 16 + g;
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  float lse_r[2], delta_r[2];
  int segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = qrow[r] < Sq;
    lse_r[r] = in ? lse[(size_t)bh * Sq + qrow[r]] : 1e30f;
    delta_r[r] = in ? delta[(size_t)bh * Sq + qrow[r]] : 0.f;
    segq[r] = seg == nullptr ? 1 : (in ? seg[(size_t)b * Sq + qrow[r]] : 0);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int kv_end = causal ? min(Skv, q0 + kRows) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, LD, kBK>(sK, k + koff, kv0, Skv);
    load_tile<D, LD, kBK>(sV, v + koff, kv0, Skv);
    if (threadIdx.x < kBK) {
      const int kv = kv0 + threadIdx.x;
      sValid[threadIdx.x] =
          kv < Skv && (kv_mask == nullptr || kv_mask[(size_t)b * Skv + kv]);
      sSeg[threadIdx.x] =
          (seg != nullptr && kv < Skv) ? seg[(size_t)b * Skv + kv] : 0;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 kv columns
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, sQ, r0, kk * 16 + t * 2);
      load_a<LD>(da, sdO, r0, kk * 16 + t * 2);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const int off = (nt * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t bk[2] = {ld32(sK + off), ld32(sK + off + 8)};
        const uint32_t bv[2] = {ld32(sV + off), ld32(sV + off + 8)};
        mma_16816(s[nt], qa, bk);
        mma_16816(dp[nt], da, bv);
      }
    }

    // P = exp(s * scale - lse) under the masks; dS = P (dP - delta) scale,
    // rounded to bf16 into A fragments. Element e of tile nt sits at row
    // g + 8 (e >> 1), column nt * 8 + 2t + (e & 1).
    uint32_t dsf[kBK / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1), r = e >> 1;
        const bool ok =
            sValid[col] && (!causal || kv0 + col <= qrow[r]) &&
            (seg == nullptr || (segq[r] > 0 && segq[r] == sSeg[col]));
        const float p = ok ? __expf(s[nt][e] * sm_scale - lse_r[r]) : 0.f;
        ds[e] = p * (dp[nt][e] - delta_r[r]) * sm_scale;
      }
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(ds[2], ds[3]);
    }

    // dQ += dS K: B fragment rows (kv) 16j + 2t (+1, +8, +9), column d
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j)
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bk[2];
        load_b_rows<LD>(bk, sK, 16 * j, t, dt * 8 + g);
        mma_16816(acc[dt], dsf[j], bk);
      }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < Sq)
        *reinterpret_cast<uint32_t*>(dq + qoff + (size_t)qrow[r] * D + c) =
            pack_f32(acc[dt][2 * r], acc[dt][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// dV = sum over q tiles of P^T dO (P as hi + lo bf16), dK of bf16(dS)^T Q
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const uint8_t* __restrict__ kv_mask,
                         const int* __restrict__ seg,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Sq,
                         int Skv, int causal, float sm_scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kRows * LD;
  __nv_bfloat16* sQ = sV + kRows * LD;
  __nv_bfloat16* sdO = sQ + kBQ * LD;
  float* sLse = reinterpret_cast<float*>(sdO + kBQ * LD);
  float* sDelta = sLse + kBQ;
  int* sSeg = reinterpret_cast<int*>(sDelta + kBQ);  // 0 past Sq

  const int kt = blockIdx.x;  // low kv tiles see the most q tiles: first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int kv0 = kt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Skv * D;

  load_tile<D, LD, kRows>(sK, k + koff, kv0, Skv);
  load_tile<D, LD, kRows>(sV, v + koff, kv0, Skv);

  const int r0 = warp * 16 + g;
  const int krow[2] = {kv0 + r0, kv0 + r0 + 8};
  bool kvalid[2];
  int segk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kvalid[r] = krow[r] < Skv &&
                (kv_mask == nullptr || kv_mask[(size_t)b * Skv + krow[r]]);
    segk[r] = (seg != nullptr && krow[r] < Skv)
                  ? seg[(size_t)b * Skv + krow[r]] : 0;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int q_start = causal ? (kv0 / kBQ) * kBQ : 0;
  for (int q0 = q_start; q0 < Sq; q0 += kBQ) {
    __syncthreads();  // every warp is done with the previous tile (and K/V)
    load_tile<D, LD, kBQ>(sQ, q + qoff, q0, Sq);
    load_tile<D, LD, kBQ>(sdO, dout + qoff, q0, Sq);
    if (threadIdx.x < kBQ) {
      const int i = q0 + threadIdx.x;
      const bool in = i < Sq;
      sLse[threadIdx.x] = in ? lse[(size_t)bh * Sq + i] : 1e30f;
      sDelta[threadIdx.x] = in ? delta[(size_t)bh * Sq + i] : 0.f;
      sSeg[threadIdx.x] =
          in ? (seg == nullptr ? 1 : seg[(size_t)b * Sq + i]) : 0;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 32 q columns per warp
    float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, sK, r0, kk * 16 + t * 2);
      load_a<LD>(va, sV, r0, kk * 16 + t * 2);
#pragma unroll
      for (int nt = 0; nt < kBQ / 8; ++nt) {
        const int off = (nt * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t bq[2] = {ld32(sQ + off), ld32(sQ + off + 8)};
        const uint32_t bd[2] = {ld32(sdO + off), ld32(sdO + off + 8)};
        mma_16816(st[nt], ka, bq);
        mma_16816(dpt[nt], va, bd);
      }
    }

    // P^T and dS^T. Element e of tile nt: kv row g + 8 (e >> 1), q column
    // nt * 8 + 2t + (e & 1). A q row past Sq has segment 0 (never allowed).
    uint32_t phi[kBQ / 16][4], plo[kBQ / 16][4], dsf[kBQ / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt) {
      float p[4], ds[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1), r = e >> 1;
        const int i = q0 + col;
        const int sq_ = sSeg[col];
        const bool ok = sq_ > 0 && kvalid[r] && (!causal || krow[r] <= i) &&
                        (seg == nullptr || sq_ == segk[r]);
        p[e] = ok ? __expf(st[nt][e] * sm_scale - sLse[col]) : 0.f;
        ds[e] = p[e] * (dpt[nt][e] - sDelta[col]) * sm_scale;
        lo[e] = p[e] - __bfloat162float(__float2bfloat16_rn(p[e]));
      }
      const int j = nt >> 1, h = (nt & 1) * 2;
      phi[j][h] = pack_f32(p[0], p[1]);
      phi[j][h + 1] = pack_f32(p[2], p[3]);
      plo[j][h] = pack_f32(lo[0], lo[1]);
      plo[j][h + 1] = pack_f32(lo[2], lo[3]);
      dsf[j][h] = pack_f32(ds[0], ds[1]);
      dsf[j][h + 1] = pack_f32(ds[2], ds[3]);
    }

    // dV += P^T dO (hi, then lo), dK += dS^T Q: B fragments run along the q
    // rows of sdO / sQ
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j)
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bd[2], bq[2];
        load_b_rows<LD>(bd, sdO, 16 * j, t, dt * 8 + g);
        load_b_rows<LD>(bq, sQ, 16 * j, t, dt * 8 + g);
        mma_16816(dv_acc[dt], phi[j], bd);
        mma_16816(dv_acc[dt], plo[j], bd);
        mma_16816(dk_acc[dt], dsf[j], bq);
      }
  }

#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (krow[r] < Skv) {
        const size_t i = koff + (size_t)krow[r] * D + c;
        *reinterpret_cast<uint32_t*>(dk + i) =
            pack_f32(dk_acc[dt][2 * r], dk_acc[dt][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + i) =
            pack_f32(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
      }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * kRows + 2 * kBK) * (D + 8) * 2 + kBK * 5;
}

template <int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * kRows + 2 * kBQ) * (D + 8) * 2 + kBQ * 12;
}

template <int D>
int launch_dq(const __nv_bfloat16* q, const __nv_bfloat16* k,
              const __nv_bfloat16* v, const __nv_bfloat16* dout,
              const float* lse, const float* delta, const uint8_t* mask,
              const int* seg, __nv_bfloat16* dq, int B, int H, int Sq,
              int Skv, int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, mask, seg, dq, H, Sq, Skv, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* dout,
               const float* lse, const float* delta, const uint8_t* mask,
               const int* seg, __nv_bfloat16* dk, __nv_bfloat16* dv, int B,
               int H, int Sq, int Skv, int causal, float sm_scale,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Skv + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, mask, seg, dk, dv, H, Sq, Skv, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Skv, const void* seg) {
  return B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || B * H > 65535 ||
         (seg != nullptr && Sq != Skv);
}

}  // namespace

// q, dout (B,H,Sq,D), k, v (B,H,Skv,D): contiguous bf16. lse, delta
// (B,H,Sq) contiguous float32. kv_mask (B,Skv) bytes (0 = masked) or null;
// seg (B,S) int32 with S = Sq = Skv, or null. dq (B,H,Sq,D) contiguous bf16
// output. D is 64 or 128. Returns cudaError_t.
extern "C" int lhrs_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* kv_mask,
                                 const void* seg, void* dq, int B, int H,
                                 int Sq, int Skv, int D, int causal,
                                 float sm_scale, void* stream) {
  if (bad_shape(B, H, Sq, Skv, seg)) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf*>(q);
  const auto* kp = static_cast<const bf*>(k);
  const auto* vp = static_cast<const bf*>(v);
  const auto* dp = static_cast<const bf*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* ep = static_cast<const float*>(delta);
  const auto* mp = static_cast<const uint8_t*>(kv_mask);
  const auto* gp = static_cast<const int*>(seg);
  auto* op = static_cast<bf*>(dq);
  if (D == 64)
    return launch_dq<64>(qp, kp, vp, dp, lp, ep, mp, gp, op, B, H, Sq, Skv,
                         causal, sm_scale, st);
  if (D == 128)
    return launch_dq<128>(qp, kp, vp, dp, lp, ep, mp, gp, op, B, H, Sq, Skv,
                          causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// As lhrs_flash_bwd_dq; dk, dv (B,H,Skv,D) contiguous bf16 outputs.
extern "C" int lhrs_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* kv_mask, const void* seg,
                                  void* dk, void* dv, int B, int H, int Sq,
                                  int Skv, int D, int causal, float sm_scale,
                                  void* stream) {
  if (bad_shape(B, H, Sq, Skv, seg)) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf*>(q);
  const auto* kp = static_cast<const bf*>(k);
  const auto* vp = static_cast<const bf*>(v);
  const auto* dp = static_cast<const bf*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* ep = static_cast<const float*>(delta);
  const auto* mp = static_cast<const uint8_t*>(kv_mask);
  const auto* gp = static_cast<const int*>(seg);
  auto* kout = static_cast<bf*>(dk);
  auto* vout = static_cast<bf*>(dv);
  if (D == 64)
    return launch_dkv<64>(qp, kp, vp, dp, lp, ep, mp, gp, kout, vout, B, H,
                          Sq, Skv, causal, sm_scale, st);
  if (D == 128)
    return launch_dkv<128>(qp, kp, vp, dp, lp, ep, mp, gp, kout, vout, B, H,
                           Sq, Skv, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
