// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 or float32 out,
// f32 softmax.
//
// Replaces the Pallas TPU kernel `_flash_kernel` (lhrs_bot_tpu/ops/attention.py:84,
// called through `_flash_attention_pallas` :178). Same semantics: optional
// kv_mask (B, Skv), top-left causal mask (kv_id <= q_id), rows with no valid
// key give exactly 0. Optional sequence-packing segment ids (B, S): position
// i attends j iff seg[i] == seg[j] > 0, combined with the masks above
// (`:139-145`); and an optional float32 log-sum-exp output (B, H, Sq) for
// the backward, m + log(l) per row and 1e30 for a row with no valid key, so
// that exp(s - lse) underflows to 0 there (`:172-175`). Null pointers mean
// "not given": the serving and vision launches are unchanged.
// Also the per-head attention inside the fused W8A8 vision blocks
// (lhrs_bot_tpu/ops/vit_block.py:111/:132, perceiver_block.py:53), whose
// output stays float32 until it is quantized: the float32-output variant
// (template flag) serves them. q, k, v and o are addressed through (batch,
// head, row) element strides, so the vision blocks read Q, K and V in place
// from their (tokens, 3 * width) projection and write the output
// token-major, (B, S, H, D), as the next projection reads it.
//
// What bounds it on the H100: at the decoder-prefill shape (H32, D128, S up
// to 2191, causal) the two matrix products are compute-bound (about 4*S*S*D
// flops per head against 4*S*D bytes); at the ViT/perceiver shapes (S <= 320,
// D64) the kernel is short and bound by launch and load latency.
//
// Design: one CTA of 4 warps per (batch*head, 64-row q tile); each warp owns
// 16 q rows. The loop over 64-row K/V tiles runs inside the CTA, in place of
// the TPU's sequential `ki` grid axis. Q fragments stay in registers; K and V
// tiles are staged in shared memory (rows padded by 8 elements so the
// fragment reads hit distinct banks, ragged tails zero-filled so no garbage
// reaches the products). Both products are warp-level mma.sync m16n8k16
// (bf16 x bf16 -> f32); the probabilities are re-packed from the score
// accumulators straight into A fragments. Running max, sum and output
// accumulator are f32 in registers. Causal CTAs stop at the diagonal tile and
// the heaviest q tiles are scheduled first. wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // q rows per CTA
constexpr int kBK = 64;       // kv rows per shared-memory tile
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr float kNegInf = -1e30f;

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

struct Strides {  // element strides of a (B, H, S, D) operand; D is unit
  long long b, h, s;
};

// Copies rows [row0, row0 + 64) of a (rows, D) bf16 matrix with row stride
// `ld` into shared memory with row stride LD, zero-filling rows at or past
// `rows`.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld +
                                            c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// One CTA's work. The segment test and the LSE write are compiled in only
// where they are asked for (kSeg, kLse).
template <int D, bool kF32Out, bool kSeg, bool kLse>
__device__ __forceinline__ void flash_fwd_tile(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ kv_mask,
    const int* __restrict__ seg, void* __restrict__ o,
    float* __restrict__ lse, int H, int Sq, int Skv, int causal,
    float sm_scale, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 sK[kBK * LD];  // Q is staged here first
  __shared__ __align__(16) __nv_bfloat16 sV[kBK * LD];
  __shared__ int sSeg[kBK];  // segment ids of the kv tile (with seg only)
  __shared__ uint8_t sValid[kBK];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, hd = bh % H;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qb = q + b * qs.b + hd * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hd * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hd * vs.h;

  // Q tile -> registers (A fragments of the 16 rows this warp owns).
  load_tile<D, LD>(sK, qb, qs.s, q0, Sq);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qf[kk][0] = ld32(sK + r0 * LD + c);
    qf[kk][1] = ld32(sK + (r0 + 8) * LD + c);
    qf[kk][2] = ld32(sK + r0 * LD + c + 8);
    qf[kk][3] = ld32(sK + (r0 + 8) * LD + c + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  int segq[2] = {0, 0};  // rows past Sq are segment 0: they attend nothing
  if (kSeg)
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < Sq) segq[r] = seg[(size_t)b * Sq + qrow[r]];

  const int kv_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile (or Q)
    load_tile<D, LD>(sK, kb, ks.s, kv0, Skv);
    load_tile<D, LD>(sV, vb, vs.s, kv0, Skv);
    if (threadIdx.x < kBK) {
      const int kv = kv0 + threadIdx.x;
      sValid[threadIdx.x] =
          kv < Skv && (kv_mask == nullptr || kv_mask[(size_t)b * Skv + kv]);
      if (kSeg) sSeg[threadIdx.x] = kv < Skv ? seg[(size_t)b * Skv + kv] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns.
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = sK + (nt * 8 + g) * LD + kk * 16 + t * 2;
        const uint32_t bf[2] = {ld32(kr), ld32(kr + 8)};
        mma_16816(s[nt], qf[kk], bf);
      }
    }

    // Mask, scale, online softmax. Element e of tile nt sits at row
    // g + 8*(e>>1), column nt*8 + 2t + (e&1).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const int r = e >> 1;
        const bool ok =
            sValid[col] && (!causal || kv0 + col <= qrow[r]) &&
            (!kSeg || (segq[r] > 0 && segq[r] == sSeg[col]));
        s[nt][e] = ok ? s[nt][e] * sm_scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries are re-zeroed: a row with no valid key so far has
        // m == kNegInf and exp(s - m) would be 1 there
        p[e] = s[nt][e] == kNegInf ? 0.f : __expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(p[0], p[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(p[2], p[3]);
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V. B fragment: rows (kv) 2t, 2t+1 (+8), column (d) g.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = sV + (16 * j + t * 2) * LD + dt * 8 + g;
        const uint32_t bf[2] = {pack_raw(vp[0], vp[LD]),
                                pack_raw(vp[8 * LD], vp[9 * LD])};
        mma_16816(acc[dt], pf[j], bf);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    if (kLse && t == 0 && qrow[r] < Sq)
      lse[(size_t)bh * Sq + qrow[r]] = l[r] > 0.f ? m[r] + logf(l[r]) : 1e30f;
  }
  const size_t ob = b * os.b + hd * os.h;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] >= Sq) continue;
      const size_t i = ob + (size_t)qrow[r] * os.s + c;
      const float v0 = acc[dt][2 * r] * inv[r], v1 = acc[dt][2 * r + 1] * inv[r];
      if (kF32Out)
        *reinterpret_cast<float2*>(static_cast<float*>(o) + i) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(o) + i) =
            pack_f32(v0, v1);
    }
  }
}

#define LHRS_FWD_PARAMS                                                      \
  const __nv_bfloat16 *__restrict__ q, const __nv_bfloat16 *__restrict__ k, \
      const __nv_bfloat16 *__restrict__ v,                                  \
      const uint8_t *__restrict__ kv_mask, const int *__restrict__ seg,     \
      void *__restrict__ o, float *__restrict__ lse, int H, int Sq, int Skv, \
      int causal, float sm_scale, Strides qs, Strides ks, Strides vs,       \
      Strides os
#define LHRS_FWD_ARGS \
  q, k, v, kv_mask, seg, o, lse, H, Sq, Skv, causal, sm_scale, qs, ks, vs, os

// Serving and vision: no segments, no LSE; the kernel as it was built
// before either existed (ptxas's own register choice).
template <int D, bool kF32Out>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(LHRS_FWD_PARAMS) {
  flash_fwd_tile<D, kF32Out, false, false>(LHRS_FWD_ARGS);
}

// Training: bf16 output with segments and / or the LSE, at most 168
// registers a thread so that three 128-thread CTAs fit an SM (at 170 the
// allocation rounds to 176 and only two fit; capped, ptxas spills a few
// values instead).
template <int D, bool kSeg, bool kLse>
__global__ void __launch_bounds__(kThreads, 3)
    flash_fwd_train_kernel(LHRS_FWD_PARAMS) {
  flash_fwd_tile<D, false, kSeg, kLse>(LHRS_FWD_ARGS);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, const uint8_t* mask, const int* seg,
           void* o, float* lse, int B, int H, int Sq, int Skv, int causal,
           float sm_scale, const long long* st, int out_f32,
           cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const bool seg_on = seg != nullptr, lse_on = lse != nullptr;
  const uint8_t* kv_mask = mask;
#define LHRS_TRAIN(SEG, LSE) \
  flash_fwd_train_kernel<D, SEG, LSE><<<grid, kThreads, 0, stream>>>( \
      LHRS_FWD_ARGS)
  if (out_f32) {
    if (seg_on || lse_on) return (int)cudaErrorInvalidValue;
    flash_fwd_kernel<D, true><<<grid, kThreads, 0, stream>>>(LHRS_FWD_ARGS);
  } else if (seg_on && lse_on) {
    LHRS_TRAIN(true, true);
  } else if (seg_on) {
    LHRS_TRAIN(true, false);
  } else if (lse_on) {
    LHRS_TRAIN(false, true);
  } else {
    flash_fwd_kernel<D, false><<<grid, kThreads, 0, stream>>>(LHRS_FWD_ARGS);
  }
#undef LHRS_TRAIN
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k/v (B,H,Skv,D), o (B,H,Sq,D): bf16 (o float32 when
// out_f32), unit stride along D, the other strides in `strides` (12 element
// strides: batch, head, row of q, k, v, o; multiples of 8, 16-byte aligned
// bases). kv_mask: (B,Skv) bytes (0 = masked) or null. seg: (B,S) int32
// segment ids with S = Sq = Skv, or null. lse: (B,H,Sq) float32 output, or
// null. Segments and the LSE take a bf16 output only. Returns cudaError_t.
extern "C" int lhrs_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kv_mask, const void* seg, void* o,
                              void* lse, int B, int H, int Sq, int Skv, int D,
                              int causal, float sm_scale, const void* strides,
                              int out_f32, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || B * H > 65535 ||
      (seg != nullptr && Sq != Skv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* mp = static_cast<const uint8_t*>(kv_mask);
  const auto* sp = static_cast<const long long*>(strides);
  const auto* gp = static_cast<const int*>(seg);
  auto* lp = static_cast<float*>(lse);
  if (D == 64)
    return launch<64>(qp, kp, vp, mp, gp, o, lp, B, H, Sq, Skv, causal,
                      sm_scale, sp, out_f32, st);
  if (D == 128)
    return launch<128>(qp, kp, vp, mp, gp, o, lp, B, H, Sq, Skv, causal,
                       sm_scale, sp, out_f32, st);
  return (int)cudaErrorInvalidValue;
}
