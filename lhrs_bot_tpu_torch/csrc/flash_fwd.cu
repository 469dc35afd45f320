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
// token-major, (B, S, H, D), as the next projection reads it. Where those
// blocks round the normalised probabilities (their `jnn` and `exp2_pre`
// softmax modes) they launch flash_fwd_norm.cu instead.
//
// What bounds it on the H100: at the decoder-prefill shape (H32, D128, S up
// to 2191, causal) the two matrix products are compute-bound (about 4*S*S*D
// flops per head against 4*S*D bytes, 989 TFLOP/s dense bf16), and only
// wgmma reaches that rate; the softmax between the products (an exp and a
// few float32 operations a score) runs on the CUDA cores and has to overlap
// them. At the ViT/perceiver shapes (S <= 320, D64) a CTA has a few kv
// tiles, and the time goes to the latency of its loads, so several CTAs
// have to share an SM.
//
// Design: one CTA per (batch*head, 64-row q tile), the heaviest causal
// tiles scheduled first, of one consumer warpgroup and one producer warp.
// The producer loads the Q tile once and keeps two rings of two stages in
// flight, 64-row K tiles and V tiles, each as soon as the consumers release
// the stage: TMA copies each 64-column block of a tile into 128-byte
// swizzled shared memory (rows past S arrive as zeros), and the warp's
// lanes write each kv row's key (-1 masked or past Skv, else its segment id
// or 0) beside the K tile before arriving on its "full" mbarrier. The
// consumer computes S = Q K^T with wgmma.mma_async m64n64k16 from shared
// memory (both operands K-major over D) and O += P V with wgmma m64nDk16
// taking P from registers (the score accumulators after the softmax,
// re-packed as bf16 A fragments) and V MN-major through the descriptor's
// transpose bit. Tile i's S and tile i-1's P V are issued together, and
// tile i's mask, scale and online softmax (float32 registers, base-2
// exponent, the scale and log2 e folded into one multiply) run while P V
// retires; the output rows are rescaled after it. A CTA is small (160
// threads, 80 KB of shared memory at D128, 40 KB at D64) so that two (D128)
// or three (D64) share an SM: one CTA's softmax, loads and epilogue then
// overlap another's products. On an H100 this beat CTAs of two consumer
// warpgroups over 128 q rows (one an SM; ptxas holds 384 threads to 168
// registers a thread, setmaxnreg or not, and 128-row kv tiles spill there)
// at every shape (PERF.md). Causal CTAs stop at the diagonal tile.

#include "flash_tiles.cuh"

namespace {

struct Params {
  const uint8_t* kv_mask;  // (B, Skv) or null
  const int* seg;          // (B, S) or null
  void* o;
  float* lse;              // (B, H, Sq) or null
  int H, Sq, Skv, causal;
  float scale_log2;        // sm_scale * log2(e)
  Strides os;
};

// The consumer warpgroup: q rows [q0, q0 + 64). The loop keeps the tensor
// cores busy across the softmax: tile i's S = Q K^T and tile i-1's O += P V
// are issued together, and the softmax of tile i runs while P V retires.
template <int D, bool kF32Out, bool kSeg, bool kLse>
__device__ __forceinline__ void consume(const Params& p, const Smem<D>& sm,
                                        int b, int hd, int bh, int q0,
                                        int n_tiles, int warp, int lane) {
  constexpr int kBN = Cfg<D>::kBN;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g;
  const int qrow[2] = {row0, row0 + 8};
  int segq[2] = {0, 0};  // rows past Sq are segment 0: they attend nothing
  if (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (qrow[r] < p.Sq) segq[r] = p.seg[(size_t)b * p.Sq + qrow[r]];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in units of log2
  float l[2] = {0.f, 0.f};          // per-thread partial row sums
  float sc[kBN / 2], alpha[2];
  uint32_t pf[kBN / 16][4];
  // the masks are needed on a tile with a kv_mask, segments, rows past Skv
  // or columns past the CTA's first row (causal)
  const bool any_mask = p.kv_mask != nullptr || kSeg;
  const auto need_mask = [&](int kv0) {
    return any_mask || kv0 + kBN > p.Skv || (p.causal && kv0 + kBN - 1 > q0);
  };
  sm90::mbar_wait(sm.q_full, 0);

  sm90::mbar_wait(&sm.full_k[0], 0);
  issue_qk<D>(sc, sm.q, sm.k(0));
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  online_softmax<kBN / 2, kSeg>(sc, sm.keys, 0, need_mask(0), p.causal, qrow,
                                segq, p.scale_log2, t, m, l, alpha);
  warp_arrive(&sm.empty_k[0], lane);
  pack_p(pf, sc);
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % kStages, sp = (i - 1) % kStages, kv0 = i * kBN;
    sm90::mbar_wait(&sm.full_k[s], (i / kStages) & 1);
    issue_qk<D>(sc, sm.q, sm.k(s));
    sm90::mbar_wait(&sm.full_v[sp], ((i - 1) / kStages) & 1);
    issue_pv<D>(acc, pf, sm.v(sp));
    sm90::wgmma_wait<1>();  // S of tile i is done; P V of tile i-1 runs on
    sm90::fence_regs(sc);
    online_softmax<kBN / 2, kSeg>(sc, sm.keys + s * kBN, kv0, need_mask(kv0),
                                  p.causal, qrow, segq, p.scale_log2, t, m, l,
                                  alpha);
    warp_arrive(&sm.empty_k[s], lane);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    warp_arrive(&sm.empty_v[sp], lane);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    pack_p(pf, sc);
  }
  const int last = (n_tiles - 1) % kStages;
  sm90::mbar_wait(&sm.full_v[last], ((n_tiles - 1) / kStages) & 1);
  issue_pv<D>(acc, pf, sm.v(last));
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    if (kLse && t == 0 && qrow[r] < p.Sq)
      p.lse[(size_t)bh * p.Sq + qrow[r]] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : 1e30f;
  }
  const size_t ob = b * p.os.b + hd * p.os.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] >= p.Sq) continue;
      const size_t i = ob + (size_t)qrow[r] * p.os.s + c;
      const float v0 = acc[4 * j + 2 * r] * inv[r];
      const float v1 = acc[4 * j + 2 * r + 1] * inv[r];
      if (kF32Out)
        *reinterpret_cast<float2*>(static_cast<float*>(p.o) + i) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.o) + i) =
            pack_bf16(v0, v1);
    }
  }
}

// The producer warp: Q once, then each kv tile's keys and K into a K stage
// and its V into a V stage, each stage as soon as the consumers have
// released it.
template <int D, bool kSeg>
__device__ __forceinline__ void produce(const Params& p, const Smem<D>& sm,
                                        const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int b, int hd,
                                        int q0, int n_tiles, int lane) {
  using C = Cfg<D>;
  if (lane == 0) {
    sm90::mbar_arrive_tx(sm.q_full, C::kQBytes);
    for (int cb = 0; cb < D / 64; ++cb)
      sm90::tma_load_4d(sm.q + cb * C::kBQ * 128, tm_q, sm.q_full, cb * 64,
                        q0, hd, b);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, kv0 = i * C::kBN;
    const uint32_t parity = ((i / kStages) & 1) ^ 1;
    sm90::mbar_wait(&sm.empty_k[s], parity);
    for (int c = lane; c < C::kBN; c += 32) {
      const int kv = kv0 + c;
      int key = -1;
      if (kv < p.Skv &&
          (p.kv_mask == nullptr || p.kv_mask[(size_t)b * p.Skv + kv]))
        key = kSeg ? p.seg[(size_t)b * p.Skv + kv] : 0;
      sm.keys[s * C::kBN + c] = key;
    }
    if (lane == 0) {  // its arrival also counts the tile's bytes
      sm90::mbar_arrive_tx(&sm.full_k[s], C::kTileBytes);
      for (int cb = 0; cb < D / 64; ++cb)
        sm90::tma_load_4d(sm.k(s) + cb * C::kBN * 128, tm_k, &sm.full_k[s],
                          cb * 64, kv0, hd, b);
    } else {
      sm90::mbar_arrive(&sm.full_k[s]);  // releases this lane's keys
    }
    if (lane == 0) {
      sm90::mbar_wait(&sm.empty_v[s], parity);
      sm90::mbar_arrive_tx(&sm.full_v[s], C::kTileBytes);
      for (int cb = 0; cb < D / 64; ++cb)
        sm90::tma_load_4d(sm.v(s) + cb * C::kBN * 128, tm_v, &sm.full_v[s],
                          cb * 64, kv0, hd, b);
    }
  }
}

template <int D, bool kF32Out, bool kSeg, bool kLse>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  using C = Cfg<D>;
  constexpr int kConsumerWarps = 4;
  extern __shared__ uint8_t smem_raw[];
  const Smem<D> sm(smem_raw);
  const int bh = blockIdx.x;
  const int b = bh / p.H, hd = bh % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBQ;  // heaviest first
  const int kv_end = p.causal ? min(p.Skv, q0 + C::kBQ) : p.Skv;
  const int n_tiles = (kv_end + C::kBN - 1) / C::kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full_k[s], 32);
      sm90::mbar_init(&sm.full_v[s], 1);
      sm90::mbar_init(&sm.empty_k[s], kConsumerWarps);
      sm90::mbar_init(&sm.empty_v[s], kConsumerWarps);
    }
    sm90::mbar_init(sm.q_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps)
    produce<D, kSeg>(p, sm, &tm_q, &tm_k, &tm_v, b, hd, q0, n_tiles, lane);
  else
    consume<D, kF32Out, kSeg, kLse>(p, sm, b, hd, bh, q0, n_tiles, warp,
                                    lane);
}

template <int D, bool kF32Out, bool kSeg, bool kLse>
int launch(const CUtensorMap* maps, const Params& p, dim3 grid,
           cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_fwd_kernel<D, kF32Out, kSeg, kLse>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(maps[0], maps[1], maps[2],
                                                  p);
  return (int)cudaGetLastError();
}

// Segments and the LSE take a bf16 output only.
template <int D>
int dispatch(const CUtensorMap* maps, const Params& p, int B, int out_f32,
             cudaStream_t stream) {
  const dim3 grid(B * p.H, (p.Sq + Cfg<D>::kBQ - 1) / Cfg<D>::kBQ);
  const bool seg = p.seg != nullptr, lse = p.lse != nullptr;
  if (out_f32) {
    if (seg || lse) return (int)cudaErrorInvalidValue;
    return launch<D, true, false, false>(maps, p, grid, stream);
  }
  if (seg && lse) return launch<D, false, true, true>(maps, p, grid, stream);
  if (seg) return launch<D, false, true, false>(maps, p, grid, stream);
  if (lse) return launch<D, false, false, true>(maps, p, grid, stream);
  return launch<D, false, false, false>(maps, p, grid, stream);
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
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || (D != 64 && D != 128) ||
      (seg != nullptr && Sq != Skv))
    return (int)cudaErrorInvalidValue;
  const auto* st = static_cast<const long long*>(strides);
  constexpr int bq = Cfg<64>::kBQ, bn = Cfg<64>::kBN;  // as Cfg<128>'s
  if ((Sq + bq - 1) / bq > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  if (!operand_map(&maps[0], q, B, H, Sq, D, st, bq) ||
      !operand_map(&maps[1], k, B, H, Skv, D, st + 3, bn) ||
      !operand_map(&maps[2], v, B, H, Skv, D, st + 6, bn))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.seg = static_cast<const int*>(seg);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.scale_log2 = sm_scale * kLog2e;
  p.os = Strides{st[9], st[10], st[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (D == 128) return dispatch<128>(maps, p, B, out_f32, cs);
  return dispatch<64>(maps, p, B, out_f32, cs);
}
