// Fused decode append + single-query attention over a stacked bf16 KV cache,
// for Hopper (sm_90a): K2.
//
// Replaces the Pallas TPU kernel `_kernel` of `fused_decode_attention`
// (lhrs_bot_tpu/ops/fused_decode.py:43, called at :201). Same semantics: the
// new K/V row of (layer, b, h) is written in place at row lengths[b] of the
// (L, B, H, S_max, D) cache, then the query attends over rows
// [0, lengths[b]] with an f32 online softmax; q is scaled by sm_scale and
// rounded to bf16 before the dot, and probabilities are rounded to bf16
// before the PV product, as in the TPU kernel.
//
// What bounds it on the H100: device-memory bandwidth. Each (b, h) streams
// 2 * (len+1) * D * 2 bytes of cache for 4 * (len+1) * D flops, far below the
// card's ridge point. The layer index and the lengths are read on the device,
// so a decode step needs no host synchronisation and the stacked cache is
// never copied.
//
// Design: decode_split.cuh, shared with K4 (fused_decode_q.cu). The rows of
// a (b, h) are split across a cluster of C CTAs (C from
// `ops.fused_decode.decode_split_plan`: all of the grid's CTAs resident at
// once), each streaming its share through a ring of bulk copies into
// shared memory, and rank 0 merges the CTAs' softmax states over
// distributed shared memory in the same launch. Inside a CTA the walk and
// the arithmetic are the one-CTA kernel's, so C = 1 gives its bits. What
// bounds the design: the ring's 3 stages of 32 KB of K and V rows and 288
// threads at 95 registers keep 2 CTAs an SM; past a fixed ~5 us a launch
// (the cluster's barriers and the merge among it) the rows stream at the
// memory's rate at B = 1-2 (PERF.md section 6).

#include "decode_split.cuh"

// q/k_new/v_new/out (B,H,1,D), caches (L,B,H,S,D): contiguous bf16, 16-byte
// aligned; lengths (B,) int32 on the device. splits: the cluster's CTAs (1,
// 2, 4 or 8). fault: 0, or a planted error for a check. Returns
// cudaError_t.
extern "C" int lhrs_fused_decode_bf16(const void* q, const void* k_new,
                                      const void* v_new, void* k_cache,
                                      void* v_cache, const void* lengths,
                                      void* out, int layer, int L, int B,
                                      int H, int S, int D, float sm_scale,
                                      int splits, int fault, void* stream) {
  decode_split::Args a{static_cast<const __nv_bfloat16*>(q),
                       k_new,
                       v_new,
                       nullptr,
                       nullptr,
                       k_cache,
                       v_cache,
                       nullptr,
                       nullptr,
                       static_cast<const int*>(lengths),
                       static_cast<__nv_bfloat16*>(out),
                       layer,
                       B,
                       H,
                       S,
                       sm_scale,
                       fault};
  return decode_split::dispatch<decode_split::Bf16Rows>(a, L, D, splits,
                                                        stream, nullptr);
}

// How many clusters of `splits` CTAs of the D = 64 or 128 kernel can be
// resident on the device at once, into *count. Returns cudaError_t.
extern "C" int lhrs_fused_decode_bf16_max_clusters(int D, int splits,
                                                   int* count) {
  decode_split::Args a{};
  a.B = a.H = a.S = 1;
  return decode_split::dispatch<decode_split::Bf16Rows>(a, 1, D, splits,
                                                        nullptr, count);
}
