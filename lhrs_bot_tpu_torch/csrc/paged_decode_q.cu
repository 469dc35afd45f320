// Paged decode append + single-query attention over a shared int8 KV page
// pool with float32 scale pages, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel_pq` of `paged_fused_decode_q`
// (lhrs_bot_tpu/ops/paged_fused.py:52, called at :412). Same semantics:
// pools are (L, N_pages, H, page, D) int8 with (L, N_pages, H, page) scale
// pages, page 0 the null page; for each row b of layer `layer`, the new
// token's int8 K/V row and its two scales are written in place at position
// lengths[b], i.e. page table[b, lengths[b] / page], offset lengths[b] %
// page; then the query attends over the lengths[b] + 1 positions of the
// row through the table, with an f32 online softmax. Roundings are the TPU
// kernel's (and K4's, fused_decode_q.cu): q * sm_scale rounded to bf16
// (:130), the score the dot with the key's codes times its scale (:174),
// p * v_scale rounded to bf16 before the PV product (:198), the
// denominator sums p, the output acc / l in f32, then bf16.
//
// What bounds it on the H100: device-memory bandwidth. Each (b, h) streams
// 2 * (len + 1) * (D + 4) bytes of codes and scales once, far below the
// card's ridge point.
//
// Design: K4's (decode_split.cuh), with the rows taken from pages (the
// `Paged` row source). A head's rows are split across a cluster of C CTAs
// (grid (C, H, B); C from `ops.fused_decode.decode_split_plan` at S = P *
// page, forced by the wrapper's `splits`), each streaming its share
// through a 3-stage ring of bulk copies, one copy a page piece, and rank 0
// merges the CTAs' softmax states over distributed shared memory in the
// same launch. The shares, the key groups and the arithmetic are K4's, so
// at every C the output equals K4's at that C on the same rows gathered
// into a contiguous cache, bit for bit (and at C = 1 the one-CTA paged
// kernel's, which this file replaces). Every rank checks every valid page
// id of its row, so a page outside the pool gives NaN and no write in all
// of them, before any cluster barrier. Ghost rows (an idle slot's table row
// of null pages) append into page 0, which no live row reads: that race is
// benign, and an idle row's output is discarded.

#include "decode_split.cuh"

namespace {

decode_split::PagedArgs paged_args(const void* q, const void* k_new,
                                   const void* k_new_scale,
                                   const void* v_new,
                                   const void* v_new_scale, void* k_pages,
                                   void* v_pages, void* k_scale,
                                   void* v_scale, const void* table,
                                   const void* lengths, void* out, int layer,
                                   int N, int B, int H, int page, int P,
                                   float sm_scale, int fault) {
  decode_split::PagedArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k_new = k_new;
  a.v_new = v_new;
  a.k_new_scale = static_cast<const float*>(k_new_scale);
  a.v_new_scale = static_cast<const float*>(v_new_scale);
  a.k_cache = k_pages;
  a.v_cache = v_pages;
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.layer = layer;
  a.B = B;
  a.H = H;
  a.S = P * page;
  a.sm_scale = sm_scale;
  a.fault = fault;
  a.table = static_cast<const int*>(table);
  a.N = N;
  a.page = page;
  a.P = P;
  return a;
}

}  // namespace

// q/out (B,H,1,D) bf16; k_new/v_new (B,H,1,D) int8; k_new_scale/v_new_scale
// (B,H,1) f32; pools (L,N,H,page,D) int8; scale pools (L,N,H,page) f32;
// table (B,P) and lengths (B,) int32 on the device. All contiguous, 16-byte
// aligned; page a multiple of 16 up to 256, P at most 2048. splits: the
// cluster's CTAs (1, 2, 4 or 8). fault: 0, or a planted error for a check.
// Returns cudaError_t.
extern "C" int lhrs_paged_decode_q(const void* q, const void* k_new,
                                   const void* k_new_scale, const void* v_new,
                                   const void* v_new_scale, void* k_pages,
                                   void* v_pages, void* k_scale, void* v_scale,
                                   const void* table, const void* lengths,
                                   void* out, int layer, int L, int N, int B,
                                   int H, int page, int P, int D,
                                   float sm_scale, int splits, int fault,
                                   void* stream) {
  if (P <= 0 || P > decode_split::kMaxPages) return (int)cudaErrorInvalidValue;
  const decode_split::PagedArgs a = paged_args(
      q, k_new, k_new_scale, v_new, v_new_scale, k_pages, v_pages, k_scale,
      v_scale, table, lengths, out, layer, N, B, H, page, P, sm_scale, fault);
  return decode_split::dispatch<decode_split::Int8Rows, decode_split::Paged>(
      a, L, D, splits, stream, nullptr);
}

// How many clusters of `splits` CTAs of the D = 64 or 128 kernel can be
// resident on the device at once, into *count. Returns cudaError_t.
extern "C" int lhrs_paged_decode_q_max_clusters(int D, int splits,
                                                int* count) {
  decode_split::PagedArgs a{};
  a.B = a.H = a.N = a.P = 1;
  a.page = 16;
  a.S = 16;
  return decode_split::dispatch<decode_split::Int8Rows, decode_split::Paged>(
      a, 1, D, splits, nullptr, count);
}
