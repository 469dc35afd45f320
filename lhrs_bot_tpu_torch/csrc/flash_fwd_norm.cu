// Normalize-first attention forward for Hopper (sm_90a): bf16 Q, K, V, f32
// scores, P = exp(s - m) / l over each row's final max m and sum l, P
// rounded to bf16 before P V, no division afterwards; float32 or bf16 out.
//
// Replaces the per-head attention of the Pallas TPU vision kernels where
// they round the NORMALISED probabilities: `_attn_probs_and_norm`
// (lhrs_bot_tpu/ops/vit_block.py:75-86) in its `jnn` and `exp2_pre` softmax
// modes inside `_vit_block_kernel` / `_vit_block_grouped_kernel` (:111,
// :132), and the perceiver block's `jax.nn.softmax` (perceiver_block.py:53);
// the split form's XLA attention rounds there too. K1 (flash_fwd.cu) rounds
// the unnormalised probabilities of an online softmax, as their `exp2_post`
// mode does. Non-causal; optional kv_mask (B, Skv) bytes; a row with no
// valid key gives 0. q, k, v and o are addressed through (batch, head, row)
// element strides, so the blocks read Q, K and V in place from their
// projections and write the output token-major, (B, S, H, D).
//
// What bounds it on the H100: bytes. At ViT-L/14's B64 H16 S257 D64 the two
// products are 17.3 GFLOP (17.5 us at 989 TFLOP/s) against 168 MB read and
// written (50 us at 3.35 TB/s); at the perceiver's 64 x 320, 5.4 GFLOP
// against 109 MB (33 us). So each head's Q, K and V should leave device
// memory once, and loads should stay in flight while the products and the
// softmax run.
//
// Resident design (rows of at most 320 keys at D64, 256 at D128: ViT-B/16's
// 197, ViT-L/14's 257, the perceiver's 320): one CTA per (batch, head), one
// warpgroup and no producer warp. Its thread 0 loads the head's whole K and
// V into shared memory by TMA, each once, and the head's 64-row Q tiles
// through two slots, each next tile as soon as a slot's Q K^T is done. A
// last key tile of at most 8 keys (257 and 197 tokens) arrives as a box of
// 8 rows (K) and 16 (V), else it is taken whole; rows past Skv arrive as
// zeros. For a Q tile the warpgroup computes every score of its 64 rows at
// once: wgmma m64n64k16 for each 64-key tile and m64n8k16 for such a last
// tile, into 32 float32 registers a thread a key tile (160 at 320 keys). It
// then takes each row's exact max and sum from those registers,
// normalises, rounds to bf16 and packs P straight into the A fragments of
// P V, which reads the resident V (m64nDk16, one k16 step for an 8-key
// tile) and is written token-major from the accumulators. Q K^T runs once
// a Q tile, and K and V cross L2 once a head. Two CTAs share an SM (three
// at D64 to 192 keys; one at D128 past 128 keys): 98 KB of shared memory
// at D64 and 320 keys, and with 8 warps an SM a thread may hold 255
// registers, so that one CTA's softmax and loads overlap the other's
// products. The products of a tile are one straight sequence: a branch
// between them made ptxas wait for each one (C7517 / C7519). Measured
// slower on an H100 (PERF.md): a producer warp beside the warpgroup (an
// SM's scheduler then holds three warps of two CTAs, 168 registers a
// thread, and 160 scores spill); a persistent CTA an SM walking heads with
// the next head's K and V in flight (no other CTA's products to overlap);
// two consumer warpgroups and a producer warp in it (168 registers again).
//
// Split design (rows of 321 to 640 keys at D64: ViT-L/14 at 336 px has 577
// tokens, its block pads them to 592, its perceiver's rows hold 64 + 576
// keys; a Q tile's scores no longer fit one warpgroup's registers): one
// CTA per (batch, head) of two consumer warpgroups and no producer warp,
// one CTA an SM (its K and V take 160 KB; eight warps, 255 registers a
// thread). Thread 0 loads the head's K and V once, as the resident path
// does. The ten key tiles are split five and five: each warpgroup runs Q
// K^T once on its half of a Q tile's keys into at most 160 scores a
// thread, taking each tile's exponentials while the next tile's product
// runs (against its own running max: a tile keeps its base until the
// row's is known), then the two exchange each row's max and sum once
// through shared memory, normalise, round and pack P into the A fragments
// of P V over their halves of V, and sum their float32 partial outputs
// through shared memory, each writing 32 of the 64 columns. Rows of 577
// to 584 keys end in an n8 tile; rows of at most 576 keys (no model's)
// run as masked rows of 640. Both warpgroups work on the same Q tile, so
// on an H100 its P V does not overlap any exponentials, and with one CTA
// an SM no other CTA's work fills that time; the designs measured beside
// it are in PERF.md.
//
// Cluster design (rows of 641 to 2,560 keys at D64, designed for ViT-L/14
// at 504 px: 1,297 tokens, as GeoChat runs it, its block pads them to
// 1,312; the host sends it only rows with more than one Q tile of 64, so
// not its perceiver's 64 queries over 64 + 1,296 keys, and not rows of
// 17, 21 or 26 key tiles, 504 px's among them, which the two-pass path
// runs faster): one thread-block cluster of C CTAs per (batch, head), each
// CTA one warpgroup over N = ceil(tiles / C) key-tile slots of a
// contiguous slice (C = 6, N = 4 at 21 and 22 tiles; up to 8 CTAs of 5
// slots, the portable cluster limit), two CTAs an SM at N = 4. Each CTA
// loads its K and V slice once by TMA, so a head's K and V
// leave device memory once; rank 0 multicasts each Q tile into every CTA
// (`.multicast::cluster`) once all have handed its slot back. A CTA runs
// the split path's warpgroup walk on its slots (Q K^T once, each slot's
// exponentials against the running max while the next slot's product
// runs), sends its rows' max and sum to every rank by st.async, forms each
// row's final max and sum from all C in rank order, normalises, rounds and
// packs P into P V over its V slots, and sends each unit of its float32
// partial output (4 floats a thread) to the rank that owns it, which sums
// the C units in rank order and writes them token-major. No cluster
// barrier runs inside the loop: a CTA's stores into a peer for a Q tile
// follow the peers' row stats of that tile, which each sends only after
// reading what it received for the tile before. Every CTA of a launch runs
// the same code (CTAs of different slot counts on one SM ran slower), so
// a short rank's last slot is a masked dummy and, without a kv_mask, only
// a CTA's last slot is masked. What bounds it on the H100: per Q tile a
// CTA waits twice on its peers and runs the exponentials, the float32
// rescale and the bf16 packing of its slots, with one other CTA an SM to
// overlap: PERF.md has the designs measured. With one Q tile a head
// nothing hides a CTA's slice load and the cluster's barriers, and the
// two-pass path is faster there (the 504-px perceiver's rows).
//
// Two-pass design (every row the other paths are not given: D128 past 256
// keys, D64 past the cluster's 2,560 keys, D64 past 640 keys with one Q
// tile a head: the 504-px perceiver's 64 x 1,360, and rows of 17, 21 and
// 26 key tiles, ViT-L/14 at 504 px's 21 among them, where it reads faster
// than the cluster path; at the cluster's other rows it reads slower,
// PERF.md). What bounds
// it on the H100: each score takes two exponentials (pass 1 for the row's
// max and sum, pass 2 for P), and with a 64-key tile the float32 work around
// them (max, mask, sum, packing) costs more issue slots than the MUFU's exp2
// rate allows for: the walk is bound by instruction issue and by the latency
// a warpgroup waits on its products, then by the MUFU (3.9 T exp2/s: 0.95 ms
// at ViT-L/14 504 px), not by bytes (one Q tile a head aside: the 504-px
// perceiver's 64 x 1,360 is bound by its K and V). The design: a 288-thread
// CTA, one an SM, of two consumer warpgroups and a producer warp (its first
// thread issues every TMA load; ptxas still allots 168 registers a thread,
// as for 384 threads, so a step holds two score tiles at most). A CTA
// takes a pair of a head's Q tiles, one a warpgroup; both read every K and
// V tile of shared rings and take turns to issue (named barriers), so that
// one's exponentials run under the other's products. A head's odd last Q
// tile, and every Q tile of a head of one, takes a CTA whose warpgroups
// split its key tiles (ceil(tiles / 2) each, the last of an odd count a
// masked dummy), exchange each row's max and sum once after pass 1 and sum
// their float32 partial outputs once after pass 2. K stays in shared memory
// between the passes where the row's key tiles fit beside the V ring (each
// K tile loaded once; at D64 rows to 1,408 keys: the 504-px ViT and its
// perceiver), else it passes through a ring twice, from L2 the second
// time; the host plans the slots (ops/attention.py's `norm_two_pass_plan`)
// and the launch checks them. A launch with split CTAs takes rings of an
// even size: a split CTA's warpgroups take alternate positions of a ring,
// and in a ring of an odd size a slot would pass from one to the other at
// every phase, so that a warpgroup waiting on its phase could take the
// other's, still in flight, for it (a barrier's wait tells phases apart by
// parity alone): an H100 read stale V tiles so at ViT-L/14 504 px, rarely.
// A warpgroup walks two tiles a step: both Q K^T issued at once, the first
// tile's exponentials under the second's product and, in pass 2, the
// second's under the first's P V, the mask from
// key bits read from device memory once a head (only on tiles that hold
// keys that do not attend), P = 2^(s scale_log2 - max - log2 sum) rounded
// straight into P V's A fragments. No product stays in flight across a
// branch or the loop's back edge, and no branch surrounds code that writes
// the scores (the mask is a select): either made ptxas serialise every
// wgmma (C7517, C7518). Every named barrier and product is preceded by a
// __syncwarp (they are .aligned: a warp's lanes must reach them together).
//
// fault = 1 skips the normalisation (P = exp2(s - m) rounded): a planted
// fault for the card's checks.

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

// the resident path's longest rows: 5 score tiles at D64, 4 at D128
constexpr int res_keys(int D) { return D == 64 ? 320 : 256; }
// the split path's (D64): 5 score tiles in each of two warpgroups
constexpr int split_keys = 640;

struct NormParams {
  const uint8_t* kv_mask;  // (B, Skv) or null
  void* o;
  int H, Sq, Skv, out_f32, fault;
  float scale_log2;  // sm_scale * log2(e)
  Strides os;
};

// One output row pair of a thread (rows qrow[0], qrow[1] of the head,
// columns 8 j + 2 t, + 1 for j in [J0, J0 + NJ)), from accumulators that
// need no rescaling.
template <int D, int J0 = 0, int NJ = D / 8>
__device__ __forceinline__ void store_rows(const NormParams& p,
                                           const float (&acc)[D / 2], int b,
                                           int hd, const int (&qrow)[2],
                                           int t) {
  const size_t ob = b * p.os.b + hd * p.os.h;
#pragma unroll
  for (int j = J0; j < J0 + NJ; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] >= p.Sq) continue;
      const size_t i = ob + (size_t)qrow[r] * p.os.s + c;
      const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (p.out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(p.o) + i) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.o) + i) =
            pack_bf16(v0, v1);
    }
  }
}

// ---- resident path ----------------------------------------------------------

// P: 1 when the last key tile holds at most 8 keys (one n8 product, one
// k16 step of P V), 0 when it is taken whole (64 keys, or a longer tail:
// its K and V arrive as 64 rows, those past Skv zeros).
template <int D, int NT, int P>
struct Res {
  static constexpr int kBQ = 64;  // q rows a tile
  static constexpr int kBN = 64;  // keys a score tile
  static constexpr int kThreads = 128;
  static constexpr int kQBytes = kBQ * D * 2;     // one Q tile
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kSmem = 1024 + 2 * kQBytes + 2 * NT * kTileBytes +
                               NT * kBN * 4 + (NT + 3) * 8;
  // CTAs an SM: as many as their shared memory lets, at most two, or
  // three at D64 to 192 keys (an SM's scheduler then holds three warps:
  // 168 registers a thread, room for 96 scores)
  static constexpr int kFit = 233472 / (kSmem + 1024);
  static constexpr int kMinBlocks =
      kFit < 2 ? 1 : (D == 64 && NT <= 3 && kFit >= 3 ? 3 : 2);
};

// Shared memory of a resident CTA: two Q tiles, the head's K tiles, its V
// tiles, each key's flag and the barriers (one a K tile, so that Q K^T
// starts on the tiles that have landed). A tile is D / 64 column blocks of
// 64 rows x 128 bytes, as K1's.
template <int D, int NT, int P>
struct ResSmem {
  using C = Res<D, NT, P>;
  uint8_t* q;
  uint8_t* k;
  uint8_t* v;
  int* flags;  // (NT * kBN)
  uint64_t* k_full;  // (NT)
  uint64_t* v_full;
  uint64_t* q_full;  // (2)

  __device__ explicit ResSmem(uint8_t* raw) {
    q = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    k = q + 2 * C::kQBytes;
    v = k + NT * C::kTileBytes;
    flags = reinterpret_cast<int*>(v + NT * C::kTileBytes);
    k_full = reinterpret_cast<uint64_t*>(flags + NT * C::kBN);
    v_full = k_full + NT;
    q_full = v_full + 1;
  }
};

// Loads key tile i of the head's K, completing on `bar`: 64 rows, or (P,
// the last tile) its first 8 through `tm_tail`.
template <int D, int NT, int P>
__device__ __forceinline__ void load_k_tile(uint8_t* k, const CUtensorMap* tm,
                                            const CUtensorMap* tm_tail,
                                            uint64_t* bar, int i, int hd,
                                            int b) {
  const bool tail = P && i == NT - 1;
  sm90::mbar_arrive_tx(bar, (tail ? 8 : 64) * D * 2);
  for (int cb = 0; cb < D / 64; ++cb)
    sm90::tma_load_4d(k + i * 64 * D * 2 + cb * 64 * 128, tail ? tm_tail : tm,
                      bar, cb * 64, i * 64, hd, b);
}

// S = Q K^T of one Q tile against the head's resident K: a wgmma m64n64k16
// chain per whole 64-key tile, then (P) an m64n8k16 chain over the last
// tile's 8 keys, each tile's as soon as its K has landed. No branch
// between a tile's products: one makes ptxas wait for each (C7517 /
// C7519).
template <int D, int NT, int P>
__device__ __forceinline__ void res_qk(float (&sc)[NT][32], const uint8_t* sq,
                                       const uint8_t* sk0, uint64_t* k_full) {
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    sm90::mbar_wait(&k_full[c], 0);
    sm90::fence_regs(sc[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk / 4, kc = (kk % 4) * 32;
      const uint64_t da = sm90::desc_sw128(sq + cb * 64 * 128 + kc, 16, 1024);
      const uint64_t db = sm90::desc_sw128(
          sk0 + c * 64 * D * 2 + cb * 64 * 128 + kc, 16, 1024);
      if (P && c == NT - 1)
        sm90::wgmma_bf16_ss_m64n8k16(sc[c], da, db, kk > 0);
      else
        sm90::wgmma_bf16_ss_m64n64k16(sc[c], da, db, kk > 0);
    }
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
}

// O = P V against the head's resident V: the four k16 steps of each whole
// 64-key tile, then (P) the last tile's first.
template <int D, int NT, int P>
__device__ __forceinline__ void res_pv(float (&acc)[D / 2],
                                       uint32_t (&pf)[NT][4][4],
                                       const uint8_t* sv0) {
#pragma unroll
  for (int c = 0; c < NT; ++c) sm90::fence_regs(pf[c]);
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int j2 = 0; j2 < (P && c == NT - 1 ? 1 : 4); ++j2) {
      const uint64_t dv = sm90::desc_sw128(
          sv0 + c * 64 * D * 2 + j2 * 16 * 128, 64 * 128, 1024);
      if constexpr (D == 64)
        sm90::wgmma_bf16_rs_m64n64k16(acc, pf[c][j2], dv);
      else
        sm90::wgmma_bf16_rs_m64n128k16(acc, pf[c][j2], dv);
    }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
}

// One CTA a head: a consumer warpgroup whose thread 0 issues the loads (K,
// Q tile 0, V, Q tile 1, then each next Q tile into the slot whose Q K^T
// is done) and which runs every Q tile of the head against the resident K
// and V. Element i of a score tile sits at row g + 8 * ((i >> 1) & 1) of
// the warp's 16 and column 8 * (i >> 2) + 2t + (i & 1) (K1's layout).
template <int D, int NT, int P>
__global__ void __launch_bounds__(128, (Res<D, NT, P>::kMinBlocks))
    flash_norm_resident_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_kt,
                               const __grid_constant__ CUtensorMap tm_vt,
                               const NormParams p) {
  using C = Res<D, NT, P>;
  constexpr int kBN = C::kBN;
  constexpr int kVBytes = ((NT - P) * kBN + 16 * P) * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const ResSmem<D, NT, P> sm(smem_raw);
  const int b = blockIdx.x / p.H, hd = blockIdx.x % p.H;
  const int nq = (p.Sq + C::kBQ - 1) / C::kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool issuer = threadIdx.x == 0;
  const auto load_q = [&](int i) {
    uint64_t* bar = &sm.q_full[i & 1];
    sm90::mbar_arrive_tx(bar, C::kQBytes);
    for (int cb = 0; cb < D / 64; ++cb)
      sm90::tma_load_4d(sm.q + (i & 1) * C::kQBytes + cb * C::kBQ * 128,
                        &tm_q, bar, cb * 64, i * C::kBQ, hd, b);
  };
  if (issuer) {  // the loads go out first; the flags are written meanwhile
    for (int c = 0; c < NT; ++c) sm90::mbar_init(&sm.k_full[c], 1);
    sm90::mbar_init(sm.v_full, 1);
    sm90::mbar_init(&sm.q_full[0], 1);
    sm90::mbar_init(&sm.q_full[1], 1);
    sm90::mbar_fence_init();
    for (int c = 0; c < NT; ++c)
      load_k_tile<D, NT, P>(sm.k, &tm_k, &tm_kt, &sm.k_full[c], c, hd, b);
    load_q(0);
    // V on one barrier: its last tile (P) as 16 rows through tm_vt
    sm90::mbar_arrive_tx(sm.v_full, kVBytes);
    for (int c = 0; c < NT; ++c)
      for (int cb = 0; cb < D / 64; ++cb)
        sm90::tma_load_4d(sm.v + c * C::kTileBytes + cb * 64 * 128,
                          P && c == NT - 1 ? &tm_vt : &tm_v, sm.v_full,
                          cb * 64, c * 64, hd, b);
    if (nq > 1) load_q(1);
  }
  for (int c = threadIdx.x; c < NT * kBN; c += C::kThreads)
    sm.flags[c] = c < p.Skv && (p.kv_mask == nullptr ||
                                p.kv_mask[(size_t)b * p.Skv + c])
                      ? 0
                      : -1;
  __syncthreads();  // the barriers' initialisation and the flags
  // bit 16 c + 2 j + h: the key 64 c + 8 j + 2 t + h is attended
  uint32_t ok[(NT * 16 + 31) / 32];
#pragma unroll
  for (int w = 0; w < (NT * 16 + 31) / 32; ++w) ok[w] = 0;
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bit = 16 * c + 2 * j + h;
        if (sm.flags[kBN * c + 8 * j + 2 * t + h] >= 0)
          ok[bit >> 5] |= 1u << (bit & 31);
      }
  // the tiles whose keys all attend need no mask
  const bool masked = p.kv_mask != nullptr;
  const bool last_masked = masked || p.Skv < NT * kBN;

  float sc[NT][kBN / 2];
  uint32_t pf[NT][kBN / 16][4];
  float acc[D / 2];
  for (int i = 0; i < nq; ++i) {
    sm90::mbar_wait(&sm.q_full[i & 1], (i >> 1) & 1);
    // S = Q K^T over every key of the head, once. The scores are written
    // first: the n8 product leaves the rest of the tail tile unwritten, and
    // the last tile's values would otherwise stay live through P V (wgmma
    // reads its accumulators)
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) sc[c][e] = 0.f;
    res_qk<D, NT, P>(sc, sm.q + (i & 1) * C::kQBytes, sm.k, sm.k_full);
    // this slot's Q is read: it takes tile i + 2
    if (issuer && i + 2 < nq) load_q(i + 2);

    // mask, the row's exact max and sum (the scale folded into the
    // exponent's FFMA: scale_log2 > 0), then P normalised
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const bool need = c == NT - 1 ? last_masked : masked;
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        const int bit = 16 * c + 2 * (e >> 2) + (e & 1);
        if (need && !((ok[bit >> 5] >> (bit & 31)) & 1u)) sc[c][e] = kNegInf;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[c][e]);
      }
    }
    float base[2], l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no valid key: its masked scores must give exp 0
      base[r] = mx[r] == kNegInf ? 0.f : mx[r] * p.scale_log2;
    }
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        sc[c][e] = ex2(fmaf(sc[c][e], p.scale_log2, -base[(e >> 1) & 1]));
        l[(e >> 1) & 1] += sc[c][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = p.fault ? 1.f : l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < NT; ++c) {
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) sc[c][e] *= inv[(e >> 1) & 1];
      pack_p<kBN / 2>(pf[c], sc[c]);
    }

    // O = P V from the resident V, over the k16 steps that hold keys
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
    sm90::mbar_wait(sm.v_full, 0);
    res_pv<D, NT, P>(acc, pf, sm.v);
    const int row0 = i * C::kBQ + 16 * warp + g;
    const int qrow[2] = {row0, row0 + 8};
    store_rows<D>(p, acc, b, hd, qrow, t);
  }
}

template <int D, int NT, int P>
int launch_resident(const CUtensorMap* maps, const NormParams& p, int B,
                    cudaStream_t stream) {
  using C = Res<D, NT, P>;
  auto kernel = flash_norm_resident_kernel<D, NT, P>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * p.H, C::kThreads, C::kSmem, stream>>>(maps[0], maps[1],
                                                     maps[2], maps[3],
                                                     maps[4], p);
  return (int)cudaGetLastError();
}

template <int D, int NT>
int launch_resident(const CUtensorMap* maps, const NormParams& p, int B,
                    cudaStream_t stream) {
  const int tail = p.Skv % 64;
  return tail > 0 && tail <= 8
             ? launch_resident<D, NT, 1>(maps, p, B, stream)
             : launch_resident<D, NT, 0>(maps, p, B, stream);
}

template <int D>
int dispatch_resident(const CUtensorMap* maps, const NormParams& p, int B,
                      cudaStream_t stream) {
  switch ((p.Skv + 63) / 64) {
    case 1: return launch_resident<D, 1>(maps, p, B, stream);
    case 2: return launch_resident<D, 2>(maps, p, B, stream);
    case 3: return launch_resident<D, 3>(maps, p, B, stream);
    case 4: return launch_resident<D, 4>(maps, p, B, stream);
    case 5:
      if constexpr (D == 64) return launch_resident<D, 5>(maps, p, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- split path ---------------------------------------------------------------

// Rows of 321 to 640 keys at D64: ten key tiles, the first five for
// warpgroup 0 and the other five for warpgroup 1 (the resident path's 160
// scores a thread in each). P: the last tile holds at most 8 keys (577 to
// 584 keys). kMask: some tile other than the last may hold keys that do
// not attend (a kv_mask, or rows of at most 576 keys: the tiles past them
// are zeros, masked); without it only the last tile is masked, and only
// when it holds keys past Skv.
constexpr int kSplitTiles = 10;

struct Split {
  static constexpr int kBQ = 64;
  static constexpr int kBN = 64;
  static constexpr int kThreads = 256;
  static constexpr int kTileBytes = 64 * 64 * 2;  // a Q, K or V tile
  static constexpr int kXFloats = 16 * 128;  // the partial outputs handed over
  static constexpr int kSmem = 1024 + 2 * kTileBytes +
                               2 * kSplitTiles * kTileBytes +
                               2 * kXFloats * 4 + 2 * 2 * kBQ * 4 +
                               4 * kSplitTiles * 2 + (kSplitTiles + 4) * 8;
};

// Shared memory of a split CTA: two Q tiles, the head's K and V tiles, the
// half of its partial output each warpgroup hands the other, each
// warpgroup's row maxima and sums, the key bits and the barriers (one a K
// tile, one for each warpgroup's V tiles, one a Q slot).
struct SplitSmem {
  uint8_t* q;
  uint8_t* k;
  uint8_t* v;
  float* xo;     // (2, 16, 128): [receiving warpgroup][element][thread]
  float* stats;  // (2, 2, 64): [warpgroup][max, sum][row]
  // (4, kSplitTiles): [t][tile] bit 2 j + h: key 64 tile + 8 j + 2 t + h
  // attends (kMask)
  uint16_t* okw;
  uint64_t* k_full;  // (kSplitTiles)
  uint64_t* v_full;  // (2)
  uint64_t* q_full;  // (2)

  __device__ explicit SplitSmem(uint8_t* raw) {
    constexpr int kTile = Split::kTileBytes;
    q = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    k = q + 2 * kTile;
    v = k + kSplitTiles * kTile;
    xo = reinterpret_cast<float*>(v + kSplitTiles * kTile);
    stats = xo + 2 * Split::kXFloats;
    okw = reinterpret_cast<uint16_t*>(stats + 2 * 2 * 64);
    k_full = reinterpret_cast<uint64_t*>(okw + 4 * kSplitTiles);
    v_full = k_full + kSplitTiles;
    q_full = v_full + 2;
  }
};

// f(std::integral_constant<int, C>()) for C = 0 .. N - 1, each with its
// index as a constant (a wgmma wait takes its count as one)
template <int C, int N>
struct Unrolled {
  template <class F>
  static __device__ __forceinline__ void run(F& f) {
    f(std::integral_constant<int, C>());
    Unrolled<C + 1, N>::run(f);
  }
};
template <int N>
struct Unrolled<N, N> {
  template <class F>
  static __device__ __forceinline__ void run(F&) {}
};

// Q tile i of the head into slot i & 1.
__device__ __forceinline__ void split_load_q(const SplitSmem& sm,
                                             const CUtensorMap* tm_q, int i,
                                             int hd, int b) {
  uint64_t* bar = &sm.q_full[i & 1];
  sm90::mbar_arrive_tx(bar, Split::kTileBytes);
  sm90::tma_load_4d(sm.q + (i & 1) * Split::kTileBytes, tm_q, bar, 0, i * 64,
                    hd, b);
}

// S = Q K^T of key tile c (n8: its first 8 keys) as one commit group, not
// waited for, from the descriptors of the Q tile and of the first key
// tile (each k16 step 32 bytes on, each key tile 8 KB: the address field
// counts 16 bytes)
template <bool kN8>
__device__ __forceinline__ void split_qk(float (&sc)[32], uint64_t dq,
                                         uint64_t dk, int c,
                                         uint64_t* k_full) {
  sm90::mbar_wait(&k_full[c], 0);
  sm90::fence_regs(sc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = dk + c * (Split::kTileBytes >> 4) + 2 * kk;
    if (kN8)
      sm90::wgmma_bf16_ss_m64n8k16(sc, dq + 2 * kk, db, kk > 0);
    else
      sm90::wgmma_bf16_ss_m64n64k16(sc, dq + 2 * kk, db, kk > 0);
  }
  sm90::wgmma_commit();
}

// Warpgroup W's walk over the head's Q tiles, on its five key tiles from
// tile c0 = 5 W (the last with at most 8 keys if P: only its first 4
// scores a thread exist). For a Q tile it issues the Q K^T of each key
// tile before taking the exponentials of the one before, against this
// thread's running row max (each tile keeps its base: its exponentials
// are rescaled once the row's max is known), so that a tile's
// exponentials overlap the next tile's products. The warpgroup's row max
// and sum go to the other warpgroup through shared memory, and the row's
// come back from both. Each tile's probabilities are multiplied by
// 2^(tile base - row base) / sum, rounded to bf16 and packed into P V's A
// fragments, and the tile's P V issued at once over its resident V tile,
// so that the next tile's packing overlaps it. Each warpgroup then hands
// the other the 32 columns of its float32 partial output that the other
// writes, adds what it receives and writes its 32 columns.
template <int P, int W, bool kMask>
__device__ __forceinline__ void split_walk(const NormParams& p,
                                           const SplitSmem& sm,
                                           const CUtensorMap* tm_q, int b,
                                           int hd, int nq) {
  constexpr int N = kSplitTiles / 2, kBN = 64, c0 = W * N;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl = p.scale_log2;
  const int row0 = 16 * warp + g;
  // bit 16 c + 2 j + h: the key 64 (c0 + c) + 8 j + 2 t + h attends; only
  // the last tile is masked without kMask, by Skv
  uint32_t ok[(N * 16 + 31) / 32];
#pragma unroll
  for (int w = 0; w < (N * 16 + 31) / 32; ++w) ok[w] = 0;
  if (kMask) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      ok[c / 2] |= uint32_t(sm.okw[t * kSplitTiles + c0 + c]) << (16 * (c % 2));
  } else if (W == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bit = 16 * (N - 1) + 2 * j + h;
        if (kBN * (kSplitTiles - 1) + 8 * j + 2 * t + h < p.Skv)
          ok[bit >> 5] |= 1u << (bit & 31);
      }
  }
  const bool last_masked = kMask || (W == 1 && p.Skv < kSplitTiles * kBN);
  const uint64_t dk = sm90::desc_sw128(sm.k + c0 * Split::kTileBytes, 16, 1024);
  const uint64_t dv = sm90::desc_sw128(sm.v + c0 * Split::kTileBytes,
                                       64 * 128, 1024);

  float sc[N][kBN / 2];
  uint32_t pf[N][kBN / 16][4];
  float acc[32];
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) sc[c][e] = 0.f;
  for (int i = 0; i < nq; ++i) {
    sm90::mbar_wait(&sm.q_full[i & 1], (i >> 1) & 1);
    const uint64_t dq =
        sm90::desc_sw128(sm.q + (i & 1) * Split::kTileBytes, 16, 1024);

    // running max (raw scores, kNegInf while every key so far is masked),
    // the base of the exponentials in units of log2 (0 while so), the sum
    // against it, and each tile's base
    float mr[2] = {kNegInf, kNegInf}, bb[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
    float bt[N][2];
    split_qk<false>(sc[0], dq, dk, 0, sm.k_full + c0);
    auto tile = [&](auto ci) {
      constexpr int c = decltype(ci)::value;
      // the elements a thread holds: 4 of an n8 tile
      constexpr int kE = P && c == N - 1 ? 4 : kBN / 2;
      if constexpr (c + 1 < N) {
        split_qk<P && c + 1 == N - 1>(sc[c + 1], dq, dk, c + 1,
                                      sm.k_full + c0);
        sm90::wgmma_wait<1>();
      } else {
        sm90::wgmma_wait<0>();
      }
      sm90::fence_regs(sc[c]);
      const bool need = kMask || (c == N - 1 && last_masked);
      float mx[2] = {mr[0], mr[1]};
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int bit = 16 * c + 2 * (e >> 2) + (e & 1);
        if (need && !((ok[bit >> 5] >> (bit & 31)) & 1u)) sc[c][e] = kNegInf;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[c][e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float nb = mx[r] == kNegInf ? 0.f : mx[r] * sl;
        // a base only rises once a key is valid (from 0 it may fall: l
        // is 0 then)
        l[r] *= ex2(fminf(bb[r] - nb, 0.f));
        bb[r] = bt[c][r] = nb;
        mr[r] = mx[r];
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        sc[c][e] = ex2(fmaf(sc[c][e], sl, -bb[(e >> 1) & 1]));
        l[(e >> 1) & 1] += sc[c][e];
      }
    };
    Unrolled<0, N>::run(tile);

    // the warpgroup's row max and sum, then the row's, from both
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = fmaxf(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float bq = m == kNegInf ? 0.f : m * sl;
      l[r] *= ex2(fminf(bb[r] - bq, 0.f));
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      mr[r] = m;
      bb[r] = bq;
      if (t == 0) {
        sm.stats[(2 * W) * 64 + row0 + 8 * r] = m;
        sm.stats[(2 * W + 1) * 64 + row0 + 8 * r] = l[r];
      }
    }
    sm90::bar_sync(1, 256);
    // both warpgroups' Q K^T of this slot are done: it takes tile i + 2
    if (W == 0 && tid == 0 && i + 2 < nq) split_load_q(sm, tm_q, i + 2, hd, b);
    float base[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mo = sm.stats[(2 * (1 - W)) * 64 + row0 + 8 * r];
      const float lo = sm.stats[(2 * (1 - W) + 1) * 64 + row0 + 8 * r];
      const float m = fmaxf(mr[r], mo);
      // a row with no valid key: its masked scores gave exp 0
      base[r] = m == kNegInf ? 0.f : m * sl;
      const float bo = mo == kNegInf ? 0.f : mo * sl;
      // the same sum in both warpgroups (addition commutes)
      const float sum = l[r] * ex2(fminf(bb[r] - base[r], 0.f)) +
                        lo * ex2(fminf(bo - base[r], 0.f));
      inv[r] = p.fault ? 1.f : sum > 0.f ? 1.f / sum : 0.f;
    }

    // O = P V over the warpgroup's V tiles, a tile's as soon as it is
    // packed, then the two halves summed
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    sm90::mbar_wait(&sm.v_full[W], 0);
#pragma unroll
    for (int c = 0; c < N; ++c) {
      float f[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        f[r] = ex2(fminf(bt[c][r] - base[r], 0.f)) * inv[r];
      if (P && c == N - 1) {  // keys 0-7 of the first k16 step
#pragma unroll
        for (int q = 0; q < 2; ++q)
          pf[c][0][q] = pack_bf16(sc[c][2 * q] * f[q],
                                  sc[c][2 * q + 1] * f[q]);
        pf[c][0][2] = pf[c][0][3] = 0u;
      } else {
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) sc[c][e] *= f[(e >> 1) & 1];
        pack_p<kBN / 2>(pf[c], sc[c]);
      }
      sm90::fence_regs(pf[c]);
      if (c == 0) sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int j2 = 0; j2 < (P && c == N - 1 ? 1 : 4); ++j2)
        sm90::wgmma_bf16_rs_m64n64k16(
            acc, pf[c][j2],
            dv + ((c * Split::kTileBytes + j2 * 16 * 128) >> 4));
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    float* give = sm.xo + (1 - W) * Split::kXFloats;
    const float* take = sm.xo + W * Split::kXFloats;
#pragma unroll
    for (int e = 0; e < 16; ++e) give[e * 128 + tid] = acc[16 * (1 - W) + e];
    sm90::bar_sync(1, 256);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[16 * W + e] += take[e * 128 + tid];
    const int qrow[2] = {i * 64 + row0, i * 64 + row0 + 8};
    store_rows<64, 4 * W, 4>(p, acc, b, hd, qrow, t);
  }
}

// One CTA a head, two consumer warpgroups and no producer warp (one CTA an
// SM: its K and V take 160 KB); thread 0 issues the loads (Q tile 0, the K
// tiles of both warpgroups in turn, each warpgroup's V, Q tile 1, then
// each next Q tile once both warpgroups' Q K^T of its slot are done).
template <int P, bool kMask>
__global__ void __launch_bounds__(256, 1)
    flash_norm_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_kt,
                            const __grid_constant__ CUtensorMap tm_vt,
                            const NormParams p) {
  constexpr int NT = kSplitTiles, N = NT / 2, kBN = Split::kBN;
  extern __shared__ uint8_t smem_raw[];
  const SplitSmem sm(smem_raw);
  const int b = blockIdx.x / p.H, hd = blockIdx.x % p.H;
  const int nq = (p.Sq + Split::kBQ - 1) / Split::kBQ;
  if (threadIdx.x == 0) {  // the loads go out first
    for (int c = 0; c < NT; ++c) sm90::mbar_init(&sm.k_full[c], 1);
    for (int w = 0; w < 2; ++w) {
      sm90::mbar_init(&sm.v_full[w], 1);
      sm90::mbar_init(&sm.q_full[w], 1);
    }
    sm90::mbar_fence_init();
    split_load_q(sm, &tm_q, 0, hd, b);
    for (int c = 0; c < N; ++c)
      for (int w = 0; w < 2; ++w)
        load_k_tile<64, NT, P>(sm.k, &tm_k, &tm_kt, &sm.k_full[w * N + c],
                               w * N + c, hd, b);
    // each warpgroup's V on its barrier: the last tile (P) as 16 rows
    for (int w = 0; w < 2; ++w) {
      sm90::mbar_arrive_tx(&sm.v_full[w],
                           ((N - P * w) * kBN + 16 * P * w) * 128);
      for (int c = w * N; c < w * N + N; ++c)
        sm90::tma_load_4d(sm.v + c * Split::kTileBytes,
                          P && c == NT - 1 ? &tm_vt : &tm_v, &sm.v_full[w],
                          0, c * kBN, hd, b);
    }
    if (nq > 1) split_load_q(sm, &tm_q, 1, hd, b);
  }
  if (kMask && threadIdx.x < 4 * NT) {  // the key bits (okw)
    const int tt = threadIdx.x / NT, cc = threadIdx.x % NT;
    uint32_t bits = 0;
    for (int j = 0; j < 8; ++j)
      for (int h = 0; h < 2; ++h) {
        const int key = kBN * cc + 8 * j + 2 * tt + h;
        if (key < p.Skv &&
            (p.kv_mask == nullptr || p.kv_mask[(size_t)b * p.Skv + key]))
          bits |= 1u << (2 * j + h);
      }
    sm.okw[threadIdx.x] = (uint16_t)bits;
  }
  __syncthreads();  // the barriers' initialisation and the key bits
  if (threadIdx.x < 128)
    split_walk<0, 0, kMask>(p, sm, &tm_q, b, hd, nq);
  else
    split_walk<P, 1, kMask>(p, sm, &tm_q, b, hd, nq);
}

template <int P, bool kMask>
int launch_split(const CUtensorMap* maps, const NormParams& p, int B,
                 cudaStream_t stream) {
  auto kernel = flash_norm_split_kernel<P, kMask>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Split::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * p.H, Split::kThreads, Split::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return (int)cudaGetLastError();
}

// Rows of 577 to 584 keys end in a tile of at most 8; rows of at most 576
// keys (no model's) run as masked rows of 640, the tiles past them zeros.
int dispatch_split(const CUtensorMap* maps, const NormParams& p, int B,
                   cudaStream_t stream) {
  const int tail = p.Skv - (kSplitTiles - 1) * 64;
  const bool mask = p.kv_mask != nullptr || tail <= 0;
  if (tail > 0 && tail <= 8)
    return mask ? launch_split<1, true>(maps, p, B, stream)
                : launch_split<1, false>(maps, p, B, stream);
  return mask ? launch_split<0, true>(maps, p, B, stream)
              : launch_split<0, false>(maps, p, B, stream);
}

// ---- cluster path -------------------------------------------------------------

// Rows of 641 to 2,560 keys at D64: the head's nt key tiles split over a
// cluster of C CTAs (2 <= C <= 8, the portable limit), each CTA N =
// ceil(nt / C) tile slots, 3 <= N <= 5 (at most the resident path's 160
// scores a thread). The first C N - nt ranks hold N - 1 tiles and a masked
// dummy slot (the next rank's first tile: finite values), the others N
// tiles; so without a kv_mask a CTA masks its last slot only (the row's
// last tile, whose rows past Skv arrive as zeros, or its dummy), and every
// CTA of a launch runs the same code (one walk instance a kernel).
constexpr int kClusterTiles = 5;
constexpr int kMaxCluster = 8;
constexpr int cluster_keys = kMaxCluster * kClusterTiles * 64;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// The first tile and the tiles (N or N - 1) of rank r of C over nt tiles.
__host__ __device__ inline void cluster_slice(int nt, int C, int r, int& c0,
                                              int& n) {
  const int N = ceil_div(nt, C), short_ranks = C * N - nt;
  n = r < short_ranks ? N - 1 : N;
  c0 = r < short_ranks ? r * (N - 1)
                       : short_ranks * (N - 1) + (r - short_ranks) * N;
}

struct Clu {
  static constexpr int kThreads = 128;
  static constexpr int kTileBytes = 64 * 64 * 2;  // a Q, K or V tile
  // A thread's 32 partial-output floats are 8 units of 4 (columns 8 j +
  // 2 t, + 1 of its two rows); each of the CTA's 32 (warp, j) units
  // belongs to one rank, which receives it from each of the C - 1 others:
  // at most (C - 1) * ceil(32 / C) * 32 lanes * 16 bytes, 15,360 at C = 6
  // or 7
  static constexpr int kXBytes = 30 * 32 * 16;
  // (m, l) of each row from every rank, two Q tiles deep
  static constexpr int kStatBytes = 2 * kMaxCluster * 32 * 16;
  // 114,944 B: two CTAs an SM
  static constexpr int kSmem = 1024 + kTileBytes + 2 * kClusterTiles *
                               kTileBytes + kXBytes + kStatBytes +
                               4 * kClusterTiles * 2 + 4 * kMaxCluster * 4 +
                               (kClusterTiles + 6) * 8;
};

// Shared memory of a cluster CTA, at the same offsets in every CTA (a
// multicast Q tile and the peers' stores land at this CTA's offsets): one Q
// tile, this CTA's K and V tiles, the partial outputs it receives, every
// rank's row maxima and sums, its key bits, the Q tile's release words
// (rank 0) and the barriers (one a K tile; V; the Q tile; the Q tile's
// release, on rank 0; the row stats, one a Q-tile parity; the partial
// outputs).
struct CluSmem {
  uint8_t* q;
  uint8_t* k;
  uint8_t* v;
  float4* xo;     // [sender (C - 1)][unit slot ceil(32 / C)][lane]
  float4* stats;  // [parity][rank][warp * 8 + g]: m, l of rows g, g + 8
  uint16_t* okw;  // [t][slot]: bit 2 j + h: key 64 tile + 8 j + 2 t + h
  uint32_t* qrel;  // [rank][warp]
  uint64_t* k_full;  // (kClusterTiles)
  uint64_t* v_full;
  uint64_t* q_full;
  uint64_t* q_empty;
  uint64_t* stat_full;  // (2)
  uint64_t* x_full;

  __device__ explicit CluSmem(uint8_t* raw) {
    constexpr int kTile = Clu::kTileBytes;
    q = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    k = q + kTile;
    v = k + kClusterTiles * kTile;
    xo = reinterpret_cast<float4*>(v + kClusterTiles * kTile);
    stats = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(xo) +
                                      Clu::kXBytes);
    okw = reinterpret_cast<uint16_t*>(reinterpret_cast<uint8_t*>(stats) +
                                      Clu::kStatBytes);
    qrel = reinterpret_cast<uint32_t*>(okw + 4 * kClusterTiles);
    k_full = reinterpret_cast<uint64_t*>(qrel + 4 * kMaxCluster);
    v_full = k_full + kClusterTiles;
    q_full = v_full + 1;
    q_empty = q_full + 1;
    stat_full = q_empty + 1;
    x_full = stat_full + 2;
  }
};

// Rows g and g + 8 of the warp's 16, columns 8 j + 2 t, + 1: one unit of
// the output.
__device__ __forceinline__ void store_unit(const NormParams& p, float4 v,
                                           int b, int hd, const int (&qrow)[2],
                                           int j, int t) {
  const size_t ob = b * p.os.b + hd * p.os.h;
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= p.Sq) continue;
    const size_t i = ob + (size_t)qrow[r] * p.os.s + 8 * j + 2 * t;
    if (p.out_f32)
      *reinterpret_cast<float2*>(static_cast<float*>(p.o) + i) =
          make_float2(e[2 * r], e[2 * r + 1]);
    else
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.o) + i) =
          pack_bf16(e[2 * r], e[2 * r + 1]);
  }
}

// The CTA's walk over the head's Q tiles on its N key-tile slots (kMask: a
// kv_mask, every slot masked by its key bits; else only the last slot,
// when `last_masked`). For a Q tile it runs the split path's warpgroup
// walk: Q K^T of each slot issued before the previous slot's exponentials,
// taken against the running row max (each slot keeps its base). Once the
// products are done each warp hands the Q tile's slot back to rank 0 by a
// 4-byte st.async completing on rank 0's barrier (the products' reads of
// the slot are over; nothing else needs ordering), and rank 0 multicasts
// the next Q tile once every warp of the cluster has. The
// CTA's row max and sum go to every rank by st.async, and each rank forms
// the row's from all C in rank order (the same sum in every CTA). P,
// scaled by 2^(slot base - row base) / sum and rounded to bf16, runs P V
// over the CTA's V tiles; each unit of the float32 partial output goes to
// its owner by st.async, and the owner sums the C units in rank order and
// writes them. A CTA's stores of a Q tile follow its receipt of every
// peer's row stats of that tile, which each peer sends only after it has
// read all it received for the tile before: that ordering alone keeps a
// buffer from being overwritten while it is read (the stats, sent before
// the partial outputs are read, are two Q tiles deep).
template <int N, bool kMask>
__device__ __forceinline__ void cluster_walk(const NormParams& p,
                                             const CluSmem& sm,
                                             const CUtensorMap* tm_q, int b,
                                             int hd, int nq, int rank,
                                             int csize, bool last_masked) {
  constexpr int kBN = 64;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl = p.scale_log2;
  const int row0 = 16 * warp + g;
  // bit 16 c + 2 j + h: the key 64 (c0 + c) + 8 j + 2 t + h attends
  uint32_t ok[(N * 16 + 31) / 32];
#pragma unroll
  for (int w = 0; w < (N * 16 + 31) / 32; ++w) ok[w] = 0;
#pragma unroll
  for (int c = 0; c < N; ++c)
    ok[c / 2] |= uint32_t(sm.okw[t * kClusterTiles + c]) << (16 * (c % 2));
  const uint64_t dq = sm90::desc_sw128(sm.q, 16, 1024);
  const uint64_t dk = sm90::desc_sw128(sm.k, 16, 1024);
  const uint64_t dv = sm90::desc_sw128(sm.v, 64 * 128, 1024);
  // unit j of warp w belongs to rank (j + w) % C, so that every warp owns
  // units of every rank (at most ceil(8 / C) a thread); its slot there
  // counts that rank's units of the warps before and its own before it.
  // The owner and slot of each of this thread's 8 units, 4 bits each; the
  // bytes the peers send this CTA a Q tile
  const auto units = [&](int w, int r) {  // rank r's units in warp w
    return ceil_div(8 - (r - w + csize) % csize, csize);
  };
  uint32_t owner = 0, oslot = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = (j + warp) % csize;
    int before = j / csize;
    for (int w = 0; w < warp; ++w) before += units(w, r);
    owner |= uint32_t(r) << (4 * j);
    oslot |= uint32_t(before) << (4 * j);
  }
  int n_own = 0;
  for (int w = 0; w < 4; ++w) n_own += units(w, rank);
  const int slots = ceil_div(32, csize);
  const uint32_t x_bytes = (csize - 1) * n_own * 512;
  const uint16_t all = (uint16_t)((1u << csize) - 1);

  float sc[N][kBN / 2];
  uint32_t pf[N][kBN / 16][4];
  float acc[32];
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) sc[c][e] = 0.f;
  for (int i = 0; i < nq; ++i) {
    const int par = i & 1;
    if (tid == 0) {  // this tile's row stats, partial outputs and release
      sm90::mbar_arrive_tx(&sm.stat_full[par], csize * 512);
      sm90::mbar_arrive_tx(sm.x_full, x_bytes);
      if (rank == 0 && i + 1 < nq)
        sm90::mbar_arrive_tx(sm.q_empty, csize * 4 * 4);
    }
    sm90::mbar_wait(sm.q_full, i & 1);

    float mr[2] = {kNegInf, kNegInf}, bb[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
    float bt[N][2];
    split_qk<false>(sc[0], dq, dk, 0, sm.k_full);
    auto tile = [&](auto ci) {
      constexpr int c = decltype(ci)::value;
      if constexpr (c + 1 < N) {
        split_qk<false>(sc[c + 1], dq, dk, c + 1, sm.k_full);
        sm90::wgmma_wait<1>();
      } else {
        sm90::wgmma_wait<0>();
        // every product of the Q tile is done: its slot goes back to rank
        // 0, after this CTA announces the next tile's bytes
        if (i + 1 < nq) {
          __syncwarp();
          if (lane == 0) {
            if (warp == 0) sm90::mbar_arrive_tx(sm.q_full, Clu::kTileBytes);
            sm90::st_async_b32(&sm.qrel[rank * 4 + warp], 1u, sm.q_empty, 0);
          }
          __syncwarp();
        }
      }
      sm90::fence_regs(sc[c]);
      const bool need = kMask || (c == N - 1 && last_masked);
      float mx[2] = {mr[0], mr[1]};
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        const int bit = 16 * c + 2 * (e >> 2) + (e & 1);
        if (need && !((ok[bit >> 5] >> (bit & 31)) & 1u)) sc[c][e] = kNegInf;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[c][e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float nb = mx[r] == kNegInf ? 0.f : mx[r] * sl;
        l[r] *= ex2(fminf(bb[r] - nb, 0.f));
        bb[r] = bt[c][r] = nb;
        mr[r] = mx[r];
      }
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
        sc[c][e] = ex2(fmaf(sc[c][e], sl, -bb[(e >> 1) & 1]));
        l[(e >> 1) & 1] += sc[c][e];
      }
    };
    Unrolled<0, N>::run(tile);

    // the CTA's row max and sum, to every rank (lane t to ranks t, t + 4)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = fmaxf(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float bq = m == kNegInf ? 0.f : m * sl;
      l[r] *= ex2(fminf(bb[r] - bq, 0.f));
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      mr[r] = m;
      bb[r] = bq;
    }
    {
      const float4 st = make_float4(mr[0], l[0], mr[1], l[1]);
      float4* dst = sm.stats + (par * kMaxCluster + rank) * 32 + warp * 8 + g;
      for (int to = t; to < csize; to += 4)
        sm90::st_async_v4(dst, *reinterpret_cast<const uint4*>(&st),
                          &sm.stat_full[par], to);
    }
    // rank 0: the next Q tile into every CTA once all have read this one
    if (rank == 0 && tid == 0 && i + 1 < nq) {
      sm90::mbar_wait(sm.q_empty, i & 1);
      sm90::tma_load_4d_multicast(sm.q, tm_q, sm.q_full, all, 0,
                                  (i + 1) * 64, hd, b);
    }
    sm90::mbar_wait(&sm.stat_full[par], (i >> 1) & 1);
    __syncwarp();  // the warp converges before its wgmmas
    float base[2], inv[2];
    {
      const float4* in = sm.stats + par * kMaxCluster * 32 + warp * 8 + g;
      float m[2] = {kNegInf, kNegInf};
      for (int s = 0; s < csize; ++s) {
        const float4 x = in[s * 32];
        m[0] = fmaxf(m[0], x.x);
        m[1] = fmaxf(m[1], x.z);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        // a row with no valid key: its masked scores gave exp 0
        base[r] = m[r] == kNegInf ? 0.f : m[r] * sl;
      float sum[2] = {0.f, 0.f};
      for (int s = 0; s < csize; ++s) {
        const float4 x = in[s * 32];
        const float b0 = x.x == kNegInf ? 0.f : x.x * sl;
        const float b1 = x.z == kNegInf ? 0.f : x.z * sl;
        sum[0] += x.y * ex2(fminf(b0 - base[0], 0.f));
        sum[1] += x.w * ex2(fminf(b1 - base[1], 0.f));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        inv[r] = p.fault ? 1.f : sum[r] > 0.f ? 1.f / sum[r] : 0.f;
    }

    // O = P V over the CTA's V tiles, a tile's as soon as it is packed
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    sm90::mbar_wait(sm.v_full, 0);
#pragma unroll
    for (int c = 0; c < N; ++c) {
      float f[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        f[r] = ex2(fminf(bt[c][r] - base[r], 0.f)) * inv[r];
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) sc[c][e] *= f[(e >> 1) & 1];
      pack_p<kBN / 2>(pf[c], sc[c]);
      sm90::fence_regs(pf[c]);
      if (c == 0) sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
        sm90::wgmma_bf16_rs_m64n64k16(
            acc, pf[c][j2],
            dv + ((c * Clu::kTileBytes + j2 * 16 * 128) >> 4));
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);

    // each unit to its owner; the owner sums the C units in rank order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int to = (owner >> (4 * j)) & 15;
      if (to == rank) continue;
      const int from = rank < to ? rank : rank - 1;
      const float4 x = make_float4(acc[4 * j], acc[4 * j + 1],
                                   acc[4 * j + 2], acc[4 * j + 3]);
      sm90::st_async_v4(
          sm.xo + (from * slots + ((oslot >> (4 * j)) & 15)) * 32 + lane,
          *reinterpret_cast<const uint4*>(&x), sm.x_full, to);
    }
    sm90::mbar_wait(sm.x_full, i & 1);
    const int qrow[2] = {i * 64 + row0, i * 64 + row0 + 8};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (((owner >> (4 * j)) & 15) != (uint32_t)rank) continue;
      const float4* in = sm.xo + ((oslot >> (4 * j)) & 15) * 32 + lane;
      float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < csize; ++s) {
        float4 x;
        if (s == rank)
          x = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                          acc[4 * j + 3]);
        else
          x = in[(s < rank ? s : s - 1) * slots * 32];
        tot.x += x.x;
        tot.y += x.y;
        tot.z += x.z;
        tot.w += x.w;
      }
      store_unit(p, tot, b, hd, qrow, j, t);
    }
  }
}

// One cluster of C CTAs a (batch, head), grid (C, H, B); a CTA of one
// warpgroup and no producer warp, two an SM. Thread 0 loads the CTA's K
// and V slots once by TMA before the cluster's first barrier; rank 0
// multicasts each Q tile to every CTA after it.
template <int N, bool kMask>
__global__ void __launch_bounds__(128, 2)
    flash_norm_cluster_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const NormParams p) {
  constexpr int kBN = 64;
  extern __shared__ uint8_t smem_raw[];
  const CluSmem sm(smem_raw);
  const int rank = (int)sm90::cluster_rank();
  const int csize = (int)sm90::cluster_size();
  const int hd = blockIdx.y, b = blockIdx.z;
  const int nq = ceil_div(p.Sq, 64), nt = ceil_div(p.Skv, kBN);
  int c0, n;
  cluster_slice(nt, csize, rank, c0, n);
  if (threadIdx.x == 0) {  // the loads go out first
    for (int c = 0; c < N; ++c) sm90::mbar_init(&sm.k_full[c], 1);
    sm90::mbar_init(sm.v_full, 1);
    sm90::mbar_init(sm.q_full, 1);
    sm90::mbar_init(sm.q_empty, 1);
    sm90::mbar_init(&sm.stat_full[0], 1);
    sm90::mbar_init(&sm.stat_full[1], 1);
    sm90::mbar_init(sm.x_full, 1);
    sm90::mbar_fence_init();
    // N slots: a short rank's last is the next rank's first tile, masked
    for (int c = 0; c < N; ++c) {
      sm90::mbar_arrive_tx(&sm.k_full[c], Clu::kTileBytes);
      sm90::tma_load_4d(sm.k + c * Clu::kTileBytes, &tm_k, &sm.k_full[c], 0,
                        (c0 + c) * kBN, hd, b);
    }
    sm90::mbar_arrive_tx(sm.v_full, N * Clu::kTileBytes);
    for (int c = 0; c < N; ++c)
      sm90::tma_load_4d(sm.v + c * Clu::kTileBytes, &tm_v, sm.v_full, 0,
                        (c0 + c) * kBN, hd, b);
    sm90::mbar_arrive_tx(sm.q_full, Clu::kTileBytes);  // Q tile 0
  }
  if (threadIdx.x < 4 * N) {  // the key bits (okw)
    const int tt = threadIdx.x / N, cc = threadIdx.x % N;
    uint32_t bits = 0;
    for (int j = 0; j < 8; ++j)
      for (int h = 0; h < 2; ++h) {
        const int key = kBN * (c0 + cc) + 8 * j + 2 * tt + h;
        if (cc < n && key < p.Skv &&
            (!kMask || p.kv_mask[(size_t)b * p.Skv + key]))
          bits |= 1u << (2 * j + h);
      }
    sm.okw[tt * kClusterTiles + cc] = (uint16_t)bits;
  }
  // every CTA's barriers exist before a peer's store or multicast reaches
  // them; the key bits are written
  sm90::cluster_arrive();
  sm90::cluster_wait();
  if (rank == 0 && threadIdx.x == 0)
    sm90::tma_load_4d_multicast(sm.q, &tm_q, sm.q_full,
                                (uint16_t)((1u << csize) - 1), 0, 0, hd, b);
  bool last_masked = false;
  for (int tt = 0; tt < 4; ++tt)
    last_masked |= sm.okw[tt * kClusterTiles + N - 1] != 0xFFFFu;
  cluster_walk<N, kMask>(p, sm, &tm_q, b, hd, nq, rank, csize, last_masked);
  // no CTA leaves while a peer may still reach its shared memory
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

// Launch on clusters of C CTAs. A cluster that cannot be resident (no
// cluster of C fits: cudaOccupancyMaxActiveClusters, asked once a C) is an
// error.
template <int N, bool kMask>
int launch_cluster(const CUtensorMap* maps, const NormParams& p, int B, int C,
                   cudaStream_t stream) {
  auto* kernel = flash_norm_cluster_kernel<N, kMask>;
  static bool sized = false;
  static int fits[kMaxCluster + 1] = {};  // per C; 0: not asked yet
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Clu::kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, p.H, B);
  cfg.blockDim = dim3(Clu::kThreads);
  cfg.dynamicSmemBytes = Clu::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (fits[C] == 0) {
    int fit = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&fit, (const void*)kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    fits[C] = fit > 0 ? fit : -1;
  }
  if (fits[C] < 0) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The kernel of N = ceil(tiles / C) slots.
template <bool kMask>
int dispatch_cluster(const CUtensorMap* maps, const NormParams& p, int B,
                     int C, cudaStream_t stream) {
  switch (ceil_div(ceil_div(p.Skv, 64), C)) {
    case 4: return launch_cluster<4, kMask>(maps, p, B, C, stream);
    case 5: return launch_cluster<5, kMask>(maps, p, B, C, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- two-pass path ------------------------------------------------------------

// A CTA of two consumer warpgroups (threads 0-255) and a producer warp
// (256-287, its first thread issues every load), one CTA an SM.
constexpr int kTwoThreads = 288;
constexpr int kTwoMinStages = 3;  // of the K ring (streamed) and the V ring
constexpr int kTwoMaxV = 8;
constexpr int kTwoHead = 2048;  // the split CTAs' row stats (1 KB), barriers

// A launch's plan: Q tiles taken in pairs, one a consumer warpgroup (a
// head's odd last tile alone: its warpgroups split its keys), Q slots (2,
// or 1 when every head has one Q tile), K slots (each key tile a slot of
// its own, loaded once, when they fit: "resident"; else a ring the K tiles
// pass through twice), V slots and the dynamic shared memory.
// The host chooses the K and V slots (ops/attention.py's
// `norm_two_pass_plan`); the rest follows from the shape.
struct TwoPlan {
  int pairs, qslots, kslots, vslots, smem;
};

// The key bits of tiles 0 .. nt (the last a split CTA's masked dummy).
inline int two_pass_okw_bytes(int nt) { return ((nt + 1) * 8 + 15) & ~15; }

// The plan of Sq query rows over Skv keys at head dim D with the host's K
// and V slots: false where the slots are not ones the walk takes (at least
// three V slots and at most kTwoMaxV; one K slot a key tile, or a ring of
// at least three; where the launch has split CTAs, an odd Q-tile count,
// rings of an even size). A plan past the card's shared memory is refused
// by the launch; the barriers take 16 bytes a slot after the row stats.
bool two_pass_plan(int Sq, int Skv, int D, int kslots, int vslots,
                   TwoPlan& pl) {
  const int tile = 64 * D * 2;
  const int nq = ceil_div(Sq, 64), nt = ceil_div(Skv, 64);
  const bool even = nq % 2;
  if (vslots < kTwoMinStages || vslots > kTwoMaxV || kslots > nt ||
      (kslots < nt && kslots < kTwoMinStages) ||
      (even && (vslots % 2 || (kslots < nt && kslots % 2))) ||
      16 * (kslots + vslots + 1) > kTwoHead - 1024)
    return false;
  pl.pairs = ceil_div(nq, 2);
  pl.qslots = nq > 1 ? 2 : 1;
  pl.kslots = kslots;
  pl.vslots = vslots;
  const long long smem = 1024 + (long long)(pl.qslots + kslots + vslots) *
                                    tile + kTwoHead + two_pass_okw_bytes(nt);
  if (smem > 0x7fffffffLL) return false;
  pl.smem = (int)smem;
  return true;
}

// Shared memory of a two-pass CTA: the Q slots, the V ring, the K slots,
// the row stats, the barriers and the key bits.
struct TwoSmem {
  uint8_t* q;
  uint8_t* v;
  uint8_t* k;
  float* stats;  // (2, 2, 64): [warpgroup][max, sum][row] (split CTAs)
  uint64_t* full_k;  // (kslots)
  uint64_t* empty_k;
  uint64_t* full_v;  // (vslots)
  uint64_t* empty_v;
  uint64_t* q_full;  // (2)
  uint16_t* okw;  // (nt + 1, 4): [tile][t] bit 2 j + h: key 64 tile + 8 j
                  // + 2 t + h attends

  __device__ TwoSmem(uint8_t* raw, int tile, const TwoPlan& pl) {
    q = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    v = q + pl.qslots * tile;
    k = v + pl.vslots * tile;
    stats = reinterpret_cast<float*>(k + pl.kslots * tile);
    full_k = reinterpret_cast<uint64_t*>(stats + 256);
    empty_k = full_k + pl.kslots;
    full_v = empty_k + pl.kslots;
    empty_v = full_v + pl.vslots;
    q_full = empty_v + pl.vslots;
    okw = reinterpret_cast<uint16_t*>(stats) + kTwoHead / 2;
  }
};

// One 64-row tile of a (B, H, S, D) operand into `dst`, completing on `bar`.
template <int D>
__device__ __forceinline__ void two_pass_load(uint8_t* dst,
                                              const CUtensorMap* tm,
                                              uint64_t* bar, int tile, int hd,
                                              int b) {
  sm90::mbar_arrive_tx(bar, 64 * D * 2);
  for (int cb = 0; cb < D / 64; ++cb)
    sm90::tma_load_4d(dst + cb * 64 * 128, tm, bar, cb * 64, tile * 64, hd,
                      b);
}

// The key tile at index j of a CTA's stream of L a pass: j itself where
// both warpgroups read every tile; for a split CTA the tiles alternate
// between its warpgroups (warpgroup 0 the first L / 2, warpgroup 1 the
// rest), and a dummy past the row's last tile (odd nt) loads that tile
// again, masked whole.
__device__ __forceinline__ int two_pass_tile(int j, bool split, int L,
                                             int nt) {
  if (!split) return j;
  const int tile = (j & 1) * (L >> 1) + (j >> 1);
  return tile < nt ? tile : nt - 1;
}

// The producer (one thread): every K tile of the CTA's stream twice
// through the K ring (resident: nothing, the prologue loaded each tile
// once), and each V tile as soon as its slot has been released. Streamed,
// the first V tiles go out beside pass 1's K tiles (V tile j after K tile
// j, while a V slot is free), the others in pass 2 after the K tile of the
// second pass's index j - vslots + 2: a consumer frees V tile j - vslots
// only once it has issued the Q K^T of the tile after it (a step's two
// tiles; in a split CTA the stream's tile two on).
template <int D>
__device__ __forceinline__ void two_pass_produce(const TwoSmem& sm,
                                                 const TwoPlan& pl,
                                                 const CUtensorMap* tm_k,
                                                 const CUtensorMap* tm_v,
                                                 int b, int hd, int nt,
                                                 bool split, int L,
                                                 bool resident) {
  constexpr int kTile = 64 * D * 2;
  int jv = 0;  // the next V tile
  const auto load_v = [&] {
    const int s = jv % pl.vslots;
    sm90::mbar_wait(&sm.empty_v[s], ((jv / pl.vslots) & 1) ^ 1);
    two_pass_load<D>(sm.v + s * kTile, tm_v, &sm.full_v[s],
                     two_pass_tile(jv, split, L, nt), hd, b);
    ++jv;
  };
  if (!resident)
    for (int pos = 0; pos < 2 * L; ++pos) {
      const int s = pos % pl.kslots;
      sm90::mbar_wait(&sm.empty_k[s], ((pos / pl.kslots) & 1) ^ 1);
      two_pass_load<D>(sm.k + s * kTile, tm_k, &sm.full_k[s],
                       two_pass_tile(pos % L, split, L, nt), hd, b);
      const int last = pos < L ? (pos < pl.vslots ? pos : -1)
                               : pos - L + pl.vslots - 2;
      while (jv < L && jv <= last) load_v();
    }
  while (jv < L) load_v();
}

// A position in a ring of `size` slots that a walk steps through `step`
// slots at a time, with the parity of the slot's barrier phase.
struct TwoCursor {
  int slot, size, step;
  uint32_t par;
  __device__ void next() {
    slot += step;
    if (slot >= size) {
      slot -= size;
      par ^= 1u;
    }
  }
};

// Consumer warpgroup w's walk: over every key tile of its own Q tile (a
// pair CTA), or over its half of the key tiles of the CTA's one Q tile (a
// split CTA), twice, two tiles a step. Pass 1 keeps each thread's running
// max and sum; pass 2 computes P = 2^(s scale_log2 - base - log2 l) from
// each row's final max (base) and sum l, rounds it into P V's A fragments
// and accumulates P V. In a step both tiles' Q K^T are issued at once, the
// first tile's exponentials run while the second's product does, and in
// pass 2 the second's while the first's P V does; no product is in flight
// across a branch or the loop's back edge (ptxas then serialises every
// wgmma: C7517 / C7518). The warpgroups of a pair CTA take turns to issue
// (named barriers 1 and 2), so that one's exponentials run under the
// other's products. A split CTA's warpgroups exchange each row's max and
// sum once after pass 1 and sum their float32 partial outputs (through the
// V ring) after pass 2, each writing half of the columns.
template <int D, bool kMask>
__device__ __forceinline__ void two_pass_walk(const NormParams& p,
                                              const TwoSmem& sm,
                                              const TwoPlan& pl, int b,
                                              int hd, int qt, int nt,
                                              bool split, int L,
                                              bool resident, int w) {
  constexpr int kTile = 64 * D * 2;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl = p.scale_log2;
  const int row0 = 16 * warp + g;
  const int n = split ? L / 2 : L;  // tiles a pass
  const int step = split ? 2 : 1, off = split ? w : 0;
  const int tile0 = split ? w * n : 0;
  // the first tile with keys that do not attend: without a kv_mask, the
  // row's last when Skv is not a multiple of 64, and a split CTA's dummy
  const int first_masked = kMask ? 0 : (p.Skv % 64 ? nt - 1 : nt);
  const int R = pl.kslots, VR = pl.vslots;
  const uint8_t* sq = sm.q + (split ? 0 : w) * kTile;
  const bool turns = !split;

  // the slot and parity of the walk's next K tile (resident: the slot is
  // the tile's, the dummy reading the last tile's, and pass 2 reads pass
  // 1's slots again; streamed, the stream runs on through both passes) and
  // of its next V tile
  const TwoCursor k_first = resident ? TwoCursor{tile0, 1 << 30, 1, 0u}
                                     : TwoCursor{off, R, step, 0u};
  TwoCursor kc = k_first;
  TwoCursor vc{off, VR, step, 0u};
  // the wgmma descriptors of the Q tile and of the first K and V slots: a
  // slot is kTile bytes on, a k16 step of Q K^T 32 bytes, a 64-column
  // block 8 KB, a k16 step of P V 2 KB (the address field counts 16 bytes)
  const uint64_t dq = sm90::desc_sw128(sq, 16, 1024);
  const uint64_t dk = sm90::desc_sw128(sm.k, 16, 1024);
  const uint64_t dv = sm90::desc_sw128(sm.v, 64 * 128, 1024);
  const auto qk = [&](float (&sc)[32], const TwoCursor& at) {
    const int slot = resident ? min(at.slot, nt - 1) : at.slot;
    sm90::mbar_wait(&sm.full_k[slot], at.par);
    const uint64_t dks = dk + slot * (kTile >> 4);
    sm90::fence_regs(sc);
    __syncwarp();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int o = (kk / 4) * 512 + (kk % 4) * 2;
      sm90::wgmma_bf16_ss_m64n64k16(sc, dq + o, dks + o, kk > 0);
    }
    sm90::wgmma_commit();
  };
  const auto pv = [&](float (&acc)[D / 2], uint32_t (&pf)[4][4],
                      const TwoCursor& at) {
    sm90::mbar_wait(&sm.full_v[at.slot], at.par);
    const uint64_t dvs = dv + at.slot * (kTile >> 4);
    sm90::fence_regs(pf);
    sm90::fence_regs(acc);
    __syncwarp();
    sm90::wgmma_fence();
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) {
      if constexpr (D == 64)
        sm90::wgmma_bf16_rs_m64n64k16(acc, pf[j2], dvs + j2 * 128);
      else
        sm90::wgmma_bf16_rs_m64n128k16(acc, pf[j2], dvs + j2 * 128);
    }
    sm90::wgmma_commit();
  };
  const auto free_k = [&](const TwoCursor& at) {
    if (!resident) warp_arrive(&sm.empty_k[at.slot], lane);
  };
  const auto free_v = [&](const TwoCursor& at) {
    warp_arrive(&sm.empty_v[at.slot], lane);
  };
  // scores of keys that do not attend to kNegInf, by selects: a branch
  // around code that writes the scores makes ptxas serialise the walk's
  // wgmmas (C7518)
  const auto mask = [&](float (&sc)[32], int k) {
    const int tl = tile0 + k;
    const uint32_t bits =
        kMask || tl >= first_masked ? uint32_t(sm.okw[tl * 4 + t]) : 0xFFFFu;
#pragma unroll
    for (int e = 0; e < 32; ++e)
      sc[e] = (bits >> (2 * (e >> 2) + (e & 1))) & 1u ? sc[e] : kNegInf;
  };
  // The named barriers, like wgmma, are .aligned: a warp's lanes must reach
  // them together, and a lane may leave mbar_wait's spin an iteration after
  // another, so a __syncwarp goes first
  const auto sync_bar = [](int id) {
    __syncwarp();
    sm90::bar_sync(id, 256);
  };
  const auto arrive_bar = [](int id) {
    __syncwarp();
    sm90::bar_arrive(id, 256);
  };
  // a pair CTA's turns: warpgroup w waits on barrier 1 + w, then signals
  // the other's
  const auto take_turn = [&] {
    if (turns) sync_bar(1 + w);
  };
  const auto give_turn = [&] {
    if (turns) arrive_bar(2 - w);
  };

  float sc[2][32];
  uint32_t pf[4][4];
  float acc[D / 2];
  // each thread's running max (raw scores; kNegInf while every key so far
  // is masked), the base of the exponentials (units of log2; 0 while so)
  // and the sum against it
  float mt[2] = {kNegInf, kNegInf}, bb[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
  const auto stats = [&](float (&s)[32], int k) {
    mask(s, k);
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a tree over the row's 16 scores
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]);
#pragma unroll
      for (int h = 4; h > 0; h >>= 1)
#pragma unroll
        for (int i = 0; i < h; ++i) a[i] = fmaxf(a[i], a[i + h]);
      mx[r] = fmaxf(mt[r], a[0]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nb = mx[r] == kNegInf ? 0.f : mx[r] * sl;
      // a base only rises once a key is valid (from 0 it may fall: l is 0
      // then)
      l[r] *= ex2(fminf(bb[r] - nb, 0.f));
      bb[r] = nb;
      mt[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e)
      l[(e >> 1) & 1] += ex2(fmaf(s[e], sl, -bb[(e >> 1) & 1]));
  };
  sm90::mbar_wait(&sm.q_full[split ? 0 : w], 0);
  if (turns && w == 1) arrive_bar(1);  // warpgroup 0 goes first

  // pass 1: two tiles a step
  int k = 0;
  for (; k + 1 < n; k += 2) {
    const TwoCursor k0 = kc;
    kc.next();
    const TwoCursor k1 = kc;
    kc.next();
    take_turn();
    qk(sc[0], k0);
    qk(sc[1], k1);
    give_turn();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc[0]);
    free_k(k0);
    stats(sc[0], k);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc[1]);
    free_k(k1);
    stats(sc[1], k + 1);
  }
  if (k < n) {
    take_turn();
    qk(sc[0], kc);
    give_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc[0]);
    free_k(kc);
    stats(sc[0], k);
    kc.next();
  }

  // each row's max and sum over the warpgroup's keys, then (split) over
  // both warpgroups'; base2 = base + log2 l folds the division into the
  // exponent (a row with no valid key: its masked scores give 0)
  float base2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float bq = m == kNegInf ? 0.f : m * sl;
    l[r] *= ex2(fminf(bb[r] - bq, 0.f));
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    mt[r] = m;
    bb[r] = bq;
  }
  if (split) {
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sm.stats[(2 * w) * 64 + row0 + 8 * r] = mt[r];
        sm.stats[(2 * w + 1) * 64 + row0 + 8 * r] = l[r];
      }
    sync_bar(3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mo = sm.stats[(2 * (1 - w)) * 64 + row0 + 8 * r];
      const float lo = sm.stats[(2 * (1 - w) + 1) * 64 + row0 + 8 * r];
      const float m = fmaxf(mt[r], mo);
      const float base = m == kNegInf ? 0.f : m * sl;
      const float bo = mo == kNegInf ? 0.f : mo * sl;
      // the same sum in both warpgroups (addition commutes)
      l[r] = l[r] * ex2(fminf(bb[r] - base, 0.f)) +
             lo * ex2(fminf(bo - base, 0.f));
      bb[r] = base;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    base2[r] = bb[r] + (p.fault || !(l[r] > 0.f) ? 0.f : __log2f(l[r]));
  // the normalised probabilities of a tile, in place
  const auto probs = [&](float (&s)[32], int k) {
    mask(s, k);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      s[e] = ex2(fmaf(s[e], sl, -base2[(e >> 1) & 1]));
  };

  // pass 2
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  if (resident) kc = k_first;
  for (k = 0; k + 1 < n; k += 2) {
    const TwoCursor k0 = kc;
    kc.next();
    const TwoCursor k1 = kc;
    kc.next();
    const TwoCursor v0 = vc;
    vc.next();
    const TwoCursor v1 = vc;
    vc.next();
    take_turn();
    qk(sc[0], k0);
    qk(sc[1], k1);
    give_turn();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc[0]);
    free_k(k0);
    probs(sc[0], k);
    pack_p<32>(pf, sc[0]);
    take_turn();
    pv(acc, pf, v0);
    give_turn();
    sm90::wgmma_wait<1>();  // the second Q K^T; the first P V runs on
    sm90::fence_regs(sc[1]);
    free_k(k1);
    probs(sc[1], k + 1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    free_v(v0);
    pack_p<32>(pf, sc[1]);
    take_turn();
    pv(acc, pf, v1);
    give_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    free_v(v1);
  }
  if (k < n) {
    take_turn();
    qk(sc[0], kc);
    give_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc[0]);
    free_k(kc);
    probs(sc[0], k);
    pack_p<32>(pf, sc[0]);
    take_turn();
    pv(acc, pf, vc);
    give_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    free_v(vc);
  }
  // warpgroup 0 takes the turn warpgroup 1 gave last (every bar_arrive
  // meets a bar_sync)
  if (turns && w == 0) sync_bar(1);

  const int q0 = qt * 64;
  const int qrow[2] = {q0 + row0, q0 + row0 + 8};
  if (!split) {
    store_rows<D>(p, acc, b, hd, qrow, t);
    return;
  }
  // a split CTA: each warpgroup hands the other the half of its partial
  // output that the other writes (the V ring is free once both are done)
  constexpr int kHalf = D / 4;  // floats a thread hands over
  const auto finish = [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    float* give = reinterpret_cast<float*>(sm.v) + (1 - W) * kHalf * 128;
    const float* take =
        reinterpret_cast<const float*>(sm.v) + W * kHalf * 128;
    sync_bar(3);
#pragma unroll
    for (int e = 0; e < kHalf; ++e)
      give[e * 128 + tid] = acc[kHalf * (1 - W) + e];
    sync_bar(3);
#pragma unroll
    for (int e = 0; e < kHalf; ++e) acc[kHalf * W + e] += take[e * 128 + tid];
    store_rows<D, W * D / 16, D / 16>(p, acc, b, hd, qrow, t);
  };
  if (w == 0)
    finish(std::integral_constant<int, 0>());
  else
    finish(std::integral_constant<int, 1>());
}

// One CTA a pair of a head's Q tiles (grid: B * H * pairs, a head's pairs
// adjacent, so that they find its K and V in L2). The producer warp's first
// thread loads the Q tiles and, when K is resident, every K tile once; the
// key bits of every tile are written meanwhile.
template <int D, bool kMask>
__global__ void __launch_bounds__(kTwoThreads, 1)
    flash_norm_two_pass_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const NormParams p, const TwoPlan pl) {
  constexpr int kTile = 64 * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const TwoSmem sm(smem_raw, kTile, pl);
  const int nq = ceil_div(p.Sq, 64), nt = ceil_div(p.Skv, 64);
  const int bh = blockIdx.x / pl.pairs, pair = blockIdx.x % pl.pairs;
  const int b = bh / p.H, hd = bh % p.H;
  // a head's odd last Q tile: its warpgroups split the keys
  const bool split = 2 * pair + 1 == nq;
  const int L = split ? 2 * ceil_div(nt, 2) : nt;
  const bool resident = nt <= pl.kslots;
  const int producer = 256;  // the producer warp's first thread
  if (threadIdx.x == producer) {
    const int warps = split ? 4 : 8;  // the warps that read each slot
    for (int s = 0; s < (resident ? nt : pl.kslots); ++s) {
      sm90::mbar_init(&sm.full_k[s], 1);
      sm90::mbar_init(&sm.empty_k[s], warps);
    }
    for (int s = 0; s < pl.vslots; ++s) {
      sm90::mbar_init(&sm.full_v[s], 1);
      sm90::mbar_init(&sm.empty_v[s], warps);
    }
    sm90::mbar_init(&sm.q_full[0], 1);
    sm90::mbar_init(&sm.q_full[1], 1);
    sm90::mbar_fence_init();
    for (int w = 0; w < (split ? 1 : 2); ++w)
      two_pass_load<D>(sm.q + w * kTile, &tm_q, &sm.q_full[w], 2 * pair + w,
                       hd, b);
    if (resident)
      for (int j = 0; j < nt; ++j)
        two_pass_load<D>(sm.k + j * kTile, &tm_k, &sm.full_k[j], j, hd, b);
  }
  for (int i = threadIdx.x; i < 4 * (nt + 1); i += kTwoThreads) {
    const int c = i >> 2, tt = i & 3;
    uint32_t bits = 0;
    for (int j = 0; j < 8; ++j)
      for (int h = 0; h < 2; ++h) {
        const int key = 64 * c + 8 * j + 2 * tt + h;
        if (key < p.Skv && (!kMask || p.kv_mask[(size_t)b * p.Skv + key]))
          bits |= 1u << (2 * j + h);
      }
    sm.okw[i] = (uint16_t)bits;
  }
  __syncthreads();  // the barriers' initialisation and the key bits
  if (threadIdx.x >= producer) {
    if (threadIdx.x == producer)
      two_pass_produce<D>(sm, pl, &tm_k, &tm_v, b, hd, nt, split, L,
                          resident);
    return;
  }
  const int w = threadIdx.x >> 7;
  two_pass_walk<D, kMask>(p, sm, pl, b, hd, 2 * pair + (split ? 0 : w), nt,
                          split, L, resident, w);
}

template <int D, bool kMask>
int launch_two_pass(const CUtensorMap* maps, const NormParams& p,
                    const TwoPlan& pl, long long ctas, cudaStream_t stream) {
  auto kernel = flash_norm_two_pass_kernel<D, kMask>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)ctas, kTwoThreads, pl.smem, stream>>>(maps[0], maps[1],
                                                          maps[2], p, pl);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_two_pass(const CUtensorMap* maps, const NormParams& p, int B,
                      int kslots, int vslots, cudaStream_t stream) {
  TwoPlan pl;
  if (!two_pass_plan(p.Sq, p.Skv, D, kslots, vslots, pl))
    return (int)cudaErrorInvalidValue;
  const long long ctas = (long long)B * p.H * pl.pairs;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return p.kv_mask != nullptr
             ? launch_two_pass<D, true>(maps, p, pl, ctas, stream)
             : launch_two_pass<D, false>(maps, p, pl, ctas, stream);
}

// Whether C CTAs take rows of nt key tiles: 4 or 5 slots each.
bool cluster_plan_ok(int nt, int C) {
  return C >= 2 && C <= kMaxCluster && ceil_div(nt, C) >= 4 &&
         ceil_div(nt, C) <= kClusterTiles;
}

}  // namespace

// q (B,H,Sq,D), k/v (B,H,Skv,D), o (B,H,Sq,D): bf16 (o float32 when
// out_f32), D 64 or 128, unit stride along D, the other strides in
// `strides` (12 element strides: batch, head, row of q, k, v, o; multiples
// of 8, 16-byte aligned bases). kv_mask: (B,Skv) bytes (0 = masked) or
// null. path 0 takes the resident path (Skv <= 320 at D64, 256 at D128), 1
// the two-pass path (any Skv), 2 the split path (D64, 320 < Skv <= 640), 3
// the cluster path (D64, 640 < Skv <= 2560) on clusters of `clusters` CTAs
// (each over 4 or 5 key tiles; a cluster that cannot be resident is
// cudaErrorInvalidConfiguration). The two-pass path takes the host's plan
// of `k_slots` K and `v_slots` V slots (`two_pass_plan` says which it
// takes). fault 1 skips the normalisation (a planted fault for checks).
// Returns cudaError_t.
extern "C" int lhrs_flash_fwd_norm(const void* q, const void* k,
                                   const void* v, const void* kv_mask,
                                   void* o, int B, int H, int Sq, int Skv,
                                   int D, float sm_scale, const void* strides,
                                   int out_f32, int path, int fault,
                                   int clusters, int k_slots, int v_slots,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || (D != 64 && D != 128) ||
      path < 0 || path > 3 || (path == 0 && Skv > res_keys(D)) ||
      (path == 2 && (D != 64 || Skv <= res_keys(D) || Skv > split_keys)) ||
      (path == 3 && (D != 64 || Skv <= split_keys || Skv > cluster_keys ||
                     !cluster_plan_ok(ceil_div(Skv, 64), clusters) ||
                     H > 65535 || B > 65535)))
    return (int)cudaErrorInvalidValue;
  const auto* st = static_cast<const long long*>(strides);
  CUtensorMap maps[5];
  // Q, K and V in 64-row boxes; the resident and split paths' last key
  // tile, when it holds at most 8 keys, in boxes of 8 rows (K) and 16 (V)
  if (!operand_map(&maps[0], q, B, H, Sq, D, st, 64) ||
      !operand_map(&maps[1], k, B, H, Skv, D, st + 3, 64) ||
      !operand_map(&maps[2], v, B, H, Skv, D, st + 6, 64) ||
      !operand_map(&maps[3], k, B, H, Skv, D, st + 3, 8) ||
      !operand_map(&maps[4], v, B, H, Skv, D, st + 6, 16))
    return (int)cudaErrorInvalidValue;
  NormParams p;
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.o = o;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.out_f32 = out_f32;
  p.fault = fault;
  p.scale_log2 = sm_scale * kLog2e;
  p.os = Strides{st[9], st[10], st[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (path == 1)
    return D == 128 ? dispatch_two_pass<128>(maps, p, B, k_slots, v_slots, cs)
                    : dispatch_two_pass<64>(maps, p, B, k_slots, v_slots, cs);
  if (path == 2) return dispatch_split(maps, p, B, cs);
  if (path == 3)
    return p.kv_mask != nullptr
               ? dispatch_cluster<true>(maps, p, B, clusters, cs)
               : dispatch_cluster<false>(maps, p, B, clusters, cs);
  return D == 128 ? dispatch_resident<128>(maps, p, B, cs)
                  : dispatch_resident<64>(maps, p, B, cs);
}
