"""Multi-head attention: the plain versions and the CUDA flash kernels,
forward and backward.

Counterpart of `lhrs_bot_tpu/ops/attention.py`. Layout: q (B, H, Sq, D),
k/v (B, H, Skv, D), optional kv_mask (B, Skv) bool (True = attend),
optional segment_ids (B, S) int32 for sequence packing (S = Sq = Skv;
position i attends j iff seg[i] == seg[j] > 0); the causal mask is top-left
aligned (kv_id <= q_id). Returns (B, H, Sq, D) in q.dtype; `mha_reference`
and `flash_attention_fwd` also give it in float32 (`out_dtype`), for the
W8A8 vision blocks, which quantize the attention output before any
rounding. A row with no valid key gives 0 and a log-sum-exp of 1e30, as the
TPU kernels do.

`flash_attention` is the entry point. CPU tensors take the plain versions;
CUDA tensors always take the hand-written kernels (csrc/flash_fwd.cu,
csrc/flash_bwd.cu; the vision blocks' normalize-first forward
csrc/flash_fwd_norm.cu), at every length: the TPU's flash-vs-XLA length
cutoff does not carry over to the port. There is no fallback: what the kernels do
not take raises. When a gradient is wanted, the call goes through
`FlashAttention`, a `torch.autograd.Function` that saves q, k, v, the output
and its log-sum-exp and runs the two-pass backward (the dQ kernel, then the
dK/dV kernel) on CUDA tensors, or `flash_attention_bwd_reference` on CPU
tensors: the same object on both devices, only the launchers differ. The
backward kernels run the (64-row q tile, 64-row kv tile) pairs that
`bwd_tile_table` sets, and skip the rest: the pairs in which no pair can
attend, by `bwd_tile_pairs`'s rule on the per-tile ranges of segment ids
that `bwd_tile_ranges` reduces (plain reductions, as delta is).
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from . import cuda_lib

_NEG_INF = -1e30
_LSE_EMPTY = 1e30  # log-sum-exp of a row with no valid key


def _allowed(sq: int, skv: int, kv_mask, segment_ids, causal: bool,
             device) -> Optional[torch.Tensor]:
    """(B or 1, 1, Sq, Skv) bool of the pairs that attend, or None for
    all."""
    allowed = None
    if kv_mask is not None:
        allowed = kv_mask[:, None, None, :]
    if segment_ids is not None:
        seg = segment_ids
        same = (seg[:, :, None] == seg[:, None, :]) & (seg > 0)[:, :, None]
        same = same[:, None]
        allowed = same if allowed is None else allowed & same
    if causal:
        tri = torch.ones(sq, skv, dtype=torch.bool, device=device).tril()
        allowed = tri if allowed is None else allowed & tri
    return allowed


BWD_TILE = 64  # rows of the backward kernels' q and kv tiles
_INT32_MAX = 2 ** 31 - 1


def tile_key_ranges(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, ceil(S / tile), 2) int32: the least and the greatest key > 0
    among each `tile` rows of `keys` (B, S) (a row's segment id, 1 for a
    row that attends without segments, 0 for a row that attends nothing);
    a tile with no such row gets an empty range (2^31 - 1, 0)."""
    b, s = keys.shape
    n = -(-s // tile)
    k = keys.to(torch.int32)
    if n * tile != s:
        k = torch.nn.functional.pad(k, (0, n * tile - s))
    k = k.view(b, n, tile)
    lo = torch.where(k > 0, k, _INT32_MAX).amin(-1)
    return torch.stack([lo, k.amax(-1)], -1)


def bwd_tile_ranges(kv_mask, segment_ids, tile: int = BWD_TILE):
    """The per-tile key ranges of the backward's skip rule: (q ranges, kv
    ranges), each a `tile_key_ranges` table or None for "any key". The q
    rows' keys are their segment ids (None without segments); the kv rows'
    the segment ids, or 1, times kv_mask (None with neither)."""
    q_ranges = (None if segment_ids is None
                else tile_key_ranges(segment_ids, tile))
    if kv_mask is None:
        return q_ranges, q_ranges
    kv_keys = (kv_mask.to(torch.int32) if segment_ids is None
               else segment_ids * kv_mask)
    return q_ranges, tile_key_ranges(kv_keys, tile)


def bwd_tile_pairs(q_ranges, kv_ranges, nq: int, nk: int, causal: bool,
                   tile_q: int = BWD_TILE, tile_kv: int = BWD_TILE,
                   device=None) -> torch.Tensor:
    """(B or 1, nq, nk) bool: the (q tile, kv tile) pairs the backward runs.
    A pair is skipped when no (i, j) in it can attend: it lies above the
    causal diagonal (its first kv row past its last q row), or its tiles'
    key ranges are disjoint, which also skips a kv tile of masked keys and
    a q tile of segment 0 (an empty range). A skipped pair would add exactly
    0 to every gradient. The tensor lies on the ranges' device, else on
    `device` (default the CPU)."""
    sides = [r for r in ((None if q_ranges is None else q_ranges[:, :, None]),
                         (None if kv_ranges is None
                          else kv_ranges[:, None, :])) if r is not None]
    dev = sides[0].device if sides else device
    run = torch.ones(1, nq, nk, dtype=torch.bool, device=dev)
    if sides:
        lo, hi = sides[0][..., 0], sides[0][..., 1]
        for r in sides[1:]:
            lo, hi = torch.maximum(lo, r[..., 0]), torch.minimum(hi, r[..., 1])
        run = run & (lo <= hi)
    if causal:
        iq = torch.arange(nq, device=dev)[:, None]
        ik = torch.arange(nk, device=dev)[None, :]
        run = run & (ik * tile_kv <= iq * tile_q + tile_q - 1)
    return run


def bwd_tile_table(kv_mask, segment_ids, b: int, sq: int, skv: int,
                   causal: bool, device) -> torch.Tensor:
    """(B, ceil(Sq / 64), ceil(Skv / 64)) contiguous bool on `device`: the
    64 x 64 tile pairs that both backward kernels run, and the only ones,
    by `bwd_tile_pairs`'s rule."""
    run = bwd_tile_pairs(*bwd_tile_ranges(kv_mask, segment_ids),
                         -(-sq // BWD_TILE), -(-skv // BWD_TILE), causal,
                         device=device)
    return run.expand(b, *run.shape[1:]).contiguous()


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor] = None, *,
                  causal: bool = False,
                  sm_scale: Optional[float] = None,
                  out_dtype: Optional[torch.dtype] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  return_lse: bool = False):
    """Plain attention: float32 scores and softmax, probabilities rounded to
    v.dtype before the PV product (float32 accumulation). A row with no
    valid key gives 0, as the kernels do. With `return_lse`, also the float32
    log-sum-exp of the scaled scores (B, H, Sq) with the kernels'
    conventions: 1e30 for a row with no valid key."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    allowed = _allowed(q.shape[2], k.shape[2], kv_mask, segment_ids, causal,
                       q.device)
    if allowed is not None:
        scores = scores.masked_fill(~allowed, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if allowed is not None:
        # masked entries are 0 already, except in a row with no valid key
        probs = probs.masked_fill(~allowed, 0.0)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    out = out.to(out_dtype or q.dtype)
    if not return_lse:
        return out
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    if allowed is not None:
        e = e.masked_fill(~allowed, 0.0)
    total = e.sum(dim=-1)
    lse = torch.where(total > 0, m[..., 0] + torch.log(total),
                      torch.full_like(total, _LSE_EMPTY))
    return out, lse


def flash_attention_bwd_reference(q, k, v, kv_mask, segment_ids, out, lse,
                                  d_out, causal: bool, sm_scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain backward with the TPU kernels' rounding points
    (`_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel`): delta = rowsum(dO O)
    and P = exp(s * scale - lse) in float32; dP = dO V^T and dV = P^T dO
    with P and dO in float32; dS = P (dP - delta) scale in float32, rounded
    to the input dtype only as the operand of dQ = dS K and dK = dS^T Q
    (float32 accumulation). Returns (dq, dk, dv) in q/k/v's dtypes."""
    delta = (d_out.float() * out.float()).sum(dim=-1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    allowed = _allowed(q.shape[2], k.shape[2], kv_mask, segment_ids, causal,
                       q.device)
    if allowed is not None:
        s = s.masked_fill(~allowed, _NEG_INF)
    p = torch.exp(s - lse[..., None])
    do = d_out.float()
    dp = torch.matmul(do, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dv = torch.matmul(p.transpose(-1, -2), do)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = torch.matmul(ds.to(q.dtype).transpose(-1, -2).float(), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_masks(kv_mask, segment_ids, b, sq, skv, device, name):
    if kv_mask is not None:
        if (kv_mask.dtype != torch.bool or kv_mask.shape != (b, skv)
                or kv_mask.device != device or not kv_mask.is_contiguous()):
            raise ValueError(f"{name}: kv_mask must be a contiguous (B, Skv) "
                             "bool tensor on q's device")
    if segment_ids is not None:
        if (segment_ids.dtype != torch.int32 or sq != skv
                or segment_ids.shape != (b, sq)
                or segment_ids.device != device
                or not segment_ids.is_contiguous()):
            raise ValueError(f"{name}: segment_ids must be a contiguous "
                             "(B, S) int32 tensor on q's device, with S = "
                             "Sq = Skv")


def _check_qkv(q, k, v, name):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{name} takes bf16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or d not in (64, 128):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}; "
                         "D must be 64 or 128")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor], causal: bool,
                        sm_scale: float, out_dtype=torch.bfloat16,
                        out: Optional[torch.Tensor] = None, *,
                        segment_ids: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA flash-attention forward. Takes bf16 CUDA tensors
    with D of 64 or 128, unit stride along D, the other strides multiples of
    8 and 16-byte aligned bases (so Q, K and V can be strided views of one
    projection), any Sq/Skv; writes a bf16 or float32 (B, H, Sq, D) result,
    into `out` when given (any such strides, e.g. the (B, H, Sq, D) view of
    a token-major (B, Sq, H, D) buffer). `segment_ids`: (B, S) int32 packing
    ids. `lse`: a contiguous float32 (B, H, Sq) tensor that receives the
    log-sum-exp of each row. Segments and the LSE take a bf16 output only.
    Raises on anything else. Counts its launches in
    `flash_attention_fwd.launches`."""
    out = _flash_fwd(q, k, v, kv_mask, causal, sm_scale, out_dtype, out,
                     segment_ids, lse)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


# Rows of at most this many keys (by head dim) take the normalize-first
# kernel's resident path (csrc/flash_fwd_norm.cu: a head's K and V in shared
# memory, a Q tile's scores in registers); longer rows of at most
# NORM_SPLIT_KEYS[D] keys its split path (the same, a Q tile's keys split
# between two warpgroups); longer rows of at most NORM_CLUSTER_KEYS[D] keys
# its cluster path (a head's key tiles split over a thread-block cluster,
# at most NORM_CLUSTER_TILES tiles of 64 keys a CTA and NORM_MAX_CLUSTER
# CTAs) where a head has more than one Q tile of 64 rows, but the rows of
# NORM_TWO_PASS_TILES[D] tiles of 64 keys; every other row (longer rows,
# D128 past 256 keys, those rows, the cluster's rows of one Q tile: the
# 504-px perceiver's 64 queries) its two-pass path. The readings on an
# H100 (`benchmarks/wgmma_ab.py --part norm`, PERF.md §6), over B64
# H16: the two-pass path is the faster at 1,088 keys (17 tiles), 1,297 and
# 1,312 (21: ViT-L/14 at 504 px and its block) and 1,664 (26), where the
# cluster's CTAs of four slots leave two or three slots empty; the cluster
# path at 704, 832, 960, 1,216, 1,408 (a tie), 1,536, 1,792, 2,048 and
# 2,560 keys, and at the tile counts not measured; at 64 x 1,360 the
# two-pass path.
NORM_RESIDENT_KEYS = {64: 320, 128: 256}
NORM_SPLIT_KEYS = {64: 640}
NORM_CLUSTER_TILES = 5
NORM_MAX_CLUSTER = 8
NORM_CLUSTER_KEYS = {64: NORM_MAX_CLUSTER * NORM_CLUSTER_TILES * 64}
NORM_TWO_PASS_TILES = {64: (17, 21, 26)}
# the C entry's path argument
_NORM_PATHS = {"resident": 0, "two_pass": 1, "split": 2, "cluster": 3}


def norm_keys_path(skv: int, d: int) -> str:
    """The normalize-first kernel that takes rows of `skv` keys at head dim
    `d`: "resident", "split", "cluster" or "two_pass" (which takes any)."""
    if skv <= NORM_RESIDENT_KEYS.get(d, 0):
        return "resident"
    if skv <= NORM_SPLIT_KEYS.get(d, 0):
        return "split"
    if skv <= NORM_CLUSTER_KEYS.get(d, 0):
        return "cluster"
    return "two_pass"


def norm_path(skv: int, d: int, sq: int) -> str:
    """The normalize-first forward's path for `sq` query rows over rows of
    `skv` keys at head dim `d`: `norm_keys_path`, but the cluster's rows
    with one Q tile (sq <= 64) and its rows of NORM_TWO_PASS_TILES[d] tiles
    of 64 keys take the two-pass path."""
    path = norm_keys_path(skv, d)
    if path == "cluster" and (sq <= 64 or -(-skv // 64)
                              in NORM_TWO_PASS_TILES.get(d, ())):
        return "two_pass"
    return path


def norm_cluster_plan(skv: int) -> Tuple[int, List[Tuple[int, int]]]:
    """The cluster path's split of rows of `skv` keys: (C, [(first tile,
    tiles) of each rank]). C is the fewest CTAs of at most 4 tiles of 64
    keys each (two CTAs an SM), or of NORM_CLUSTER_TILES past 4
    NORM_MAX_CLUSTER tiles; every CTA runs N = ceil(tiles / C) slots (4 or
    5), the first C N - tiles ranks one tile fewer (their last slot a
    masked dummy), as csrc/flash_fwd_norm.cu's `cluster_slice`. Raises for
    rows the cluster path does not take."""
    if norm_keys_path(skv, 64) != "cluster":
        raise ValueError(f"the cluster path takes rows of "
                         f"{NORM_SPLIT_KEYS[64] + 1} to "
                         f"{NORM_CLUSTER_KEYS[64]} keys, not {skv}")
    nt = -(-skv // 64)
    c = -(-nt // (4 if nt <= 4 * NORM_MAX_CLUSTER else NORM_CLUSTER_TILES))
    n = -(-nt // c)
    short = c * n - nt
    return c, [(r * (n - 1), n - 1) if r < short else
               (short * (n - 1) + (r - short) * n, n) for r in range(c)]


# the two-pass kernel's CTA (csrc/flash_fwd_norm.cu's `two_pass_plan`, which
# checks the slots it is given): K and V slots in the H100's 232,448 bytes
# of shared memory a block, beside 2,048 bytes of row stats and barriers,
# at least 3 slots in a ring and at most 8 V slots
_TWO_PASS_SMEM = 232448
_TWO_PASS_HEAD = 2048
_TWO_PASS_MIN_STAGES = 3
_TWO_PASS_MAX_V = 8


def norm_two_pass_plan(sq: int, skv: int, d: int) -> dict:
    """The two-pass kernel's plan for `sq` query rows over rows of `skv`
    keys at head dim `d`, whose K and V slots the launch passes to the
    kernel: a CTA takes a pair of a head's 64-row Q tiles, one for each
    consumer warpgroup (`pairs` a head); a head's odd last Q tile takes a
    CTA alone, whose warpgroups split its key tiles (ceil(tiles / 2) each,
    the second's last a masked dummy when the count is odd). K stays in
    shared memory between the passes ("resident": each key tile loaded
    once, the dummy reading the last) where the row's key tiles fit beside
    the V ring; else K passes through a ring twice. A launch with split
    CTAs (an odd Q-tile count) takes rings of an even size, at least four:
    its warpgroups take alternate positions of a ring, and an odd ring
    would hand a slot from one to the other at every phase, which a
    barrier's parity cannot tell apart. Keys: pairs, q_slots, k_slots,
    v_slots, smem (bytes), resident (the pair CTAs', the split CTAs' or
    None where the launch has none). Raises where no plan fits."""
    tile = 64 * d * 2
    nq, nt = -(-sq // 64), -(-skv // 64)
    q_slots = 2 if nq > 1 else 1
    even = nq % 2 == 1
    least = _TWO_PASS_MIN_STAGES + even  # the fewest slots of a ring
    okw = ((nt + 1) * 8 + 15) & ~15
    fixed = 1024 + q_slots * tile + _TWO_PASS_HEAD + okw
    avail = (_TWO_PASS_SMEM - fixed) // tile
    if avail < 2 * least:
        raise ValueError(f"the two-pass kernel has no plan for rows of {skv} "
                         f"keys at D {d}")
    if nt + least <= avail:
        k_slots, v_slots = nt, min(avail - nt, _TWO_PASS_MAX_V)
    else:
        k_slots, v_slots = avail - least, least
    if even:
        v_slots -= v_slots % 2
        if k_slots < nt:
            k_slots -= k_slots % 2
    pairs = -(-nq // 2)
    return {"pairs": pairs, "q_slots": q_slots, "k_slots": k_slots,
            "v_slots": v_slots, "smem": fixed + (k_slots + v_slots) * tile,
            "resident": (nt <= k_slots if nq > 1 else None,
                         nt <= k_slots if even else None)}


def flash_attention_fwd_normalized(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   kv_mask: Optional[torch.Tensor],
                                   sm_scale: float, out_dtype=torch.float32,
                                   out: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """The normalize-first attention forward (csrc/flash_fwd_norm.cu),
    non-causal: P = exp(s - m) / l over each row's final max m and sum l is
    rounded to bf16 before the P V product, with no division at the end.
    That is where the TPU vision kernels round (`jax.nn.softmax(...).astype(
    bf16)`, their default softmax mode, and `exp2_pre`), where K1 rounds the
    unnormalised probabilities (their `exp2_post` mode). Takes what
    `flash_attention_fwd` takes but segments and the LSE. Rows of at most
    `NORM_RESIDENT_KEYS[D]` keys launch the resident kernel, counted in
    `flash_attention_fwd_normalized.launches`; longer rows go to
    `flash_attention_fwd_normalized_split` (to `NORM_SPLIT_KEYS[D]` keys),
    `flash_attention_fwd_normalized_cluster` (to `NORM_CLUSTER_KEYS[D]`,
    more than 64 query rows, but rows of `NORM_TWO_PASS_TILES[D]` key
    tiles) or `flash_attention_fwd_normalized_two_pass` (`norm_path`),
    which count their own.
    Its plain version is `mha_reference`."""
    path = norm_path(k.shape[2], q.shape[3], q.shape[2])
    if path == "split":
        return flash_attention_fwd_normalized_split(q, k, v, kv_mask,
                                                    sm_scale, out_dtype, out)
    if path == "cluster":
        return flash_attention_fwd_normalized_cluster(q, k, v, kv_mask,
                                                      sm_scale, out_dtype,
                                                      out)
    if path == "two_pass":
        return flash_attention_fwd_normalized_two_pass(q, k, v, kv_mask,
                                                       sm_scale, out_dtype,
                                                       out)
    out = _flash_fwd_norm(q, k, v, kv_mask, sm_scale, out_dtype, out)
    flash_attention_fwd_normalized.launches += 1
    return out


flash_attention_fwd_normalized.launches = 0


def flash_attention_fwd_normalized_split(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kv_mask: Optional[torch.Tensor], sm_scale: float,
        out_dtype=torch.float32, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The normalize-first forward's split kernel, for rows past
    `NORM_RESIDENT_KEYS[64]` keys up to `NORM_SPLIT_KEYS[64]` at D64 (ViT-L/14
    at 336 px: 577 tokens, its perceiver's 640 keys): a CTA a head holds its
    K and V, and two warpgroups split each Q tile's keys, their scores in
    registers. `flash_attention_fwd_normalized` takes it for such rows.
    Counts its launches in `flash_attention_fwd_normalized_split.launches`."""
    out = _flash_fwd_norm(q, k, v, kv_mask, sm_scale, out_dtype, out,
                          path="split")
    flash_attention_fwd_normalized_split.launches += 1
    return out


flash_attention_fwd_normalized_split.launches = 0


def flash_attention_fwd_normalized_cluster(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kv_mask: Optional[torch.Tensor], sm_scale: float,
        out_dtype=torch.float32, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The normalize-first forward's cluster kernel, for rows past
    `NORM_SPLIT_KEYS[64]` keys up to `NORM_CLUSTER_KEYS[64]` at D64: a
    thread-block cluster a head, each CTA holding its slice of the head's
    K and V (`norm_cluster_plan`), the row stats and partial outputs
    exchanged through distributed shared memory. A cluster that does not
    fit on the card raises. `flash_attention_fwd_normalized` takes it for
    such rows where the queries fill more than one tile of 64, but those
    of `NORM_TWO_PASS_TILES[64]` tiles of 64 keys (ViT-L/14 at 504 px:
    1,297 tokens, the block's 1,312), which the two-pass kernel runs
    faster. Counts its launches in
    `flash_attention_fwd_normalized_cluster.launches`."""
    out = _flash_fwd_norm(q, k, v, kv_mask, sm_scale, out_dtype, out,
                          path="cluster")
    flash_attention_fwd_normalized_cluster.launches += 1
    return out


flash_attention_fwd_normalized_cluster.launches = 0


def flash_attention_fwd_normalized_two_pass(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        kv_mask: Optional[torch.Tensor], sm_scale: float,
        out_dtype=torch.float32, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The normalize-first forward's two-pass kernel at any row length (a
    first pass of Q K^T for each row's max and sum, then Q K^T again and
    P V; two consumer warpgroups a CTA over two Q tiles of a head, or over
    the halves of a lone Q tile's keys, with K kept in shared memory
    between the passes where `norm_two_pass_plan` fits it), which
    `flash_attention_fwd_normalized` takes for rows past
    `NORM_CLUSTER_KEYS[D]` keys (past `NORM_RESIDENT_KEYS[D]` where D has no
    split or cluster path), for the rows of `NORM_TWO_PASS_TILES[D]` key
    tiles (ViT-L/14 at 504 px) and for the cluster's rows with one Q tile (the
    504-px perceiver's 64 x 1,360). Counts its launches in
    `flash_attention_fwd_normalized_two_pass.launches`."""
    out = _flash_fwd_norm(q, k, v, kv_mask, sm_scale, out_dtype, out,
                          path="two_pass")
    flash_attention_fwd_normalized_two_pass.launches += 1
    return out


flash_attention_fwd_normalized_two_pass.launches = 0


def _fwd_out_and_strides(q, k, v, out, out_dtype):
    """The forward's output (allocated when not given) and the 12 element
    strides (batch, head, row of q, k, v, out) its kernels take; raises on
    what they do not take."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    if out is None:
        out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    elif (out.shape != q.shape or out.dtype != out_dtype
          or out.device != q.device):
        raise ValueError(f"out must be a {out_dtype} {tuple(q.shape)} tensor "
                         "on q's device")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if (t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must have unit stride along D, strides "
                             "that are multiples of 8 and a 16-byte aligned "
                             "base")
        strides += t.stride()[:3]
    return out, (ctypes.c_longlong * 12)(*strides)


def _flash_fwd_norm(q, k, v, kv_mask, sm_scale, out_dtype, out, *,
                    path="resident", fault=0):
    """The checks and the launch of the normalize-first kernel on `path`
    ("resident", "split", "cluster" or "two_pass"), counted by the public
    wrappers above. `fault=1` skips the normalisation: a planted fault, for
    the card's checks."""
    _check_qkv(q, k, v, "flash_attention_fwd_normalized")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if path != "two_pass" and norm_keys_path(skv, d) != path:
        raise ValueError(f"rows of {skv} keys at D {d} take the "
                         f"{norm_keys_path(skv, d)} path, not the {path} "
                         "path")
    c = norm_cluster_plan(skv)[0] if path == "cluster" else 0
    plan = (norm_two_pass_plan(sq, skv, d) if path == "two_pass"
            else {"k_slots": 0, "v_slots": 0})
    out, strides = _fwd_out_and_strides(q, k, v, out, out_dtype)
    _check_masks(kv_mask, None, b, sq, skv, q.device,
                 "flash_attention_fwd_normalized")
    lib = cuda_lib.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_flash_fwd_norm(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            out.data_ptr(), b, h, sq, skv, d, float(sm_scale), strides,
            int(out_dtype == torch.float32), _NORM_PATHS[path], int(fault),
            c, plan["k_slots"], plan["v_slots"], stream)
    cuda_lib.check(err, "flash_attention_fwd_normalized")
    return out


def _flash_fwd(q, k, v, kv_mask, causal, sm_scale, out_dtype, out,
               segment_ids=None, lse=None):
    """The checks and the launch of K1, counted by `flash_attention_fwd`."""
    _check_qkv(q, k, v, "flash_attention_fwd")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if out_dtype == torch.float32 and (segment_ids is not None
                                       or lse is not None):
        raise ValueError("segment_ids and lse take a bf16 output")
    out, strides = _fwd_out_and_strides(q, k, v, out, out_dtype)
    _check_masks(kv_mask, segment_ids, b, sq, skv, q.device,
                 "flash_attention_fwd")
    if lse is not None and (lse.dtype != torch.float32
                            or lse.shape != (b, h, sq)
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError("lse must be a contiguous float32 (B, H, Sq) tensor "
                         "on q's device")
    lib = cuda_lib.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            _ptr(segment_ids), out.data_ptr(), _ptr(lse),
            b, h, sq, skv, d, int(causal), float(sm_scale), strides,
            int(out_dtype == torch.float32), stream)
    cuda_lib.check(err, "flash_attention_fwd")
    return out


def _bwd_args(q, k, v, kv_mask, segment_ids, lse, delta, d_out, causal,
              runs, name):
    """Checks shared by the two backward kernels; returns contiguous q, k,
    v, dO and the tile pairs to run (`bwd_tile_table`, built here when
    `runs` is None)."""
    _check_qkv(q, k, v, name)
    b, h, sq, _ = q.shape
    skv = k.shape[2]
    _check_masks(kv_mask, segment_ids, b, sq, skv, q.device, name)
    if (d_out.shape != q.shape or d_out.device != q.device
            or d_out.dtype != torch.bfloat16):
        raise ValueError(f"{name}: d_out must be a bf16 tensor of q's shape")
    for t_name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b, h, sq)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {t_name} must be a contiguous float32 "
                             "(B, H, Sq) tensor on q's device")
    if runs is None:
        runs = bwd_tile_table(kv_mask, segment_ids, b, sq, skv, causal,
                              q.device)
    if (runs.dtype != torch.bool or runs.device != q.device
            or runs.shape != (b, -(-sq // BWD_TILE), -(-skv // BWD_TILE))
            or not runs.is_contiguous()):
        raise ValueError(f"{name}: runs must be a contiguous bool (B, "
                         "ceil(Sq / 64), ceil(Skv / 64)) tensor on q's "
                         "device")
    out = [t.contiguous() for t in (q, k, v, d_out)]
    if (any(t.data_ptr() % 16 for t in out)
            or (kv_mask is not None and kv_mask.data_ptr() % 4)):
        raise ValueError(f"{name}: q, k, v and d_out need 16-byte aligned "
                         "bases, kv_mask a 4-byte aligned one")
    return (*out, runs)


def flash_attention_bwd_dq(q, k, v, kv_mask, segment_ids, lse, delta, d_out,
                           causal: bool, sm_scale: float, runs=None
                           ) -> torch.Tensor:
    """Launch the dQ kernel (csrc/flash_bwd.cu): bf16 CUDA q (B, H, Sq, D),
    k/v (B, H, Skv, D) and d_out, float32 lse and delta = rowsum(dO O)
    (B, H, Sq), the forward's masks, and `runs`, the tile pairs to run
    (`bwd_tile_table` of the masks, built here when None); returns dq
    (B, H, Sq, D) bf16. Counts its launches in
    `flash_attention_bwd_dq.launches`."""
    q, k, v, d_out, runs = _bwd_args(
        q, k, v, kv_mask, segment_ids, lse, delta, d_out, causal, runs,
        "flash_attention_bwd_dq")
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    lib = cuda_lib.load_library()
    with torch.cuda.device(q.device):
        err = lib.lhrs_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(kv_mask),
            _ptr(segment_ids), runs.data_ptr(), dq.data_ptr(), b, h, sq,
            k.shape[2], d, int(causal), float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, kv_mask, segment_ids, lse, delta, d_out,
                            causal: bool, sm_scale: float, runs=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel (csrc/flash_bwd.cu) on the inputs of
    `flash_attention_bwd_dq`; returns (dk, dv) (B, H, Skv, D) bf16. Counts
    its launches in `flash_attention_bwd_dkv.launches`."""
    q, k, v, d_out, runs = _bwd_args(
        q, k, v, kv_mask, segment_ids, lse, delta, d_out, causal, runs,
        "flash_attention_bwd_dkv")
    b, h, sq, d = q.shape
    runs_t = runs.transpose(1, 2).contiguous()  # a row a kv tile
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = cuda_lib.load_library()
    with torch.cuda.device(q.device):
        err = lib.lhrs_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(kv_mask),
            _ptr(segment_ids), runs_t.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, k.shape[2], d, int(causal),
            float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, kv_mask, segment_ids, out, lse, d_out,
                        causal: bool, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA backward: delta = rowsum(dO O) in float32 (a plain
    reduction, as XLA computes it beside the TPU kernels) and the tile
    pairs to run (`bwd_tile_table`, plain reductions too), then the dQ
    kernel and the dK/dV kernel. Returns (dq, dk, dv) bf16; each kernel
    counts its own launches."""
    if not d_out.is_cuda:
        raise ValueError("flash_attention_bwd takes CUDA tensors")
    delta = (d_out.float() * out.float()).sum(dim=-1)
    runs = bwd_tile_table(kv_mask, segment_ids, q.shape[0], q.shape[2],
                          k.shape[2], causal, q.device)
    dq = flash_attention_bwd_dq(q, k, v, kv_mask, segment_ids, lse, delta,
                                d_out, causal, sm_scale, runs)
    dk, dv = flash_attention_bwd_dkv(q, k, v, kv_mask, segment_ids, lse,
                                     delta, d_out, causal, sm_scale, runs)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward. Forward: the CUDA kernel with its
    log-sum-exp on CUDA tensors, `mha_reference(return_lse=True)` on CPU
    tensors. Backward: `flash_attention_bwd` on CUDA tensors,
    `flash_attention_bwd_reference` on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, segment_ids, causal, sm_scale):
        if q.is_cuda:
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
            out = flash_attention_fwd(q, k, v, kv_mask, causal, sm_scale,
                                      segment_ids=segment_ids, lse=lse)
        else:
            out, lse = mha_reference(q, k, v, kv_mask, causal=causal,
                                     sm_scale=sm_scale,
                                     segment_ids=segment_ids,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, segment_ids, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        q, k, v, kv_mask, segment_ids, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd if q.is_cuda
               else flash_attention_bwd_reference)
        dq, dk, dv = bwd(q, k, v, kv_mask, segment_ids, out, lse, d_out,
                         ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim `d` below 128 at: 64 or
    128."""
    return 64 if d <= 64 else 128


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """`t` (..., D) with zero columns up to `width` (differentiable)."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False,
                    sm_scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Multi-head attention. CUDA tensors launch the flash kernels, CPU
    tensors run the plain versions. A call that needs no gradient (grad
    mode off, as for the frozen vision tower, or no input that requires
    one) runs the forward alone, without the log-sum-exp; otherwise it goes
    through `FlashAttention`. On CUDA tensors a head dim below 128 that the
    kernels do not take is zero-padded to 64 or 128 (the scale stays the
    true head dim's) and the output cut back."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no attention path for device {q.device}")
    d = q.shape[-1]
    if q.is_cuda and d < 128 and d not in (64, 128):
        # the kernels take D 64 or 128: zero columns change no score and
        # give output columns that are dropped (ViT-B's perceiver, D 48)
        width = padded_head_dim(d)
        out = flash_attention(*(pad_head_dim(t, width) for t in (q, k, v)),
                              kv_mask, causal=causal, sm_scale=sm_scale,
                              segment_ids=segment_ids)
        return out[..., :d]
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, kv_mask, segment_ids, causal,
                                    sm_scale)
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, kv_mask, causal, sm_scale,
                                   segment_ids=segment_ids)
    return mha_reference(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale,
                         segment_ids=segment_ids)
