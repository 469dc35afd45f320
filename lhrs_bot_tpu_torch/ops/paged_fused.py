"""Paged decode step: page append + single-query attention over a page pool.

Counterpart of `lhrs_bot_tpu/ops/paged_fused.py` `paged_fused_decode`
(bf16/f32 pools) and `paged_fused_decode_q` (int8 pools with float32 scale
pages (L, N, H, page)). Pools are (L, N_pages, H, page, D), page 0 the null
page; `page_table` (B, P) int32 names each row's pages. One call writes the
new token's K/V row of `layer` (and, int8, its two scales) at position
lengths[b] of row b, IN PLACE, then attends the query over the row's
lengths[b] + 1 positions through the table.

`paged_fused_decode` and `paged_fused_decode_q` are the entry points. CPU
tensors take the plain versions, which are the JAX package's reference path
(`llama_paged.py` `_append_rows` + `paged_attention_reference`, kept here so
that models/llama_paged.py can import them); CUDA tensors always take the
hand-written kernels (csrc/paged_decode.cu for a bf16 pool,
csrc/paged_decode_q.cu for an int8 pool), which read the lengths and the
table on the device. There is no fallback: what a kernel does not take
raises. The TPU wrappers' `interpret` and `vmem_limit` are TPU settings and
are not taken.

The int8 pool's kernel is K4's design (csrc/decode_split.cuh) over pages:
a head's rows split across a cluster of C CTAs (`decode_split_plan` at S
= P * page), a ring of bulk copies, one a page piece. Its plain picture:
`paged_fused_decode_q_split_plain` (the split and merge) and
`stage_page_pieces` (the copies of each stage).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from . import cuda_lib
from .decode_attention import decode_attention
from .fused_decode import (MAX_PAGES, _check_splits,
                           decode_launch_splits, decode_shares,
                           split_decode_attention_plain)


def _append_target(page_table: torch.Tensor, lengths: torch.Tensor,
                   page: int):
    """(page ids (B,), offsets (B,)) of the append at position lengths[b]:
    the page index clamps to the table's last entry, as JAX's
    `take_along_axis` does."""
    idx = (lengths.long() // page).clamp(max=page_table.shape[1] - 1)
    page_ids = page_table.gather(1, idx[:, None])[:, 0].long()
    return page_ids, lengths.long() % page


def _append_rows(pool: torch.Tensor, li: int, page_ids: torch.Tensor,
                 offs: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Scatter one new token's (B, H, d) rows (or (B, H) scales) into layer
    li of the pool, in place; returns the pool."""
    pool[li, page_ids, :, offs] = rows.to(pool.dtype)
    return pool


def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor):
    """One layer's (N, H, p[, d]) pool gathered through the (B, P) table
    into contiguous (B, H, P * p[, d]) views."""
    g = pages[page_table.long()]  # (B, P, H, p[, d])
    b, n_p, h, p = g.shape[:4]
    g = g.transpose(1, 2)
    return g.reshape((b, h, n_p * p) + tuple(g.shape[4:]))


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor,
                              k_scales: Optional[torch.Tensor] = None,
                              v_scales: Optional[torch.Tensor] = None, *,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """JAX `llama_paged.paged_attention_reference`: q (B, H, 1, d) against
    one layer's (N, H, p, d) pools, gathered through the table into
    contiguous views, over `lengths` positions (the appended token
    included), through the masked `decode_attention`."""
    ks = vs = None
    if k_scales is not None:
        ks = _gather_pages(k_scales, page_table)
        vs = _gather_pages(v_scales, page_table)
    return decode_attention(q, _gather_pages(k_pages, page_table),
                            _gather_pages(v_pages, page_table), lengths,
                            sm_scale=sm_scale, k_scale=ks, v_scale=vs)


def _check(tensors, names, want, q):
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("the paged decode kernels take CUDA tensors on one "
                         "device")
    for name, t, dt in zip(names, tensors, want):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in zip(names, tensors):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _shapes(q, k_pages, v_pages, page_table, lengths, layer):
    """(L, N, B, H, page, P, D) of a call, checked."""
    if k_pages.dim() != 5 or v_pages.shape != k_pages.shape:
        raise ValueError("pools must be (L, N, H, page, D) and alike")
    nl, n, h, page, d = k_pages.shape
    b, pps = page_table.shape
    if d not in (64, 128) or page % 16 or not 16 <= page <= 256:
        raise ValueError(f"pool {tuple(k_pages.shape)}: D must be 64 or 128 "
                         "and the page a multiple of 16 up to 256")
    if pps > MAX_PAGES:
        raise ValueError(f"the table's {pps} entries a row exceed "
                         f"{MAX_PAGES}")
    if q.shape != (b, h, 1, d) or lengths.shape != (b,):
        raise ValueError(f"q {tuple(q.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match the table "
                         f"{tuple(page_table.shape)} and pool")
    if not 0 <= int(layer) < nl:
        raise ValueError(f"layer {layer} out of range [0, {nl})")
    return nl, n, b, h, page, pps, d


def paged_fused_decode_plain(q, k_new, v_new, k_pages, v_pages, page_table,
                             lengths, layer: int, *,
                             sm_scale: Optional[float] = None):
    """The plain version: `_append_rows` of the K/V rows (in place), then
    `paged_attention_reference` over lengths + 1 positions."""
    page_ids, offs = _append_target(page_table, lengths, k_pages.shape[3])
    _append_rows(k_pages, layer, page_ids, offs, k_new[:, :, 0])
    _append_rows(v_pages, layer, page_ids, offs, v_new[:, :, 0])
    out = paged_attention_reference(q, k_pages[layer], v_pages[layer],
                                    page_table, lengths + 1,
                                    sm_scale=sm_scale)
    return out, k_pages, v_pages


def paged_fused_decode_kernel(q, k_new, v_new, k_pages, v_pages, page_table,
                              lengths, layer: int, sm_scale: float):
    """Launch the CUDA paged decode kernel over a bf16 pool. Takes
    contiguous CUDA tensors on one device: bf16 q / k_new / v_new (B, H, 1,
    D) with D 64 or 128, bf16 pools (L, N, H, page, D) with a page that is
    a multiple of 16 up to 256, int32 table (B, P) with P <= 2048 and int32
    lengths (B,). Raises on anything else. Counts its launches in
    `paged_fused_decode_kernel.launches`."""
    names = ("q", "k_new", "v_new", "k_pages", "v_pages", "page_table",
             "lengths")
    tensors = (q, k_new, v_new, k_pages, v_pages, page_table, lengths)
    _check(tensors, names, (torch.bfloat16,) * 5 + (torch.int32,) * 2, q)
    nl, n, b, h, page, pps, d = _shapes(q, k_pages, v_pages, page_table,
                                        lengths, layer)
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError("k_new / v_new must have q's shape")
    lib = cuda_lib.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_paged_decode_bf16(
            *(t.data_ptr() for t in tensors), out.data_ptr(), int(layer), nl,
            n, b, h, page, pps, d, float(sm_scale), stream)
    cuda_lib.check(err, "paged_fused_decode_kernel")
    paged_fused_decode_kernel.launches += 1
    return out, k_pages, v_pages


paged_fused_decode_kernel.launches = 0


def paged_fused_decode(
    q: torch.Tensor,           # (B, H, 1, D)
    k_new: torch.Tensor,       # (B, H, 1, D) this step's key
    v_new: torch.Tensor,       # (B, H, 1, D) this step's value
    k_pages: torch.Tensor,     # (L, N, H, page, D), updated in place
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, P) int32, 0 = null page
    lengths: torch.Tensor,     # (B,) int32 valid entries before the append
    layer: int,
    *,
    sm_scale: Optional[float] = None,
):
    """Returns (attn_out (B, H, 1, D), k_pages, v_pages); the pools are the
    same tensors, updated in place. A row with no room for the append
    (lengths[b] >= P * page; admission never makes one) behaves as in
    `fused_decode_attention`: the CUDA kernel writes nothing and returns
    NaN for it; the plain version writes where the JAX reference writes
    (the page index clamped to the table's last entry)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    args = (q, k_new, v_new, k_pages, v_pages, page_table, lengths, layer)
    if q.is_cuda:
        return paged_fused_decode_kernel(*args, sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"no paged decode path for device {q.device}")
    return paged_fused_decode_plain(*args, sm_scale=sm_scale)


def paged_fused_decode_q_plain(q, k_new, k_new_scale, v_new, v_new_scale,
                               k_pages, v_pages, k_scale_pages,
                               v_scale_pages, page_table, lengths,
                               layer: int, *,
                               sm_scale: Optional[float] = None):
    """The plain version: `_append_rows` of the int8 rows and of their
    scales (in place), then `paged_attention_reference` with the scale
    pages over lengths + 1 positions."""
    page_ids, offs = _append_target(page_table, lengths, k_pages.shape[3])
    _append_rows(k_pages, layer, page_ids, offs, k_new[:, :, 0])
    _append_rows(v_pages, layer, page_ids, offs, v_new[:, :, 0])
    _append_rows(k_scale_pages, layer, page_ids, offs, k_new_scale[:, :, 0])
    _append_rows(v_scale_pages, layer, page_ids, offs, v_new_scale[:, :, 0])
    out = paged_attention_reference(
        q, k_pages[layer], v_pages[layer], page_table, lengths + 1,
        k_scale_pages[layer], v_scale_pages[layer], sm_scale=sm_scale)
    return out, k_pages, v_pages, k_scale_pages, v_scale_pages


def paged_fused_decode_q_split_plain(q, k_new, k_new_scale, v_new,
                                     v_new_scale, k_pages, v_pages,
                                     k_scale_pages, v_scale_pages,
                                     page_table, lengths, layer: int, *,
                                     splits: int,
                                     sm_scale: Optional[float] = None,
                                     fault: int = 0):
    """`paged_fused_decode_q_plain` with the attention of the split
    kernel: the appends (in place), then the row's pages gathered into a
    contiguous view and `split_decode_attention_plain` over lengths + 1
    rows with `splits` ranks (and the planted `fault`). Float32 output."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    page_ids, offs = _append_target(page_table, lengths, k_pages.shape[3])
    _append_rows(k_pages, layer, page_ids, offs, k_new[:, :, 0])
    _append_rows(v_pages, layer, page_ids, offs, v_new[:, :, 0])
    _append_rows(k_scale_pages, layer, page_ids, offs, k_new_scale[:, :, 0])
    _append_rows(v_scale_pages, layer, page_ids, offs, v_new_scale[:, :, 0])
    out = split_decode_attention_plain(
        q, _gather_pages(k_pages[layer], page_table),
        _gather_pages(v_pages[layer], page_table), lengths, splits,
        sm_scale=sm_scale,
        k_scale=_gather_pages(k_scale_pages[layer], page_table),
        v_scale=_gather_pages(v_scale_pages[layer], page_table), fault=fault)
    return out, k_pages, v_pages, k_scale_pages, v_scale_pages


def stage_page_pieces(n_valid: int, splits: int, rank: int, page: int,
                      stage_rows: int) -> List[List[Tuple[int, int, int,
                                                          int]]]:
    """The bulk copies of each ring stage of one rank of the paged split
    kernel, in its producer's order: for a head of n_valid rows, the
    rank's share (`decode_shares`) in stages of stage_rows rows (128 at
    D128, 256 at D64), rows up to the appended one (row n_valid - 1 comes
    from k_new), each stage cut at page boundaries. Returns per stage a
    list of (table entry, offset in the page, rows, first row in the
    stage); the scales of a piece are copied as ceil(rows / 4) 16-byte
    words from the same offset."""
    s0, s1 = decode_shares(n_valid, splits)[rank]
    copy_end = min(s1, n_valid - 1)
    stages = []
    for r0 in range(s0, s1, stage_rows):
        n = max(0, min(r0 + stage_rows, copy_end) - r0)
        pieces, r = [], r0
        while r < r0 + n:
            e = min(r0 + n, (r // page + 1) * page)
            pieces.append((r // page, r % page, e - r, r - r0))
            r = e
        stages.append(pieces)
    return stages


def paged_max_clusters(d: int, splits: int) -> int:
    """How many clusters of `splits` CTAs of the paged int8 kernel can be
    resident on the current card at once (`cudaOccupancyMaxActiveClusters`)."""
    import ctypes

    _check_splits(splits)
    count = ctypes.c_int(0)
    lib = cuda_lib.load_library()
    cuda_lib.check(lib.lhrs_paged_decode_q_max_clusters(
        int(d), int(splits), ctypes.addressof(count)), "paged_max_clusters")
    return count.value


def paged_fused_decode_q_kernel(q, k_new, k_new_scale, v_new, v_new_scale,
                                k_pages, v_pages, k_scale_pages,
                                v_scale_pages, page_table, lengths,
                                layer: int, sm_scale: float, *,
                                splits: Optional[int] = None,
                                fault: int = 0):
    """Launch the CUDA paged decode kernel over an int8 pool. Takes
    contiguous CUDA tensors on one device: bf16 q (B, H, 1, D) with D 64 or
    128, int8 k/v rows (B, H, 1, D) and pools (L, N, H, page, D), float32
    row scales (B, H, 1) and scale pools (L, N, H, page), int32 table (B,
    P) and lengths (B,). Raises on anything else. `splits` forces the
    cluster size (else `decode_launch_splits` at S = P * page) and `fault`
    plants a merge fault, both for the card's checks and the A/B. Counts
    its launches in `paged_fused_decode_q_kernel.launches`."""
    _check_splits(splits)
    names = ("q", "k_new", "k_new_scale", "v_new", "v_new_scale", "k_pages",
             "v_pages", "k_scale_pages", "v_scale_pages", "page_table",
             "lengths")
    tensors = (q, k_new, k_new_scale, v_new, v_new_scale, k_pages, v_pages,
               k_scale_pages, v_scale_pages, page_table, lengths)
    _check(tensors, names,
           (torch.bfloat16, torch.int8, torch.float32, torch.int8,
            torch.float32, torch.int8, torch.int8, torch.float32,
            torch.float32, torch.int32, torch.int32), q)
    nl, n, b, h, page, pps, d = _shapes(q, k_pages, v_pages, page_table,
                                        lengths, layer)
    for name, t, shape in (("k_new", k_new, q.shape),
                           ("v_new", v_new, q.shape),
                           ("k_new_scale", k_new_scale, (b, h, 1)),
                           ("v_new_scale", v_new_scale, (b, h, 1)),
                           ("k_scale_pages", k_scale_pages,
                            k_pages.shape[:-1]),
                           ("v_scale_pages", v_scale_pages,
                            k_pages.shape[:-1])):
        if t.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    splits = splits or decode_launch_splits(q.device, b, h, pps * page, d, 1)
    lib = cuda_lib.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_paged_decode_q(
            *(t.data_ptr() for t in tensors), out.data_ptr(), int(layer), nl,
            n, b, h, page, pps, d, float(sm_scale), int(splits), int(fault),
            stream)
    cuda_lib.check(err, "paged_fused_decode_q_kernel")
    paged_fused_decode_q_kernel.launches += 1
    return out, k_pages, v_pages, k_scale_pages, v_scale_pages


paged_fused_decode_q_kernel.launches = 0


def paged_fused_decode_q(
    q: torch.Tensor,              # (B, H, 1, D) query
    k_new: torch.Tensor,          # (B, H, 1, D) int8 key codes
    k_new_scale: torch.Tensor,    # (B, H, 1) float32
    v_new: torch.Tensor,          # (B, H, 1, D) int8 value codes
    v_new_scale: torch.Tensor,    # (B, H, 1) float32
    k_pages: torch.Tensor,        # (L, N, H, page, D) int8, in place
    v_pages: torch.Tensor,
    k_scale_pages: torch.Tensor,  # (L, N, H, page) float32, in place
    v_scale_pages: torch.Tensor,
    page_table: torch.Tensor,     # (B, P) int32
    lengths: torch.Tensor,        # (B,) int32 valid entries before the append
    layer: int,
    *,
    sm_scale: Optional[float] = None,
):
    """int8-pool append + attention. Returns (attn_out (B, H, 1, D),
    k_pages, v_pages, k_scale_pages, v_scale_pages); the pools are the same
    tensors, updated in place. A full row behaves as in
    `paged_fused_decode`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    args = (q, k_new, k_new_scale, v_new, v_new_scale, k_pages, v_pages,
            k_scale_pages, v_scale_pages, page_table, lengths, layer)
    if q.is_cuda:
        return paged_fused_decode_q_kernel(*args, sm_scale)
    if q.device.type != "cpu":
        raise ValueError(f"no paged decode path for device {q.device}")
    return paged_fused_decode_q_plain(*args, sm_scale=sm_scale)
