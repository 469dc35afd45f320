"""Paged KV cache: a page pool shared by all slots, for the decode path.

Counterpart of `lhrs_bot_tpu/models/llama_paged.py` (`PagedKVCache`,
`scatter_prefill`, `paged_attention_reference`, `paged_prefill_with_context`,
`_append_rows`, `paged_decode_step`). A sequence holds ceil(len / page)
pages of the pool instead of max_seq_len rows, so admission is limited by
total tokens, not slots (serve/paged.py does the bookkeeping).

Layout: pools (L, N_pages, H, page, d), one page a dense (H, page, d) block;
`page_table` (B, pages_per_seq) int32 rows index the pool. **Page 0 is the
null page**: unallocated table entries point at it, it is never allocated to
a sequence, and masked attention (positions >= length) never reads it.

Unlike the JAX package, the pools are updated IN PLACE: the prefill and
decode functions write into the pool tensors of the cache they are given and
return a PagedKVCache over those same pools, with new page-table and length
tensors. Every weight format of the contiguous decoder is taken (bf16, int8,
NF4 and "4h", the latter W4A8 in decode as in `llama_decode_step`). On CUDA
tensors `paged_decode_step` always launches the paged decode kernels
(ops/paged_fused.py), where JAX decides by backend.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..device import resolve_device
# `_append_rows` and `paged_attention_reference` live beside the kernels
# they are the plain versions of; importable here under the JAX module's
# names
from ..ops.paged_fused import (_append_rows,  # noqa: F401
                               paged_attention_reference,  # noqa: F401
                               paged_fused_decode, paged_fused_decode_q)
from ..ops.quant import quantize_activation
from ..ops.rmsnorm import rms_norm
from ..ops.rope import rope_cos_sin
from .llama import (KVCache, LlamaConfig, _layer, _lm_head_logits, _proj,
                    _qkv, _silu_mlp)


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor     # (L, N_pages, H, page_size, d)
    v_pages: torch.Tensor     # (L, N_pages, H, page_size, d)
    page_table: torch.Tensor  # (B, pages_per_seq) int32, 0 = null page
    lengths: torch.Tensor     # (B,) int32 valid tokens per slot
    # int8 pools: per-(head, position) vector scales, x ~ q * scale
    k_scale_pages: Optional[torch.Tensor] = None  # (L, N, H, page) float32
    v_scale_pages: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale_pages is not None

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, num_pages: int,
               pages_per_seq: int, page_size: int = 128,
               dtype: torch.dtype = torch.bfloat16,
               device="cuda") -> "PagedKVCache":
        """Zero pools, an all-null table and zero lengths; int8 pools get
        scale pages that start at 1."""
        if dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise NotImplementedError(f"{dtype} page pool is not ported "
                                      "(bf16/f32/int8 only)")
        device = resolve_device(device)
        shape = (cfg.num_hidden_layers, num_pages, cfg.num_attention_heads,
                 page_size, cfg.head_dim)
        scales = {}
        if dtype == torch.int8:
            scales = {name: torch.ones(shape[:-1], dtype=torch.float32,
                                       device=device)
                      for name in ("k_scale_pages", "v_scale_pages")}
        return cls(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            page_table=torch.zeros((batch, pages_per_seq), dtype=torch.int32,
                                   device=device),
            lengths=torch.zeros(batch, dtype=torch.int32, device=device),
            **scales)


def _with_rows(t: torch.Tensor, slot_idx: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """A copy of `t` with its rows `slot_idx` set to `rows`."""
    t = t.clone()
    t[slot_idx.long()] = rows.to(t.dtype)
    return t


def scatter_prefill(pcache: PagedKVCache, tmp: KVCache,
                    slot_idx: torch.Tensor, table_rows: torch.Tensor,
                    prompt_len: torch.Tensor) -> PagedKVCache:
    """Move a contiguous prefill's (L, b, H, W, d) K/V into the pool, in
    place, re-chunked into the pages that `table_rows` (b, pages_per_seq)
    names. Entries past a prompt's allocation must be 0: those chunks land
    on the null page, which is never read."""
    nl, b, h, w, d = tmp.k.shape
    p = pcache.page_size
    if w % p:
        raise ValueError(f"prefill width {w} not a multiple of page size {p}")
    n_chunks = w // p
    if n_chunks > pcache.pages_per_seq:
        raise ValueError(f"prefill width {w} needs {n_chunks} pages > "
                         f"pages_per_seq {pcache.pages_per_seq}")
    if pcache.quantized != tmp.quantized:
        raise ValueError("paged pool and prefill cache dtype mismatch")
    ids = table_rows[:, :n_chunks].reshape(-1).long()

    def put(pool, rows):  # (L, b, H, W[, d]) -> (L, b * n_chunks, H, p[, d])
        chunks = rows.reshape((nl, b, h, n_chunks, p) + rows.shape[4:])
        chunks = chunks.transpose(2, 3).reshape(
            (nl, b * n_chunks, h, p) + rows.shape[4:])
        pool[:, ids] = chunks.to(pool.dtype)

    put(pcache.k_pages, tmp.k)
    put(pcache.v_pages, tmp.v)
    if pcache.quantized:
        put(pcache.k_scale_pages, tmp.k_scale)
        put(pcache.v_scale_pages, tmp.v_scale)
    return dataclasses.replace(
        pcache, page_table=_with_rows(pcache.page_table, slot_idx, table_rows),
        lengths=_with_rows(pcache.lengths, slot_idx, prompt_len))


def _gather_row(pool: torch.Tensor, table_row: torch.Tensor) -> torch.Tensor:
    """One layer's (N, H, p[, d]) pool through one (P,) table row: the
    contiguous (1, H, P * p[, d]) view of the row's pages."""
    g = pool[table_row.long()].transpose(0, 1)  # (H, P, p[, d])
    return g.reshape((1, g.shape[0], -1) + tuple(g.shape[3:]))


def paged_prefill_with_context(
    params, cfg: LlamaConfig, pcache: PagedKVCache, *,
    inputs_embeds: torch.Tensor,  # (b, W, D) suffix embeds, right-padded
    suffix_len: torch.Tensor,     # (b,) int32 valid suffix tokens
    ctx_len: torch.Tensor,        # (b,) int32 shared-prefix tokens, page-
                                  # aligned (full pages already in the table)
    slot_idx: torch.Tensor,       # (b,) int32 rows of the batch being filled
    table_rows: torch.Tensor,     # (b, pages_per_seq) shared pages first,
                                  # then fresh ones, 0-padded
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, PagedKVCache]:
    """Prefill only a prompt suffix against shared-page context (JAX
    `paged_prefill_with_context`); with ctx_len 0 it is the dense paged
    prefill. Returns (next-token logits (b, V) float32, cache).

    Per layer the suffix K/V are written into the request's pages first (in
    place; padded columns go to the null page), then attention gathers the
    whole table row (shared context + the suffix just written) and masks
    causally against global positions (query i sees columns <= ctx + i);
    RoPE takes the global positions. The float32 scores of one row are (H,
    W, P * page), about 0.7 GB at 7B with W = P * page = 2304, so attention
    loops over the rows of the admission, one row at a time."""
    x = inputs_embeds.to(compute_dtype)
    b, w, _ = x.shape
    dev = x.device
    p = pcache.page_size
    ctx_len = ctx_len.to(dev).long()
    suffix_len = suffix_len.to(dev).long()
    table_rows = table_rows.to(dev)
    positions = ctx_len[:, None] + torch.arange(w, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

    n_pages = table_rows.shape[1]
    valid_tok = torch.arange(w, device=dev)[None, :] < suffix_len[:, None]
    page_idx = (positions // p).clamp(max=n_pages - 1)
    tok_pages = torch.where(valid_tok, table_rows.long().gather(1, page_idx),
                            0)
    tok_offs = positions % p
    s_total = pcache.pages_per_seq * p
    quantized = pcache.quantized
    sm = 1.0 / math.sqrt(cfg.head_dim)
    causal = (torch.arange(s_total, device=dev)[None, None, :]
              <= positions[:, :, None])  # (b, W, S)

    def attend(q, k_view, v_view, ks_view, vs_view, mask):
        scores = torch.matmul(q.float(), k_view.to(q.dtype).float()
                              .transpose(-1, -2)) * sm
        if ks_view is not None:
            scores = scores * ks_view[:, :, None, :]
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1)
        if vs_view is not None:
            probs = probs * vs_view[:, :, None, :]
        return torch.matmul(probs.to(q.dtype), v_view.to(q.dtype))

    kp, vp = pcache.k_pages, pcache.v_pages
    ks, vs = pcache.k_scale_pages, pcache.v_scale_pages
    for li in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], li)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, cos, sin)  # (b, H, W, hd)
        k_rows = k.transpose(1, 2)  # (b, W, H, d)
        v_rows = v.transpose(1, 2)
        if quantized:
            k_q, k_s = quantize_activation(k_rows)
            v_q, v_s = quantize_activation(v_rows)
            kp[li, tok_pages, :, tok_offs] = k_q
            vp[li, tok_pages, :, tok_offs] = v_q
            ks[li, tok_pages, :, tok_offs] = k_s[..., 0]
            vs[li, tok_pages, :, tok_offs] = v_s[..., 0]
        else:
            kp[li, tok_pages, :, tok_offs] = k_rows.to(kp.dtype)
            vp[li, tok_pages, :, tok_offs] = v_rows.to(vp.dtype)
        attn = torch.cat([attend(
            q[r:r + 1], _gather_row(kp[li], table_rows[r]),
            _gather_row(vp[li], table_rows[r]),
            None if ks is None else _gather_row(ks[li], table_rows[r]),
            None if vs is None else _gather_row(vs[li], table_rows[r]),
            causal[r]) for r in range(b)])
        attn = attn.transpose(1, 2).reshape(b, w, cfg.hidden_size)
        x = x + _proj(lp, "wo", attn)
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _silu_mlp(h2, lp)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = (suffix_len - 1).clamp(min=0)
    logits = _lm_head_logits(x[torch.arange(b, device=dev), last],
                             params["lm_head"])
    return logits, dataclasses.replace(
        pcache, page_table=_with_rows(pcache.page_table, slot_idx,
                                      table_rows),
        lengths=_with_rows(pcache.lengths, slot_idx, ctx_len + suffix_len))


def paged_decode_step(params, cfg: LlamaConfig, pcache: PagedKVCache, *,
                      inputs_embeds: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decode step over the paged cache from the (B, 1, D) embedding
    of the new token; returns (logits (B, V) float32, cache with lengths +
    1). Mirrors `llama_decode_step`: every layer appends its K/V row at
    lengths[b] into the row's page, in place, and attends over lengths + 1
    positions through `paged_fused_decode`, or, for an int8 pool, appends
    the `quantize_activation` codes and scales through
    `paged_fused_decode_q`. "4h" weights run W4A8."""
    x = inputs_embeds.to(compute_dtype)
    b = x.shape[0]
    cos, sin = rope_cos_sin(pcache.lengths[:, None], cfg.head_dim,
                            cfg.rope_theta)
    for li in range(cfg.num_hidden_layers):
        lp = _layer(params["layers"], li, w4a8=True)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, cos, sin)  # (B, H, 1, hd)
        if pcache.quantized:
            k_q, k_s = quantize_activation(k)
            v_q, v_s = quantize_activation(v)
            attn = paged_fused_decode_q(
                q, k_q, k_s[..., 0], v_q, v_s[..., 0], pcache.k_pages,
                pcache.v_pages, pcache.k_scale_pages, pcache.v_scale_pages,
                pcache.page_table, pcache.lengths, li)[0]
        else:
            attn = paged_fused_decode(q, k, v, pcache.k_pages,
                                      pcache.v_pages, pcache.page_table,
                                      pcache.lengths, li)[0]
        attn = attn.to(compute_dtype).transpose(1, 2).reshape(
            b, 1, cfg.hidden_size)
        x = x + _proj(lp, "wo", attn)
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _silu_mlp(h2, lp)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _lm_head_logits(x[:, 0, :], params["lm_head"])
    return logits, dataclasses.replace(pcache, lengths=pcache.lengths + 1)
