"""Paged continuous batching: admission limited by tokens, not slots, with
content-addressed prefix caching.

Counterpart of `lhrs_bot_tpu/serve/paged.py` (`PageAllocator`, `_Match`,
`PagedScheduler`). KV lives in a shared page pool (models/llama_paged.py):
a request holds ceil((spliced + budget) / page) pages, so the admission
limit is the pool's total token capacity. The PrefixPool (serve/prefix.py)
shares pages whose token prefix is identical across requests: they are
matched by chain hash and acquired by reference, and the prefill runs over
the uncached suffix only. A request's own full pure-text prompt pages are
promoted into the pool after allocation; refcount-0 entries stay cached
until page pressure evicts them (LRU). Sharing is across admission waves:
two identical prompts admitted in the same wave do not share.

Admission reserves the full prompt + budget up front, so no preemption is
ever needed. Private pages free the moment a request finishes or is
cancelled; shared and promoted pages return to the pool's refcounting.

One repair against the reference: a released slot's row of the device page
table is reset to the null page. Every tick decodes every slot, and an idle
slot still appends a K/V row at its frozen length; in the JAX scheduler
that row still names the freed pages, which the LIFO allocator hands out
first, so an idle slot could overwrite a live sequence's KV. Here idle
slots append into page 0, which nothing reads.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.llama_paged import (PagedKVCache, paged_decode_step,
                                  paged_prefill_with_context)
from .engine import _sample_token_per_slot
from .prefix import PrefixPool
from .scheduler import ContinuousBatchingScheduler

logger = logging.getLogger(__name__)


class PageAllocator:
    """LIFO free-list over the pool; page 0 is the reserved null page."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page + null")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))

    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"(admission control must prevent this)")
        got, self._free = self._free[-n:], self._free[:-n]
        return got[::-1]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.num_pages:
                raise ValueError(f"freeing invalid page {p}")
        self._free.extend(pages)


@dataclasses.dataclass
class _Match:
    keys: list          # acquired PrefixPool keys (shared pages, in order)
    pages: list         # their page ids
    ctx: int            # shared tokens = len(pages) * page_size
    suffix: np.ndarray  # uncached prompt tokens (capped to cache room)


class PagedScheduler(ContinuousBatchingScheduler):
    """The continuous-batching scheduler over a page pool with prefix
    caching. `max_seq_len` (the per-sequence cap) is pages_per_seq *
    page_size; `num_pages` sizes the shared pool, page 0 included.
    `prefill_chunk` (a multiple of page_size) runs the decoder's prefill
    over slices of that width."""

    def __init__(self, cfg, params, llama_params, *,
                 num_pages: int, page_size: int = 128,
                 pages_per_seq: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 prompt_bucket: int = 64,
                 enable_prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None, **kw):
        if max_seq_len is None and pages_per_seq is None:
            raise ValueError("pass pages_per_seq or max_seq_len")
        if pages_per_seq is None:
            pages_per_seq = -(-max_seq_len // page_size)
        if prompt_bucket % page_size and page_size % prompt_bucket:
            raise ValueError(
                f"prompt_bucket {prompt_bucket} and page_size {page_size} "
                f"must nest (prefill widths are re-chunked into pages)")
        if prefill_chunk and prefill_chunk % page_size:
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be a multiple of "
                f"page_size {page_size} (chunk boundaries must land on page "
                f"boundaries)")
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.num_pages = num_pages
        self.allocator = PageAllocator(num_pages)
        self.enable_prefix_cache = enable_prefix_cache
        self.prefix = PrefixPool()
        self.prefill_chunk = prefill_chunk
        self._match: Dict[int, _Match] = {}
        super().__init__(cfg, params, llama_params,
                         max_seq_len=pages_per_seq * page_size,
                         prompt_bucket=max(prompt_bucket, page_size), **kw)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.max_batch)]
        self.slot_shared_keys: List[list] = [[] for _ in range(self.max_batch)]
        self.slot_promoted_keys: List[list] = [
            [] for _ in range(self.max_batch)]

    # -- device work ---------------------------------------------------------

    def _make_cache(self):
        return PagedKVCache.create(
            self.cfg.llama, self.max_batch, self.num_pages,
            self.pages_per_seq, page_size=self.page_size,
            dtype=self.cache_dtype, device=self.device)

    def _ctx_prefill(self, cache, embeds, suffix_len, ctx_len, slot_idx,
                     table_rows):
        return paged_prefill_with_context(
            self.llama_params, self.cfg.llama, cache, inputs_embeds=embeds,
            suffix_len=suffix_len, ctx_len=ctx_len, slot_idx=slot_idx,
            table_rows=table_rows, compute_dtype=self.compute_dtype)

    def _prefill(self, input_ids, images, slot_idx, seq_lens, temps, top_ps,
                 extra, *, width: int):
        """Suffix prefill against shared-page context (ctx 0 rows are a
        dense paged prefill). With `prefill_chunk`, the decoder runs over
        slices of the spliced embeddings, each at most that wide (a
        prefix-hit wave with short suffixes runs a narrower slice); a
        row whose suffix ended in an earlier slice writes nothing."""
        table_rows, ctx = (torch.as_tensor(a, device=self.device)
                           for a in extra)
        spliced = self._splice(input_ids, images, seq_lens)
        emb, spl_len = spliced.inputs_embeds, spliced.seq_len
        if not self.prefill_chunk:
            logits, cache = self._ctx_prefill(self.cache, emb, spl_len, ctx,
                                              slot_idx, table_rows)
            return _sample_token_per_slot(logits, self.generator, temps,
                                          top_ps), cache
        w = min(self.prefill_chunk, emb.shape[1])
        n_chunks = -(-emb.shape[1] // w)
        emb = torch.nn.functional.pad(
            emb, (0, 0, 0, n_chunks * w - emb.shape[1]))
        last_chunk = (spl_len.cpu().numpy() - 1).clip(min=0) // w
        cache, per_chunk = self.cache, {}
        for c in range(n_chunks):
            logits_c, cache = self._ctx_prefill(
                cache, emb[:, c * w:(c + 1) * w],
                (spl_len - c * w).clamp(0, w),
                ctx + spl_len.clamp(max=c * w), slot_idx, table_rows)
            if (last_chunk == c).any():
                per_chunk[c] = logits_c
        logits = torch.stack([per_chunk[int(c)][r]
                              for r, c in enumerate(last_chunk)])
        return _sample_token_per_slot(logits, self.generator, temps,
                                      top_ps), cache

    def _decode(self, cache, embeds):
        return paged_decode_step(self.llama_params, self.cfg.llama, cache,
                                 inputs_embeds=embeds,
                                 compute_dtype=self.compute_dtype)

    @staticmethod
    def _freeze_lengths(new_cache, old_cache, act):
        return dataclasses.replace(
            new_cache, lengths=torch.where(act, new_cache.lengths,
                                           old_cache.lengths))

    # -- prefix matching / page accounting -----------------------------------

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _img_extra(self, req) -> int:
        return self._image_count(req) * (self.cfg.pooler.num_query - 1)

    def _match_request(self, req) -> _Match:
        ids = np.asarray(req.input_ids)
        keys: list = []
        pages: list = []
        if self.enable_prefix_cache:
            # never match the full prompt: the prefill needs at least one
            # suffix token to produce next-token logits
            keys, pages = self.prefix.match(ids[:-1], self.page_size)
            if keys:
                self.prefix.acquire(keys)
        ctx = len(pages) * self.page_size
        cap = max(1, self.max_seq_len - ctx - self._img_extra(req))
        return _Match(keys=keys, pages=pages, ctx=ctx,
                      suffix=ids[ctx:ctx + cap])

    def _packed_ids(self, req):
        st = self._match.get(req.uid)
        return st.suffix if st is not None else req.input_ids

    def _room(self, slot: int, spliced: int, req=None) -> int:
        ctx = self._match[req.uid].ctx if req is not None and \
            req.uid in self._match else 0
        return self.max_seq_len - ctx - spliced

    def _fresh_pages_needed(self, req) -> int:
        st = self._match[req.uid]
        sfx_worst = len(st.suffix) + self._img_extra(req)
        total = min(st.ctx + sfx_worst + req.max_new_tokens,
                    self.max_seq_len)
        return self._pages_for(total) - len(st.pages)

    def _admission_capacity(self, requests, free) -> int:
        limit = min(len(requests), len(free))
        for req in requests[:limit]:
            self._match[req.uid] = self._match_request(req)
        avail = self.allocator.available() + self.prefix.evictable()
        taken = 0
        for req in requests[:limit]:
            need = self._fresh_pages_needed(req)
            if need > avail:
                break
            avail -= need
            taken += 1
        # un-match everything not admitted this round (they re-match on the
        # next admission attempt)
        for req in requests[taken:limit]:
            st = self._match.pop(req.uid)
            if st.keys:
                self.prefix.release(st.keys)
        if taken < limit:
            logger.info(
                "paged admission: %d/%d requests deferred (pool has %d free "
                "+ %d evictable pages)", limit - taken, limit,
                self.allocator.available(), self.prefix.evictable())
        return taken

    def _alloc(self, n: int) -> List[int]:
        short = n - self.allocator.available()
        if short > 0:
            reclaimed = self.prefix.evict(short)
            if reclaimed:
                self.allocator.free(reclaimed)
        return self.allocator.alloc(n)

    def _reserve_rows(self, slots, batch, spliced, budgets, width):
        rows = np.zeros((len(slots), self.pages_per_seq), np.int32)
        ctx_arr = np.zeros(len(slots), np.int32)
        for row, (slot, req, sp, bu) in enumerate(
                zip(slots, batch, spliced, budgets)):
            st = self._match.pop(req.uid)
            fresh = self._alloc(
                self._pages_for(st.ctx + sp + bu) - len(st.pages))
            rows[row, :len(st.pages)] = st.pages
            rows[row, len(st.pages):len(st.pages) + len(fresh)] = fresh
            ctx_arr[row] = st.ctx
            self.slot_shared_keys[slot] = list(st.keys)
            self.slot_pages[slot] = list(fresh)
            self.slot_promoted_keys[slot] = []
            if self.enable_prefix_cache:
                self._promote(slot, st, fresh, width)
        return rows, ctx_arr

    def _promote(self, slot, st: _Match, fresh, width) -> None:
        """Offer this request's full pure-text prompt pages to the pool.
        Only pages whose tokens this prefill writes (within the width) and
        that precede any image token qualify."""
        p = self.page_size
        n_written = min(len(st.suffix), width)
        neg = np.flatnonzero(np.asarray(st.suffix[:n_written]) < 0)
        text_end = int(neg[0]) if neg.size else n_written
        parent = st.keys[-1] if st.keys else None
        promoted = []
        still_private = list(fresh)
        for k in range(text_end // p):
            page_id = fresh[k]
            key, inserted = self.prefix.insert(
                parent, st.suffix[k * p:(k + 1) * p], page_id)
            parent = key
            if inserted:
                promoted.append(key)
                still_private.remove(page_id)
        self.slot_promoted_keys[slot] = promoted
        self.slot_pages[slot] = still_private

    def _release_slot(self, slot: int) -> None:
        if self.slot_shared_keys[slot]:
            self.prefix.release(self.slot_shared_keys[slot])
            self.slot_shared_keys[slot] = []
        if self.slot_promoted_keys[slot]:
            self.prefix.release(self.slot_promoted_keys[slot])
            self.slot_promoted_keys[slot] = []
        if self.slot_pages[slot]:
            self.allocator.free(self.slot_pages[slot])
            self.slot_pages[slot] = []
        # the repair: the idle slot's appends go to the null page from now
        self.cache.page_table[slot] = 0

    def fail_all(self) -> None:
        super().fail_all()
        # release matches acquired for an admission that never completed
        for st in self._match.values():
            if st.keys:
                self.prefix.release(st.keys)
        self._match.clear()

    def pool_stats(self):
        return {"free_pages": self.allocator.available(),
                "total_pages": self.num_pages - 1,
                "page_size": self.page_size,
                "prefix": self.prefix.stats()}
