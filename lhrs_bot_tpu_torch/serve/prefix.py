"""Prefix cache: content-addressed sharing of prompt KV pages.

A jax-free copy of `lhrs_bot_tpu/serve/prefix.py` `PrefixPool` (that module
imports no JAX, but the port imports nothing of the JAX package). With the
paged pool (models/llama_paged.py) a prompt's KV lives in pages, so
identical token prefixes can share pages: the pool maps a chain hash of the
token prefix to a page id, admission walks the chain page by page, and the
prefill runs only over the suffix (`paged_prefill_with_context`).

Invariants:
  * a page's key commits to the entire prefix up to its end (chain hash:
    key_k = H(key_{k-1}, tokens of page k)), so a hit guarantees identical
    KV content, positions included, since pages are position-aligned;
  * only full pages of pure-text prompt tokens are inserted (an image
    splice makes the KV after it depend on pixels; generated tokens differ
    per request), so matching stops at the first image token;
  * pages held by the pool are never in the allocator's free list; they
    return to it only through eviction (LRU over refcount-0 entries).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class _Entry:
    page: int
    refs: int
    tick: int


class PrefixPool:
    """Chain-hash → pooled page with refcounts and LRU eviction."""

    def __init__(self):
        self._entries: Dict[Tuple, _Entry] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    @staticmethod
    def _key(parent: Optional[Tuple], page_tokens: Sequence[int]) -> Tuple:
        return (parent, tuple(int(t) for t in page_tokens))

    def match(self, ids, page_size: int) -> Tuple[List[Tuple], List[int]]:
        """Walk full pages of `ids` while the chain hits; returns (keys,
        page ids) of the shared prefix. Does NOT acquire references."""
        keys, pages = [], []
        parent: Optional[Tuple] = None
        n_full = len(ids) // page_size
        for k in range(n_full):
            chunk = ids[k * page_size:(k + 1) * page_size]
            if any(int(t) < 0 for t in chunk):
                break  # image splice: KV beyond here is request-specific
            key = self._key(parent, chunk)
            ent = self._entries.get(key)
            if ent is None:
                break
            keys.append(key)
            pages.append(ent.page)
            parent = key
        if keys:
            self.hits += 1
            self.tokens_reused += len(keys) * page_size
        else:
            self.misses += 1
        return keys, pages

    def acquire(self, keys: Sequence[Tuple]) -> None:
        self._tick += 1
        for key in keys:
            ent = self._entries[key]
            ent.refs += 1
            ent.tick = self._tick

    def release(self, keys: Sequence[Tuple]) -> None:
        for key in keys:
            ent = self._entries.get(key)
            if ent is None or ent.refs <= 0:
                raise ValueError(f"release of unheld prefix page {key!r}")
            ent.refs -= 1

    def insert(self, parent: Optional[Tuple], page_tokens: Sequence[int],
               page: int) -> Tuple[Tuple, bool]:
        """Register `page` as holding `page_tokens` after `parent`; the
        inserter holds one reference. Returns (key, inserted) — inserted
        is False when the chain position is already occupied (the caller
        keeps its page private but can chain further inserts off the
        returned key, which is content-determined)."""
        key = self._key(parent, page_tokens)
        if key in self._entries:
            return key, False
        self._tick += 1
        self._entries[key] = _Entry(page=page, refs=1, tick=self._tick)
        return key, True

    def evictable(self) -> int:
        return sum(1 for e in self._entries.values() if e.refs == 0)

    def evict(self, n: int) -> List[int]:
        """Drop up to `n` refcount-0 entries (LRU first); returns their
        page ids for the allocator to reclaim."""
        victims = sorted(
            (item for item in self._entries.items() if item[1].refs == 0),
            key=lambda kv: kv[1].tick)[:n]
        for key, _ in victims:
            del self._entries[key]
        return [e.page for _, e in victims]

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries),
                "evictable": self.evictable(),
                "hits": self.hits, "misses": self.misses,
                "tokens_reused": self.tokens_reused}
