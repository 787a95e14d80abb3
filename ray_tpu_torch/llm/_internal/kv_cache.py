"""Host-side page allocator for the paged KV cache.

A copy of ``ray_tpu/llm/_internal/kv_cache.py``'s ``PageAllocator``
(this package imports nothing from the JAX package). The engine
attaches its host KV tier (``kv_offload.HostKVTier``) as ``host_tier``
so that one ``stats()`` reports device and parked host pages together.

Reference parity: vLLM's BlockManager role (external to the reference —
net-new here; SURVEY.md §7 step 10). Pages are allocated worst-case at
admission (prompt + max_new_tokens) so a running sequence can never hit
cache OOM mid-decode — admission control is the backpressure point.

Prefix caching (SURVEY §7 hard part 1): full prompt pages are
hash-consed — a page's key is the chain (parent_key, its page_size
tokens), so two requests sharing a prompt prefix share the KV pages and
the second prefill starts where the match ends. Shared pages are
refcounted; only FULL pages are ever shared, so the write path (decode
scatters, partial-page prefill) always lands in private pages and no
copy-on-write is needed. Cached-but-unreferenced pages stay resident
and are evicted LRU only under allocation pressure.

A request under a LoRA adapter bypasses the cache (``lora`` not None:
no match, no registration): an adapter changes the residual stream and
so the K/V of every later layer, which the token chain does not key.
The JAX allocator keys on tokens alone and shares such pages; this is a
recorded departure.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int,
                 enable_prefix_caching: bool = True):
        # last page is the scratch page scatter_kv() uses for masked rows
        self.page_size = page_size
        self.num_usable = num_pages - 1
        self.enable_prefix_caching = enable_prefix_caching
        self._free: List[int] = list(range(self.num_usable))
        self._rc: Dict[int, int] = {}
        # prefix cache: chain key -> page id, LRU-ordered (move_to_end on
        # hit). The cache itself holds one reference on its pages.
        self._cache: "OrderedDict[Tuple, int]" = OrderedDict()
        self._key_by_page: Dict[int, Tuple] = {}
        self.cache_hit_tokens = 0
        self.cache_query_tokens = 0
        # the next tier down: the engine's HostKVTier, when KV offload
        # is on (its stats join this allocator's)
        self.host_tier: Optional[Any] = None

    # ------------------------------------------------------------ basics
    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now (free list + evictable cache)."""
        evictable = sum(1 for p in self._cache.values()
                        if self._rc.get(p, 0) == 1)
        return len(self._free) + evictable

    def can_allocate(self, num_tokens: int) -> bool:
        return self.pages_needed(num_tokens) <= self.free_pages

    def allocate(self, num_tokens: int) -> List[int]:
        return self.allocate_pages(self.pages_needed(num_tokens))

    def allocate_pages(self, n: int) -> List[int]:
        if n > self.free_pages:
            raise MemoryError(
                f"KV cache exhausted: need {n} pages, {self.free_pages} "
                f"free")
        while len(self._free) < n:
            self._evict_one()
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._rc[p] = 1
        return pages

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            rc = self._rc.get(p, 0) - 1
            if rc <= 0:
                self._rc.pop(p, None)
                self._free.append(p)
            else:
                self._rc[p] = rc

    # ----------------------------------------------------- prefix cache
    def _chain_keys(self, tokens: Sequence[int]) -> List[Tuple]:
        """One key per FULL page of `tokens`, each chaining its parent."""
        keys: List[Tuple] = []
        parent: Tuple = ()
        for i in range(len(tokens) // self.page_size):
            page_toks = tuple(
                tokens[i * self.page_size:(i + 1) * self.page_size])
            parent = (parent, page_toks)
            keys.append(parent)
        return keys

    def shares(self, lora: Optional[str] = None) -> bool:
        """Whether a request under `lora` matches and registers pages."""
        return self.enable_prefix_caching and lora is None

    def match_prefix(self, prompt_tokens: Sequence[int],
                     lora: Optional[str] = None) -> Tuple[List[int], int]:
        """Longest cached chain of full prompt pages.

        Returns (shared page ids with a reference taken, matched token
        count). Matching is capped one token short of the full prompt so
        the final prompt token is always recomputed — its logits seed
        the first sampled token (vLLM does the same). A request under an
        adapter matches nothing."""
        if not self.shares(lora):
            return [], 0
        matchable = prompt_tokens[:max(len(prompt_tokens) - 1, 0)]
        pages: List[int] = []
        for key in self._chain_keys(matchable):
            page = self._cache.get(key)
            if page is None:
                break
            self._cache.move_to_end(key)
            self._rc[page] = self._rc.get(page, 0) + 1
            pages.append(page)
        return pages, len(pages) * self.page_size

    def cached_prefix_pages(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached chain of FULL pages for `tokens`, in chain
        order, without taking references or touching the LRU order (the
        prefix export and import paths only inspect the cache). Unlike
        match_prefix it is not capped one token short: every cached page
        of the prompt counts."""
        pages: List[int] = []
        for key in self._chain_keys(tokens):
            page = self._cache.get(key)
            if page is None:
                break
            pages.append(page)
        return pages

    def record_match(self, matched: int, prompt_len: int) -> None:
        """Hit-rate accounting, called ONCE per ADMITTED request (a
        blocked head-of-line request re-matches every scheduler tick and
        must not inflate the telemetry)."""
        self.cache_hit_tokens += matched
        self.cache_query_tokens += prompt_len

    def register_prefix(self, prompt_tokens: Sequence[int],
                        pages: Sequence[int],
                        lora: Optional[str] = None) -> None:
        """Offer a prefilled prompt's full pages to the cache. Pages
        already cached under the same chain are skipped (the earlier
        copy wins); newly cached pages gain the cache's reference. Pages
        computed under an adapter are never offered."""
        if not self.shares(lora):
            return
        keys = self._chain_keys(prompt_tokens)
        for key, page in zip(keys, pages):
            if key in self._cache:
                self._cache.move_to_end(key)
                continue
            if page in self._key_by_page:
                continue   # page already caches a different chain
            self._cache[key] = page
            self._key_by_page[page] = key
            self._rc[page] = self._rc.get(page, 0) + 1

    def _evict_one(self) -> None:
        """Drop the least-recently-used cache entry whose page has no
        other owner (rc == 1: only the cache holds it)."""
        for key, page in self._cache.items():
            if self._rc.get(page, 0) == 1:
                del self._cache[key]
                del self._key_by_page[page]
                self._rc.pop(page, None)
                self._free.append(page)
                return
        raise MemoryError("no evictable KV cache page")

    def clear_cache(self) -> None:
        """Drop every cache entry whose page has no other owner (bench /
        test hook; entries still referenced by live sequences stay)."""
        for key in list(self._cache):
            page = self._cache[key]
            if self._rc.get(page, 0) == 1:
                del self._cache[key]
                del self._key_by_page[page]
                self._rc.pop(page, None)
                self._free.append(page)

    # ------------------------------------------------------------- stats
    @property
    def cached_pages(self) -> int:
        return len(self._cache)

    @property
    def used_pages(self) -> int:
        """Pages NOT allocatable right now — referenced by live
        sequences or pinned by multiply-owned cache entries (the
        complement of free_pages, which counts evictable cached pages
        as free)."""
        return self.num_usable - self.free_pages

    @property
    def cache_hit_rate(self) -> float:
        """Cumulative prefix-cache hit rate: matched prompt tokens /
        queried prompt tokens over every ADMITTED request (the
        occupancy signal paged-attention serving is judged on)."""
        return (self.cache_hit_tokens / self.cache_query_tokens
                if self.cache_query_tokens else 0.0)

    def stats(self) -> Dict[str, float]:
        out = {
            "free_pages": self.free_pages,
            "used_pages": self.used_pages,
            "occupancy": (self.used_pages / self.num_usable
                          if self.num_usable else 0.0),
            "cached_pages": self.cached_pages,
            "cache_hit_tokens": self.cache_hit_tokens,
            "cache_query_tokens": self.cache_query_tokens,
            "cache_hit_rate": self.cache_hit_rate,
        }
        if self.host_tier is not None:
            out.update(self.host_tier.stats())
        return out
