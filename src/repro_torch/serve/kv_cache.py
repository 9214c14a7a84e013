"""Paged KV-cache bookkeeping for the continuous-batching ServeEngine (own
copy of ``repro.serve.kv_cache``; the registry counters of the reference
are the plain :class:`PagedStats` fields here).

The device-side KV pool (one ``(num_pages, n_kv_heads, page_size, head_dim)``
array pair per layer, built by ``LM.init_paged_caches``) is dumb storage;
this module owns every allocation decision on the host:

  * **free-list allocation** — pages are handed out LIFO from a free list;
    page 0 is permanently reserved as the *scratch* page, so a block-table
    entry of 0 always points at in-bounds (but dead) storage.  Writes for
    padded/invalid token slots and reads past a request's length land there,
    which keeps the kernel's page gather fully in-bounds without any host
    round-trip.
  * **per-request block tables** — ``tables[uid]`` is the ordered list of
    page ids whose concatenation is the request's logical KV stream.  The
    engine materializes them into a dense ``(B, width)`` int32 array (scratch-
    padded) for the kernel.
  * **refcounted prefix sharing** — every *full* page of a prompt is indexed
    under the hash of the prompt prefix it completes.  A later request whose
    prompt starts with the same tokens maps those pages into its own table
    (refcount++) and skips prefilling them.  Only full pages are shared and
    at least one prompt token is always left to prefill, so the sharer never
    writes into a shared page (its first write position is page-aligned into
    its own freshly allocated page) — no copy-on-write is needed.
  * **eviction** — when the free list runs dry, prefix-index entries whose
    pages no live request references are evicted oldest-first to reclaim
    pages.  If that still isn't enough the caller sees the failure and
    preempts a request (engine policy, not ours).

Pure host-side numpy/python — nothing here is traced.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Page id 0 is never allocated: it is the scratch page every dead block-table
# slot points at.
SCRATCH_PAGE = 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _prefix_key(tokens: Sequence[int]) -> str:
    """Content hash of a prompt prefix (order-sensitive, deterministic)."""
    arr = np.asarray(list(tokens), dtype=np.int32)
    return hashlib.sha1(arr.tobytes()).hexdigest()


@dataclasses.dataclass
class PagedStats:
    """Counters the engine folds into StepTelemetry / BENCH_serve.json."""
    allocated_pages: int = 0      # allocation events (lifetime)
    prefix_queries: int = 0
    prefix_hit_pages: int = 0     # pages mapped in via sharing (lifetime)
    prefix_hit_tokens: int = 0    # prompt tokens skipped via sharing
    evictions: int = 0            # prefix entries evicted under pressure


class PagedKVCache:
    """Host-side page allocator + block tables + prefix index.

    ``num_pages`` counts the whole pool *including* the reserved scratch
    page, matching the leading axis of the device pool arrays.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is reserved "
                             f"scratch), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # LIFO free list; page 0 (SCRATCH_PAGE) is never in it.
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros(self.num_pages, dtype=np.int64)
        self._tables: Dict[object, List[int]] = {}
        self._lengths: Dict[object, int] = {}
        # prefix key -> page id, oldest-first (eviction order); the index
        # itself holds one reference on every page it names.
        self._prefix: "OrderedDict[str, int]" = OrderedDict()
        self.stats = PagedStats()

    # ---------------------------------------------------------------- pool

    @property
    def pages_in_use(self) -> int:
        """Allocatable pages currently NOT on the free list."""
        return (self.num_pages - 1) - len(self._free)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def occupancy(self) -> float:
        cap = self.num_pages - 1
        return self.pages_in_use / cap if cap else 0.0

    def _reclaim_one(self) -> bool:
        """Evict prefix entries (oldest first) until one page is freed."""
        for key in list(self._prefix):
            page = self._prefix[key]
            if self._ref[page] == 1:        # only the index holds it
                del self._prefix[key]
                self._ref[page] = 0
                self._free.append(page)
                self.stats.evictions += 1
                return True
        return False

    def _take_page(self) -> Optional[int]:
        if not self._free and not self._reclaim_one():
            return None
        page = self._free.pop()
        assert page != SCRATCH_PAGE and self._ref[page] == 0
        self._ref[page] = 1
        self.stats.allocated_pages += 1
        return page

    def _release_page(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] < 0:
            raise RuntimeError(f"page {page} refcount went negative "
                               f"(double free)")
        if self._ref[page] == 0:
            self._free.append(page)

    # ------------------------------------------------------------- prefix

    def match_prefix(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest indexed full-page prefix of ``prompt``.

        Returns ``(pages, shared_tokens)``.  At least one prompt token is
        always left unshared so prefill still produces the logits that seed
        the first generated token (and so the sharer's first cache write is
        page-aligned into its own page).
        """
        ps = self.page_size
        self.stats.prefix_queries += 1
        max_shareable = (len(prompt) - 1) // ps if len(prompt) else 0
        pages: List[int] = []
        for p in range(max_shareable):
            key = _prefix_key(prompt[:(p + 1) * ps])
            page = self._prefix.get(key)
            if page is None:
                break
            pages.append(page)
        return pages, len(pages) * ps

    def register_prefix(self, uid, prompt: Sequence[int]) -> int:
        """Index every full prompt page of a (fully prefilled) request.

        Returns the number of newly indexed pages.  Pages whose prefix key
        is already indexed (e.g. the ones this request itself shared) are
        skipped — the existing entry keeps its age.
        """
        table = self._tables[uid]
        ps = self.page_size
        added = 0
        for p in range(len(prompt) // ps):
            key = _prefix_key(prompt[:(p + 1) * ps])
            if key in self._prefix:
                continue
            page = table[p]
            self._prefix[key] = page
            self._ref[page] += 1
            added += 1
        return added

    @property
    def prefix_entries(self) -> int:
        return len(self._prefix)

    # ---------------------------------------------------------- sequences

    def allocate(self, uid, shared_pages: Sequence[int] = (),
                 shared_tokens: int = 0) -> None:
        """Create a sequence whose table starts with ``shared_pages``."""
        if uid in self._tables:
            raise ValueError(f"uid {uid!r} already allocated")
        if shared_tokens != len(shared_pages) * self.page_size:
            raise ValueError("prefix sharing covers full pages only: "
                             f"{shared_tokens} tokens vs "
                             f"{len(shared_pages)} pages")
        for page in shared_pages:
            self._ref[page] += 1
        self.stats.prefix_hit_pages += len(shared_pages)
        self.stats.prefix_hit_tokens += shared_tokens
        self._tables[uid] = list(shared_pages)
        self._lengths[uid] = shared_tokens

    def rollback_prefix_hits(self, pages: int, tokens: int) -> None:
        """Undo :meth:`allocate`'s prefix-hit accounting for a sequence
        whose admission was rolled back before it did any work — otherwise
        a request stuck at the queue head re-inflates the sharing counters
        on every admission attempt."""
        self.stats.prefix_hit_pages -= int(pages)
        self.stats.prefix_hit_tokens -= int(tokens)

    def ensure(self, uid, new_length: int) -> bool:
        """Grow ``uid``'s table to cover ``new_length`` tokens.

        Returns False (sequence untouched) if the pool cannot supply the
        pages even after prefix eviction — the engine then preempts.
        """
        table = self._tables[uid]
        need = cdiv(new_length, self.page_size) - len(table)
        if need <= 0:
            self._lengths[uid] = max(self._lengths[uid], new_length)
            return True
        fresh: List[int] = []
        for _ in range(need):
            page = self._take_page()
            if page is None:
                for p in fresh:              # roll back, all-or-nothing
                    self._release_page(p)
                return False
            fresh.append(page)
        table.extend(fresh)
        self._lengths[uid] = max(self._lengths[uid], new_length)
        return True

    def free_seq(self, uid) -> None:
        """Drop a sequence; pages return to the free list when unreferenced
        (prefix-indexed pages survive for future sharing)."""
        table = self._tables.pop(uid)
        del self._lengths[uid]
        for page in table:
            self._release_page(page)

    def table(self, uid) -> List[int]:
        return list(self._tables[uid])

    def block_table_row(self, uid, width: int) -> np.ndarray:
        """Dense int32 row for the kernel, scratch-padded to ``width``."""
        table = self._tables[uid]
        if len(table) > width:
            raise ValueError(f"uid {uid!r} holds {len(table)} pages, "
                             f"block-table width is {width}")
        row = np.full(width, SCRATCH_PAGE, dtype=np.int32)
        row[:len(table)] = table
        return row

    def check_invariants(self) -> None:
        """Internal-consistency audit used by tests."""
        counted = np.zeros(self.num_pages, dtype=np.int64)
        for table in self._tables.values():
            for page in table:
                counted[page] += 1
        for page in self._prefix.values():
            counted[page] += 1
        if not np.array_equal(counted, self._ref):
            raise AssertionError(
                f"refcount drift: counted {counted.tolist()} vs "
                f"stored {self._ref.tolist()}")
        free = set(self._free)
        if SCRATCH_PAGE in free:
            raise AssertionError("scratch page leaked into the free list")
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        for page in free:
            if self._ref[page] != 0:
                raise AssertionError(f"free page {page} has refcount "
                                     f"{self._ref[page]}")
        in_use = {p for p in range(1, self.num_pages) if self._ref[p] > 0}
        if in_use & free:
            raise AssertionError("page both free and referenced")
        if len(in_use) + len(free) != self.num_pages - 1:
            raise AssertionError("pages leaked (neither free nor referenced)")
