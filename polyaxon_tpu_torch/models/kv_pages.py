"""Block-paged KV-cache accounting: page pool, content-addressed prefixes
(own copy of `polyaxon_tpu/models/kv_pages.py`; the port imports nothing of
the JAX package).

The device tensors — one pair of `[pool_pages, page_tokens, n_kv_heads,
head_dim]` K/V tensors per layer — are made by
`models.generate.make_paged_cache` and indexed through per-request page
tables (the paged branch of `models.transformer.Attention`; `serving/kv.py`
owns the device pool). THIS module is the host-side bookkeeping that
decides which pool slots those tables may point at:

**PagePool** — a free list with refcounts and admission reservations.
Requests reserve their worst-case page demand at admission (so the
coalescer sheds instead of running out of memory mid-decode) and allocate
lazily as decode advances; pages are refcounted because prefix-cache
entries and in-flight requests share them copy-on-write (readers alias the
page, writers always target pages they own exclusively).

**PrefixCache** — content-addressed index of prefilled pages. Prompt
prefixes are keyed by a ROLLING chain hash over page-aligned token
chunks (hash of page k commits to pages 0..k), so a lookup walks the
chain and returns the longest cached prefix whose token content
VERIFIES (hash collisions degrade to misses, never to wrong KV).
A `namespace` seeds the chain: K/V that depend on more than the tokens
(the adapter that projected them) live in a chain of their own, and the
empty namespace gives the plain chain.
Eviction is LRU over entries not referenced by any in-flight request;
freed pages return to the pool only when their refcount drains.

Dependency-free (no torch) and clock-free: recency is a logical tick
counter.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import deque
from typing import Callable, Optional

DEFAULT_PAGE_TOKENS = 128

# hash_fn(prev_hash_or_None, chunk_tokens) -> str. Injectable so tests can
# force collisions; the default chains blake2b over the previous digest and
# the chunk's token bytes (framed, so [1,23] never collides with [12,3]).
HashFn = Callable[[Optional[str], tuple], str]


def _default_hash(prev: Optional[str], chunk: tuple) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(b"kv-prefix-v1|")
    h.update((prev or "").encode())
    for t in chunk:
        h.update(b"|%d" % int(t))
    return h.hexdigest()


def page_hashes(
    tokens, page_tokens: int, hash_fn: Optional[HashFn] = None, namespace: str = ""
) -> list[str]:
    """Chain hashes for every FULL page of `tokens`: entry k (0-based)
    commits to tokens[: (k+1) * page_tokens] and to `namespace`. Partial
    tail pages are not addressable — prefix reuse is token-page-aligned by
    design."""
    fn = hash_fn or _default_hash
    out: list[str] = []
    # a digest is hex, so no seed "ns:..." is ever another chain's link
    prev: Optional[str] = f"ns:{namespace}" if namespace else None
    for i in range(len(tokens) // page_tokens):
        chunk = tuple(int(t) for t in tokens[i * page_tokens:(i + 1) * page_tokens])
        prev = fn(prev, chunk)
        out.append(prev)
    return out


@dataclasses.dataclass(frozen=True)
class PagedKVLayout:
    """Static shape of the device pool (frozen, hashable).

    `kv_quant` selects the pool element type: "none" keeps the model's
    dtype; "int8" holds an int8 payload plus one f32 scale per slot and kv
    head (`models.quant.quantize_kv`)."""

    page_tokens: int = DEFAULT_PAGE_TOKENS
    pool_pages: int = 0
    kv_quant: str = "none"  # none | int8

    def __post_init__(self):
        if self.page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {self.page_tokens}")
        if self.pool_pages < 1:
            raise ValueError(f"pool_pages must be >= 1, got {self.pool_pages}")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"kv_quant must be 'none' or 'int8', got {self.kv_quant!r}"
            )

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold `n_tokens` cache slots."""
        return -(-max(0, int(n_tokens)) // self.page_tokens)


class PagePoolExhausted(RuntimeError):
    """Allocation/reservation would overcommit the pool. The serving layer
    maps this to a 503 shed (reason `kv_pages`) — never an out-of-memory
    error mid-decode."""


class PagePool:
    """Fixed pool of page ids with refcounts and admission reservations.

    Not thread-safe by itself — the owning KVCacheManager serializes
    access (one lock covers pool + prefix index + page tables).

    Invariant: `reserved <= len(free)` at all times, so a reservation made
    at admission can ALWAYS be converted into pages mid-decode —
    exhaustion is only ever surfaced at admission time.
    """

    def __init__(self, n_pages: int, page_tokens: int = DEFAULT_PAGE_TOKENS):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        self._free: deque[int] = deque(range(self.n_pages))
        self._refs: dict[int, int] = {}
        self._reserved = 0
        self.used_hwm = 0
        self.alloc_total = 0

    # ------------------------------------------------------------- views
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def reserved(self) -> int:
        return self._reserved

    @property
    def available(self) -> int:
        """Pages a NEW reservation (or an unreserved alloc) may claim."""
        return len(self._free) - self._reserved

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    # ------------------------------------------------------ reservations
    def reserve(self, n: int) -> None:
        """Earmark `n` free pages for later alloc(reserved=True) calls."""
        if n < 0:
            raise ValueError(f"cannot reserve {n} pages")
        if n > self.available:
            raise PagePoolExhausted(
                f"need {n} pages, {self.available} available "
                f"({self.used}/{self.n_pages} used, {self._reserved} reserved)"
            )
        self._reserved += n

    def unreserve(self, n: int) -> None:
        if n < 0 or n > self._reserved:
            raise ValueError(
                f"cannot unreserve {n} of {self._reserved} reserved pages"
            )
        self._reserved -= n

    # ------------------------------------------------------- page churn
    def alloc(self, n: int, *, reserved: bool = False) -> list[int]:
        """Take `n` pages (refcount 1 each). `reserved=True` draws down an
        existing reservation; otherwise only unreserved free pages are
        eligible (harvest/scratch must never eat an admitted request's
        reservation)."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        if reserved:
            if n > self._reserved:
                raise ValueError(
                    f"alloc(reserved=True) of {n} exceeds reservation "
                    f"{self._reserved}"
                )
        elif n > self.available:
            raise PagePoolExhausted(
                f"need {n} pages, {self.available} available"
            )
        ids = [self._free.popleft() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        if reserved:
            self._reserved -= n
        self.alloc_total += n
        self.used_hwm = max(self.used_hwm, self.used)
        return ids

    def ref(self, pages) -> None:
        for i in pages:
            if i not in self._refs:
                raise ValueError(f"ref of unallocated page {i}")
            self._refs[i] += 1

    def unref(self, pages) -> None:
        for i in pages:
            c = self._refs.get(i)
            if c is None:
                raise ValueError(f"unref of unallocated page {i}")
            if c == 1:
                del self._refs[i]
                self._free.append(i)
            else:
                self._refs[i] = c - 1


@dataclasses.dataclass
class PrefixEntry:
    tokens: tuple  # verified content (collision ⇒ miss, never wrong KV)
    pages: tuple  # pool page ids holding the prefilled K/V, in order
    tick: int  # logical LRU recency (counter, not a clock)
    active: int = 0  # in-flight requests currently reading this entry
    namespace: str = ""  # the chain's seed (page_hashes)

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


class PrefixCache:
    """Content-addressed index: chain hash → prefilled pages.

    Each entry holds its OWN refcount on every page it names (chain
    entries share page objects — entry for pages [a, b] and entry for
    [a] both ref `a`), so evicting one link never invalidates a longer
    live one, and pages referenced by in-flight requests survive until
    those requests release them."""

    def __init__(
        self,
        pool: PagePool,
        *,
        max_pages: Optional[int] = None,
        hash_fn: Optional[HashFn] = None,
        on_evict: Optional[Callable[[str, PrefixEntry], None]] = None,
    ):
        self.pool = pool
        self.max_pages = max_pages
        self.hash_fn = hash_fn
        # Demotion hook: called with (chain_hash, entry) BEFORE the entry's
        # page refs drop, so a spill tier can claim the bytes while the
        # pages are still pinned. Must not re-enter the cache.
        self.on_evict = on_evict
        self._entries: dict[str, PrefixEntry] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.collisions = 0
        self.inserts = 0

    # ------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def page_refs(self) -> int:
        """Page references held across entries (shared pages count once
        per entry that names them)."""
        return sum(len(e.pages) for e in self._entries.values())

    @property
    def held_pages(self) -> int:
        """DISTINCT pool pages referenced by at least one entry — the
        pages a warm cache keeps on purpose. Drain accounting subtracts
        this (plus the scratch page) from pages_used to compute leaks."""
        return len({p for e in self._entries.values() for p in e.pages})

    def heads(self) -> list[str]:
        """Chain hashes of every indexed entry — the replica's /kvz
        advertisement. Every chain link is separately indexed, so this is
        the full set of prefixes a router-side directory can match on."""
        return list(self._entries.keys())

    def contains(self, tokens, namespace: str = "") -> bool:
        """True iff the FULL page-aligned content of `tokens` is indexed
        in `namespace` (len must be a multiple of page_tokens)."""
        hashes = page_hashes(tokens, self.pool.page_tokens, self.hash_fn, namespace)
        if not hashes:
            return False
        e = self._entries.get(hashes[-1])
        return e is not None and e.tokens == tuple(int(t) for t in tokens)

    # ------------------------------------------------------------ lookup
    def lookup(
        self, tokens, max_tokens: Optional[int] = None, namespace: str = ""
    ) -> tuple[int, tuple[int, ...], Optional[PrefixEntry]]:
        """Longest verified cached prefix of `tokens` in `namespace` (capped
        at `max_tokens`): (prefix_len, page_ids, entry).

        On a hit the entry's pages are REFERENCED for the caller and the
        entry marked active — release() when the request finishes. Walks
        every chain link (an evicted middle link must not hide a longer
        live entry) and verifies token content, so a forced hash
        collision reads as a miss."""
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        pt = self.pool.page_tokens
        best: Optional[PrefixEntry] = None
        for k, h in enumerate(page_hashes(tokens[:limit], pt, self.hash_fn, namespace), 1):
            e = self._entries.get(h)
            if e is None:
                continue
            if e.tokens != tuple(int(t) for t in tokens[: k * pt]):
                self.collisions += 1
                continue
            best = e
        if best is None:
            self.misses += 1
            return 0, (), None
        self._tick += 1
        best.tick = self._tick
        best.active += 1
        self.pool.ref(best.pages)
        self.hits += 1
        return best.n_tokens, best.pages, best

    def peek(
        self, tokens, max_tokens: Optional[int] = None, namespace: str = ""
    ) -> tuple[int, tuple[int, ...]]:
        """Longest verified cached prefix WITHOUT refs, active marks, or
        hit/miss counter churn: (prefix_len, page_ids). A read-only probe
        for the spill/restore path — the caller holds the KV manager lock,
        so the result cannot be evicted before it acts on it, and the
        subsequent real lookup() keeps the hit/miss ledger honest."""
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        pt = self.pool.page_tokens
        best: Optional[PrefixEntry] = None
        for k, h in enumerate(page_hashes(tokens[:limit], pt, self.hash_fn, namespace), 1):
            e = self._entries.get(h)
            if e is None or e.tokens != tuple(int(t) for t in tokens[: k * pt]):
                continue
            best = e
        if best is None:
            return 0, ()
        return best.n_tokens, best.pages

    def release(self, entry: PrefixEntry, pages) -> None:
        """Undo one lookup: drop the request's page refs and active mark."""
        entry.active = max(0, entry.active - 1)
        self.pool.unref(pages)

    # ------------------------------------------------------------ insert
    def insert(self, tokens, pages, namespace: str = "") -> bool:
        """Index `tokens` (page-aligned length) in `namespace` → `pages`.
        Takes its own refs on the pages (the caller keeps/drops its refs
        separately).
        Returns False without indexing when the hash slot is taken by
        DIFFERENT content (collision: first writer wins) or the content
        is already indexed."""
        toks = tuple(int(t) for t in tokens)
        pt = self.pool.page_tokens
        if not toks or len(toks) % pt:
            raise ValueError(
                f"prefix length {len(toks)} is not page-aligned (page_tokens={pt})"
            )
        if len(toks) // pt != len(pages):
            raise ValueError(
                f"{len(toks)} tokens need {len(toks) // pt} pages, got {len(pages)}"
            )
        h = page_hashes(toks, pt, self.hash_fn, namespace)[-1]
        cur = self._entries.get(h)
        if cur is not None:
            if cur.tokens != toks:
                self.collisions += 1
            return False
        self._tick += 1
        self.pool.ref(pages)
        self._entries[h] = PrefixEntry(toks, tuple(pages), self._tick, namespace=namespace)
        self.inserts += 1
        if self.max_pages is not None:
            self.evict_to(self.max_pages)
        return True

    # ---------------------------------------------------------- eviction
    def _evictable(self) -> list[tuple[str, PrefixEntry]]:
        return sorted(
            (
                (h, e)
                for h, e in self._entries.items()
                if e.active == 0
            ),
            key=lambda he: he[1].tick,
        )

    def _evict_one(self, h: str, e: PrefixEntry) -> None:
        del self._entries[h]
        if self.on_evict is not None:
            # Pages are still referenced here — the hook may copy/spill
            # their content before the unref below can recycle them.
            self.on_evict(h, e)
        self.pool.unref(e.pages)
        self.evictions += 1

    def evict_for(self, n_pages: int) -> bool:
        """Evict idle entries (LRU-first) until the pool can satisfy a
        reservation of `n_pages`. True when it now can."""
        for h, e in self._evictable():
            if self.pool.available >= n_pages:
                break
            self._evict_one(h, e)
        return self.pool.available >= n_pages

    def evict_to(self, max_pages: int) -> None:
        """Evict idle entries (LRU-first) until the index holds at most
        `max_pages` page references."""
        for h, e in self._evictable():
            if self.page_refs <= max_pages:
                break
            self._evict_one(h, e)

    def clear(self) -> None:
        for h, e in list(self._entries.items()):
            self._evict_one(h, e)
