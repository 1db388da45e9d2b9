"""Serving-side owner of the paged KV pool, counterpart of
`polyaxon_tpu/serving/kv.py::KVCacheManager` without its spill tier
(mirror, demote, restore) and its KV handoff (export, adopt).

`KVCacheManager` glues the host accounting (`models/kv_pages.py`: PagePool
refcounts and reservations, the content-addressed PrefixCache) to the
device pool (`models.generate.make_paged_cache`) and the coalescer:

* **Admission** — `plan_row()` runs on the HTTP producer threads: look up
  the longest cached prefix, bucket the remaining suffix, and RESERVE the
  row's worst-case page demand. A reservation that cannot be satisfied
  first tries LRU eviction of idle prefix entries, then sheds with
  `ShedError(reason="kv_pages")` → HTTP 503. The pool never runs out
  mid-decode, because reserved pages are always convertible (PagePool
  invariant: reserved <= free).
* **Lazy allocation** — `ensure_pages()` converts reservations into pages
  only as decode actually advances (the decode worker calls it before
  prefill and before each chunk or step), so a request that finishes early
  on eos never touches its tail pages.
* **Prefix harvest** — after a row completes, `harvest()` copies its
  page-aligned prompt prefix into freshly allocated pool pages (a
  pool-to-pool copy, in place) and indexes every chain link in the
  PrefixCache, so the next request sharing that prefix skips that part of
  its prefill (its rows alias the pages read-only: copy-on-write is free
  because decode only writes slots >= prefix_len).

Page table layout per row (width = pages_for(L + pb + nb - 1)):
`[shared prefix pages | own pages, allocated lazily | scratch]` — the
scratch page backs not-yet-allocated tail entries and every slot of
batch-padding dummy rows; its contents are masked dead in attention (or
belong to dummy rows whose output is dropped).

Threading: producer threads plan and release, the single decode worker
allocates and harvests; every pool, index and table mutation happens under
one lock. No wall clocks here (PrefixCache recency is a logical tick).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..models.generate import make_paged_cache
from ..models.quant import kv_pool_bytes
from ..models.kv_pages import (
    PagedKVLayout,
    PagePool,
    PagePoolExhausted,
    PrefixCache,
    PrefixEntry,
)
from .batching import ServingError, ShedError, choose_buckets


@dataclasses.dataclass
class RowPlan:
    """One admitted row's paging state, attached to its PendingRequest.
    Created (and reserved) at admission, mutated by the decode worker as
    pages materialize, released exactly once when the request finishes."""

    prefix_len: int  # L: tokens served from the prefix cache (page-aligned)
    prefix_pages: tuple  # shared page ids (read-only for this row)
    prefix_entry: Optional[PrefixEntry]
    suffix_bucket: int  # pb: the row's own tokens, left-padded to this
    new_bucket: int  # nb
    n_pages: int  # table width = pages_for(L + pb + nb - 1)
    reserved: int  # pages still reserved, not yet allocated
    own_pages: list = dataclasses.field(default_factory=list)
    released: bool = False

    @property
    def prefix_pages_n(self) -> int:
        return len(self.prefix_pages)


class KVCacheManager:
    """Owns the device page pool and every decision about who may write
    which page. See the module docstring for the protocol."""

    def __init__(
        self,
        module,
        *,
        pool_pages: int,
        page_tokens: int = 128,
        prefix_cache: bool = True,
        kv_quant: str = "none",
        hash_fn=None,
        observer: Optional[Callable[..., None]] = None,
    ):
        if pool_pages < 2:
            raise ValueError(
                f"kv_pool_pages must be >= 2 (1 scratch + data), got {pool_pages}"
            )
        # kv_quant="int8": int8 payloads plus one f32 scale per (slot, kv
        # head) — about half the bytes of a bf16 pool at head_dim 64
        self.layout = PagedKVLayout(
            page_tokens=page_tokens, pool_pages=pool_pages, kv_quant=kv_quant
        )
        self.module = module
        self.pool = PagePool(pool_pages, page_tokens)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.pool, hash_fn=hash_fn) if prefix_cache else None
        )
        self._observer = observer
        self._lock = threading.RLock()
        # the device pool: per layer (k, v) [pool_pages, page_tokens, nkv,
        # hd] (and their [pool_pages, page_tokens, nkv] scales on an int8
        # pool), updated in place by the prefill, decode and harvest writes
        self.cache = make_paged_cache(module, self.layout)
        # the scratch page: backs unallocated table entries and dummy rows
        self.scratch = self.pool.alloc(1)[0]
        # concurrency accounting: how many rows hold reservations at once —
        # the occupancy win over dense worst-case reservation
        self.active_rows = 0
        self.active_rows_hwm = 0
        self.harvest_skipped = 0

    # ------------------------------------------------------------- helpers
    def _observe(self, event: str, **ctx) -> None:
        if self._observer is None:
            return
        try:
            self._observer(event, **ctx)
        except Exception:  # noqa: BLE001 — telemetry must not break serving
            pass

    def _pages_changed(self) -> None:
        self._observe(
            "kv_pages",
            used=self.pool.used,
            total=self.pool.n_pages,
            prefix_held=self.prefix.held_pages if self.prefix is not None else 0,
        )

    @property
    def dense_equivalent_rows(self) -> int:
        """How many concurrent rows the SAME memory budget supports under
        dense worst-case reservation (seq_len slots per row) — the
        baseline the paged admission beats."""
        slots = self.layout.pool_pages * self.layout.page_tokens
        return max(1, slots // int(self.module.cfg.seq_len))

    # ----------------------------------------------------------- admission
    def plan_row(
        self, tokens, max_new: int, prompt_ladder: tuple, new_ladder: tuple,
        seq_len: int,
    ) -> RowPlan:
        """Admit one row: prefix lookup + suffix bucketing + reservation.
        Raises ServingError (400) when the row can NEVER fit the pool and
        ShedError(reason="kv_pages") (503) when it cannot fit NOW."""
        pt = self.layout.page_tokens
        with self._lock:
            L, ppages, entry = 0, (), None
            if self.prefix is not None:
                # cap at len-1: prefill needs >= 1 suffix token to produce
                # the first sampled logits
                L, ppages, entry = self.prefix.lookup(tokens, max_tokens=len(tokens) - 1)
                self._observe(
                    "prefix_hit" if entry is not None else "prefix_miss", tokens=L
                )
            try:
                sfx = len(tokens) - L
                pb, nb = choose_buckets(
                    sfx, max_new, prompt_ladder, new_ladder, seq_len - L
                )
                n_pages = self.layout.pages_for(L + pb + nb - 1)
                demand = n_pages - L // pt
                # scratch is permanently allocated → usable = pool - 1
                if demand + L // pt + 1 > self.pool.n_pages:
                    raise ServingError(
                        f"request needs {demand + L // pt} KV pages but the "
                        f"pool holds {self.pool.n_pages - 1} usable pages — "
                        f"raise kvPoolPages or shorten the request"
                    )
                try:
                    self.pool.reserve(demand)
                except PagePoolExhausted:
                    # make room: LRU-evict idle prefix entries, retry once
                    if self.prefix is None or not self.prefix.evict_for(demand):
                        raise
                    self._observe("prefix_evict")
                    self.pool.reserve(demand)
            except PagePoolExhausted as e:
                if entry is not None:
                    self.prefix.release(entry, ppages)
                self._observe("shed", reason="kv_pages")
                raise ShedError(
                    f"KV page pool exhausted: {e}", reason="kv_pages"
                ) from None
            except ServingError:
                if entry is not None:
                    self.prefix.release(entry, ppages)
                raise
            self.active_rows += 1
            self.active_rows_hwm = max(self.active_rows_hwm, self.active_rows)
            self._pages_changed()
            return RowPlan(
                prefix_len=L,
                prefix_pages=tuple(ppages),
                prefix_entry=entry,
                suffix_bucket=pb,
                new_bucket=nb,
                n_pages=n_pages,
                reserved=demand,
            )

    def release(self, plan: RowPlan) -> None:
        """Return everything a row holds: allocated pages, the unused
        remainder of its reservation, and its prefix references.
        Idempotent — wired to PendingRequest.on_finish, which fires on
        every terminal path (success, shed, deadline, crash, drain)."""
        with self._lock:
            if plan.released:
                return
            plan.released = True
            if plan.own_pages:
                self.pool.unref(plan.own_pages)
            if plan.reserved:
                self.pool.unreserve(plan.reserved)
            if plan.prefix_entry is not None:
                self.prefix.release(plan.prefix_entry, plan.prefix_pages)
            self.active_rows -= 1
            self._pages_changed()

    # ------------------------------------------------------ decode support
    def ensure_pages(self, plans, upto_slot: int) -> None:
        """Allocate each plan's own pages to cover slots [0, upto_slot) out
        of its reservation. Called by the decode worker before prefill and
        each chunk or step — cannot fail (reserved <= free invariant)."""
        with self._lock:
            for plan in plans:
                if plan is None:
                    continue
                need_total = min(self.layout.pages_for(upto_slot), plan.n_pages)
                need = need_total - plan.prefix_pages_n - len(plan.own_pages)
                if need <= 0:
                    continue
                ids = self.pool.alloc(need, reserved=True)
                plan.reserved -= need
                plan.own_pages.extend(ids)
            self._pages_changed()

    def tables(self, plans, batch: int, n_pages: int) -> np.ndarray:
        """[batch, n_pages] page tables: prefix + own pages per real row,
        scratch everywhere else (unallocated tails, dummy rows).

        The scratch tail is load-bearing for chunked prefill: the step
        engine asks for tables WIDER than a row's allocated pages (the next
        power of two over its final page count). Slots past the row's
        frontier are masked by the pad and position math of the decode, so
        writes land in the scratch page and reads never reach it."""
        t = np.full((batch, n_pages), self.scratch, np.int64)
        with self._lock:
            for i, plan in enumerate(plans):
                if plan is None:
                    continue
                ids = list(plan.prefix_pages) + plan.own_pages
                t[i, : len(ids)] = ids
        return t

    # -------------------------------------------------------------- harvest
    @torch.inference_mode()
    def _copy_pages(self, table_row, start: int, count: int, new_ids) -> None:
        """Pool-to-pool copy: gather `count` slots of one row's window
        (from slot `start`) and scatter them, page-aligned, into the freshly
        allocated pages `new_ids`, in every layer, in place."""
        dev = self.cache[0][0].device
        pt = self.layout.page_tokens
        slots = start + torch.arange(count, device=dev)
        table_row = torch.as_tensor(np.asarray(table_row), dtype=torch.long, device=dev)
        src_pages, src_off = table_row[slots // pt], slots % pt
        dst = torch.as_tensor(np.asarray(new_ids), dtype=torch.long, device=dev)
        for layer in self.cache:
            for pool in layer:  # k, v (and their scales on an int8 pool)
                vals = pool[src_pages, src_off]  # a copy: sources stay intact
                pool[dst] = vals.reshape(len(new_ids), pt, *pool.shape[2:])

    def harvest(self, rows) -> int:
        """Index each completed row's page-aligned prompt prefix. `rows` is
        [(tokens, plan, pad)] — called by the decode worker AFTER the row's
        tokens are out (harvest must not delay TTFT). Returns the number of
        entries inserted."""
        if self.prefix is None:
            return 0
        pt = self.layout.page_tokens
        inserted = 0
        for tokens, plan, pad in rows:
            if plan is None or plan.released:
                continue
            k = len(tokens) // pt  # full prompt pages
            Lp = plan.prefix_pages_n
            if k <= Lp:
                continue
            with self._lock:
                if self.prefix.contains(tokens[: k * pt]):
                    continue
                n_new = k - Lp
                if self.pool.available < n_new:
                    # evict idle LRU entries rather than drop the newest
                    # prompt: the freed pages net out against the new
                    # entry's, so admission headroom is untouched
                    if not self.prefix.evict_for(n_new):
                        self.harvest_skipped += 1
                        continue
                new_ids = self.pool.alloc(n_new)
                table = list(plan.prefix_pages) + plan.own_pages
            self._copy_pages(table, plan.prefix_len + int(pad), n_new * pt, new_ids)
            with self._lock:
                # index every chain link so partial-overlap prompts hit too
                for j in range(Lp + 1, k + 1):
                    pages_j = tuple(plan.prefix_pages) + tuple(new_ids[: j - Lp])
                    if self.prefix.insert(tokens[: j * pt], pages_j):
                        inserted += 1
                # drop the allocation refs — the entries hold their own
                self.pool.unref(new_ids)
                self._pages_changed()
        return inserted

    # ---------------------------------------------------------------- stats
    def kv_pool_bytes(self) -> int:
        """Device bytes of the pool (payloads and scales), by the formula
        admission budgets with (`models.quant.kv_pool_bytes`); it equals
        the live tensors' bytes by construction."""
        cfg = self.module.cfg
        return kv_pool_bytes(
            self.layout, cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
            self.cache[0][0].element_size(),
        )

    def stats(self) -> dict:
        with self._lock:
            out = {
                "page_tokens": self.layout.page_tokens,
                "kv_quant": self.layout.kv_quant,
                "kv_pool_bytes": self.kv_pool_bytes(),
                "pages_total": self.pool.n_pages,
                "pages_used": self.pool.used,
                "pages_reserved": self.pool.reserved,
                "pages_hwm": self.pool.used_hwm,
                "active_rows": self.active_rows,
                "active_rows_hwm": self.active_rows_hwm,
                "dense_equivalent_rows": self.dense_equivalent_rows,
                "harvest_skipped": self.harvest_skipped,
            }
            if self.prefix is not None:
                out["prefix"] = {
                    "entries": len(self.prefix),
                    "page_refs": self.prefix.page_refs,
                    "held_pages": self.prefix.held_pages,
                    "hits": self.prefix.hits,
                    "misses": self.prefix.misses,
                    "evictions": self.prefix.evictions,
                    "collisions": self.prefix.collisions,
                }
            return out
