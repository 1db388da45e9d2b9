"""Serving-side owner of the paged KV pool, counterpart of
`polyaxon_tpu/serving/kv.py::KVCacheManager` with its spill tier and its
KV handoff (export, adopt).

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
* **Spill tier** (`spill_ram_bytes` / `spill_dir`) — evicted prefix
  entries demote to host RAM and disk (`serving/spill.py`) instead of
  vanishing. Harvest takes a host MIRROR of each freshly written page
  (one gather per dtype, copied to pinned memory on the stream that wrote
  it), keyed by the chain hash at its position; `_demote` (the
  PrefixCache's `on_evict` hook) builds the payload from the mirror, and
  admission (`plan_row`) restores a spilled prefix longer than the cached
  one into fresh pages before its lookup. On a decode mesh the mirror
  gathers every rank's kv heads over `model` into whole pages and a
  restore writes each rank's heads (`serving/mesh.py`'s `pages_read` and
  `pages_write` commands), so the payloads, the spill segments and the
  handoff wire are a one-device server's, whatever the mesh. The device
  write of a restore waits in a queue until the decode worker's next
  dispatch (`flush_restores`); each queued item holds its own page refs. Payload
  leaves follow the reference's leaf order (layers by name, then
  cached_key, [its scale], cached_value, [its scale]), so a segment
  written by either package holds the same leaves in the same order.
* **KV handoff** (disaggregated pools) — on a prefill replica
  `export_prefix` captures a finished row's cached page-aligned prefix as
  a host SpillPayload (the wire unit of `serving/handoff.py`); on a decode
  replica `adopt_pages` allocates pool pages for it, queues their device
  write like a spill restore and indexes every chain link, so the
  replayed request's admission hits it. Both work in the row's prefix
  namespace: an adapter's pages land in that adapter's chain only.
  `advertised_heads` (the `/kvz` payload) lists the resident and spilled
  chain heads the router's affinity directory matches prompts against.

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

from ..models.generate import copy_pool_pages, make_paged_cache
from ..models.quant import kv_pool_bytes
from ..chaos.injector import inject
from ..models.kv_pages import (
    PagedKVLayout,
    PagePool,
    PagePoolExhausted,
    PrefixCache,
    PrefixEntry,
    page_hashes,
)
from .batching import ServingError, ShedError, choose_buckets
from .mesh import MeshCache
from ..telemetry import now as _now
from .spill import SpillManager, SpillPayload


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
    namespace: str = ""  # the prefix cache's chain the row reads and feeds

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
        spill_ram_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None,
        spill_dir_bytes: Optional[int] = None,
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
        # ---- tiered prefix spill: the host MIRROR holds each cached page's
        # bytes keyed by the chain hash at its position (hash h_j commits to
        # pages 0..j, so it names page j's content); `_mirror_refs[h]`
        # counts live entries whose chain covers position h — the bytes
        # drop when the last covering entry evicts
        spill_on = bool((spill_ram_bytes or spill_dir) and self.prefix is not None)
        self._spill: Optional[SpillManager] = (
            SpillManager(ram_bytes=spill_ram_bytes or 0, dir_path=spill_dir,
                         dir_bytes=spill_dir_bytes)
            if spill_on else None
        )
        if self._spill is not None:
            self.prefix.on_evict = self._demote
        self._mirror: dict[str, list] = {}  # hash -> per-leaf page bytes
        self._mirror_refs: dict[str, int] = {}
        self._pending_restores: list = []  # (page ids, per-leaf values, tag)
        self.spill_restores = 0
        self.restore_skipped = 0
        self.restore_aborted = 0
        self.spill_skipped = 0  # demotes with missing mirror bytes
        self.mirror_capture_failures = 0
        # ---- live KV handoff: pages held by adopt-queued writes not yet
        # flushed read as HELD (in transit), not leaked
        self._handoff_pending = 0
        self.handoff_exports = 0
        self.handoff_adopted_pages = 0
        self.handoff_adopt_aborted = 0
        # 0, not the post-heal value: startup quarantines surface on the
        # first observation
        self._quarantined_seen = 0
        # the pool's leaves in the reference's order: layers sorted by their
        # tree name ("layer_10" < "layer_2"), each as (k, [k scale], v,
        # [v scale])
        fields = (0, 2, 1, 3) if self.layout.kv_quant == "int8" else (0, 1)
        self.leaves = [
            (i, f) for i in sorted(range(module.cfg.n_layers), key=lambda i: f"layer_{i}")
            for f in fields
        ]

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
            handoff_held=self._handoff_pending,
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
        seq_len: int, namespace: str = "", trace=None,
    ) -> RowPlan:
        """Admit one row: prefix lookup + suffix bucketing + reservation.
        `namespace` names the prefix chain the row reads and, at harvest,
        feeds: rows whose K/V differ for the same tokens (another adapter)
        each get their own. `trace` (a RequestTrace) gets a `kv_plan`
        annotation.
        Raises ServingError (400) when the row can NEVER fit the pool and
        ShedError(reason="kv_pages") (503) when it cannot fit NOW."""
        pt = self.layout.page_tokens
        with self._lock:
            L, ppages, entry = 0, (), None
            if self.prefix is not None:
                if self._spill is not None:
                    # restore a spilled prefix BEFORE the lookup, so the
                    # lookup below hits it and the hit/miss ledger tells
                    # what the request actually got
                    self._maybe_restore(tokens, len(tokens) - 1, namespace)
                # cap at len-1: prefill needs >= 1 suffix token to produce
                # the first sampled logits
                L, ppages, entry = self.prefix.lookup(
                    tokens, max_tokens=len(tokens) - 1, namespace=namespace)
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
            if trace is not None:
                trace.annotate(
                    "kv_plan", prefix_len=L, prefix_hit=entry is not None,
                    suffix_bucket=pb, new_bucket=nb, pages=n_pages, reserved=demand,
                )
            return RowPlan(
                prefix_len=L,
                prefix_pages=tuple(ppages),
                prefix_entry=entry,
                suffix_bucket=pb,
                new_bucket=nb,
                n_pages=n_pages,
                reserved=demand,
                namespace=namespace,
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
    def ensure_pages(self, plans, upto_slot: int, traces=None) -> None:
        """Allocate each plan's own pages to cover slots [0, upto_slot) out
        of its reservation. Called by the decode worker before prefill and
        each chunk or step — cannot fail (reserved <= free invariant).
        `traces` (parallel to `plans`) gets a `kv_ensure` annotation per
        row that allocated."""
        with self._lock:
            for i, plan in enumerate(plans):
                if plan is None:
                    continue
                need_total = min(self.layout.pages_for(upto_slot), plan.n_pages)
                need = need_total - plan.prefix_pages_n - len(plan.own_pages)
                if need <= 0:
                    continue
                ids = self.pool.alloc(need, reserved=True)
                plan.reserved -= need
                plan.own_pages.extend(ids)
                if traces is not None and traces[i] is not None:
                    traces[i].annotate("kv_ensure", pages=need, upto_slot=upto_slot)
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
    def _copy_pages(self, table_row, start: int, count: int, new_ids) -> None:
        """Pool-to-pool copy of `count` slots of one row's window into the
        freshly allocated pages `new_ids` (`models.generate.
        copy_pool_pages`), on every rank of a decode mesh."""
        args = dict(table_row=np.asarray(table_row), start=int(start), count=int(count),
                    new_ids=np.asarray(new_ids), page_tokens=self.layout.page_tokens)
        if isinstance(self.cache, MeshCache):
            self.module.copy_pages(self.cache, **args)
        else:
            copy_pool_pages(self.cache, **args)

    def harvest(self, rows) -> int:
        """Index each completed row's page-aligned prompt prefix, in its
        plan's namespace. `rows` is [(tokens, plan, pad)] or [(tokens, plan,
        pad, trace)] — called by the decode worker AFTER the row's tokens
        are out (harvest must not delay TTFT). Returns the number of entries
        inserted."""
        if self.prefix is None:
            return 0
        pt = self.layout.page_tokens
        inserted = 0
        for row in rows:
            tokens, plan, pad = row[:3]
            trace = row[3] if len(row) > 3 else None
            if plan is None or plan.released:
                continue
            k = len(tokens) // pt  # full prompt pages
            Lp = plan.prefix_pages_n
            if k <= Lp:
                continue
            with self._lock:
                if self.prefix.contains(tokens[: k * pt], plan.namespace):
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
            # the harvested pages' host mirror NOW, on the worker, from the
            # freshly written pool: a later eviction needs the bytes after
            # the pages may have been reused
            mirror_pages = None
            if self._spill is not None:
                try:
                    mirror_pages = self._capture_mirror(new_ids)
                except Exception:  # noqa: BLE001 — spill is best-effort
                    self.mirror_capture_failures += 1
            with self._lock:
                hashes = (
                    page_hashes(tokens[: k * pt], pt, self.prefix.hash_fn, plan.namespace)
                    if self._spill is not None else ()
                )
                if mirror_pages is not None:
                    for idx in range(n_new):
                        self._mirror.setdefault(hashes[Lp + idx], mirror_pages[idx])
                # index every chain link so partial-overlap prompts hit too
                for j in range(Lp + 1, k + 1):
                    pages_j = tuple(plan.prefix_pages) + tuple(new_ids[: j - Lp])
                    if self.prefix.insert(tokens[: j * pt], pages_j, plan.namespace):
                        inserted += 1
                        self._mirror_ref(hashes[:j])
                self._mirror_gc(hashes)
                # drop the allocation refs — the entries hold their own
                self.pool.unref(new_ids)
                self._pages_changed()
            if trace is not None:
                trace.annotate("kv_harvest_row", pages=n_new)
        return inserted

    # --------------------------------------------------------- tiered spill
    def _mirror_ref(self, hashes) -> None:
        for h in hashes:
            self._mirror_refs[h] = self._mirror_refs.get(h, 0) + 1

    def _mirror_unref(self, hashes) -> None:
        for h in hashes:
            c = self._mirror_refs.get(h)
            if c is None:
                continue
            if c <= 1:
                del self._mirror_refs[h]
                self._mirror.pop(h, None)
            else:
                self._mirror_refs[h] = c - 1

    def _mirror_gc(self, hashes) -> None:
        """Drop mirror bytes of positions no entry ended up covering (an
        insert lost a collision race)."""
        for h in hashes:
            if h not in self._mirror_refs:
                self._mirror.pop(h, None)

    @torch.inference_mode()
    def _capture_mirror(self, new_ids) -> list:
        """Host copies of freshly written pool pages, per page per leaf (in
        `self.leaves` order). The pages of every leaf of one dtype are
        gathered into one device buffer and copied to pinned host memory on
        the current stream, so the copy follows the write that produced
        them; the call returns when the bytes are on the host. On a decode
        mesh the pages come whole: every rank's kv heads gathered over
        `model` (`serving.mesh.read_pages`, one command), so a page's bytes
        are the ones one device's pool holds in the same layout."""
        dev = self.cache[0][0].device
        if isinstance(self.cache, MeshCache):
            whole = self.module.read_pages(self.cache, new_ids)
            picked = [whole[i][f] for i, f in self.leaves]
        else:
            ids = torch.as_tensor(np.asarray(new_ids), dtype=torch.long, device=dev)
            picked = [self.cache[i][f].index_select(0, ids) for i, f in self.leaves]
        by_dtype: dict = {}
        for j, leaf in enumerate(picked):
            by_dtype.setdefault(leaf.dtype, []).append(j)
        host: list = [None] * len(picked)
        for idx in by_dtype.values():
            stacked = torch.stack([picked[j] for j in idx])
            if stacked.is_cuda:
                buf = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
                buf.copy_(stacked)  # blocking: ordered after the harvest's write
            else:
                buf = stacked.clone()
            for n, j in enumerate(idx):
                host[j] = buf[n]
        return [[h[p] for h in host] for p in range(len(new_ids))]

    def _observe_quarantine(self) -> None:
        q = self._spill.quarantined
        if q > self._quarantined_seen:
            self._observe("kv_spill_quarantined", n=q - self._quarantined_seen)
            self._quarantined_seen = q

    def _demote(self, h: str, e: PrefixEntry) -> None:
        """PrefixCache eviction hook: move the entry's bytes to the spill
        tier instead of losing them. Runs under self._lock (every evict path
        is inside a locked region) with the pages still referenced."""
        hashes = page_hashes(e.tokens, self.layout.page_tokens, self.prefix.hash_fn,
                             e.namespace)
        try:
            pages = []
            for hj in hashes:
                b = self._mirror.get(hj)
                if b is None:
                    # no mirror bytes for a position: the entry evicts the
                    # pre-spill way
                    self.spill_skipped += 1
                    pages = None
                    break
                pages.append(b)
            if pages is not None:
                payload = SpillPayload(tuple(e.tokens), tuple(hashes), pages)
                if self._spill.put(payload):
                    self._observe("kv_spill", bytes=payload.nbytes)
                self._observe_quarantine()
        finally:
            self._mirror_unref(hashes)

    def _maybe_restore(self, tokens, limit: int, namespace: str = "") -> None:
        """Admission-time restore: if the spill tier holds a LONGER verified
        prefix of `tokens` than the in-pool cache, pull its pages back into
        fresh pool pages and re-index every chain link, so the lookup that
        follows hits it. Caller holds self._lock."""
        pt = self.layout.page_tokens
        hashes = page_hashes(tokens[:limit], pt, self.prefix.hash_fn, namespace)
        if not hashes:
            return
        _k_len, k_pages = self.prefix.peek(tokens, max_tokens=limit, namespace=namespace)
        k = len(k_pages)
        j = 0
        for cand in range(len(hashes), k, -1):
            if self._spill.has(hashes[cand - 1], tokens[: cand * pt]):
                j = cand
                break
        if j == 0:
            return
        n_new = j - k
        # the harvest's headroom rule: cache warmth never eats the admission
        # headroom a reservation is about to need
        if self.pool.available < n_new:
            self.restore_skipped += 1
            return
        payload = self._spill.take(hashes[j - 1], tokens[: j * pt])
        self._observe_quarantine()
        if payload is None:
            return  # a corrupt or incomplete segment: quarantined, a clean miss
        try:
            new_ids = self.pool.alloc(n_new)
        except PagePoolExhausted:
            self.restore_skipped += 1
            return
        queued = None
        try:
            # chaos: a kill here is a death mid-restore — the except arm
            # returns every page this restore holds
            inject("kv.restore", h=hashes[j - 1], pages=n_new)
            queued = self._queue_restore(new_ids, payload.pages[k:])
            for pos in range(1, j + 1):
                self._mirror.setdefault(hashes[pos - 1], payload.pages[pos - 1])
            inserted = 0
            for jj in range(k + 1, j + 1):
                pages_jj = tuple(k_pages) + tuple(new_ids[: jj - k])
                if self.prefix.insert(tokens[: jj * pt], pages_jj, namespace):
                    inserted += 1
                    self._mirror_ref(hashes[:jj])
            self._mirror_gc(hashes)
            if inserted == 0:
                # lost the admission race (the hash slot holds other
                # content): cancel the queued write, free its pages
                self._unqueue_restore(queued)
                queued = None
                self.restore_aborted += 1
            else:
                self.spill_restores += 1
                self._observe("kv_spill_restore", pages=n_new)
            self.pool.unref(new_ids)
            self._pages_changed()
        except BaseException:
            if queued is not None:
                self._unqueue_restore(queued)
            self.pool.unref(new_ids)
            raise

    def _queue_restore(self, new_ids, pages_payload, tag: str = "spill") -> tuple:
        """Queue the device write of restored pages: per leaf, the pages'
        host values stacked. The item holds its OWN pool refs, so an
        eviction racing the flush is harmless — the write lands in
        still-held pages, which free right after. `tag="handoff"` items
        also count into the in-transit gauge until flushed."""
        vals = [
            torch.stack([page[leaf] for page in pages_payload])
            for leaf in range(len(pages_payload[0]))
        ]
        self.pool.ref(new_ids)
        item = (list(new_ids), vals, tag)
        self._pending_restores.append(item)
        if tag == "handoff":
            self._handoff_pending += len(new_ids)
        return item

    def _unqueue_restore(self, item) -> bool:
        """Cancel one queued restore (the abort path): drop it from the
        queue and return its refs. Caller holds self._lock."""
        try:
            self._pending_restores.remove(item)
        except ValueError:
            return False
        self.pool.unref(item[0])
        if item[2] == "handoff":
            self._handoff_pending -= len(item[0])
        return True

    @torch.inference_mode()
    def flush_restores(self) -> int:
        """Write queued restores into the device pool. The decode worker
        calls this under the server lock before each dispatch, so a restored
        row's first read sees its bytes. Returns the batches applied."""
        with self._lock:
            if not self._pending_restores:
                return 0
            pending, self._pending_restores = self._pending_restores, []
        dev = self.cache[0][0].device
        for ids, vals, tag in pending:
            t0 = _now()
            if isinstance(self.cache, MeshCache):  # each rank its kv heads
                self.module.write_pages(self.cache, ids, dict(zip(self.leaves, vals)))
            else:
                dst = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
                for (i, f), v in zip(self.leaves, vals):
                    self.cache[i][f][dst] = v.to(dev)
            with self._lock:
                self.pool.unref(ids)
                if tag == "handoff":
                    self._handoff_pending -= len(ids)
                self._pages_changed()
            if tag == "handoff":
                # the host time of the adopted pages' device write (its
                # copies are queued on the stream that runs the steps)
                self._observe("kv_handoff_write", ms=(_now() - t0) * 1e3, pages=len(ids))
        return len(pending)

    # ------------------------------------------------------ live handoff
    def export_prefix(self, tokens, namespace: str = "") -> Optional[SpillPayload]:
        """Capture the longest cached page-aligned prefix of `tokens` in
        `namespace`'s chain as a host SpillPayload — the wire unit of the
        live KV handoff. Decode worker only, right after the producing
        step (the rule of `_capture_mirror`: the copy is queued on the
        step's stream, after the write). The chain pages are ref-held
        across the read so a racing eviction cannot recycle them. Returns
        None when nothing page-aligned is cached (prompt shorter than a
        page, prefix cache off): the caller decodes locally."""
        if self.prefix is None:
            return None
        pt = self.layout.page_tokens
        k = len(tokens) // pt
        if k < 1:
            return None
        with self._lock:
            _plen, page_ids = self.prefix.peek(tokens, max_tokens=k * pt, namespace=namespace)
            j = len(page_ids)
            if j < 1:
                return None
            page_ids = list(page_ids)
            self.pool.ref(page_ids)
        try:
            pages = self._capture_mirror(page_ids)
        finally:
            with self._lock:
                self.pool.unref(page_ids)
                self._pages_changed()
        hashes = page_hashes(tokens[: j * pt], pt, self.prefix.hash_fn, namespace)
        with self._lock:
            self.handoff_exports += 1
        return SpillPayload(
            tuple(int(t) for t in tokens[: j * pt]), tuple(hashes), pages,
            namespace=namespace,
        )

    def adopt_pages(self, payload: SpillPayload) -> int:
        """Adopt an imported handoff page set into `payload.namespace`'s
        chain: allocate pool pages, queue the device write (flushed by the
        worker before the next prefill, like a spill restore) and index
        every chain link, so the replayed request's admission hits it.
        Content verification (CRC frames, the hash chain against the
        tokens) is the HTTP layer's; this method owns the refcounts.

        Returns the number of newly adopted pages (0 when the chain is
        already resident: a repeated import is idempotent). Raises
        ShedError(reason="kv_handoff") when there is no headroom even after
        LRU eviction. Every abort path — a chaos raise, a collision race, a
        headroom shed — returns every page this adoption holds."""
        if self.prefix is None:
            raise ServingError("kv handoff requires the prefix cache")
        pt = self.layout.page_tokens
        ns = payload.namespace
        tokens = tuple(int(t) for t in payload.tokens)
        j = len(payload.pages)
        with self._lock:
            _plen, k_pages = self.prefix.peek(tokens, max_tokens=len(tokens), namespace=ns)
            k = len(k_pages)
            n_new = j - k
            if n_new <= 0:
                return 0
            if self.pool.available < n_new:
                if not self.prefix.evict_for(n_new):
                    self._observe("shed", reason="kv_handoff")
                    raise ShedError(
                        f"KV pool cannot adopt {n_new} handoff pages "
                        f"({self.pool.available} free)",
                        reason="kv_handoff",
                    )
                self._observe("prefix_evict")
            try:
                new_ids = self.pool.alloc(n_new)
            except PagePoolExhausted as e:
                self._observe("shed", reason="kv_handoff")
                raise ShedError(
                    f"KV pool cannot adopt handoff pages: {e}", reason="kv_handoff"
                ) from None
            queued = None
            try:
                # chaos: a kill here is a death mid-adopt — the except arm
                # returns every page this adoption holds
                inject("serving.kv_adopt", h=payload.hashes[-1], pages=n_new)
                queued = self._queue_restore(new_ids, payload.pages[k:], tag="handoff")
                if self._spill is not None:
                    for pos in range(1, j + 1):
                        self._mirror.setdefault(payload.hashes[pos - 1], payload.pages[pos - 1])
                inserted = 0
                for jj in range(k + 1, j + 1):
                    pages_jj = tuple(k_pages) + tuple(new_ids[: jj - k])
                    if self.prefix.insert(tokens[: jj * pt], pages_jj, ns):
                        inserted += 1
                        if self._spill is not None:
                            self._mirror_ref(payload.hashes[:jj])
                if self._spill is not None:
                    self._mirror_gc(payload.hashes)
                if inserted == 0:
                    # collision race: other content owns the chain slots —
                    # cancel the queued write, free the pages
                    self._unqueue_restore(queued)
                    queued = None
                    self.handoff_adopt_aborted += 1
                    n_new = 0
                else:
                    self.handoff_adopted_pages += n_new
                    self._observe("kv_handoff_adopt", pages=n_new)
                self.pool.unref(new_ids)
                self._pages_changed()
                return n_new
            except BaseException:
                if queued is not None:
                    self._unqueue_restore(queued)
                self.pool.unref(new_ids)
                self._pages_changed()
                raise

    def advertised_heads(self) -> list:
        """Chain hashes restorable on this replica — resident PrefixCache
        entries plus spilled entries in either tier. The /kvz payload."""
        with self._lock:
            heads = self.prefix.heads() if self.prefix is not None else []
            if self._spill is not None:
                heads.extend(self._spill.heads())
            return list(dict.fromkeys(heads))

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

    def rank_pool_bytes(self) -> int:
        """Device bytes of the pool on each rank: the whole pool on one
        device, this rank's kv heads' share on a decode mesh."""
        cfg = self.module.cfg
        return kv_pool_bytes(
            self.layout, cfg.n_layers, self.module.local_kv_heads, cfg.head_dim,
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
            if (self.handoff_exports or self.handoff_adopted_pages
                    or self.handoff_adopt_aborted or self._handoff_pending):
                out["handoff"] = {
                    "exports": self.handoff_exports,
                    "adopted_pages": self.handoff_adopted_pages,
                    "adopt_aborted": self.handoff_adopt_aborted,
                    "pending_pages": self._handoff_pending,
                }
            if self._spill is not None:
                out["spill"] = {
                    **self._spill.stats(),
                    "restores": self.spill_restores,
                    "restore_skipped": self.restore_skipped,
                    "restore_aborted": self.restore_aborted,
                    "spill_skipped": self.spill_skipped,
                    "mirror_entries": len(self._mirror),
                    "mirror_capture_failures": self.mirror_capture_failures,
                    "pending_restores": len(self._pending_restores),
                }
            return out
