"""Router-side prefix directory: which replica holds which KV prefix.

An own copy of `polyaxon_tpu/serving/affinity.py` over the port's
`models/kv_pages.py::page_hashes`. Each replica advertises the content-hash
chain heads of its resident prefixes — pool-resident PrefixCache entries
plus spilled (host-RAM / disk) entries — on `GET /kvz`. The router's
poll loop feeds those advertisements here, and the forward path asks
:meth:`PrefixDirectory.match` which routable replica holds the longest
verified prefix of an incoming prompt. Warm traffic then sticks to the
replica that already paid the prefill (or can restore it from spill)
instead of re-prefilling the same tokens on a random sibling.

The directory is a HINT, never a correctness surface: heads are hashes
of page-aligned token content (models/kv_pages.py `page_hashes`), and
the replica re-verifies token content on lookup — a stale or even
adversarial advertisement degrades to a normal cache miss at the
replica, costing one prefill, never wrong KV. Staleness is bounded by
the router's poll interval: entries evicted-and-not-spilled since the
last scrape still match here and miss there; entries prefilled since
the last scrape miss here and route by load. Both are benign.

Namespaces: a replica seeds an adapter row's chain with the adapter's
name (the port's prefix cache is namespaced by adapter), and only the
replica maps a tenant to its adapter. So a replica's advertisement also
carries its tenant → namespace map, and `match` hashes a tenant's prompt
in the namespace that replica gives the tenant. A request without a
tenant, or with one the replica binds to no adapter, hashes in the base
namespace: base-model rows match exactly as in the reference.

Clock-free by construction: the
directory has no time axis — freshness is whatever the poll loop last
wrote. Thread-safe: the poll thread writes, request threads read.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

# dependency-free module (no torch, no clocks) — safe in the router
from ..models.kv_pages import page_hashes
from .tenancy import DEFAULT_TENANT

__all__ = ["PrefixDirectory"]


class PrefixDirectory:
    """Map replica slug → advertised prefix chain heads.

    `max_prompt_pages` bounds the hash walk per request: a pathological
    multi-megatoken prompt costs at most that many page hashes, keeping
    the router's per-request affinity overhead O(pages), small and flat.
    """

    def __init__(self, *, max_prompt_pages: int = 64):
        self.max_prompt_pages = max(1, int(max_prompt_pages))
        # slug -> (page_tokens, frozenset of chain-head hex digests)
        self._by_slug: dict[str, tuple[int, frozenset]] = {}
        # slug -> {tenant: prefix namespace} (tenants bound to an adapter)
        self._namespaces: dict[str, dict[str, str]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ writes
    def update(
        self, slug: str, page_tokens: int, heads: Iterable[str],
        namespaces: Optional[dict] = None,
    ) -> None:
        """Replace `slug`'s advertisement (the poll loop calls this with
        each fresh `/kvz` answer; an empty/failed scrape clears it).
        `namespaces`: the replica's tenant → prefix namespace map."""
        pt = int(page_tokens or 0)
        hs = frozenset(str(h) for h in heads)
        ns = {str(t): str(n) for t, n in (namespaces or {}).items() if n}
        with self._lock:
            if pt <= 0 or not hs:
                self._by_slug.pop(slug, None)
                self._namespaces.pop(slug, None)
            else:
                self._by_slug[slug] = (pt, hs)
                self._namespaces[slug] = ns

    def forget(self, slug: str) -> None:
        with self._lock:
            self._by_slug.pop(slug, None)
            self._namespaces.pop(slug, None)

    # ------------------------------------------------------------- reads
    @property
    def empty(self) -> bool:
        with self._lock:
            return not self._by_slug

    def heads_count(self, slug: str) -> int:
        with self._lock:
            ent = self._by_slug.get(slug)
            return len(ent[1]) if ent else 0

    def match(self, tokens, tenant: str = "") -> dict[str, int]:
        """Longest advertised prefix per replica for this prompt of
        `tenant` (hashed in the namespace each replica gives the tenant;
        an empty tenant is the replicas' "default" one).

        Returns `{slug: matched_full_pages}` for every replica holding
        at least one full page of the prompt (matched pages > 0). The
        last prompt token is never part of a matched page — the replica
        always computes at least one token itself (mirrors the
        `lookup(..., max_tokens=len(tokens)-1)` cap in serving/kv.py),
        so the router and replica agree on what is reusable.
        """
        with self._lock:
            snapshot = dict(self._by_slug)
            namespaces = {slug: self._namespaces.get(slug, {}) for slug in snapshot}
        if not snapshot or len(tokens) < 2:
            return {}
        usable = len(tokens) - 1
        tenant = (tenant or "").strip() or DEFAULT_TENANT
        # one hash chain per distinct (page size, namespace)
        chains: dict[tuple, list] = {}
        out: dict[str, int] = {}
        for slug, (pt, heads) in snapshot.items():
            key = (pt, namespaces[slug].get(tenant, ""))
            if key not in chains:
                n = min(usable // pt, self.max_prompt_pages)
                chains[key] = (
                    page_hashes(tokens[: n * pt], pt, namespace=key[1])
                    if n > 0 else []
                )
            chain = chains[key]
            for j in range(len(chain), 0, -1):  # longest first
                if chain[j - 1] in heads:
                    out[slug] = j
                    break
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": len(self._by_slug),
                "heads": sum(len(hs) for _, hs in self._by_slug.values()),
            }
