"""Per-tenant admission + weighted fair ordering for the serving plane, an
own copy of `polyaxon_tpu/serving/tenancy.py` (the port imports nothing of
the JAX package).

The reference's fleet layer has this shape (per-scope concurrent caps,
weighted fair share when contended). This module is the same semantics one
level down, where the unit is an HTTP generate request instead of a run:

* `TenantSpec` — a named tenant's admission contract: cap on outstanding
  requests, cap on outstanding token budget (prompt + max_new of every
  queued/running request), fair-share `weight`, and the LoRA adapter its
  rows gather (empty = the checkpoint's own slot-0 adapter).
* `TenantAdmission` — purely logical counters behind a lock. `admit()`
  runs inside DecodeCoalescer.submit: over-cap tenants raise ShedError
  with `reason="tenant_quota"` so ONE tenant's flood sheds that tenant
  and nobody else (the queue never even sees the flood). Successful
  admits return a release callable the coalescer chains onto the
  request's idempotent finish — exactly-once release on every exit path
  (complete, deadline, disconnect, drain).
* `share(tenant)` — outstanding_tokens / weight, the key the coalescer
  and StepScheduler use to pick the next request among tenants: smallest
  share first (FIFO within a tenant), so a heavier-weighted tenant gets
  proportionally more decode rows of a contended server without
  starving anyone outright.

Unknown named tenants are a client error (HTTP 400 upstream), not a
shed: quota isolation is meaningless if anyone can mint a fresh tenant.
Requests with no tenant ride the implicit "default" tenant, which is
uncapped unless the operator configures it.

No wall clocks in here: admission state is counters only; queue-wait
timing lives in the serving layer.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from .batching import ShedError

__all__ = [
    "DEFAULT_TENANT",
    "TenantAdmission",
    "TenantSpec",
    "normalize_adapters",
    "normalize_tenants",
]

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's admission contract. `None` caps are uncapped; `adapter` of "" means the
    base (slot-0) adapter."""

    name: str
    max_outstanding: Optional[int] = None
    max_tokens: Optional[int] = None
    weight: float = 1.0
    adapter: str = ""

    def __post_init__(self):
        if not self.name or not str(self.name).strip():
            raise ValueError("tenant name must be non-empty")
        for field in ("max_outstanding", "max_tokens"):
            v = getattr(self, field)
            if v is not None and int(v) < 0:
                raise ValueError(f"tenant {field} must be >= 0, got {v}")
        if self.weight <= 0:
            raise ValueError(
                f"tenant weight must be > 0, got {self.weight}"
            )

    def to_pairs(self) -> tuple:
        """Hashable, sorted (key, value) pairs — the form ServingConfig
        stores so configs stay frozen/comparable."""
        out = [("name", self.name)]
        if self.max_outstanding is not None:
            out.append(("max_outstanding", int(self.max_outstanding)))
        if self.max_tokens is not None:
            out.append(("max_tokens", int(self.max_tokens)))
        if self.weight != 1.0:
            out.append(("weight", float(self.weight)))
        if self.adapter:
            out.append(("adapter", self.adapter))
        return tuple(sorted(out))

    @classmethod
    def from_pairs(cls, pairs) -> "TenantSpec":
        return cls(**dict(pairs))


def normalize_tenants(tenants) -> tuple:
    """Validate a collection of tenant specs (dicts, pair-tuples, or
    TenantSpec) into the sorted pair-tuple form ServingConfig carries.
    Rejects duplicates — two contracts for one tenant is a config bug."""
    specs = []
    for t in tenants or ():
        if isinstance(t, TenantSpec):
            specs.append(t)
        elif isinstance(t, dict):
            specs.append(TenantSpec(**t))
        else:
            specs.append(TenantSpec.from_pairs(t))
    names = [s.name for s in specs]
    if len(names) != len(set(names)):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate tenant spec(s): {dupes}")
    return tuple(s.to_pairs() for s in sorted(specs, key=lambda s: s.name))


def normalize_adapters(adapters) -> tuple:
    """Validate a name→source mapping (dict or pair iterable) into the
    sorted (name, source) tuple ServingConfig carries."""
    if hasattr(adapters, "items"):
        items = list(adapters.items())
    else:
        items = [tuple(p) for p in (adapters or ())]
    out = []
    for name, source in items:
        name, source = str(name).strip(), str(source).strip()
        if not name or not source:
            raise ValueError(
                f"adapter entries need a name and a source, got "
                f"{(name, source)!r}"
            )
        out.append((name, source))
    names = [n for n, _ in out]
    if len(names) != len(set(names)):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate adapter name(s): {dupes}")
    return tuple(sorted(out))


@dataclasses.dataclass
class _TenantState:
    spec: TenantSpec
    outstanding: int = 0
    tokens: int = 0
    admitted: int = 0
    shed: int = 0


class TenantAdmission:
    """Thread-safe per-tenant outstanding/token counters + fair-share
    ordering key. Clock-free."""

    def __init__(self, tenants=()):
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}
        for pairs in normalize_tenants(tenants):
            spec = TenantSpec.from_pairs(pairs)
            self._tenants[spec.name] = _TenantState(spec)
        # the implicit tenant every tenant-less request rides; uncapped
        # unless the operator configured it explicitly
        if DEFAULT_TENANT not in self._tenants:
            self._tenants[DEFAULT_TENANT] = _TenantState(
                TenantSpec(DEFAULT_TENANT)
            )

    # ---------------------------------------------------------- resolve
    def known(self) -> list:
        return sorted(self._tenants)

    def resolve(self, tenant: Optional[str]) -> TenantSpec:
        """Map a request's tenant field to its spec. Empty/missing →
        "default". Unknown names raise KeyError → HTTP 400 upstream."""
        name = (tenant or "").strip() or DEFAULT_TENANT
        state = self._tenants.get(name)
        if state is None:
            raise KeyError(name)
        return state.spec

    # ------------------------------------------------------------ admit
    def admit(self, tenant: str, tokens: int):
        """Charge one request (`tokens` = prompt_len + max_new budget)
        against its tenant, or raise ShedError(reason="tenant_quota").
        Returns an idempotent release callable."""
        name = (tenant or "").strip() or DEFAULT_TENANT
        with self._lock:
            state = self._tenants.get(name)
            if state is None:
                raise KeyError(name)
            spec = state.spec
            if (spec.max_outstanding is not None
                    and state.outstanding >= spec.max_outstanding):
                state.shed += 1
                raise ShedError(
                    f"tenant {name!r} at its outstanding-request cap "
                    f"({spec.max_outstanding})",
                    reason="tenant_quota",
                    retry_after_s=0.5,
                )
            if (spec.max_tokens is not None
                    and state.tokens + tokens > spec.max_tokens):
                state.shed += 1
                raise ShedError(
                    f"tenant {name!r} over its token budget "
                    f"({state.tokens}+{tokens} > {spec.max_tokens})",
                    reason="tenant_quota",
                    retry_after_s=0.5,
                )
            state.outstanding += 1
            state.tokens += tokens
            state.admitted += 1

        released = threading.Event()

        def release():
            if released.is_set():
                return
            released.set()
            with self._lock:
                st = self._tenants.get(name)
                if st is not None:
                    st.outstanding = max(0, st.outstanding - 1)
                    st.tokens = max(0, st.tokens - tokens)

        return release

    # ---------------------------------------------------------- ordering
    def share(self, tenant: str) -> float:
        """Fair-share key: outstanding tokens ÷ weight. Smallest admits
        next; unknown/default tenants key on the default spec."""
        name = (tenant or "").strip() or DEFAULT_TENANT
        with self._lock:
            state = self._tenants.get(name) or self._tenants[DEFAULT_TENANT]
            return state.tokens / state.spec.weight

    # ------------------------------------------------------------- views
    def snapshot(self) -> dict:
        """Per-tenant counters for /statsz."""
        with self._lock:
            return {
                name: {
                    "outstanding": st.outstanding,
                    "tokens": st.tokens,
                    "admitted": st.admitted,
                    "shed": st.shed,
                    "weight": st.spec.weight,
                    "max_outstanding": st.spec.max_outstanding,
                    "max_tokens": st.spec.max_tokens,
                    "adapter": st.spec.adapter,
                }
                for name, st in sorted(self._tenants.items())
            }
