"""Per-request serving traces, an own copy of
`polyaxon_tpu/telemetry/tracing.py` (stdlib only): explicit-parent span records and a
bounded tail-sampling ring.

The trainer's ``SpanTracer`` (spans.py) nests by per-thread stacks —
right for a step loop that lives on one thread, useless for a serving
request that hops HTTP handler → admission → coalescer queue → decode
worker → stream writer. This module is the serving-side trace builder:

* ``RequestTrace`` carries explicit span records (name, start offset,
  duration, attrs) with no thread-local state, so any thread holding
  the trace object can append. Spans that belong to a coalesced decode
  group carry the shared ``group`` span id, which is how the B member
  rows of one batch share one decode-group span across B traces.
* ``TraceRing`` is the tail sampler deciding which finished traces are
  worth keeping: errors/sheds/deadline-exceeded always, plus the
  slowest tail, plus a recent window — bounded memory no matter the
  request rate.

All times come from the telemetry clock (``registry.now``); records
carry monotonic offsets relative to the trace start, never wall-clock.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import uuid
from collections import deque
from typing import Callable, Optional

from .registry import now

#: statuses the tail sampler always retains (never evicted by ok traffic
#: while capacity lasts) — anything that is not a clean completion.
OK_STATUS = "ok"


def new_trace_id() -> str:
    """Server-assigned request id (client may supply its own instead)."""
    return uuid.uuid4().hex[:16]


class RequestTrace:
    """One request's span tree, built explicitly across threads.

    Spans are flat records with ``start_s`` offsets relative to the
    trace start and a ``dur_s`` duration; the tree structure the
    `/tracez` detail view renders is implied by the span names
    (admission/queue_wait/prefill/decode/verify/kv_harvest/stream_flush
    are all children of the root request). ``add`` measures nothing —
    the caller passes the absolute start (from the telemetry clock) and
    the duration it measured; ``annotate`` stamps a zero-duration event
    at "now" for clock-free layers (the KV manager) that may attach
    context but must not read a clock themselves.
    """

    def __init__(
        self,
        trace_id: str,
        *,
        clock: Callable[[], float] = now,
        **attrs,
    ):
        self.trace_id = trace_id
        self.attrs = dict(attrs)
        self._clock = clock
        self.t0 = clock()
        self._lock = threading.Lock()
        self._spans: list[dict] = []
        self._groups: list[int] = []
        self.status: Optional[str] = None
        self.error: Optional[str] = None
        self.dur_s: Optional[float] = None

    # ------------------------------------------------------------ build
    def add(
        self,
        name: str,
        *,
        start: Optional[float] = None,
        dur_s: float = 0.0,
        **attrs,
    ) -> dict:
        """Append a span. ``start`` is an absolute telemetry-clock time
        (defaults to now); stored as an offset from the trace start."""
        t = self._clock() if start is None else start
        rec = {
            "name": name,
            "start_s": max(0.0, t - self.t0),
            "dur_s": max(0.0, float(dur_s)),
            "attrs": attrs,
        }
        with self._lock:
            self._spans.append(rec)
        return rec

    def annotate(self, name: str, **attrs) -> dict:
        """Zero-duration context event (e.g. a KV plan decision). The
        clock read happens HERE, inside telemetry — callers in
        clock-free modules pass data only."""
        return self.add(name, dur_s=0.0, **attrs)

    def set_group(self, group_id: int) -> None:
        """Join a coalesced decode group; the id is shared by every
        member row's trace."""
        with self._lock:
            if group_id not in self._groups:
                self._groups.append(group_id)

    def finish(
        self, status: str = OK_STATUS, error: Optional[str] = None
    ) -> None:
        """Close the root span (idempotent — first call wins)."""
        with self._lock:
            if self.dur_s is not None:
                return
            self.dur_s = max(0.0, self._clock() - self.t0)
            self.status = status
            self.error = error

    # ------------------------------------------------------------ reads
    @property
    def finished(self) -> bool:
        return self.dur_s is not None

    @property
    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    @property
    def groups(self) -> list[int]:
        with self._lock:
            return list(self._groups)

    def to_dict(self) -> dict:
        with self._lock:
            d = {
                "id": self.trace_id,
                "status": self.status or "open",
                "dur_ms": (
                    self.dur_s * 1e3 if self.dur_s is not None else None
                ),
                "group_span_ids": list(self._groups),
                "attrs": dict(self.attrs),
                "spans": [dict(s) for s in self._spans],
            }
            if self.error:
                d["error"] = self.error
            return d


def tracez_payload(ring: "TraceRing", query: str) -> tuple[int, dict]:
    """THE `/tracez` HTTP contract, shared by every surface that owns a
    ring (replica server, router): ``?id=`` returns the full trace dict
    (404 with ``{"error": "no trace ..."}`` when the sampler dropped or
    never saw it), otherwise a summary list honoring ``?n=`` and
    ``?sort=recent|slowest|errors`` (bad sort/n → 400). Returns
    ``(status, payload)`` — the handler just serializes."""
    from urllib.parse import parse_qs

    q = parse_qs(query)
    tid = (q.get("id") or [None])[0]
    if tid is not None:
        tr = ring.get(tid)
        if tr is None:
            return 404, {"error": f"no trace {tid!r}"}
        return 200, tr
    try:
        n = int((q.get("n") or ["50"])[0])
        sort = (q.get("sort") or ["recent"])[0]
        traces = ring.list(n=n, sort=sort)
    except ValueError as e:
        return 400, {"error": str(e)}
    return 200, {"traces": traces, **ring.stats()}


def graft_spans(
    tdict: dict,
    anchor: dict,
    remote: dict,
    **attrs,
) -> int:
    """Cross-process stitching: splice a remote trace's spans into
    ``tdict`` under ``anchor`` (a span record already in ``tdict``).

    Remote ``start_s`` offsets are relative to the REMOTE trace start;
    re-anchoring them at the anchor span's start keeps one coherent
    timeline on the local clock without ever comparing the two
    processes' clocks directly (the anchor's wall window already brackets
    the remote work — HTTP request/response order guarantees it). The
    anchor gains ``remote_status``/``remote_dur_ms`` attrs; every
    grafted span carries the extra ``attrs`` (replica slug, attempt
    index) plus ``remote: True``. Returns the number of spans grafted.
    """
    anchor["attrs"]["remote_status"] = remote.get("status")
    anchor["attrs"]["remote_dur_ms"] = remote.get("dur_ms")
    if remote.get("error"):
        anchor["attrs"]["remote_error"] = remote["error"]
    base = anchor.get("start_s", 0.0)
    grafted = 0
    for rs in remote.get("spans") or []:
        tdict["spans"].append(
            {
                "name": rs.get("name", "?"),
                "start_s": base + float(rs.get("start_s") or 0.0),
                "dur_s": float(rs.get("dur_s") or 0.0),
                "attrs": {
                    **(rs.get("attrs") or {}),
                    **attrs,
                    "remote": True,
                },
            }
        )
        grafted += 1
    return grafted


def _summary(tdict: dict) -> dict:
    spans = tdict.get("spans") or []
    return {
        "id": tdict["id"],
        "status": tdict["status"],
        "dur_ms": tdict["dur_ms"],
        "spans": len(spans),
        "group_span_ids": tdict.get("group_span_ids", []),
        "attrs": tdict.get("attrs", {}),
    }


class TraceRing:
    """Bounded tail-sampling store of finished traces.

    Three retention classes share one id-indexed store:

    * ``recent``  — sliding window of the last N traces, any status;
    * ``errors``  — every non-ok trace (shed/deadline/error), its own
      window so a flood of ok traffic cannot evict them;
    * ``slowest`` — min-heap of the slowest durations seen.

    A trace lives in the store while ANY class references it
    (refcounted), so `/tracez?id=` keeps working for exactly the traces
    the sampler decided matter.
    """

    def __init__(
        self,
        capacity: int = 256,
        error_capacity: int = 128,
        slow_capacity: int = 32,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._store: dict[int, dict] = {}  # seq -> trace dict
        self._refs: dict[int, int] = {}  # seq -> refcount
        self._ids: dict[str, int] = {}  # trace id -> latest seq
        self._recent: deque[int] = deque()
        self._errors: deque[int] = deque()
        self._slow: list[tuple[float, int]] = []  # min-heap (dur, seq)
        self._capacity = capacity
        self._error_capacity = max(1, error_capacity)
        self._slow_capacity = max(1, slow_capacity)
        self._recorded = 0

    # --------------------------------------------------------- refcount
    def _retain(self, seq: int) -> None:
        self._refs[seq] = self._refs.get(seq, 0) + 1

    def _release(self, seq: int) -> None:
        n = self._refs.get(seq, 0) - 1
        if n > 0:
            self._refs[seq] = n
            return
        self._refs.pop(seq, None)
        t = self._store.pop(seq, None)
        if t is not None and self._ids.get(t["id"]) == seq:
            del self._ids[t["id"]]

    # ------------------------------------------------------------ write
    def record(self, trace) -> None:
        """Admit a finished RequestTrace (or a plain trace dict)."""
        tdict = trace.to_dict() if hasattr(trace, "to_dict") else dict(trace)
        dur = tdict.get("dur_ms") or 0.0
        status = tdict.get("status") or "open"
        with self._lock:
            seq = next(self._seq)
            self._recorded += 1
            self._store[seq] = tdict
            self._ids[tdict["id"]] = seq  # client-reused id: latest wins
            self._recent.append(seq)
            self._retain(seq)
            if len(self._recent) > self._capacity:
                self._release(self._recent.popleft())
            if status != OK_STATUS:
                self._errors.append(seq)
                self._retain(seq)
                if len(self._errors) > self._error_capacity:
                    self._release(self._errors.popleft())
            if len(self._slow) < self._slow_capacity:
                heapq.heappush(self._slow, (dur, seq))
                self._retain(seq)
            elif dur > self._slow[0][0]:
                _, old = heapq.heapreplace(self._slow, (dur, seq))
                self._retain(seq)
                self._release(old)

    # ------------------------------------------------------------ reads
    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            seq = self._ids.get(trace_id)
            if seq is None:
                return None
            return dict(self._store[seq])

    def list(self, n: int = 50, sort: str = "recent") -> list[dict]:
        """Trace summaries, newest/slowest first."""
        with self._lock:
            if sort == "slowest":
                seqs = [
                    s for _, s in sorted(self._slow, reverse=True)
                ]
            elif sort == "errors":
                seqs = list(reversed(self._errors))
            elif sort == "recent":
                seqs = list(reversed(self._recent))
            else:
                raise ValueError(
                    f"sort must be recent|slowest|errors, got {sort!r}"
                )
            out = []
            for seq in seqs[: max(0, n)]:
                t = self._store.get(seq)
                if t is not None:
                    out.append(_summary(t))
            return out

    def dump(self) -> list[dict]:
        """Every retained trace, full detail — the flight recorder's
        view. Oldest first, deduplicated across retention classes."""
        with self._lock:
            return [self._store[s] for s in sorted(self._store)]

    def stats(self) -> dict:
        with self._lock:
            return {
                "recorded": self._recorded,
                "retained": len(self._store),
                "recent": len(self._recent),
                "errors": len(self._errors),
                "slowest": len(self._slow),
                "capacity": self._capacity,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)
