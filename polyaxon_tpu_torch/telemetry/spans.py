"""Span tracing: context-manager spans with per-thread parent/child nesting,
a bounded in-memory ring and a JSONL sink. An own copy of `SpanTracer` and
`get_tracer` from `polyaxon_tpu/telemetry/spans.py` (the serving stack's
request traces are not ported).

    with tracer.span("step", step=i):
        with tracer.span("data_wait"):
            batch = feed.get()
        with tracer.span("compute"):
            ...

gives a two-level tree per step. One JSON object per line:
    {"kind": "span"|"event", "name": str, "span_id": int,
     "parent_id": int|null, "ts": float (unix), "dur_s": float, "attrs": {...}}
Durations come from the monotonic `registry.now`; `ts` is wall-clock.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Optional

from .registry import now


class _SpanHandle:
    """One in-flight span."""

    def __init__(self, tracer: "SpanTracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id: Optional[int] = None
        self.ts = 0.0
        self._t0 = 0.0
        self.dur_s: Optional[float] = None

    def __enter__(self) -> "_SpanHandle":
        stack = self.tracer._stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.ts = time.time()
        self._t0 = now()
        return self

    def __exit__(self, *exc) -> None:
        self.dur_s = now() - self._t0
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # mis-nested exit
            stack.remove(self)
        self.tracer._record({
            "kind": "span", "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id, "ts": self.ts, "dur_s": self.dur_s,
            "attrs": self.attrs,
        })


class SpanTracer:
    """`path=None` keeps records only in the memory ring (`recent()`); with
    a path every completed record is also appended to that JSONL file.
    An export failure stops the export and never fails the traced work."""

    def __init__(self, path: Optional[str] = None, capacity: int = 512):
        self._path = Path(path) if path else None
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._write_lock = threading.Lock()
        self._broken = False

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def span(self, name: str, **attrs) -> _SpanHandle:
        return _SpanHandle(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Instant (zero-duration) record."""
        stack = self._stack()
        self._record({
            "kind": "event", "name": name, "span_id": next(self._ids),
            "parent_id": stack[-1].span_id if stack else None,
            "ts": time.time(), "dur_s": 0.0, "attrs": attrs,
        })

    def _record(self, rec: dict) -> None:
        self._ring.append(rec)
        if self._path is None or self._broken:
            return
        try:
            with self._write_lock:
                self._path.parent.mkdir(parents=True, exist_ok=True)
                with self._path.open("a") as f:
                    f.write(json.dumps(rec) + "\n")
        except OSError:
            self._broken = True  # a full disk must not kill training

    def recent(self, n: int = 50) -> list[dict]:
        """Most recent completed records, oldest first."""
        return list(self._ring)[-n:]


_global = SpanTracer()


def get_tracer() -> SpanTracer:
    """Process-wide tracer (memory ring only) for cross-cutting events such
    as chaos injections."""
    return _global
