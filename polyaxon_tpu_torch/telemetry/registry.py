"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.
An own copy of `polyaxon_tpu/telemetry/registry.py` (stdlib only).

One registry instance is one scrape surface. Metric names use dotted
namespaces (`trainer.step_seconds`); the Prometheus renderer turns the dots
into underscores (counters grow `_total`, histograms emit
`_bucket{le=...}`/`_sum`/`_count`). `snapshot()` is the JSON view.

Histogram percentiles are estimated from bucket counts (linear
interpolation inside the bucket holding the target rank, clamped to the
observed min/max): no raw samples are kept.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

# latency-shaped default buckets, in seconds: 1ms .. 60s
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def now() -> float:
    """The monotonic clock every duration measurement goes through."""
    return time.perf_counter()


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (None until first set)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram. Buckets are ascending upper bounds; an
    implicit +inf bucket catches the overflow."""

    kind = "histogram"

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None, help: str = ""):
        self.name = name
        self.help = help
        bounds = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name} buckets must be strictly ascending, got {bounds}"
            )
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last = +inf overflow
        self._sum = 0.0
        self._count = 0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        # last (value, trace_id) landing in each bucket: the exemplar that
        # links a p99 spike to a concrete request trace
        self._exemplars: list = [None] * (len(bounds) + 1)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        value = float(value)
        i = next((i for i, b in enumerate(self.bounds) if value <= b), len(self.bounds))
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._min is None or value < self._min:
                self._min = value
            if self._max is None or value > self._max:
                self._max = value
            if exemplar is not None:
                self._exemplars[i] = (value, str(exemplar))

    def _state(self):
        with self._lock:
            return list(self._counts), self._sum, self._count, self._min, self._max

    @property
    def count(self) -> int:
        return self._state()[2]

    @property
    def sum(self) -> float:
        return self._state()[1]

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (q in [0, 1]) from bucket counts."""
        counts, _sum, total, vmin, vmax = self._state()
        if total == 0:
            return None
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else (vmin if vmin is not None else 0.0)
            hi = self.bounds[i] if i < len(self.bounds) else (vmax if vmax is not None else lo)
            if cum + c >= target:
                frac = (target - cum) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return min(max(est, vmin), vmax)
            cum += c
        return vmax

    def count_le(self, value: float) -> float:
        """Estimated cumulative count of observations <= value (linear
        interpolation inside the bucket the threshold falls in): the
        latency SLO's good events, from bucket counts only."""
        counts, _sum, total, vmin, vmax = self._state()
        if total == 0:
            return 0.0
        value = float(value)
        cum = 0.0
        for i, c in enumerate(counts):
            lo = self.bounds[i - 1] if i > 0 else (vmin if vmin is not None else 0.0)
            hi = self.bounds[i] if i < len(self.bounds) else (vmax if vmax is not None else lo)
            if value >= hi:
                cum += c
                continue
            if value >= lo and hi > lo:
                cum += c * (value - lo) / (hi - lo)
            break
        return cum

    def exemplar(self, q: float = 0.99) -> Optional[dict]:
        """The exemplar nearest the q-quantile bucket: {'value',
        'trace_id'} of a request that landed there, or None."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            ex = list(self._exemplars)
        if total == 0:
            return None
        target = q * total
        cum = 0.0
        idx = len(counts) - 1
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                idx = i
                break
        # the rank bucket may hold no exemplar: fall outward to the nearest
        for j in list(range(idx, len(ex))) + list(range(idx - 1, -1, -1)):
            if ex[j] is not None:
                return {"value": ex[j][0], "trace_id": ex[j][1]}
        return None

    def summary(self) -> dict:
        counts, total_sum, total, vmin, vmax = self._state()
        out = {
            "count": total, "sum": total_sum,
            "mean": (total_sum / total) if total else None,
            "min": vmin, "max": vmax,
        }
        for label, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            out[label] = self.percentile(q)
        return out


class MetricsRegistry:
    """Get-or-create metric container. A name is bound to one metric kind
    (and one set of histogram buckets) for the registry's lifetime;
    re-registering it otherwise raises."""

    def __init__(self, default_buckets: Optional[Sequence[float]] = None):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._default_buckets = tuple(default_buckets) if default_buckets else None

    def _get_or_create(self, name: str, factory, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(f"metric {name!r} already registered as {m.kind}, not {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help), "counter")

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help), "gauge")

    def histogram(
        self, name: str, buckets: Optional[Sequence[float]] = None, help: str = ""
    ) -> Histogram:
        h = self._get_or_create(
            name, lambda: Histogram(name, buckets or self._default_buckets, help), "histogram"
        )
        if buckets is not None and tuple(float(b) for b in buckets) != h.bounds:
            raise ValueError(f"histogram {name!r} already registered with buckets {h.bounds}")
        return h

    def metrics(self) -> list:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def snapshot(self) -> dict:
        """counters/gauges → value, histograms → their summary dict."""
        return {
            m.name: m.summary() if m.kind == "histogram" else m.value
            for m in self.metrics()
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: list[str] = []
        for m in self.metrics():
            name = _sanitize(m.name) + ("_total" if m.kind == "counter" else "")
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if m.kind == "counter":
                lines.append(f"{name} {_fmt(m.value)}")
            elif m.kind == "gauge":
                if m.value is not None:
                    lines.append(f"{name} {_fmt(m.value)}")
            else:
                counts, total_sum, total, _, _ = m._state()
                cum = 0
                for bound, c in zip(m.bounds, counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(bound)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {total}')
                lines.append(f"{name}_sum {_fmt(total_sum)}")
                lines.append(f"{name}_count {total}")
        return "\n".join(lines) + ("\n" if lines else "")


def _sanitize(name: str) -> str:
    s = "".join(
        ch if ch.isalnum() or ch == "_" or (ch == ":" and i) else "_"
        for i, ch in enumerate(name)
    )
    return ("_" + s) if s and s[0].isdigit() else s


def _fmt(v: float) -> str:
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_global = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry for cross-cutting layers (checkpoint tiers,
    chaos). A Trainer keeps its own unless it is given one."""
    return _global
