"""Regression sentinel: declarative rules over metrics history windows,
an own copy of `polyaxon_tpu/telemetry/detect.py`.

History (`telemetry/history.py`) makes performance queryable; this
module makes it *actionable*. A :class:`RegressionSentinel` evaluates a
list of :class:`RegressionRule`s against a :class:`HistoryStore` on a
background cadence. Three rule kinds cover the drift shapes the ROADMAP
cares about (step-time drift, TTFT creep, queue-wait trend, spec
accept-rate collapse, KV spill-rate surge):

* ``ceiling`` — the aggregated value over the last ``window_s`` crossed
  an absolute threshold (direction ``above``, or ``below`` for floors
  like accept rate).
* ``window_ratio`` — the last window versus the window before it: fires
  when recent/previous exceeds ``threshold`` (``above``) or drops under
  it (``below``). The sharp-elbow detector.
* ``ewma_drift`` — an exponentially weighted baseline over the lookback
  (everything before the last window); fires when the recent window
  leaves the baseline by more than ``threshold`` (a fraction: 0.10 =
  10% drift). The slow-creep detector.

Firing is EDGE-TRIGGERED, exactly like the SLO engine: the hooks fire
once on the inactive→active transition and never re-fire while the rule
stays active. On an edge the sentinel

* emits a ``perf_regression`` event through its ``on_event`` sink (the
  serving layer points this at the run's event log, so the regression
  lands in its timeline);
* dumps a :class:`FlightRecorder` bundle with the offending series
  window attached (``history_window`` in breach.json);
* flips the rule's ``regression_active_<rule>`` gauge (and the
  aggregate ``regression_active``) on the owning registry.

NO raw clocks here: evaluation time comes
from the injected clock, so tests replay deterministic histories.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

from .history import BadQuery, HistoryStore
from .registry import MetricsRegistry, now

__all__ = [
    "RULE_KINDS",
    "RegressionRule",
    "RegressionSentinel",
    "build_rules",
    "DEFAULT_SERVING_RULES",
]

RULE_KINDS = ("ceiling", "window_ratio", "ewma_drift")


def _slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


class RegressionRule:
    """One declarative rule. ``spec`` keys (normalized — what
    the reference's run spec produces):

    name, series, kind, threshold; optional agg (default avg),
    window_s (default 60), direction (above|below, default above),
    alpha (ewma smoothing, default 0.3), lookback_windows (ewma
    baseline depth, default 5), min_samples (default 3).
    """

    def __init__(self, spec: dict):
        self.name = str(spec["name"])
        self.series = str(spec["series"])
        self.kind = str(spec.get("kind", "ceiling"))
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"rule {self.name!r}: kind must be one of "
                f"{'|'.join(RULE_KINDS)}, got {self.kind!r}"
            )
        self.agg = str(spec.get("agg", "avg"))
        self.window_s = float(spec.get("window_s", 60.0))
        if self.window_s <= 0:
            raise ValueError(
                f"rule {self.name!r}: window_s must be > 0"
            )
        self.threshold = float(spec["threshold"])
        self.direction = str(spec.get("direction", "above"))
        if self.direction not in ("above", "below"):
            raise ValueError(
                f"rule {self.name!r}: direction must be above|below, "
                f"got {self.direction!r}"
            )
        self.alpha = float(spec.get("alpha", 0.3))
        self.lookback_windows = max(2, int(spec.get("lookback_windows", 5)))
        self.min_samples = max(1, int(spec.get("min_samples", 3)))
        self.active = False

    def describe(self) -> dict:
        return {
            "name": self.name,
            "series": self.series,
            "kind": self.kind,
            "agg": self.agg,
            "window_s": self.window_s,
            "threshold": self.threshold,
            "direction": self.direction,
        }

    # --------------------------------------------------------- evaluation
    def _worse(self, value: float, baseline: float) -> bool:
        if self.direction == "above":
            return value > baseline
        return value < baseline

    def evaluate(self, store: HistoryStore, t: float) -> dict:
        """One verdict: {active, value, baseline, samples, window}.
        Never raises — an unqueryable series is an inactive rule (the
        series may simply not have flowed yet)."""
        out = dict(self.describe())
        out.update(active=False, value=None, baseline=None, window=[])
        try:
            if self.kind == "ewma_drift":
                lookback = self.window_s * self.lookback_windows
                res = store.query(
                    self.series,
                    last=lookback,
                    step=self.window_s,
                    agg=self.agg,
                )
            else:
                res = store.query(
                    self.series,
                    last=2 * self.window_s,
                    step=self.window_s,
                    agg=self.agg,
                )
        except BadQuery:
            return out
        pts = [(p[0], p[1]) for p in res["points"] if p[1] is not None]
        out["window"] = [[t0, v] for t0, v in pts]
        out["resets"] = res.get("resets", 0)
        if res["samples"] < self.min_samples or not pts:
            return out
        value = pts[-1][1]
        out["value"] = value
        if self.kind == "ceiling":
            out["baseline"] = self.threshold
            out["active"] = self._worse(value, self.threshold)
        elif self.kind == "window_ratio":
            if len(pts) < 2:
                return out
            prev = pts[-2][1]
            out["baseline"] = prev
            if prev == 0:
                return out
            ratio = value / prev
            out["ratio"] = ratio
            out["active"] = (
                ratio > self.threshold
                if self.direction == "above"
                else ratio < self.threshold
            )
        else:  # ewma_drift
            history = [v for _, v in pts[:-1]]
            if not history:
                return out
            ewma = history[0]
            for v in history[1:]:
                ewma = self.alpha * v + (1 - self.alpha) * ewma
            out["baseline"] = ewma
            if self.direction == "above":
                out["active"] = value > ewma * (1.0 + self.threshold)
            else:
                out["active"] = value < ewma * (1.0 - self.threshold)
        return out


def build_rules(specs: Sequence[dict]) -> list[RegressionRule]:
    rules = [RegressionRule(dict(s)) for s in specs]
    seen: set[str] = set()
    for r in rules:
        if r.name in seen:
            raise ValueError(f"duplicate regression rule name {r.name!r}")
        seen.add(r.name)
    return rules


#: the serving drift pack — wired as-is when a spec
#: says ``regressionRules: default``
DEFAULT_SERVING_RULES: tuple[dict, ...] = (
    {
        "name": "ttft-creep",
        "series": "serving.ttft_ms",
        "kind": "ewma_drift",
        "agg": "p95",
        "window_s": 60.0,
        "threshold": 0.25,
    },
    {
        "name": "queue-wait-trend",
        "series": "serving.queue_wait_seconds",
        "kind": "window_ratio",
        "agg": "p95",
        "window_s": 60.0,
        "threshold": 2.0,
    },
    {
        "name": "accept-rate-collapse",
        "series": "serving.spec_accept_rate",
        "kind": "ceiling",
        "agg": "avg",
        "window_s": 60.0,
        "threshold": 0.2,
        "direction": "below",
    },
    {
        "name": "kv-spill-surge",
        "series": "serving.kv_spill_bytes",
        "kind": "window_ratio",
        "agg": "rate",
        "window_s": 60.0,
        "threshold": 4.0,
    },
    # multi-tenant serving: named-tenant queue waits doubling
    # window-over-window means fairness is degrading (one tenant's flood
    # is leaking into everyone's latency)...
    {
        "name": "tenant-queue-wait-trend",
        "series": "serving.tenant_queue_wait_seconds",
        "kind": "window_ratio",
        "agg": "p95",
        "window_s": 60.0,
        "threshold": 2.0,
    },
    # ...and an adapter-load rate spike means the hot-slot working set is
    # thrashing (too few adapterSlots for the live tenant mix)
    {
        "name": "adapter-thrash-surge",
        "series": "serving.adapter_loads",
        "kind": "window_ratio",
        "agg": "rate",
        "window_s": 60.0,
        "threshold": 4.0,
    },
    # disaggregated serving: handoff latency p95 doubling
    # window-over-window means the prefill→decode transfer path is
    # degrading (network, decode-pool headroom, or retry storms) — the
    # first symptom before fallbacks start eating the decode pool's TTFT
    # advantage
    {
        "name": "handoff-latency-trend",
        "series": "serving.kv_handoff_ms",
        "kind": "window_ratio",
        "agg": "p95",
        "window_s": 60.0,
        "threshold": 2.0,
    },
)


class RegressionSentinel:
    """Evaluates rules on a cadence; owns the `regression_active` gauges
    and the edge hooks. `evaluate()` is cheap and safe from a scrape
    handler; `start()` keeps the gauges fresh between scrapes."""

    def __init__(
        self,
        store: HistoryStore,
        registry: MetricsRegistry,
        rules: Sequence[RegressionRule],
        *,
        on_event: Optional[Callable[[str, dict], None]] = None,
        recorder=None,  # FlightRecorder-shaped: .dump(breach_dict)
        clock: Callable[[], float] = now,
        interval_s: float = 5.0,
    ):
        self.store = store
        self.rules = list(rules)
        self._on_event = on_event
        self._recorder = recorder
        self._clock = clock
        self.interval_s = max(0.05, float(interval_s))
        self._lock = threading.Lock()
        self._g_active = registry.gauge(
            "regression.active",
            help="Regression rules currently firing (count)",
        )
        self._g_active.set(0.0)
        self._per: dict[str, object] = {}
        for r in self.rules:
            g = registry.gauge(
                f"regression.active.{_slug(r.name)}",
                help=f"1 while regression rule {r.name!r} is firing",
            )
            g.set(0.0)
            self._per[r.name] = g
        self._last: list[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def evaluate(self, t: Optional[float] = None) -> list[dict]:
        """One pass; fires hooks on each rule's inactive→active edge
        (never re-fires while it stays active)."""
        edges: list[dict] = []
        with self._lock:
            t = self._clock() if t is None else t
            results = []
            for r in self.rules:
                res = r.evaluate(self.store, t)
                res["edge"] = bool(res["active"]) and not r.active
                r.active = bool(res["active"])
                self._per[r.name].set(1.0 if r.active else 0.0)
                if res["edge"]:
                    edges.append(res)
                results.append(res)
            self._g_active.set(
                float(sum(1 for r in self.rules if r.active))
            )
            self._last = results
        for res in edges:
            body = {k: v for k, v in res.items() if k != "edge"}
            body["history_window"] = body.pop("window", [])
            # the run event log flattens the body into its record, where
            # a "kind" key would clobber the event kind itself — the
            # rule's kind travels under its own name
            body["rule_kind"] = body.pop("kind", None)
            if self._on_event is not None:
                try:
                    self._on_event("perf_regression", body)
                except Exception:
                    pass  # the sink is advisory, never the eval path
            if self._recorder is not None:
                try:
                    self._recorder.dump(dict(body))
                except Exception:
                    pass
        return results

    @property
    def last(self) -> list[dict]:
        with self._lock:
            return list(self._last)

    def to_dict(self) -> dict:
        results = self.evaluate()
        return {
            "enabled": bool(self.rules),
            "active": [r["name"] for r in results if r["active"]],
            "rules": [
                {k: v for k, v in r.items() if k not in ("edge", "window")}
                for r in results
            ],
        }

    # -------------------------------------------------------- background
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None or not self.rules:
            return
        if interval_s is not None:
            self.interval_s = max(0.05, float(interval_s))
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.evaluate()
                except Exception:
                    pass

        self._thread = threading.Thread(
            target=loop, name="regression-sentinel", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
