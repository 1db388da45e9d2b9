"""SLO burn-rate engine and the breach flight recorder, an own copy of
`polyaxon_tpu/telemetry/slo.py` whose profile window is `torch.profiler`.

Objectives (dicts: name, kind, objective, threshold_ms, windows) are
evaluated as **multi-window burn rates** over the registry's existing
counters/histograms — the engine stores no raw samples, only a short
ring of (t, bad, total) snapshots per objective, so memory is O(windows)
no matter the traffic.

Burn rate = (observed error rate over a window) / (error budget), where
error budget = 1 - objective. A burn of 1.0 spends the budget exactly at
the sustainable pace; an availability objective of 0.99 with 5% of
requests failing burns at 5. An objective breaches when EVERY window
burns at or above its threshold (the classic multi-window AND: the short
window proves it is happening now, the long window proves it is not a
blip).

Gauges exported on the owning registry:

    slo_burn_rate                 max effective burn across objectives
    slo_breached                  1 if any objective is breached
    slo_burn_rate_<name>          per-objective effective (min-window) burn
    slo_breached_<name>           per-objective breach flag

On a breach EDGE (ok → breached) the engine fires its hook once; the
serving layer points the hook at a ``FlightRecorder`` so every breach
leaves a post-mortem bundle (trace ring + registry snapshot + queue/KV
occupancy) under ``<outputs>/debug/`` instead of a flat graph.

All time comes from the telemetry clock (``registry.now``), never raw
``time.*`` reads, so burn windows can never
disagree with the latency histograms they are computed from.
"""

from __future__ import annotations

import itertools
import json
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

from .registry import MetricsRegistry, now

DEFAULT_WINDOWS_S: tuple[float, ...] = (60.0, 300.0)
_PROFILE_LOCK = threading.Lock()  # the flight recorders' profiler windows
_PROFILER_WARM = False


def _profile_activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _warm_profiler() -> None:
    """One empty profiler session on the constructing thread: the profiler
    library initializes on the thread of its first session and traces no
    device activity when that is not the thread that loaded it, so a later
    breach window (on a thread of its own) would come back empty."""
    global _PROFILER_WARM
    with _PROFILE_LOCK:
        if _PROFILER_WARM:
            return
        try:
            from torch.profiler import profile

            with profile(activities=_profile_activities()):
                pass
        except Exception:
            pass
        _PROFILER_WARM = True


def _slug(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


class Objective:
    """One SLO: a name, a target, burn windows, and a way to count
    (bad, total) from live metrics. Subclasses bind the counting."""

    kind = "objective"

    def __init__(
        self,
        name: str,
        objective: float,
        *,
        windows_s: Sequence[float] = DEFAULT_WINDOWS_S,
        burn_threshold: float = 1.0,
    ):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"slo {name!r}: objective must be in (0, 1), got {objective}"
            )
        ws = tuple(float(w) for w in windows_s)
        if not ws or any(w <= 0 for w in ws) or sorted(set(ws)) != list(ws):
            raise ValueError(
                f"slo {name!r}: windows must be strictly ascending positive "
                f"seconds, got {windows_s}"
            )
        if burn_threshold <= 0:
            raise ValueError(
                f"slo {name!r}: burnThreshold must be > 0, "
                f"got {burn_threshold}"
            )
        self.name = name
        self.objective = float(objective)
        self.budget = 1.0 - self.objective
        self.windows_s = ws
        self.burn_threshold = float(burn_threshold)
        # (t, bad, total) snapshots; pruned to ~the longest window
        self._samples: list[tuple[float, float, float]] = []
        self.breached = False

    def sample(self) -> tuple[float, float]:
        """Return cumulative (bad, total) counts."""
        raise NotImplementedError

    def describe(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "objective": self.objective,
            "windows_s": list(self.windows_s),
            "burn_threshold": self.burn_threshold,
        }


class AvailabilityObjective(Objective):
    """bad/total from counters: e.g. 5xx responses over all requests."""

    kind = "availability"

    def __init__(self, name, objective, *, bad, total, **kw):
        super().__init__(name, objective, **kw)
        self._bad = tuple(bad)
        self._total = tuple(total)

    def sample(self):
        return (
            sum(c.value for c in self._bad),
            sum(c.value for c in self._total),
        )


class LatencyObjective(Objective):
    """bad = observations above the threshold, from a histogram whose
    samples are in seconds. `objective` is the fraction that must land
    at or under `threshold_ms` (e.g. 0.95 of requests under 250ms)."""

    kind = "latency"

    def __init__(self, name, objective, *, histogram, threshold_ms, **kw):
        super().__init__(name, objective, **kw)
        if threshold_ms is None or float(threshold_ms) <= 0:
            raise ValueError(
                f"slo {name!r}: latency objective needs thresholdMs > 0, "
                f"got {threshold_ms}"
            )
        self._hist = histogram
        self.threshold_ms = float(threshold_ms)

    def sample(self):
        total = float(self._hist.count)
        good = self._hist.count_le(self.threshold_ms / 1e3)
        return (max(0.0, total - good), total)

    def describe(self):
        d = super().describe()
        d["threshold_ms"] = self.threshold_ms
        return d


def build_objectives(specs: Sequence[dict], *, bad, total, histogram):
    """Bind normalized slo spec dicts (name, kind, objective, threshold_ms,
    windows, burn_threshold) to the
    serving metrics: availability objectives count `bad`/`total`
    counters, latency objectives read the request-latency histogram."""
    out = []
    for s in specs:
        kw = {
            "windows_s": tuple(s.get("windows") or DEFAULT_WINDOWS_S),
            "burn_threshold": float(s.get("burn_threshold", 1.0)),
        }
        kind = s.get("kind", "availability")
        if kind == "availability":
            out.append(
                AvailabilityObjective(
                    s["name"], float(s["objective"]),
                    bad=bad, total=total, **kw,
                )
            )
        elif kind == "latency":
            out.append(
                LatencyObjective(
                    s["name"], float(s["objective"]),
                    histogram=histogram,
                    threshold_ms=s.get("threshold_ms"), **kw,
                )
            )
        else:
            raise ValueError(
                f"slo {s.get('name')!r}: kind must be availability|latency, "
                f"got {kind!r}"
            )
    return out


class SLOEngine:
    """Evaluates objectives against the registry clock; owns the gauges
    and the breach-edge hook. `evaluate()` is cheap and safe to call
    from a scrape handler; `start()` adds a background cadence so the
    gauges stay fresh between scrapes."""

    def __init__(
        self,
        objectives: Sequence[Objective],
        registry: MetricsRegistry,
        *,
        on_breach: Optional[Callable[[dict], None]] = None,
        clock: Callable[[], float] = now,
    ):
        self.objectives = list(objectives)
        self._registry = registry
        self._on_breach = on_breach
        self._clock = clock
        self._lock = threading.Lock()
        self._g_burn = registry.gauge(
            "slo.burn_rate", help="Max effective burn rate across SLOs"
        )
        self._g_breached = registry.gauge(
            "slo.breached", help="1 if any SLO is currently breached"
        )
        self._g_burn.set(0.0)
        self._g_breached.set(0.0)
        self._per: dict[str, tuple] = {}
        for obj in self.objectives:
            slug = _slug(obj.name)
            self._per[obj.name] = (
                registry.gauge(f"slo.burn_rate.{slug}"),
                registry.gauge(f"slo.breached.{slug}"),
            )
        self._last: list[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -------------------------------------------------------- evaluation
    def _eval_one(self, obj: Objective, t: float) -> dict:
        bad, total = obj.sample()
        obj._samples.append((t, bad, total))
        horizon = t - max(obj.windows_s) * 1.5
        while len(obj._samples) >= 2 and obj._samples[1][0] <= horizon:
            obj._samples.pop(0)
        burns = {}
        dn_long = 0.0
        for w in obj.windows_s:
            base = obj._samples[0]
            for s in obj._samples:
                if s[0] <= t - w:
                    base = s
                else:
                    break
            db = max(0.0, bad - base[1])
            dn = max(0.0, total - base[2])
            rate = (db / dn) if dn > 0 else 0.0
            burns[w] = rate / obj.budget
            if w == max(obj.windows_s):
                dn_long = dn
        effective = min(burns.values())
        breached = dn_long > 0 and effective >= obj.burn_threshold
        edge = breached and not obj.breached
        obj.breached = breached
        res = dict(obj.describe())
        res.update(
            {
                "bad": bad,
                "total": total,
                "burn_rates": {f"{w:g}s": b for w, b in burns.items()},
                "burn_rate": effective,
                "breached": breached,
                "edge": edge,
            }
        )
        g_burn, g_breached = self._per[obj.name]
        g_burn.set(effective)
        g_breached.set(1.0 if breached else 0.0)
        return res

    def evaluate(self, t: Optional[float] = None) -> list[dict]:
        """One evaluation pass; fires the breach hook on each objective's
        ok→breached edge (never re-fires while it stays breached)."""
        with self._lock:
            t = self._clock() if t is None else t
            results = [self._eval_one(obj, t) for obj in self.objectives]
            self._g_burn.set(
                max((r["burn_rate"] for r in results), default=0.0)
            )
            self._g_breached.set(
                1.0 if any(r["breached"] for r in results) else 0.0
            )
            self._last = results
        if self._on_breach is not None:
            for r in results:
                if r["edge"]:
                    try:
                        self._on_breach(r)
                    except Exception:
                        pass  # the recorder is advisory, never the request path
        return results

    @property
    def last(self) -> list[dict]:
        with self._lock:
            return list(self._last)

    def to_dict(self) -> dict:
        results = self.evaluate()
        return {
            "enabled": bool(self.objectives),
            "breached": any(r["breached"] for r in results),
            "slos": [
                {k: v for k, v in r.items() if k != "edge"}
                for r in results
            ],
        }

    # -------------------------------------------------------- background
    def start(self, interval_s: Optional[float] = None) -> None:
        if self._thread is not None or not self.objectives:
            return
        if interval_s is None:
            shortest = min(min(o.windows_s) for o in self.objectives)
            interval_s = min(5.0, max(0.25, shortest / 6.0))
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate()
                except Exception:
                    pass

        self._thread = threading.Thread(
            target=loop, name="slo-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)


class FlightRecorder:
    """Dumps a post-mortem bundle on SLO breach. Each dump is one
    directory under `<out_dir>/`:

        slo-NNN-<objective>/
          breach.json   the breaching objective's burn rates + trigger
          trace.json    the breaching trace (p99 exemplar or last error)
          traces.jsonl  every trace the tail-sampler retained
          metrics.json  full registry snapshot
          state.json    queue/KV occupancy at breach time
          profile/      optional torch.profiler window (profile_s > 0)

    Bounded (`limit` dumps per process) and advisory: any failure is
    swallowed — a full disk must not take down serving.
    """

    def __init__(
        self,
        out_dir,
        *,
        registry: Optional[MetricsRegistry] = None,
        trace_ring=None,
        state_fn: Optional[Callable[[], dict]] = None,
        trace_fn: Optional[Callable[[dict], Optional[dict]]] = None,
        profile_s: float = 0.0,
        limit: int = 8,
    ):
        self._out = Path(out_dir)
        self._registry = registry
        self._ring = trace_ring
        self._state_fn = state_fn
        self._trace_fn = trace_fn
        self._profile_s = float(profile_s)
        self._limit = int(limit)
        self._seq = itertools.count(1)
        self._dumps: list[str] = []
        self._profilers: list[threading.Thread] = []
        self._lock = threading.Lock()
        if self._profile_s > 0:
            _warm_profiler()

    @property
    def dumps(self) -> list[str]:
        with self._lock:
            return list(self._dumps)

    def dump(self, breach: dict) -> Optional[Path]:
        with self._lock:
            if len(self._dumps) >= self._limit:
                return None
            seq = next(self._seq)
        try:
            name = _slug(str(breach.get("name", "slo")))
            d = self._out / f"slo-{seq:03d}-{name}"
            d.mkdir(parents=True, exist_ok=True)
            trace = self._pick_trace(breach)
            info = dict(breach)
            info.pop("edge", None)
            if trace is not None:
                info["trace_id"] = trace.get("id")
            (d / "breach.json").write_text(json.dumps(info, indent=2))
            if trace is not None:
                (d / "trace.json").write_text(json.dumps(trace, indent=2))
            if self._ring is not None:
                with (d / "traces.jsonl").open("w") as f:
                    for t in self._ring.dump():
                        f.write(json.dumps(t) + "\n")
            if self._registry is not None:
                (d / "metrics.json").write_text(
                    json.dumps(self._registry.snapshot(), indent=2)
                )
            if self._state_fn is not None:
                (d / "state.json").write_text(
                    json.dumps(self._state_fn(), indent=2)
                )
            self._maybe_profile(d)
            with self._lock:
                self._dumps.append(str(d))
            return d
        except Exception:
            return None  # advisory

    def _pick_trace(self, breach: dict) -> Optional[dict]:
        """The trace that best explains the breach: a caller-provided
        picker first (the server points latency breaches at the p99
        exemplar), then the most recent error, then the slowest."""
        if self._trace_fn is not None:
            try:
                t = self._trace_fn(breach)
                if t is not None:
                    return t
            except Exception:
                pass
        if self._ring is None:
            return None
        for sort in ("errors", "slowest"):
            top = self._ring.list(1, sort=sort)
            if top:
                return self._ring.get(top[0]["id"])
        return None

    def _maybe_profile(self, d: Path) -> None:
        """A `torch.profiler` window of `profile_s` seconds into
        `<bundle>/profile/trace.json` (Chrome trace), on a thread of its
        own: CUDA activity is traced device-wide, so the steps the decode
        worker launches meanwhile land in it."""
        if self._profile_s <= 0:
            return

        def run():
            # one profiler session per process: a window that would overlap
            # a running one (a second breach edge, another profiler) is
            # skipped, never nested
            if not _PROFILE_LOCK.acquire(blocking=False):
                return
            try:
                from torch.profiler import profile

                with profile(activities=_profile_activities()) as prof:
                    threading.Event().wait(self._profile_s)
                (d / "profile").mkdir(exist_ok=True)
                prof.export_chrome_trace(str(d / "profile" / "trace.json"))
            except Exception:
                pass
            finally:
                _PROFILE_LOCK.release()

        t = threading.Thread(target=run, name="slo-profile", daemon=True)
        with self._lock:
            self._profilers.append(t)
        t.start()

    def wait_profiles(self, timeout: Optional[float] = None) -> None:
        """Block until every profile window started so far is written."""
        with self._lock:
            threads = list(self._profilers)
        for t in threads:
            t.join(timeout)
