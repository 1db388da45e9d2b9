"""Embedded metrics history: a crash-consistent time-series store, an own
copy of `polyaxon_tpu/telemetry/history.py`. Its segments use the same
framing (`store/framing.py`) and JSON samples, so a segment written by
either package reads in the other.

Every other observability surface is an instantaneous snapshot —
`/metricsz`, `/statsz`, the router's federated scrape. This module gives
the process a memory: a background :class:`HistorySampler` snapshots a
``MetricsRegistry`` (counters, gauges, histogram bucket vectors) at a
configurable cadence into length+CRC32-framed append-only segments under
``<outputs>/telemetry/history/``, and a query layer answers
``GET /queryz?series=&since=&until=&step=&agg=`` with windowed
aggregates (avg|min|max|rate|p50|p95|p99) computed from those samples.

Durability is the event-log contract, *verbatim* — the segments use
``store.framing.frame``/``scan_frames``:

* a torn tail (crash mid-append) truncates back to the last whole frame;
* a corrupt frame with committed data after it (bit rot) quarantines the
  segment as ``<seg>.corrupt`` and truncates;
* heal runs at open and NEVER wedges — a damaged history store always
  boots and keeps every committed sample.

Retention is tiered: the ``raw`` tier holds full-cadence samples; when
its byte budget fills, the oldest raw segment is *downsampled* into the
``10s`` tier (last sample per 10-second bucket — samples are cumulative
counter/bucket states, so the last state per bucket loses no rate
information), and ``10s`` overflow downsamples into ``1m``. Only the
coarsest tier drops data outright. Total bytes stay bounded.

``rate()`` is counter-reset aware: a replica restart (the decode
worker's watchdog, a replica-set restart) drops its counters to zero mid-window. A decrease between
consecutive samples is treated as a restart — the post-reset value IS
the increase since the reset — so a rate is never negative, and the
query result carries a ``resets`` annotation instead of a lie. The same
clamp guards ``cluster:*:sum`` series recorded by the router's federated
history (one source's reset drops the sum; see `telemetry.federate`).

NO raw clocks in this module: samples carry
their own timestamps, assigned by the *caller's* injected clock
(`HistorySampler` defaults to `registry.now`), so tests drive the store
with a fake clock and every window boundary is deterministic.

Chaos: ``inject("history.append", path=..., tier=...)`` fires before
each frame lands, so a seeded kill, scramble or corrupt plan can
exercise heal across every crash shape.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Callable, Iterable, Optional, Sequence
from urllib.parse import parse_qs

from ..chaos.injector import inject
from ..store.framing import frame, scan_frames
from .registry import MetricsRegistry, now

__all__ = [
    "AGGS",
    "TIERS",
    "HistoryStore",
    "HistorySampler",
    "BadQuery",
    "aggregate",
    "percentile_from_counts",
    "rate_over",
    "sample_registry",
    "sample_from_snapshots",
    "queryz_payload",
]

AGGS = ("avg", "min", "max", "rate", "p50", "p95", "p99")

#: retention tiers, finest first; downsample step per tier (seconds)
TIERS = ("raw", "10s", "1m")
_TIER_STEP = {"raw": 0.0, "10s": 10.0, "1m": 60.0}
#: fraction of the total byte budget each tier may hold
_TIER_BUDGET = {"raw": 0.5, "10s": 0.3, "1m": 0.2}

DEFAULT_MAX_BYTES = 32 * 1024 * 1024
DEFAULT_SEGMENT_BYTES = 256 * 1024


class BadQuery(Exception):
    """Client-side bad /queryz parameter → 400 (mirrors streams.BadParam:
    deliberately not a ValueError, so corrupt stored samples surface as
    server faults, never as the client's mistake)."""


# --------------------------------------------------------------- store
class HistoryStore:
    """Append-only, CRC-framed, tier-retained sample store.

    One instance owns one directory. Samples are JSON dicts::

        {"t": <ts>, "s": {name: value},            # counters + gauges
         "h": {name: [bucket_counts, sum, count]}, # histograms
         "hb": {name: [bounds...]}}                # histogram bounds

    Timestamps come from the caller; the store itself is clock-free.
    Thread-safe: one lock guards append/rotate/retention; queries read
    committed segment bytes and may run concurrently with appends.
    """

    DEFAULT_MAX_BYTES = DEFAULT_MAX_BYTES
    DEFAULT_SEGMENT_BYTES = DEFAULT_SEGMENT_BYTES

    def __init__(
        self,
        root,
        *,
        max_bytes: int = DEFAULT_MAX_BYTES,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max(4096, int(max_bytes))
        self.segment_bytes = max(1024, int(segment_bytes))
        self._lock = threading.Lock()
        self.heal_stats = self.heal()
        self._seq: dict[str, int] = {}
        for tier in TIERS:
            segs = self._segments(tier)
            self._seq[tier] = (
                int(segs[-1].stem.rsplit("-", 1)[1]) + 1 if segs else 0
            )

    # ------------------------------------------------------------ layout
    def _segments(self, tier: str) -> list[Path]:
        return sorted(self.root.glob(f"{tier}-*.seg"))

    def _live_segment(self, tier: str) -> Path:
        segs = self._segments(tier)
        if segs and segs[-1].stat().st_size < self.segment_bytes:
            return segs[-1]
        seq = self._seq.get(tier, 0)
        self._seq[tier] = seq + 1
        return self.root / f"{tier}-{seq:08d}.seg"

    def total_bytes(self, tier: Optional[str] = None) -> int:
        tiers = (tier,) if tier else TIERS
        return sum(
            p.stat().st_size for t in tiers for p in self._segments(t)
        )

    # ------------------------------------------------------------ healing
    def heal(self) -> dict:
        """Scan every segment; truncate torn tails, quarantine corrupt
        segments as ``<seg>.corrupt``. Never raises — a damaged history
        must not wedge the process that owns it."""
        stats = {"clean": 0, "torn": 0, "corrupt": 0}
        for tier in TIERS:
            for seg in self._segments(tier):
                try:
                    data = seg.read_bytes()
                    _, verdict, good_end = scan_frames(data)
                except OSError:
                    continue
                if verdict == "clean":
                    stats["clean"] += 1
                    continue
                stats[verdict] += 1
                try:
                    if verdict == "corrupt":
                        shutil.copyfile(seg, seg.with_suffix(".corrupt"))
                    with seg.open("r+b") as f:
                        f.truncate(good_end)
                        f.flush()
                except OSError:
                    pass  # advisory: keep booting on a read-only disk
        return stats

    # ------------------------------------------------------------ writes
    def append(self, sample: dict, tier: str = "raw") -> None:
        payload = json.dumps(
            sample, separators=(",", ":"), default=float
        ).encode()
        with self._lock:
            self._append_locked(payload, tier)
            self._retain_locked()

    def _append_locked(self, payload: bytes, tier: str) -> None:
        seg = self._live_segment(tier)
        # chaos site: a kill here is a crash mid-append (torn tail on
        # recovery), scramble_tail/corrupt_segment damage the bytes the
        # way a power cut / bit rot would
        inject("history.append", path=str(seg), tier=tier)
        with seg.open("ab") as f:
            f.write(frame(payload))

    # --------------------------------------------------------- retention
    def _retain_locked(self) -> None:
        for i, tier in enumerate(TIERS):
            budget = int(self.max_bytes * _TIER_BUDGET[tier])
            nxt = TIERS[i + 1] if i + 1 < len(TIERS) else None
            while self.total_bytes(tier) > budget:
                segs = self._segments(tier)
                if len(segs) < 2:
                    break  # never evict the live segment
                oldest = segs[0]
                if nxt is not None:
                    for rec in self._downsample(oldest, _TIER_STEP[nxt]):
                        self._append_locked(
                            json.dumps(
                                rec, separators=(",", ":"), default=float
                            ).encode(),
                            nxt,
                        )
                oldest.unlink(missing_ok=True)

    def _downsample(self, seg: Path, step: float) -> list[dict]:
        """Last sample per `step`-second bucket. Samples are cumulative
        states, so keeping the last per bucket preserves every increase
        a rate() over the coarser tier can observe."""
        buckets: dict[int, dict] = {}
        for rec in self._read_segment(seg):
            t = rec.get("t")
            if t is None:
                continue
            buckets[int(float(t) // step)] = rec
        return [buckets[k] for k in sorted(buckets)]

    # ------------------------------------------------------------- reads
    def _read_segment(self, seg: Path) -> list[dict]:
        try:
            data = seg.read_bytes()
        except OSError:
            return []
        payloads, _verdict, _end = scan_frames(data)
        out = []
        for p in payloads:
            try:
                out.append(json.loads(p))
            except ValueError:
                continue
        return out

    def samples(
        self,
        since: Optional[float] = None,
        until: Optional[float] = None,
    ) -> list[dict]:
        """All samples across tiers, time-ordered, de-duplicated by
        timestamp (finer tiers win — a raw sample not yet evicted
        shadows its downsampled copy)."""
        by_t: dict[float, dict] = {}
        for tier in reversed(TIERS):  # coarse first; raw overwrites
            for seg in self._segments(tier):
                for rec in self._read_segment(seg):
                    t = rec.get("t")
                    if t is None:
                        continue
                    t = float(t)
                    if since is not None and t < since:
                        continue
                    if until is not None and t > until:
                        continue
                    by_t[t] = rec
        return [by_t[t] for t in sorted(by_t)]

    def series_names(self) -> list[str]:
        names: dict[str, None] = {}
        for rec in self.samples():
            for key in ("s", "h"):
                for name in rec.get(key) or {}:
                    names.setdefault(name)
        return sorted(names)

    # ------------------------------------------------------------- query
    def query(
        self,
        series: str,
        *,
        since: Optional[float] = None,
        until: Optional[float] = None,
        step: Optional[float] = None,
        agg: str = "avg",
        last: Optional[float] = None,
    ) -> dict:
        if agg not in AGGS:
            raise BadQuery(
                f"agg must be one of {'|'.join(AGGS)}, got {agg!r}"
            )
        recs = self.samples()
        scalars: list[tuple[float, float]] = []
        hists: list[tuple[float, list, float, float]] = []
        bounds: Optional[list] = None
        for rec in recs:
            t = float(rec["t"])
            v = (rec.get("s") or {}).get(series)
            if v is not None:
                scalars.append((t, float(v)))
            h = (rec.get("h") or {}).get(series)
            if h is not None:
                counts, hsum, hcount = h[0], float(h[1]), float(h[2])
                hists.append((t, list(counts), hsum, hcount))
                b = (rec.get("hb") or {}).get(series)
                if b is not None:
                    bounds = [float(x) for x in b]
        if not scalars and not hists:
            raise BadQuery(f"unknown series {series!r}")
        times = [p[0] for p in (scalars or hists)]
        lo, hi = min(times), max(times)
        if last is not None:
            until = hi if until is None else until
            since = until - float(last)
        since = lo if since is None else float(since)
        until = hi if until is None else float(until)
        if until < since:
            raise BadQuery("until must be >= since")
        span = until - since
        step = span if step is None or step <= 0 else float(step)
        if step <= 0:
            step = 1.0  # zero-span range: one degenerate window
        if span / step > 10_000:
            raise BadQuery(
                f"step {step:g}s over a {span:g}s range yields too many "
                "points (max 10000)"
            )
        points: list[list] = []
        resets = 0
        w0 = since
        while w0 <= until:
            w1 = min(w0 + step, until) if step < span else until
            if agg in ("avg", "min", "max"):
                if not scalars:
                    raise BadQuery(
                        f"agg {agg!r} needs a scalar series; "
                        f"{series!r} is a histogram (use p50|p95|p99|rate)"
                    )
                vals = [v for t, v in scalars if w0 <= t <= w1]
                points.append([w0, aggregate(vals, agg)])
            elif agg == "rate":
                pts = scalars or [(t, c) for t, _, _, c in hists]
                v, r = rate_over(pts, w0, w1)
                resets += r
                points.append([w0, v])
            else:  # p50|p95|p99
                if not hists:
                    raise BadQuery(
                        f"agg {agg!r} needs a histogram series; "
                        f"{series!r} is scalar (use avg|min|max|rate)"
                    )
                if bounds is None:
                    raise BadQuery(
                        f"series {series!r} has no recorded bucket bounds"
                    )
                q = {"p50": 0.5, "p95": 0.95, "p99": 0.99}[agg]
                delta, r = _hist_window_delta(hists, w0, w1)
                resets += r
                points.append(
                    [w0, percentile_from_counts(delta, bounds, q)]
                )
            if w1 >= until:
                break
            w0 = w0 + step
        return {
            "series": series,
            "agg": agg,
            "since": since,
            "until": until,
            "step": step,
            "points": points,
            "samples": len(scalars) + len(hists),
            "resets": resets,
        }


# ----------------------------------------------------- aggregation math
def aggregate(values: Sequence[float], agg: str) -> Optional[float]:
    """avg|min|max over raw scalar samples; None on an empty window."""
    if not values:
        return None
    if agg == "avg":
        return sum(values) / len(values)
    if agg == "min":
        return min(values)
    if agg == "max":
        return max(values)
    raise BadQuery(f"unknown scalar agg {agg!r}")


def rate_over(
    points: Sequence[tuple[float, float]], w0: float, w1: float
) -> tuple[Optional[float], int]:
    """Per-second increase of a cumulative counter over [w0, w1].

    Counter-reset aware: a decrease between consecutive samples means
    the source restarted — the new value is the increase since the
    reset, never a negative delta. Returns ``(rate_or_None, resets)``;
    None when fewer than two samples cover the window."""
    seq = [(t, v) for t, v in points if w0 <= t <= w1]
    base = None
    for t, v in points:
        if t < w0:
            base = (t, v)
        else:
            break
    if base is not None:
        seq = [base] + seq
    if len(seq) < 2:
        return None, 0
    inc, resets = 0.0, 0
    for (_, v0), (_, v1) in zip(seq, seq[1:]):
        if v1 >= v0:
            inc += v1 - v0
        else:
            inc += v1  # restart: count from zero, never negative
            resets += 1
    dur = seq[-1][0] - seq[0][0]
    if dur <= 0:
        return None, resets
    return inc / dur, resets


def _hist_window_delta(
    hists: Sequence[tuple[float, list, float, float]],
    w0: float,
    w1: float,
) -> tuple[list, int]:
    """Bucket-count increase over the window from cumulative states.

    A reset (any bucket decreased — the histogram's process restarted)
    falls back to the end state's counts alone: everything the restarted
    process observed, nothing negative."""
    start = None
    for t, counts, _s, _c in hists:
        if t < w0:
            start = counts
        else:
            break
    end = None
    for t, counts, _s, _c in hists:
        if w0 <= t <= w1:
            end = counts
    if end is None:
        return [], 0
    if start is None:
        return list(end), 0
    if len(start) != len(end) or any(
        e < s for s, e in zip(start, end)
    ):
        return list(end), 1
    return [e - s for s, e in zip(start, end)], 0


def percentile_from_counts(
    counts: Sequence[float], bounds: Sequence[float], q: float
) -> Optional[float]:
    """q-quantile from per-window bucket deltas: linear interpolation
    inside the bucket holding the target rank (the registry Histogram's
    estimator, minus the min/max clamp — window deltas have neither)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (target - cum) / c
            return lo + (hi - lo) * max(0.0, min(1.0, frac))
        cum += c
    return float(bounds[-1]) if bounds else None


# ------------------------------------------------------------- sampling
def sample_registry(registry: MetricsRegistry, t: float) -> dict:
    """One history record from a live registry: counters/gauges →
    scalars, histograms → cumulative bucket-count vectors (+bounds, so
    queries can interpolate percentiles without the registry)."""
    s: dict = {}
    h: dict = {}
    hb: dict = {}
    for m in registry.metrics():
        if m.kind == "histogram":
            counts, hsum, hcount, _mn, _mx = m._state()
            h[m.name] = [counts, hsum, hcount]
            hb[m.name] = list(m.bounds)
        elif m.value is not None:
            s[m.name] = float(m.value)
    rec = {"t": t, "s": s}
    if h:
        rec["h"] = h
        rec["hb"] = hb
    return rec


def sample_from_snapshots(snapshots, t: float) -> dict:
    """One *federated* history record from the router's per-replica
    parsed scrapes: ``[(slug, PromSnapshot-or-None), ...]`` → every
    label-less replica series as ``<name>{replica="<slug>"}`` plus
    ``cluster:<name>:sum`` rollups (the federate() recording-rule
    names), so one store answers per-replica AND cluster questions.
    Bucket component series are skipped — per-replica percentile history
    lives in each replica's own store."""
    s: dict = {}
    sums: dict[str, float] = {}
    for slug, snap in snapshots:
        s[f'federation_source_up{{replica="{slug}"}}'] = (
            0.0 if snap is None else 1.0
        )
        if snap is None:
            continue
        for name, value in snap.flat().items():
            if name.endswith("_bucket"):
                continue
            s[f'{name}{{replica="{slug}"}}'] = value
            sums[name] = sums.get(name, 0.0) + value
    for name, value in sums.items():
        s[f"cluster:{name}:sum"] = value
    return {"t": t, "s": s}


class HistorySampler:
    """Background sampler: snapshots `registry` into `store` every
    `interval_s` on the injected clock. Owns the history health metrics
    (`history_samples_total`, `history_bytes` on /metricsz)."""

    def __init__(
        self,
        registry: MetricsRegistry,
        store: HistoryStore,
        *,
        interval_s: float = 1.0,
        clock: Callable[[], float] = now,
    ):
        self.registry = registry
        self.store = store
        self.interval_s = max(0.01, float(interval_s))
        self._clock = clock
        self._m_samples = registry.counter(
            "history.samples",
            help="Metric snapshots appended to the history store",
        )
        self._m_bytes = registry.gauge(
            "history.bytes",
            help="Total bytes held by the history store across tiers",
        )
        self._m_healed = registry.gauge(
            "history.healed_segments",
            help="Segments truncated or quarantined at the last open "
            "(torn + corrupt)",
        )
        hs = store.heal_stats
        self._m_healed.set(hs.get("torn", 0) + hs.get("corrupt", 0))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def sample_once(self, t: Optional[float] = None) -> dict:
        t = self._clock() if t is None else t
        rec = sample_registry(self.registry, t)
        self.store.append(rec)
        self._m_samples.inc()
        self._m_bytes.set(self.store.total_bytes())
        return rec

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample_once()
                except Exception:
                    pass  # sampling is advisory, never the request path

        self._thread = threading.Thread(
            target=loop, name="history-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)


# ----------------------------------------------------------- /queryz
def queryz_payload(
    store: Optional[HistoryStore], query: str
) -> tuple[int, dict]:
    """ONE /queryz contract across every surface that owns (or fronts) a
    history store — serving server, router, streams server. `query` is
    the raw URL query string. Without `series`, lists what's queryable."""
    if store is None:
        return 503, {"error": "history disabled"}
    params = {k: v[0] for k, v in parse_qs(query or "").items()}
    series = params.get("series")
    try:
        if not series:
            return 200, {
                "series": store.series_names(),
                "bytes": store.total_bytes(),
                "tiers": {
                    t: {
                        "segments": len(store._segments(t)),
                        "bytes": store.total_bytes(t),
                    }
                    for t in TIERS
                },
            }
        kw = {}
        for name in ("since", "until", "step", "last"):
            raw = params.get(name)
            if raw is not None:
                try:
                    kw[name] = float(raw)
                except ValueError:
                    raise BadQuery(
                        f"query param {name!r} must be a number, "
                        f"got {raw!r}"
                    ) from None
        return 200, store.query(
            series, agg=params.get("agg", "avg"), **kw
        )
    except BadQuery as e:
        return 400, {"error": str(e)}
    except Exception as e:  # noqa: BLE001 — surface, keep serving
        return 500, {"error": f"{type(e).__name__}: {e}"}
