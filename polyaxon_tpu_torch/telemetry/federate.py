"""Cluster metrics federation: ONE Prometheus text parser, ONE renderer
(an own copy of `polyaxon_tpu/telemetry/federate.py`).

Before this module every consumer of a `/metricsz` scrape hand-rolled
its own line regex (the router's queue-wait delta math being the worst
offender: a label-blind pattern that silently dropped every labeled
series). This module is the shared parser and the federation renderer
the cluster observability plane rides on:

* ``parse_prometheus_text`` understands the full 0.0.4 exposition
  surface our registries (and real exporters) emit: ``# TYPE``/``# HELP``
  comments, label sets with escaped values, histogram components
  (``_bucket{le="+Inf"}``, ``_sum``, ``_count``), ``NaN``/``+Inf``
  values. The result is a :class:`PromSnapshot` — an ordered list of
  (name, labels, value) samples with typed lookups.
* ``federate`` re-exports N scraped exposition texts as ONE text: every
  source's series gains an identity label (``replica="r0"`` on the
  router, ``source="agent"`` on the streams server), a per-source
  ``federation_source_up`` gauge records scrape health, and cluster
  aggregates land as recording-rule-style series
  (``cluster:<name>:sum``, plus ``cluster:<name>:max`` for
  gauge-shaped series) so one scrape answers both "which replica" and
  "how much in total".
* ``queue_wait_delta_ms`` is the router's balancing signal — the
  queue-wait mean over the window between two scrapes — computed from
  snapshot values instead of ad-hoc dict math.

NO clock in this module: federation is a
pure text transform. Scrape timing belongs to the caller (the router's
poll loop, on the telemetry clock); aggregation has no time axis at all.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional, Sequence

__all__ = [
    "PromSample",
    "PromSnapshot",
    "parse_prometheus_text",
    "render_sample",
    "federate",
    "queue_wait_delta_ms",
]

_SAMPLE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)"  # metric name
    r"(?:\{(.*)\})?"  # optional label set (lazy-parsed below)
    r"\s+"
    r"([+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN)"
    r"\s*(?:[0-9.e+-]+)?\s*$"  # optional timestamp, ignored
)
_LABEL = re.compile(r'\s*([A-Za-z_][A-Za-z0-9_]*)="((?:\\.|[^"\\])*)"\s*,?')
_TYPE_LINE = re.compile(r"^#\s*TYPE\s+(\S+)\s+(\S+)\s*$")
# histogram/summary component suffixes: counter-shaped, never max()'d
_COUNTER_SUFFIXES = ("_total", "_sum", "_count", "_bucket")

_UNESCAPE = {"\\\\": "\\", '\\"': '"', "\\n": "\n"}


def _unescape(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        pair = value[i : i + 2]
        if pair in _UNESCAPE:
            out.append(_UNESCAPE[pair])
            i += 2
        else:
            out.append(value[i])
            i += 1
    return "".join(out)


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class PromSample:
    """One exposition sample: name, label dict, float value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict[str, str], value: float):
        self.name = name
        self.labels = labels
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"PromSample({self.name!r}, {self.labels!r}, {self.value!r})"


class PromSnapshot:
    """Parsed exposition text: ordered samples + the ``# TYPE`` map."""

    def __init__(
        self, samples: list[PromSample], types: dict[str, str]
    ):
        self.samples = samples
        self.types = types

    def get(
        self, name: str, default: Optional[float] = None, **labels: str
    ) -> Optional[float]:
        """First sample matching ``name`` whose labels are a superset of
        the given ones (label-less lookup matches any label set)."""
        for s in self.samples:
            if s.name != name:
                continue
            if all(s.labels.get(k) == v for k, v in labels.items()):
                return s.value
        return default

    def value(self, name: str, default: float = 0.0, **labels: str) -> float:
        got = self.get(name, None, **labels)
        return default if got is None else got

    def flat(self) -> dict[str, float]:
        """Label-less name → value view (the legacy router parser's
        shape). Labeled samples are excluded — they were invisible to
        the old regex, and a flat dict cannot hold them losslessly."""
        return {s.name: s.value for s in self.samples if not s.labels}

    def names(self) -> list[str]:
        seen: dict[str, None] = {}
        for s in self.samples:
            seen.setdefault(s.name)
        return list(seen)

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self):
        return iter(self.samples)


def _parse_labels(raw: str) -> Optional[dict[str, str]]:
    labels: dict[str, str] = {}
    pos = 0
    for m in _LABEL.finditer(raw):
        if m.start() != pos:
            return None  # garbage between pairs: reject the line
        labels[m.group(1)] = _unescape(m.group(2))
        pos = m.end()
    if pos != len(raw.rstrip(", ")) and pos != len(raw):
        return None
    return labels


def parse_prometheus_text(text: str) -> PromSnapshot:
    """Parse Prometheus text exposition format 0.0.4.

    Tolerant by design — a scrape is operational data, not a config
    file: unparseable lines are skipped, never fatal. ``NaN`` and
    ``±Inf`` values parse to their float equivalents.
    """
    samples: list[PromSample] = []
    types: dict[str, str] = {}
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped:
            continue
        if stripped.startswith("#"):
            tm = _TYPE_LINE.match(stripped)
            if tm:
                types[tm.group(1)] = tm.group(2)
            continue
        m = _SAMPLE.match(stripped)
        if not m:
            continue
        labels: dict[str, str] = {}
        if m.group(2):
            parsed = _parse_labels(m.group(2))
            if parsed is None:
                continue
            labels = parsed
        try:
            value = float(m.group(3).replace("Inf", "inf"))
        except ValueError:
            continue
        samples.append(PromSample(m.group(1), labels, value))
    return PromSnapshot(samples, types)


def render_sample(
    name: str, labels: dict[str, str], value: float
) -> str:
    """One exposition line. Integral values render without a trailing
    .0 (matching registry.render_prometheus), ``le`` sorts last-stable
    so bucket series stay humanly diffable."""
    if labels:
        inner = ",".join(
            f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
        )
        head = f"{name}{{{inner}}}"
    else:
        head = name
    return f"{head} {_fmt_value(value)}"


def _fmt_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _is_counter_shaped(name: str, types: dict[str, str]) -> bool:
    if types.get(name) == "counter":
        return True
    base = name
    for suf in ("_bucket", "_sum", "_count"):
        if name.endswith(suf):
            base = name[: -len(suf)]
            break
    if types.get(base) == "histogram":
        return True
    return name.endswith(_COUNTER_SUFFIXES)


def federate(
    sources: Sequence[tuple[str, "Optional[str | PromSnapshot]"]],
    *,
    label: str = "replica",
    local_text: str = "",
    aggregate: bool = True,
    aggregate_prefix: str = "cluster",
) -> str:
    """Merge N scraped exposition texts into one federated text.

    ``sources`` is ``[(slug, text_or_snapshot_or_None), ...]`` — a
    source may be raw exposition text OR an already-parsed
    :class:`PromSnapshot` (the router's poll loop parses each scrape
    exactly once and hands the snapshot to the balancer, the stats
    rollup, and federation alike — no per-consumer re-parse). ``None``
    marks a failed scrape; the source still appears as
    ``federation_source_up{<label>="<slug>"} 0`` so an absent replica is
    visible, not silent. Every source sample is re-emitted with
    ``<label>="<slug>"`` merged into its labels (a pre-existing label of
    the same name is overwritten: the federation identity wins).

    With ``aggregate``, per-series cluster rollups land as
    ``<prefix>:<name>:sum`` (all series) and ``<prefix>:<name>:max``
    (gauge-shaped series only — a max over counters is noise), grouped
    by the series' remaining labels so histogram buckets aggregate
    per-``le``.

    Counter-reset hazard: ``<prefix>:<name>:sum`` over
    counter-shaped series is an *instantaneous* sum of cumulative
    values. When one source restarts, its counters drop to zero and the
    cluster sum DROPS — the aggregate is not itself a well-formed
    monotone counter. Consumers must never difference two ``:sum``
    readings naively; the history layer's ``rate_over``
    (telemetry/history.py) treats any decrease as a reset (the
    post-reset value is the increase) and annotates ``resets``, which is
    why the router records ``cluster:*`` series into history rather than
    rate-ing raw scrapes. Pinned by
    ``test_history.py::test_federated_cluster_sum_reset_clamp``.
    """
    out: list[str] = []
    if local_text:
        out.extend(local_text.rstrip("\n").splitlines())
    # (name, sorted label items) → [values across sources]
    groups: dict[tuple, list[float]] = {}
    types: dict[str, str] = {}
    for slug, text in sources:
        out.append(
            render_sample(
                "federation_source_up",
                {label: slug},
                0.0 if text is None else 1.0,
            )
        )
        if text is None:
            continue
        snap = (
            text
            if isinstance(text, PromSnapshot)
            else parse_prometheus_text(text)
        )
        types.update(snap.types)
        for s in snap.samples:
            merged = {**s.labels, label: slug}
            out.append(render_sample(s.name, merged, s.value))
            if aggregate:
                key = (s.name, tuple(sorted(s.labels.items())))
                groups.setdefault(key, []).append(s.value)
    if aggregate:
        for (name, label_items), values in groups.items():
            labels = dict(label_items)
            agg_base = f"{aggregate_prefix}:{name}"
            out.append(
                render_sample(f"{agg_base}:sum", labels, sum(values))
            )
            if not _is_counter_shaped(name, types):
                out.append(
                    render_sample(f"{agg_base}:max", labels, max(values))
                )
    return "\n".join(out) + ("\n" if out else "")


def queue_wait_delta_ms(
    snap: PromSnapshot, prev_sum: float, prev_count: float
) -> tuple[Optional[float], float, float]:
    """The router's balancing signal from one scrape: mean queue-wait
    (ms) over the observations since the previous scrape. Returns
    ``(delta_ms_or_None, new_sum, new_count)`` — None when no new
    observation landed (callers keep their EWMA untouched)."""
    wsum = snap.value("serving_queue_wait_seconds_sum")
    wcount = snap.value("serving_queue_wait_seconds_count")
    dc = wcount - prev_count
    if dc <= 0:
        return None, wsum, wcount
    return 1000.0 * (wsum - prev_sum) / dc, wsum, wcount


def sum_values(
    snapshots: Iterable[Optional[PromSnapshot]], name: str, **labels: str
) -> float:
    """Sum one series across snapshots (missing snapshots/series count
    as 0) — the `/statsz` cluster block's helper."""
    total = 0.0
    for snap in snapshots:
        if snap is not None:
            total += snap.value(name, 0.0, **labels)
    return total
