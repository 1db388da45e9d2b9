"""`top`: a live terminal dashboard over the observability plane (an own
copy of `polyaxon_tpu/cli/top.py`). One frame joins:

- runs: seeded once from the store's committed event log
  (`read_events_since(None)`, an index read, never a directory scan) and
  advanced between frames by the watch cursor (`wait_events`), so a
  refresh costs the new events only;
- the router's federated `/statsz`: each replica's health, queue depth
  and wait, in-flight requests, and the cluster rollup;
- `/sloz`: the burn rate of each objective; `/queryz`: sparklines of the
  router's history.

Each frame is a list of lines, repainted after a clear every interval.
`--once` prints one frame with no escape codes (over a pipe too).
"""

from __future__ import annotations

import datetime
import json
import sys
from typing import Optional, TextIO
from urllib import request as urlrequest

from ..schemas.lifecycle import DONE_STATUSES, V1Statuses

#: statuses worth a line in the "active runs" pane, busiest first
_ACTIVE_ORDER = (
    "running", "starting", "compiled", "scheduled", "queued",
    "awaiting_cache", "resuming", "retrying", "stopping", "created",
)


def _fetch_json(url: str, timeout: float = 2.0) -> Optional[dict]:
    try:
        with urlrequest.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())
    except Exception:  # noqa: BLE001 — a dead surface is data, not a fault
        return None


class _RunTable:
    """uid → {status, name, project}, folded from the event log's records."""

    def __init__(self):
        self.runs: dict[str, dict] = {}

    def apply(self, records: list[dict]) -> None:
        for rec in records:
            uid = rec.get("r")
            if not uid:
                continue
            kind = rec.get("kind")
            if kind == "create":
                self.runs.setdefault(uid, {}).update(
                    name=rec.get("name"),
                    project=rec.get("project"),
                    status=V1Statuses.CREATED.value,
                )
            elif kind == "status":
                self.runs.setdefault(uid, {})["status"] = rec.get("status")

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.runs.values():
            s = str(r.get("status") or "unknown")
            out[s] = out.get(s, 0) + 1
        return out

    def active(self) -> list[tuple[str, dict]]:
        def _key(item):
            s = str(item[1].get("status") or "")
            return (
                _ACTIVE_ORDER.index(s) if s in _ACTIVE_ORDER else 99,
                item[0],
            )

        live = [
            (uid, r)
            for uid, r in self.runs.items()
            if not _is_done(r.get("status"))
        ]
        return sorted(live, key=_key)


def _is_done(status) -> bool:
    try:
        return V1Statuses(str(status)) in DONE_STATUSES
    except ValueError:
        return False


#: the sparkline columns: (label, series, agg) queried off the router's
#: federated /queryz; a pane with no data is left out
SPARK_SERIES = (
    ("req/s", "router.requests", "rate"),
    ("p95 s", "router.request_seconds", "p95"),
    ("queue", "router.replica_queue_depth.r0", "avg"),
)
_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: list, width: int = 32) -> str:
    """A point list scaled into block characters (None → a space)."""
    vals = list(values)[-width:]
    present = [v for v in vals if v is not None]
    if not present:
        return ""
    lo, hi = min(present), max(present)
    span = hi - lo
    out = []
    for v in vals:
        if v is None:
            out.append(" ")
            continue
        idx = (
            int((v - lo) / span * (len(_SPARK_BLOCKS) - 1))
            if span > 0
            else 0
        )
        out.append(_SPARK_BLOCKS[idx])
    return "".join(out)


def fetch_sparks(
    url: str, *, last: float = 120.0, step: float = 5.0
) -> Optional[list[tuple[str, list]]]:
    """The SPARK_SERIES windows off /queryz; None when the surface has no
    history (503) or is unreachable: the pane is left out, not drawn
    empty."""
    from urllib.parse import urlencode

    out = []
    for label, series, agg in SPARK_SERIES:
        q = urlencode(
            {"series": series, "agg": agg, "last": last, "step": step}
        )
        data = _fetch_json(f"{url}/queryz?{q}")
        if data is None or "points" not in data:
            continue
        pts = [v for _, v in data["points"]]
        if any(v is not None for v in pts):
            out.append((label, pts))
    return out or None


def _fmt(v, width: int = 0, nd: int = 1) -> str:
    if v is None:
        s = "-"
    elif isinstance(v, float):
        s = f"{v:.{nd}f}"
    else:
        s = str(v)
    return s.rjust(width) if width else s


def render_frame(
    *,
    url: str,
    fleet: Optional[dict],
    stats: Optional[dict],
    slo: Optional[dict],
    runs: _RunTable,
    when: Optional[str] = None,
    max_runs: int = 10,
    sparks: Optional[list[tuple[str, list]]] = None,
) -> str:
    """One frame of the dashboard as text, from its inputs alone."""
    lines: list[str] = []
    head = f"polyaxon top — {url}"
    if when:
        head += f"   {when}"
    lines.append(head)

    if fleet and fleet.get("configured"):
        lines.append(
            f"fleet    chips {fleet.get('chips_reserved', 0)}"
            f"/{fleet.get('chips_total', 0)} reserved"
            f"  ({len(fleet.get('reservations') or [])} gang(s))"
        )

    if stats is None:
        lines.append("router   unreachable")
    else:
        lat = (stats.get("latency_ms") or {})
        lines.append(
            f"router   req {stats.get('requests', 0)}"
            f"  retries {stats.get('retries', 0)}"
            f"  shed {stats.get('upstream_shed', 0)}"
            f"  errors {stats.get('errors', 0)}"
            f"  p95 {_fmt(lat.get('p95'))} ms"
            f"  routable {stats.get('routable', 0)}"
            f"/{len(stats.get('replicas') or [])}"
        )
        cluster = stats.get("cluster") or {}
        if cluster:
            lines.append(
                f"cluster  queue {_fmt(cluster.get('queue_depth'), nd=0)}"
                f"  inflight {cluster.get('inflight', 0)}"
                f"  wait_max {_fmt(cluster.get('queue_wait_ms_max'))} ms"
                f"  served {_fmt(cluster.get('serving_requests'), nd=0)}"
                f"  shed {_fmt(cluster.get('serving_shed'), nd=0)}"
                + ("" if cluster.get("federation", True) else
                   "  [federation off]")
            )
        replicas = stats.get("replicas") or []
        if replicas:
            lines.append(
                "  replica    state      queue   wait_ms  inflight  requests"
            )
            for r in replicas:
                state = (
                    "draining" if r.get("draining")
                    else "up" if r.get("healthy") else "down"
                )
                lines.append(
                    f"  {str(r.get('slug', '?')):<9}  {state:<9}"
                    f"{_fmt(r.get('queue_depth'), 7, nd=0)}"
                    f"{_fmt(r.get('queue_wait_ms'), 10)}"
                    f"{_fmt(r.get('inflight'), 10)}"
                    f"{_fmt(r.get('requests'), 10)}"
                )

    if sparks:
        # the router's metrics history (/queryz): one sparkline a series,
        # the newest point on the right
        for i, (label, pts) in enumerate(sparks):
            latest = next(
                (v for v in reversed(pts) if v is not None), None
            )
            lines.append(
                ("history  " if i == 0 else "         ")
                + f"{label:<7} {sparkline(pts):<32}"
                + f"  now {_fmt(latest, nd=3)}"
            )

    if slo and slo.get("slos"):
        lines.append(
            "slo      " + "   ".join(
                f"{s.get('name', '?')}"
                f" burn {_fmt(s.get('burn_rate'), nd=2)}"
                + (" BREACHED" if s.get("breached") else "")
                for s in slo["slos"]
            )
        )

    counts = runs.counts()
    if counts:
        lines.append(
            "runs     " + "  ".join(
                f"{k}:{counts[k]}" for k in sorted(counts)
            )
        )
    active = runs.active()
    for uid, r in active[:max_runs]:
        name = r.get("name") or ""
        proj = r.get("project") or ""
        ref = f"{proj}/{name}" if proj and name else (name or uid[:12])
        lines.append(
            f"  {uid[:12]}  {str(r.get('status') or '?'):<12} {ref}"
        )
    if len(active) > max_runs:
        lines.append(f"  ... and {len(active) - max_runs} more active")
    return "\n".join(lines)


def run_top(
    store,
    url: str,
    *,
    interval: float = 2.0,
    once: bool = False,
    out: Optional[TextIO] = None,
) -> None:
    """The dashboard's loop; `once` prints one frame without escape
    codes (for a pipe)."""
    out = out or sys.stdout
    runs = _RunTable()
    # seeded from the committed log: one index read, no directory scan
    records, cursor = store.read_events_since(None)
    runs.apply(records)
    while True:
        fleet = None
        try:
            from ..scheduler.fleet import Fleet

            snap = Fleet(store).snapshot()
            fleet = snap if snap.get("configured") else None
        except Exception:  # noqa: BLE001 — fleet pane is optional
            fleet = None
        frame = render_frame(
            url=url,
            fleet=fleet,
            stats=_fetch_json(url + "/statsz"),
            slo=_fetch_json(url + "/sloz"),
            runs=runs,
            when=datetime.datetime.now().strftime("%H:%M:%S"),
            sparks=fetch_sparks(url),
        )
        if once:
            out.write(frame + "\n")
            out.flush()
            return
        out.write("\x1b[2J\x1b[H" + frame + "\n")
        out.flush()
        try:
            # the refresh interval bounds the watch's long-poll: a commit
            # wakes the frame early, an idle store costs one poll
            records, cursor = store.wait_events(cursor, timeout=interval)
        except KeyboardInterrupt:
            return
        runs.apply(records)
