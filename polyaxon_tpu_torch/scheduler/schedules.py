"""Schedule execution, an own copy of `polyaxon_tpu/scheduler/schedules.py`:
cron, interval and datetime operations (`schedule:` on an operation).

A file-backed registry (`<home>/schedules.jsonl`, the queue's pattern)
and a `tick` the agent calls each poll: due schedules enqueue a fresh run
and advance their next fire time.

The cron matcher takes the standard 5 fields with `*`, lists, ranges and
`*/n` steps, evaluated minute by minute (schedules fire at minute
granularity).
"""

from __future__ import annotations

import datetime as dt
import fcntl
import json
from pathlib import Path
from typing import Optional

from ..schemas.operation import V1Operation, V1Schedule
from ..store.local import RunStore


class ScheduleError(Exception):
    pass


# ------------------------------------------------------------------ cron
def _parse_field(field: str, lo: int, hi: int) -> set[int]:
    values: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        if not (lo <= start <= hi and lo <= end <= hi):
            raise ScheduleError(f"cron field value out of range [{lo},{hi}]: {part!r}")
        values.update(range(start, end + 1, step))
    return values


def cron_matches(expr: str, when: dt.datetime) -> bool:
    parts = expr.split()
    if len(parts) != 5:
        raise ScheduleError(f"cron needs 5 fields, got {expr!r}")
    minute, hour, dom, month, dow = parts
    if not (
        when.minute in _parse_field(minute, 0, 59)
        and when.hour in _parse_field(hour, 0, 23)
        and when.month in _parse_field(month, 1, 12)
    ):
        return False
    dom_ok = when.day in _parse_field(dom, 1, 31)
    # cron dow: 0 and 7 are Sunday; python weekday(): Monday=0
    dow_ok = ((when.weekday() + 1) % 7) in {v % 7 for v in _parse_field(dow, 0, 7)}
    # standard cron: when BOTH dom and dow are restricted, either matching
    # fires; otherwise both (trivially true for the '*' one) must hold
    if dom != "*" and dow != "*":
        return dom_ok or dow_ok
    return dom_ok and dow_ok


def next_cron_time(expr: str, after: dt.datetime) -> dt.datetime:
    """First matching minute strictly after `after` (scans ≤ 4 years)."""
    t = after.replace(second=0, microsecond=0) + dt.timedelta(minutes=1)
    for _ in range(4 * 366 * 24 * 60):
        if cron_matches(expr, t):
            return t
        t += dt.timedelta(minutes=1)
    raise ScheduleError(f"cron {expr!r} never fires")


def next_fire_time(
    schedule: V1Schedule, after: dt.datetime, last: Optional[dt.datetime]
) -> Optional[dt.datetime]:
    """None = schedule exhausted."""
    end = dt.datetime.fromisoformat(schedule.end_at) if schedule.end_at else None
    start = dt.datetime.fromisoformat(schedule.start_at) if schedule.start_at else None
    if schedule.kind == "cron":
        if not schedule.cron:
            raise ScheduleError("cron schedule needs `cron`")
        base = max(after, start) if start else after
        t = next_cron_time(schedule.cron, base)
    elif schedule.kind == "interval":
        if not schedule.frequency:
            raise ScheduleError("interval schedule needs `frequency` seconds")
        anchor = last or start or after
        t = anchor + dt.timedelta(seconds=schedule.frequency)
        if t <= after:
            t = after + dt.timedelta(seconds=1)
    elif schedule.kind == "datetime":
        if not schedule.start_at:
            raise ScheduleError("datetime schedule needs `startAt`")
        t = start
        if last is not None:  # one-shot already fired
            return None
    else:
        raise ScheduleError(f"unknown schedule kind {schedule.kind!r}")
    if end and t > end:
        return None
    return t


# ------------------------------------------------------------------ registry
class ScheduleRegistry:
    """Persisted scheduled operations; `tick()` enqueues due runs."""

    def __init__(self, store: Optional[RunStore] = None):
        self.store = store or RunStore()
        self.path = Path(self.store.home) / "schedules.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.touch(exist_ok=True)

    def _locked(self, fn):
        with open(self.path, "r+") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                entries = [json.loads(line) for line in f if line.strip()]
                result, entries = fn(entries)
                f.seek(0)
                f.truncate()
                for e in entries:
                    f.write(json.dumps(e) + "\n")
                return result
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def add(self, op: V1Operation, *, project: str = "default") -> str:
        if op.schedule is None:
            raise ScheduleError("operation has no schedule")
        import uuid as _uuid

        sid = _uuid.uuid4().hex[:12]
        now = dt.datetime.now()
        first = next_fire_time(op.schedule, now, None)
        entry = {
            "id": sid,
            "project": project,
            "operation": op.to_dict(),
            "next_at": first.isoformat() if first else None,
            "last_at": None,
            "runs": 0,
        }
        self._locked(lambda entries: (None, entries + [entry]))
        return sid

    def remove(self, sid: str) -> bool:
        def fn(entries):
            kept = [e for e in entries if e["id"] != sid]
            return len(kept) != len(entries), kept

        return self._locked(fn)

    def list(self) -> list[dict]:
        return self._locked(lambda entries: (list(entries), entries))

    def tick(self, agent, now: Optional[dt.datetime] = None) -> int:
        """Enqueue every due schedule; returns the number fired.

        The registry update (advancing next_at/runs) commits INSIDE the
        lock, before any submission runs — a failing submit must not roll
        back other schedules' state, or every tick would resubmit them."""
        now = now or dt.datetime.now()
        to_submit: list[tuple[V1Operation, str, str]] = []

        def fn(entries):
            kept = []
            for e in entries:
                if e["next_at"] is None:
                    continue  # exhausted: drop
                due = dt.datetime.fromisoformat(e["next_at"])
                op = V1Operation.from_dict(e["operation"])
                sched = op.schedule
                if due <= now:
                    if not (sched.max_runs and e["runs"] >= sched.max_runs):
                        to_submit.append(
                            (
                                op.copy(schedule=None),
                                e.get("project", "default"),
                                e["id"],
                            )
                        )
                        e["runs"] += 1
                        e["last_at"] = due.isoformat()
                    if sched.max_runs and e["runs"] >= sched.max_runs:
                        continue  # drop exhausted
                    nxt = next_fire_time(sched, now, due)
                    if nxt is None:
                        continue
                    e["next_at"] = nxt.isoformat()
                kept.append(e)
            return None, kept

        self._locked(fn)
        fired = 0
        for op, project, sid in to_submit:
            try:
                agent.submit(op, project=project)
                fired += 1
            except Exception as e:  # noqa: BLE001 — one bad schedule, not the tick
                print(f"schedule {sid}: submit failed: {e}")
        return fired
