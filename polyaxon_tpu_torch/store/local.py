"""Local run store, an own copy of `polyaxon_tpu/store/local.py` (the port
imports nothing of the JAX package): the filesystem-backed control-plane
DB and artifact store. Its layout and formats are the reference's, so a
store that either package wrote reads back in the other.

Layout under $POLYAXON_HOME (default ~/.polyaxon):
  runs/<uuid>/spec.json      compiled operation (concrete, post-interpolation)
  runs/<uuid>/status.json    MATERIALIZED VIEW of the run's event log
  runs/<uuid>/log/           the run's event log (see store/eventlog.py)
  runs/<uuid>/metrics.jsonl  one JSON line per logged step
  runs/<uuid>/events.jsonl   non-metric tracked events (artifacts refs, ...)
  runs/<uuid>/logs.txt       captured run logs
  runs/<uuid>/outputs/       artifacts root (checkpoints/, profiler/, ...)
  index.jsonl                append-only run registry
  eventlog/                  global event index + watch cursors
  store_format               layout version stamp ("2" = event-log store)

The ordering authority for every lifecycle mutation is the
append-only event log (`store/eventlog.py`): status transitions, meta
merges, and tracked events commit there first (fsync'd group commit,
single-writer lease per run), and `status.json` is just a view the log
writes back for cheap polling — `get_status` never takes a lock. This
closes the old read-modify-write window in `set_status`: two concurrent
terminal transitions now serialize on the run's lease and exactly one
wins. Legacy dirs (pre-event-log) are migrated into the log on first
write (`_ensure_migrated`) or in bulk via `migrate()`.

Consumers should prefer the cursor API (`head_cursor` /
`read_events_since` / `wait_events` / `watch`) over `list_runs()`
polling: a cursor read is O(new events), a listing is O(runs).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Iterator, Optional

from ..schemas.lifecycle import V1Statuses, can_transition, is_done

logger = logging.getLogger(__name__)


class UnknownRunError(KeyError):
    """A run reference (uuid / prefix / name) matched nothing in the store.
    KeyError subclass: existing `except KeyError` callers keep working;
    the CLI catches THIS type so unrelated KeyErrors still traceback."""


def polyaxon_home() -> Path:
    """Env wins, then the user config file, then the default (settings.py)."""
    env = os.environ.get("POLYAXON_HOME")
    if env:
        return Path(env)
    from ..settings import get as _get_setting

    return Path(_get_setting("home"))


STORE_FORMAT = "2"


class RunStore:
    def __init__(
        self,
        home: Optional[Path | str] = None,
        *,
        eventlog_fsync: Optional[bool] = None,
    ):
        self.home = Path(home) if home else polyaxon_home()
        self.runs_dir = self.home / "runs"
        self.runs_dir.mkdir(parents=True, exist_ok=True)
        # a store with no pre-event-log runs to import was never format 1:
        # stamp it so `store migrate` on a fresh home is a visible no-op
        stamp = self.home / "store_format"
        if not stamp.exists() and not (self.home / "index.jsonl").exists():
            with contextlib.suppress(OSError):
                stamp.write_text(STORE_FORMAT + "\n")
        self._eventlog = None
        self._eventlog_fsync = eventlog_fsync
        # O(runs) listing counter (a steady-state consumer should never
        # grow it: cursors read O(new events))
        self.scans = 0

    # ----------------------------------------------------------- event log
    @property
    def eventlog(self):
        """The store's ordering authority (lazy: pure-read stores that
        never touch lifecycle state pay nothing)."""
        if self._eventlog is None:
            from ..telemetry import now as _mono
            from .eventlog import EventLog

            self._eventlog = EventLog(
                self.home,
                wall=time.time,
                mono=_mono,
                fsync=self._eventlog_fsync,
                view_writer=self._write_view,
            )
        return self._eventlog

    def _write_view(self, run_uuid: str, doc: dict) -> None:
        """status.json is a non-durable materialized view: atomic replace
        so readers never see a torn file, but no fsync — on crash the log
        is the truth and `recover()` refreshes the view."""
        run_dir = self.run_dir(run_uuid)
        run_dir.mkdir(parents=True, exist_ok=True)
        path = run_dir / "status.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(doc, indent=1, default=str))
        os.replace(tmp, path)

    def _ensure_migrated(
        self, run_uuid: str, *, name: str = "", project: str = ""
    ) -> bool:
        """Import a legacy (pre-event-log) run dir into the log on first
        touch. No-op for runs already in the log or brand-new runs."""
        log = self.eventlog
        if log.has_run(run_uuid):
            return False
        doc = _read_json(self.run_dir(run_uuid) / "status.json")
        if not doc or not doc.get("status"):
            return False
        events = _read_jsonl(self.run_dir(run_uuid) / "events.jsonl")
        log.import_legacy(
            run_uuid, doc, events, name=name, project=project
        )
        return True

    def migrate(self) -> int:
        """Bulk-import every legacy run dir into the event log and stamp
        the layout version. Idempotent. Returns the number migrated."""
        n = 0
        for rec in _read_jsonl(self.home / "index.jsonl"):
            if self._ensure_migrated(
                rec["uuid"],
                name=rec.get("name", ""),
                project=rec.get("project", ""),
            ):
                n += 1
        self.eventlog.recover_all()
        (self.home / "store_format").write_text(STORE_FORMAT + "\n")
        return n

    def store_format(self) -> str:
        path = self.home / "store_format"
        try:
            return path.read_text().strip()
        except OSError:
            return "1"

    # ----------------------------------------------------------- creation
    def create_run(
        self,
        run_uuid: str,
        name: str,
        project: str,
        spec: dict[str, Any],
        *,
        tags: Optional[list[str]] = None,
        meta: Optional[dict] = None,
    ) -> Path:
        run_dir = self.run_dir(run_uuid)
        if (run_dir / "status.json").exists() or self.eventlog.has_run(
            run_uuid
        ):
            # idempotent: agent-submitted runs are created at queue time and
            # hit the executor's create_run again at execution time
            return run_dir
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "outputs").mkdir(exist_ok=True)
        _write_json(run_dir / "spec.json", spec)
        self.eventlog.append(
            run_uuid,
            "create",
            {
                "cond": _condition(V1Statuses.CREATED),
                "meta": meta or {},
                "name": name,
                "project": project,
            },
        )
        with self._index_lock(), (self.home / "index.jsonl").open("a") as f:
            f.write(
                json.dumps(
                    {
                        "uuid": run_uuid,
                        "name": name,
                        "project": project,
                        "tags": tags or [],
                        "created_at": time.time(),
                    }
                )
                + "\n"
            )
        return run_dir

    def run_dir(self, run_uuid: str) -> Path:
        return self.runs_dir / run_uuid

    def outputs_dir(self, run_uuid: str) -> Path:
        return self.run_dir(run_uuid) / "outputs"

    # ----------------------------------------------------------- status
    def set_status(
        self, run_uuid: str, status: str, reason: str = "", message: str = ""
    ):
        self._ensure_migrated(run_uuid)

        def _validate(doc: dict) -> None:
            current = doc.get("status")
            if current and not can_transition(
                V1Statuses(current), V1Statuses(status)
            ):
                raise ValueError(
                    f"illegal status transition {current} → {status}"
                )

        # the event log is the single ordering authority: validation runs
        # under the run's writer lease against the log-derived document,
        # so two racing transitions serialize and exactly one commits —
        # the old status.json read-modify-write lost-update window is gone
        self.eventlog.append(
            run_uuid,
            "status",
            {"status": status, "cond": _condition(status, reason, message)},
            validate=_validate,
        )
        # the single transition choke point: every lifecycle move in this
        # process lands in the global registry (scraped at /metricsz)
        from ..telemetry import get_registry

        reg = get_registry()
        reg.counter(
            "runs.transitions", help="Run status transitions, all statuses"
        ).inc()
        reg.counter(f"runs.transitions.{V1Statuses(status).value}").inc()
        # chips never outlive the lifecycle: every terminal transition
        # drops the run's gang reservation, whichever process drove it there
        if is_done(V1Statuses(status)):
            self._release_reservation(run_uuid)

    def _release_reservation(self, run_uuid: str) -> None:
        """Drop the run's fleet reservation, if any. Guarded on the ledger
        file, so a store without a fleet pays no import and no lock."""
        if not (self.home / "fleet" / "reservations.json").exists():
            return
        from ..scheduler.fleet import Fleet

        try:
            Fleet(self).release(run_uuid)
        except Exception:  # noqa: BLE001
            pass  # a release failure never blocks a status transition

    def get_status(self, run_uuid: str) -> dict:
        return _read_json(self.run_dir(run_uuid) / "status.json") or {}

    def get_history(self, run_uuid: str) -> list[dict]:
        """The run's committed event-log records in sequence order — the
        byte-identical replay source chaos recovery is pinned against."""
        self._ensure_migrated(run_uuid)
        return self.eventlog.history(run_uuid)

    def timeline(self, run_uuid: str) -> list[dict]:
        """The run's causally ordered operator-facing timeline, folded
        from committed event-log records (transitions, retries,
        preemptions, elastic resizes, checkpoint tiers). One per-run log
        read — never a directory scan."""
        from .timeline import fold_timeline

        return fold_timeline(self.get_history(run_uuid))

    def recover(self, run_uuid: Optional[str] = None):
        """Crash recovery: heal interrupted batches, truncate torn tails,
        quarantine corrupt segments, refresh status.json views. One run,
        or the whole store when `run_uuid` is None."""
        if run_uuid is not None:
            return self.eventlog.recover_run(run_uuid)
        return self.eventlog.recover_all()

    def compact_run(self, run_uuid: str) -> None:
        self._ensure_migrated(run_uuid)
        self.eventlog.compact(run_uuid)

    # ----------------------------------------------------------- cursors
    def head_cursor(self) -> str:
        return self.eventlog.head_cursor()

    def read_events_since(
        self, cursor: Optional[str] = None, limit: int = 10000
    ) -> tuple[list[dict], str]:
        return self.eventlog.read_since(cursor, limit)

    def wait_events(
        self, cursor: Optional[str] = None, timeout: float = 1.0
    ) -> tuple[list[dict], str]:
        """Long-poll for committed events after `cursor` (from "now" when
        None). O(new events), never O(runs)."""
        return self.eventlog.wait(cursor, timeout=timeout)

    def watch(self, cursor: Optional[str] = None, **kw) -> Iterator[dict]:
        return self.eventlog.watch(cursor, **kw)

    def _index_lock(self):
        """Cross-process lock serializing index.jsonl appends and rewrites.
        A dedicated lock file (never replaced) avoids the stale-inode race
        of locking the index itself across os.replace."""
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def lock():
            with open(self.home / "index.lock", "w") as f:
                fcntl.flock(f, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(f, fcntl.LOCK_UN)

        return lock()

    def delete_run(self, run_uuid: str, *, cascade: bool = False) -> None:
        """Remove a run's directory, queue entries, and index entry. Refuses
        while the run is in an active state — stop it first. Data removal
        failures propagate BEFORE the index is touched (no silent orphans).

        Sweep runs own trial runs (meta.sweep lineage): deleting the sweep
        without `cascade` is refused rather than orphaning them, and with
        `cascade` every trial must be deletable BEFORE anything is removed
        (no half-deleted sweeps)."""
        from ..schemas.lifecycle import DONE_STATUSES

        def _deletable(uuid: str):
            status = self.get_status(uuid).get("status")
            if (
                status
                and status not in DONE_STATUSES
                and status != V1Statuses.CREATED
            ):
                raise ValueError(
                    f"run {uuid[:8]} is {status}; stop it before deleting"
                )

        _deletable(run_uuid)
        # only a SWEEP can own children — check the run's own spec before
        # paying the store-wide scan (ordinary deletes stay O(1))
        spec = self.read_spec(run_uuid)
        is_sweep = bool(
            spec.get("matrix")
            or (spec.get("operation") or {}).get("matrix")
        )
        if is_sweep:
            # list_runs() already folds status meta into each row — filter
            # on it directly instead of re-reading status.json per run
            children = [
                rec["uuid"]
                for rec in self.list_runs()
                if (rec.get("meta") or {}).get("sweep") == run_uuid
            ]
            if children:
                if not cascade:
                    raise ValueError(
                        f"run {run_uuid[:8]} is a sweep with "
                        f"{len(children)} trial runs; delete with cascade "
                        "to remove them too"
                    )
                for child in children:
                    _deletable(child)  # all-or-nothing: validate first
                for child in children:
                    # trials cannot themselves be sweeps: take the plain
                    # removal path, no per-child store scan
                    self._delete_one(child)
        self._delete_one(run_uuid)

    def _delete_one(self, run_uuid: str) -> None:
        """The removal core: queue entries, run dir, index entry. Callers
        have already validated deletability."""
        import shutil

        # a stopped-while-queued run still has a queue entry; without this a
        # draining agent would resurrect the deleted run
        from ..scheduler.queue import QueueRegistry

        registry = QueueRegistry(self)
        for name in registry.names():
            registry.get(name).remove(run_uuid)
        run_dir = self.run_dir(run_uuid)
        if run_dir.exists():
            shutil.rmtree(run_dir)  # errors propagate: index stays intact
        self.eventlog.forget(run_uuid)
        index = self.home / "index.jsonl"
        if index.exists():
            # under the shared index lock (held by create_run's append too)
            # + atomic replace: concurrent appends are never lost and a
            # crash mid-rewrite never truncates the index
            with self._index_lock():
                kept = [
                    rec
                    for rec in _read_jsonl(index)
                    if rec.get("uuid") != run_uuid
                ]
                tmp = index.with_suffix(".jsonl.tmp")
                tmp.write_text("".join(json.dumps(r) + "\n" for r in kept))
                os.replace(tmp, index)

    def set_meta(self, run_uuid: str, **entries):
        """Merge keys into the run's status meta (attempt counters etc.)."""
        self._ensure_migrated(run_uuid)
        self.eventlog.append(
            run_uuid, "meta", {"entries": entries}, must_exist=True
        )

    def request_stop(self, run_uuid: str) -> str:
        """Lifecycle-aware stop: RUNNING goes to STOPPING and stays there —
        whoever owns the process (executor at its next log point, reconciler
        for cluster gangs) observes it and settles STOPPED. Pre-run stages
        with no live process go straight to STOPPED. Terminal runs are left
        alone. Returns the resulting status."""
        from ..schemas.lifecycle import DONE_STATUSES

        current = V1Statuses(self.get_status(run_uuid)["status"])
        if current in DONE_STATUSES:
            return current
        if can_transition(current, V1Statuses.STOPPING):
            self.set_status(run_uuid, V1Statuses.STOPPING)
            return V1Statuses.STOPPING
        self.set_status(run_uuid, V1Statuses.STOPPED)
        return V1Statuses.STOPPED

    # ----------------------------------------------------------- events
    def log_metrics(self, run_uuid: str, step: int, metrics: dict[str, float]):
        line = json.dumps({"step": step, "ts": time.time(), **metrics})
        with (self.run_dir(run_uuid) / "metrics.jsonl").open("a") as f:
            f.write(line + "\n")

    def log_event(self, run_uuid: str, kind: str, body: dict[str, Any]):
        # migrate BEFORE the jsonl append so the new row isn't imported
        # twice; the legacy file write stays FIRST among writes so a
        # missing run dir still fails the old way (FileNotFoundError)
        self._ensure_migrated(run_uuid)
        line = {"kind": kind, "ts": time.time(), **body}
        with (self.run_dir(run_uuid) / "events.jsonl").open("a") as f:
            f.write(json.dumps(line) + "\n")
        self.eventlog.append(run_uuid, "event", {"event": line})

    def append_log(self, run_uuid: str, text: str):
        with (self.run_dir(run_uuid) / "logs.txt").open("a") as f:
            f.write(text if text.endswith("\n") else text + "\n")
        # a non-durable pulse: wakes watch cursors (live log tailing)
        # without paying an fsync per log line
        self.eventlog.append(
            run_uuid, "log", {"n": len(text)}, durable=False
        )

    # ----------------------------------------------------------- reads
    def read_metrics(self, run_uuid: str) -> list[dict]:
        return _read_jsonl(self.run_dir(run_uuid) / "metrics.jsonl")

    def read_events(self, run_uuid: str) -> list[dict]:
        return _read_jsonl(self.run_dir(run_uuid) / "events.jsonl")

    def read_logs(self, run_uuid: str) -> str:
        path = self.run_dir(run_uuid) / "logs.txt"
        return path.read_text() if path.exists() else ""

    def read_spec(self, run_uuid: str) -> dict:
        return _read_json(self.run_dir(run_uuid) / "spec.json") or {}

    def list_runs(self, project: Optional[str] = None) -> list[dict]:
        self.scans += 1
        out = []
        for rec in _read_jsonl(self.home / "index.jsonl"):
            if project and rec.get("project") != project:
                continue
            status = self.get_status(rec["uuid"])
            rec["status"] = status.get("status", "unknown")
            # status.json is already read: meta rides along for free —
            # listings can filter on lineage (sweep trials) without an
            # N+1 status fetch per run
            meta = status.get("meta")
            if meta:
                rec["meta"] = meta
            out.append(rec)
        return out

    def resolve(self, ref: str) -> str:
        """uuid, unique uuid prefix, or run name → uuid (latest match wins)."""
        runs = _read_jsonl(self.home / "index.jsonl")
        exact = [r for r in runs if r["uuid"] == ref]
        if exact:
            return ref
        by_prefix = [r for r in runs if r["uuid"].startswith(ref)]
        if len({r["uuid"] for r in by_prefix}) == 1:
            return by_prefix[0]["uuid"]
        by_name = [r for r in runs if r.get("name") == ref]
        if by_name:
            return by_name[-1]["uuid"]
        raise UnknownRunError(f"no run matching {ref!r}")

    def watch_logs(self, run_uuid: str, poll: float = 0.3) -> Iterator[str]:
        """Tail logs until the run reaches a terminal status. Between reads
        it blocks on the event log (woken by the
        run's non-durable log pulses) instead of sleeping blind."""
        path = self.run_dir(run_uuid) / "logs.txt"
        pos = 0
        cursor = self.eventlog.head_cursor()
        while True:
            if path.exists():
                with path.open() as f:
                    f.seek(pos)
                    chunk = f.read()
                    pos = f.tell()
                if chunk:
                    yield chunk
            status = self.get_status(run_uuid).get("status", "")
            try:
                if is_done(V1Statuses(status)):
                    break
            except ValueError:
                pass
            _, cursor = self.eventlog.wait(cursor, timeout=poll)


def _condition(status: str, reason: str = "", message: str = "") -> dict:
    return {
        "type": status,
        "status": True,
        "reason": reason,
        "message": message,
        "ts": time.time(),
    }


def _write_json(path: Path, data: dict):
    # crash-durable replace: the bytes must be on disk before the rename,
    # and the rename itself must survive a power cut — fsync the file,
    # then the parent directory entry
    tmp = path.with_suffix(".tmp")
    with tmp.open("w") as f:
        f.write(json.dumps(data, indent=1, default=str))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dir_fd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except OSError:
        # some filesystems (and platforms) refuse directory fsync; the
        # file-level fsync above already bounds the damage to a stale name
        pass


def _read_json(path: Path) -> Optional[dict]:
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        # a torn/garbled file must not wedge every status poll — quarantine
        # it (keeping the bytes for forensics) and report "nothing here"
        quarantine = path.with_name(path.name + ".corrupt")
        try:
            os.replace(path, quarantine)
        except OSError:
            quarantine = None
        logger.warning(
            "store: undecodable JSON at %s (%s)%s",
            path, e,
            f" — quarantined to {quarantine}" if quarantine else "",
        )
        return None


def _read_jsonl(path: Path) -> list[dict]:
    if not path.exists():
        return []
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out
