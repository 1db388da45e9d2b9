"""Append-only, crash-consistent event log for the run store, an own copy
of `polyaxon_tpu/store/eventlog.py` (the port imports nothing of the JAX
package). The on-disk format is the reference's byte for byte: a store
written by either package reads back, heals and extends in the other.

One log per run under `runs/<uuid>/log/`, one global index under
`$POLYAXON_HOME/eventlog/`. Every control-plane mutation (create, status
transition, meta merge, tracked event, log pulse) is a length+CRC framed
JSON record stamped with a *globally monotonic* sequence number, so a
single cursor totally orders the whole store and `watch` consumers can
resume across writer restarts with no gaps and no duplicates.

Layout:
  runs/<uuid>/log/NNNNNN.seg   framed records; max-numbered file is live
  runs/<uuid>/log/snapshot.json  compaction snapshot {last_seq, records}
  runs/<uuid>/log/LEASE        flock: the single-writer lease for the run
  runs/<uuid>/log/INDEXED      last sequence number known to be indexed
  eventlog/index.seg           framed record copies + {"r": run} fan-in
  eventlog/index.lock          flock serializing ALL log mutations
  eventlog/SEQ                 next unallocated sequence number (hint)
  eventlog/INTENT              runs with a possibly part-indexed batch

Durability contract (`store/local.py::_read_json`'s, extended to the log):
  - a record is COMMITTED once `append` returns: its frame and its index
    entry are fsync'd (group commit — one fsync per touched file per
    batch, shared by every append that rode the batch);
  - a crash mid-append loses at most the uncommitted tail: recovery scans
    frames, truncates a torn tail (partial/bad frame at EOF), and
    quarantines a corrupt segment (bad frame with data after it) to
    `<seg>.corrupt` instead of wedging a poll;
  - a crash between the frame fsync and the index append cannot orphan a
    committed record: the batch's runs are written to INTENT (fsync'd)
    first, and every writer and reader heals INTENT before allocating or
    scanning, so legitimate index entries stay sequence-sorted and a
    monotonic-skip reader never misses one. Re-healed duplicates carry an
    already-delivered seq and are skipped by the same monotonic rule.

Ordering is by sequence number, never wall time: this module imports no
clock — callers inject `wall` (condition timestamps, for humans) and
`mono` (fsync latency + wait deadlines, for the shared telemetry
registry).
"""

from __future__ import annotations

import contextlib
import copy
import fcntl
import json
import logging
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

from ..chaos.injector import inject
from .framing import _HEADER, frame, scan_frames

logger = logging.getLogger(__name__)

# fsync latencies are milliseconds-shaped, not request-seconds-shaped
_FSYNC_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    1000.0,
)

# record kinds that change the derived run document
_DOC_KINDS = ("create", "status", "meta")


# In-process commit wakeups, keyed by store home so every EventLog facade
# over the same directory (store copies are cheap and common) shares one
# condition. Cross-process watchers fall back to a short stat poll.
_WAKE_LOCK = threading.Lock()
_WAKE: dict[str, threading.Condition] = {}


def _wake_cond(home: Path) -> threading.Condition:
    key = str(home)
    with _WAKE_LOCK:
        cond = _WAKE.get(key)
        if cond is None:
            cond = _WAKE[key] = threading.Condition()
        return cond


class _Slot:
    __slots__ = (
        "run", "kind", "body", "validate", "must_exist", "durable",
        "done", "result", "exc",
    )

    def __init__(self, run, kind, body, validate, must_exist, durable):
        self.run = run
        self.kind = kind
        self.body = body
        self.validate = validate
        self.must_exist = must_exist
        self.durable = durable
        self.done = threading.Event()
        self.result: Optional[dict] = None
        self.exc: Optional[BaseException] = None


class _Batcher:
    """Leader-based group commit. The first thread to win the leader lock
    drains the whole queue and flushes it as ONE batch; followers block on
    their slot and inherit the shared fsync."""

    def __init__(self, flush: Callable[[list], None]):
        self._flush = flush
        self._mutex = threading.Lock()
        self._leader = threading.Lock()
        self._queue: list[_Slot] = []
        self.batches = 0
        self.max_batch = 0

    def submit(self, slot: _Slot) -> dict:
        self._submit_many([slot])
        if slot.exc is not None:
            raise slot.exc
        return slot.result

    def submit_many(self, slots: list[_Slot]) -> list[dict]:
        self._submit_many(slots)
        for s in slots:
            if s.exc is not None:
                raise s.exc
        return [s.result for s in slots]

    def _submit_many(self, slots: list[_Slot]) -> None:
        with self._mutex:
            self._queue.extend(slots)
        with self._leader:
            if not slots[-1].done.is_set():
                with self._mutex:
                    batch, self._queue = self._queue, []
                self.batches += 1
                self.max_batch = max(self.max_batch, len(batch))
                try:
                    self._flush(batch)
                finally:
                    for s in batch:
                        s.done.set()
        for s in slots:
            s.done.wait()


class _RunState:
    __slots__ = (
        "records", "doc", "last_seq", "seg_no", "seg_size",
        "since_snapshot", "snap_last_seq", "sig",
    )

    def __init__(self):
        self.records: list[dict] = []
        self.doc: dict = {}
        self.last_seq = 0
        self.seg_no = 0
        self.seg_size = 0
        self.since_snapshot = 0
        self.snap_last_seq = 0
        self.sig: tuple = ()


class EventLog:
    """The store's single ordering authority. See module docstring."""

    def __init__(
        self,
        home: Path,
        *,
        wall: Callable[[], float],
        mono: Callable[[], float],
        fsync: Optional[bool] = None,
        compact_every: Optional[int] = None,
        view_writer: Optional[Callable[[str, dict], None]] = None,
    ):
        self.home = Path(home)
        self.runs_dir = self.home / "runs"
        self.dir = self.home / "eventlog"
        self._wall = wall
        self._mono = mono
        if fsync is None:
            fsync = os.environ.get("POLYAXON_EVENTLOG_FSYNC", "1") not in (
                "0", "false", "no",
            )
        self.fsync = fsync
        if compact_every is None:
            compact_every = int(
                os.environ.get("POLYAXON_EVENTLOG_COMPACT_EVERY", "512")
            )
        self.compact_every = compact_every
        self.view_writer = view_writer
        self._cache: dict[str, _RunState] = {}
        self._next_seq: Optional[int] = None
        # byte offset up to which THIS process has verified the index
        # clean (always a frame boundary). Heals scan only past it, so a
        # steady-state flush costs O(batch), not O(index). The index is
        # append+truncate-only, so bytes below a verified offset can only
        # vanish (size < offset), never change — checked on every heal.
        self._index_good = 0
        self._batcher = _Batcher(self._flush)
        # introspection for tests/benchmarks
        self.appends = 0
        self.fsyncs = 0
        from ..telemetry import get_registry

        reg = get_registry()
        self._m_appends = reg.counter(
            "store.appends", help="Event-log records committed"
        )
        self._m_fsync_ms = reg.histogram(
            "store.fsync_ms",
            buckets=_FSYNC_BUCKETS_MS,
            help="Event-log fsync latency (ms)",
        )
        self._m_recovered = reg.counter(
            "store.recovered_tails",
            help="Torn log tails truncated during recovery",
        )
        self._m_quarantined = reg.counter(
            "store.quarantined_segments",
            help="Corrupt log segments quarantined during recovery",
        )
        self._m_compactions = reg.counter(
            "store.compactions", help="Per-run log compactions"
        )
        self._m_lag = reg.gauge(
            "store.watch_cursor_lag",
            help="Head seq minus the last seq a watcher has consumed",
        )

    # ------------------------------------------------------------ paths
    def _log_dir(self, run: str) -> Path:
        return self.runs_dir / run / "log"

    @property
    def _index_path(self) -> Path:
        return self.dir / "index.seg"

    # ------------------------------------------------------------ locks
    @contextlib.contextmanager
    def _lease(self, run: str):
        """The run's single-writer lease. flock excludes per open file
        description, so this also serializes threads in one process. NOT
        reentrant — internal callees take `_locked=True` instead."""
        path = self._log_dir(run) / "LEASE"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    @contextlib.contextmanager
    def _index_lock(self):
        """Serializes every log mutation store-wide. Lock order is ALWAYS
        lease(s) (sorted by uuid) -> index lock, never the reverse."""
        self.dir.mkdir(parents=True, exist_ok=True)
        with open(self.dir / "index.lock", "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    # ------------------------------------------------------- small files
    def _write_small(self, path: Path, text: str, *, durable: bool) -> None:
        tmp = path.with_name(path.name + ".tmp")
        with tmp.open("w") as f:
            f.write(text)
            if durable and self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if durable and self.fsync:
            try:
                dfd = os.open(path.parent, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass

    @staticmethod
    def _read_int(path: Path) -> Optional[int]:
        try:
            return int(path.read_text().strip())
        except (OSError, ValueError):
            return None

    def _read_intent(self) -> list[str]:
        try:
            data = json.loads((self.dir / "INTENT").read_text())
            return [r for r in data if isinstance(r, str)]
        except (OSError, ValueError):
            return []

    # --------------------------------------------------------- run state
    def _sig(self, run: str) -> tuple:
        logdir = self._log_dir(run)
        parts = []
        try:
            with os.scandir(logdir) as it:
                for e in it:
                    if e.name.endswith(".seg") or e.name == "snapshot.json":
                        st = e.stat()
                        parts.append((e.name, st.st_size, st.st_mtime_ns))
        except OSError:
            return ()
        return tuple(sorted(parts))

    def _state(self, run: str) -> _RunState:
        """Load (or revalidate) a run's state. Callers hold the lease."""
        sig = self._sig(run)
        cached = self._cache.get(run)
        if cached is not None and cached.sig == sig:
            return cached
        st = self._load_state(run)
        st.sig = self._sig(run)  # recomputed: loading may have healed
        self._cache[run] = st
        return st

    def _load_state(self, run: str) -> _RunState:
        logdir = self._log_dir(run)
        st = _RunState()
        # a compaction that died before its atomic swap leaves a stray tmp
        with contextlib.suppress(OSError):
            (logdir / "snapshot.json.tmp").unlink()
        snap = self._read_snapshot(logdir / "snapshot.json")
        if snap:
            st.snap_last_seq = int(snap.get("last_seq", 0))
            st.records = list(snap.get("records", []))
            st.last_seq = st.snap_last_seq
        seg_paths = sorted(logdir.glob("[0-9]*.seg"))
        for seg in seg_paths:
            payloads = self._heal_segment(seg)
            for payload in payloads:
                try:
                    rec = json.loads(payload)
                except ValueError:
                    continue  # CRC-valid but undecodable: skip, don't wedge
                seq = int(rec.get("seq", 0))
                if seq <= st.snap_last_seq:
                    continue  # already captured by the snapshot
                st.records.append(rec)
                st.last_seq = max(st.last_seq, seq)
                st.since_snapshot += 1
        if seg_paths:
            live = seg_paths[-1]
            st.seg_no = int(live.stem)
            st.seg_size = live.stat().st_size if live.exists() else 0
        st.doc = self._derive(run, st.records)
        return st

    def _read_snapshot(self, path: Path) -> Optional[dict]:
        if not path.exists():
            return None
        try:
            data = json.loads(path.read_text())
            if isinstance(data, dict):
                return data
        except (ValueError, OSError):
            pass
        # same quarantine contract as _read_json: keep the bytes, move on
        quarantine = path.with_name(path.name + ".corrupt")
        with contextlib.suppress(OSError):
            os.replace(path, quarantine)
        logger.warning("eventlog: corrupt snapshot quarantined: %s", path)
        return None

    def _heal_segment(self, seg: Path) -> list[bytes]:
        """Scan one segment, repairing in place per the durability
        contract. Returns the valid payloads."""
        try:
            data = seg.read_bytes()
        except OSError:
            return []
        payloads, verdict, good_end = scan_frames(data)
        if verdict == "clean":
            return payloads
        if verdict == "corrupt":
            quarantine = seg.with_name(seg.name + ".corrupt")
            with contextlib.suppress(OSError):
                shutil.copyfile(seg, quarantine)
            self._m_quarantined.inc()
            logger.warning(
                "eventlog: corrupt segment %s quarantined to %s "
                "(keeping %d-byte valid prefix)",
                seg, quarantine, good_end,
            )
        else:
            self._m_recovered.inc()
            logger.warning(
                "eventlog: torn tail on %s truncated %d -> %d bytes",
                seg, len(data), good_end,
            )
        with open(seg, "r+b") as f:
            f.truncate(good_end)
            if self.fsync:
                os.fsync(f.fileno())
        return payloads

    def _derive(self, run: str, records: list[dict]) -> dict:
        doc: dict[str, Any] = {
            "uuid": run, "status": None, "conditions": [], "meta": {},
        }
        for rec in records:
            kind = rec.get("kind")
            if kind == "create":
                cond = rec.get("cond") or {}
                doc["status"] = cond.get("type")
                doc["conditions"].append(cond)
                doc["meta"].update(rec.get("meta") or {})
            elif kind == "status":
                doc["status"] = rec.get("status")
                if rec.get("cond"):
                    doc["conditions"].append(rec["cond"])
            elif kind == "meta":
                doc["meta"].update(rec.get("entries") or {})
        return doc

    # ------------------------------------------------------------- index
    def _scan_index(self) -> tuple[list[bytes], str, int]:
        try:
            data = self._index_path.read_bytes()
        except OSError:
            return [], "clean", 0
        return scan_frames(data)

    def _heal_index_locked(self) -> None:
        """Truncate a torn/bad index tail. Caller holds the index lock.
        Safe: every dropped entry is either re-healed from INTENT or was
        never acknowledged to a writer. Only the unverified tail (past
        `_index_good`) is scanned."""
        base = self._index_good
        try:
            size = self._index_path.stat().st_size
        except OSError:
            self._index_good = 0
            return
        if size < base:
            base = 0  # truncated below our watermark: re-verify everything
        if size == base:
            return
        try:
            with open(self._index_path, "rb") as f:
                f.seek(base)
                data = f.read()
        except OSError:
            return
        payloads, verdict, good_end = scan_frames(data)
        if verdict == "clean":
            self._index_good = base + good_end
            return
        if verdict == "corrupt":
            quarantine = self._index_path.with_name("index.seg.corrupt")
            with contextlib.suppress(OSError):
                shutil.copyfile(self._index_path, quarantine)
            self._m_quarantined.inc()
            logger.warning(
                "eventlog: corrupt index tail quarantined to %s", quarantine
            )
        else:
            self._m_recovered.inc()
        with open(self._index_path, "r+b") as f:
            f.truncate(base + good_end)
            if self.fsync:
                os.fsync(f.fileno())
        self._index_good = base + good_end

    def _index_max_seq_locked(self) -> int:
        payloads, _, _ = self._scan_index()
        top = 0
        for p in payloads:
            try:
                top = max(top, int(json.loads(p).get("seq", 0)))
            except ValueError:
                continue
        return top

    def _heal_intent_locked(self, intent: list[str]) -> None:
        """Re-index committed records whose batch died between the frame
        fsync and the index append. Caller holds the index lock; the dead
        writer's leases are free and every live writer serializes on the
        index lock we hold, so reading run segments lease-less is safe."""
        self._heal_index_locked()
        missing: list[dict] = []
        for run in intent:
            if not self._log_dir(run).is_dir():
                continue
            st = self._state(run)
            marker = self._read_int(self._log_dir(run) / "INDEXED") or 0
            for rec in st.records:
                if int(rec.get("seq", 0)) > marker:
                    missing.append({**rec, "r": run})
        if missing:
            missing.sort(key=lambda r: r["seq"])
            buf = b"".join(
                frame(json.dumps(r, default=str).encode()) for r in missing
            )
            with open(self._index_path, "ab") as f:
                f.write(buf)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            logger.warning(
                "eventlog: healed %d unindexed committed records from "
                "INTENT (%s)", len(missing), ",".join(r[:8] for r in intent),
            )
        for run in intent:
            if self._log_dir(run).is_dir():
                st = self._cache.get(run)
                if st is not None and st.last_seq:
                    self._write_small(
                        self._log_dir(run) / "INDEXED",
                        str(st.last_seq), durable=False,
                    )
        with contextlib.suppress(OSError):
            (self.dir / "INTENT").unlink()

    def heal(self) -> None:
        """Heal any interrupted batch. Cheap no-op when INTENT is clear.
        Called by every writer before committing and by readers before
        scanning, so a crash can never open a cursor gap."""
        if not self._read_intent():
            return
        with self._index_lock():
            intent = self._read_intent()
            if intent:
                self._heal_intent_locked(intent)

    # ------------------------------------------------------------ append
    def append(
        self,
        run: str,
        kind: str,
        body: dict,
        *,
        validate: Optional[Callable[[dict], None]] = None,
        must_exist: bool = False,
        durable: bool = True,
    ) -> dict:
        """Commit one record. Returns it (with its seq) once durable.

        `validate(doc)` runs under the run's lease against the *evolving*
        in-memory document — raising there (e.g. an illegal status
        transition) rejects only this record, atomically with respect to
        every concurrent append. This is what closes the old status.json
        read-modify-write race."""
        slot = _Slot(run, kind, body, validate, must_exist, durable)
        return self._batcher.submit(slot)

    def append_many(self, run: str, items: list[tuple[str, dict]]) -> list[dict]:
        """Commit several records for one run as a single batch (one
        fsync). Used by migration; skips per-record validation."""
        slots = [
            _Slot(run, kind, body, None, False, True) for kind, body in items
        ]
        return self._batcher.submit_many(slots)

    def _flush(self, batch: list[_Slot]) -> None:
        try:
            self._flush_inner(batch)
        except BaseException as exc:
            # the batch's in-memory state may be ahead of disk: poison the
            # cache so the next access re-reads (and heals) from disk, and
            # make sure no follower hangs without a result
            for s in batch:
                self._cache.pop(s.run, None)
                if s.exc is None and s.result is None:
                    s.exc = exc
            raise

    def _flush_inner(self, batch: list[_Slot]) -> None:
        self.heal()  # before OUR locks: healing takes leases itself
        runs = sorted({s.run for s in batch})
        with contextlib.ExitStack() as stack:
            for run in runs:
                stack.enter_context(self._lease(run))
            stack.enter_context(self._index_lock())
            # a writer that died after our heal() above still gets healed:
            # INTENT is re-checked under the lock every batch
            intent = self._read_intent()
            if intent:
                self._heal_intent_locked(intent)
            else:
                self._heal_index_locked()
            states = {run: self._state(run) for run in runs}
            # validate + stage records against the evolving docs
            staged: dict[str, list[dict]] = {run: [] for run in runs}
            accepted: list[_Slot] = []
            for s in batch:
                st = states[s.run]
                exists = bool(st.records or st.snap_last_seq)
                if s.must_exist and not exists:
                    s.exc = KeyError(f"unknown run {s.run}")
                    continue
                if s.validate is not None:
                    try:
                        s.validate(st.doc)
                    except BaseException as exc:  # noqa: BLE001
                        s.exc = exc
                        continue
                rec = {"kind": s.kind, "ts": self._wall(), **s.body}
                staged[s.run].append(rec)
                accepted.append(s)
                s.result = rec
            if not accepted:
                return
            # sequence allocation: in-memory high-water vs the SEQ hint vs
            # the index itself (scanned once per process)
            seq_hint = self._read_int(self.dir / "SEQ") or 1
            if self._next_seq is None:
                self._next_seq = max(self._index_max_seq_locked() + 1, 1)
            nxt = max(self._next_seq, seq_hint)
            for run in runs:
                if staged[run]:
                    nxt = max(nxt, states[run].last_seq + 1)
            total = sum(len(v) for v in staged.values())
            batch_durable = any(
                s.durable and s.kind != "log" for s in accepted
            )
            # publish intent BEFORE any frame hits a segment: if we die
            # between the segment fsync and the index fsync, the healer
            # knows exactly which runs may hold unindexed records. Pure
            # log-pulse batches are not durable by contract: no fsyncs.
            self._write_small(
                self.dir / "INTENT",
                json.dumps([r for r in runs if staged[r]]),
                durable=batch_durable,
            )
            self._write_small(self.dir / "SEQ", str(nxt + total), durable=False)
            index_buf = []
            for run in runs:
                if not staged[run]:
                    continue
                st = states[run]
                for rec in staged[run]:
                    rec["seq"] = nxt
                    nxt += 1
                    index_buf.append({**rec, "r": run})
                self._write_segment(run, st, staged[run])
            self._next_seq = nxt
            # one index append + fsync for the whole batch
            buf = b"".join(
                frame(json.dumps(r, default=str).encode()) for r in index_buf
            )
            with open(self._index_path, "ab") as f:
                f.write(buf)
                if self.fsync and batch_durable:
                    f.flush()
                    self._timed_fsync(f.fileno())
                # we hold the index lock and healed before appending, so
                # the whole file is verified through our own frames
                self._index_good = f.tell()
            inject("store.append.indexed", runs=",".join(runs))
            for run in runs:
                if staged[run]:
                    self._write_small(
                        self._log_dir(run) / "INDEXED",
                        str(states[run].last_seq),
                        durable=False,
                    )
            with contextlib.suppress(OSError):
                (self.dir / "INTENT").unlink()
            # commit point passed: fold into memory + views + compaction
            self.appends += total
            self._m_appends.inc(total)
            for run in runs:
                if not staged[run]:
                    continue
                st = states[run]
                st.sig = self._sig(run)
                if self.view_writer is not None:
                    if any(r["kind"] in _DOC_KINDS for r in staged[run]):
                        self.view_writer(run, st.doc)
                if st.since_snapshot >= self.compact_every:
                    self.compact(run, _locked=True)
        cond = _wake_cond(self.home)
        with cond:
            cond.notify_all()

    def _write_segment(
        self, run: str, st: _RunState, recs: list[dict]
    ) -> None:
        logdir = self._log_dir(run)
        if st.seg_no == 0:
            st.seg_no = 1
            st.seg_size = 0
        seg = logdir / f"{st.seg_no:06d}.seg"
        buf = b"".join(
            frame(json.dumps(r, default=str).encode()) for r in recs
        )
        inject(
            "store.append", run=run, seq=recs[0]["seq"], path=str(seg)
        )
        with open(seg, "ab") as f:
            f.write(buf)
            if self.fsync and self._batch_durable(recs):
                f.flush()
                self._timed_fsync(f.fileno())
        st.seg_size += len(buf)
        for rec in recs:
            st.records.append(rec)
            st.last_seq = rec["seq"]
            st.since_snapshot += 1
            self._apply(st.doc, rec)

    @staticmethod
    def _batch_durable(recs: list[dict]) -> bool:
        return any(r.get("kind") != "log" for r in recs)

    def _apply(self, doc: dict, rec: dict) -> None:
        kind = rec.get("kind")
        if kind == "create":
            cond = rec.get("cond") or {}
            doc["status"] = cond.get("type")
            doc["conditions"].append(cond)
            doc["meta"].update(rec.get("meta") or {})
        elif kind == "status":
            doc["status"] = rec.get("status")
            if rec.get("cond"):
                doc["conditions"].append(rec["cond"])
        elif kind == "meta":
            doc["meta"].update(rec.get("entries") or {})

    def _timed_fsync(self, fd: int) -> None:
        t0 = self._mono()
        os.fsync(fd)
        self._m_fsync_ms.observe((self._mono() - t0) * 1000.0)
        self.fsyncs += 1

    # -------------------------------------------------------- compaction
    def compact(self, run: str, *, _locked: bool = False) -> None:
        """Fold the run's segments into snapshot.json + a fresh live
        segment. Crash-safe: the snapshot lands via fsync'd atomic
        replace; replay skips segment records <= snapshot.last_seq, so
        dying in any window replays byte-identical history."""
        if not _locked:
            # index lock too: INTENT healers read run segments lease-less
            # under it, so every segment mutation must hold it
            with self._lease(run), self._index_lock():
                return self.compact(run, _locked=True)
        st = self._state(run)
        logdir = self._log_dir(run)
        kept = [r for r in st.records if r.get("kind") != "log"]
        snap = {"version": 1, "last_seq": st.last_seq, "records": kept}
        tmp = logdir / "snapshot.json.tmp"
        with tmp.open("w") as f:
            f.write(json.dumps(snap, default=str))
            if self.fsync:
                f.flush()
                self._timed_fsync(f.fileno())
        inject("store.compact", run=run, path=str(tmp))
        os.replace(tmp, logdir / "snapshot.json")
        inject("store.compact.swapped", run=run)
        old = sorted(logdir.glob("[0-9]*.seg"))
        st.seg_no += 1
        (logdir / f"{st.seg_no:06d}.seg").touch()
        for seg in old:
            with contextlib.suppress(OSError):
                seg.unlink()
        st.seg_size = 0
        st.since_snapshot = 0
        st.snap_last_seq = st.last_seq
        st.records = kept
        st.doc = self._derive(run, kept)
        st.sig = self._sig(run)
        self._m_compactions.inc()

    # ---------------------------------------------------------- recovery
    def recover_run(self, run: str) -> dict:
        """Re-scan one run's log from disk, repairing torn tails and
        quarantining corrupt segments, and refresh its materialized view.
        Idempotent. Returns the derived document."""
        with self._lease(run), self._index_lock():
            self._cache.pop(run, None)
            st = self._state(run)
            if self.view_writer is not None and (
                st.records or st.snap_last_seq
            ):
                self.view_writer(run, st.doc)
            return copy.deepcopy(st.doc)

    def recover_all(self) -> int:
        """Heal the whole store: interrupted batches first, then every
        run log. Returns the number of runs scanned."""
        self.heal()
        n = 0
        if not self.runs_dir.is_dir():
            return 0
        for entry in sorted(self.runs_dir.iterdir()):
            if (entry / "log").is_dir():
                self.recover_run(entry.name)
                n += 1
        return n

    # ------------------------------------------------------------- reads
    def has_run(self, run: str) -> bool:
        logdir = self._log_dir(run)
        if (logdir / "snapshot.json").exists():
            return True
        try:
            return any(
                e.name.endswith(".seg") and e.stat().st_size > 0
                for e in os.scandir(logdir)
            )
        except OSError:
            return False

    def doc(self, run: str) -> Optional[dict]:
        with self._lease(run), self._index_lock():
            st = self._state(run)
            if not (st.records or st.snap_last_seq):
                return None
            return copy.deepcopy(st.doc)

    def history(self, run: str) -> list[dict]:
        """Every committed record for the run (log pulses excluded), in
        sequence order — the byte-identical replay source."""
        with self._lease(run), self._index_lock():
            st = self._state(run)
            return [
                copy.deepcopy(r)
                for r in st.records
                if r.get("kind") != "log"
            ]

    def forget(self, run: str) -> None:
        self._cache.pop(run, None)

    # ----------------------------------------------------------- cursors
    def head_cursor(self) -> str:
        """Cursor at the current end of the index: watchers starting here
        see only events committed after this call."""
        try:
            size = self._index_path.stat().st_size
        except OSError:
            size = 0
        seq = self._read_int(self.dir / "SEQ")
        if seq is None:
            with self._index_lock():
                seq = self._index_max_seq_locked() + 1
        return f"{max(seq - 1, 0)}:{size}"

    def read_since(
        self, cursor: Optional[str] = None, limit: int = 10000
    ) -> tuple[list[dict], str]:
        """Ordered committed events after `cursor` (entire history when
        None), plus the cursor to resume from. Lock-free: the index is
        append-only, an in-flight tail frame just reads as EOF. Gap-free
        across crashes because INTENT healing runs before the scan."""
        if self._read_intent():
            self.heal()
        last_seq, off = 0, 0
        if cursor:
            try:
                a, b = str(cursor).split(":", 1)
                last_seq, off = int(a), int(b)
            except ValueError:
                last_seq, off = 0, 0
        try:
            data = self._index_path.read_bytes()
        except OSError:
            data = b""
        if off > len(data):
            off = 0  # index was rebuilt/shrunk: rescan, dedupe by seq
        payloads, verdict, good_end = scan_frames(data[off:])
        if verdict != "clean" and off and not payloads:
            # either a misaligned cursor (not a frame boundary — would
            # wedge forever) or a genuinely in-flight tail frame; both are
            # safe to full-rescan: the monotonic seq filter drops
            # duplicates, and an in-flight tail resolves to the same
            # boundary cursor it had before
            off = 0
            payloads, verdict, good_end = scan_frames(data)
        out: list[dict] = []
        pos = off
        for payload in payloads:
            pos += _HEADER.size + len(payload)
            try:
                rec = json.loads(payload)
            except ValueError:
                continue
            seq = int(rec.get("seq", 0))
            if seq <= last_seq:
                continue
            last_seq = seq
            out.append(rec)
            if len(out) >= limit:
                break
        return out, f"{last_seq}:{pos}"

    def wait(
        self,
        cursor: Optional[str] = None,
        timeout: float = 1.0,
        poll: float = 0.05,
    ) -> tuple[list[dict], str]:
        """Long-poll `read_since`: returns as soon as events exist, else
        after `timeout`. In-process commits wake this immediately via the
        shared condition; cross-process commits are caught by the short
        stat poll."""
        if cursor is None:
            cursor = self.head_cursor()
        entries, cur = self.read_since(cursor)
        if not entries and timeout > 0:
            cond = _wake_cond(self.home)
            deadline = self._mono() + timeout
            while not entries:
                remaining = deadline - self._mono()
                if remaining <= 0:
                    break
                with cond:
                    cond.wait(min(remaining, poll))
                entries, cur = self.read_since(cursor)
        try:
            head = int(self.head_cursor().split(":", 1)[0])
            self._m_lag.set(max(0, head - int(cur.split(":", 1)[0])))
        except ValueError:
            pass
        return entries, cur

    def watch(
        self,
        cursor: Optional[str] = None,
        *,
        timeout: float = 0.5,
        stop: Optional[Callable[[], bool]] = None,
    ) -> Iterator[dict]:
        """Yield ordered committed events forever (or until `stop()`),
        starting from `cursor` (entire history when None, falsy-but-set
        "now" semantics via head_cursor() are the caller's choice)."""
        cur = cursor if cursor is not None else "0:0"
        while True:
            entries, cur = self.wait(cur, timeout=timeout)
            yield from entries
            if stop is not None and stop():
                return

    # --------------------------------------------------------- migration
    def import_legacy(
        self,
        run: str,
        doc: dict,
        events: list[dict],
        *,
        name: str = "",
        project: str = "",
    ) -> int:
        """Replay a legacy status.json + events.jsonl into the log as one
        batch. No lifecycle validation: history is imported verbatim."""
        if self.has_run(run):
            return 0
        conds = list(doc.get("conditions") or [])
        status = doc.get("status")
        if not conds:
            conds = [{
                "type": status, "status": True, "reason": "migrated",
                "message": "", "ts": self._wall(),
            }]
        items: list[tuple[str, dict]] = [(
            "create",
            {
                "cond": conds[0],
                "meta": doc.get("meta") or {},
                "name": name,
                "project": project,
            },
        )]
        for cond in conds[1:]:
            items.append(("status", {"status": cond.get("type"), "cond": cond}))
        derived = conds[-1].get("type")
        if status and status != derived:
            items.append((
                "status",
                {
                    "status": status,
                    "cond": {
                        "type": status, "status": True,
                        "reason": "migrated", "message": "",
                        "ts": self._wall(),
                    },
                },
            ))
        for ev in events:
            items.append(("event", {"event": ev}))
        self.append_many(run, items)
        return len(items)
