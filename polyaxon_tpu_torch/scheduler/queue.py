"""Persistent run queues, an own copy of `polyaxon_tpu/scheduler/queue.py`:
the control plane's pending-work list, which the agent drains and
`RunStore.delete_run` cleans.

The same files as the reference: `<home>/queues/<name>.jsonl` (one JSON
entry per line, flock'd around every mutation), `<name>.seq` (the queue's
monotonic counter) and `<home>/queues/config.json` (per-queue settings),
so a CLI submit in one process and an agent in another, of either
package, see one queue.

Entries are kept sorted by `(-priority, seq)`: `push` inserts with
`bisect.insort` on that key, and FIFO within a priority survives
remove/re-add cycles, since a run popped and re-enqueued (after an
eviction) takes a new `seq` and the untouched entries never reorder.
"""

from __future__ import annotations

import bisect
import fcntl
import json
import os
from pathlib import Path
from typing import Any, Optional

from ..store.local import RunStore
from .clock import WALL


def _order(entry: dict) -> tuple[int, int]:
    return (-int(entry.get("priority", 0)), int(entry.get("seq", 0)))


class RunQueue:
    def __init__(self, store: Optional[RunStore] = None, name: str = "default"):
        self.store = store or RunStore()
        self.name = name
        self.path = Path(self.store.home) / "queues" / f"{name}.jsonl"
        self.seq_path = self.path.with_suffix(".seq")
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
                # flushed before the unlock: a reader after it sees the update
                f.flush()
                os.fsync(f.fileno())
                return result
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def _next_seq(self) -> int:
        """The queue's monotonic counter, read and bumped under the queue
        file's lock; kept in a sidecar so a popped entry's number is never
        reused (a re-added run would jump the FIFO line)."""
        try:
            current = int(self.seq_path.read_text())
        except (OSError, ValueError):
            current = 0
        self.seq_path.write_text(str(current + 1))
        return current + 1

    def push(self, run_uuid: str, payload: dict[str, Any], priority: int = 0,
             **extra: Any) -> dict:
        """Enqueue; returns the stored entry. `extra` rides along in the
        entry (the agent stamps the `chips`/`min_chips`/`block` demand;
        `enqueued_at` defaults to the wall clock)."""

        def fn(entries):
            entry = {
                "uuid": run_uuid,
                "priority": int(priority),
                "seq": self._next_seq(),
                **extra,
                "payload": payload,
            }
            if "enqueued_at" not in entry:
                entry["enqueued_at"] = WALL.time()
            bisect.insort(entries, entry, key=_order)
            return entry, entries

        return self._locked(fn)

    def pop(self) -> Optional[dict]:
        """Claim the highest-priority entry (None when empty)."""

        def fn(entries):
            if not entries:
                return None, entries
            return entries[0], entries[1:]

        return self._locked(fn)

    def peek_all(self) -> list[dict]:
        """Every entry, without claiming any."""
        return self._locked(lambda entries: (list(entries), entries))

    def remove(self, run_uuid: str) -> bool:
        def fn(entries):
            kept = [e for e in entries if e["uuid"] != run_uuid]
            return len(kept) != len(entries), kept

        return self._locked(fn)

    def __len__(self) -> int:
        return len(self.peek_all())


class QueueRegistry:
    """Named queues with per-queue settings (`queues/config.json`); a
    queue exists once something is pushed to it, settings are optional."""

    _DEFAULTS = {"concurrency": 1, "priority": 0}

    def __init__(self, store: Optional[RunStore] = None):
        self.store = store or RunStore()
        self.dir = Path(self.store.home) / "queues"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.config_path = self.dir / "config.json"
        self._lock_path = self.dir / "config.lock"

    def config(self) -> dict[str, dict]:
        # writers replace the file atomically; a missing or corrupt file
        # reads as the defaults
        try:
            return json.loads(self.config_path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}

    def set_queue(self, name: str, *, concurrency: int = 1, priority: int = 0):
        """A locked read-modify-write and an atomic replace: concurrent
        `queues set` calls lose no update and expose no half-written file."""
        with open(self._lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                cfg = self.config()
                cfg[name] = {"concurrency": int(concurrency), "priority": int(priority)}
                tmp = self.config_path.with_suffix(".json.tmp")
                tmp.write_text(json.dumps(cfg, indent=1))
                os.replace(tmp, self.config_path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def settings(self, name: str, config: Optional[dict] = None) -> dict:
        cfg = self.config() if config is None else config
        return cfg.get(name, dict(self._DEFAULTS))

    def names(self, config: Optional[dict] = None) -> list[str]:
        """Configured queues and queues with a backing file, highest queue
        priority first (then by name)."""
        cfg = self.config() if config is None else config
        found = {p.stem for p in self.dir.glob("*.jsonl")} | set(cfg)
        return sorted(found, key=lambda n: (-self.settings(n, cfg).get("priority", 0), n))

    def get(self, name: str) -> RunQueue:
        return RunQueue(self.store, name=name)

    def stats(self) -> list[dict]:
        cfg = self.config()
        return [
            {"name": n, "pending": len(self.get(n)), **self.settings(n, cfg)}
            for n in self.names(cfg)
        ]
