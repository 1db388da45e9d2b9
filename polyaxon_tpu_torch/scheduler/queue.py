"""Persistent run queues: the part of `polyaxon_tpu/scheduler/queue.py`
that `RunStore.delete_run` reads (an own copy; the port imports nothing of
the JAX package). A deleted run must leave no queue entry behind, or a
draining agent of either package would resurrect it.

Same files as the reference: `<home>/queues/<name>.jsonl` (one JSON entry
per line, flock'd around every mutation) and `<home>/queues/config.json`
(per-queue settings). Pushing and claiming entries belong to the agent,
which is not ported; `peek_all` reads them.
"""

from __future__ import annotations

import fcntl
import json
import os
from pathlib import Path
from typing import Optional


class RunQueue:
    def __init__(self, store, name: str = "default"):
        self.store = store
        self.name = name
        self.path = Path(self.store.home) / "queues" / f"{name}.jsonl"
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

    def peek_all(self) -> list[dict]:
        """Every entry, without claiming any (what `stats` shows of a
        queued run)."""
        return self._locked(lambda entries: (list(entries), entries))

    def remove(self, run_uuid: str) -> bool:
        def fn(entries):
            kept = [e for e in entries if e["uuid"] != run_uuid]
            return len(kept) != len(entries), kept

        return self._locked(fn)


class QueueRegistry:
    """Named queues: configured ones (`queues/config.json`) and those with
    a backing file, highest queue priority first."""

    _DEFAULTS = {"concurrency": 1, "priority": 0}

    def __init__(self, store):
        self.store = store
        self.dir = Path(self.store.home) / "queues"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.config_path = self.dir / "config.json"

    def config(self) -> dict[str, dict]:
        try:
            return json.loads(self.config_path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}

    def settings(self, name: str, config: Optional[dict] = None) -> dict:
        cfg = self.config() if config is None else config
        return cfg.get(name, dict(self._DEFAULTS))

    def names(self, config: Optional[dict] = None) -> list[str]:
        cfg = self.config() if config is None else config
        found = {p.stem for p in self.dir.glob("*.jsonl")} | set(cfg)
        return sorted(
            found, key=lambda n: (-self.settings(n, cfg).get("priority", 0), n)
        )

    def get(self, name: str) -> RunQueue:
        return RunQueue(self.store, name=name)
