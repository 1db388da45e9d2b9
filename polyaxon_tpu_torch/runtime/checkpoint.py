"""Checkpoints and resume in a torch format, with the semantics of
`polyaxon_tpu/runtime/checkpoint.py` (Orbax there).

Layout: one directory per step, `<directory>/<step>/state.pt`, written as
`<step>.saving/` and renamed when complete (file and directories fsynced),
so a torn write is never listed. The payload holds tensors, ints, floats,
strings, None, dicts and lists only: `torch.load(weights_only=True)` reads
it.

Saves are asynchronous as Orbax's are: `save` snapshots the state's
tensors with a clone on their own device (for CUDA tensors an enqueued
device-to-device copy, ordered after the step that made them on the
current stream), and a background thread copies the clone to the host,
writes, fsyncs and renames it. The step loop pays the snapshot only. One
save is in flight per directory: a save waits for the one before it. As
with Orbax's `should_save`, a save of a step at or below the newest saved
(or in-flight) step is a no-op. `max_to_keep` (`keep`, default 3) prunes
the oldest steps after each write.

Restore loads into the tensors of a target of the same structure
(`copy_`), on their device and in place, so whatever holds those tensors
(the optimizer's parameters and state) keeps them; a DTensor target (the
trainer's mesh) takes its rank's shard of the full tensor. A step whose restore
raises is quarantined: renamed to `<step>.corrupt`, the rename fsynced
through the parent directory.

Two tiers (`CheckpointTiers`): with a local tier (`train.checkpointLocalDir`,
host SSD) every boundary save lands there first and a background uploader
replicates finished steps to the durable tier (the run's outputs): copy to
`<step>.uploading`, fsync, then an atomic rename. Restore searches the
union of both tiers newest first, preferring the durable copy of a step and
falling back to the local one, quarantining per tier.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
from typing import Any, Optional

import torch

from ..telemetry import get_registry, now

STATE_FILE = "state.pt"
_SAVING_SUFFIX = ".saving"
_UPLOAD_SUFFIX = ".uploading"
DEFAULT_KEEP = 3


def _steps_on_disk(directory: str) -> list[int]:
    try:
        return sorted(int(n) for n in os.listdir(directory) if n.isdigit())
    except OSError:
        return []


def _map_tensors(fn, tree):
    """`tree` with `fn` applied to every tensor (dicts, lists and tuples
    rebuilt; other leaves as they are)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _to_host_in_place(tree, stream) -> None:
    """Replace each CUDA tensor in the dicts and lists of `tree` by its host
    copy, one at a time, so each device clone is freed once copied."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                with torch.cuda.stream(stream):
                    tree[k] = v.to("cpu")
        elif isinstance(v, (dict, list)):
            _to_host_in_place(v, stream)
        elif isinstance(v, tuple):
            host = list(v)
            _to_host_in_place(host, stream)
            tree[k] = tuple(host)


class CheckpointManager:
    """The saves of one directory: one in flight at a time, written by a
    background thread. A failed write raises from the next `save` and
    from every `wait_until_finished` until then."""

    def __init__(self, directory: str, keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.keep = keep or DEFAULT_KEEP
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._held: set[int] = set()

    # ------------------------------------------------------------ steps
    def all_steps(self) -> list[int]:
        return _steps_on_disk(self.directory)

    @property
    def pending_step(self) -> Optional[int]:
        return self._pending

    def latest_step(self) -> Optional[int]:
        """Newest step saved or being saved."""
        steps = self.all_steps()
        pending = self._pending
        if pending is not None:
            steps.append(pending)
        return max(steps) if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        return latest is None or step > latest

    # ------------------------------------------------------------- save
    def save(self, step: int, state) -> bool:
        """Start saving `state` as `step`; False (and nothing written) when
        `step` is not newer than the newest step."""
        if not self.should_save(step):
            return False
        self._join()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err
        snapshot = _map_tensors(lambda t: t.detach().clone(), state)
        ready = None
        cuda = [t for t in _leaves(snapshot) if t.is_cuda]
        if cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda[0].device))
        self._pending = step
        thread = threading.Thread(
            target=self._write, args=(step, snapshot, ready, cuda[0].device if cuda else None),
            name=f"ckpt-write-{step}", daemon=True,
        )
        # published only once started, under the lock `_join` reads it
        # with: an uploader joining in between would otherwise join a
        # thread that has not started and raise
        with self._lock:
            thread.start()
            self._thread = thread
        return True

    def _join(self) -> None:
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()

    def wait_until_finished(self) -> None:
        """Barrier on the save in flight; raises its error if it failed."""
        self._join()
        with self._lock:
            err = self._error
        if err is not None:
            raise err

    def _write(self, step: int, snapshot, ready, device) -> None:
        t0 = now()
        tmp = os.path.join(self.directory, f"{step}{_SAVING_SUFFIX}")
        try:
            if ready is not None:
                stream = torch.cuda.Stream(device)
                stream.wait_event(ready)
                _to_host_in_place(snapshot, stream)
                get_registry().histogram(
                    "checkpoint.host_copy_seconds",
                    help="Device-to-host copy of one checkpoint's snapshot (part of the write)",
                ).observe(now() - t0)
            os.makedirs(self.directory, exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(snapshot, f)
                f.flush()
                os.fsync(f.fileno())
            del snapshot
            _fsync_dir(tmp)
            os.rename(tmp, os.path.join(self.directory, str(step)))
            _fsync_dir(self.directory)
            get_registry().histogram(
                "checkpoint.write_seconds",
                help="Background write of one checkpoint step: host copy, save, fsync, rename",
            ).observe(now() - t0)
            self._prune()
        except BaseException as e:  # noqa: BLE001 — raised at the next save/wait
            shutil.rmtree(tmp, ignore_errors=True)
            with self._lock:
                self._error = e
        finally:
            self._pending = None

    # -------------------------------------------------------- retention
    def hold(self, step: int) -> None:
        """Keep `step` from being pruned until `release(step)` (a step
        queued for upload to another tier)."""
        with self._lock:
            self._held.add(step)

    def release(self, step: int) -> None:
        with self._lock:
            self._held.discard(step)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        with self._lock:
            drop = [s for s in steps[:-self.keep] if s not in self._held]
        for s in drop:
            shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)

    def close(self) -> None:
        self._join()


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


# ------------------------------------------------------ manager cache
_manager_lock = threading.Lock()
# directory -> (manager, the keep it was built with)
_managers: dict[str, tuple[CheckpointManager, int]] = {}


def _manager(directory: str, keep: Optional[int] = None) -> CheckpointManager:
    """One manager per directory. A `keep` that disagrees with the cached
    manager's flushes and rebuilds it, so retention follows the latest
    caller's spec."""
    directory = os.path.abspath(directory)
    with _manager_lock:
        cached = _managers.get(directory)
        if cached is not None:
            mgr, pinned = cached
            if keep is None or keep == pinned:
                return mgr
            try:
                mgr.wait_until_finished()
            except Exception:  # noqa: BLE001 — a failed flush cannot block the rebuild
                pass
        mgr = CheckpointManager(directory, keep)
        _managers[directory] = (mgr, mgr.keep)
        return mgr


def _cached_manager(directory: str) -> Optional[CheckpointManager]:
    cached = _managers.get(os.path.abspath(directory))
    return cached[0] if cached else None


def save_checkpoint(
    directory: str, step: int, state, *, wait: bool = False, keep: Optional[int] = None
) -> bool:
    """Save `state` as `step` in the background; True when a save started
    (False: `step` is not newer than the newest step)."""
    from ..chaos.injector import inject

    mgr = _manager(directory, keep=keep)
    saved = mgr.save(step, state)
    if saved:
        inject("checkpoint.save", step=step, directory=directory, manager=mgr)
    if wait:
        mgr.wait_until_finished()
    return saved


def all_steps(directory: str) -> list[int]:
    """Complete checkpoint steps, ascending (empty when no directory)."""
    return _steps_on_disk(directory) if directory else []


def latest_step(directory: str) -> Optional[int]:
    """Newest step saved or being saved, or None."""
    mgr = _cached_manager(directory) if directory else None
    if mgr is not None:
        return mgr.latest_step()
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int, target):
    """Load step `step` into `target` (nested dicts/lists of tensors and
    scalars of the saved structure): tensors are copied into in place,
    other leaves come from the checkpoint. Raises on any mismatch."""
    path = os.path.join(os.path.abspath(directory), str(step), STATE_FILE)
    loaded = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    with torch.no_grad():
        return _load_into(target, loaded, f"{path}:")


def _load_into(target, loaded, where: str):
    """Check the whole structure first, then copy: a mismatch leaves the
    target untouched."""
    _check(target, loaded, where)
    return _copy_into(target, loaded)


def _check(target, loaded, where: str) -> None:
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"{where} holds {type(loaded).__name__}, not a tensor")
        if loaded.shape != target.shape or loaded.dtype != target.dtype:
            raise ValueError(
                f"{where} holds {tuple(loaded.shape)} {loaded.dtype}, the target "
                f"{tuple(target.shape)} {target.dtype}"
            )
    elif isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            raise ValueError(f"{where} keys differ from the target's")
        for k, v in target.items():
            _check(v, loaded[k], f"{where}{k}/")
    elif isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(target):
            raise ValueError(f"{where} length differs from the target's")
        for i, (t, x) in enumerate(zip(target, loaded)):
            _check(t, x, f"{where}{i}/")


def _copy_into(target, loaded):
    from torch.distributed.tensor import DTensor

    if isinstance(target, DTensor):
        # a sharded target (the trainer's mesh) takes its rank's shard of the
        # full tensor the checkpoint holds
        from ..parallel.sharding import local_shard

        local = target.to_local()
        local.copy_(local_shard(loaded.to(local.device), target.device_mesh, target.placements))
        return target
    if isinstance(target, torch.Tensor):
        return target.copy_(loaded)
    if isinstance(target, dict):
        return {k: _copy_into(v, loaded[k]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_copy_into(t, x) for t, x in zip(target, loaded))
    return loaded


def restore_latest_intact(directory: str, target):
    """Restore the newest step that loads cleanly, newest first. A step
    whose restore raises is quarantined (`<step>.corrupt`), so it is not
    listed again and a later save of that step does not collide with it.
    A save still in flight is waited for first, never judged mid-write.

    Returns (state, step, corrupt_steps); (target, 0, [...]) when no step
    is intact."""
    corrupt: list[int] = []
    mgr = _cached_manager(directory)
    if mgr is not None:
        try:
            mgr.wait_until_finished()
        except Exception:  # noqa: BLE001 — a failed write is simply not listed
            pass
    for step in reversed(all_steps(directory)):
        try:
            return restore_checkpoint(directory, step, target), step, corrupt
        except Exception:  # noqa: BLE001 — any restore fault means fall back
            corrupt.append(step)
            _quarantine(directory, step)
    return target, 0, corrupt


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync


def _quarantine(directory: str, step: int) -> None:
    """Rename a poisoned step out of sight (`<step>.corrupt`, with a number
    after it when that name is taken) and fsync the parent directory, so a
    crash right after cannot bring the step back under its old name."""
    parent = os.path.abspath(directory)
    src = os.path.join(parent, str(step))
    dst, n = src + ".corrupt", 1
    while os.path.exists(dst):
        dst, n = f"{src}.corrupt.{n}", n + 1
    try:
        if os.path.isdir(src):
            os.rename(src, dst)
            _fsync_dir(parent)
    except OSError:
        pass  # renamed by another process, or refused: best effort


def close_all() -> None:
    with _manager_lock:
        for mgr, _keep in _managers.values():
            try:
                mgr.close()
            except Exception:  # noqa: BLE001
                pass
        _managers.clear()


# --------------------------------------------------------------- tiers
def _tier_counter(name: str, help: str):
    return get_registry().counter(name, help=help)


_TIER_WRITES = ("checkpoint.tier_writes",
                "Checkpoint step landings, all tiers (local save + durable upload)")


class CheckpointTiers:
    """Two-tier checkpoint layout for one run.

    `durable` is the run's outputs directory; `local` an optional fast
    tier that takes every boundary save, replicated to `durable` by a
    background uploader. Without a local tier this is the plain
    single-directory behaviour.

    An ordinary exception in an upload is a durable-tier outage: counted
    (`checkpoint.upload_failures`), the step stays local-only, training
    goes on. A `SimulatedKill` at the `checkpoint.upload` chaos point is
    stashed and re-raised at the next `save()`/`wait()`.
    """

    def __init__(self, durable: str, local: Optional[str] = None, keep: Optional[int] = None):
        self.durable = os.path.abspath(durable)
        self.local = os.path.abspath(local) if local else None
        self.keep = keep
        self._queue: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error_lock = threading.Lock()
        self._upload_error: Optional[BaseException] = None

    @property
    def primary(self) -> str:
        """The tier boundary saves land on first."""
        return self.local or self.durable

    # ------------------------------------------------------------ save
    def save(self, step: int, state, *, wait: bool = False) -> bool:
        # the local save lands before a stashed upload death is raised, so
        # the restart resumes from the step just saved
        saved = save_checkpoint(self.primary, step, state, keep=self.keep)
        if saved:
            _tier_counter(*_TIER_WRITES).inc()
        self._raise_pending()
        if saved and self.local:
            _manager(self.local).hold(step)
            self._ensure_worker()
            self._queue.put(step)
        if wait:
            self.wait()
        return saved

    def wait(self) -> None:
        """Barrier: the local save written and every queued upload settled."""
        mgr = _cached_manager(self.primary)
        if mgr is not None:
            mgr.wait_until_finished()
        if self.local:
            self._queue.join()
        self._raise_pending()

    def _raise_pending(self) -> None:
        with self._error_lock:
            err, self._upload_error = self._upload_error, None
        if err is not None:
            raise err

    # ---------------------------------------------------------- upload
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._upload_loop, name="ckpt-upload",
                                            daemon=True)
            self._worker.start()

    def _upload_loop(self) -> None:
        from ..chaos.injector import SimulatedKill

        while True:
            step = self._queue.get()
            try:
                self._replicate(step)
            except SimulatedKill as e:
                # abrupt death mid-upload: surfaced to the step loop; the
                # finished local copy carries the resume
                with self._error_lock:
                    self._upload_error = e
            except Exception:  # noqa: BLE001 — durable tier outage
                _tier_counter(
                    "checkpoint.upload_failures",
                    "Durable-tier replication failures (step stays local-only)",
                ).inc()
            finally:
                _manager(self.local).release(step)
                self._queue.task_done()

    def _replicate(self, step: int) -> None:
        from ..chaos.injector import inject

        src = os.path.join(self.local, str(step))
        dst = os.path.join(self.durable, str(step))
        if os.path.isdir(dst):
            return
        mgr = _cached_manager(self.local)
        if mgr is not None:  # the local write of `step` may be in flight
            mgr.wait_until_finished()
        if not os.path.isdir(src):
            return  # quarantined before the upload ran
        t0 = now()
        os.makedirs(self.durable, exist_ok=True)
        tmp = os.path.join(self.durable, f"{step}{_UPLOAD_SUFFIX}")
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            shutil.copytree(src, tmp)
            _fsync_tree(tmp)
            # chaos point: a kill here leaves only the staging directory,
            # so the durable tier never lists a half-uploaded step
            inject("checkpoint.upload", step=step, src=src, directory=self.durable)
            os.rename(tmp, dst)
            _fsync_dir(self.durable)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _tier_counter(*_TIER_WRITES).inc()
        get_registry().histogram(
            "checkpoint.upload_seconds",
            help="Copy of one step to the durable tier: copy, fsync, rename",
        ).observe(now() - t0)
        self._prune_durable()

    def _prune_durable(self) -> None:
        """Mirror the local tier's retention on the durable tier."""
        keep = self.keep or DEFAULT_KEEP
        for step in _steps_on_disk(self.durable)[:-keep]:
            shutil.rmtree(os.path.join(self.durable, str(step)), ignore_errors=True)

    # --------------------------------------------------------- restore
    def steps_by_tier(self) -> dict[str, list[int]]:
        out = {"durable": all_steps(self.durable)}
        if self.local:
            out["local"] = all_steps(self.local)
        return out

    def latest_step(self) -> Optional[int]:
        """Newest step on either tier, or being saved."""
        steps = set().union(*self.steps_by_tier().values())
        mgr = _cached_manager(self.primary)
        if mgr is not None and mgr.pending_step is not None:
            steps.add(mgr.pending_step)
        return max(steps) if steps else None

    def restore_latest_intact(self, target) -> tuple[Any, int, list, Optional[str]]:
        """Newest intact checkpoint across both tiers: steps newest first
        over the union, the durable copy of a step before the local one. A
        copy that fails to restore is quarantined in its own tier only.

        Returns (state, step, corrupt, tier): corrupt lists (tier, step)
        pairs; tier is "durable", "local" or None (nothing to restore)."""
        corrupt: list[tuple[str, int]] = []
        for directory in filter(None, (self.local, self.durable)):
            mgr = _cached_manager(directory)
            if mgr is not None:
                try:
                    mgr.wait_until_finished()
                except Exception:  # noqa: BLE001
                    pass
        if self.local:
            self._queue.join()  # uploads in flight are good copies
        by_tier = self.steps_by_tier()
        dirs = {"durable": self.durable, "local": self.local}
        for step in sorted(set().union(*by_tier.values()), reverse=True):
            for tier in ("durable", "local"):
                if step not in by_tier.get(tier, ()):
                    continue
                try:
                    return restore_checkpoint(dirs[tier], step, target), step, corrupt, tier
                except Exception:  # noqa: BLE001 — fall through per tier
                    corrupt.append((tier, step))
                    _quarantine(dirs[tier], step)
        return target, 0, corrupt, None


def _fsync_tree(root: str) -> None:
    """fsync every file, then every directory under `root`, bottom-up."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for name in filenames:
            try:
                fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)
            except OSError:
                pass
        _fsync_dir(dirpath)
