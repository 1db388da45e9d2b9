"""Local executor: `CompiledOperation` → a run in the store, executed. An
own copy of `polyaxon_tpu/runtime/executor.py` for one process on one
card.

Create the run → walk its lifecycle (compiled → queued → scheduled →
starting → running → succeeded/failed/stopped) → execute it (a native
program through the port's `Trainer`, a `dag` through
`scheduler/dag.py::execute_dag`, or a container command, a job or a
service, as a local subprocess) → metrics, events and logs into the
store. Around the body: a cache hit on the spec fingerprint, retries with
backoff from `termination:`, a stop landing at the next log point, a
SIGTERM (`runtime/preemption.py`) restarting from the newest checkpoint
without costing retry budget, init entries, sidecars and `pathRef` hooks.

The device comes from `device=`, else the first of `devices=` (a sweep
trial's group, `tuner/placement.py`; giving both is a ValueError), else
`POLYAXON_TORCH_DEVICE` (the card unless it says `cpu`). An in-process
program trains under its CUDA device (`torch.cuda.device`): the hand
kernels launch on the calling thread's current device. A jaxjob over
more than one device runs as a gang (`_run_distributed`): the native
supervisor starts one worker process per device (`runtime/worker.py`),
and they train on one mesh; with a group, the workers see only the
group's GPUs. Where the reference runs `replicas` processes that each drive all of a host's
devices, a replica of k devices here is k workers (`replica_devices`: the
mesh's fixed devices, or the `tpu:` chips, over `replicas`), `replicas x
k` in all (`gang_size`); a spec from which no whole k follows is refused
(ValueError), naming both numbers. With fewer GPUs than workers (in the
group, or visible) the gang is refused before the run exists, naming the
counts; the CPU (`gloo`) is used only when asked for. A mesh that resolves
to one device runs as the single-device program: it computes the same
thing. As the reference's, `execute` does not read `matrix:` or `joins:`:
the CLI resolves joins (`scheduler/joins.py::resolve_joins`) and sends a
matrix to `tuner/driver.py::run_sweep` before anything compiles; a
`schedule:` is the agent's (`scheduler/schedules.py`), and the executor
runs one firing like any operation.

Under the fleet scheduler (`scheduler/admission.py`) an eviction flag
(`preempt_requested` in the run's meta) rides the SIGTERM machinery: the
trainer checkpoints at its next step boundary, and the executor releases
the run's reservation and pushes it back on its queue at its original
priority (`_requeue_preempted`); the next attempt resumes from the
checkpoint. An elastic grant below the request (`granted_chips`) trains
on that many devices, in process for one and as a smaller gang (its
`CUDA_VISIBLE_DEVICES` the granted GPUs) for more, with `grad_accum`
multiplied by `requested // granted` (`_apply_elastic_grant`). Refused
with `NotImplementedError` before the run is created, each naming
ROADMAP.md: named `connections:`, an artifacts init and a notifier hook.
"""

from __future__ import annotations

import gc
import math
import os
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Optional

from ..compiler.resolver import CompiledOperation
from ..schemas.lifecycle import V1Statuses, can_transition
from ..store import RunStore

_ROADMAP = "is not ported to PyTorch yet (see ROADMAP.md)"


class ExecutionError(Exception):
    pass


class StopRequested(Exception):
    """A stop arrived (`ops stop`, or the store's STOPPING status),
    observed at a log point: the executor's cooperative cancellation
    boundary."""


def replica_devices(run) -> int:
    """Devices one replica of a jaxjob drives (k): with `replicas` above
    1, the devices the mesh fixes (no -1 axis) over `replicas`, else the
    chips of `environment.resources.tpu` over `replicas` (1 without a
    `tpu:` block); a single replica drives the devices its mesh fixes (a
    -1 axis filling to 1). A spec from which no whole k follows raises
    ValueError naming both numbers."""
    replicas = int(run.replicas or 1)
    sizes = run.mesh.axis_sizes() if run.mesh else {}
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if replicas == 1:
        return fixed
    if sizes and -1 not in sizes.values():
        total, what = fixed, f"the mesh {sizes} fixes {fixed} devices"
    else:
        env = getattr(run, "environment", None)
        tpu = env.resources.tpu if env and env.resources else None
        if tpu is None:
            return 1
        total, what = tpu.total_chips, f"environment.resources.tpu has {tpu.total_chips} chips"
    if total % replicas:
        raise ValueError(
            f"{what}, which do not split into replicas: {replicas} (each replica "
            "drives a whole number of devices)"
        )
    return total // replicas


def gang_size(run) -> int:
    """Worker processes a jaxjob runs on, one device each: `replicas`
    times the devices of a replica (`replica_devices`); the mesh resolves
    over all of them."""
    return int(run.replicas or 1) * replica_devices(run)


def gang_device_error(compiled: CompiledOperation, device,
                      devices: Optional[list] = None,
                      world: Optional[int] = None) -> Optional[str]:
    """Why a gang cannot get one GPU per worker here, or None (the CPU
    under `gloo` is used only when `device` asks for it). With `devices`
    (a sweep trial's group) the group's GPUs are counted, else the visible
    ones. `world`: the workers after an elastic grant (default the
    spec's gang)."""
    import torch

    run = compiled.run
    if run.kind != "jaxjob" or run.program is None or torch.device(device).type != "cuda":
        return None
    world = gang_size(run) if world is None else world
    if devices is not None:
        have = sum(torch.device(d).type == "cuda" for d in devices)
        where = "in the trial's device group"
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        where = "visible"
    if world > 1 and have < world:
        return (f"the gang has {world} workers (replicas: {int(run.replicas or 1)} x "
                f"{replica_devices(run)} devices each), one GPU each, but {have} "
                f"GPU(s) are {where}; set POLYAXON_TORCH_DEVICE=cpu to run it on the CPU")
    return None


def device_scope(device):
    """The context an in-process program runs in: `torch.cuda.device(device)`
    for a CUDA device where CUDA is available (the hand kernels launch on
    the calling thread's current device), else nothing."""
    import contextlib

    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def refusal(compiled: CompiledOperation) -> Optional[str]:
    """Why the port cannot run `compiled` in this process (one card), or
    None. A jaxjob from which no whole number of devices a replica
    follows raises ValueError (`replica_devices`), before any run exists."""
    op, run = compiled.operation, compiled.run
    if getattr(run, "connections", None):
        return f"named `connections:` (connections/) {_ROADMAP}"
    for init in getattr(run, "init", None) or ():
        if init.artifacts or init.connection:
            return f"an artifacts init and init connections (connections/) {_ROADMAP}"
    for hook in op.hooks or ():
        if not hook.path_ref:
            return f"a notifier hook (connections/notifier.py) {_ROADMAP}"
    if run.kind == "jaxjob" and run.program is not None:
        gang_size(run)  # no whole number of devices a replica: ValueError, before any run
    return None


class Executor:
    def __init__(self, store: Optional[RunStore] = None, device=None,
                 devices: Optional[list] = None):
        from ..device import env_device

        if device is not None and devices is not None:
            raise ValueError("give `device=` (one device) or `devices=` (a group), not both")
        self.store = store or RunStore()
        self.devices = list(devices) if devices is not None else None
        if device is None:
            device = str(self.devices[0]) if self.devices else env_device()
        self.device = device

    def execute(self, compiled: CompiledOperation) -> str:
        """Run to completion; returns the final status. Retries per the
        termination spec (restart-from-checkpoint comes free: the trainer
        resumes from the run's outputs). With `cache:` on, a succeeded run
        with the same spec fingerprint short-circuits: its metrics and
        events are copied in and the run succeeds at once."""
        why = refusal(compiled)
        if why is not None:
            raise NotImplementedError(why)
        if compiled.run.kind == "jaxjob" and compiled.run.program is not None:
            from ..device import resolve_device

            resolve_device(self.device)  # no card where one is asked for: raise, run nothing
            short = gang_device_error(compiled, self.device, self.devices,
                                      world=self._granted_world(compiled))
            if short is not None:
                raise RuntimeError(short)
        from ..compiler.resolver import spec_fingerprint
        from ..retry import PERMANENT, PREEMPTED, RetryPolicy, classify
        from ..telemetry import get_registry

        store = self.store
        run_uuid = compiled.run_uuid
        fingerprint = spec_fingerprint(compiled)
        store.create_run(
            run_uuid, compiled.name, compiled.project, compiled.to_dict(),
            tags=compiled.operation.tags, meta={"fingerprint": fingerprint},
        )
        cache = compiled.operation.cache or compiled.component.cache
        if cache is not None and not cache.disable:
            hit = self._find_cached(fingerprint, cache.ttl, exclude=run_uuid)
            if hit is not None:
                return self._finish_from_cache(compiled, hit)
        self._advance(run_uuid, (V1Statuses.COMPILED, V1Statuses.QUEUED, V1Statuses.SCHEDULED))

        term = compiled.component.termination
        policy = RetryPolicy.from_termination(term)
        max_retries = policy.max_retries
        timeout = term.timeout if term else None
        attempt = 0  # budgeted retries consumed (transient failures)
        restarts = int((store.get_status(run_uuid).get("meta") or {}).get("preempt_restarts", 0))
        while True:
            if self._stopped(run_uuid):  # a stop landed between attempts
                return V1Statuses.STOPPED
            store.set_status(run_uuid, V1Statuses.STARTING)
            try:
                self._run_once(compiled, timeout=timeout, resume=restarts > 0)
                if self._stopped(run_uuid):  # the stop raced the finish line
                    return V1Statuses.STOPPED
                store.set_status(run_uuid, V1Statuses.SUCCEEDED)
                self._run_hooks(compiled, V1Statuses.SUCCEEDED)
                return V1Statuses.SUCCEEDED
            except BaseException as e:  # noqa: BLE001 — record, then decide
                store.append_log(run_uuid, f"ERROR: {e}\n{traceback.format_exc()}")
                if isinstance(e, StopRequested):
                    self._stopped(run_uuid)  # settles STOPPING → STOPPED
                    return V1Statuses.STOPPED
                if self._stopped(run_uuid):
                    return V1Statuses.STOPPED
                if isinstance(e, KeyboardInterrupt):
                    store.request_stop(run_uuid)
                    raise
                kind = classify(e)
                if kind == PREEMPTED:
                    meta = store.get_status(run_uuid).get("meta") or {}
                    if meta.get("preempt_requested"):
                        return self._requeue_preempted(compiled, e, restarts)
                    # the program was healthy, the machine went away:
                    # restart from the checkpoint without burning budget
                    restarts += 1
                    get_registry().counter(
                        "runs.preemptions", help="Budget-free preemption restarts"
                    ).inc()
                    store.log_event(run_uuid, "preempted",
                                    {"step": getattr(e, "step", None), "restart": restarts})
                    store.set_status(run_uuid, V1Statuses.RETRYING, reason="preempted",
                                     message=str(e))
                    store.set_status(run_uuid, V1Statuses.QUEUED)
                    store.set_status(run_uuid, V1Statuses.SCHEDULED)
                    continue
                if kind != PERMANENT and attempt < max_retries:
                    delay = policy.delay(attempt, seed=run_uuid)
                    attempt += 1
                    restarts += 1
                    get_registry().counter(
                        "runs.retries", help="Budgeted transient-failure retries"
                    ).inc()
                    store.log_event(run_uuid, "retry",
                                    {"attempt": attempt, "delay": delay, "error": str(e)})
                    store.set_status(
                        run_uuid, V1Statuses.RETRYING,
                        reason=f"retry {attempt}/{max_retries}"
                        + (f" after {delay:.3g}s" if delay > 0 else ""),
                        message=str(e),
                    )
                    store.set_status(run_uuid, V1Statuses.QUEUED)
                    store.set_status(run_uuid, V1Statuses.SCHEDULED)
                    if delay > 0:
                        time.sleep(delay)
                    continue
                store.set_status(run_uuid, V1Statuses.FAILED, reason=type(e).__name__,
                                 message=str(e))
                self._run_hooks(compiled, V1Statuses.FAILED)
                return V1Statuses.FAILED

    def _advance(self, run_uuid: str, stages) -> None:
        """Walk the pre-run lifecycle, skipping stages already passed (an
        agent-submitted run arrives QUEUED, a direct one CREATED)."""
        for s in stages:
            current = V1Statuses(self.store.get_status(run_uuid)["status"])
            if current != s and can_transition(current, s):
                self.store.set_status(run_uuid, s)

    def _requeue_preempted(self, compiled: CompiledOperation, exc: BaseException,
                           restarts: int) -> str:
        """A scheduler eviction: admission flagged this run to yield its
        chips, the trainer checkpointed at the step boundary and raised
        Preempted. Release the reservation and push the run back on its
        queue at its original priority with its full demand; the next
        attempt resumes (`preempt_restarts` makes it `resume=True`)."""
        from ..scheduler.fleet import Fleet, chips_demand, min_chips_demand, topology_request
        from ..scheduler.queue import RunQueue

        store, run_uuid = self.store, compiled.run_uuid
        meta = store.get_status(run_uuid).get("meta") or {}
        store.set_meta(run_uuid, preempt_requested=False, preempt_restarts=restarts + 1)
        store.log_event(run_uuid, "preempted", {
            "step": getattr(exc, "step", None), "restart": restarts + 1, "scheduler": True,
            # the gang this attempt ran at: the next pass may grant another rung
            "granted_chips": meta.get("granted_chips"),
        })
        store.set_status(run_uuid, V1Statuses.RETRYING, reason="evicted", message=str(exc))
        store.set_status(run_uuid, V1Statuses.QUEUED)
        Fleet(store).release(run_uuid)  # the chips go to the preemptor
        op = compiled.operation
        block = topology_request(op)
        RunQueue(store, name=meta.get("queue") or "default").push(
            run_uuid, {"operation": op.to_dict(), "project": compiled.project},
            priority=int(meta.get("priority", 0)), chips=chips_demand(op),
            min_chips=min_chips_demand(op), block=list(block) if block else None,
        )
        return V1Statuses.QUEUED

    def _granted_world(self, compiled: CompiledOperation) -> int:
        """The workers a jaxjob trains on: its gang (`gang_size`), or the
        chips an elastic grant gave it when that is fewer."""
        from ..scheduler.fleet import min_chips_demand

        world = gang_size(compiled.run)
        meta = self.store.get_status(compiled.run_uuid).get("meta") or {}
        granted = meta.get("granted_chips")
        if granted is None or min_chips_demand(compiled.operation) is None:
            return world
        return min(world, int(granted))

    def _apply_elastic_grant(self, compiled: CompiledOperation, program):
        """(program, world) for the gang the scheduler granted: below the
        spec's gang, `grad_accum` is multiplied by `requested // granted`
        so the global batch holds, and the grant is counted and logged.
        Untouched when the grant covers the gang (or the run is not
        elastic)."""
        from ..scheduler.fleet import chips_demand
        from ..telemetry import get_registry

        world, granted = gang_size(compiled.run), self._granted_world(compiled)
        if granted >= world:
            return program, world
        requested = chips_demand(compiled.operation)
        tspec = program.train
        accum = int(tspec.grad_accum) if tspec and tspec.grad_accum else 1
        new_accum = accum * max(1, requested // granted)
        if tspec is not None:
            program = program.copy(train=tspec.copy(grad_accum=new_accum))
        get_registry().counter(
            "trainer.elastic_resizes", help="Training attempts started at a resized gang"
        ).inc()
        self.store.log_event(compiled.run_uuid, "elastic_resize", {
            "granted": granted, "requested": requested, "grad_accum": new_accum})
        return program, granted

    def _stopped(self, run_uuid: str) -> bool:
        """True when a stop request landed; settles STOPPING → STOPPED."""
        current = self.store.get_status(run_uuid).get("status")
        if current == V1Statuses.STOPPING:
            self.store.set_status(run_uuid, V1Statuses.STOPPED)
            return True
        return current == V1Statuses.STOPPED

    # ------------------------------------------------------------------ hooks
    def _run_hooks(self, compiled: CompiledOperation, status: str) -> None:
        """A `pathRef` hook compiles and executes that component as its own
        run with the parent's status and uuid as params. A hook's failure is
        logged, never propagated into the parent's status."""
        from ..compiler.resolver import compile_operation
        from ..schemas.operation import V1Operation

        store, run_uuid = self.store, compiled.run_uuid
        for hook in compiled.operation.hooks or []:
            trigger = hook.trigger or "done"
            fire = (
                trigger == "done"
                or (trigger == "succeeded" and status == V1Statuses.SUCCEEDED)
                or (trigger == "failed" and status == V1Statuses.FAILED)
            )
            if not fire:
                continue
            try:
                params = dict(hook.params or {})
                child = V1Operation.from_dict({
                    "name": f"{compiled.name}-hook",
                    "pathRef": hook.path_ref,
                    "params": {
                        **{k: v.to_dict() for k, v in params.items()},
                        "status": {"value": getattr(status, "value", str(status))},
                        "run_uuid": {"value": run_uuid},
                    },
                })
                hook_compiled = compile_operation(child, project=compiled.project)
                store.append_log(run_uuid,
                                 f"hook {hook.path_ref}: run {hook_compiled.run_uuid[:8]}")
                self.execute(hook_compiled)
            except Exception as e:  # noqa: BLE001 — hooks never fail the run
                store.append_log(run_uuid, f"hook error ({hook.path_ref or hook.hub_ref}): {e}")

    # ------------------------------------------------------------------ cache
    def _find_cached(self, fingerprint: str, ttl, exclude: str):
        """The newest succeeded run with the same fingerprint (within ttl)."""
        best = None
        for rec in self.store.list_runs():
            uuid = rec["uuid"]
            if uuid == exclude:
                continue
            if ttl and rec.get("created_at", 0) < time.time() - ttl:
                continue
            status = self.store.get_status(uuid)
            if status.get("status") != V1Statuses.SUCCEEDED:
                continue
            if status.get("meta", {}).get("fingerprint") != fingerprint:
                continue
            if best is None or rec.get("created_at", 0) > best[1]:
                best = (uuid, rec.get("created_at", 0))
        return best[0] if best else None

    def _finish_from_cache(self, compiled: CompiledOperation, source_uuid: str) -> str:
        """Copy the cached run's results in and succeed without executing."""
        import shutil

        store, run_uuid = self.store, compiled.run_uuid
        self._advance(run_uuid, (V1Statuses.COMPILED, V1Statuses.QUEUED, V1Statuses.SCHEDULED,
                                 V1Statuses.STARTING, V1Statuses.RUNNING))
        for fname in ("metrics.jsonl", "events.jsonl"):
            src = store.run_dir(source_uuid) / fname
            if src.exists():
                shutil.copy(src, store.run_dir(run_uuid) / fname)
        store.log_event(run_uuid, "cache_hit", {"source_run": source_uuid})
        store.append_log(run_uuid, f"cache hit: reusing results of run {source_uuid[:8]}")
        store.set_status(run_uuid, V1Statuses.SUCCEEDED, reason="cached")
        self._run_hooks(compiled, V1Statuses.SUCCEEDED)
        return V1Statuses.SUCCEEDED

    # ------------------------------------------------------------------ body
    def _run_once(self, compiled: CompiledOperation, timeout=None, resume=False):
        run = compiled.run
        if getattr(run, "init", None):
            self._run_init(compiled)
        sidecars = self._start_sidecars(compiled)
        try:
            if run.kind == "jaxjob" and run.program is not None:
                self._run_program(compiled, resume=resume)
            elif run.kind == "service" and run.container is not None:
                self._run_service(compiled, timeout=timeout)
            elif run.kind in ("job", "jaxjob") and run.container is not None:
                self._run_container(compiled, timeout=timeout)
            elif run.kind == "dag":
                from ..scheduler.dag import execute_dag

                self.store.set_status(compiled.run_uuid, V1Statuses.RUNNING)
                execute_dag(compiled, self)
            else:
                raise ExecutionError(f"cannot execute run kind {run.kind!r} locally")
        finally:
            try:
                self._stop_sidecars(sidecars)
            except Exception as e:  # noqa: BLE001 — never masks the run's own failure
                self.store.append_log(compiled.run_uuid, f"sidecar teardown failed: {e}")

    def context_dir(self, run_uuid: str) -> Path:
        d = self.store.run_dir(run_uuid) / "context"
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _run_init(self, compiled: CompiledOperation):
        """Each V1Init entry into the run's context dir: git clone, literal
        files, host paths, or a custom container. A failed init fails the
        run (as an init container's crash does)."""
        import shutil

        run, store, run_uuid = compiled.run, self.store, compiled.run_uuid
        ctx = self.context_dir(run_uuid)
        for i, init in enumerate(run.init or []):
            try:
                if init.git:
                    self._init_git(init, ctx, run_uuid)
                if init.file:
                    f = init.file
                    dst = ctx / str(f.get("name") or f.get("path") or "file")
                    dst.parent.mkdir(parents=True, exist_ok=True)
                    dst.write_text(str(f.get("content", "")))
                for p in init.paths or ():
                    src = Path(p)
                    dst = ctx / src.name
                    if src.is_dir():
                        shutil.copytree(src, dst, dirs_exist_ok=True)
                    elif src.is_file():
                        dst.parent.mkdir(parents=True, exist_ok=True)
                        shutil.copy2(src, dst)
                    else:
                        raise ExecutionError(f"init path not found: {p}")
                if init.container:
                    self._run_aux_container(compiled, init.container, cwd=str(ctx), tag="init")
            except ExecutionError:
                raise
            except Exception as e:  # noqa: BLE001 — name the entry that failed
                raise ExecutionError(f"init[{i}] failed: {e}") from e
            store.append_log(run_uuid, f"init[{i}] done")

    def _init_git(self, init, ctx: Path, run_uuid: str):
        git = init.git
        url = str(git.get("url", ""))
        dest = ctx / (git.get("dest")
                      or url.rstrip("/").split("/")[-1].removesuffix(".git") or "repo")
        proc = subprocess.run(["git", "clone", "--quiet", url, str(dest)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise ExecutionError(f"git clone {url}: {proc.stderr.strip()}")
        if git.get("revision"):
            proc = subprocess.run(
                ["git", "-C", str(dest), "checkout", "--quiet", str(git["revision"])],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise ExecutionError(f"git checkout {git['revision']}: {proc.stderr.strip()}")
        self.store.append_log(run_uuid, f"init: cloned {url} -> {dest.name}")

    def _start_sidecars(self, compiled: CompiledOperation) -> list:
        """Sidecar containers run beside the main work as local
        subprocesses; a drain thread streams each one's output into the
        run log (an undrained pipe would block it). They are terminated
        when the run finishes."""
        procs = []
        for c in getattr(compiled.run, "sidecars", None) or []:
            cmd = list(c.command or []) + list(c.args or [])
            if not cmd:
                continue
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=c.working_dir or None, env=self._container_env(compiled, c),
            )

            def _drain(p=proc):
                for line in iter(p.stdout.readline, ""):
                    self.store.append_log(compiled.run_uuid, "[sidecar] " + line.rstrip("\n"))

            t = threading.Thread(target=_drain, daemon=True)
            t.start()
            procs.append((proc, t))
        return procs

    def _stop_sidecars(self, procs: list):
        for proc, drain in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
            drain.join(timeout=5)

    def _container_env(self, compiled, c) -> dict[str, str]:
        """A container's environment: inherited, the run's context
        variables, then the container's own env (dict or k8s list)."""
        env = dict(os.environ)
        env.update(_context_env(compiled, self.store))
        if isinstance(c.env, dict):
            env.update({k: str(v) for k, v in c.env.items()})
        elif isinstance(c.env, list):
            env.update({e["name"]: str(e.get("value", "")) for e in c.env})
        return env

    def _run_aux_container(self, compiled, c, cwd: str, tag: str):
        cmd = list(c.command or []) + list(c.args or [])
        if not cmd:
            raise ExecutionError(f"{tag} container has no command")
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=c.working_dir or cwd,
                              env=self._container_env(compiled, c))
        for line in (proc.stdout or "").splitlines():
            self.store.append_log(compiled.run_uuid, f"[{tag}] " + line)
        if proc.returncode != 0:
            raise ExecutionError(
                f"{tag} container exited with code {proc.returncode}: "
                f"{(proc.stderr or '').strip()[-500:]}"
            )

    def _run_program(self, compiled: CompiledOperation, resume: bool):
        import torch

        from . import preemption
        from .trainer import Trainer

        run = compiled.run
        store, run_uuid = self.store, compiled.run_uuid
        ckpt_dir = local_ckpt_dir = None
        tspec = run.program.train
        if tspec and (tspec.checkpoint_every or tspec.resume):
            ckpt_dir = str(store.outputs_dir(run_uuid) / "checkpoints")
            if tspec.checkpoint_local_dir:
                # the fast tier, scoped per run
                local_ckpt_dir = str(Path(tspec.checkpoint_local_dir) / run_uuid / "checkpoints")
        program = run.program
        if resume and tspec is not None:
            program = program.copy(train=tspec.copy(resume=True))
        program, world = self._apply_elastic_grant(compiled, program)
        if world > 1:
            return self._run_distributed(compiled, world, program, ckpt_dir)

        def log_fn(step: int, metrics: dict):
            store.log_metrics(run_uuid, step, metrics)
            store.append_log(run_uuid, f"step {step}: " + " ".join(
                f"{k}={v:.6g}" for k, v in metrics.items()))
            # log points are the cooperative cancellation boundary
            data = store.get_status(run_uuid)
            if data.get("status") in (V1Statuses.STOPPING, V1Statuses.STOPPED):
                raise StopRequested(f"stop requested at step {step}")
            # a scheduler eviction rides the SIGTERM machinery: the trainer
            # checkpoints at the next step boundary and raises Preempted
            if (data.get("meta") or {}).get("preempt_requested"):
                preemption.trigger()

        # SIGTERM = a preemption notice for the length of this attempt: the
        # step loop checkpoints at the next boundary and raises Preempted.
        # Only this in-process path enters the device: a gang, a container
        # or a dag's supervisor never starts CUDA here
        with preemption.scoped(), device_scope(self.device):
            trainer = Trainer(
                program,
                device=self.device,
                log_fn=log_fn,
                event_fn=lambda kind, body: store.log_event(run_uuid, kind, body),
                checkpoint_dir=ckpt_dir,
                local_checkpoint_dir=local_ckpt_dir,
                artifacts_dir=str(store.outputs_dir(run_uuid)),
            )
            store.set_status(run_uuid, V1Statuses.RUNNING)
            monitor = None
            obs = program.observability
            if obs is not None:
                from ..tracking.monitors import SystemMonitor

                monitor = SystemMonitor(store, run_uuid, interval=float(obs.sample_interval)).start()
            try:
                result = trainer.run()
            finally:
                if monitor is not None:
                    monitor.stop()
                trainer.close()
                # the next attempt builds its own model: give this one's
                # memory back first
                del trainer
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
        store.log_event(run_uuid, "run_summary", {
            "steps_per_sec": result.steps_per_sec, "final_metrics": result.final_metrics,
        })
        store.append_log(run_uuid, f"done: {result.steps_per_sec:.2f} steps/s, "
                                   f"final {result.final_metrics}")

    def _run_distributed(self, compiled: CompiledOperation, world: int, program, ckpt_dir):
        """A gang under the native supervisor: `world` worker processes
        (`runtime.worker`), one device each, with torch.distributed's
        rendezvous environment injected by the launcher; gang semantics
        restart all or nothing. Exit 75 (a worker checkpointed on SIGTERM)
        or 143 (the launcher itself was SIGTERMed) is a preemption."""
        import json
        import tempfile

        from ..native import launcher_path, pick_port
        from ..retry import Preempted
        from ..schemas.run_kinds import run_num_slices

        run = compiled.run
        store, run_uuid = self.store, compiled.run_uuid
        payload = {
            "runUuid": run_uuid,
            "program": program.to_dict(),
            "mesh": run.mesh.axis_sizes() if run.mesh else None,
            "slices": run_num_slices(run),
        }
        if ckpt_dir is not None:
            payload["checkpointDir"] = ckpt_dir
        with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as spec_file:
            json.dump(payload, spec_file)
        # a grant below the gang trains on the first `world` devices of the
        # group (without one, the workers take cuda:0 .. world - 1)
        group = visible_group(self.devices[:world] if self.devices else None)
        term = compiled.component.termination
        root = str(Path(__file__).resolve().parents[2])
        path = os.environ.get("PYTHONPATH")
        cmd = [
            launcher_path(),
            "--num-workers", str(world),
            "--coordinator", f"127.0.0.1:{pick_port(run_uuid)}",
            "--max-restarts", "0",  # retries are execute()'s
            *(["--timeout", str(int(term.timeout))] if term and term.timeout else []),
            "--env", f"POLYAXON_PROGRAM_SPEC={spec_file.name}",
            "--env", f"POLYAXON_HOME={store.home}",
            "--env", f"POLYAXON_TORCH_DEVICE={self.device}",
            "--env", f"POLYAXON_REPLICA_DEVICES={replica_devices(run)}",
            *(["--env", f"CUDA_VISIBLE_DEVICES={group}"] if group else []),
            "--env", f"PYTHONPATH={root + (os.pathsep + path if path else '')}",
            "--", sys.executable, "-m", "polyaxon_tpu_torch.runtime.worker",
        ]
        store.set_status(run_uuid, V1Statuses.RUNNING)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            for line in iter(proc.stdout.readline, ""):
                store.append_log(run_uuid, "[launcher] " + line.rstrip("\n"))
            code = proc.wait()
        finally:
            os.unlink(spec_file.name)
        if code in (75, 143):
            raise Preempted(f"distributed gang preempted (exit code {code})")
        if code != 0:
            raise ExecutionError(f"distributed gang exited with code {code}")

    def _spawn_container(self, compiled, c, extra_env: Optional[dict] = None) -> subprocess.Popen:
        """One launch recipe for main containers and services."""
        cmd = list(c.command or []) + list(c.args or [])
        if not cmd:
            raise ExecutionError("container has no command")
        env = self._container_env(compiled, c)
        if extra_env:
            env.update(extra_env)
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, cwd=c.working_dir or None, env=env)

    def _run_service(self, compiled: CompiledOperation, timeout=None):
        """A service stays up: RUNNING until a stop lands (terminated →
        STOPPED) or the timeout expires; a service that exits by itself has
        FAILED. Its ports reach it as POLYAXON_SERVICE_PORT[S]."""
        run = compiled.run
        store, run_uuid = self.store, compiled.run_uuid
        ports = [int(p) for p in (getattr(run, "ports", None) or [])]
        extra_env = {}
        if ports:
            extra_env["POLYAXON_SERVICE_PORT"] = str(ports[0])
            extra_env["POLYAXON_SERVICE_PORTS"] = ",".join(str(p) for p in ports)
        store.set_status(run_uuid, V1Statuses.RUNNING)
        store.log_event(run_uuid, "service_started", {"ports": ports})
        proc = self._spawn_container(compiled, run.container, extra_env)

        def _drain():
            for line in iter(proc.stdout.readline, ""):
                store.append_log(run_uuid, line.rstrip("\n"))

        drain = threading.Thread(target=_drain, daemon=True)
        drain.start()
        deadline = time.time() + timeout if timeout else None
        try:
            while proc.poll() is None:
                status = store.get_status(run_uuid).get("status")
                if status in (V1Statuses.STOPPING, V1Statuses.STOPPED):
                    raise StopRequested("service stop requested")
                if deadline and time.time() > deadline:
                    raise ExecutionError(f"service exceeded timeout of {timeout}s")
                time.sleep(0.5)
        finally:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
            drain.join(timeout=5)
        raise ExecutionError(f"service exited unexpectedly with code {proc.returncode}")

    def _run_container(self, compiled: CompiledOperation, timeout=None):
        """The container command as a local subprocess (the image is not
        used locally)."""
        store, run_uuid = self.store, compiled.run_uuid
        store.set_status(run_uuid, V1Statuses.RUNNING)
        proc = self._spawn_container(compiled, compiled.run.container)
        deadline = time.time() + timeout if timeout else None
        for line in iter(proc.stdout.readline, ""):
            store.append_log(run_uuid, line.rstrip("\n"))
            if deadline and time.time() > deadline:
                proc.kill()
                raise ExecutionError(f"run exceeded timeout of {timeout}s")
        code = proc.wait()
        if code != 0:
            raise ExecutionError(f"container command exited with code {code}")


def visible_group(devices: Optional[list]) -> Optional[str]:
    """`CUDA_VISIBLE_DEVICES` for a gang on `devices` (a sweep trial's
    group): their indices mapped through this process's own
    `CUDA_VISIBLE_DEVICES`, so the workers see only the group's GPUs (and
    `runtime/worker.py` splits them per replica). None without a CUDA
    group."""
    import torch

    cuda = [torch.device(d) for d in devices or () if torch.device(d).type == "cuda"]
    if not cuda:
        return None
    ids = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ids.split(",") if ids else None
    return ",".join(ids[d.index or 0] if ids else str(d.index or 0) for d in cuda)


def _context_env(compiled: CompiledOperation, store: RunStore) -> dict[str, str]:
    """The run identity and paths a container reads to attach to its run."""
    return {
        "POLYAXON_RUN_UUID": compiled.run_uuid,
        "POLYAXON_RUN_NAME": compiled.name,
        "POLYAXON_PROJECT": compiled.project,
        "POLYAXON_RUN_OUTPUTS_PATH": str(store.outputs_dir(compiled.run_uuid)),
        "POLYAXON_RUN_CONTEXT_PATH": str(store.run_dir(compiled.run_uuid) / "context"),
        "POLYAXON_HOME": str(store.home),
    }
