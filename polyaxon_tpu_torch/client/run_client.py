"""`RunClient`, the SDK surface over the local run store: an own copy of
the local transport of `polyaxon_tpu/client/run_client.py`.

    client = RunClient()
    uuid = client.create(op)                # compile and queue it for an agent
    uuid = client.create(op, queue=False)   # compile and run it here
    client.logs(uuid); client.metrics(uuid); client.statuses(uuid)
    client.stop(uuid)
    client.resume(uuid, queue=False)        # a new run from the newest checkpoint

`restart`, `copy` and `resume` make a new run from the source's stored
operation (with `cloned_from`/`clone_kind` in its meta and a `lineage`
event on the source), queued for an agent (`queue=True`, the default:
`scheduler/agent.py::Agent.submit`) or run in this process. The
reference's HTTP transport (`base_url=`, a remote control plane) is not
ported (ROADMAP.md).
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path
from typing import Callable, Optional

from ..schemas.lifecycle import DONE_STATUSES, V1Statuses
from ..schemas.operation import V1Operation
from ..store import RunStore

_ROADMAP = "is not ported to PyTorch yet (see ROADMAP.md)"


class ClientError(Exception):
    pass


class RunClient:
    def __init__(self, base_url: Optional[str] = None, store: Optional[RunStore] = None,
                 project: str = "default", device=None):
        if base_url:
            raise NotImplementedError(
                f"a remote control plane (base_url, client/'s HTTP transport) {_ROADMAP}"
            )
        self.project = project
        self.device = device
        self._store = store if store is not None else RunStore()
        self._http = None  # the local transport only

    @property
    def store(self) -> RunStore:
        return self._store

    # ---------------------------------------------------------------- write
    def _submit(self, op: V1Operation, *, meta: Optional[dict] = None,
                prepare_fn: Optional[Callable] = None):
        """Compile and create the run (the agent's `submit` without the
        queue push): created → compiled → queued, meta stamped, then
        `prepare_fn(compiled)` before it runs."""
        from .. import settings
        from ..compiler.resolver import compile_operation, spec_fingerprint
        from ..runtime.executor import refusal

        compiled = compile_operation(op, project=self.project,
                                     artifacts_root=str(self.store.runs_dir))
        why = refusal(compiled)
        if why is not None:
            raise NotImplementedError(why)
        self.store.create_run(
            compiled.run_uuid, compiled.name, compiled.project, compiled.to_dict(),
            tags=compiled.operation.tags,
            meta={
                "fingerprint": spec_fingerprint(compiled),
                "queue": op.queue or settings.get("queue") or "default",
                "priority": 0,
                **(meta or {}),
            },
        )
        if prepare_fn is not None:
            prepare_fn(compiled)
        self.store.set_status(compiled.run_uuid, V1Statuses.COMPILED)
        self.store.set_status(compiled.run_uuid, V1Statuses.QUEUED)
        return compiled

    def _run_inline(self, compiled) -> str:
        from ..runtime.executor import Executor

        return Executor(self.store, device=self.device).execute(compiled)

    def _agent(self):
        from ..scheduler.agent import Agent

        return Agent(store=self.store)

    def create(self, op: V1Operation, *, queue: bool = True) -> str:
        """Submit an operation: queued for the agent draining this store
        (`queue=True`), or run here to completion (`queue=False`)."""
        if queue:
            return self._agent().submit(op, project=self.project)
        compiled = self._submit(op)
        self._run_inline(compiled)
        return compiled.run_uuid

    def stop(self, uuid: str):
        self.store.request_stop(self.store.resolve(uuid))

    def delete(self, uuid: str, *, cascade: bool = False):
        """Permanently delete a finished run's data (`cascade` for a sweep's
        trials)."""
        self.store.delete_run(self.store.resolve(uuid), cascade=cascade)

    # ------------------------------------------------- restart/resume/copy
    def _op_from_run(self, src_uuid: str, suffix: str) -> V1Operation:
        """A submittable operation from a run's stored spec: the raw
        operation (templates, matrix, queue and tags intact; a path or hub
        ref frozen to the component it resolved to), named `<name>-<suffix>`,
        with caching off so the clone actually runs."""
        spec = self.store.read_spec(src_uuid)
        if not spec or ("component" not in spec and "operation" not in spec):
            raise ClientError(f"run {src_uuid[:8]} has no stored spec")
        raw = spec.get("operation")
        if raw:
            data = dict(raw)
            if not data.get("component") and spec.get("component"):
                data["component"] = spec["component"]
                data.pop("pathRef", None)
                data.pop("hubRef", None)
            data["name"] = f"{spec.get('name') or raw.get('name') or 'run'}-{suffix}"
            data["cache"] = {"disable": True}
            return V1Operation.from_dict(data)
        params = {
            k: (v if isinstance(v, dict) and "value" in v else {"value": v})
            for k, v in (spec.get("params") or {}).items()
        }
        return V1Operation.from_dict({
            "name": f"{spec.get('name') or 'run'}-{suffix}",
            "component": spec["component"],
            "params": params or None,
            "cache": {"disable": True},
            "queue": spec.get("queue"),
            "tags": spec.get("tags"),
        })

    def _clone(self, uuid: str, suffix: str, *, op_patch=None, copy_outputs: bool,
               queue: bool) -> str:
        src = self.store.resolve(uuid)
        if copy_outputs:
            status = self.store.get_status(src).get("status")
            if status not in DONE_STATUSES:
                # copying a live run would snapshot half-written checkpoints
                raise ClientError(
                    f"cannot {suffix} run {src[:8]} while it is {status}; "
                    "wait for a terminal status or stop it first"
                )
        op = self._op_from_run(src, suffix)
        if op_patch is not None:
            op = op_patch(op)

        def prepare(compiled):
            if copy_outputs:
                src_out = self.store.outputs_dir(src)
                if src_out.exists():
                    shutil.copytree(src_out, self.store.outputs_dir(compiled.run_uuid),
                                    dirs_exist_ok=True)
            self.store.log_event(src, "lineage",
                                 {"child": compiled.run_uuid, "clone_kind": suffix})

        meta = {"cloned_from": src, "clone_kind": suffix}
        if queue:
            return self._agent().submit(op, project=self.project, meta=meta, prepare_fn=prepare)
        compiled = self._submit(op, meta=meta, prepare_fn=prepare)
        self._run_inline(compiled)
        return compiled.run_uuid

    def restart(self, uuid: str, *, queue: bool = True) -> str:
        """A fresh run from the source's spec (outputs start empty)."""
        return self._clone(uuid, "restart", copy_outputs=False, queue=queue)

    def copy(self, uuid: str, *, queue: bool = True) -> str:
        """A new run seeded with a copy of the source's outputs."""
        return self._clone(uuid, "copy", copy_outputs=True, queue=queue)

    def resume(self, uuid: str, *, queue: bool = True) -> str:
        """Continue training: the outputs (checkpoints included) are
        inherited and `train.resume` is forced on, so the trainer restores
        the newest checkpoint and goes on from its step."""

        def patch(op: V1Operation) -> V1Operation:
            data = op.to_dict()
            program = data.get("component", {}).get("run", {}).get("program")
            if program is not None:
                program.setdefault("train", {})["resume"] = True
            return V1Operation.from_dict(data)

        return self._clone(uuid, "resume", op_patch=patch, copy_outputs=True, queue=queue)

    # ---------------------------------------------------------------- read
    def _resolve(self, uuid: str) -> str:
        return self.store.resolve(uuid)

    def list(self, project: Optional[str] = None) -> list[dict]:
        return self.store.list_runs(project)

    def get(self, uuid: str) -> dict:
        return self.store.get_status(self._resolve(uuid))

    def statuses(self, uuid: str) -> list[dict]:
        return self.get(uuid).get("conditions", [])

    def logs(self, uuid: str, offset: int = 0) -> str:
        return self.store.read_logs(self._resolve(uuid))[offset:]

    def metrics(self, uuid: str) -> list[dict]:
        return self.store.read_metrics(self._resolve(uuid))

    def events(self, uuid: str) -> list[dict]:
        return self.store.read_events(self._resolve(uuid))

    def spec(self, uuid: str) -> dict:
        return self.store.read_spec(self._resolve(uuid)) or {}

    def artifacts(self, uuid: str) -> list[str]:
        root = self.store.outputs_dir(self._resolve(uuid))
        return [str(p.relative_to(root)) for p in sorted(root.rglob("*")) if p.is_file()]

    def download_artifact(self, uuid: str, path: str, dest) -> str:
        """Copy one output artifact to `dest` (a local file path)."""
        uuid = self._resolve(uuid)
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        root = self.store.outputs_dir(uuid)
        src = (root / path).resolve()
        root_resolved = root.resolve()
        if (src != root_resolved and root_resolved not in src.parents) or not src.is_file():
            raise ClientError(f"no artifact {path!r} in run {uuid[:8]}")
        shutil.copy2(src, dest)
        return str(dest)

    def wait(self, uuid: str, timeout: float = 3600, poll: float = 0.5) -> str:
        """Block until the run reaches a terminal status."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            status = self.get(uuid).get("status")
            if status in {str(s) for s in DONE_STATUSES} | set(DONE_STATUSES):
                return status
            time.sleep(poll)
        raise TimeoutError(f"run {uuid} not done after {timeout}s")
