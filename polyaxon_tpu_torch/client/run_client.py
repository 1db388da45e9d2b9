"""`RunClient` and `ProjectClient`, the SDK surface: an own copy of
`polyaxon_tpu/client/run_client.py`. Two transports behind one API:

- local (the default): the file-backed run store itself;
- HTTP (`base_url=`): the streams and control service
  (`streams/server.py`): create and stop over POST, delete over DELETE,
  status, logs, metrics, events, spec and artifacts over GET.

    client = RunClient()                             # local
    client = RunClient(base_url="http://host:8585")  # remote
    uuid = client.create(op)                # compile and queue it for an agent
    uuid = client.create(op, queue=False)   # compile and run it here (local)
    client.logs(uuid); client.metrics(uuid); client.statuses(uuid)
    client.stop(uuid)
    client.resume(uuid, queue=False)        # a new run from the newest checkpoint

`restart`, `copy` and `resume` make a new run from the source's stored
operation (with `cloned_from`/`clone_kind` in its meta and a `lineage`
event on the source), queued for an agent (`queue=True`, the default:
`scheduler/agent.py::Agent.submit`) or run in this process. They need
the store: over HTTP alone (no `store=`) they raise `ClientError`.
"""

from __future__ import annotations

import json
import shutil
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Callable, Optional

from ..schemas.lifecycle import DONE_STATUSES, V1Statuses
from ..schemas.operation import V1Operation
from ..store import RunStore


class ClientError(Exception):
    pass


class _HttpTransport:
    """JSON over HTTP to the streams service; an error status raises
    `ClientError` with the server's `error` detail."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def get(self, path: str) -> Any:
        return self.request("GET", path)

    def post(self, path: str, body: Optional[dict] = None) -> Any:
        return self.request("POST", path, body or {})

    def request(self, method: str, path: str, body: Optional[dict] = None) -> Any:
        return json.loads(self.fetch(method, path, body))

    def fetch(self, method: str, path: str, body: Optional[dict] = None) -> bytes:
        """The raw response body of `method path`."""
        data = None if body is None and method == "GET" else json.dumps(body or {}).encode()
        req = urllib.request.Request(self.base_url + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = ": " + json.loads(e.read()).get("error", "")
            except Exception:  # noqa: BLE001 — the detail is best-effort
                pass
            raise ClientError(f"{method} {path}: HTTP {e.code}{detail}") from e
        except urllib.error.URLError as e:
            raise ClientError(f"{method} {path}: {e.reason}") from e


class RunClient:
    def __init__(self, base_url: Optional[str] = None, store: Optional[RunStore] = None,
                 project: str = "default", device=None):
        self.project = project
        self.device = device
        self._http = _HttpTransport(base_url) if base_url else None
        self._store = store if store is not None else (None if base_url else RunStore())

    @property
    def store(self) -> RunStore:
        if self._store is None:
            raise ClientError("mutating operations need a local store (no base_url mode)")
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
        if self._http:  # the service queues it for the agent draining its store
            return self._http.post("/runs", {"operation": op.to_dict(),
                                             "project": self.project})["uuid"]
        if queue:
            return self._agent().submit(op, project=self.project)
        compiled = self._submit(op)
        self._run_inline(compiled)
        return compiled.run_uuid

    def stop(self, uuid: str):
        if self._http:
            self._http.post(f"/runs/{uuid}/stop")
            return
        self.store.request_stop(self.store.resolve(uuid))

    def delete(self, uuid: str, *, cascade: bool = False):
        """Permanently delete a finished run's data (`cascade` for a sweep's
        trials)."""
        if self._http:
            self._http.request("DELETE", f"/runs/{uuid}" + ("?cascade=true" if cascade else ""))
            return
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
        if self._http:
            return uuid  # the server resolves short uuids
        return self.store.resolve(uuid)

    def list(self, project: Optional[str] = None) -> list[dict]:
        if self._http:
            return self._http.get("/runs" + (f"?project={project}" if project else ""))
        return self.store.list_runs(project)

    def get(self, uuid: str) -> dict:
        uuid = self._resolve(uuid)
        if self._http:
            return self._http.get(f"/runs/{uuid}/status")
        return self.store.get_status(uuid)

    def statuses(self, uuid: str) -> list[dict]:
        return self.get(uuid).get("conditions", [])

    def logs(self, uuid: str, offset: int = 0) -> str:
        uuid = self._resolve(uuid)
        if self._http:
            return self._http.get(f"/runs/{uuid}/logs?offset={offset}")["logs"]
        return self.store.read_logs(uuid)[offset:]

    def metrics(self, uuid: str) -> list[dict]:
        uuid = self._resolve(uuid)
        if self._http:
            return self._http.get(f"/runs/{uuid}/metrics")
        return self.store.read_metrics(uuid)

    def events(self, uuid: str) -> list[dict]:
        uuid = self._resolve(uuid)
        if self._http:
            return self._http.get(f"/runs/{uuid}/events")
        return self.store.read_events(uuid)

    def spec(self, uuid: str) -> dict:
        """The run's compiled spec (remotely GET /runs/<uuid>/spec)."""
        uuid = self._resolve(uuid)
        if self._http:
            return self._http.get(f"/runs/{uuid}/spec") or {}
        return self.store.read_spec(uuid) or {}

    def artifacts(self, uuid: str) -> list[str]:
        uuid = self._resolve(uuid)
        if self._http:
            return self._http.get(f"/runs/{uuid}/artifacts")["files"]
        root = self.store.outputs_dir(uuid)
        return [str(p.relative_to(root)) for p in sorted(root.rglob("*")) if p.is_file()]

    def download_artifact(self, uuid: str, path: str, dest) -> str:
        """Fetch one output artifact to `dest` (a local file path)."""
        uuid = self._resolve(uuid)
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        if self._http:
            dest.write_bytes(self._http.fetch("GET", f"/runs/{uuid}/artifacts/{path}"))
            return str(dest)
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


class ProjectClient:
    """The project registry: `projects.json` under the store's home, plus
    the implicit projects the index's runs name."""

    def __init__(self, store: Optional[RunStore] = None):
        self.store = store or RunStore()
        self.path = self.store.home / "projects.json"

    def _read(self) -> dict:
        if self.path.exists():
            return json.loads(self.path.read_text())
        return {}

    def _write(self, data: dict):
        self.path.write_text(json.dumps(data, indent=1))

    def create(self, name: str, description: str = "") -> dict:
        projects = self._read()
        if name in projects:
            raise ClientError(f"project {name!r} already exists")
        projects[name] = {"name": name, "description": description, "created_at": time.time()}
        self._write(projects)
        return projects[name]

    def get(self, name: str) -> dict:
        projects = self._read()
        if name not in projects:
            # an implicit project exists once a run names it
            runs = self.store.list_runs(name)
            if runs:
                return {"name": name, "description": "(implicit)", "runs": len(runs)}
            raise ClientError(f"unknown project {name!r}")
        return {**projects[name], "runs": len(self.store.list_runs(name))}

    def list(self) -> list[dict]:
        projects = dict(self._read())
        for rec in self.store.list_runs():
            projects.setdefault(rec["project"], {"name": rec["project"],
                                                 "description": "(implicit)"})
        return [self.get(n) for n in sorted(projects)]

    def delete(self, name: str):
        projects = self._read()
        projects.pop(name, None)
        self._write(projects)
