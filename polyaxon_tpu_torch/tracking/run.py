"""The in-job tracking client, an own copy of
`polyaxon_tpu/tracking/run.py`. Inside a run's container it attaches to
the run that the executor's `POLYAXON_RUN_*` variables name
(`runtime/executor.py::_context_env`); without them it creates a run of
its own and owns its lifecycle:

    from polyaxon_tpu_torch import tracking
    run = tracking.init()                  # or init(name=..., project=...)
    run.log_metrics(loss=0.3, step=10)
    run.log_artifact("/path/to/file")
    run.end()

Everything goes straight to the run's files in the store (metrics, events,
logs, outputs), the files the streams service serves. `log_image` and
`log_histogram` take numpy arrays or CPU tensors.
"""

from __future__ import annotations

import os
import shutil
import uuid as _uuid
from pathlib import Path
from typing import Any, Optional

import numpy as np

from ..schemas.lifecycle import V1Statuses
from ..store import RunStore

_active_run: Optional["Run"] = None


def _host_array(data) -> np.ndarray:
    """A numpy array of `data` (an array, a list or a tensor)."""
    if hasattr(data, "detach"):
        data = data.detach().cpu().numpy()
    return np.asarray(data)


class Run:
    def __init__(self, run_uuid: Optional[str] = None, *, name: Optional[str] = None,
                 project: Optional[str] = None, store: Optional[RunStore] = None,
                 is_new: bool = False):
        self.store = store or RunStore()
        self.uuid = run_uuid or os.environ.get("POLYAXON_RUN_UUID")
        self._owns_lifecycle = is_new
        if self.uuid is None:  # a script outside an orchestrated run: a run of its own
            self.uuid = _uuid.uuid4().hex
            self.store.create_run(
                self.uuid, name or f"tracked-{self.uuid[:8]}",
                project or os.environ.get("POLYAXON_PROJECT", "default"),
                spec={"kind": "tracked"},
            )
            for status in (V1Statuses.COMPILED, V1Statuses.QUEUED, V1Statuses.SCHEDULED,
                           V1Statuses.RUNNING):
                self.store.set_status(self.uuid, status)
            self._owns_lifecycle = True
        self._step = 0

    # ------------------------------------------------------------- logging
    def log_metrics(self, step: Optional[int] = None, **metrics: float):
        """One metrics row at `step` (the next step after the last when
        None)."""
        if step is None:
            step = self._step
        self._step = step + 1
        self.store.log_metrics(self.uuid, step, {k: float(v) for k, v in metrics.items()})

    def log_metric(self, name: str, value: float, step: Optional[int] = None):
        self.log_metrics(step=step, **{name: value})

    def log_outputs(self, **outputs: Any):
        self.store.log_event(self.uuid, "outputs", {"outputs": outputs})

    def log_tags(self, *tags: str):
        self.store.log_event(self.uuid, "tags", {"tags": list(tags)})

    def log_artifact(self, path: str, name: Optional[str] = None, kind: str = "file"):
        """Copy a file into the run's outputs, with an `artifact` event."""
        src = Path(path)
        dst = self.outputs_path / (name or src.name)
        dst.parent.mkdir(parents=True, exist_ok=True)
        if src.resolve() != dst.resolve():
            shutil.copy2(src, dst)
        self.store.log_event(self.uuid, "artifact", {"name": name or src.name, "path": str(dst),
                                                     "artifact_kind": kind})
        return str(dst)

    def log_text(self, text: str):
        self.store.append_log(self.uuid, text)

    def log_image(self, data, name: str, step: Optional[int] = None):
        """An `image` event: `data` a path (copied) or an array or CPU
        tensor (saved as .npy)."""
        img_dir = self.outputs_path / "images"
        img_dir.mkdir(parents=True, exist_ok=True)
        if isinstance(data, (str, Path)):
            dst = img_dir / Path(data).name
            shutil.copy2(data, dst)
        else:
            dst = img_dir / f"{name}.npy"
            np.save(dst, _host_array(data))
        self.store.log_event(self.uuid, "image", {
            "name": name, "path": str(dst), "step": self._step if step is None else step})
        return str(dst)

    def log_histogram(self, name: str, values, bins: int = 30, step: Optional[int] = None):
        """A `histogram` event with its bin edges and counts inline."""
        counts, edges = np.histogram(_host_array(values).ravel(), bins=bins)
        self.store.log_event(self.uuid, "histogram", {
            "name": name, "counts": counts.tolist(), "edges": edges.tolist(),
            "step": self._step if step is None else step})

    def log_html(self, name: str, html: str):
        dst = self.outputs_path / f"{name}.html"
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(html)
        self.store.log_event(self.uuid, "html", {"name": name, "path": str(dst)})
        return str(dst)

    # ---------------------------------------------------------------- info
    @property
    def outputs_path(self) -> Path:
        env = os.environ.get("POLYAXON_RUN_OUTPUTS_PATH")
        return Path(env) if env else self.store.outputs_dir(self.uuid)

    def get_metrics(self) -> list[dict]:
        return self.store.read_metrics(self.uuid)

    def get_status(self) -> str:
        return self.store.get_status(self.uuid).get("status", "unknown")

    def refresh_data(self) -> dict:
        return self.store.get_status(self.uuid)

    # ----------------------------------------------------------- lifecycle
    def end(self, status: str = V1Statuses.SUCCEEDED):
        """Set `status` on a run this client created; detach either way."""
        global _active_run
        if self._owns_lifecycle:
            self.store.set_status(self.uuid, status)
        if _active_run is self:
            _active_run = None


def init(**kwargs) -> Run:
    """The process's tracked run, created or attached on the first call."""
    global _active_run
    if _active_run is None:
        _active_run = Run(**kwargs)
    return _active_run


def get_or_create_run() -> Run:
    return init()


def log_metrics(step: Optional[int] = None, **metrics):
    init().log_metrics(step=step, **metrics)


def end(status: str = V1Statuses.SUCCEEDED):
    if _active_run is not None:
        _active_run.end(status)
