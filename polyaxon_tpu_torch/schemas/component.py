"""`V1Component`, the reusable unit of execution, with its cache, plugins
and build blocks: an own copy of `polyaxon_tpu/schemas/component.py`."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .base import Spec
from .io import V1IO
from .run_kinds import V1RunKindField
from .termination import V1Termination


@dataclasses.dataclass
class V1Plugins(Spec):
    auth: Optional[bool] = None
    docker: Optional[bool] = None
    shm: Optional[bool] = None
    collect_artifacts: Optional[bool] = None
    collect_logs: Optional[bool] = None
    collect_resources: Optional[bool] = None
    sync_statuses: Optional[bool] = None
    auto_resume: Optional[bool] = None
    log_level: Optional[str] = None


@dataclasses.dataclass
class V1Cache(Spec):
    disable: Optional[bool] = None
    ttl: Optional[int] = None


@dataclasses.dataclass
class V1Build(Spec):
    hub_ref: Optional[str] = None
    connection: Optional[str] = None
    params: Optional[dict[str, Any]] = None


@dataclasses.dataclass(kw_only=True)
class V1Component(Spec):
    version: float | str = 1.1
    kind: str = "component"
    name: Optional[str] = None
    description: Optional[str] = None
    tags: Optional[list[str]] = None
    presets: Optional[list[str]] = None
    queue: Optional[str] = None
    cache: Optional[V1Cache] = None
    termination: Optional[V1Termination] = None
    plugins: Optional[V1Plugins] = None
    build: Optional[V1Build] = None
    hooks: Optional[list[dict]] = None
    inputs: Optional[list[V1IO]] = None
    outputs: Optional[list[V1IO]] = None
    run: V1RunKindField

    @classmethod
    def _check_kind(cls, v):
        if v != "component":
            raise ValueError(f"component kind must be 'component', got {v!r}")
        return v

    def get_input(self, name: str) -> Optional[V1IO]:
        for io in self.inputs or []:
            if io.name == name:
                return io
        return None

    def get_output(self, name: str) -> Optional[V1IO]:
        for io in self.outputs or []:
            if io.name == name:
                return io
        return None
