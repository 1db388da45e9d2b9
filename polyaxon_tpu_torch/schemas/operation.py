"""`V1Operation`: an invocation of a component with params, a matrix and
overrides, with its schedule, join and hook blocks. An own copy of
`polyaxon_tpu/schemas/operation.py`."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .base import Spec
from .component import V1Cache, V1Component, V1Plugins
from .environment import V1Environment
from .io import V1Param
from .matrix import V1MatrixField
from .termination import V1Termination

_PARAM_KEYS = {"value", "ref", "contextOnly", "context_only", "connection", "toInit", "to_init"}


@dataclasses.dataclass
class V1Schedule(Spec):
    kind: str = "cron"  # cron | interval | datetime
    cron: Optional[str] = None
    start_at: Optional[str] = None
    end_at: Optional[str] = None
    frequency: Optional[int] = None  # seconds, for interval
    max_runs: Optional[int] = None
    depends_on_past: Optional[bool] = None


@dataclasses.dataclass(kw_only=True)
class V1Join(Spec):
    query: str
    sort: Optional[str] = None
    limit: Optional[int] = None
    params: Optional[dict[str, V1Param]] = None


@dataclasses.dataclass
class V1Hook(Spec):
    hub_ref: Optional[str] = None
    path_ref: Optional[str] = None
    trigger: Optional[str] = None  # succeeded | failed | done
    connection: Optional[str] = None
    params: Optional[dict[str, V1Param]] = None


@dataclasses.dataclass
class V1Operation(Spec):
    version: float | str = 1.1
    kind: str = "operation"
    name: Optional[str] = None
    description: Optional[str] = None
    tags: Optional[list[str]] = None
    project: Optional[str] = None
    queue: Optional[str] = None
    presets: Optional[list[str]] = None
    cache: Optional[V1Cache] = None
    termination: Optional[V1Termination] = None
    plugins: Optional[V1Plugins] = None
    environment: Optional[V1Environment] = None  # patch onto component.run.environment
    params: Optional[dict[str, V1Param]] = None
    matrix: Optional[V1MatrixField] = None
    joins: Optional[list[V1Join]] = None
    schedule: Optional[V1Schedule] = None
    events: Optional[list[dict]] = None
    hooks: Optional[list[V1Hook]] = None
    dependencies: Optional[list[str]] = None
    trigger: Optional[str] = None
    conditions: Optional[str] = None
    skip_on_upstream_skip: Optional[bool] = None
    patch_strategy: Optional[str] = None  # replace | isnull | post_merge | pre_merge
    is_preset: Optional[bool] = None
    is_approved: Optional[bool] = None
    # component resolution (at most one)
    component: Optional[V1Component] = None
    hub_ref: Optional[str] = None
    path_ref: Optional[str] = None
    url_ref: Optional[str] = None
    dag_ref: Optional[str] = None
    # run-section patch (merged onto the component's run at compile time)
    run_patch: Optional[dict[str, Any]] = None

    @classmethod
    def _check_kind(cls, v):
        if v != "operation":
            raise ValueError(f"operation kind must be 'operation', got {v!r}")
        return v

    @classmethod
    def _before_params(cls, v):
        """Shorthand `params: {lr: 0.1}` → `{lr: {value: 0.1}}`."""
        if not isinstance(v, dict):
            return v
        return {
            k: p if isinstance(p, dict) and (_PARAM_KEYS & set(p)) else {"value": p}
            for k, p in v.items()
        }

    def __post_init__(self):
        refs = [
            r for r in (self.component, self.hub_ref, self.path_ref, self.url_ref, self.dag_ref)
            if r is not None
        ]
        if len(refs) > 1:
            raise ValueError(
                "operation must set at most one of component/hubRef/pathRef/urlRef/dagRef"
            )

    @property
    def has_component(self) -> bool:
        return self.component is not None
