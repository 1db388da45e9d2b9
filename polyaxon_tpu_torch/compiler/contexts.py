"""Compile-time context: the params and globals that templates read
(`{{ params.* }}`, `{{ globals.run_outputs_path }}`). An own copy of
`polyaxon_tpu/compiler/contexts.py`."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

from ..schemas import V1Component, V1Operation
from .interpolation import CompilationError


def resolve_params(
    op: V1Operation, component: V1Component
) -> dict[str, Any]:
    """Merge operation params onto component input defaults, validating types.

    Unknown params (no matching input) are allowed as context-only values,
    matching the reference's contextOnly behavior; declared inputs are
    type-checked via V1IO.validate_value.
    """
    values: dict[str, Any] = {}
    inputs = {io.name: io for io in (component.inputs or [])}
    given = {k: p.value for k, p in (op.params or {}).items() if p.ref is None}

    for name, io in inputs.items():
        if name in given:
            try:
                values[name] = io.validate_value(given.pop(name))
            except ValueError as e:
                raise CompilationError(str(e)) from e
        else:
            try:
                values[name] = io.validate_value(None)
            except ValueError as e:
                raise CompilationError(str(e)) from e
    # leftover params: context-only extras
    values.update(given)
    return values


def build_globals(
    *,
    run_uuid: str,
    run_name: Optional[str],
    project: Optional[str],
    artifacts_root: str,
    iteration: Optional[int] = None,
) -> dict[str, Any]:
    run_path = str(Path(artifacts_root) / run_uuid)
    return {
        "uuid": run_uuid,
        "name": run_name or run_uuid,
        "project_name": project or "default",
        "iteration": iteration,
        "run_artifacts_path": run_path,
        "run_outputs_path": str(Path(run_path) / "outputs"),
        "run_events_path": str(Path(run_path) / "events"),
        "run_logs_path": str(Path(run_path) / "logs"),
        "run_checkpoints_path": str(Path(run_path) / "outputs" / "checkpoints"),
    }


def build_context(
    params: dict[str, Any], globs: dict[str, Any]
) -> dict[str, Any]:
    return {"params": params, "globals": globs}
