"""Polyaxonfile reading: YAML/JSON → validated `V1Operation` /
`V1Component`, an own copy of `polyaxon_tpu/polyaxonfile/reader.py` over
the port's `yaml_lite` reader and dataclass specs.

- a file may hold a component or an operation; a bare component is
  wrapped into an operation so `run -f component.yaml` works;
- a multi-document stream yields one spec per document;
- `-P name=value` params override or extend the operation's params;
- a validation error carries the file and each failure's location.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional, Union

from ..schemas import SpecError, V1Component, V1Operation
from ..schemas.io import V1Param
from . import yaml_lite
from .yaml_lite import PolyaxonfileError

__all__ = [
    "PolyaxonfileError", "check_polyaxonfile", "parse_cli_param", "read_polyaxonfile",
    "read_specs", "wrap_component",
]


def _load_docs(path: Union[str, Path]) -> list[dict]:
    p = Path(path)
    if not p.exists():
        raise PolyaxonfileError(f"polyaxonfile not found: {p}")
    try:
        text = p.read_text(encoding="utf-8")
    except UnicodeDecodeError as e:
        raise PolyaxonfileError(
            f"polyaxonfile {p} is not a text file (binary or non-UTF-8): {e}"
        ) from e
    except OSError as e:
        raise PolyaxonfileError(f"polyaxonfile {p} is unreadable: {e}") from e
    try:
        if p.suffix == ".json":
            docs = [json.loads(text)]
        else:
            docs = [d for d in yaml_lite.safe_load_all(text) if d is not None]
    except (yaml_lite.YAMLError, json.JSONDecodeError) as e:
        raise PolyaxonfileError(f"polyaxonfile {p} is not valid YAML/JSON: {e}") from e
    if not docs:
        raise PolyaxonfileError(f"polyaxonfile is empty: {p}")
    for d in docs:
        if not isinstance(d, dict):
            raise PolyaxonfileError(
                f"polyaxonfile {p} must contain mappings, got {type(d).__name__}"
            )
    return docs


def _validate_doc(doc: dict, source: str) -> Union[V1Component, V1Operation]:
    kind = doc.get("kind")
    try:
        if kind == "component":
            return V1Component.from_dict(doc)
        if kind == "operation":
            return V1Operation.from_dict(doc)
    except SpecError as e:
        raise PolyaxonfileError(f"{source}: invalid {kind}: {e}") from e
    raise PolyaxonfileError(
        f"{source}: `kind` must be 'component' or 'operation', got {kind!r}"
    )


def wrap_component(component: V1Component) -> V1Operation:
    return V1Operation(component=component, name=component.name)


def read_specs(path: Union[str, Path]) -> list[V1Operation]:
    """Read a polyaxonfile into a list of operations (components wrapped)."""
    ops = []
    for doc in _load_docs(path):
        spec = _validate_doc(doc, str(path))
        ops.append(wrap_component(spec) if isinstance(spec, V1Component) else spec)
    return ops


def parse_cli_param(raw: str) -> tuple[str, Any]:
    """Parse `-P name=value`, YAML-decoding the value (so `-P lr=0.1` is a
    float, `-P layers=[1,2]` a list, and `-P lr=1e-3` the string '1e-3',
    as YAML 1.1 reads it)."""
    if "=" not in raw:
        raise PolyaxonfileError(f"bad param {raw!r}; expected name=value")
    name, _, value = raw.partition("=")
    try:
        parsed = yaml_lite.safe_load(value)
    except yaml_lite.YAMLError:
        parsed = value
    return name.strip(), parsed


def read_polyaxonfile(
    path: Union[str, Path],
    params: Optional[dict[str, Any]] = None,
    name: Optional[str] = None,
) -> V1Operation:
    """Read the first (or only) operation, applying CLI param overrides."""
    ops = read_specs(path)
    if len(ops) > 1:
        raise PolyaxonfileError(f"{path} holds {len(ops)} specs; pass one operation per run")
    op = ops[0]
    if params:
        merged = dict(op.params or {})
        for k, v in params.items():
            merged[k] = V1Param(value=v)
        op = op.copy(params=merged)
    if name:
        op = op.copy(name=name)
    return op


def check_polyaxonfile(path: Union[str, Path]) -> list[dict]:
    """Validate and return summaries without running."""
    out = []
    for op in read_specs(path):
        run_kind = None
        if op.component is not None and op.component.run is not None:
            run_kind = op.component.run.kind
        out.append({
            "name": op.name,
            "kind": "operation",
            "run_kind": run_kind,
            "params": sorted((op.params or {}).keys()),
            "matrix": getattr(op.matrix, "kind", None),
        })
    return out
