"""Joins, an own copy of `polyaxon_tpu/scheduler/joins.py`: query past runs
and inject their outputs as list params.

A join's `query` selects runs from the store, `sort`/`limit` order and cap
them, and each join param's `ref` names what to collect from every matched
run:

    joins:
    - query: "project:default status:succeeded tag:sweep metrics.loss:<1.0"
      sort: "metrics.loss"          # or -metrics.loss (descending)
      limit: 5
      params:
        top_runs: {ref: "runs.uuid"}
        losses:   {ref: "runs.outputs.loss"}
        ckpts:    {ref: "runs.artifacts_path"}

Resolution happens at submit time (resolve_joins), so the operation
compiles with concrete list-valued params.
"""
from __future__ import annotations

from typing import Any, Optional

from ..schemas.io import V1Param
from ..schemas.operation import V1Operation
from ..store import RunStore


class JoinError(Exception):
    pass


def _last_metrics(store: RunStore, uuid: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for rec in store.read_metrics(uuid):
        for k, v in rec.items():
            if k not in ("step", "ts") and isinstance(v, (int, float)):
                out[k] = float(v)
    return out


def query_runs(
    store: RunStore,
    query: str,
    sort: Optional[str] = None,
    limit: Optional[int] = None,
) -> list[dict]:
    """Filter store runs by `field:value` terms; returns enriched records
    (index fields + status + last metrics)."""
    terms = [t for t in query.replace(",", " ").split() if t]
    filters = []
    for term in terms:
        if ":" not in term:
            raise JoinError(f"bad query term {term!r}; expected field:value")
        field, value = term.split(":", 1)
        filters.append((field, value))

    matched = []
    for rec in store.list_runs():
        uuid = rec["uuid"]
        status = store.get_status(uuid).get("status", "")
        metrics = None  # lazy
        ok = True
        for field, value in filters:
            if field == "project":
                ok = rec.get("project") == value
            elif field == "status":
                ok = str(status) == value
            elif field == "name":
                ok = value in (rec.get("name") or "")
            elif field == "tag":
                ok = value in (rec.get("tags") or [])
            elif field.startswith("metrics."):
                if metrics is None:
                    metrics = _last_metrics(store, uuid)
                name = field[len("metrics."):]
                if name not in metrics:
                    ok = False
                else:
                    m = metrics[name]
                    if value.startswith("<"):
                        ok = m < float(value[1:])
                    elif value.startswith(">"):
                        ok = m > float(value[1:])
                    else:
                        ok = m == float(value)
            else:
                raise JoinError(f"unknown query field {field!r}")
            if not ok:
                break
        if ok:
            if metrics is None:
                metrics = _last_metrics(store, uuid)
            matched.append({**rec, "status": str(status), "metrics": metrics})

    if sort:
        desc = sort.startswith("-")
        key = sort.lstrip("-")
        if key.startswith("metrics."):
            name = key[len("metrics."):]
            matched.sort(key=lambda r: r["metrics"].get(name, float("inf")), reverse=desc)
        else:
            matched.sort(key=lambda r: r.get(key) or 0, reverse=desc)
    if limit:
        matched = matched[: int(limit)]
    return matched


def _collect(store: RunStore, runs: list[dict], ref: str) -> list[Any]:
    if ref in ("runs.uuid", "runs"):
        return [r["uuid"] for r in runs]
    if ref == "runs.name":
        return [r.get("name") for r in runs]
    if ref == "runs.artifacts_path":
        return [str(store.outputs_dir(r["uuid"])) for r in runs]
    if ref.startswith("runs.outputs."):
        name = ref[len("runs.outputs."):]
        return [r["metrics"].get(name) for r in runs]
    raise JoinError(
        f"unknown join ref {ref!r}; expected runs.uuid | runs.name | "
        "runs.artifacts_path | runs.outputs.<metric>"
    )


def resolve_joins(op: V1Operation, store: Optional[RunStore] = None) -> V1Operation:
    """Materialize every join into concrete list params on the operation."""
    if not op.joins:
        return op
    store = store or RunStore()
    params = dict(op.params or {})
    for join in op.joins:
        runs = query_runs(store, join.query, join.sort, join.limit)
        for name, param in (join.params or {}).items():
            if not param.ref:
                raise JoinError(f"join param {name!r} needs a ref")
            params[name] = V1Param(value=_collect(store, runs, param.ref))
    return op.copy(params=params, joins=None)
