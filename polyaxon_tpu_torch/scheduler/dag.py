"""DAG execution, an own copy of `polyaxon_tpu/scheduler/dag.py`: a
topological schedule of a `V1Dag`'s operations.

Kahn topological order, honoring `dependsOn` edges, per-node trigger
policies (all_succeeded/all_done/one_succeeded/one_done/all_failed/
one_failed), and `concurrency` for sibling fan-out (ready nodes run in a
thread pool — each child is its own run in the store). A node with a
`matrix:` is a sweep, run through `tuner/driver.py::run_sweep`.

Params flow: a child's `params` may reference upstream outputs with
`{{ ops.<name>.outputs.<key> }}`; outputs are the final metrics each child
logged (its `run_summary` event), and a sweep node's are `best_objective`
and `best.<param>` of its winner.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from ..compiler.resolver import CompilationError, compile_operation
from ..schemas.lifecycle import V1Statuses
from ..schemas.operation import V1Operation


class DagError(Exception):
    pass


def topo_order(nodes: dict[str, Any]) -> list[list[str]]:
    """Kahn levels: list of waves, each wave independent given prior waves."""
    deps = {
        name: set(node.depends_on or ()) for name, node in nodes.items()
    }
    for name, d in deps.items():
        unknown = d - set(nodes)
        if unknown:
            raise DagError(f"operation {name!r} depends on unknown {sorted(unknown)}")
    done: set[str] = set()
    waves: list[list[str]] = []
    remaining = dict(deps)
    while remaining:
        ready = sorted(n for n, d in remaining.items() if d <= done)
        if not ready:
            raise DagError(
                f"dependency cycle among {sorted(remaining)}"
            )
        waves.append(ready)
        done.update(ready)
        for n in ready:
            remaining.pop(n)
    return waves


def _trigger_met(trigger: Optional[str], dep_statuses: list[str]) -> bool:
    trigger = trigger or "all_succeeded"
    succeeded = [s == V1Statuses.SUCCEEDED for s in dep_statuses]
    done = [
        s
        in (
            V1Statuses.SUCCEEDED,
            V1Statuses.FAILED,
            V1Statuses.STOPPED,
            V1Statuses.SKIPPED,
            V1Statuses.UPSTREAM_FAILED,
        )
        for s in dep_statuses
    ]
    failed = [s == V1Statuses.FAILED for s in dep_statuses]
    if trigger == "all_succeeded":
        return all(succeeded)
    if trigger == "all_done":
        return all(done)
    if trigger == "one_succeeded":
        return any(succeeded) if dep_statuses else True
    if trigger == "one_done":
        return any(done) if dep_statuses else True
    if trigger == "all_failed":
        return all(failed) if dep_statuses else False
    if trigger == "one_failed":
        return any(failed)
    raise DagError(f"unknown trigger {trigger!r}")


def _node_operation(node, dag_environment) -> V1Operation:
    data: dict[str, Any] = {"name": node.name}
    if node.component is not None:
        data["component"] = node.component
    if node.path_ref:
        data["pathRef"] = node.path_ref
    if node.hub_ref:
        data["hubRef"] = node.hub_ref
    if node.params:
        data["params"] = node.params
    if getattr(node, "matrix", None):
        data["matrix"] = node.matrix
    if dag_environment is not None:
        data["environment"] = dag_environment.to_dict()
    try:
        return V1Operation.from_dict(data)
    except Exception as e:
        raise DagError(f"dag operation {node.name!r} invalid: {e}") from e


def _resolve_ops_context(params: Optional[dict], outputs: dict[str, dict]) -> Optional[dict]:
    """Substitute {{ ops.<name>.outputs.<key> }} templates in param values."""
    if not params:
        return params
    import re

    pat = re.compile(r"^\s*\{\{\s*ops\.([\w-]+)\.outputs\.([\w./-]+)\s*\}\}\s*$")

    def sub(v):
        if isinstance(v, str):
            m = pat.match(v)
            if m:
                name, key = m.group(1), m.group(2)
                if name not in outputs:
                    raise DagError(f"ops context: no upstream run named {name!r}")
                if key not in outputs[name]:
                    raise DagError(
                        f"ops context: upstream {name!r} has no output {key!r} "
                        f"(has {sorted(outputs[name])})"
                    )
                return outputs[name][key]
        if isinstance(v, dict):
            if "value" in v:
                return {**v, "value": sub(v["value"])}
            return {k: sub(x) for k, x in v.items()}
        if hasattr(v, "value"):  # V1Param after operation validation
            return v.copy(value=sub(v.value))
        return v

    return {k: sub(v) for k, v in params.items()}


def execute_dag(compiled, executor) -> None:
    """Run a compiled DAG operation. Raises on any child failure whose
    trigger semantics make the DAG fail (default all_succeeded chain)."""
    dag = compiled.run
    store = executor.store
    nodes = {node.name: node for node in dag.operations}
    if not nodes:
        return
    waves = topo_order(nodes)
    statuses: dict[str, str] = {}
    outputs: dict[str, dict] = {}
    concurrency = dag.concurrency or 1

    def run_node(name: str):
        node = nodes[name]
        dep_statuses = [statuses[d] for d in (node.depends_on or ())]
        if not _trigger_met(node.trigger, dep_statuses):
            # default all_succeeded unmet means an upstream failed → the DAG
            # fails; an explicit conditional trigger unmet is a benign skip
            default = node.trigger in (None, "all_succeeded")
            statuses[name] = (
                V1Statuses.UPSTREAM_FAILED if default else V1Statuses.SKIPPED
            )
            store.append_log(
                compiled.run_uuid,
                f"dag node {name}: trigger {node.trigger or 'all_succeeded'} "
                f"unmet (deps {dep_statuses}) — "
                + ("failing" if default else "skipping"),
            )
            return
        op = _node_operation(node, dag.environment)
        try:
            op = op.copy(params=_resolve_ops_context(op.params, outputs))
        except DagError as e:
            # missing upstream output: fail THIS node through the normal
            # bookkeeping (raising here would abort sibling collection)
            statuses[name] = V1Statuses.FAILED
            store.append_log(compiled.run_uuid, f"dag node {name}: {e}")
            return
        if op.matrix is not None:
            # a SWEEP node: drive it through the tuner (a plain compile
            # would silently drop the matrix). Downstream nodes read the
            # winner via {{ ops.<name>.outputs.best.<param> }} — the
            # sweep-then-train-best pipeline.
            from ..tuner.driver import run_sweep
            from ..tuner.placement import device_pool

            try:
                summary = run_sweep(
                    op,
                    store=store,
                    project=compiled.project,
                    # the executor's group, else the pool its device names
                    devices=executor.devices
                    if executor.devices is not None
                    else device_pool(executor.device),
                    log_fn=lambda line: store.append_log(
                        compiled.run_uuid, f"dag node {name}: {line}"
                    ),
                )
            except Exception as e:  # noqa: BLE001 — node fails, DAG decides
                statuses[name] = V1Statuses.FAILED
                store.append_log(
                    compiled.run_uuid, f"dag node {name}: sweep failed: {e}"
                )
                return
            sweep_status = summary.get("status")
            best = summary.get("best")
            if sweep_status == V1Statuses.STOPPED:
                # a user stop is neither success nor failure: downstream
                # all_succeeded triggers won't fire, all_done ones can
                statuses[name] = V1Statuses.STOPPED
                store.append_log(
                    compiled.run_uuid, f"dag node {name}: sweep stopped"
                )
                return
            if not best or sweep_status == V1Statuses.FAILED:
                # no trial produced the objective: the sweep run is FAILED
                # (driver semantics) and downstream best.* must not resolve
                statuses[name] = V1Statuses.FAILED
                store.append_log(
                    compiled.run_uuid,
                    f"dag node {name}: sweep produced no winner",
                )
                return
            statuses[name] = V1Statuses.SUCCEEDED
            node_out = {"best_objective": best.get("objective")}
            for k, v in (best.get("params") or {}).items():
                node_out[f"best.{k}"] = v
            outputs[name] = node_out
            store.append_log(
                compiled.run_uuid,
                f"dag node {name}: sweep {summary['sweep'][:8]} done, "
                f"best {best.get('params')}",
            )
            return
        try:
            child = compile_operation(op, project=compiled.project)
        except CompilationError as e:
            statuses[name] = V1Statuses.FAILED
            store.append_log(compiled.run_uuid, f"dag node {name}: compile failed: {e}")
            return
        store.append_log(
            compiled.run_uuid, f"dag node {name}: run {child.run_uuid[:8]}"
        )
        status = executor.execute(child)
        statuses[name] = status
        # harvest outputs for downstream ops context
        summary = {}
        for ev in store.read_events(child.run_uuid):
            if ev.get("kind") == "run_summary":  # store flattens body into the record
                summary = dict(ev.get("final_metrics", {}))
        outputs[name] = summary

    for wave in waves:
        if concurrency > 1 and len(wave) > 1:
            with ThreadPoolExecutor(max_workers=concurrency) as pool:
                list(pool.map(run_node, wave))
        else:
            for name in wave:
                run_node(name)

    bad = {
        n: s
        for n, s in statuses.items()
        if s in (V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED)
    }
    if bad:
        raise DagError(f"dag children failed: {bad}")
