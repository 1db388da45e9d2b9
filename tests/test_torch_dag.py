"""The port's DAGs (`scheduler/dag.py`) and joins (`scheduler/joins.py`)
against the JAX package's, on the CPU: the same `dag` operation through
both executors (the JAX one pinned to one device, the port's on the CPU),
each node's status, its params and the DAG run's conditions held equal.

- a chain whose second node reads `{{ ops.<first>.outputs.loss }}` from a
  tiny MLP program (the port's trainer starts from the JAX trainer's
  initial params, so the loss agrees within 1e-4 relative);
- an upstream failure: an `all_succeeded` child is upstream_failed, an
  `all_done` child still runs, an `all_failed` one too, a
  `one_succeeded` one is skipped, and the DAG fails;
- siblings fanned out over `concurrency: 2`;
- a sweep node (a grid over two learning rates) whose winner feeds
  `{{ ops.search.outputs.best.lr }}` downstream — the sweep-then-train-best
  pipeline;
- `topo_order` and its errors;
- `query_runs`/`resolve_joins` give the same params over two equal stores.
"""

import re

import jax
import numpy as np
import pytest

from polyaxon_tpu.compiler import compile_operation as jax_compile
from polyaxon_tpu.runtime.executor import Executor as JaxExecutor
from polyaxon_tpu.scheduler import dag as jax_dag
from polyaxon_tpu.scheduler import joins as jax_joins
from polyaxon_tpu.schemas import V1Operation as JaxOperation
from polyaxon_tpu.store.local import RunStore as JaxStore
from polyaxon_tpu_torch.compiler import compile_operation
from polyaxon_tpu_torch.runtime.executor import Executor
from polyaxon_tpu_torch.scheduler import dag, joins
from polyaxon_tpu_torch.schemas import V1Operation
from polyaxon_tpu_torch.store import RunStore
from torch_init_carry import InitCarry

DAG_UUID = "da9" * 10 + "00"


def job(command="true", inputs=()):
    return {"kind": "component", "name": "job",
            "inputs": [{"name": n, "type": t} for n, t in inputs],
            "run": {"kind": "job", "container": {"command": [command]}}}


MLP = {"kind": "component", "name": "mlp",
       "inputs": [{"name": "lr", "type": "float", "value": 0.01},
                  {"name": "steps", "type": "int", "value": 4}],
       "run": {"kind": "jaxjob", "program": {
           "model": {"name": "mlp", "config": {"input_dim": 16, "num_classes": 4,
                                               "hidden": [32]}},
           "data": {"name": "synthetic", "batchSize": 16,
                    "config": {"shape": [16], "num_classes": 4}},
           "optimizer": {"name": "adamw", "learningRate": "{{ params.lr }}"},
           "train": {"steps": "{{ params.steps }}", "logEvery": 2, "precision": "float32"}}}}


def dag_op(operations, **extra):
    return {"kind": "operation", "name": "pipeline",
            "component": {"kind": "component", "name": "pipeline",
                          "run": {"kind": "dag", "operations": operations, **extra}}}


DAGS = {
    "chain": dag_op([
        {"name": "train", "component": MLP, "params": {"lr": 0.05}},
        {"name": "report", "dependsOn": ["train"],
         "component": job(inputs=[("loss", "float")]),
         "params": {"loss": "{{ ops.train.outputs.loss }}"}},
    ]),
    "upstream-failure": dag_op([
        {"name": "a", "component": job("false")},
        {"name": "b", "dependsOn": ["a"], "component": job()},
        {"name": "c", "dependsOn": ["a"], "trigger": "all_done", "component": job()},
        {"name": "d", "dependsOn": ["a"], "trigger": "all_failed", "component": job()},
        {"name": "e", "dependsOn": ["a"], "trigger": "one_succeeded", "component": job()},
        {"name": "f", "dependsOn": ["b"], "component": job()},
    ]),
    "fan-out": dag_op([
        {"name": "root", "component": job()},
        {"name": "left", "dependsOn": ["root"], "component": job()},
        {"name": "right", "dependsOn": ["root"], "component": job()},
        {"name": "join", "dependsOn": ["left", "right"], "component": job()},
    ], concurrency=2),
    "sweep-then-train-best": dag_op([
        {"name": "search", "component": MLP, "params": {"steps": 4},
         "matrix": {"kind": "grid", "params": {
             "lr": {"kind": "choice", "value": [1e-9, 0.05]}}}},
        {"name": "train-best", "dependsOn": ["search"], "component": MLP,
         "params": {"lr": "{{ ops.search.outputs.best.lr }}", "steps": 6}},
    ]),
    "missing-output": dag_op([
        {"name": "a", "component": job()},
        {"name": "b", "dependsOn": ["a"], "component": job(inputs=[("x", "float")]),
         "params": {"x": "{{ ops.a.outputs.loss }}"}},
    ]),
}


def _story(store, status):
    """(DAG status, its conditions, its dag-node log lines with uuids
    masked, {node run name: (status, params)})."""
    conds = [(c["type"], c.get("reason", "")) for c in store.get_status(DAG_UUID)["conditions"]]
    lines = [re.sub(r"\b[0-9a-f]{8}\b", "U", line.split("dag node ", 1)[1])
             for line in store.read_logs(DAG_UUID).splitlines() if "dag node " in line]
    nodes = {}
    for rec in store.list_runs():
        if rec["uuid"] == DAG_UUID:
            continue
        spec = store.read_spec(rec["uuid"])
        nodes.setdefault(rec["name"], []).append(
            (store.get_status(rec["uuid"])["status"], spec.get("params")))
    return str(status), conds, lines, nodes


@pytest.fixture(scope="module")
def dags(tmp_path_factory):
    out = {}
    for name, doc in DAGS.items():
        root = tmp_path_factory.mktemp(name)
        carry = InitCarry()
        with carry.recording():
            ref_store = JaxStore(root / "jax")
            ref = JaxExecutor(ref_store, devices=jax.devices()[:1]).execute(
                jax_compile(JaxOperation.model_validate(doc), run_uuid=DAG_UUID))
        with carry.loading():
            store = RunStore(root / "torch")
            ours = Executor(store, device="cpu").execute(
                compile_operation(V1Operation.from_dict(doc), run_uuid=DAG_UUID))
        assert carry.loaded == len(carry.params)
        out[name] = (_story(store, ours), _story(ref_store, ref), store)
    return out


def _split_floats(nodes):
    """Node params with floats taken out (compared within a tolerance)."""
    exact, floats = {}, []
    for name, runs in sorted(nodes.items()):
        for status, params in runs:
            kept = {}
            for k, v in sorted((params or {}).items()):
                if isinstance(v, float):
                    floats.append(v)
                else:
                    kept[k] = v
            exact.setdefault(name, []).append((status, kept))
    return exact, floats


@pytest.mark.parametrize("name", list(DAGS))
def test_dag_matches_the_reference(dags, name):
    (status, conds, lines, nodes), (rstatus, rconds, rlines, rnodes), _ = dags[name]
    assert status == rstatus and conds == rconds
    assert sorted(lines) == sorted(rlines)  # siblings log in either order
    exact, floats = _split_floats(nodes)
    rexact, rfloats = _split_floats(rnodes)
    assert exact == rexact
    np.testing.assert_allclose(floats, rfloats, rtol=1e-4)


def test_chain_hands_the_upstream_loss_downstream(dags):
    (status, _, _, nodes), _, store = dags["chain"]
    assert status == "V1Statuses.SUCCEEDED"
    (train,) = [r for r in store.list_runs() if r["name"] == "train"]
    losses = [m["loss"] for m in store.read_metrics(train["uuid"]) if "loss" in m]
    assert nodes["report"] == [("succeeded", {"loss": losses[-1]})]


def test_upstream_failure_fails_the_dag_and_honours_triggers(dags):
    (status, conds, lines, nodes), *_ = dags["upstream-failure"]
    assert status == "V1Statuses.FAILED" and conds[-1][0] == "failed"
    assert {n: [s for s, _ in runs] for n, runs in nodes.items()} == {
        "a": ["failed"], "c": ["succeeded"], "d": ["succeeded"]}
    assert any(line.startswith("b: trigger all_succeeded unmet") for line in lines)
    assert any(line.startswith("e: trigger one_succeeded unmet") and "skipping" in line
               for line in lines)
    assert any(line.startswith("f: trigger all_succeeded unmet") for line in lines)


def test_sweep_node_feeds_the_winner_downstream(dags):
    (status, _, lines, nodes), _, store = dags["sweep-then-train-best"]
    assert status == "V1Statuses.SUCCEEDED"
    assert nodes["train-best"] == [("succeeded", {"lr": 0.05, "steps": 6})]
    trials = [r for r in store.list_runs() if "trial" in (r.get("tags") or [])]
    assert sorted(store.read_spec(t["uuid"])["params"]["lr"] for t in trials) == [1e-9, 0.05]
    sweep = next(r for r in store.list_runs() if r["name"] == "search-sweep")
    assert store.get_status(sweep["uuid"])["status"] == "succeeded"
    assert any(line.startswith("search: sweep U done, best {'lr': 0.05") for line in lines)


def test_missing_output_fails_the_node(dags):
    (status, _, lines, nodes), *_ = dags["missing-output"]
    assert status == "V1Statuses.FAILED" and "b" not in nodes
    assert any("upstream 'a' has no output 'loss'" in line for line in lines)


def test_topo_order_matches_the_reference():
    class Node:
        def __init__(self, deps):
            self.depends_on = deps

    graphs = [
        {"a": [], "b": ["a"], "c": ["a"], "d": ["b", "c"], "e": []},
        {"x": ["y"], "y": []},
    ]
    for g in graphs:
        nodes = {k: Node(v) for k, v in g.items()}
        assert dag.topo_order(nodes) == jax_dag.topo_order(nodes)
    for bad, what in (({"a": ["b"], "b": ["a"]}, "cycle"), ({"a": ["zz"]}, "unknown")):
        nodes = {k: Node(v) for k, v in bad.items()}
        with pytest.raises(dag.DagError, match=what):
            dag.topo_order(nodes)
        with pytest.raises(jax_dag.DagError, match=what):
            jax_dag.topo_order(nodes)


@pytest.mark.parametrize("trigger", ["all_succeeded", "all_done", "one_succeeded", "one_done",
                                     "all_failed", "one_failed", None])
def test_triggers_match_the_reference(trigger):
    from polyaxon_tpu.schemas.lifecycle import V1Statuses as J
    from polyaxon_tpu_torch.schemas.lifecycle import V1Statuses as T

    for deps in ([], ["succeeded"], ["failed"], ["succeeded", "failed"], ["stopped"],
                 ["skipped", "upstream_failed"], ["running"]):
        assert dag._trigger_met(trigger, [T(s) for s in deps]) == jax_dag._trigger_met(
            trigger, [J(s) for s in deps])


# ------------------------------------------------------------------ joins
RUNS = [  # uuid, name, project, tags, status, metrics
    ("1" * 32, "alpha", "default", ["trial"], "succeeded", {"loss": 0.5, "acc": 0.8}),
    ("2" * 32, "beta", "default", ["trial", "best"], "succeeded", {"loss": 0.2}),
    ("3" * 32, "gamma", "other", ["trial"], "succeeded", {"loss": 0.1}),
    ("4" * 32, "delta", "default", ["trial"], "failed", {"loss": 9.0}),
    ("5" * 32, "alpha-2", "default", [], "succeeded", {"loss": 0.3}),
]


@pytest.fixture(scope="module")
def join_stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("joins")
    stores = (RunStore(root / "torch"), JaxStore(root / "jax"))
    for store in stores:
        for uuid, name, project, tags, status, metrics in RUNS:
            store.create_run(uuid, name, project, {}, tags=tags)
            path = ["compiled", "queued", "scheduled", "starting", "running", status]
            for s in path:
                store.set_status(uuid, s)
            store.log_metrics(uuid, 1, {k: v * 2 for k, v in metrics.items()})
            store.log_metrics(uuid, 2, metrics)
    return stores


JOINS = [
    {"query": "project:default status:succeeded tag:trial", "sort": "metrics.loss",
     "params": {"uuids": {"ref": "runs.uuid"}, "losses": {"ref": "runs.outputs.loss"},
                "names": {"ref": "runs.name"}}},
    {"query": "metrics.loss:<0.4", "sort": "-metrics.loss", "limit": 2,
     "params": {"best": {"ref": "runs"}, "acc": {"ref": "runs.outputs.acc"}}},
    {"query": "name:alpha, metrics.acc:>0.5",
     "params": {"paths": {"ref": "runs.artifacts_path"}}},
    {"query": "metrics.loss:0.2 tag:best", "sort": "name",
     "params": {"names": {"ref": "runs.name"}}},
]


@pytest.mark.parametrize("i", range(len(JOINS)))
def test_resolve_joins_matches_the_reference(join_stores, i):
    store, ref_store = join_stores
    doc = {"kind": "operation", "name": "consumer", "joins": [JOINS[i]],
           "params": {"keep": 1}, "component": job()}
    ours = joins.resolve_joins(V1Operation.from_dict(doc), store)
    ref = jax_joins.resolve_joins(JaxOperation.model_validate(doc), ref_store)
    assert ours.joins is None and ref.joins is None
    got = {k: v.value for k, v in ours.params.items()}
    want = {k: v.value for k, v in ref.params.items()}
    if "paths" in got:  # each store's own outputs dir
        got["paths"] = [p.replace(str(store.home), "H") for p in got["paths"]]
        want["paths"] = [p.replace(str(ref_store.home), "H") for p in want["paths"]]
    assert got == want and got["keep"] == 1
    assert any(v for k, v in got.items() if k != "keep")


def test_query_runs_and_join_errors_match_the_reference(join_stores):
    store, ref_store = join_stores
    for q, sort, limit in (("tag:trial", "-metrics.loss", None), ("project:default", "name", 3),
                           ("status:failed", None, None)):
        ours = joins.query_runs(store, q, sort, limit)
        ref = jax_joins.query_runs(ref_store, q, sort, limit)
        keys = ("uuid", "name", "status", "metrics")
        assert [{k: r[k] for k in keys} for r in ours] == [{k: r[k] for k in keys} for r in ref]
    for q, what in (("nocolon", "bad query term"), ("colour:red", "unknown query field")):
        with pytest.raises(joins.JoinError, match=what):
            joins.query_runs(store, q)
        with pytest.raises(jax_joins.JoinError, match=what):
            jax_joins.query_runs(ref_store, q)
    doc = {"kind": "operation", "joins": [{"query": "tag:trial", "params": {
        "x": {"ref": "runs.weights"}}}], "component": job()}
    with pytest.raises(joins.JoinError, match="unknown join ref"):
        joins.resolve_joins(V1Operation.from_dict(doc), store)
    with pytest.raises(jax_joins.JoinError, match="unknown join ref"):
        jax_joins.resolve_joins(JaxOperation.model_validate(doc), ref_store)
