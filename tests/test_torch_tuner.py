"""The port's Polytune (`polyaxon_tpu_torch/tuner/`) against the JAX
package's, on the CPU.

- Every manager kind, and the matrices of the three shipped sweep examples
  read from `examples/`, gives the same suggestions (params, bracket, rung,
  resource) for the same fed scores: exactly, float for float. The scores
  are one function of the suggestion on both sides, with every seventh
  trial failed (None).
- The space encodings and the early-stopping policies are exact.
- `sub_slices` and `choose_block_shape` give the same groups by index over
  8 devices (the JAX package's 8 CPU devices by id, the port's by index).
- A grid and an ASHA sweep of a tiny MLP through both drivers give the same
  trial params in order and the same best, the objectives within 1e-4
  relative: the port's trainers start from the JAX trainers' initial
  params (`params_from_jax`), the JAX trials run on one device, and the
  learning rates are far apart, so float noise cannot reorder a rung.
- A sweep whose trials log no objective settles failed, and a stop
  settles stopped, with the same conditions on both sides.
- A concurrency-2 sweep over an explicit 4-device pool hands each running
  trial a group of its own; a trial's Executor runs under its group's
  first device (`torch.cuda.device`), and a gang sees only its group.
"""

import contextlib
import math
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from polyaxon_tpu.polyaxonfile import read_polyaxonfile as jax_read
from polyaxon_tpu.schemas.matrix import parse_matrix as jax_parse
from polyaxon_tpu.schemas.matrix import (
    V1MedianStoppingPolicy as JaxMedian,
    V1MetricEarlyStopping as JaxMetricStop,
    V1TruncationStoppingPolicy as JaxTruncation,
)
from polyaxon_tpu.schemas.operation import V1Operation as JaxOperation
from polyaxon_tpu.scheduler import topology as jax_topology
from polyaxon_tpu.store.local import RunStore as JaxStore
from polyaxon_tpu.tuner import driver as jax_driver
from polyaxon_tpu.tuner import early_stopping as jax_es
from polyaxon_tpu.tuner import managers as jax_managers
from polyaxon_tpu.tuner import placement as jax_placement
from polyaxon_tpu.tuner import space as jax_space
from polyaxon_tpu_torch.compiler import compile_operation
from polyaxon_tpu_torch.polyaxonfile.reader import read_polyaxonfile
from polyaxon_tpu_torch.runtime.executor import (
    Executor,
    device_scope,
    gang_device_error,
    visible_group,
)
from polyaxon_tpu_torch.scheduler import topology
from polyaxon_tpu_torch.schemas.matrix import (
    V1MedianStoppingPolicy,
    V1MetricEarlyStopping,
    V1TruncationStoppingPolicy,
    parse_matrix,
)
from polyaxon_tpu_torch.schemas.operation import V1Operation
from polyaxon_tpu_torch.store import RunStore
from polyaxon_tpu_torch.tuner import driver, early_stopping, managers, placement, space
from torch_init_carry import InitCarry

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# ------------------------------------------------------------------ managers
ALL_KINDS = {
    "lr": {"kind": "loguniform", "value": {"low": math.log(1e-4), "high": math.log(1e-1)}},
    "width": {"kind": "choice", "value": [64, 128, 256]},
    "act": {"kind": "pchoice", "value": [["relu", 0.2], ["gelu", 0.5], ["silu", 0.3]]},
    "layers": {"kind": "range", "value": {"start": 1, "stop": 7, "step": 2}},
    "mom": {"kind": "linspace", "value": {"start": 0.8, "stop": 0.99, "num": 4}},
    "wd": {"kind": "logspace", "value": {"start": -5, "stop": -2, "num": 4}},
    "drop": {"kind": "uniform", "value": {"low": 0, "high": 0.5}},
    "batch": {"kind": "quniform", "value": {"low": 8, "high": 64, "q": 8}},
    "noise": {"kind": "normal", "value": {"loc": 0.0, "scale": 1.0}},
    "scale": {"kind": "lognormal", "value": {"loc": 0.0, "scale": 0.5}},
}
DISCRETE = {k: ALL_KINDS[k] for k in ("width", "act", "layers", "mom", "wd")}
CONTINUOUS = {k: ALL_KINDS[k] for k in ("lr", "drop", "noise", "width")}
METRIC = {"name": "loss", "optimization": "minimize"}
STEPS = {"name": "steps", "type": "int"}

MATRICES = {
    "grid": {"kind": "grid", "params": DISCRETE},
    "grid-num-runs": {"kind": "grid", "params": DISCRETE, "numRuns": 7},
    "random": {"kind": "random", "params": ALL_KINDS, "numRuns": 9, "seed": 5},
    "mapping": {"kind": "mapping", "values": [{"lr": 0.1, "w": 1}, {"lr": 0.01, "w": 2}]},
    "iterative": {"kind": "iterative", "params": ALL_KINDS, "maxIterations": 5, "seed": 2},
    "hyperband": {"kind": "hyperband", "params": ALL_KINDS, "maxIterations": 9, "eta": 3,
                  "resource": STEPS, "metric": METRIC, "seed": 1},
    "hyperband-float": {"kind": "hyperband", "params": CONTINUOUS, "maxIterations": 16,
                        "eta": 2, "resource": {"name": "epochs", "type": "float"},
                        "metric": METRIC, "seed": 3},
    "asha": {"kind": "asha", "params": ALL_KINDS, "maxIterations": 14, "eta": 2,
             "minResource": 1, "maxResource": 8, "concurrency": 3, "resource": STEPS,
             "metric": METRIC, "seed": 4},
    "bayes-ucb": {"kind": "bayes", "params": CONTINUOUS, "numInitialRuns": 4,
                  "maxIterations": 6, "metric": METRIC, "seed": 6},
    "bayes-ei": {"kind": "bayes", "params": CONTINUOUS, "numInitialRuns": 3,
                 "maxIterations": 5, "metric": METRIC, "seed": 7,
                 "utilityFunction": {"acquisitionFunction": "ei", "eps": 0.01}},
    "bayes-pi": {"kind": "bayes", "params": CONTINUOUS, "numInitialRuns": 3,
                 "maxIterations": 5, "metric": METRIC, "seed": 8,
                 "utilityFunction": {"acquisitionFunction": "pi"}},
    "turbo": {"kind": "bayes", "algorithm": "turbo", "params": CONTINUOUS,
              "numInitialRuns": 4, "maxIterations": 10, "metric": METRIC, "seed": 9,
              "trustRegion": {"lengthInit": 0.4, "failTol": 2, "succTol": 2}},
    "baxus": {"kind": "bayes", "algorithm": "baxus", "params": ALL_KINDS,
              "numInitialRuns": 4, "maxIterations": 12, "metric": METRIC, "seed": 10,
              "trustRegion": {"lengthInit": 0.2, "failTol": 1, "lengthMin": 0.1}},
    "hyperopt-tpe": {"kind": "hyperopt", "params": ALL_KINDS, "numRuns": 12, "seed": 11},
    "hyperopt-rand": {"kind": "hyperopt", "algorithm": "rand", "params": ALL_KINDS,
                      "numRuns": 6, "seed": 12},
    "hyperopt-anneal": {"kind": "hyperopt", "algorithm": "anneal", "params": CONTINUOUS,
                        "numRuns": 10, "seed": 13},
}
EXAMPLES = ("lm_asha.yaml", "mlp_turbo_bo.yaml", "vit_hyperband.yaml")


def score(sug, k: int):
    """One deterministic score a suggestion, higher better; every seventh
    trial fails (None)."""
    if k % 7 == 6:
        return None
    total = 0.0
    for name, v in sorted(sug.params.items()):
        if isinstance(v, str):
            total += len(v) * 0.1
        else:
            total -= (math.log(abs(float(v)) + 1e-3) + 2.0) ** 2 / (1 + len(name))
    if sug.resource is not None:
        total += math.log1p(float(sug.resource))
    return total


def drive(build, matrix, rounds: int = 60) -> list:
    mgr, trace, k = build(matrix), [], 0
    for _ in range(rounds):
        if mgr.done:
            break
        batch = mgr.suggest()
        if not batch:
            break
        trace.append([(s.params, s.bracket, s.rung, s.resource) for s in batch])
        results = []
        for s in batch:
            results.append((s, score(s, k)))
            k += 1
        mgr.observe(results)
    assert mgr.done, "the manager never finished"
    return trace


def assert_same_trace(ours: list, ref: list):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert len(a) == len(b)
        for (pa, *ra), (pb, *rb) in zip(a, b):
            assert pa == pb and ra == rb
            assert [type(v) for v in pa.values()] == [type(v) for v in pb.values()]


@pytest.mark.parametrize("name", list(MATRICES))
def test_manager_suggestions_match_the_reference(name):
    ours = drive(managers.build_manager, parse_matrix(MATRICES[name]))
    ref = drive(jax_managers.build_manager, jax_parse(MATRICES[name]))
    assert_same_trace(ours, ref)
    assert sum(len(b) for b in ours) > 1


@pytest.mark.parametrize("example", EXAMPLES)
def test_shipped_sweep_matrices_give_the_reference_suggestions(example):
    path = REPO / "examples" / example
    ours = drive(managers.build_manager, read_polyaxonfile(path).matrix)
    ref = drive(jax_managers.build_manager, jax_read(path).matrix)
    assert_same_trace(ours, ref)


def test_lm_asha_runs_sixteen_trials():
    """`examples/lm_asha.yaml`: 16 trial executions over rungs of 50..400
    steps (chip_smoke's sweep phase counts them)."""
    trace = drive(managers.build_manager, read_polyaxonfile(REPO / "examples" / "lm_asha.yaml").matrix)
    flat = [s for b in trace for s in b]
    assert len(flat) == 16 and {r for *_, r in flat} <= {50.0, 100.0, 200.0, 400.0}
    assert max(r for *_, r in flat) > 50.0  # something was promoted


def test_gp_posterior_matches_the_reference():
    rng = np.random.default_rng(0)
    X, y, Xs = rng.random((7, 3)), rng.normal(size=7), rng.random((11, 3))
    for a, b in zip(managers.gp_posterior(X, y, Xs, 0.3), jax_managers.gp_posterior(X, y, Xs, 0.3)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ space
@pytest.mark.parametrize("name", list(ALL_KINDS))
def test_space_encodings_are_exact(name):
    ours = parse_matrix({"kind": "random", "numRuns": 1, "params": {name: ALL_KINDS[name]}}).params[name]
    ref = jax_parse({"kind": "random", "numRuns": 1, "params": {name: ALL_KINDS[name]}}).params[name]
    assert space.param_bounds(ours) == jax_space.param_bounds(ref)
    if ours.kind in space.DISCRETE_KINDS:
        assert space.grid_values(ours) == jax_space.grid_values(ref)
    else:
        with pytest.raises(ValueError):
            space.grid_values(ours)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    draws = [space.sample(ours, r1) for _ in range(20)]
    assert draws == [jax_space.sample(ref, r2) for _ in range(20)]
    for v in draws:
        assert space.to_unit(ours, v) == jax_space.to_unit(ref, v)
    for u in np.linspace(0.0, 1.0, 13):
        assert space.from_unit(ours, float(u)) == jax_space.from_unit(ref, float(u))


def test_grid_and_sampled_configs_are_exact():
    ours = parse_matrix(MATRICES["random"]).params
    ref = jax_parse(MATRICES["random"]).params
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    assert [space.sample_config(ours, r1) for _ in range(5)] == [
        jax_space.sample_config(ref, r2) for _ in range(5)]
    grid = parse_matrix(MATRICES["grid"]).params
    assert space.grid_configs(grid) == jax_space.grid_configs(jax_parse(MATRICES["grid"]).params)


# ------------------------------------------------------------ early stopping
def test_early_stopping_policies_are_exact():
    rng = np.random.default_rng(4)
    gates = [{"metric": "loss", "value": 0.5, "optimization": "minimize"},
             {"metric": "acc", "value": 0.9, "optimization": "maximize"}]
    ours_gate = [V1MetricEarlyStopping.from_dict(g) for g in gates]
    ref_gate = [JaxMetricStop.model_validate(g) for g in gates]
    for loss, acc in rng.random((40, 2)):
        for m in ({"loss": loss}, {"acc": acc}, {"loss": loss, "acc": acc}, {"other": 1.0}):
            assert early_stopping.metric_triggered(ours_gate, m) == jax_es.metric_triggered(
                ref_gate, m)
    assert early_stopping.metric_triggered(None, {"loss": 0.0}) is False
    for cfg in ({}, {"evaluationInterval": 2}, {"minInterval": 3, "minSamples": 2}):
        ours_m, ref_m = V1MedianStoppingPolicy.from_dict(cfg), JaxMedian.model_validate(cfg)
        for n in range(7):
            hist, others = list(rng.random(n)), list(rng.random(n % 4))
            for maximize in (True, False):
                assert early_stopping.median_should_stop(
                    ours_m, hist, others, maximize=maximize) == jax_es.median_should_stop(
                    ref_m, hist, others, maximize=maximize)
    for cfg in ({}, {"percent": 25}, {"percent": 80, "minSamples": 4}):
        ours_t, ref_t = V1TruncationStoppingPolicy.from_dict(cfg), JaxTruncation.model_validate(cfg)
        for n in range(8):
            values = list(rng.random(n))
            for v in rng.random(5):
                for maximize in (True, False):
                    assert early_stopping.truncation_should_stop(
                        ours_t, v, values, maximize=maximize) == jax_es.truncation_should_stop(
                        ref_t, v, values, maximize=maximize)


# ------------------------------------------------------------------ placement
POOL = [torch.device("cuda", i) for i in range(8)]  # named, never touched


def _ids(groups, attr):
    return [[getattr(d, attr) for d in g] for g in groups]


@pytest.mark.parametrize("topology", [None, (2, 4), (4, 2), (8,), (2, 2, 2)])
def test_sub_slices_give_the_reference_groups_by_index(topology):
    devices = jax.devices()
    assert len(devices) == 8
    for n in (1, 2, 3, 4, 5, 8, 9):
        ours = placement.sub_slices(n, POOL, topology=topology)
        ref = jax_placement.sub_slices(n, devices, topology=topology)
        assert _ids(ours, "index") == _ids(ref, "id"), (n, topology)
        flat = [d for g in ours for d in g]
        assert len(flat) == len(set(flat))  # disjoint
    # a pool in another order keeps its order, as the reference's fallback does
    assert _ids(placement.sub_slices(3, POOL[::-1]), "index") == _ids(
        jax_placement.sub_slices(3, devices[::-1]), "id")


def test_a_topology_that_is_not_the_pool_is_refused():
    with pytest.raises(ValueError, match="topology"):
        placement.sub_slices(2, POOL, topology=(4, 4))
    with pytest.raises(ValueError, match="topology"):
        jax_placement.sub_slices(2, jax.devices(), topology=(4, 4))
    with pytest.raises(ValueError):
        placement.sub_slices(0, POOL)


def test_choose_block_shape_matches_the_reference():
    for topo in ((2, 4), (4, 4), (4, 8), (8,), (2, 2, 2), (3, 6)):
        for n in (1, 2, 3, 4, 5, 7, 8, 16, 100):
            assert placement.choose_block_shape(topo, n) == jax_placement.choose_block_shape(
                topo, n)
        for block in ((1,), (2, 2), (3, 3), (1, 1, 1, 1)):
            assert topology.fits_torus(topo, block) == jax_topology.fits_torus(topo, block)
        assert topology.grid_blocks(topo, topology.choose_block_shape(topo, 2)) == \
            jax_topology.grid_blocks(topo, jax_topology.choose_block_shape(topo, 2))
    for spec in ("2x4", "2xfour", "", None, (2, 4), [0, 2], "4X8"):
        assert topology.parse_topology(spec) == jax_topology.parse_topology(spec)


def test_one_card_is_one_group():
    """`sub_slices` never splits a device: concurrency 4 on one GPU is one
    group, and `SweepDriver` runs the batch one trial at a time."""
    assert _ids(placement.sub_slices(4, POOL[:1]), "index") == [[0]]
    assert placement.device_pool("cpu") == [CPU]


# ------------------------------------------------------------------ sweeps
def mlp_component(steps_default: int = 2, **train) -> dict:
    return {
        "kind": "component", "name": "mlp-train",
        "inputs": [{"name": "lr", "type": "float", "value": 0.001},
                   {"name": "steps", "type": "int", "value": steps_default}],
        "run": {"kind": "jaxjob", "program": {
            "model": {"name": "mlp", "config": {"input_dim": 16, "num_classes": 4,
                                                "hidden": [32]}},
            "data": {"name": "synthetic", "batchSize": 16,
                     "config": {"shape": [16], "num_classes": 4}},
            "optimizer": {"name": "adamw", "learningRate": "{{ params.lr }}"},
            "train": {"steps": "{{ params.steps }}", "logEvery": 2, "precision": "float32",
                      **train},
        }},
    }


SWEEPS = {
    "grid": {"kind": "operation", "name": "grid-mlp",
             "params": {"steps": 4},
             "matrix": {"kind": "grid", "params": {
                 "lr": {"kind": "choice", "value": [1e-9, 0.05]}}},
             "component": mlp_component()},
    "asha": {"kind": "operation", "name": "asha-mlp",
             "matrix": {"kind": "asha", "concurrency": 2, "maxIterations": 4, "eta": 2,
                        "minResource": 2, "maxResource": 8, "resource": STEPS,
                        "metric": METRIC, "seed": 3,
                        "params": {"lr": {"kind": "choice", "value": [0.05, 0.005, 1e-6]}}},
             "component": mlp_component()},
}


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Each SWEEPS entry through the JAX driver (trials on one device), then
    the port's (trials on the CPU, from the JAX trials' initial params)."""
    out = {}
    for name, doc in SWEEPS.items():
        root = tmp_path_factory.mktemp(name)
        carry = InitCarry()
        with carry.recording():
            ref_store = JaxStore(root / "jax")
            ref = jax_driver.run_sweep(JaxOperation.model_validate(doc), store=ref_store,
                                       devices=jax.devices()[:1], log_fn=lambda *a: None)
        with carry.loading():
            store = RunStore(root / "torch")
            ours = driver.run_sweep(V1Operation.from_dict(doc), store=store, devices=[CPU],
                                    log_fn=lambda *a: None)
        assert carry.loaded == len(carry.params) == len(ref["trials"])
        out[name] = (ours, ref, store, ref_store)
    return out


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sweep_matches_the_reference_trial_for_trial(sweeps, name):
    ours, ref, store, ref_store = sweeps[name]
    assert ours["status"] == ref["status"] == "succeeded"
    assert [t["params"] for t in ours["trials"]] == [t["params"] for t in ref["trials"]]
    assert [t["status"] for t in ours["trials"]] == [t["status"] for t in ref["trials"]]
    np.testing.assert_allclose([t["objective"] for t in ours["trials"]],
                               [t["objective"] for t in ref["trials"]], rtol=1e-4)
    assert ours["best"]["params"] == ref["best"]["params"]
    assert ours["best"]["params"]["lr"] == 0.05
    np.testing.assert_allclose(ours["best"]["objective"], ref["best"]["objective"], rtol=1e-4)
    best = min(ours["trials"], key=lambda t: t["objective"])
    assert ours["best"]["uuid"] == best["uuid"]
    if name == "asha":
        assert len(ours["trials"]) == 4
        assert any(t["params"]["steps"] > 2 for t in ours["trials"])  # promoted


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sweep_record_and_lineage_match_the_reference(sweeps, name):
    ours, ref, store, ref_store = sweeps[name]

    def story(st, summary):
        sweep = summary["sweep"]
        conds = [(c["type"], c.get("reason", "")) for c in st.get_status(sweep)["conditions"]]
        events = [(e["kind"], e.get("iteration"), e.get("trials"))
                  for e in st.read_events(sweep)]
        rows = {r["uuid"]: r for r in st.list_runs()}
        trials = []
        for t in summary["trials"]:
            meta = st.get_status(t["uuid"])["meta"]
            trials.append((meta["sweep"] == sweep, meta["iteration"], len(meta["fingerprint"]),
                           rows[t["uuid"]]["tags"]))
        return conds, events, trials, rows[sweep]["tags"], rows[sweep]["name"]

    assert story(store, ours) == story(ref_store, ref)
    spec = store.read_spec(ours["sweep"])
    assert spec["matrix"] == ref_store.read_spec(ref["sweep"])["matrix"]


def _job_sweep(matrix=None, command=("true",)) -> dict:
    return {"kind": "operation", "name": "job-sweep",
            "matrix": matrix or {"kind": "grid", "params": {
                "lr": {"kind": "choice", "value": [0.01, 0.02]}}},
            "component": {"kind": "component", "name": "job",
                          "inputs": [{"name": "lr", "type": "float", "value": 0.001}],
                          "run": {"kind": "job", "container": {"command": list(command)}}}}


def _both(tmp_path, doc, *, prepare=None, **kw):
    """Run `doc` through both drivers: [(summary, store), (ref summary, ref store)]."""
    out = []
    for store, drv, op in ((RunStore(tmp_path / "torch"), driver,
                            V1Operation.from_dict(doc)),
                           (JaxStore(tmp_path / "jax"), jax_driver,
                            JaxOperation.model_validate(doc))):
        d = drv.SweepDriver(op, store=store, log_fn=lambda *a: None,
                            devices=[CPU] if drv is driver else jax.devices()[:1], **kw)
        if prepare is not None:
            prepare(d, store)
        try:
            result = d.run()
            out.append((result, store))
        except Exception as e:  # noqa: BLE001 — held equal below
            out.append((e, store))
    return out


def _conds(store, uuid):
    return [(c["type"], c.get("reason", "")) for c in store.get_status(uuid)["conditions"]]


def test_no_objective_settles_failed_like_the_reference(tmp_path):
    (ours, store), (ref, ref_store) = _both(tmp_path, _job_sweep())
    assert ours.best is None and ref.best is None
    assert [t.status for t in ours.trials] == [t.status for t in ref.trials] == [
        "succeeded"] * 2
    assert _conds(store, ours.sweep_uuid) == _conds(ref_store, ref.sweep_uuid)
    assert store.get_status(ours.sweep_uuid)["status"] == "failed"
    msg = store.get_status(ours.sweep_uuid)["conditions"][-1]["message"]
    assert msg == ref_store.get_status(ref.sweep_uuid)["conditions"][-1]["message"]
    assert "'loss'" in msg and "2 trials" in msg


def test_a_stop_settles_stopped_like_the_reference(tmp_path):
    """Before the first iteration (the stop lands as the sweep starts
    running) and during the final batch (as the first trial starts)."""

    def stop_as_it_starts(d, store):
        set_status = store.set_status

        def hook(uuid, status, **kw):
            set_status(uuid, status, **kw)
            if uuid == d.sweep_uuid and status == "running":
                store.request_stop(uuid)

        store.set_status = hook

    (ours, store), (ref, ref_store) = _both(tmp_path / "a", _job_sweep(),
                                           prepare=stop_as_it_starts)
    assert ours.trials == [] and ref.trials == []
    assert _conds(store, ours.sweep_uuid) == _conds(ref_store, ref.sweep_uuid)
    assert store.get_status(ours.sweep_uuid)["status"] == "stopped"

    def stop_at_first_trial(d, store):
        fired = []

        def log(*a):
            if not fired:
                fired.append(True)
                store.request_stop(d.sweep_uuid)

        d.log = log

    (ours, store), (ref, ref_store) = _both(tmp_path / "b", _job_sweep(),
                                           prepare=stop_at_first_trial)
    assert len(ours.trials) == len(ref.trials) == 2
    assert _conds(store, ours.sweep_uuid) == _conds(ref_store, ref.sweep_uuid)
    assert store.get_status(ours.sweep_uuid)["status"] == "stopped"


def test_a_failing_trial_and_the_metric_gate_match_the_reference(tmp_path, monkeypatch):
    """Trials that fail are observed as None; a metric gate stops the
    sweep after the iteration that crosses it."""
    (ours, store), (ref, ref_store) = _both(tmp_path / "f", _job_sweep(command=("false",)))
    assert [t.status for t in ours.trials] == [t.status for t in ref.trials] == ["failed"] * 2
    assert _conds(store, ours.sweep_uuid) == _conds(ref_store, ref.sweep_uuid)

    # the gate (loss <= 0.03) stops the sweep after the iteration whose
    # trial crosses it; the trials log their lr as the loss
    monkeypatch.setattr(driver, "Executor", LossExecutor)
    monkeypatch.setattr(jax_driver, "Executor", LossExecutor)
    matrix = {"kind": "hyperopt", "algorithm": "rand", "numRuns": 8, "seed": 2,
              "earlyStopping": [{"kind": "metric_early_stopping", "metric": "loss",
                                 "value": 0.03, "optimization": "minimize"}],
              "params": {"lr": {"kind": "uniform", "value": {"low": 0.01, "high": 0.1}}}}
    (ours, store), (ref, ref_store) = _both(tmp_path / "g", _job_sweep(matrix))
    assert [t.params for t in ours.trials] == [t.params for t in ref.trials]
    assert 1 <= len(ours.trials) < 8 and ours.trials[-1].objective <= 0.03
    assert ours.best.objective == ref.best.objective
    assert [e.get("iteration") for e in store.read_events(ours.sweep_uuid)] == [
        e.get("iteration") for e in ref_store.read_events(ref.sweep_uuid)]
    assert _conds(store, ours.sweep_uuid) == _conds(ref_store, ref.sweep_uuid)


class LossExecutor:
    """Stands in for a trial's Executor: logs the trial's lr as its loss."""

    def __init__(self, store=None, devices=None, **kw):
        self.store = store

    def execute(self, compiled):
        self.store.log_metrics(compiled.run_uuid, 1, {"loss": compiled.params["lr"]})
        return "succeeded"


def test_a_declared_topology_applies_only_to_a_pool_of_its_size(tmp_path):
    doc = _job_sweep({"kind": "grid", "concurrency": 4,
                      "params": {"lr": {"kind": "choice", "value": [1, 2, 3, 4]}}})
    doc["component"]["run"]["environment"] = {
        "resources": {"tpu": {"type": "v5e", "topology": "2x4"}}}
    for pool, ref_pool, want in ((POOL, jax.devices(), (2, 4)),
                                 (POOL[:1], jax.devices()[:1], None)):
        ours = driver.SweepDriver(V1Operation.from_dict(doc), devices=pool,
                                  store=RunStore(tmp_path / "torch"))
        ref = jax_driver.SweepDriver(JaxOperation.model_validate(doc), devices=ref_pool,
                                     store=JaxStore(tmp_path / "jax"))
        assert ours._topology() == ref._topology() == want


class GroupRecorder:
    """Stands in for a trial's Executor: records its device group, fails
    if another running trial holds one of its devices, and logs a loss."""

    def __init__(self, key):
        self.key = key
        self.lock = threading.Lock()
        self.busy: set = set()
        self.groups: list = []
        self.overlapped = 0

    def factory(self):
        rec = self

        class Recorder:
            def __init__(self, store=None, devices=None, **kw):
                self.store, self.devices = store, devices

            def execute(self, compiled):
                ids = [getattr(d, rec.key) for d in self.devices]
                with rec.lock:
                    assert not rec.busy & set(ids), (rec.busy, ids)
                    rec.overlapped += bool(rec.busy)
                    rec.busy |= set(ids)
                    rec.groups.append(ids)
                time.sleep(0.2)
                with rec.lock:
                    rec.busy -= set(ids)
                self.store.log_metrics(compiled.run_uuid, 1, {"loss": float(ids[0])})
                return "succeeded"

        return Recorder


def test_concurrent_trials_get_disjoint_groups_of_the_pool(tmp_path, monkeypatch):
    doc = _job_sweep({"kind": "grid", "concurrency": 2,
                      "params": {"lr": {"kind": "choice", "value": [1, 2, 3, 4, 5]}}})
    ours, ref = GroupRecorder("index"), GroupRecorder("id")
    monkeypatch.setattr(driver, "Executor", ours.factory())
    monkeypatch.setattr(jax_driver, "Executor", ref.factory())
    a = driver.run_sweep(V1Operation.from_dict(doc), store=RunStore(tmp_path / "torch"),
                         devices=POOL[:4], log_fn=lambda *x: None)
    b = jax_driver.run_sweep(JaxOperation.model_validate(doc), store=JaxStore(tmp_path / "jax"),
                             devices=jax.devices()[:4], log_fn=lambda *x: None)
    assert [t["params"] for t in a["trials"]] == [t["params"] for t in b["trials"]]
    assert len(ours.groups) == len(ref.groups) == 5
    assert {tuple(g) for g in ours.groups} == {tuple(g) for g in ref.groups} == {(0, 1), (2, 3)}
    assert ours.overlapped > 0  # two trials did run at once


def test_a_trial_executes_under_its_group_device(tmp_path, monkeypatch):
    """`torch.cuda.device(group[0])` around an in-process program's
    Trainer, built and run (faked here: the CPU has no card); a container
    job and a gang's supervisor never enter it, nor does a CPU run."""
    from types import SimpleNamespace

    from polyaxon_tpu_torch.runtime import trainer as trainer_mod

    entered, inside = [], []

    @contextlib.contextmanager
    def fake_device(dev):
        entered.append((dev, threading.get_ident()))
        inside.append(True)
        try:
            yield
        finally:
            inside.pop()

    class FakeTrainer:
        def __init__(self, program, device, **kw):
            seen.append(("init", device, bool(inside)))

        def run(self):
            seen.append(("run", bool(inside)))
            return SimpleNamespace(steps_per_sec=1.0, final_metrics={})

        def close(self):
            pass

    def fake_gang(self, compiled, world, program, ckpt_dir):
        seen.append(("gang", world, bool(inside)))
        self.store.set_status(compiled.run_uuid, "running")

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(trainer_mod, "Trainer", FakeTrainer)
    monkeypatch.setattr(Executor, "_run_distributed", fake_gang)
    store = RunStore(tmp_path)
    group = [torch.device("cuda", 2), torch.device("cuda", 3)]

    def op(component, **extra):
        return compile_operation(V1Operation.from_dict(
            {"kind": "operation", "params": {"lr": 0.1, "steps": 2},
             "component": component, **extra}))

    ex = Executor(store, devices=group)
    assert ex.device == "cuda:2"
    assert ex.execute(op(mlp_component())) == "succeeded"
    assert entered == [(torch.device("cuda", 2), threading.get_ident())]
    assert seen == [("init", "cuda:2", True), ("run", True)]

    entered.clear(), seen.clear()
    job = _job_sweep()["component"]
    assert Executor(store, devices=group).execute(op(job)) == "succeeded"
    gang = mlp_component()
    gang["run"]["replicas"] = 2
    assert Executor(store, devices=group).execute(op(gang)) == "succeeded"
    assert seen == [("gang", 2, False)] and entered == []

    assert isinstance(device_scope("cpu"), contextlib.nullcontext)
    with pytest.raises(ValueError, match="not both"):
        Executor(store, device="cpu", devices=POOL[:2])


def test_a_gang_sees_only_its_group(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert visible_group(POOL[2:4]) == "2,3"
    assert visible_group([CPU]) is None and visible_group(None) is None
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert visible_group(POOL[2:4]) == "6,7"
    doc = {"kind": "operation", "component": {"kind": "component", "run": {
        "kind": "jaxjob", "replicas": 2, "program": mlp_component()["run"]["program"]}},
        "params": {"lr": 0.1, "steps": 2}}
    doc["component"]["inputs"] = mlp_component()["inputs"]
    compiled = compile_operation(V1Operation.from_dict(doc))
    err = gang_device_error(compiled, "cuda:0", POOL[:1])
    assert "2 workers" in err and "1 GPU(s) are in the trial's device group" in err
    assert gang_device_error(compiled, "cuda:0", POOL[:2]) is None
    assert gang_device_error(compiled, "cpu", POOL[:1]) is None
