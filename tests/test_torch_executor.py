"""The port's local Executor against the JAX package's, side by side on the
CPU (the port with `device="cpu"`, as `POLYAXON_TORCH_DEVICE=cpu` gives
it; the JAX executor pinned to one device). Each case runs the same
compiled operation through both into two run stores and holds them to the
same status conditions (with the same reasons), the same event kinds and
the same metric keys per step:

- a 2-layer, narrow `transformer_lm` program whose port trainer starts from
  the JAX trainer's initial parameters (`params_from_jax`, patched into the
  port's `Trainer` by the test): per-step loss and grad_norm within
  `tests/test_torch_trainer.py`'s float32 tolerance, 5e-5 relative;
- `command: ["false"]` with `maxRetries: 2, backoff: 0.05`: the reasons
  `retry 1/2 after 0.05s` and `retry 2/2 after 0.1s`;
- a cache hit, a stop landing mid-run, a SIGTERM preemption that restarts
  from the checkpoint (budget-free), a `pathRef` hook, and a `job` and a
  `service` container;
- a two-node `dag` through `scheduler/dag.py::execute_dag`;
- the refusals of what is not ported, each naming ROADMAP.md.
"""

import json
import os
import signal
import sys
import threading
import time

import jax
import numpy as np
import pytest

from polyaxon_tpu.compiler import compile_operation as jax_compile
from polyaxon_tpu.runtime import preemption as jax_preemption
from polyaxon_tpu.runtime.executor import Executor as JaxExecutor
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas import V1Operation as JaxOperation
from polyaxon_tpu.store.local import RunStore as JaxStore
from polyaxon_tpu_torch.compiler import compile_operation
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.runtime import preemption
from polyaxon_tpu_torch.runtime.executor import Executor
from polyaxon_tpu_torch.runtime.trainer import Trainer
from polyaxon_tpu_torch.schemas import V1Operation
from polyaxon_tpu_torch.store import RunStore

UUID = "feedc0de" * 4

LM = {"name": "transformer_lm", "config": {
    "dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "vocab_size": 256,
    "seq_len": 32, "attention": "flash"}}
LM_DATA = {"name": "synthetic_text", "batchSize": 4, "config": {"seq_len": 32, "vocab_size": 256}}
MLP = {"name": "mlp", "config": {"hidden": [16], "num_classes": 10, "input_dim": 784}}
MNIST = {"name": "mnist", "batchSize": 8}


def op(run, **extra):
    return {"kind": "operation", "name": "t",
            "component": {"kind": "component", "name": "t", "run": run}, **extra}


def program(model, data, steps, **train):
    return {"kind": "jaxjob", "program": {
        "model": model, "data": data,
        "optimizer": {"name": "adamw", "learningRate": 3e-3},
        "train": {"steps": steps, "logEvery": 1, "precision": "float32", **train},
    }}


@pytest.fixture
def stores(tmp_path):
    return RunStore(tmp_path / "torch"), JaxStore(tmp_path / "jax")


@pytest.fixture
def jax_sigterm():
    """The JAX executor installs its SIGTERM handler for good: put back
    whatever handled SIGTERM before."""
    old, was = signal.getsignal(signal.SIGTERM), jax_preemption._installed
    yield
    jax_preemption.clear()
    signal.signal(signal.SIGTERM, old)
    jax_preemption._installed = was


def run_both(stores, doc, uuid=UUID, **kw):
    """Execute `doc` through both executors; returns
    (port status, JAX status, port store, JAX store, uuid)."""
    ours_store, jax_store = stores
    ours = Executor(ours_store, device="cpu").execute(
        compile_operation(V1Operation.from_dict(doc), run_uuid=uuid,
                          artifacts_root=str(ours_store.runs_dir), **kw))
    ref = JaxExecutor(jax_store, devices=jax.devices()[:1]).execute(
        jax_compile(JaxOperation.model_validate(doc), run_uuid=uuid,
                    artifacts_root=str(jax_store.runs_dir), **kw))
    return ours, ref


def conditions(store, uuid):
    return [(c["type"], c.get("reason", "")) for c in store.get_status(uuid)["conditions"]]


def event_kinds(store, uuid):
    return [e["kind"] for e in store.read_events(uuid)]


def metric_keys(store, uuid):
    return [sorted(k for k in m if k != "ts") for m in store.read_metrics(uuid)]


def assert_same_story(stores, uuid=UUID):
    ours_store, jax_store = stores
    assert conditions(ours_store, uuid) == conditions(jax_store, uuid)
    assert event_kinds(ours_store, uuid) == event_kinds(jax_store, uuid)
    assert metric_keys(ours_store, uuid) == metric_keys(jax_store, uuid)


# ------------------------------------------------------------------ cases
def test_lm_program_matches_the_reference_step_for_step(stores, monkeypatch):
    init = {}
    jax_init = JaxTrainer.__init__

    def record(self, *a, **kw):
        jax_init(self, *a, **kw)
        init["params"] = jax.tree.map(np.asarray, self.state.params)

    port_init = Trainer.__init__

    def load(self, *a, **kw):
        port_init(self, *a, **kw)
        self.load_state_dict(params_from_jax(init["params"], self.module.cfg))

    monkeypatch.setattr(JaxTrainer, "__init__", record)
    monkeypatch.setattr(Trainer, "__init__", load)
    ours_store, jax_store = stores
    doc = op(program(LM, LM_DATA, 4))
    # the JAX run first: its initial parameters seed the port's trainer
    ref = JaxExecutor(jax_store, devices=jax.devices()[:1]).execute(
        jax_compile(JaxOperation.model_validate(doc), run_uuid=UUID))
    ours = Executor(ours_store, device="cpu").execute(
        compile_operation(V1Operation.from_dict(doc), run_uuid=UUID))
    assert ours == ref == "succeeded"
    assert_same_story(stores)
    a, b = ours_store.read_metrics(UUID), jax_store.read_metrics(UUID)
    assert [m["step"] for m in a] == [m["step"] for m in b] == [1, 2, 3, 4]
    for x, y in zip(a, b):
        np.testing.assert_allclose(x["loss"], y["loss"], rtol=5e-5)
        np.testing.assert_allclose(x["grad_norm"], y["grad_norm"], rtol=5e-5)
    assert "done:" in ours_store.read_logs(UUID)


def test_retries_back_off_as_the_reference(stores):
    doc = op({"kind": "job", "container": {"command": ["false"]}},
             termination={"maxRetries": 2, "backoff": 0.05, "backoffFactor": 2,
                          "jitter": 0})
    assert run_both(stores, doc) == ("failed", "failed")
    assert_same_story(stores)
    reasons = [r for t, r in conditions(stores[0], UUID) if t == "retrying"]
    assert reasons == ["retry 1/2 after 0.05s", "retry 2/2 after 0.1s"]
    assert conditions(stores[0], UUID)[-1] == ("failed", "ExecutionError")


def test_cache_hit_reuses_the_first_runs_results(stores):
    doc = op(program(MLP, MNIST, 2), cache={"disable": False})
    assert run_both(stores, doc, uuid="a" * 32) == ("succeeded", "succeeded")
    assert run_both(stores, doc, uuid="b" * 32) == ("succeeded", "succeeded")
    assert_same_story(stores, "b" * 32)
    assert conditions(stores[0], "b" * 32)[-1] == ("succeeded", "cached")
    assert stores[0].read_metrics("b" * 32) == stores[0].read_metrics("a" * 32)


def _stop_at_step(store, step):
    """Request a stop once `step` is logged (a patch of log_metrics: the
    request lands between two log points, as `ops stop` from another
    process does)."""
    log_metrics = store.log_metrics

    def patched(run_uuid, s, metrics):
        log_metrics(run_uuid, s, metrics)
        if s == step:
            store.request_stop(run_uuid)

    store.log_metrics = patched


def test_stop_lands_at_the_next_log_point(stores):
    for store in stores:
        _stop_at_step(store, 2)
    assert run_both(stores, op(program(MLP, MNIST, 50))) == ("stopped", "stopped")
    assert_same_story(stores)
    assert [m["step"] for m in stores[0].read_metrics(UUID)] == [1, 2]


def _sigterm_at_step(store, step):
    log_metrics = store.log_metrics
    sent = []

    def patched(run_uuid, s, metrics):
        log_metrics(run_uuid, s, metrics)
        if s == step and not sent:
            sent.append(s)
            os.kill(os.getpid(), signal.SIGTERM)

    store.log_metrics = patched


def test_sigterm_preempts_and_restarts_from_the_checkpoint(stores, jax_sigterm):
    old = signal.getsignal(signal.SIGTERM)
    for store in stores:
        _sigterm_at_step(store, 3)
    doc = op(program(MLP, MNIST, 6, checkpointEvery=2))
    assert run_both(stores, doc) == ("succeeded", "succeeded")
    assert_same_story(stores)
    assert ("retrying", "preempted") in conditions(stores[0], UUID)
    steps = [m["step"] for m in stores[0].read_metrics(UUID)]
    # the flag raised at step 3's log point is read at the next step
    # boundary: step 4 is checkpointed (before its own log point) and the
    # restart resumes from it, in both packages
    assert steps == [m["step"] for m in stores[1].read_metrics(UUID)] == [1, 2, 3, 5, 6]
    # the executor's own event (the trainer logs one of its own, without `restart`)
    assert [e["restart"] for e in stores[0].read_events(UUID)
            if e["kind"] == "preempted" and "restart" in e] == [1]
    # the port's handler is put back after the run
    assert signal.getsignal(signal.SIGTERM) is old and not preemption.requested()


def test_path_ref_hook_runs_as_its_own_run(stores, tmp_path):
    hook = tmp_path / "hook.yaml"
    hook.write_text(
        "kind: component\nname: notify\n"
        "inputs: [{name: status, type: str}, {name: run_uuid, type: str}]\n"
        "run: {kind: job, container: {command: [echo, '{{ params.status }}']}}\n")
    doc = op({"kind": "job", "container": {"command": ["true"]}},
             hooks=[{"pathRef": str(hook), "trigger": "succeeded"}])
    assert run_both(stores, doc) == ("succeeded", "succeeded")
    assert_same_story(stores)
    for store in stores:
        child = [r for r in store.list_runs() if r["uuid"] != UUID]
        assert len(child) == 1 and child[0]["name"] == "t-hook"
        assert store.get_status(child[0]["uuid"])["status"] == "succeeded"
        assert store.read_logs(child[0]["uuid"]).strip() == "succeeded"
        assert f"hook {hook}: run" in store.read_logs(UUID)


def test_job_and_service_containers(stores):
    job = op({"kind": "job", "container": {
        "command": [sys.executable, "-c", "import os; print(os.environ['POLYAXON_RUN_UUID'])"]},
        "init": [{"file": {"name": "cfg.txt", "content": "x"}}]})
    assert run_both(stores, job) == ("succeeded", "succeeded")
    assert_same_story(stores)
    for store in stores:
        assert UUID in store.read_logs(UUID)
        assert (store.run_dir(UUID) / "context" / "cfg.txt").read_text() == "x"

    service = op({"kind": "service", "ports": [8123], "container": {
        "command": [sys.executable, "-c",
                    "import os, time; print(os.environ['POLYAXON_SERVICE_PORT'], flush=True);"
                    " time.sleep(60)"]}})
    uid = "c" * 32

    def stop_when_serving(store):
        """Stop once the service runs and has printed its port."""
        deadline = time.time() + 120
        while time.time() < deadline:
            if (store.get_status(uid).get("status") == "running"
                    and "8123" in store.read_logs(uid)):
                store.request_stop(uid)
                return
            time.sleep(0.05)

    outcomes = []
    for store, run in zip(stores, (
        lambda: Executor(stores[0], device="cpu").execute(
            compile_operation(V1Operation.from_dict(service), run_uuid=uid)),
        lambda: JaxExecutor(stores[1]).execute(
            jax_compile(JaxOperation.model_validate(service), run_uuid=uid)),
    )):
        t = threading.Thread(target=stop_when_serving, args=(store,))
        t.start()
        outcomes.append(run())
        t.join()
    assert outcomes == ["stopped", "stopped"]
    assert_same_story(stores, uid)
    assert "8123" in stores[0].read_logs(uid)


# a scanned gang (`scan_layers`) is no longer refused: its workers build
# the scanned stack (the CLI's tiny scanned gang runs, tests/test_torch_cli.py);
# the zoo's gangs and replicas over several devices run
# (tests/test_torch_worker_replicas.py, tests/test_torch_zoo_mesh.py)
SCAN_LM = {**LM, "config": {**LM["config"], "scan_layers": True}}


@pytest.mark.parametrize("doc,what", [
    (op(dict(program(SCAN_LM, LM_DATA, 2), replicas=2)), None),
    (op(dict(program(SCAN_LM, LM_DATA, 2), mesh={"data": 2})), None),
    (op({"kind": "job", "container": {"command": ["true"]}, "connections": ["s3"]}),
     "connections"),
    (op({"kind": "job", "container": {"command": ["true"]},
         "init": [{"artifacts": {"run": "x"}}]}), "artifacts init"),
    (op({"kind": "job", "container": {"command": ["true"]}},
        hooks=[{"connection": "slack"}]), "notifier hook"),
    (op({"kind": "job", "container": {"command": ["true"]}},
        schedule={"kind": "cron", "cron": "0 * * * *"}), "schedule"),
])
def test_refusals_name_the_roadmap(stores, doc, what):
    compiled = compile_operation(V1Operation.from_dict(doc), run_uuid=UUID)
    if what == "schedule":  # the agent fires a schedule; a firing runs as any op
        from polyaxon_tpu_torch.runtime.executor import refusal

        assert refusal(compiled) is None
        assert Executor(stores[0], device="cpu").execute(compiled) == "succeeded"
        return
    if what is None:
        from polyaxon_tpu_torch.models import build_model
        from polyaxon_tpu_torch.runtime.executor import gang_size, refusal

        assert refusal(compiled) is None and gang_size(compiled.run) == 2
        model = compiled.run.program.model
        module = build_model(model.name, dict(model.config), device="cpu").module
        assert module.scan.block.attention.q_proj.weight.shape[0] == LM["config"]["n_layers"]
        return
    with pytest.raises(NotImplementedError, match=rf"{what}.*ROADMAP\.md"):
        Executor(stores[0], device="cpu").execute(compiled)
    assert stores[0].list_runs() == []  # refused before the run exists


def test_a_two_node_dag_runs_like_the_reference(stores):
    """`b` after `a` through `scheduler/dag.py::execute_dag`: the DAG run's
    story and each child's status as the reference's."""
    job = {"kind": "component", "run": {"kind": "job", "container": {"command": ["true"]}}}
    doc = op({"kind": "dag", "operations": [
        {"name": "a", "component": job},
        {"name": "b", "dependsOn": ["a"], "component": job}]})
    assert run_both(stores, doc) == ("succeeded", "succeeded")
    assert_same_story(stores)
    for store in stores:
        children = {r["name"]: store.get_status(r["uuid"])["status"]
                    for r in store.list_runs() if r["uuid"] != UUID}
        assert children == {"a": "succeeded", "b": "succeeded"}
        assert "dag node b: run" in store.read_logs(UUID)


def test_a_mesh_on_one_device_runs_the_single_device_program(stores):
    doc = op(dict(program(MLP, MNIST, 2), mesh={"data": -1}))
    compiled = compile_operation(V1Operation.from_dict(doc), run_uuid=UUID)
    assert Executor(stores[0], device="cpu").execute(compiled) == "succeeded"
    assert json.loads(json.dumps(stores[0].read_spec(UUID)))["component"]["run"]["mesh"] == {
        "data": -1}


def test_scheduler_eviction_and_elastic_grant_are_refused_at_run_time(stores):
    """A scheduler eviction (`preempt_requested` set at a log point)
    checkpoints at the step boundary, releases the run's reservation and
    requeues it at its original priority; a grant in the meta of a run
    that is not elastic changes nothing."""
    from polyaxon_tpu_torch.scheduler.fleet import Fleet
    from polyaxon_tpu_torch.scheduler.queue import RunQueue

    store = stores[0]
    log_metrics = store.log_metrics

    def evict_at_step_1(run_uuid, step, metrics):
        log_metrics(run_uuid, step, metrics)
        if step == 1:
            store.set_meta(run_uuid, preempt_requested=True)

    store.log_metrics = evict_at_step_1
    doc = op(program(MLP, MNIST, 4))
    doc["component"]["run"]["program"]["train"]["checkpointEvery"] = 2
    compiled = compile_operation(V1Operation.from_dict(doc), run_uuid=UUID)
    Fleet(store).configure(chips=1)
    store.create_run(UUID, "t", "default", compiled.to_dict(),
                     meta={"queue": "bulk", "priority": 3})
    assert Fleet(store).reserve(UUID, chips=1) is not None
    assert Executor(store, device="cpu").execute(compiled) == "queued"
    assert conditions(store, UUID)[-2:] == [("retrying", "evicted"), ("queued", "")]
    assert not preemption.requested()
    (entry,) = RunQueue(store, name="bulk").peek_all()
    assert (entry["uuid"], entry["priority"], entry["chips"]) == (UUID, 3, 1)
    assert Fleet(store).ledger.get(UUID) is None
    meta = store.get_status(UUID)["meta"]
    assert meta["preempt_restarts"] == 1 and meta["preempt_requested"] is False
    (evicted,) = [e for e in store.read_events(UUID) if e.get("scheduler")]
    assert evicted["kind"] == "preempted" and evicted["step"] == 2  # the boundary's checkpoint

    store.log_metrics = log_metrics
    uid = "d" * 32
    compiled = compile_operation(V1Operation.from_dict(op(program(MLP, MNIST, 2))),
                                 run_uuid=uid)
    store.create_run(uid, "t", "default", compiled.to_dict(), meta={"granted_chips": 2})
    assert Executor(store, device="cpu").execute(compiled) == "succeeded"
    assert not [e for e in store.read_events(uid) if e["kind"] == "elastic_resize"]
