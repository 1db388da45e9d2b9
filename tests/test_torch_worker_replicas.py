"""A replica over several devices: the port's gang of `replicas x k`
workers against the JAX executor's gang of `replicas` processes of k
devices each, on the CPU.

`examples/resnet50.yaml` (2 replicas, mesh {data: -1}) scaled down: `-P`
params for the steps and the batch, and in the test's copy of the spec a
2x2 `tpu:` topology (4 chips, so k = 2) and its ResNet cut to depth 18
and width 8 on 32-pixel images. The port runs it under `POLYAXON_TORCH_DEVICE=cpu` as 2
replicas x 2 workers (`gloo`), the reference as 2 jax.distributed
processes of 2 virtual CPU devices each; both meshes are {data: 4}.

- each worker's `RANK`, `LOCAL_RANK` (its index in its replica) and
  replica, as it reports them in the run's logs;
- the status conditions, event kinds and metric keys equal the JAX
  executor's, and the per-process records are the reference's, by
  replica: `slice_health` (4 devices, 2 processes) and `run_summary`
  (`num_processes` 2);
- the losses equal a single replica of 4 workers on the same mesh;
- a spec from which no whole k follows is refused before the run exists,
  naming both numbers; `check` passes on the five shipped examples that
  put a replica over several devices, the executor no longer refuses
  them, and on a card with one GPU it refuses them for want of GPUs only,
  naming the counts.
"""

import contextlib
import io
import json
import os
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from polyaxon_tpu.compiler.resolver import compile_operation as jax_compile
from polyaxon_tpu.runtime.executor import Executor as JaxExecutor
from polyaxon_tpu.schemas.operation import V1Operation as JaxOperation
from polyaxon_tpu.store.local import RunStore as JaxStore
from polyaxon_tpu_torch.cli.main import main
from polyaxon_tpu_torch.compiler.resolver import compile_operation
from polyaxon_tpu_torch.polyaxonfile import read_polyaxonfile
from polyaxon_tpu_torch.runtime.executor import (
    Executor, gang_size, refusal, replica_devices)
from polyaxon_tpu_torch.schemas import V1Operation
from polyaxon_tpu_torch.store import RunStore

REPO = Path(__file__).resolve().parents[1]
UUID = "5e6f" * 8
SINGLE_UUID = "3a4b" * 8
JAX_UUID = "1c2d" * 8
EXAMPLES = ("bert", "bert_multislice", "resnet50", "llama_lora", "longcontext")


def resnet_doc(replicas=2, mesh=None) -> dict:
    """examples/resnet50.yaml with `-P steps=2 -P batch_size=8`, on 4 chips,
    its ResNet at depth 18 and width 8."""
    op = read_polyaxonfile(str(REPO / "examples" / "resnet50.yaml"),
                           params={"steps": 2, "batch_size": 8}).to_dict()
    run = op["component"]["run"]
    run["replicas"] = replicas
    if mesh is not None:
        run["mesh"] = mesh
    run["environment"]["resources"]["tpu"]["topology"] = "2x2"
    program = run["program"]
    program["model"] = {"name": "resnet", "config": {"depth": 18, "width": 8,
                                                  "num_classes": 10, "image_size": 32}}
    program["data"]["config"] = {"image_size": 32, "num_classes": 10}
    program["train"]["logEvery"] = 1
    return op


def _story(store, uuid):
    status = store.get_status(uuid)
    return (
        status["status"],
        [(c["type"], c.get("reason", "")) for c in status["conditions"]],
        [e["kind"] for e in store.read_events(uuid)],
        [sorted(k for k in m if k != "ts") for m in store.read_metrics(uuid)],
    )


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The port's 2 x 2 gang and its 1 x 4 twin, and the JAX gang of 2
    processes x 2 devices on a thread beside them."""
    jax_store = JaxStore(tmp_path_factory.mktemp("jax-replicas"))
    compiled = jax_compile(JaxOperation.model_validate(resnet_doc()), run_uuid=JAX_UUID,
                           artifacts_root=str(jax_store.runs_dir))
    prev = {k: os.environ.get(k) for k in ("JAX_NUM_CPU_DEVICES", "OMP_NUM_THREADS",
                                           "XLA_FLAGS")}
    os.environ["JAX_NUM_CPU_DEVICES"] = "2"  # read when the workers start
    os.environ["OMP_NUM_THREADS"] = "1"  # gang workers inherit it
    # the reference's numbers are not compared here (its workers read their
    # own batches): its workers compile unoptimized, at ~40% of the CPU
    os.environ["XLA_FLAGS"] = (prev["XLA_FLAGS"] or "") + " --xla_backend_optimization_level=0"
    result: list = []
    thread = threading.Thread(
        target=lambda: result.append(JaxExecutor(jax_store).execute(compiled)))
    thread.start()
    try:
        store = RunStore(tmp_path_factory.mktemp("torch-replicas"))
        statuses = {}
        for uuid, doc in ((UUID, resnet_doc()), (SINGLE_UUID, resnet_doc(1, {"data": 4}))):
            ours = compile_operation(V1Operation.from_dict(doc), run_uuid=uuid,
                                     artifacts_root=str(store.runs_dir))
            statuses[uuid] = Executor(store, device="cpu").execute(ours)
    finally:
        thread.join(timeout=600)
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return store, statuses, jax_store, result


def test_each_worker_has_its_rank_and_local_rank(gangs):
    store, statuses, _, _ = gangs
    assert statuses[UUID] == "succeeded"
    lines = [json.loads(m) for m in
             re.findall(r'\{"event":"worker_device"[^}]*\}', store.read_logs(UUID))]
    got = sorted((d["rank"], d["local_rank"], d["replica"], d["device"]) for d in lines)
    assert got == [(0, 0, 0, "cpu"), (1, 1, 0, "cpu"), (2, 0, 1, "cpu"), (3, 1, 1, "cpu")]


def test_records_equal_the_jax_executors(gangs):
    store, _, jax_store, result = gangs
    assert result == ["succeeded"]
    assert _story(store, UUID) == _story(jax_store, JAX_UUID)
    for kind, keys in (("slice_health", ("devices", "process_count", "all_reduce_ok")),
                       ("run_summary", ("num_processes",))):
        ours = [e for e in store.read_events(UUID) if e["kind"] == kind]
        ref = [e for e in jax_store.read_events(JAX_UUID) if e["kind"] == kind]
        assert len(ours) == len(ref) == 1
        assert {k: ours[0][k] for k in keys} == {k: ref[0][k] for k in keys}
    health = [e for e in store.read_events(UUID) if e["kind"] == "slice_health"][0]
    assert (health["devices"], health["process_count"]) == (4, 2)


def test_losses_equal_one_replica_of_four(gangs):
    store, statuses, _, _ = gangs
    assert statuses[SINGLE_UUID] == "succeeded"
    ours, single = store.read_metrics(UUID), store.read_metrics(SINGLE_UUID)
    assert [m["step"] for m in ours] == [m["step"] for m in single] == [1, 2]
    np.testing.assert_allclose([m["loss"] for m in ours], [m["loss"] for m in single],
                               rtol=1e-6)
    assert all(np.isfinite(m["loss"]) for m in ours)


@pytest.mark.parametrize("change,numbers", [
    # no mesh: k from the 8 chips of the 2x4 topology
    ({"replicas": 3, "mesh": None}, ("8 chips", "replicas: 3")),
    # the compiler fills {data: -1} from the chips: the mesh fixes 8
    ({"replicas": 3}, ("fixes 8 devices", "replicas: 3")),
])
def test_a_spec_without_a_whole_k_is_refused(tmp_path, monkeypatch, change, numbers):
    doc = resnet_doc()
    doc["component"]["run"]["environment"]["resources"]["tpu"]["topology"] = "2x4"
    doc["component"]["run"].update(change)
    store = RunStore(tmp_path)
    compiled = compile_operation(V1Operation.from_dict(doc), run_uuid=UUID,
                                 artifacts_root=str(store.runs_dir))
    with pytest.raises(ValueError) as e:
        Executor(store, device="cpu").execute(compiled)
    assert all(n in str(e.value) for n in numbers), str(e.value)
    assert store.list_runs() == []  # refused before the run exists
    spec = tmp_path / "spec.yaml"
    spec.write_text(json.dumps(doc))  # JSON is YAML's flow style
    monkeypatch.setenv("POLYAXON_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):  # the CLI: a clean error, exit 1
        assert main(["run", "-f", str(spec)]) == 1
    assert err.getvalue().startswith("Error: ") and all(n in err.getvalue() for n in numbers)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_check_and_run_as_gangs(tmp_path, monkeypatch, name):
    path = str(REPO / "examples" / f"{name}.yaml")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["check", "-f", path]) == 0
    compiled = compile_operation(read_polyaxonfile(path), run_uuid=UUID,
                                 artifacts_root=str(tmp_path))
    assert refusal(compiled) is None
    run = compiled.run
    assert replica_devices(run) == 4
    assert gang_size(run) == int(run.replicas) * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    store = RunStore(tmp_path)
    with pytest.raises(RuntimeError) as e:
        Executor(store, device="cuda").execute(compiled)
    msg = str(e.value)
    assert f"{gang_size(run)} workers" in msg and f"replicas: {run.replicas} x 4" in msg
    assert "1 GPU(s)" in msg
    assert store.list_runs() == []
