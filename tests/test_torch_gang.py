"""The port's gang against the JAX package's, on the CPU: the native
supervisor (`polyaxon_tpu_torch/native/launcher.cpp`, built into
`build/torch_native/`), `runtime/health.py`, `runtime/worker.py` and the
executor's `_run_distributed`, mirroring `tests/test_distributed.py`.

- the launcher builds, injects torch.distributed's rendezvous environment
  (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) and the extra
  variables, restarts the gang, tears it down when one worker fails, and
  times out, with the reference launcher's exit codes and event lines;
- a `replicas: 2` jaxjob of the flagship runs to SUCCEEDED through the
  port's CLI (`run -f`) and executor on two `gloo` workers, and its status
  conditions, event
  kinds and metric keys equal the JAX executor's on two jax.distributed
  workers of one CPU device each (the same {data: 2} mesh; the numbers
  differ: the reference's workers each read their own batch and init
  their own way, and `tests/test_torch_trainer_mesh.py` holds the numbers);
- `check_slice` runs in every gang worker (its `slice_health` event);
  its refusal of a short world is `tests/test_torch_mesh.py`'s, in that
  file's world;
- a worker SIGTERMed mid-run checkpoints, the gang exits 75 and the
  executor restarts it from the checkpoint as a preemption;
- a gang asked for more GPUs than are visible, without a CPU request,
  refuses, naming both counts, in the executor and in the worker.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import threading
import time

import jax
import numpy as np
import pytest
import torch

from polyaxon_tpu.compiler.resolver import compile_operation as jax_compile
from polyaxon_tpu.runtime.executor import Executor as JaxExecutor
from polyaxon_tpu.schemas.operation import V1Operation as JaxOperation
from polyaxon_tpu.store.local import RunStore as JaxStore
from polyaxon_tpu_torch.cli.main import main
from polyaxon_tpu_torch.compiler.resolver import compile_operation
from polyaxon_tpu_torch.native import launcher_path
from polyaxon_tpu_torch.runtime import worker
from polyaxon_tpu_torch.runtime.executor import Executor
from polyaxon_tpu_torch.schemas import V1Operation
from polyaxon_tpu_torch.store import RunStore

UUID = "9a9b" * 8
JAX_UUID = "7c7d" * 8  # another rendezvous port than the port's gang
LM = {"name": "transformer_lm", "config": {
    "dim": 64, "n_layers": 1, "n_heads": 4, "n_kv_heads": 4, "vocab_size": 512, "seq_len": 32}}
LM_DATA = {"name": "synthetic_text", "batchSize": 8, "config": {"seq_len": 32, "vocab_size": 512}}


def op(replicas, mesh, steps, **train):
    return {"kind": "operation", "name": "dist", "component": {
        "kind": "component", "name": "dist", "run": {
            "kind": "jaxjob", "replicas": replicas, "mesh": mesh,
            "program": {"model": LM, "data": LM_DATA,
                        "optimizer": {"name": "adamw", "learningRate": 1e-3},
                        "train": {"steps": steps, "logEvery": 2, "precision": "float32",
                                  **train}}}}}


def _launch(*args, timeout=30):
    return subprocess.run([launcher_path(), *args], capture_output=True, text=True,
                          timeout=timeout)


def test_launcher_builds():
    path = launcher_path()
    assert os.path.exists(path) and os.access(path, os.X_OK)
    assert "build/torch_native" in path.replace(os.sep, "/")


def test_launcher_env_injection():
    out = _launch("--num-workers", "3", "--coordinator", "127.0.0.1:1234",
                  "--env", "EXTRA=hello", "--", "/bin/sh", "-c",
                  'echo "r=$RANK l=$LOCAL_RANK n=$WORLD_SIZE a=$MASTER_ADDR '
                  'p=$MASTER_PORT w=$POLYAXON_WORKER_ID e=$EXTRA"')
    assert out.returncode == 0
    lines = sorted(line for line in out.stdout.splitlines() if line.startswith("r="))
    assert lines == [f"r={i} l={i} n=3 a=127.0.0.1 p=1234 w={i} e=hello" for i in range(3)]


def test_launcher_gang_restart_and_exit_code():
    out = _launch("--num-workers", "2", "--max-restarts", "2", "--", "/bin/sh", "-c", "exit 7")
    assert out.returncode == 7
    events = [json.loads(line) for line in out.stdout.splitlines()]
    assert [e["attempt"] for e in events if e["event"] == "gang_start"] == [0, 1, 2]
    assert events[-1] == {"event": "gang_done", "code": 7}


def test_launcher_gang_teardown_on_partial_failure():
    out = _launch("--num-workers", "2", "--", "/bin/sh", "-c",
                  'if [ "$RANK" = 0 ]; then exit 3; else sleep 30; fi', timeout=15)
    assert out.returncode == 3


def test_launcher_timeout():
    out = _launch("--num-workers", "1", "--timeout", "1", "--", "/bin/sh", "-c", "sleep 30",
                  timeout=15)
    assert out.returncode == 124


def _story(store, uuid):
    status = store.get_status(uuid)
    return (
        status["status"],
        [(c["type"], c.get("reason", "")) for c in status["conditions"]],
        [e["kind"] for e in store.read_events(uuid)],
        [sorted(k for k in m if k != "ts") for m in store.read_metrics(uuid)],
    )


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Gang workers inherit the environment: one thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


E2E_DOC = op(2, {"data": -1}, 4)


@pytest.fixture(scope="module")
def jax_gang(tmp_path_factory):
    """The JAX executor's gang run of E2E_DOC on two jax.distributed
    workers of one CPU device each, started when the module starts, on a
    thread, so it runs beside this module's other gangs (both are
    subprocesses); the test that reads it joins it."""
    store = JaxStore(tmp_path_factory.mktemp("jax-gang"))
    compiled = jax_compile(JaxOperation.model_validate(E2E_DOC), run_uuid=JAX_UUID,
                           artifacts_root=str(store.runs_dir))
    prev = os.environ.get("JAX_NUM_CPU_DEVICES")
    os.environ["JAX_NUM_CPU_DEVICES"] = "1"  # read when the workers start
    result: list = []
    thread = threading.Thread(target=lambda: result.append(JaxExecutor(store).execute(compiled)))
    thread.start()

    def finished():
        thread.join(timeout=300)
        return result

    yield store, finished
    thread.join(timeout=300)
    os.environ["JAX_NUM_CPU_DEVICES"] = prev if prev is not None else "8"


@pytest.fixture(autouse=True)
def _start_the_jax_gang_first(jax_gang):
    """Every test of the module asks for the JAX gang, so it starts with
    the first of them."""


def test_sigterm_to_a_worker_preempts_and_restarts(tmp_path):
    store = RunStore(tmp_path)
    doc = op(2, None, 12, checkpointEvery=2)  # steps enough to land the kill mid-run
    doc["component"]["run"]["program"]["train"]["logEvery"] = 1
    compiled = compile_operation(V1Operation.from_dict(doc), run_uuid=UUID,
                                 artifacts_root=str(store.runs_dir))
    killed = []

    def kill_rank_1_once_training():
        deadline = time.time() + 120
        while time.time() < deadline and not killed:
            if store.read_metrics(UUID):
                for line in store.read_logs(UUID).splitlines():
                    if '"event":"worker_start","worker":1' in line:
                        pid = json.loads(line.split("[launcher] ", 1)[1])["pid"]
                        os.kill(pid, signal.SIGTERM)
                        killed.append(pid)
                        return
            time.sleep(0.02)

    t = threading.Thread(target=kill_rank_1_once_training)
    t.start()
    status = Executor(store, device="cpu").execute(compiled)
    t.join()
    assert killed and status == "succeeded"
    conditions = [(c["type"], c.get("reason", "")) for c in store.get_status(UUID)["conditions"]]
    assert ("retrying", "preempted") in conditions
    logs = store.read_logs(UUID)
    assert '"code":75' in logs and "distributed gang preempted (exit code 75)" in logs
    events = store.read_events(UUID)
    assert [e["kind"] for e in events].count("worker_preempted") == 1
    resumed = [e for e in events if e["kind"] == "resumed"]
    assert resumed and resumed[0]["step"] > 0
    assert store.read_metrics(UUID)[-1]["step"] == 12


def test_a_gang_without_enough_gpus_refuses(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    store = RunStore(tmp_path)
    compiled = compile_operation(V1Operation.from_dict(op(2, None, 2)), run_uuid=UUID,
                                 artifacts_root=str(store.runs_dir))
    with pytest.raises(RuntimeError, match=r"2 workers.*1 GPU"):
        Executor(store, device="cuda").execute(compiled)
    assert store.list_runs() == []  # refused before the run exists
    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match=r"2 workers.*1 GPU"):
        worker.init_process_group(rank=0, world=2, local_rank=0)


def test_distributed_jaxjob_end_to_end(tmp_path, jax_gang, monkeypatch):
    """Last of the fast tests: the JAX gang has run beside the others. The
    port's run goes through the CLI (`run -f`, in-process), as a user
    submits it, on the CPU."""
    spec = tmp_path / "gang.yaml"
    spec.write_text(json.dumps(E2E_DOC))  # JSON is YAML's flow style
    monkeypatch.setenv("POLYAXON_HOME", str(tmp_path / "torch"))
    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(["run", "-f", str(spec)])
    assert code == 0 and "finished:" in out.getvalue(), out.getvalue()
    ours_store = RunStore(tmp_path / "torch")
    uuid = ours_store.list_runs()[0]["uuid"]
    assert ours_store.get_status(uuid)["status"] == "succeeded"
    jax_store, finished = jax_gang
    assert finished() == ["succeeded"]
    ours, ref = _story(ours_store, uuid), _story(jax_store, JAX_UUID)
    assert ours == ref
    metrics = ours_store.read_metrics(uuid)
    assert [m["step"] for m in metrics] == [2, 4]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    events = ours_store.read_events(uuid)
    summary = [e for e in events if e["kind"] == "run_summary"]
    assert summary and summary[0]["num_processes"] == 2
    health = [e for e in events if e["kind"] == "slice_health"]
    assert health[0]["devices"] == 2 and health[0]["all_reduce_ok"]
    assert '"event":"gang_done","code":0' in ours_store.read_logs(uuid)


# the counterparts of tests/test_distributed.py's slow gangs
@pytest.mark.slow
def test_distributed_gang_with_model_axis(tmp_path):
    """4 workers with a model (TP) axis: the row-parallel sums and the
    vocab-parallel loss cross process boundaries."""
    store = RunStore(tmp_path)
    compiled = compile_operation(V1Operation.from_dict(op(4, {"data": 2, "model": 2}, 2)),
                                 run_uuid=UUID, artifacts_root=str(store.runs_dir))
    assert Executor(store, device="cpu").execute(compiled) == "succeeded"
    assert store.read_metrics(UUID)[-1]["step"] == 2
    health = [e for e in store.read_events(UUID) if e["kind"] == "slice_health"]
    assert health and health[0]["devices"] == 4


@pytest.mark.slow
def test_distributed_multislice_gang(tmp_path):
    """`slices: 2` reaches the workers, whose hybrid mesh lays the data
    axis slice-major, and the steps run across the slice boundary."""
    doc = op(4, {"data": 4}, 2)
    doc["component"]["run"]["environment"] = {
        "resources": {"tpu": {"type": "v5e", "count": 2, "slices": 2}}}
    store = RunStore(tmp_path)
    compiled = compile_operation(V1Operation.from_dict(doc), run_uuid=UUID,
                                 artifacts_root=str(store.runs_dir))
    assert Executor(store, device="cpu").execute(compiled) == "succeeded"
    assert store.read_metrics(UUID)[-1]["step"] == 2
