"""The port's in-job tracking client and callbacks
(`polyaxon_tpu_torch/tracking/`) against the reference's
(`polyaxon_tpu/tracking/`), on the CPU, with no JAX compile:

- the same calls of each package's `Run` (metrics, a metric, outputs,
  tags, text, an artifact, an image from an array and from a CPU tensor,
  a histogram, HTML, `end`) into two homes leave files that the
  reference's `RunStore` reads identically from both, and so does the
  port's (timestamps and home paths masked);
- a run of its own (no `POLYAXON_RUN_UUID`) goes created → running →
  succeeded in both;
- a container job run by the port's executor attaches through
  `tracking.init()` to the run its `POLYAXON_RUN_*` variables name;
- `polyaxon_log_fn`, `PolyaxonHFCallback` and `PolyaxonKerasCallback`
  log what the reference's do;
- with `transformers` imported here only, `PolyaxonHFCallback` has every
  `on_*` event of `transformers.TrainerCallback`, and a
  `transformers.trainer_callback.CallbackHandler` dispatches to it.
"""

import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import polyaxon_tpu.tracking.callbacks as jax_callbacks
import polyaxon_tpu.tracking.run as jax_run
import polyaxon_tpu_torch.tracking.callbacks as callbacks
import polyaxon_tpu_torch.tracking.run as run_mod
from polyaxon_tpu.store.local import RunStore as JaxRunStore
from polyaxon_tpu_torch.client import RunClient
from polyaxon_tpu_torch.schemas.operation import V1Operation
from polyaxon_tpu_torch.store import RunStore

REPO_ROOT = Path(__file__).resolve().parents[1]
UUID = "0123456789abcdef0123456789abcdef"
IMAGE = np.arange(12, dtype=np.float32).reshape(3, 4)


@pytest.fixture(autouse=True)
def _no_run_env(monkeypatch):
    for key in ("POLYAXON_RUN_UUID", "POLYAXON_RUN_OUTPUTS_PATH", "POLYAXON_PROJECT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(run_mod, "_active_run", None)
    monkeypatch.setattr(jax_run, "_active_run", None)


def _drive(run, tmp_path, image):
    """The same calls on either package's `Run`."""
    src = tmp_path / "weights.txt"
    src.write_text("w")
    run.log_metrics(loss=0.5, acc=0.25)
    run.log_metrics(step=7, loss=0.4)
    run.log_metric("lr", 3e-4)
    run.log_outputs(best=0.4, note="fine")
    run.log_tags("a", "b")
    run.log_text("hello from the job")
    run.log_artifact(str(src))
    run.log_artifact(str(src), name="nested/copy.txt", kind="model")
    run.log_image(image, "img")
    run.log_histogram("h", np.linspace(-1, 1, 50), bins=5)
    run.log_html("report", "<b>ok</b>")
    run.end()


def _homes(tmp_path, image=IMAGE, own=False):
    """(the reference's home, the port's) after the same calls; `own`:
    each `Run` creates its run, else it attaches to UUID."""
    homes = tmp_path / "jax", tmp_path / "torch"
    for home, store, make in ((homes[0], JaxRunStore(homes[0]), jax_run.Run),
                              (homes[1], RunStore(homes[1]), run_mod.Run)):
        if own:
            run = make(store=store, name="mine", project="p")
        else:
            store.create_run(UUID, "attached", "p", {"kind": "job"})
            run = make(UUID, store=store)
        _drive(run, tmp_path, image)
    return homes


_HEX = re.compile(r"[0-9a-f]{32}")
_EPOCH = re.compile(r"\b1\d{9}(\.\d+)?\b")


def _read(store, uuid, home):
    out = {
        "metrics": store.read_metrics(uuid),
        "events": store.read_events(uuid),
        "logs": store.read_logs(uuid),
        "status": store.get_status(uuid),
        "files": sorted(str(p.relative_to(store.outputs_dir(uuid)))
                        for p in store.outputs_dir(uuid).rglob("*") if p.is_file()),
    }
    text = json.dumps(out, sort_keys=True, default=str).replace(str(home), "HOME")
    return _EPOCH.sub("0", _HEX.sub("U", text))  # still JSON


@pytest.mark.parametrize("reader", ["reference", "port"])
@pytest.mark.parametrize("own", [False, True], ids=["attached", "own-run"])
def test_run_writes_what_either_store_reads_alike(tmp_path, reader, own):
    homes = _homes(tmp_path, own=own)
    make = JaxRunStore if reader == "reference" else RunStore
    reads = []
    for home in homes:
        store = make(home)
        uuid = store.list_runs()[0]["uuid"]
        reads.append(_read(store, uuid, home))
    assert reads[0] == reads[1]
    if own:
        status = json.loads(reads[1])["status"]
        assert status["status"] == "succeeded"
        assert [c["type"] for c in status["conditions"]] == [
            "created", "compiled", "queued", "scheduled", "running", "succeeded"]


def test_log_image_takes_a_cpu_tensor(tmp_path):
    store = RunStore(tmp_path)
    store.create_run(UUID, "t", "p", {"kind": "job"})
    run = run_mod.Run(UUID, store=store)
    path = run.log_image(torch.from_numpy(IMAGE).requires_grad_(True), "img")
    np.testing.assert_array_equal(np.load(path), IMAGE)
    run.log_histogram("h", torch.linspace(-1, 1, 50), bins=5)
    hist = [e for e in store.read_events(UUID) if e.get("kind") == "histogram"][-1]
    ref = np.histogram(np.linspace(-1, 1, 50, dtype=np.float32), bins=5)
    assert hist["counts"] == ref[0].tolist()


def test_a_container_job_attaches_through_its_environment(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(
        f"import sys; sys.path.insert(0, {str(REPO_ROOT)!r})\n"
        "from polyaxon_tpu_torch import tracking\n"
        "run = tracking.init()\n"
        "run.log_metrics(step=3, loss=0.125)\n"
        "open('made.txt', 'w').write('x')\n"
        "run.log_artifact('made.txt')\n"
        "tracking.log_metrics(loss=0.0625)\n"
        "tracking.end()\n")
    op = V1Operation.from_dict({
        "version": 1.1, "kind": "operation", "name": "tracked",
        "component": {"kind": "component", "name": "tracked", "run": {
            "kind": "job", "container": {"command": [sys.executable, str(script)],
                                         "workingDir": str(tmp_path)}}}})
    store = RunStore(tmp_path / "home")
    uuid = RunClient(store=store, device="cpu").create(op, queue=False)
    assert store.get_status(uuid)["status"] == "succeeded", store.read_logs(uuid)
    rows = store.read_metrics(uuid)
    assert [(r["step"], r["loss"]) for r in rows] == [(3, 0.125), (4, 0.0625)]
    assert (store.outputs_dir(uuid) / "made.txt").read_text() == "x"
    assert any(e.get("kind") == "artifact" for e in store.read_events(uuid))


def _callback_calls(pkg, store):
    """The same callback calls through either package, into `store`'s run."""
    run = (jax_run if pkg is jax_callbacks else run_mod).Run(UUID, store=store)
    pkg.polyaxon_log_fn(run)(2, {"loss": np.float32(0.5), "n": 3})
    hf = pkg.PolyaxonHFCallback(run)
    state = SimpleNamespace(global_step=10, epoch=1.5)
    hf.on_log(None, state, None, logs={"loss": 0.25, "text": "skip", "lr": 1e-3})
    hf.on_log(None, state, None, logs={})
    hf.on_train_end(None, state, None)
    keras = pkg.PolyaxonKerasCallback(run)
    keras.set_params({"epochs": 2})
    keras.on_epoch_end(0, {"loss": 0.75, "name": "x"})
    keras.on_epoch_end(1, None)
    keras.on_train_end({"loss": 0.5})
    return store


def test_callbacks_log_like_the_reference(tmp_path):
    reads = []
    for name, pkg, make in (("jax", jax_callbacks, JaxRunStore), ("torch", callbacks, RunStore)):
        store = make(tmp_path / name)
        store.create_run(UUID, "cb", "p", {"kind": "job"})
        _callback_calls(pkg, store)
        reads.append(_read(store, UUID, tmp_path / name))
    assert reads[0] == reads[1]
    assert json.loads(reads[1])["metrics"][0]["loss"] == 0.5


def test_hf_callback_has_every_event_and_dispatches(tmp_path):
    from transformers import TrainerCallback
    from transformers.trainer_callback import CallbackHandler, TrainerControl, TrainerState

    events = sorted(n for n in dir(TrainerCallback) if n.startswith("on_"))
    assert len(events) >= 15
    assert all(callable(getattr(callbacks.PolyaxonHFCallback, n, None)) for n in events)
    store = RunStore(tmp_path)
    store.create_run(UUID, "hf", "p", {"kind": "job"})
    cb = callbacks.PolyaxonHFCallback(run_mod.Run(UUID, store=store))
    handler = CallbackHandler([cb], None, None, None, None)
    state, control = TrainerState(), TrainerControl()
    state.global_step, state.epoch = 5, 1.0
    args = SimpleNamespace()
    extra = {"on_log": {"logs": {"loss": 0.3}}, "on_evaluate": {"metrics": {}},
             "on_predict": {"metrics": {}}}
    for event in events:
        getattr(handler, event)(args, state, control, **extra.get(event, {}))
    assert [(r["step"], r["loss"]) for r in store.read_metrics(UUID)] == [(5, 0.3)]
    outputs = [e for e in store.read_events(UUID) if e.get("kind") == "outputs"]
    assert outputs[-1]["outputs"] == {"global_step": 5, "epochs": 1.0}
