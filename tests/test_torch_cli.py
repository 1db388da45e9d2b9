"""The port's CLI (`polyaxon_tpu_torch.cli.main.main(argv)`, in-process, on
`POLYAXON_TORCH_DEVICE=cpu`) against the reference's click `cli` under
`CliRunner`, each over its own temporary `POLYAXON_HOME`:

- `check` prints the same JSON for every example (the run uuid aside);
- `run -f examples/mnist.yaml -P steps=5 -P batch_size=8` prints the same
  lines, and the `ops` verbs, `config`, `events` and `timeline` read the
  runs alike (uuids, times and measured numbers masked);
- `ops resume` of a stopped run continues from its newest checkpoint;
- each refusal is a clean `Error:` naming ROADMAP.md, exit 1, and a usage
  error exits 2;
- `serve -uid` answers `/generate` with the greedy tokens of
  `ModelServer.from_run` on the same run, and `serve --pools 1:1` starts
  two CPU child processes (`python -m polyaxon_tpu_torch serve`) behind
  the router and answers through the prefill → decode handoff;
- a `{data: -1}` mesh (`examples/seq2seq.yaml`, its model cut to the
  `tiny-test` preset) runs as the single-device program.
"""

import contextlib
import io
import json
import os
import re
import signal
import socket
import threading
import time
import urllib.request
from pathlib import Path

import pytest
from click.testing import CliRunner

from polyaxon_tpu.cli.main import cli as jax_cli
from polyaxon_tpu_torch.cli.main import main
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.store import RunStore

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((REPO / "examples").glob("*.yaml"))
MNIST = str(REPO / "examples" / "mnist.yaml")


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Homes:
    """A home for each package; `ours(...)` and `ref(...)` run one command
    and return (exit code, stdout, stderr)."""

    def __init__(self, root: Path):
        self.root = root
        self.ours_home, self.ref_home = root / "torch", root / "jax"
        self.config = root / "config"

    def env(self, home):
        return {"POLYAXON_HOME": str(home), "POLYAXON_CONFIG_DIR": str(self.config),
                "POLYAXON_TORCH_DEVICE": "cpu"}

    def ours(self, *argv):
        out, err = io.StringIO(), io.StringIO()
        with _env(**self.env(self.ours_home)), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            code = main(list(argv))
        return code, out.getvalue(), err.getvalue()

    def ref(self, *argv):
        r = CliRunner().invoke(jax_cli, list(argv), env=self.env(self.ref_home))
        return r.exit_code, r.stdout, r.stderr


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    return Homes(tmp_path_factory.mktemp("cli"))


_UUID = re.compile(r"\b[0-9a-f]{32}\b|\b[0-9a-f]{8}\b")
_NUM = re.compile(r"-?\d+\.\d+(e[-+]?\d+)?|\b\d{6,}\b")
_TIME = re.compile(r"\b\d\d:\d\d:\d\d\b")


def _mask(text: str) -> str:
    return _NUM.sub("N", _TIME.sub("T", _UUID.sub("U", text)))


def _uid(homes, which, name):
    store = RunStore(homes.ours_home if which == "ours" else homes.ref_home)
    return next(r["uuid"] for r in reversed(store.list_runs()) if r["name"] == name)


# ------------------------------------------------------------------ check
@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_check_prints_the_reference_json(homes, path):
    (code, out, err), (rcode, rout, _) = homes.ours("check", "-f", str(path)), \
        homes.ref("check", "-f", str(path))
    assert code == rcode == 0, err
    ours, ref = json.loads(out), json.loads(rout)
    assert ours.pop("runUuid") != ref.pop("runUuid")
    assert json.dumps(ours) == json.dumps(ref)


# ------------------------------------------------------------------ run/ops
@pytest.fixture(scope="module")
def mnist_runs(homes):
    """Two mnist runs in each home (two, for `ops compare`)."""
    out = []
    for i in range(2):
        ours = homes.ours("run", "-f", MNIST, "-P", "steps=5", "-P", "batch_size=8",
                          "--name", f"mnist-{i}")
        ref = homes.ref("run", "-f", MNIST, "-P", "steps=5", "-P", "batch_size=8",
                        "--name", f"mnist-{i}")
        out.append((ours, ref))
    return out


def test_run_prints_the_reference_lines(mnist_runs):
    for (code, out, err), (rcode, rout, _) in mnist_runs:
        assert code == rcode == 0, err
        assert _mask(out) == _mask(rout)
        assert out.splitlines()[-1].endswith("finished: V1Statuses.SUCCEEDED")


def test_ops_verbs_read_runs_like_the_reference(homes, mnist_runs):
    ours_uid, ref_uid = _uid(homes, "ours", "mnist-0"), _uid(homes, "ref", "mnist-0")
    ours_uid1, ref_uid1 = _uid(homes, "ours", "mnist-1"), _uid(homes, "ref", "mnist-1")
    for argv in (("ops", "ls"), ("ops", "statuses", "-uid", "{u}"),
                 ("ops", "stop", "-uid", "{u}"), ("ops", "artifacts", "-uid", "{u}"),
                 ("timeline", "{u}"), ("config", "show")):
        (code, out, err) = homes.ours(*[a.format(u=ours_uid) for a in argv])
        (rcode, rout, _) = homes.ref(*[a.format(u=ref_uid) for a in argv])
        assert code == rcode == 0, (argv, err)
        if argv[:2] == ("config", "show"):
            ours_cfg, ref_cfg = json.loads(out), json.loads(rout)
            assert ours_cfg.pop("home") != ref_cfg.pop("home") and ours_cfg == ref_cfg
        else:
            assert _mask(out) == _mask(rout), argv
    # metrics: one JSON line a log point, with the same keys
    code, out, _ = homes.ours("ops", "metrics", "-uid", ours_uid)
    _, rout, _ = homes.ref("ops", "metrics", "-uid", ref_uid)
    assert [sorted(json.loads(x)) for x in out.splitlines()] == [
        sorted(json.loads(x)) for x in rout.splitlines()]
    code, out, _ = homes.ours("ops", "logs", "-uid", ours_uid)
    _, rout, _ = homes.ref("ops", "logs", "-uid", ref_uid)
    assert code == 0 and [ln.split(":")[0] for ln in out.splitlines()] == [
        ln.split(":")[0] for ln in rout.splitlines()]
    code, out, _ = homes.ours("ops", "get", "-uid", ours_uid)
    _, rout, _ = homes.ref("ops", "get", "-uid", ref_uid)
    assert code == 0 and sorted(json.loads(out)) == sorted(json.loads(rout))
    assert json.loads(out)["spec"]["component"] == json.loads(rout)["spec"]["component"]
    code, out, _ = homes.ours("ops", "compare", "-uid", ours_uid, "-uid", ours_uid1)
    _, rout, _ = homes.ref("ops", "compare", "-uid", ref_uid, "-uid", ref_uid1)
    assert code == 0 and [ln.split()[0] for ln in out.splitlines()[1:]] == [
        ln.split()[0] for ln in rout.splitlines()[1:]]
    code, out, _ = homes.ours("events", ours_uid)
    _, rout, _ = homes.ref("events", ref_uid)
    assert code == 0 and [json.loads(x).get("k") for x in out.splitlines()] == [
        json.loads(x).get("k") for x in rout.splitlines()]
    code, out, _ = homes.ours("stats", ours_uid)
    _, rout, _ = homes.ref("stats", ref_uid)
    assert code == 0 and _mask(out.splitlines()[0]) == _mask(rout.splitlines()[0])
    for kind in ("restart", "copy"):
        code, out, err = homes.ours("ops", kind, "-uid", ours_uid)
        _, rout, _ = homes.ref("ops", kind, "-uid", ref_uid)
        assert code == 0 and _mask(out) == _mask(rout), err
    assert homes.ours("ops", "delete", "-uid", ours_uid1, "--yes")[:2] == (
        0, f"{ours_uid1[:8]} deleted\n")
    assert homes.ours("ops", "get", "-uid", ours_uid1)[0] == 1
    assert homes.ours("config", "get", "nope")[0] == homes.ref("config", "get", "nope")[0] == 1


def test_ops_resume_continues_from_the_newest_checkpoint(homes, tmp_path, monkeypatch):
    spec = tmp_path / "ckpt.yaml"
    spec.write_text(Path(MNIST).read_text().replace(
        "logEvery: 20", "logEvery: 1\n        checkpointEvery: 2"))
    stop_at = {"step": 3}
    log_metrics = RunStore.log_metrics

    def stop_after(self, run_uuid, step, metrics):
        log_metrics(self, run_uuid, step, metrics)
        if step == stop_at["step"]:
            self.request_stop(run_uuid)

    monkeypatch.setattr(RunStore, "log_metrics", stop_after)
    code, out, err = homes.ours("run", "-f", str(spec), "-P", "steps=6", "-P", "batch_size=8",
                                "--name", "ckpt")
    assert code == 0 and out.endswith("finished: V1Statuses.STOPPED\n"), err
    src = _uid(homes, "ours", "ckpt")
    stop_at["step"] = None
    code, out, err = homes.ours("ops", "resume", "-uid", src)
    assert code == 0 and re.fullmatch(r"resume of \w{8} -> run (\w{8}) \(succeeded\)\n", out), (
        out, err)
    store = RunStore(homes.ours_home)
    child = _uid(homes, "ours", "ckpt-resume")
    # checkpoints at steps 2 (and 4 once resumed): the clone restores step 2
    assert [m["step"] for m in store.read_metrics(child)] == [3, 4, 5, 6]
    assert store.get_status(child)["meta"]["cloned_from"] == src
    assert any(e["kind"] == "lineage" for e in store.read_events(src))
    assert "--queue" in homes.ours("ops", "resume", "-uid", src, "--queue")[2]


# ------------------------------------------------------------------ refusals
def _op_file(tmp_path, name, body):
    p = tmp_path / f"{name}.yaml"
    p.write_text(body)
    return str(p)


JOB = "component:\n  kind: component\n  run: {kind: job, container: {command: ['true']}}\n"


def _with_scan_layers(example: str) -> str:
    """An example's text with `scan_layers: true` in its model config."""
    text = (REPO / "examples" / example).read_text()
    return re.sub(r"(\n( +)config:\n)", r"\1\2  scan_layers: true\n", text, count=1)


# A gang (replicas over several devices) runs, the zoo's included
# (tests/test_torch_worker_replicas.py); one of a config its workers would
# refuse is refused before it starts.
@pytest.mark.parametrize("argv,what", [
    (["run", "-f", "@scan-longcontext"], "replicas: 8"),
    (["run", "-f", "@scan-replicas2"], "replicas: 2"),
    (["run", "-f", "@scan-llama_lora"], "replicas: 8"),
    (["run", "-f", str(REPO / "examples" / "vit_hyperband.yaml")], "matrix"),
    (["run", "-f", "@sched"], "schedule"),
    (["run", "-f", "@joins"], "joins"),
    (["run", "-f", "@conn"], "connections"),
    (["serve", "-uid", "x", "--mesh", "model=2"], "--mesh"),
    (["serve", "-uid", "x", "--mesh-model", "2"], "--mesh"),
])
def test_refusals_are_clean_errors_naming_the_roadmap(homes, tmp_path, argv, what):
    files = {
        "@sched": _op_file(tmp_path, "sched", "kind: operation\nschedule: {kind: cron}\n" + JOB),
        "@joins": _op_file(tmp_path, "joins", "kind: operation\njoins: [{query: 'x'}]\n" + JOB),
        "@conn": _op_file(tmp_path, "conn", "kind: operation\n" + JOB.replace(
            "kind: job,", "kind: job, connections: [s3],")),
        "@scan-longcontext": _op_file(tmp_path, "scan-lc", _with_scan_layers("longcontext.yaml")),
        "@scan-llama_lora": _op_file(tmp_path, "scan-ll", _with_scan_layers("llama_lora.yaml")),
        "@scan-replicas2": _op_file(tmp_path, "scan-r2", (
            "kind: operation\ncomponent:\n  kind: component\n  run:\n    kind: jaxjob\n"
            "    replicas: 2\n    mesh: {data: -1}\n    program:\n      model:\n"
            "        name: transformer_lm\n        config: {preset: tiny, scan_layers: true}\n")),
    }
    code, out, err = homes.ours(*[files.get(a, a) for a in argv])
    assert code == 1 and out == ""
    assert err.startswith("Error: ") and what in err and "ROADMAP.md" in err, err


def test_remote_control_plane_is_refused(homes):
    with _env(POLYAXON_STREAMS_URL="http://127.0.0.1:9"):
        code, _, err = homes.ours("run", "-f", MNIST)
    assert code == 1 and "streams_url" in err and "ROADMAP.md" in err


def test_usage_errors_exit_2_like_the_reference(homes):
    for argv in (["run"], ["run", "-f", "/nonexistent.yaml"], ["ops", "get"],
                 ["ops", "logs", "-uid"], ["nosuch"]):
        code, _, err = homes.ours(*argv)
        assert code == homes.ref(*argv)[0] == 2 and err.startswith("Error: "), argv
    assert homes.ours("ops", "get", "-uid", "nope")[0] == homes.ref(
        "ops", "get", "-uid", "nope")[0] == 1
    assert homes.ours("version")[1] == homes.ref("version")[1]


def test_a_one_device_mesh_runs_the_single_device_program(homes, tmp_path):
    text = (REPO / "examples" / "seq2seq.yaml").read_text()
    text = text.replace("config: {preset: small, src_len: 128, tgt_len: 128}",
                        "config: {preset: tiny-test, src_len: 16, tgt_len: 16}")
    text = text.replace("batchSize: 32", "batchSize: 2").replace(
        "config: {src_len: 128, tgt_len: 128, vocab_size: 32128}",
        "config: {src_len: 16, tgt_len: 16, vocab_size: 128}")
    spec = _op_file(tmp_path, "seq2seq", text)
    code, out, err = homes.ours("run", "-f", spec, "-P", "steps=2", "-P", "lr=1e-3")
    assert code == 0 and out.endswith("finished: V1Statuses.SUCCEEDED\n"), err
    # -P goes through JSON: 1e-3 is the float 0.001 in both packages
    assert RunStore(homes.ours_home).read_spec(_uid(homes, "ours", "seq2seq-small"))[
        "params"]["lr"] == 0.001


# ------------------------------------------------------------------ serve
LM_SPEC = """
kind: operation
name: tiny-lm
component:
  kind: component
  run:
    kind: jaxjob
    program:
      model:
        name: transformer_lm
        config: {dim: 64, n_layers: 2, n_heads: 4, n_kv_heads: 2, vocab_size: 128, seq_len: 64}
      data: {name: synthetic_text, batchSize: 2, config: {seq_len: 64, vocab_size: 128}}
      train: {steps: 2, logEvery: 1, checkpointEvery: 2, precision: float32}
      serving: {chunkedPrefill: true, kvPoolPages: 64, kvPageTokens: 8, prefillChunkTokens: 16}
"""
BODY = {"tokens": [[5, 9, 17, 33, 2, 7, 11, 40, 3, 21, 6, 8]], "maxNewTokens": 6}


@pytest.fixture(scope="module")
def lm_run(homes, tmp_path_factory):
    spec = tmp_path_factory.mktemp("lm") / "lm.yaml"
    spec.write_text(LM_SPEC)
    code, _, err = homes.ours("run", "-f", str(spec))
    assert code == 0, err
    return _uid(homes, "ours", "tiny-lm")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ready(url) -> bool:
    with urllib.request.urlopen(url + "/readyz", timeout=2) as r:
        return bool(json.loads(r.read()).get("ready"))


def _roles_known(url) -> bool:
    """The router has polled both pools' roles (until then it routes
    without a handoff target)."""
    with urllib.request.urlopen(url + "/statsz", timeout=2) as r:
        roles = {rep["replica_role"] for rep in json.loads(r.read())["replicas"]}
    return roles == {"prefill", "decode"}


def _serve_and_ask(homes, argv, port, body, timeout=120.0, ready=_ready):
    """Run `serve` on the main thread (it waits for SIGINT there) while a
    helper thread asks once `ready(url)`, then sends the SIGINT."""
    answer = {}

    def ask():
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                try:
                    if ready(url):
                        break
                except Exception:  # noqa: BLE001 — not up yet
                    pass
                time.sleep(0.2)
            req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                answer["body"] = json.loads(r.read())
            with urllib.request.urlopen(url + "/statsz", timeout=10) as r:
                reps = json.loads(r.read()).get("replicas") or []
            answer["handoff"] = {}
            for rep in reps:  # a fleet: each replica's own counters
                with urllib.request.urlopen(rep["url"] + "/statsz", timeout=10) as r:
                    kv = json.loads(r.read()).get("kv") or {}
                answer["handoff"][rep["replica_role"]] = kv.get("handoff") or {}
        finally:
            # only once `serve` waits on its own handler: a SIGINT before
            # that would interrupt the test session itself
            stop_by = time.monotonic() + 60
            while signal.getsignal(signal.SIGINT) is original and time.monotonic() < stop_by:
                time.sleep(0.05)
            if signal.getsignal(signal.SIGINT) is not original:
                os.kill(os.getpid(), signal.SIGINT)

    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    original = handlers[signal.SIGINT]
    t = threading.Thread(target=ask, daemon=True)
    t.start()
    try:
        code, out, err = homes.ours(*argv, "--port", str(port))
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    t.join(timeout=30)
    return code, out, err, answer


def test_serve_answers_with_the_greedy_tokens_of_from_run(homes, lm_run):
    want = ModelServer.from_run(lm_run, store=RunStore(homes.ours_home), device="cpu").generate(
        dict(BODY))
    code, out, err, answer = _serve_and_ask(homes, ["serve", "-uid", lm_run[:8]], _free_port(),
                                            BODY)
    assert code == 0, err
    assert out.startswith("serving transformer_lm (step 2) on http://127.0.0.1:")
    assert out.rstrip().endswith("draining...")
    assert answer["body"]["tokens"] == want["tokens"]


def test_serve_pools_runs_two_children_behind_the_router(homes, lm_run):
    body = {"tokens": [list(range(3, 24))], "maxNewTokens": 6}  # 21 tokens: two full pages
    code, out, err, answer = _serve_and_ask(
        homes, ["serve", "-uid", lm_run, "--pools", "1:1"], _free_port(), body, timeout=180.0,
        ready=_roles_known)
    assert code == 0, err
    assert "starting 2 replica(s)..." in out and "draining fleet..." in out
    want = ModelServer.from_run(lm_run, store=RunStore(homes.ours_home), device="cpu").generate(
        dict(body))
    assert answer["body"]["tokens"] == want["tokens"]
    # the prefill child exported the page set and the decode child adopted it
    assert answer["handoff"]["prefill"]["exports"] == 1
    assert answer["handoff"]["decode"]["adopted_pages"] == 2
