"""The port's CLI (`polyaxon_tpu_torch.cli.main.main(argv)`, in-process, on
`POLYAXON_TORCH_DEVICE=cpu`) against the reference's click `cli` under
`CliRunner`, each over its own temporary `POLYAXON_HOME`:

- `check` prints the same JSON for every example (the run uuid aside);
- `run -f examples/mnist.yaml -P steps=5 -P batch_size=8` prints the same
  lines, and the `ops` verbs, `config`, `events` and `timeline` read the
  runs alike (uuids, times and measured numbers masked);
- `ops resume` of a stopped run continues from its newest checkpoint;
- `run` of a `matrix:` prints the reference's trial lines and JSON summary,
  `ops ls --sweep` lists the trials, `run` of a `joins:` file collects
  their losses, and `ops delete` of the sweep needs `--cascade`;
- each refusal is a clean `Error:` naming ROADMAP.md, exit 1, and a usage
  error exits 2;
- with `POLYAXON_STREAMS_URL` set, `run --watch` and the `ops` verbs go
  over HTTP to the port's streams server, an agent thread running the
  job, and print the reference's lines against the reference's server
  and agent; a remote sweep or schedule is refused as there;
- `project create|ls|get` and `store migrate|recover` print the
  reference's lines, and `top --once` its frame on one store with a stub
  router;
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
    # --queue: the clone waits for an agent, which drains it
    code, out, err = homes.ours("ops", "resume", "-uid", src, "--queue")
    assert code == 0 and re.fullmatch(r"resume of \w{8} -> run \w{8} \(queued\)\n", out), err
    assert homes.ours("agent", "drain") == (0, "processed 1 run(s)\n", "")
    queued = [r["uuid"] for r in store.list_runs() if r["name"] == "ckpt-resume"][-1]
    assert store.get_status(queued)["status"] == "succeeded"
    assert [m["step"] for m in store.read_metrics(queued)] == [3, 4, 5, 6]


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
# (tests/test_torch_worker_replicas.py). A scanned config (`scan_layers`)
# checks as the reference's does and its tiny gang runs; a schedule is
# registered for the agent, as the reference's `run` does; what is left
# unported is refused by name.
@pytest.mark.parametrize("argv,what", [
    (["check", "-f", "@scan-longcontext"], None),
    (["run", "-f", "@scan-replicas2"], None),
    (["check", "-f", "@scan-llama_lora"], None),
    (["run", "-f", "@sched"], "schedule"),
    (["run", "-f", "@conn"], "connections"),
])
def test_refusals_are_clean_errors_naming_the_roadmap(homes, tmp_path, argv, what):
    files = {
        "@sched": _op_file(tmp_path, "sched", "kind: operation\nschedule: {kind: interval, "
                                              "frequency: 3600}\n" + JOB),
        "@conn": _op_file(tmp_path, "conn", "kind: operation\n" + JOB.replace(
            "kind: job,", "kind: job, connections: [s3],")),
        "@scan-longcontext": _op_file(tmp_path, "scan-lc", _with_scan_layers("longcontext.yaml")),
        "@scan-llama_lora": _op_file(tmp_path, "scan-ll", _with_scan_layers("llama_lora.yaml")),
        "@scan-replicas2": _op_file(tmp_path, "scan-r2", (
            "kind: operation\nname: scan-r2\ncomponent:\n  kind: component\n  run:\n"
            "    kind: jaxjob\n    replicas: 2\n    mesh: {data: -1}\n    program:\n"
            "      model:\n        name: transformer_lm\n        config: {dim: 32, n_layers: 2,"
            " n_heads: 4, n_kv_heads: 2, vocab_size: 128, seq_len: 16, scan_layers: true}\n"
            "      data: {name: synthetic_text, batchSize: 4, config: {seq_len: 16,"
            " vocab_size: 128}}\n      train: {steps: 2, logEvery: 1}\n")),
    }
    argv = [files.get(a, a) for a in argv]
    code, out, err = homes.ours(*argv)
    if what == "schedule":
        rcode, rout, _ = homes.ref(*argv)
        sid = re.compile(r"^schedule \w{12} ")
        assert code == rcode == 0 and sid.sub("", out) == sid.sub("", rout), (out, rout, err)
        assert re.fullmatch(r"schedule \w{12} registered \(interval\); a running agent "
                            r"\(`polyaxon agent start`\) fires it\n", out)
        return
    if what is not None:
        assert code == 1 and out == ""
        assert err.startswith("Error: ") and what in err and "ROADMAP.md" in err, err
        return
    assert code == 0, err
    if argv[0] == "check":
        rcode, rout, _ = homes.ref(*argv)
        assert rcode == 0
        ours, ref = json.loads(out), json.loads(rout)
        assert ours.pop("runUuid") != ref.pop("runUuid")
        assert ours == ref
        return
    uid = _uid(homes, "ours", "scan-r2")
    status = RunStore(homes.ours_home).get_status(uid)
    assert status["status"] == "succeeded", status
    logs = RunStore(homes.ours_home).read_logs(uid)
    assert '"event":"gang_done","code":0' in logs and logs.count('"worker_device"') == 2


SWEEP = """\
kind: operation
name: cli-sweep
matrix:
  kind: grid
  params:
    lr: {kind: choice, value: [0.05, 1.0e-9]}
component:
  kind: component
  name: cli-sweep
  inputs:
  - {name: lr, type: float, value: 0.001}
  run:
    kind: jaxjob
    program:
      model: {name: mlp, config: {input_dim: 16, num_classes: 4, hidden: [16]}}
      data: {name: synthetic, batchSize: 8, config: {shape: [16], num_classes: 4}}
      optimizer: {name: adamw, learningRate: "{{ params.lr }}"}
      train: {steps: 4, logEvery: 2, precision: float32}
"""

JOINS = """\
kind: operation
name: cli-joins
joins:
- query: "project:sweeps tag:trial status:succeeded"
  sort: metrics.loss
  params:
    losses: {ref: runs.outputs.loss}
    names: {ref: runs.name}
component:
  kind: component
  name: cli-joins
  inputs:
  - {name: losses, type: list}
  - {name: names, type: list}
  run: {kind: job, container: {command: ['true']}}
"""


def _summary(out: str) -> dict:
    """The JSON summary `run` prints after the trials' lines."""
    return json.loads(out[out.index("{\n"):])


def test_run_a_sweep_and_a_join_over_its_trials_like_the_reference(homes, tmp_path):
    """`run` of a `matrix:` prints the trials' lines and the sweep's JSON
    summary as the reference does; `ops ls --sweep` lists its trials;
    `run` of a `joins:` file collects the trials' losses; `ops delete`
    of the sweep needs `--cascade`."""
    sweep = _op_file(tmp_path, "sweep", SWEEP)
    (code, out, err), (rcode, rout, _) = (homes.ours("run", "-f", sweep, "--project", "sweeps"),
                                          homes.ref("run", "-f", sweep, "--project", "sweeps"))
    assert code == rcode == 0, err
    assert _mask(out) == _mask(rout)
    ours, ref = _summary(out), _summary(rout)
    assert ours["status"] == ref["status"] == "succeeded"
    assert [t["params"] for t in ours["trials"]] == [{"lr": 0.05}, {"lr": 1e-9}]
    assert ours["best"]["params"] == ref["best"]["params"] == {"lr": 0.05}
    store = RunStore(homes.ours_home)
    trials = [t["uuid"] for t in ours["trials"]]
    assert all(store.get_status(u)["meta"]["sweep"] == ours["sweep"] for u in trials)
    (code, out, _), (_, rout, _) = (homes.ours("ops", "ls", "--sweep", ours["sweep"][:8]),
                                    homes.ref("ops", "ls", "--sweep", ref["sweep"][:8]))
    assert code == 0 and _mask(out) == _mask(rout)
    assert sorted(line[:8] for line in out.splitlines()) == sorted(u[:8] for u in trials)

    joins = _op_file(tmp_path, "joins", JOINS)
    (code, out, err), (rcode, rout, _) = (homes.ours("run", "-f", joins),
                                          homes.ref("run", "-f", joins))
    assert code == rcode == 0, err
    assert _mask(out) == _mask(rout)
    params = store.read_spec(_uid(homes, "ours", "cli-joins"))["params"]
    losses = sorted(t["objective"] for t in ours["trials"])
    assert params == {"losses": losses, "names": ["cli-sweep", "cli-sweep"]}
    ref_params = RunStore(homes.ref_home).read_spec(_uid(homes, "ref", "cli-joins"))["params"]
    assert ref_params["names"] == params["names"] and len(ref_params["losses"]) == 2

    code, _, err = homes.ours("ops", "delete", "-uid", ours["sweep"], "--yes")
    assert code == 1 and "cascade" in err
    code, out, _ = homes.ours("ops", "delete", "-uid", ours["sweep"], "--yes", "--cascade")
    assert code == 0 and all(u not in {r["uuid"] for r in store.list_runs()} for u in trials)


def test_a_sweep_without_a_card_is_a_clean_error(homes, tmp_path, monkeypatch):
    """Unset POLYAXON_TORCH_DEVICE means the card: without one, `run` of a
    sweep exits 1 with resolve_device's error before any run exists."""
    sweep = _op_file(tmp_path, "sweep-card", SWEEP)
    home = tmp_path / "no-card"
    monkeypatch.setenv("POLYAXON_HOME", str(home))
    monkeypatch.delenv("POLYAXON_TORCH_DEVICE", raising=False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main(["run", "-f", sweep])
    assert code == 1 and out.getvalue() == "" and "torch.cuda.is_available()" in err.getvalue()
    assert RunStore(home).list_runs() == []


def test_scheduler_commands_print_the_reference_lines(tmp_path):
    """queues, fleet (init, show, quota) and agent drain on a fresh home of
    each package: the same lines, JSON and exit codes."""
    homes = Homes(tmp_path)
    for argv in (["fleet", "init", "--chips", "4"], ["fleet", "init", "--topology", "2x4"],
                 ["fleet", "init", "--topology", "bad"],
                 ["fleet", "quota", "set", "team-a", "--max-chips", "2", "--weight", "2"],
                 ["fleet", "quota", "set", "queue:bulk", "--max-runs", "1"],
                 ["fleet", "quota", "set", "x", "--weight", "0"],
                 ["fleet", "quota", "ls"], ["fleet", "quota", "rm", "team-a"],
                 ["fleet", "quota", "rm", "team-a"], ["fleet", "show"],
                 ["queues", "set", "bulk", "--concurrency", "2", "--priority", "3"],
                 ["queues", "ls"], ["agent", "drain"], ["agent", "drain", "--queue", "bulk"]):
        code, out, err = homes.ours(*argv)
        rcode, rout, _ = homes.ref(*argv)
        assert code == rcode, (argv, err)
        assert out == rout, argv
        if code:
            assert err.startswith("Error: "), argv
    for flags in (["--cluster"], ["--namespace", "ns"], ["--context", "kind"],
                  ["--kube-dry-run"]):
        code, _, err = homes.ours("agent", "start", *flags)
        assert code == 1 and flags[0] in err and "k8s/" in err and "ROADMAP.md" in err


def test_agent_start_fires_a_schedule_and_stats_shows_the_fleet(tmp_path):
    homes = Homes(tmp_path)
    assert homes.ours("fleet", "init", "--chips", "1")[0] == 0
    spec = _op_file(tmp_path, "tick", "kind: operation\nname: tick\nschedule: {kind: interval, "
                    "frequency: 1, maxRuns: 1}\n" + JOB)
    assert homes.ours("run", "-f", spec)[0] == 0
    store = RunStore(homes.ours_home)
    done = threading.Event()

    def stop_when_fired():
        deadline = time.time() + 30
        while time.time() < deadline and not done.is_set():
            runs = store.list_runs()
            if runs and store.get_status(runs[0]["uuid"]).get("status") == "succeeded":
                break
            time.sleep(0.1)
        os.kill(os.getpid(), signal.SIGINT)

    threading.Thread(target=stop_when_fired, daemon=True).start()
    code, out, err = homes.ours("agent", "start", "--poll-interval", "0.1")
    done.set()
    assert code == 0 and out == "agent started; polling all queues (ctrl-c to stop)\n", err
    (run,) = store.list_runs()
    assert store.get_status(run["uuid"])["status"] == "succeeded"
    code, out, _ = homes.ours("stats", run["uuid"][:8])
    assert code == 0 and out.startswith(f"run {run['uuid'][:8]}  status=succeeded\n")
    assert "reservation" not in out  # released on the terminal transition


def test_remote_control_plane_is_refused(homes, tmp_path):
    """With streams_url set, `run` goes over HTTP: a server that does not
    answer is a clean error, and a sweep or a schedule is refused before
    any request, with the reference's message."""
    with _env(POLYAXON_STREAMS_URL="http://127.0.0.1:9"):
        code, out, err = homes.ours("run", "-f", MNIST)
        assert code == 1 and out == "" and err.startswith("Error: POST /runs: "), err
        for name, body in (("remote-sweep", SWEEP), ("remote-sched", (
                "kind: operation\nschedule: {kind: interval, frequency: 1}\n" + JOB))):
            spec = _op_file(tmp_path, name, body)
            (code, out, err), (rcode, rout, rerr) = (homes.ours("run", "-f", spec),
                                                     homes.ref("run", "-f", spec))
            assert code == rcode == 1 and out == rout == "", err
            assert err == rerr and "remote control plane" in err


REMOTE_JOB = ("kind: operation\nname: remote-job\ncomponent:\n  kind: component\n  run: "
              "{kind: job, container: {command: ['sh', '-c', 'echo out-line']}}\n")


def _remote(homes, home, server, agent, cli, argv_list):
    """Each command of `argv_list` through `cli` with POLYAXON_STREAMS_URL
    at `server` over `home`, an `agent` thread draining that store until
    its first run ends → [(exit code, stdout, stderr)]."""
    store = agent.store
    done = threading.Event()

    def finished():
        runs = store.list_runs()
        return done.is_set() or bool(runs and runs[0]["status"] in ("succeeded", "failed"))

    with server as srv:
        url = f"http://127.0.0.1:{srv.port}"
        t = threading.Thread(target=agent.serve, kwargs=dict(poll_interval=0.1, stop_when=finished))
        t.start()
        try:
            with _env(POLYAXON_STREAMS_URL=url, POLYAXON_HOME=str(home)):
                return url, [cli(*argv) for argv in argv_list]
        finally:
            done.set()
            t.join(timeout=30)


def test_remote_run_watch_and_ops_over_http_like_the_reference(homes, tmp_path):
    """`run --watch` POSTs the operation to the streams server, whose
    agent thread runs it, then prints its logs; every `ops` verb rides
    the same server. The port's server and agent against the reference's,
    lines masked. `restart` with streams_url set clones through the local
    store, as the reference's does."""
    from polyaxon_tpu.scheduler import Agent as JaxAgent
    from polyaxon_tpu.store.local import RunStore as JaxRunStore
    from polyaxon_tpu.streams import BackgroundServer as JaxServer
    from polyaxon_tpu_torch.scheduler import Agent
    from polyaxon_tpu_torch.streams import BackgroundServer

    spec = _op_file(tmp_path, "remote", REMOTE_JOB)
    argv = [("run", "-f", spec, "--watch"), ("ops", "ls"), ("ops", "statuses", "-uid", "remote-job"),
            ("ops", "metrics", "-uid", "remote-job"), ("ops", "logs", "-uid", "remote-job"),
            ("ops", "get", "-uid", "remote-job"), ("ops", "stop", "-uid", "remote-job"),
            ("ops", "artifacts", "-uid", "remote-job"),
            ("ops", "delete", "-uid", "remote-job", "--yes"), ("ops", "ls")]
    ours_home, ref_home = tmp_path / "remote-torch", tmp_path / "remote-jax"
    store = RunStore(ours_home)
    url, ours = _remote(homes, ours_home, BackgroundServer(store),
                        Agent(store=store, devices=["cpu"]), homes.ours, argv)
    jstore = JaxRunStore(ref_home)
    rurl, ref = _remote(homes, ref_home, JaxServer(jstore), JaxAgent(store=jstore),
                        lambda *a: homes.ref(*a), argv)
    for args, (code, out, err), (rcode, rout, _) in zip(argv, ours, ref):
        assert code == rcode == 0, (args, err)
        assert _mask(out.replace(url, "URL")) == _mask(rout.replace(rurl, "URL")), args
    code, out, _ = ours[0]
    assert "created on http://127.0.0.1" in out and "finished: succeeded" in out
    assert "out-line" in out and "out-line" in ours[4][1]
    assert "succeeded" in ours[1][1] and "succeeded" in ours[2][1]
    assert ours[-1][1] == "no runs\n"
    with BackgroundServer(store) as srv, _env(POLYAXON_STREAMS_URL=f"http://127.0.0.1:{srv.port}"):
        code, _, err = homes.ours("ops", "get", "-uid", "nosuchrun")
        assert code == 1 and err.startswith("Error: GET /runs/nosuchrun/status: HTTP 404")
    local = Homes(tmp_path / "clones")
    assert local.ours("run", "-f", spec)[0] == local.ref("run", "-f", spec)[0] == 0
    clones = []
    for cli, server in ((local.ours, BackgroundServer(RunStore(local.ours_home))),
                        (local.ref, JaxServer(JaxRunStore(local.ref_home)))):
        with server as srv, _env(POLYAXON_STREAMS_URL=f"http://127.0.0.1:{srv.port}"):
            clones.append([cli("ops", "restart", "-uid", "remote-job"), cli("ops", "ls")])
    for (code, out, err), (rcode, rout, _) in zip(*clones):
        assert code == rcode == 0, err
        assert _mask(out) == _mask(rout)
    assert "restart of" in clones[0][0][1] and "(succeeded)" in clones[0][0][1]
    assert clones[0][1][1].count("succeeded") == 2


def test_project_commands_print_the_reference_lines(tmp_path):
    homes = Homes(tmp_path)
    for argv in (["project", "ls"], ["project", "create", "vision", "--description", "cnn work"],
                 ["project", "create", "vision"], ["project", "get", "vision"],
                 ["project", "get", "nosuch"], ["run", "-f", _op_file(tmp_path, "p", "kind: operation\n" + JOB),
                                                "--project", "implicit"],
                 ["project", "ls"], ["project", "get", "implicit"]):
        (code, out, err), (rcode, rout, rerr) = homes.ours(*argv), homes.ref(*argv)
        assert code == rcode, (argv, err)
        assert _mask(out) == _mask(rout), argv
        assert err == rerr, argv


class _StubRouter:
    """A router's read surfaces with canned bodies: /statsz, /sloz and
    /queryz (one series with points)."""

    STATS = {"requests": 12, "retries": 1, "upstream_shed": 0, "errors": 2,
             "latency_ms": {"p95": 41.5}, "routable": 1,
             "cluster": {"queue_depth": 3.0, "inflight": 2, "queue_wait_ms_max": 7.25,
                         "serving_requests": 11.0, "serving_shed": 0.0},
             "replicas": [{"slug": "r0", "healthy": True, "queue_depth": 1, "queue_wait_ms": 2.5,
                           "inflight": 1, "requests": 7},
                          {"slug": "r1", "draining": True, "queue_depth": 0,
                           "queue_wait_ms": 0.0, "inflight": 0, "requests": 5}]}
    SLO = {"slos": [{"name": "ttft", "burn_rate": 0.5}, {"name": "errors", "burn_rate": 3.25,
                                                         "breached": True}]}

    def __enter__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):  # noqa: N802
                path = self.path.split("?")[0]
                body = {"/statsz": stub.STATS, "/sloz": stub.SLO}.get(path)
                if path == "/queryz":
                    body = ({"points": [[0, 1.0], [1, None], [2, 3.0], [3, 2.0]]}
                            if "router.requests" in self.path else {"points": []})
                data = json.dumps(body).encode()
                self.send_response(200 if body is not None else 404)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()


def test_top_once_prints_the_reference_frame(tmp_path):
    """`top --once` over one store and a stub router prints the frame of
    the reference's `render_frame`, time masked; both packages' frames
    name the runs."""
    from polyaxon_tpu.cli import top as jax_top
    from polyaxon_tpu.store.local import RunStore as JaxRunStore
    from polyaxon_tpu_torch.cli import top

    homes = Homes(tmp_path)
    assert homes.ours("run", "-f", _op_file(tmp_path, "t", "kind: operation\n" + JOB), "--name", "done-run")[0] == 0
    assert homes.ours("fleet", "init", "--chips", "2")[0] == 0
    from polyaxon_tpu_torch.client import RunClient
    from polyaxon_tpu_torch.schemas.operation import V1Operation

    store = RunStore(homes.ours_home)
    op = V1Operation.from_dict({"kind": "operation", "name": "waiting", "component": {
        "kind": "component", "run": {"kind": "job", "container": {"command": ["true"]}}}})
    RunClient(store=store, project="q").create(op)
    with _StubRouter() as router:
        homes.ref_home = homes.ours_home  # one store for both
        (code, out, err), (rcode, rout, _) = (homes.ours("top", "--url", router.url, "--once"),
                                              homes.ref("top", "--url", router.url, "--once"))
        assert code == rcode == 0, err
        assert _TIME.sub("T", out) == _TIME.sub("T", rout)
        assert "\x1b" not in out and "waiting" in out and "r1" in out and "BREACHED" in out
        assert "history  req/s" in out
        # the frame from the reference's renderer, on the port's run table
        runs, jruns = top._RunTable(), jax_top._RunTable()
        runs.apply(store.read_events_since(None)[0])
        jruns.apply(JaxRunStore(homes.ours_home).read_events_since(None)[0])
        kw = dict(url=router.url, fleet=None, stats=router.STATS, slo=router.SLO, when="T",
                  sparks=[("req/s", [1.0, None, 3.0])])
        assert top.render_frame(runs=runs, **kw) == jax_top.render_frame(runs=jruns, **kw)
    assert top.sparkline([1, 2, None, 8]) == jax_top.sparkline([1, 2, None, 8])
    assert homes.ours("top", "--url", "http://127.0.0.1:9", "--once")[1].count("unreachable") == 1


def test_store_migrate_and_recover_print_the_reference_lines(tmp_path):
    import shutil

    homes = Homes(tmp_path)
    assert homes.ours("run", "-f", _op_file(tmp_path, "s", "kind: operation\n" + JOB), "--name", "kept")[0] == 0
    shutil.copytree(homes.ours_home, homes.ref_home)
    uid = _uid(homes, "ours", "kept")
    for argv in (["store", "migrate"], ["store", "migrate"], ["store", "recover"],
                 ["store", "recover", "-uid", uid[:8]], ["store", "recover", "-uid", "nosuch"]):
        (code, out, err), (rcode, rout, rerr) = homes.ours(*argv), homes.ref(*argv)
        assert code == rcode, (argv, err)
        assert out == rout and err == rerr, argv
    assert RunStore(homes.ours_home).get_status(uid)["status"] == "succeeded"


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
