"""The port's streams and control service (`polyaxon_tpu_torch/streams/`)
against the reference's (`polyaxon_tpu/streams/`), on the CPU, with no
JAX compile.

One store is built through the port: three container runs of trivial
shell commands (two projects, one with an artifact in a subdirectory),
metrics and events logged into them, and a queued run. A copy of its
home goes to each server: the reference's `BackgroundServer` over one,
the port's over the other, so each mutating request meets the same
state. For every route both answer with the same status code and the
same body, uuids and timestamps masked:

- each GET: health, readiness, the index (by project), a run's status,
  logs (by offset), metrics (by tail), events, timeline, spec and
  artifacts, a download, `/fleetz`, `/queryz` without a history, the
  `?watch=` long-poll from a cursor and from now, `/openapi.json`;
- 400 on a bad `offset`, `tail` or `timeout`, 403 on a path out of the
  outputs, 404 on an unknown run, route or artifact;
- `POST /runs` (the queued entries and compiled specs equal), a body
  without an operation and bad JSON (400; a bad spec is 400 on both, its
  message the validator's own), `POST .../stop`;
- `DELETE` (409 on an active run, then 200, then 404).

`/metricsz` is each process's own registry: both serve Prometheus text,
and with `federate` both re-export a source by its slug. The dashboard's
page is the reference's, and every path it calls is served.
"""

import json
import re
import shutil
import urllib.error
import urllib.request

import pytest

from polyaxon_tpu.store.local import RunStore as JaxRunStore
from polyaxon_tpu.streams import BackgroundServer as JaxServer
from polyaxon_tpu.streams.openapi import spec as jax_spec
from polyaxon_tpu_torch.client import RunClient
from polyaxon_tpu_torch.schemas.operation import V1Operation
from polyaxon_tpu_torch.store import RunStore
from polyaxon_tpu_torch.streams import BackgroundServer
from polyaxon_tpu_torch.streams.openapi import spec
from polyaxon_tpu_torch.streams.ui import INDEX_HTML


def _op(name, command, tags=None):
    return V1Operation.from_dict({
        "version": 1.1, "kind": "operation", "name": name, "tags": tags,
        "component": {"kind": "component", "name": name,
                      "run": {"kind": "job", "container": {"command": ["sh", "-c", command]}}},
    })


WRITE = ("echo out-line; echo second-line; mkdir -p $POLYAXON_RUN_OUTPUTS_PATH/sub; "
         "echo payload > $POLYAXON_RUN_OUTPUTS_PATH/sub/a.txt")
SUBMIT = {"version": 1.1, "kind": "operation", "name": "posted",
          "component": {"kind": "component", "name": "posted",
                        "run": {"kind": "job", "container": {"command": ["true"]}}}}


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    """(the reference server's home, the port's), copies of one store:
    name → uuid of its runs, and the event-log cursor after the first."""
    root = tmp_path_factory.mktemp("streams")
    store = RunStore(root / "built")
    runs = {}
    for name, project, command in (("writer", "alpha", WRITE), ("plain", "alpha", "echo hi"),
                                   ("other", "beta", "echo beta-line")):
        runs[name] = RunClient(store=store, project=project, device="cpu").create(
            _op(name, command), queue=False)
    cursor = store.head_cursor()
    for step in range(3):
        store.log_metrics(runs["writer"], step, {"loss": 1.0 / (step + 1), "acc": 0.25 * step})
    store.log_event(runs["writer"], "note", {"text": "hello", "n": 3})
    runs["queued"] = RunClient(store=store, project="alpha").create(_op("queued", "true"))
    shutil.copytree(root / "built", root / "jax")
    shutil.copytree(root / "built", root / "torch")
    return root / "jax", root / "torch", runs, cursor


@pytest.fixture(scope="module")
def servers(homes):
    jax_home, torch_home, runs, cursor = homes
    with JaxServer(JaxRunStore(jax_home)) as ref, BackgroundServer(RunStore(torch_home)) as ours:
        yield f"http://127.0.0.1:{ref.port}", f"http://127.0.0.1:{ours.port}", runs, cursor


def _call(url, method="GET", body=None, raw=None):
    """(status, content type, body bytes)."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


_UUID = re.compile(r"[0-9a-f]{32}")
_EPOCH = re.compile(r"\b1\d{9}(\.\d+)?(e[-+]?\d+)?\b")
_HOME = re.compile(r"/[^\"]*/(jax|torch)/")


def _mask(body: bytes) -> str:
    text = body.decode()
    return _EPOCH.sub("T", _UUID.sub("U", _HOME.sub("HOME/", text)))


def _both(servers, path, **kw):
    ref, ours = servers[0], servers[1]
    return _call(ref + path, **kw), _call(ours + path, **kw)


def _path(route, runs, cursor):
    return route.format(u=runs.get("writer", ""), p=runs.get("plain", ""),
                        q=runs.get("queued", ""), short=runs.get("writer", "")[:8],
                        cursor=cursor)


GETS = [
    "/healthz", "/readyz", "/runs", "/runs?project=alpha", "/runs?project=none",
    "/runs/{u}", "/runs/{u}/status", "/runs/{short}/status", "/runs/writer/status",
    "/runs/{u}/logs", "/runs/{u}/logs?offset=4", "/runs/{u}/logs?offset=100000",
    "/runs/{u}/metrics", "/runs/{u}/metrics?tail=2", "/runs/{u}/metrics?tail=0",
    "/runs/{u}/events", "/runs/{u}/timeline", "/runs/{p}/timeline", "/runs/{u}/spec",
    "/runs/{q}/status", "/runs/{u}/artifacts", "/runs/{p}/artifacts",
    "/runs/{u}/artifacts/sub/a.txt", "/runs?watch={cursor}&timeout=0",
    "/runs?watch=now&timeout=0", "/fleetz", "/queryz", "/queryz?series=x",
    # client errors
    "/runs/{u}/logs?offset=x", "/runs/{u}/metrics?tail=two", "/runs?watch=now&timeout=soon",
    "/runs/{u}/artifacts/../../status.json", "/runs/{u}/artifacts/sub/../../../x",
    "/runs/nosuchrun/status", "/runs/nosuchrun", "/nosuch", "/runs/{u}/nosuch",
    "/runs/{u}/artifacts/missing.txt",
]


@pytest.mark.parametrize("route", GETS)
def test_get_answers_like_the_reference(servers, route):
    path = _path(route, servers[2], servers[3])
    (rcode, rtype, rbody), (code, ctype, body) = _both(servers, path)
    assert code == rcode, (path, body)
    assert ctype == rtype, path
    assert _mask(body) == _mask(rbody), path


def test_watch_returns_the_runs_transitions_in_order(servers):
    ref, ours, runs, cursor = servers
    _, _, body = _call(f"{ours}/runs?watch={cursor}&timeout=0")
    events = json.loads(body)["events"]
    assert events and json.loads(body)["cursor"]
    queued = [e["status"] if e["kind"] == "status" else e["kind"]
              for e in events if e.get("r") == runs["queued"]]
    assert queued == ["create", "compiled", "queued"]
    # the next poll from the returned cursor holds nothing older
    _, _, again = _call(f"{ours}/runs?watch={json.loads(body)['cursor']}&timeout=0")
    assert json.loads(again)["events"] == []


def test_openapi_and_the_dashboard(servers):
    ref, ours, runs, _ = servers
    assert spec() == jax_spec()
    (rcode, _, rbody), (code, ctype, body) = _both(servers, "/openapi.json")
    assert code == rcode == 200 and json.loads(body) == json.loads(rbody)
    for page in ("/", "/ui"):
        (rcode, rtype, rbody), (code, ctype, body) = _both(servers, page)
        assert code == rcode == 200 and ctype == rtype == "text/html" and body == rbody
    assert body.decode() == INDEX_HTML
    # every path the page calls is served
    calls = set(re.findall(r"[`\"](/runs[^`\"]*)[`\"]", INDEX_HTML))
    assert len(calls) >= 8, calls
    uid = runs["writer"]
    for call in calls:
        path = (call.replace("${encodeURIComponent(uuid)}", uid).replace("${uuid}", uid)
                .replace("${off}", "0"))
        if path.endswith("/stop"):
            continue  # a POST, held below
        if path.endswith("/artifacts/"):
            path += "sub/a.txt"
        assert _call(ours + path)[0] == 200, path


def test_metricsz_serves_the_registry_and_federates(servers, tmp_path):
    ref, ours, _, _ = servers
    (rcode, rtype, _), (code, ctype, body) = _both(servers, "/metricsz")
    assert code == rcode == 200 and ctype == rtype == "text/plain; version=0.0.4"
    down = "http://127.0.0.1:9"
    with BackgroundServer(RunStore(tmp_path), federate={"agent": ours, "gone": down}) as srv:
        code, _, text = _call(f"http://127.0.0.1:{srv.port}/metricsz")
    text = text.decode()
    assert code == 200
    assert 'federation_source_up{source="agent"} 1' in text
    assert 'federation_source_up{source="gone"} 0' in text


def _queue_entries(home):
    lines = (home / "queues" / "default.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines if line.strip()]


def test_post_runs_queues_the_same_entries_and_specs(servers, homes):
    jax_home, torch_home, _, _ = homes
    before = len(_queue_entries(torch_home)), len(_queue_entries(jax_home))
    body = {"operation": SUBMIT, "project": "gamma", "priority": 3}
    (rcode, _, rbody), (code, _, obody) = _both(servers, "/runs", method="POST", body=body)
    assert code == rcode == 201, obody
    assert _mask(obody) == _mask(rbody)
    ours, ref = json.loads(obody)["uuid"], json.loads(rbody)["uuid"]
    q_ours, q_ref = _queue_entries(torch_home), _queue_entries(jax_home)
    assert (len(q_ours), len(q_ref)) == (before[0] + 1, before[1] + 1)
    assert _mask(json.dumps(q_ours[-1]).encode()) == _mask(json.dumps(q_ref[-1]).encode())
    spec_ours = RunStore(torch_home).read_spec(ours)
    spec_ref = JaxRunStore(jax_home).read_spec(ref)
    assert _mask(json.dumps(spec_ours).encode()) == _mask(json.dumps(spec_ref).encode())


@pytest.mark.parametrize("case", ["no-operation", "bad-json", "bad-spec", "unknown-route"])
def test_post_errors_answer_like_the_reference(servers, case):
    path, kw = "/runs", {}
    if case == "no-operation":
        kw["body"] = {"project": "x"}
    elif case == "bad-json":
        kw["raw"] = b"{not json"
    elif case == "bad-spec":
        kw["body"] = {"operation": {"kind": "operation", "component": {"run": {"kind": 7}}}}
    else:
        path, kw["body"] = "/runs/x/y/z", {}
    (rcode, rtype, rbody), (code, ctype, body) = _both(servers, path, method="POST", **kw)
    assert code == rcode, body
    assert ctype == rtype
    if case == "bad-spec":  # the validators word their messages apart
        assert code == 400 and set(json.loads(body)) == set(json.loads(rbody)) == {"error"}
    else:
        assert _mask(body) == _mask(rbody)


def test_stop_and_delete_answer_like_the_reference(servers):
    ref, ours, runs, _ = servers
    for path, method in ((f"/runs/{runs['plain']}/stop", "POST"),
                         ("/runs/nosuchrun/stop", "POST"),
                         (f"/runs/{runs['queued']}", "DELETE"),  # active: 409
                         (f"/runs/{runs['queued']}/stop", "POST"),
                         (f"/runs/{runs['other']}?cascade=true", "DELETE"),
                         (f"/runs/{runs['other']}", "DELETE"),  # gone: 404
                         ("/runs/x/y", "DELETE")):
        (rcode, _, rbody), (code, _, body) = _both(servers, path, method=method,
                                                   body={} if method == "POST" else None)
        assert code == rcode, (path, body)
        assert _mask(body) == _mask(rbody), path
