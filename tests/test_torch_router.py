"""The port's serving fleet (`serving/router.py`, `serving/replicas.py`,
`serving/affinity.py`) against the JAX package's, on the CPU.

- balancing: the seeded P2C order, and the router's candidate order (the
  prefill pool first, affinity to the longest advertised prefix unless its
  holder is overloaded), equal the reference's for the same replica states;
- affinity: `PrefixDirectory.match` answers the reference's matches for the
  same advertisements (heads from the port's `page_hashes` and the
  reference's are the same digests);
- failover: a replica that dies mid-stream is replayed on its sibling and
  the tokens it already sent are trimmed, frame for frame as the reference
  router relays them (scripted upstreams); a row error frame fails over;
- a live fleet (`ReplicaSetManager` over two `InProcessReplica`s behind the
  `Router`): its answers equal a direct server's, streamed and not; a
  decode worker killed mid-stream fails over with the same tokens; a killed
  replica restarts in its slot; `rolling_redeploy` replaces every replica
  with no failed request; the federated `/metricsz` and the `/statsz`
  rollups count the fleet; `/tracez` stitches the replica's spans.

Exact comparisons throughout (orders, frames, greedy f32 tokens)."""

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from polyaxon_tpu.serving import affinity as jaff
from polyaxon_tpu.serving import router as jrouter
from polyaxon_tpu_torch.chaos import Fault, FaultPlan, active
from polyaxon_tpu_torch.models.kv_pages import page_hashes
from polyaxon_tpu_torch.retry import RetryPolicy
from polyaxon_tpu_torch.serving import affinity as taff
from polyaxon_tpu_torch.serving import router as trouter
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.replicas import InProcessReplica, ReplicaSetManager
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.telemetry.federate import parse_prometheus_text
from tests.test_torch_transformer import jax_lm, torch_lm

pytestmark = pytest.mark.serving


# ------------------------------------------------------------ balancing
STATES = [  # (depth, queue wait ms, inflight, role)
    [(0, 0, 0, "both"), (3, 5, 1, "both"), (1, 50, 0, "both"), (2, 1, 2, "both")],
    [(4, 0, 0, "both"), (4, 0, 0, "both"), (0, 9, 3, "both")],
    [(1, 0, 0, "prefill"), (0, 0, 0, "decode"), (2, 0, 0, "prefill"), (5, 0, 0, "both")],
]


def _states(mod, spec):
    out = []
    for i, (depth, wait, inflight, role) in enumerate(spec):
        s = mod.ReplicaState(url=f"http://h/r{i}", slug=f"r{i}", healthy=True)
        s.queue_depth, s.queue_wait_ms, s.inflight, s.role = depth, wait, inflight, role
        out.append(s)
    return out


@pytest.mark.parametrize("spec", range(len(STATES)))
def test_seeded_p2c_order_equals_the_reference(spec):
    got = []
    for mod in (trouter, jrouter):
        bal = mod.P2CBalancer(seed=11)
        states = _states(mod, STATES[spec])
        got.append([[s.slug for s in bal.order(states)] for _ in range(12)])
    assert got[0] == got[1]


def _router_order(mod, spec, heads_for, tokens, **kw):
    r = mod.Router([], balancer=mod.P2CBalancer(seed=5), **kw)
    r._states = _states(mod, spec)
    for slug, heads in heads_for.items():
        r.directory.update(slug, 8, heads)
    body = json.dumps({"tokens": [tokens]}).encode()
    return [s.slug for s in r._order(body)], r.stats()["affinity"]


@pytest.mark.parametrize("case", ["prefill-first", "affinity", "overloaded", "no-match"])
def test_router_candidate_order_equals_the_reference(case):
    prompt = list(range(1, 42))
    chain = page_hashes(prompt[:40], 8)
    spec, heads, kw = STATES[0], {}, {}
    if case == "prefill-first":
        spec = STATES[2]
    elif case == "affinity":
        heads = {"r3": chain[:2], "r1": chain[:4]}
    elif case == "overloaded":
        heads = {"r1": chain}
        kw = {"affinity_imbalance": 1.0}
    else:
        heads = {"r2": page_hashes(list(range(100, 140)), 8)}
    ours = _router_order(trouter, spec, heads, prompt, **kw)
    ref = _router_order(jrouter, spec, heads, prompt, **kw)
    assert ours == ref
    if case == "affinity":
        assert ours[0][0] == "r1"  # the longest advertised prefix


def test_prefix_directory_matches_the_reference():
    prompts = [list(range(1, 34)), list(range(1, 17)) + [99] * 16, [7] * 40, [1]]
    ours, ref = taff.PrefixDirectory(max_prompt_pages=3), jaff.PrefixDirectory(max_prompt_pages=3)
    for d in (ours, ref):
        d.update("r0", 8, page_hashes(prompts[0], 8)[:2])
        d.update("r1", 8, page_hashes(prompts[0], 8))
        d.update("r2", 16, page_hashes(prompts[2], 16))
        d.update("r3", 8, [])  # an empty advertisement clears the slug
    for p in prompts:
        assert ours.match(p) == ref.match(p)
    assert ours.match(prompts[0]) == {"r0": 2, "r1": 3}
    assert ours.stats() == ref.stats()
    # the port's digests are the reference's
    from polyaxon_tpu.models.kv_pages import page_hashes as jpage_hashes

    assert page_hashes(prompts[0], 8) == jpage_hashes(prompts[0], 8)


# ------------------------------------------------ scripted failover
def _upstream(events, terminal=True):
    """A replica look-alike: ready, an empty /metricsz, and an SSE
    /generate that sends `events` (and the terminal frame)."""

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            data = (b"serving_queue_depth 0\n" if self.path.startswith("/metricsz")
                    else json.dumps({"ready": True, "reason": "ok"}).encode())
            self.send_response(200 if not self.path.startswith("/kvz") else 404)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Connection", "close")
            self.end_headers()
            for ev in events + ([{"done": True}] if terminal else []):
                self.wfile.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
                self.wfile.flush()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _fixed(mod, urls):
    class Fixed(mod.P2CBalancer):
        def order(self, candidates):
            return sorted(candidates, key=lambda s: urls.index(s.url))
    return Fixed()


def _relay(mod, first, second):
    a, aurl = _upstream(*first)
    b, burl = _upstream(*second)
    try:
        r = mod.Router([aurl, burl], balancer=_fixed(mod, [aurl, burl]))
        r.poll_once()
        frames = [json.loads(f.decode().strip()[6:]) for f in r.forward_stream(b"{}", "rid")]
        return frames, r.stats()["retries"]
    finally:
        a.shutdown()
        b.shutdown()


@pytest.mark.parametrize("case", ["dies-mid-stream", "row-error"])
def test_midstream_failover_trims_like_the_reference(case):
    full = ([{"row": 0, "tokens": [1, 2]}, {"row": 0, "tokens": [3, 4]},
             {"row": 0, "tokens": [5]}, {"row": 0, "done": True}],)
    if case == "dies-mid-stream":
        # dies after [1, 2], [3] with no terminal frame
        first = ([{"row": 0, "tokens": [1, 2]}, {"row": 0, "tokens": [3]}], False)
    else:
        first = ([{"row": 0, "tokens": [1]}, {"row": 0, "error": "decode worker crashed"}],)
    ours = _relay(trouter, first, full)
    assert ours == _relay(jrouter, first, full)
    frames, retries = ours
    toks = [t for f in frames if f.get("row") == 0 for t in f.get("tokens", [])]
    assert toks == [1, 2, 3, 4, 5] and retries == 1
    assert not any("error" in f for f in frames) and frames[-1] == {"done": True}


# ------------------------------------------------------------ live fleet
CFG = {"max_batch": 4, "max_wait_ms": 5.0, "kv_pool_pages": 64, "kv_page_tokens": 8,
       "stream_chunk_tokens": 2}


def _post(url, body, path="/generate", rid=None, timeout=120):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json",
                                          **({"X-Request-Id": rid} if rid else {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.read()


def _tokens(raw):
    rows: dict = {}
    for line in raw.decode().splitlines():
        if line.startswith("data: "):
            ev = json.loads(line[6:])
            assert "error" not in ev, ev
            rows.setdefault(ev.get("row"), []).extend(ev.get("tokens", []))
    return rows


@pytest.fixture(scope="module")
def fleet():
    module, params = jax_lm({"attention": "xla"})
    model = torch_lm(module, params)

    def server():
        return ModelServer(model, None, ServingConfig(**CFG), model_name="small", device="cpu")

    mgr = ReplicaSetManager(lambda i: InProcessReplica(server), replicas=2,
                            retry=RetryPolicy(max_retries=3, backoff=0.05),
                            monitor_interval_s=0.1)
    router = trouter.Router(mgr.endpoints, balancer=trouter.P2CBalancer(seed=7),
                            poll_interval_s=0.2)
    mgr.attach_router(router)
    mgr.start()
    url = f"http://127.0.0.1:{router.start('127.0.0.1', 0)}"
    direct = server()
    durl = f"http://127.0.0.1:{direct.start('127.0.0.1', 0)}"
    router.poll_once()
    try:
        yield {"mgr": mgr, "router": router, "url": url, "direct": direct, "durl": durl}
    finally:
        router.stop()
        mgr.stop()
        direct.stop()


def _bodies():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 255, 12).tolist() for _ in range(2)]
    return ({"tokens": prompts, "maxNewTokens": 8},
            {"tokens": prompts, "maxNewTokens": 8, "temperature": 0.8, "topK": 40,
             "seed": 123})


def test_fleet_answers_equal_a_direct_server(fleet):
    for i, body in enumerate(_bodies()):
        c1, o1 = _post(fleet["durl"], body, rid=f"rid-{i}")
        c2, o2 = _post(fleet["url"], body, rid=f"rid-{i}")
        assert c1 == c2 == 200
        assert o1 == o2  # the payload bytes, relayed verbatim
        s1, f1 = _post(fleet["durl"], body, path="/generate?stream=1", rid=f"rs-{i}")
        s2, f2 = _post(fleet["url"], body, path="/generate?stream=1", rid=f"rs-{i}")
        assert s1 == s2 == 200 and f1 == f2
        whole = json.loads(o1)["tokens"]
        assert {k: v for k, v in _tokens(f2).items() if k is not None} == {
            r: row[len(body["tokens"][r]):] for r, row in enumerate(whole)}


def test_worker_killed_midstream_fails_over(fleet):
    _, sampled = _bodies()
    code, want = _post(fleet["durl"], sampled, path="/generate?stream=1")
    assert code == 200
    retries0 = fleet["router"].stats()["retries"]
    with active(FaultPlan([Fault("serving.worker", "kill", at=0)])):
        code, got = _post(fleet["url"], sampled, path="/generate?stream=1", rid="rid-kill")
    assert code == 200
    assert _tokens(got) == _tokens(want)
    assert fleet["router"].stats()["retries"] >= retries0 + 1


def test_killed_replica_restarts_in_its_slot(fleet):
    mgr, router = fleet["mgr"], fleet["router"]
    before = mgr.endpoints()
    restarts0 = int(mgr._m_restarts.value)
    mgr.replica(0).kill()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and mgr.live() < 2:
        time.sleep(0.05)
    assert mgr.live() == 2 and int(mgr._m_restarts.value) == restarts0 + 1
    after = mgr.endpoints()
    assert after[1] == before[1]  # the sibling never moved
    router.poll_once()
    assert [s.slug for s in router.states()] == ["r0", "r1"]
    assert all(s.routable for s in router.states())


def test_rolling_redeploy_fails_no_request(fleet):
    mgr, results, errors = fleet["mgr"], [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                results.append(_post(fleet["url"], {"tokens": [[5, 6, 7]], "maxNewTokens": 2})[0])
            except Exception as e:  # noqa: BLE001 — any failure is the bug
                errors.append(repr(e))

    t = threading.Thread(target=client)
    t.start()
    try:
        before = set(mgr.endpoints())
        mgr.rolling_redeploy()
        after = set(mgr.endpoints())
    finally:
        stop.set()
        t.join(60)
    assert not errors and results and set(results) == {200}, (errors[:3], results[:5])
    assert before.isdisjoint(after)
    fleet["router"].poll_once()
    assert fleet["router"].readiness() == (True, "ok")


def test_federated_metricsz_statsz_and_stitched_tracez(fleet):
    code, _ = _post(fleet["url"], {"tokens": [[5, 6, 7]], "maxNewTokens": 2}, rid="rid-fed")
    assert code == 200
    fleet["router"].poll_once()
    snap = parse_prometheus_text(_get(fleet["url"], "/metricsz").decode())
    for slug in ("r0", "r1"):
        assert snap.get("federation_source_up", replica=slug) == 1.0
        assert snap.get("serving_requests_total", replica=slug) is not None
    per = sum(snap.get("serving_requests_total", replica=s) for s in ("r0", "r1"))
    assert snap.get("cluster:serving_requests_total:sum") == per >= 1.0
    assert snap.get("cluster:serving_queue_depth:max") is not None
    assert snap.get("cluster:serving_requests_total:max") is None
    assert snap.get("router_requests_total") is not None
    st = json.loads(_get(fleet["url"], "/statsz"))
    assert st["role"] == "router" and st["routable"] == 2
    assert st["cluster"]["federation"] is True and st["cluster"]["scraped"] == 2
    assert st["cluster"]["serving_requests"] == per
    t = json.loads(_get(fleet["url"], "/tracez?id=rid-fed"))
    names = {s["name"] for s in t["spans"]}
    assert {"balance", "upstream_attempt", "queue_wait", "prefill"} <= names
    assert t["attrs"]["stitched"] >= 1
    assert any(s["attrs"].get("remote") for s in t["spans"])


def test_fleet_placement_is_refused_by_name(tmp_path):
    """`fleet=`: each slot holds a reservation of `chips_per_replica` chips
    under queue `serving` while it runs, as the reference's slots do, and
    gives it back when it is drained or stopped."""
    from polyaxon_tpu.scheduler.fleet import Fleet as JaxFleet
    from polyaxon_tpu.store.local import RunStore as JaxRunStore
    from polyaxon_tpu_torch.scheduler.fleet import Fleet
    from polyaxon_tpu_torch.store import RunStore

    class Stub:
        def __init__(self, i):
            self.i, self.up = i, False

        def start(self):
            self.up = True
            return f"http://stub-{self.i}"

        def alive(self):
            return self.up

        def stop(self, drain_grace_s=None):
            self.up = False

    fleet = Fleet(RunStore(tmp_path))
    fleet.configure(chips=4)
    mgr = ReplicaSetManager(Stub, replicas=2, fleet=fleet, chips_per_replica=2, name="svc")
    mgr.start()
    try:
        recs = JaxFleet(JaxRunStore(tmp_path)).ledger.all()  # the reference reads them
        assert {u: (r["chips"], r["queue"]) for u, r in recs.items()} == {
            "svc-r0": (2, "serving"), "svc-r1": (2, "serving")}
        with pytest.raises(RuntimeError, match="no capacity for replica 2"):
            mgr._launch(2)
        mgr.scale_to(1)  # the drained slot gives its chips back
        assert list(fleet.ledger.all()) == ["svc-r0"]
    finally:
        mgr.stop()
    assert fleet.reserved_chips() == 0


# ----------------------------------------- affinity in adapter namespaces
def test_tenants_route_to_their_own_namespace_heads():
    """Two tenants on different adapters send one prompt through the
    router: each goes to the replica holding the prompt's heads in its
    adapter's namespace (the replicas advertise their tenant → namespace
    map on /kvz). A base-model row hashes as the reference's directory
    does."""
    from polyaxon_tpu_torch.models import build_model
    from polyaxon_tpu_torch.serving.tenancy import normalize_adapters, normalize_tenants

    lora = build_model("transformer_lm", dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                              vocab_size=128, seq_len=64, lora_rank=4),
                       device="cpu").module.eval()
    cfg = ServingConfig(
        max_batch=2, max_wait_ms=1.0, kv_pool_pages=32, kv_page_tokens=8,
        adapters=normalize_adapters({"a1": "seed:1", "a2": "seed:2"}),
        tenants=normalize_tenants([{"name": "t1", "adapter": "a1"},
                                   {"name": "t2", "adapter": "a2"}]))
    servers = [ModelServer(lora, None, cfg, device="cpu") for _ in range(2)]
    urls = [f"http://127.0.0.1:{s.start('127.0.0.1', 0)}" for s in servers]
    router = trouter.Router(urls, balancer=trouter.P2CBalancer(seed=3))
    prompt = np.random.default_rng(5).integers(1, 127, 33).tolist()
    body = {"tokens": [prompt], "maxNewTokens": 2}
    try:
        # t1 warms r0 and t2 warms r1: the same tokens, chained in a1 and a2
        for url, tenant in zip(urls, ("t1", "t2")):
            assert _post(url, {**body, "tenant": tenant})[0] == 200
        router.poll_once()
        kvz = json.loads(_get(urls[0], "/kvz"))
        assert kvz["namespaces"] == {"t1": "a1", "t2": "a2"}
        assert router.directory.match(prompt, "t1") == {"r0": 4}
        assert router.directory.match(prompt, "t2") == {"r1": 4}
        assert router.directory.match(prompt) == {}  # no base-namespace heads
        url = f"http://127.0.0.1:{router.start('127.0.0.1', 0)}"
        for tenant, slot in (("t1", 0), ("t2", 1), ("t2", 1), ("t1", 0)):
            served = [s.requests_served for s in servers]
            if tenant == "t1":  # by header, as a proxy forwards it
                req = urllib.request.Request(
                    url + "/generate", data=json.dumps(body).encode(), method="POST",
                    headers={"Content-Type": "application/json", "X-Tenant": tenant})
                with urllib.request.urlopen(req, timeout=120) as r:
                    assert r.status == 200
            else:  # in the body
                assert _post(url, {**body, "tenant": tenant})[0] == 200
            assert [s.requests_served - n for s, n in zip(servers, served)] == [
                int(slot == 0), int(slot == 1)]
        assert router.stats()["affinity"]["hits"] == 4
        # a base-model row: the same chain as the reference's directory
        assert _post(urls[1], body)[0] == 200
        router.poll_once()
        heads = [json.loads(_get(u, "/kvz"))["heads"] for u in urls]
        ref = jaff.PrefixDirectory()
        for i, h in enumerate(heads):
            ref.update(f"r{i}", 8, h)
        assert router.directory.match(prompt) == ref.match(prompt) == {"r1": 4}
        assert router.directory.match(prompt, "t1") == {"r0": 4}
    finally:
        router.stop()
        for s in servers:
            s.stop()
