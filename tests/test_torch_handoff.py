"""The port's disaggregated prefill→decode KV handoff (`serving/handoff.py`,
`KVCacheManager.export_prefix`/`adopt_pages`, `POST /kv_import`, `role`)
against the JAX package, on the CPU in f32.

- `FaultPlan.kv_handoff_crash`: the reference's point, hit and params
  for the same seed and window;
- lease units: the same call scripts on the port's and the reference's
  `LeaseTable` give the same outcomes and stats (monotonic epochs,
  preemption, release, the id bound);
- the wire: for the same pages (f32, bf16 and an int8 pool's payloads and
  scales) the port's bytes equal the reference's, and each package reads
  the other's wire back to the same pages; torn and corrupt bytes are
  refused whole; an adapter's payload carries its namespace;
- `HandoffClient` against one scripted upstream: the same attempts, epochs
  and reasons as the reference's client;
- live rigs: the port's router over a prefill and a decode replica (and a
  monolithic `direct` replica) answers the greedy tokens of the JAX
  package's router over its own two pools (tests/test_handoff.py's rig),
  streamed and not, with speculation on both sides, through real handoffs
  whose replays are admitted on the adopted chain (a mis-hashed adopt
  answers the same tokens and shows only as the replay's miss);
- a fault at each chaos point (`serving.kv_export`, `serving.kv_import`,
  `serving.kv_adopt`) falls back to local decode with the direct tokens,
  one counted fallback and zero leaked pages on either replica;
- a stale epoch gets 409, torn bytes 400;
- an adapter row handed off lands in its adapter's prefix namespace on the
  decode replica (not in the base chain) and answers the tokens of a solo
  server holding only that adapter.

Tokens are compared exactly (greedy f32 on the CPU); pages bit for bit."""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import ml_dtypes
import numpy as np
import pytest
import torch

from polyaxon_tpu.serving import handoff as jh
from polyaxon_tpu.serving.spill import SpillPayload as JPayload
from polyaxon_tpu_torch.chaos import Fault, FaultPlan, active
from polyaxon_tpu_torch.serving import handoff as th
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.router import P2CBalancer, Router, parse_prometheus
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.serving.spill import SpillPayload
from polyaxon_tpu_torch.serving.tenancy import normalize_adapters, normalize_tenants
from tests.test_torch_transformer import jax_lm, torch_lm

pytestmark = pytest.mark.serving


# ------------------------------------------------------------ lease units
LEASE_SCRIPTS = {
    "monotonic": [("acquire", "r1", 5), ("complete", 0), ("acquire", "r1", 5),
                  ("acquire", "r1", 4), ("acquire", "r1", 6), ("complete", 3)],
    "preempt": [("acquire", "r2", 1), ("acquire", "r2", 2), ("complete", 0),
                ("complete", 1), ("acquire", "r2", 2)],
    "release": [("acquire", "r3", 1), ("release", 0), ("acquire", "r3", 1),
                ("acquire", "r3", 2), ("complete", 2)],
    "bound": [("acquire", f"id{i}", 1) for i in range(5)] + [("acquire", "id0", 1)],
}


def _run_leases(mod, script):
    t = mod.LeaseTable(max_ids=4)
    leases, out = [], []
    for op in script:
        if op[0] == "acquire":
            try:
                leases.append(t.acquire(op[1], op[2]))
                out.append(("granted", leases[-1].epoch))
            except mod.StaleLeaseError:
                leases.append(None)
                out.append("stale")
        elif op[0] == "complete":
            out.append(t.complete(leases[op[1]]))
        else:
            t.release(leases[op[1]])
            out.append(t.active)
    return out, t.stats(), [(x.rid, x.epoch, x.state) for x in leases if x is not None]


@pytest.mark.parametrize("name", list(LEASE_SCRIPTS))
def test_lease_table_matches_reference(name):
    assert _run_leases(th, LEASE_SCRIPTS[name]) == _run_leases(jh, LEASE_SCRIPTS[name])


@pytest.mark.parametrize("seed", [0, 3, 5, 11])
@pytest.mark.parametrize("window", [1, 4])
def test_kv_handoff_crash_plan_matches_reference(seed, window):
    from polyaxon_tpu.chaos.plan import FaultPlan as JPlan

    ours, ref = FaultPlan.kv_handoff_crash(seed, window), JPlan.kv_handoff_crash(seed, window)
    assert ours.params == ref.params
    assert [vars(f) for f in ours.faults] == [vars(f) for f in ref.faults]


# ---------------------------------------------------------------- wire
def _pages(kind, n_pages=3, seed=0):
    """(numpy pages for the reference, torch pages for the port): the same
    values, in the pool's leaf order — k, v (f32, bf16) or k, k scale, v,
    v scale (the int8 pool)."""
    rng = np.random.default_rng(seed)
    np_pages, t_pages = [], []
    for _ in range(n_pages):
        np_page, t_page = [], []
        if kind == "int8":
            for _leaf in range(2):
                q = rng.integers(-127, 128, (8, 2, 16)).astype(np.int8)
                sc = rng.random((8, 2)).astype(np.float32)
                np_page += [q, sc]
                t_page += [torch.from_numpy(q.copy()), torch.from_numpy(sc.copy())]
        else:
            for _leaf in range(2):
                a = rng.standard_normal((8, 2, 16)).astype(np.float32)
                if kind == "bf16":
                    b = a.astype(ml_dtypes.bfloat16)
                    np_page.append(b)
                    t_page.append(torch.from_numpy(b.view(np.uint16).copy()).view(torch.bfloat16))
                else:
                    np_page.append(a)
                    t_page.append(torch.from_numpy(a.copy()))
        np_pages.append(np_page)
        t_pages.append(t_page)
    return np_pages, t_pages


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_wire_bytes_equal_the_reference(kind):
    np_pages, t_pages = _pages(kind)
    tokens = tuple(range(24))
    hashes = ("a0", "a1", "a2")
    ours = th.payload_to_wire(SpillPayload(tokens, hashes, t_pages))
    ref = jh.payload_to_wire(JPayload(tokens, hashes, np_pages))
    assert ours == ref
    # each package reads the other's wire to the same pages
    back = th.payload_from_wire(ref)
    assert back.tokens == tokens and back.hashes == hashes and back.namespace == ""
    jback = jh.payload_from_wire(ours)
    for a_np, a_t, b_t, b_np in zip(np_pages, t_pages, back.pages, jback.pages):
        for x, y, z, w in zip(a_np, a_t, b_t, b_np):
            assert z.dtype == y.dtype and tuple(z.shape) == x.shape
            assert _as_numpy(z).tobytes() == x.tobytes() == w.tobytes()


def test_wire_namespace_and_damage():
    _, t_pages = _pages("f32", n_pages=2)
    payload = SpillPayload(tuple(range(16)), ("h0", "h1"), t_pages, namespace="acme")
    data = th.payload_to_wire(payload)
    assert th.payload_from_wire(data).namespace == "acme"
    # the reference's parser ignores the extra meta key and reads the pages
    assert len(jh.payload_from_wire(data).pages) == 2
    for mod in (th, jh):
        with pytest.raises(mod.HandoffError, match="torn"):
            mod.payload_from_wire(data[:-7])
        flipped = bytearray(data)
        flipped[len(data) // 2] ^= 0xFF
        with pytest.raises(mod.HandoffError):
            mod.payload_from_wire(bytes(flipped))


# ------------------------------------------------------- scripted client
class _Scripted(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        srv = self.server
        code, body = srv.script[min(srv.calls, len(srv.script) - 1)]
        srv.calls += 1
        srv.epochs.append(int(self.headers["X-Handoff-Epoch"]))
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


def _client_run(mod, script):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Scripted)
    httpd.script, httpd.calls, httpd.epochs = script, 0, []
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        client = mod.HandoffClient(retry=mod.RetryPolicy(max_retries=2, backoff=0.0))
        res = client.send(f"http://127.0.0.1:{httpd.server_address[1]}", "rid", b"x",
                          base_epoch=3)
    finally:
        httpd.shutdown()
        httpd.server_close()
    return (res.ok, res.adopted_pages, res.epoch, res.attempts, res.reason), httpd.epochs


@pytest.mark.parametrize("script", [
    [(502, {}), (200, {"adopted_pages": 4})],
    [(409, {"reason": "stale_epoch"})],
    [(503, {"reason": "kv_handoff"})],
    [(400, {})],
    [(502, {})],
], ids=["retry-then-adopt", "stale", "shed", "rejected", "exhausted"])
def test_handoff_client_matches_reference(script):
    assert _client_run(th, script) == _client_run(jh, script)


# ------------------------------------------------------------ live rigs
POOL = {"max_batch": 4, "max_wait_ms": 2.0, "kv_page_tokens": 8, "kv_pool_pages": 64,
        "stream_chunk_tokens": 3, "chunked_prefill": True, "prefix_cache": True,
        "speculate": True, "draft_tokens": 3}
NEW = 8


def _post(url, body, path="/generate", rid=None, timeout=120):
    host, port = url.rsplit("/", 1)[-1].split(":")
    c = http.client.HTTPConnection(host, int(port), timeout=timeout)
    headers = {"Content-Type": "application/json"}
    if rid is not None:
        headers["X-Request-Id"] = rid
    c.request("POST", path, json.dumps(body), headers)
    r = c.getresponse()
    out = r.read()
    c.close()
    return r.status, out


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.read()


def _stream_tokens(raw: bytes) -> dict:
    rows: dict = {}
    for line in raw.decode().splitlines():
        if line.startswith("data: "):
            ev = json.loads(line[6:])
            assert "error" not in ev, ev
            if "tokens" in ev and "row" in ev:
                rows.setdefault(ev["row"], []).extend(ev["tokens"])
    return rows


def _router(router_cls, balancer, urls):
    router = router_cls(urls, balancer=balancer, poll_interval_s=0.1)
    url = f"http://127.0.0.1:{router.start('127.0.0.1', 0)}"
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        router.poll_once()
        reps = router.stats()["replicas"]
        if len(reps) == len(urls) and all(r["healthy"] for r in reps):
            break
        time.sleep(0.05)
    return router, url


def _port_server(model, **extra):
    server = ModelServer(model, None, ServingConfig(**{**POOL, **extra}),
                         model_name="small", device="cpu")
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


def drained(url, budget_s=15.0):
    """Zero leak: pages used back to the scratch page plus the prefix
    cache's held pages, no export in flight (polled: fallbacks finish
    asynchronously)."""
    deadline = time.monotonic() + budget_s
    last = {}
    while time.monotonic() < deadline:
        last = parse_prometheus(_get(url, "/metricsz").decode())
        if (last.get("serving_kv_pages_used", 0.0)
                <= 1 + last.get("serving_kv_pages_prefix_held", 0.0)
                and last.get("serving_kv_handoff_inflight", 0.0) == 0):
            return True
        time.sleep(0.05)
    raise AssertionError(f"pages leaked or an export stuck: {last}")


def _prompt(seed, n=21):
    return np.random.default_rng(seed).integers(1, 255, n).tolist()


def _replay_hit(url, rid):
    """From the port router's stitched /tracez of `rid`: the pages the
    prefill replica (r0) exported, and the decode replica's (r1) kv_plan
    on the replay — whether its admission hit the prefix cache, and for
    how many tokens. The router records a trace a beat after it answers,
    so a 404 is asked again for a few seconds."""
    deadline = time.monotonic() + 10.0
    while True:
        try:
            t = json.loads(_get(url, f"/tracez?id={rid}"))
            break
        except urllib.error.HTTPError as e:
            if e.code != 404 or time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    export = [s for s in t["spans"] if s["name"] == "kv_export"
              and s["attrs"].get("replica") == "r0"]
    plan = [s for s in t["spans"] if s["name"] == "kv_plan"
            and s["attrs"].get("replica") == "r1"]
    assert len(export) == 1 and len(plan) == 1, [s["name"] for s in t["spans"]]
    return (export[0]["attrs"]["pages"], plan[0]["attrs"]["prefix_hit"],
            plan[0]["attrs"]["prefix_len"])


@pytest.fixture(scope="module")
def rigs():
    from polyaxon_tpu.serving.batching import ServingConfig as JConfig
    from polyaxon_tpu.serving.router import P2CBalancer as JBalancer
    from polyaxon_tpu.serving.router import Router as JRouter
    from polyaxon_tpu.serving.server import ModelServer as JServer

    module, params = jax_lm({"attention": "xla"})
    model = torch_lm(module, params)
    pre, pre_url = _port_server(model, role="prefill")
    dec, dec_url = _port_server(model, role="decode")
    direct, direct_url = _port_server(model)
    router, url = _router(Router, P2CBalancer(seed=7), [pre_url, dec_url])
    jservers = [JServer(module, params, model_name="small",
                        config=JConfig(**{**POOL, "role": role}))
                for role in ("prefill", "decode")]
    jurls = [f"http://127.0.0.1:{s.start(port=0)}" for s in jservers]
    jrouter, jurl = _router(JRouter, JBalancer(seed=7), jurls)
    rig = {"pre": pre, "dec": dec, "direct": direct, "router": router, "url": url,
           "pre_url": pre_url, "dec_url": dec_url, "direct_url": direct_url,
           "jurl": jurl, "model": model}
    try:
        yield rig
    finally:
        for s in (router, jrouter, pre, dec, direct, *jservers):
            s.stop()


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "streamed"])
def test_pooled_greedy_matches_the_jax_pools(rigs, stream):
    exports0 = rigs["pre"].stats()["handoff"]["exports"]
    imports0 = rigs["dec"].stats()["handoff"]["imports"]
    path = "/generate?stream=1" if stream else "/generate"
    for i, seed in enumerate((1, 2)):
        body = {"tokens": [_prompt(seed + 10 * stream)], "maxNewTokens": NEW}
        rid = f"rid-{'s' if stream else 'w'}{i}"
        code, direct = _post(rigs["direct_url"], body)
        assert code == 200
        want = json.loads(direct)["tokens"][0]
        got = []
        for url in (rigs["url"], rigs["jurl"]):
            code, out = _post(url, body, path=path, rid=rid)
            assert code == 200, out
            if stream:
                # the first token from the prefill replica, the rest from
                # the decode replica mid-flight, trimmed to the suffix
                got.append(body["tokens"][0] + _stream_tokens(out)[0])
            else:
                got.append(json.loads(out)["tokens"][0])
        assert got[0] == got[1] == want
        # the replay was admitted onto the adopted chain, not re-prefilled:
        # 21 tokens export 2 pages, and admission caps its hit at 20 tokens
        assert _replay_hit(rigs["url"], rid) == (2, True, 2 * POOL["kv_page_tokens"])
    # the identity rode real handoffs, not a silent fallback
    h = rigs["pre"].stats()["handoff"]
    assert h["exports"] == exports0 + 2 and h["fallbacks"] == 0, h
    assert rigs["dec"].stats()["handoff"]["imports"] == imports0 + 2
    drained(rigs["pre_url"])
    drained(rigs["dec_url"])
    assert rigs["dec"].stats()["handoff"]["leases"]["active"] == 0


def test_roles_on_every_surface(rigs):
    for url, role in ((rigs["pre_url"], "prefill"), (rigs["dec_url"], "decode"),
                      (rigs["direct_url"], "both")):
        assert json.loads(_get(url, "/readyz"))["role"] == role
        assert json.loads(_get(url, "/kvz"))["role"] == role
        assert json.loads(_get(url, "/statsz"))["handoff"]["role"] == role
    st = json.loads(_get(rigs["url"], "/statsz"))
    assert {r["replica_role"] for r in st["replicas"]} == {"prefill", "decode"}
    assert "serving_kv_handoff_exports_total" in _get(rigs["pre_url"], "/metricsz").decode()


@pytest.mark.chaos
@pytest.mark.parametrize("point", ["serving.kv_export", "serving.kv_import",
                                   "serving.kv_adopt"])
def test_chaos_point_falls_back_clean(rigs, point):
    body = {"tokens": [_prompt(50 + len(point))], "maxNewTokens": 6}
    code, direct = _post(rigs["direct_url"], body)
    assert code == 200
    fb0 = rigs["pre"].stats()["handoff"]["fallbacks"]
    plan = FaultPlan([Fault(point, "raise", at=0)], seed=3)
    with active(plan):
        code, out = _post(rigs["url"], body, rid=f"rid-chaos-{point}")
    # the client never sees the fault: the local fallback's tokens
    assert code == 200, out
    assert json.loads(out)["tokens"] == json.loads(direct)["tokens"]
    assert plan.faults[0].fired == 1
    assert rigs["pre"].stats()["handoff"]["fallbacks"] == fb0 + 1
    drained(rigs["pre_url"])
    drained(rigs["dec_url"])
    assert rigs["dec"].stats()["handoff"]["leases"]["active"] == 0


def test_a_mis_hashed_adopt_misses_on_the_replay(rigs, monkeypatch):
    """An adopt that indexes the chain where the replay does not look (here:
    under another namespace) still answers the right tokens — the decode
    replica re-prefills the whole prompt — and every lease completes; only
    the replay's kv_plan shows that the handoff was useless."""
    kv = rigs["dec"]._kv
    adopt = kv.adopt_pages

    def mis_hashed(payload):
        payload.namespace = "elsewhere"
        return adopt(payload)

    monkeypatch.setattr(kv, "adopt_pages", mis_hashed)
    body = {"tokens": [_prompt(77)], "maxNewTokens": NEW}
    code, direct = _post(rigs["direct_url"], body)
    assert code == 200
    code, out = _post(rigs["url"], body, rid="rid-mis-hashed")
    assert code == 200 and json.loads(out)["tokens"] == json.loads(direct)["tokens"]
    assert _replay_hit(rigs["url"], "rid-mis-hashed") == (2, False, 0)
    monkeypatch.undo()
    drained(rigs["pre_url"])
    drained(rigs["dec_url"])
    assert rigs["dec"].stats()["handoff"]["leases"]["active"] == 0


def test_stale_epoch_gets_409_and_torn_bytes_400(rigs):
    prompt = _prompt(4, n=16)
    code, _ = _post(rigs["pre_url"], {"tokens": [prompt], "maxNewTokens": 4})
    assert code == 200
    payload = rigs["pre"]._kv.export_prefix(prompt)
    data = th.payload_to_wire(payload)
    host, port = rigs["dec_url"].rsplit(":", 1)

    def imp(epoch, blob=data, rid="rid-stale"):
        c = http.client.HTTPConnection("127.0.0.1", int(port), timeout=60)
        c.request("POST", "/kv_import", blob, {
            "Content-Type": "application/octet-stream",
            "X-Handoff-Id": rid, "X-Handoff-Epoch": str(epoch)})
        r = c.getresponse()
        out = json.loads(r.read())
        c.close()
        return r.status, out

    stale0 = rigs["dec"].stats()["handoff"]["leases"]["stale_rejections"]
    code, out = imp(100)
    assert code == 200 and out["adopted_pages"] == 2
    for stale in (100, 99):
        code, out = imp(stale)
        assert code == 409 and out["reason"] == "stale_epoch", out
    code, out = imp(101)  # a higher epoch is honoured, and idempotent
    assert code == 200 and out["adopted_pages"] == 0
    assert rigs["dec"].stats()["handoff"]["leases"]["stale_rejections"] == stale0 + 2
    code, out = imp(1, blob=data[:-9], rid="rid-torn")
    assert code == 400 and out["reason"] == "rejected"
    drained(rigs["dec_url"])


ADAPTERS = {"acme": "seed:1"}


def test_adapter_row_lands_in_its_namespace():
    """An adapter row's pages travel in its adapter's namespace: on the
    decode replica they sit in that chain and not in the base one, and the
    routed row answers a solo server's tokens (holding only that adapter)."""
    module, params = jax_lm({"attention": "xla", "lora_rank": 4})
    model = torch_lm(module, params)
    tenancy = {"adapters": normalize_adapters(ADAPTERS),
               "tenants": normalize_tenants([{"name": "acme", "adapter": "acme"}])}
    servers = [_port_server(model, **tenancy, role=role) for role in ("prefill", "decode")]
    (pre, pre_url), (dec, dec_url) = servers
    solo, solo_url = _port_server(model, **tenancy)
    router, url = _router(Router, P2CBalancer(seed=3), [pre_url, dec_url])
    try:
        prompt = _prompt(9, n=20)
        body = {"tokens": [prompt], "maxNewTokens": 6, "tenant": "acme"}
        code, out = _post(url, body, rid="rid-acme")
        assert code == 200, out
        code, want = _post(solo_url, body)
        assert json.loads(out)["tokens"] == json.loads(want)["tokens"]
        assert pre.stats()["handoff"]["exports"] == 1
        assert dec.stats()["handoff"]["imports"] == 1
        head = prompt[:16]  # the two full pages the export carried
        assert dec._kv.prefix.contains(head, "acme")
        assert not dec._kv.prefix.contains(head, "")
        # the base tenant's row on the decode replica misses the adopted
        # pages: no cross-tenant KV
        hits0 = dec.stats()["kv"]["prefix"]["hits"]
        code, base = _post(dec_url, {"tokens": [prompt], "maxNewTokens": 6})
        code2, base_solo = _post(solo_url, {"tokens": [prompt], "maxNewTokens": 6})
        assert code == code2 == 200
        assert json.loads(base)["tokens"] == json.loads(base_solo)["tokens"]
        assert dec.stats()["kv"]["prefix"]["hits"] == hits0
        assert json.loads(base)["tokens"] != json.loads(out)["tokens"]
        drained(pre_url)
        drained(dec_url)
        # an unknown namespace is refused before any lease or page
        payload = pre._kv.export_prefix(prompt, "acme")
        payload.namespace = "nobody"
        c = http.client.HTTPConnection("127.0.0.1", int(dec_url.rsplit(":", 1)[1]))
        c.request("POST", "/kv_import", th.payload_to_wire(payload),
                  {"X-Handoff-Id": "rid-x", "X-Handoff-Epoch": "1"})
        r = c.getresponse()
        assert r.status == 400 and json.loads(r.read())["reason"] == "rejected"
        c.close()
    finally:
        for s in (router, pre, dec, solo):
            s.stop()
