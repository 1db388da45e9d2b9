"""The port's per-request traces (`telemetry/tracing.py`, the server's
spans, `/tracez`) against the JAX package, on the CPU.

- `RequestTrace` on an injected clock: the same scripted adds, annotations,
  groups and finish give the same trace dict as the reference's;
- `TraceRing`: the same recorded traces give the same retention (recent,
  errors, slowest), stats, lookups and `/tracez` payloads (`tracez_payload`
  for ids, `n`, every sort and the bad queries);
- `graft_spans`: the same remote trace grafts to the same spans;
- live servers: the same scripted requests (greedy, a shared-prefix hit,
  sampled, streamed) through the port's server and the JAX package's, on
  the coalesced dense path, the paged pool and the step scheduler, give
  traces with the same spans in the same order and the same attributes —
  everything but the measured times, which differ by construction.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

from polyaxon_tpu.telemetry import tracing as jtr
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.telemetry import tracing as ttr
from tests.test_torch_transformer import jax_lm, torch_lm

pytestmark = pytest.mark.serving


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _scripted(mod):
    tr = mod.RequestTrace("rid-1", clock=_Clock(), stream=True)
    tr.add("admission", start=100.0, dur_s=0.5)
    tr.set_group(3)
    tr.set_group(3)
    tr.set_group(4)
    tr.add("queue_wait", start=101.0, dur_s=0.25, group=3, row=0)
    tr.annotate("kv_plan", prefix_len=8, prefix_hit=True)
    tr.add("decode", start=99.0, dur_s=-1.0, steps=4)  # clamped to 0
    tr.finish(status="shed:queue", error="queue full")
    tr.finish(status="ok")  # first call wins
    return tr.to_dict()


def test_request_trace_equals_the_reference():
    assert _scripted(ttr) == _scripted(jtr)


def _traces(n=14):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        status = ["ok", "ok", "error", "shed:kv_pages", "deadline_exceeded"][i % 5]
        out.append({"id": f"t{i % 11}", "status": status,
                    "dur_ms": float(rng.integers(1, 500)), "group_span_ids": [i],
                    "attrs": {"i": i}, "spans": [{"name": "x", "start_s": 0.0,
                                                  "dur_s": 0.001, "attrs": {}}] * (i % 3)})
    return out


QUERIES = ["", "n=3", "n=5&sort=slowest", "sort=errors", "n=2&sort=errors",
           "id=t3", "id=t10", "id=missing", "sort=bogus", "n=x"]


def _ring(mod):
    ring = mod.TraceRing(capacity=4, error_capacity=3, slow_capacity=2)
    for t in _traces():
        ring.record(t)
    return ring


def test_trace_ring_and_tracez_payload_equal_the_reference():
    ours, ref = _ring(ttr), _ring(jtr)
    assert ours.stats() == ref.stats() and len(ours) == len(ref)
    assert ours.dump() == ref.dump()
    for sort in ("recent", "slowest", "errors"):
        assert ours.list(10, sort=sort) == ref.list(10, sort=sort)
    for q in QUERIES:
        assert ttr.tracez_payload(ours, q) == jtr.tracez_payload(ref, q), q
    with pytest.raises(ValueError):
        ttr.TraceRing(capacity=0)


def test_graft_spans_equals_the_reference():
    remote = {"status": "shed:kv_handoff_done", "dur_ms": 3.5, "error": "handed off",
              "spans": [{"name": "prefill", "start_s": 0.001, "dur_s": 0.002,
                         "attrs": {"row": 0}}, {"name": "kv_export", "start_s": 0.004}]}
    got = []
    for mod in (ttr, jtr):
        tdict = {"spans": [{"name": "upstream_attempt", "start_s": 0.5, "dur_s": 0.01,
                            "attrs": {"replica": "r0"}}]}
        n = mod.graft_spans(tdict, tdict["spans"][0], remote, replica="r0", attempt=0)
        got.append((n, tdict))
    assert got[0] == got[1] and got[0][0] == 2


# ------------------------------------------------------------ live servers
CONFIGS = {
    "dense": {},
    "paged": {"kv_pool_pages": 64, "kv_page_tokens": 8, "stream_chunk_tokens": 3},
    "step": {"kv_pool_pages": 64, "kv_page_tokens": 8, "stream_chunk_tokens": 3,
             "chunked_prefill": True, "prefill_chunk_tokens": 8, "max_step_tokens": 32},
}
BASE = {"max_batch": 4, "max_wait_ms": 1.0}


def _requests():
    # maxNewTokens at a bucket edge (16): the reference's paged group decodes
    # to the end of its new-token bucket, the port's to the longest row's
    # end, so only there do both run the same decode windows
    shared = np.random.default_rng(100).integers(1, 255, 16).tolist()
    own = np.random.default_rng(5).integers(1, 255, 30).tolist()
    return [
        ("greedy", {"tokens": [shared + own[:5]], "maxNewTokens": 16}, False),
        ("prefix-hit", {"tokens": [shared + own[5:9]], "maxNewTokens": 16}, False),
        ("sampled", {"tokens": [own[:11]], "maxNewTokens": 16, "temperature": 0.8,
                     "topK": 20, "seed": 4}, False),
        ("streamed", {"tokens": [own[11:24]], "maxNewTokens": 16}, True),
    ]


def _shape(trace):
    """A trace without its measured times: status, attrs and every span's
    name and attributes, in order."""
    return (trace["status"], trace["attrs"], trace["group_span_ids"],
            [(s["name"], s["attrs"]) for s in trace["spans"]])


def _run(url):
    out = {}
    for rid, body, stream in _requests():
        path = "/generate?stream=1" if stream else "/generate"
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                     method="POST", headers={"X-Request-Id": rid})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            r.read()
        for _ in range(50):  # a streamed trace lands when its generator closes
            try:
                with urllib.request.urlopen(url + f"/tracez?id={rid}", timeout=30) as r:
                    out[rid] = json.loads(r.read())
                break
            except urllib.error.HTTPError:
                time.sleep(0.02)
    with urllib.request.urlopen(url + "/tracez?n=10", timeout=30) as r:
        listing = json.loads(r.read())
    return out, listing


@pytest.fixture(scope="module")
def lm():
    module, params = jax_lm({"attention": "xla"})
    return module, params, torch_lm(module, params)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_live_traces_equal_the_reference(lm, name):
    from polyaxon_tpu.serving.batching import ServingConfig as JConfig
    from polyaxon_tpu.serving.server import ModelServer as JServer

    cfg = {**BASE, **CONFIGS[name]}
    ours = ModelServer(lm[2], None, ServingConfig(**cfg), device="cpu")
    ref = JServer(lm[0], lm[1], model_name="small", config=JConfig(**cfg))
    got = []
    for server in (ours, ref):
        url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
        try:
            got.append(_run(url))
        finally:
            server.stop()
    (traces, listing), (jtraces, jlisting) = got
    assert set(traces) == {rid for rid, _, _ in _requests()}
    for rid in traces:
        assert _shape(traces[rid]) == _shape(jtraces[rid]), (name, rid)
    names = {s["name"] for s in traces["greedy"]["spans"]}
    assert {"admission", "queue_wait", "decode"} <= names
    assert [(t["id"], t["status"], t["spans"]) for t in listing["traces"]] == [
        (t["id"], t["status"], t["spans"]) for t in jlisting["traces"]]
    assert listing["recorded"] == jlisting["recorded"] == 4
