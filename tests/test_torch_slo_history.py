"""The port's SLOs, metrics history, regression sentinel and federation
(`telemetry/slo.py`, `history.py`, `detect.py`, `federate.py`, the
server's `/sloz` and `/queryz`) against the JAX package, on the CPU.

- SLOs: a port server and a JAX server with the same `slos` and tenants,
  fed the same request counts and latencies at the same injected times,
  give the same burn rates, breach flags and breach edges — the
  per-tenant latency objectives ("<slo>@<tenant>") included;
- the port's flight recorder writes its bundle on a breach edge, with a
  `torch.profiler` trace under `profile/`;
- history: a segment written by either package is read by the other to
  the same `queryz_payload` answers (series list, avg/max/rate/p95
  windows, a bad query);
- the sentinel: the same history and rules fire the same edges;
- federation: the same exposition texts parse and merge to the same text.

Burn rates and aggregates are compared exactly: both sides do the same
float arithmetic on the same inputs."""

import importlib
import json
import urllib.request

import numpy as np
import pytest

from polyaxon_tpu.telemetry import detect as jdet
from polyaxon_tpu.telemetry import history as jhist
from polyaxon_tpu.telemetry import registry as jreg
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.serving.tenancy import normalize_tenants
from polyaxon_tpu_torch.telemetry import detect as tdet
from polyaxon_tpu_torch.telemetry import history as thist
from polyaxon_tpu_torch.telemetry import registry as treg
from tests.test_torch_transformer import jax_lm, torch_lm

# the packages export a `federate` function that shadows the module name
jfed = importlib.import_module("polyaxon_tpu.telemetry.federate")
tfed = importlib.import_module("polyaxon_tpu_torch.telemetry.federate")

SLOS = [
    {"name": "avail", "kind": "availability", "objective": 0.99, "windows": [10, 30]},
    {"name": "p95", "kind": "latency", "objective": 0.9, "threshold_ms": 250,
     "windows": [10, 30], "burn_threshold": 2.0},
]
TENANTS = normalize_tenants([{"name": "acme"}, {"name": "globex"}])


@pytest.fixture(scope="module")
def lm():
    module, params = jax_lm({"attention": "xla"})
    return module, params, torch_lm(module, params)


def _feed(rng_seed=0, steps=40):
    """Per step: (requests, errors, [(tenant, latency s)])."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(steps):
        bad_phase = 15 <= i < 25
        n = int(rng.integers(5, 15))
        errors = int(rng.integers(1, 4)) if bad_phase else 0
        lats = [("acme" if j % 2 else "globex",
                 float(rng.uniform(0.3, 0.9) if bad_phase and j % 2 else rng.uniform(0.01, 0.2)))
                for j in range(n)]
        out.append((n, errors, lats))
    return out


def _burn(server):
    edges = []
    server.slo_engine._on_breach = edges.append
    reg = server.telemetry
    out = []
    for i, (n, errors, lats) in enumerate(_feed()):
        reg.counter("serving.http_requests").inc(n)
        reg.counter("serving.http_errors").inc(errors)
        for tenant, lat in lats:
            reg.histogram("serving.request_seconds").observe(lat)
            server._tenant_series(tenant)[1].observe(lat)
        out.append(server.slo_engine.evaluate(t=1000.0 + 2.0 * i))
    return out, edges, server.slo_engine.to_dict()["slos"][0]["name"]


def test_burn_rates_and_breach_edges_equal_the_reference(lm):
    from polyaxon_tpu.serving.batching import ServingConfig as JConfig
    from polyaxon_tpu.serving.server import ModelServer as JServer

    ours = ModelServer(lm[2], None, ServingConfig(tenants=TENANTS), slos=SLOS, device="cpu")
    ref = JServer(lm[0], lm[1], model_name="small", config=JConfig(tenants=TENANTS), slos=SLOS)
    got, want = _burn(ours), _burn(ref)
    assert got == want
    names = [r["name"] for r in got[0][0]]
    assert names == ["avail", "p95", "p95@acme", "p95@default", "p95@globex"]
    edges = {e["name"] for e in got[1]}
    # the fleet burns, and the noisy tenant burns its own budget only
    assert {"avail", "p95@acme"} <= edges and "p95@globex" not in edges


def test_breach_writes_a_bundle_with_a_torch_profile(lm, tmp_path):
    server = ModelServer(lm[2], None, ServingConfig(), device="cpu", slos=SLOS[:1],
                         debug_dir=str(tmp_path), slo_profile_s=0.05)
    reg = server.telemetry
    server.slo_engine.evaluate(t=0.0)
    reg.counter("serving.http_requests").inc(10)
    reg.counter("serving.http_errors").inc(5)
    (res,) = server.slo_engine.evaluate(t=5.0)
    assert res["edge"] and res["breached"]
    server.flight_recorder.wait_profiles(30)
    (bundle,) = server.flight_recorder.dumps
    files = {p.name for p in (tmp_path / bundle.rsplit("/", 1)[-1]).iterdir()}
    assert {"breach.json", "metrics.json", "state.json", "traces.jsonl", "profile"} <= files
    trace = json.loads((tmp_path / bundle.rsplit("/", 1)[-1] / "profile" / "trace.json").read_text())
    assert "traceEvents" in trace
    assert server.stats()["slo"]["flight_recorder_dumps"] == [bundle]


# ------------------------------------------------------------- history
QUERIES = [
    "", "series=serving.requests&agg=avg", "series=serving.requests&agg=rate&step=5",
    "series=serving.ttft_ms&agg=p95&since=1002&until=1030",
    "series=serving.ttft_ms&agg=max&last=12", "series=serving.queue_depth&agg=min",
    "series=serving.requests&agg=bogus", "series=serving.requests&since=x",
]


def _registry(mod):
    reg = mod.MetricsRegistry()
    return (reg, reg.counter("serving.requests"), reg.gauge("serving.queue_depth"),
            reg.histogram("serving.ttft_ms", buckets=(1, 5, 10, 50, 100, 500)))


def _write(hist_mod, reg_mod, root):
    reg, c, g, h = _registry(reg_mod)
    store = hist_mod.HistoryStore(root, max_bytes=1 << 20, segment_bytes=2048)
    sampler = hist_mod.HistorySampler(reg, store, interval_s=1.0)
    rng = np.random.default_rng(1)
    for i in range(40):
        c.inc(int(rng.integers(0, 5)))
        g.set(float(rng.integers(0, 9)))
        for v in rng.uniform(0, 300, 4):
            h.observe(float(v))
        if i == 20:  # a replica restart: the counter drops to zero
            c._value = 0.0
        sampler.sample_once(t=1000.0 + i)
    return store


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_history_segments_read_by_either_package(tmp_path, writer):
    mods = {"port": (thist, treg), "jax": (jhist, jreg)}
    _write(*mods[writer], tmp_path)
    ours, ref = thist.HistoryStore(tmp_path), jhist.HistoryStore(tmp_path)
    for q in QUERIES:
        a, b = thist.queryz_payload(ours, q), jhist.queryz_payload(ref, q)
        assert a == b, q
    assert thist.queryz_payload(ours, QUERIES[1])[0] == 200
    assert thist.queryz_payload(ours, QUERIES[6])[0] == 400
    assert thist.queryz_payload(None, "")[0] == 503
    assert ours.samples() == ref.samples()


RULES = [
    {"name": "depth-ceiling", "series": "serving.queue_depth", "kind": "ceiling",
     "agg": "avg", "window_s": 5, "threshold": 4.0},
    {"name": "ttft-ratio", "series": "serving.ttft_ms", "kind": "window_ratio",
     "agg": "p95", "window_s": 5, "threshold": 1.5},
    {"name": "req-drift", "series": "serving.requests", "kind": "ewma_drift",
     "agg": "rate", "window_s": 5, "threshold": 0.2},
]


def test_sentinel_fires_the_same_edges(tmp_path):
    _write(thist, treg, tmp_path)
    got = []
    for det, hist, reg in ((tdet, thist, treg), (jdet, jhist, jreg)):
        events = []
        sentinel = det.RegressionSentinel(
            hist.HistoryStore(tmp_path), reg.MetricsRegistry(), det.build_rules(RULES),
            on_event=lambda kind, body, events=events: events.append((kind, body)))
        results = [sentinel.evaluate(t=1000.0 + t) for t in range(5, 41, 3)]
        got.append((results, events))
    assert got[0] == got[1]
    assert got[0][1], "no rule fired: the comparison would be vacuous"


def test_server_sloz_and_queryz_over_http(lm, tmp_path):
    server = ModelServer(lm[2], None, ServingConfig(), device="cpu", slos=SLOS,
                         history={"dir": str(tmp_path), "interval_s": 0.05},
                         regression_rules=RULES)
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        server.history_sampler.sample_once()
        with urllib.request.urlopen(url + "/sloz") as r:
            sloz = json.loads(r.read())
        assert [s["name"] for s in sloz["slos"]] == ["avail", "p95"]
        with urllib.request.urlopen(url + "/queryz") as r:
            qz = json.loads(r.read())
        assert "serving.requests" in qz["series"]
        with urllib.request.urlopen(url + "/queryz?series=serving.requests&agg=max") as r:
            assert r.status == 200
    finally:
        server.stop()


# ---------------------------------------------------------- federation
def _texts():
    out = []
    for k in range(2):
        reg = treg.MetricsRegistry()
        reg.counter("serving.requests").inc(3 + k)
        reg.gauge("serving.queue_depth").set(k)
        h = reg.histogram("serving.queue_wait_seconds", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05 * (k + 1), 0.5):
            h.observe(v)
        out.append(reg.render_prometheus())
    out.append('x_total{a="b\\"c"} NaN\nweird line\n')  # escapes, NaN, junk
    return out


def test_federate_parses_and_merges_like_the_reference():
    texts = _texts()
    for text in texts:
        a, b = tfed.parse_prometheus_text(text), jfed.parse_prometheus_text(text)
        assert str(a.flat()) == str(b.flat())
    sources = [("r0", texts[0]), ("r1", texts[1]), ("r2", None), ("r3", texts[2])]
    ours = tfed.federate(sources, local_text="router_requests_total 7\n")
    ref = jfed.federate(sources, local_text="router_requests_total 7\n")
    assert ours == ref
    snap = tfed.parse_prometheus_text(ours)
    assert snap.get("cluster:serving_requests_total:sum") == 7.0
    assert snap.get("federation_source_up", replica="r2") == 0.0
    s = tfed.parse_prometheus_text(texts[1])
    assert tfed.queue_wait_delta_ms(s, 0.0, 1.0) == jfed.queue_wait_delta_ms(
        jfed.parse_prometheus_text(texts[1]), 0.0, 1.0)
