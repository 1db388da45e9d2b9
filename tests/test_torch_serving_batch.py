"""The port's batched ModelServer over real HTTP on the CPU, held against
the JAX package's ModelServer in the same config.

One port server per config (module scope) answers concurrent greedy
requests; the JAX server of that config answers the same bodies (through
its own `generate`, the path it runs inline), and every row must be the
same tokens — which are also those of the port's direct `generate`. The
configs: `dense` (the coalescer over bucketed dense groups) and `paged`
(the paged pool with the prefix cache); `tests/test_torch_serving_chunked.py`
holds the step scheduler and `..._stream.py` the SSE path. Then: the
serving series on /statsz and /metricsz carry the reference's names, a
full queue sheds 503, a deadline that passes in the queue answers 504, and
no KV page has leaked after the traffic."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch.models.generate import generate
from polyaxon_tpu_torch.serving import batching
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.server import ModelServer
from tests.test_torch_transformer import jax_lm, torch_lm

BASE = {"max_batch": 4, "max_wait_ms": 50.0}
CONFIGS = {
    "dense": {},
    "paged": {"kv_pool_pages": 64, "kv_page_tokens": 8, "stream_chunk_tokens": 3},
    "step": {"kv_pool_pages": 64, "kv_page_tokens": 8, "stream_chunk_tokens": 3,
             "chunked_prefill": True, "prefill_chunk_tokens": 8,
             "max_step_tokens": 32},
}
NEW = 6


@pytest.fixture(scope="module")
def lm():
    module, params = jax_lm({"attention": "xla"})
    return module, params, torch_lm(module, params)


def traffic(seed=0, n=4, shared_len=16):
    """Prompts of several lengths; half share one page-aligned prefix (the
    same in every wave, so a later wave hits the prefix cache)."""
    rng = np.random.default_rng(seed)
    shared = np.random.default_rng(100).integers(1, 256, shared_len).tolist()
    out = []
    for i in range(n):
        own = rng.integers(1, 256, int(rng.integers(3, 12))).tolist()
        out.append((shared + own) if i % 2 == 0 else own)
    return out


def post(url, body, path="/generate", timeout=120):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        data = resp.read()
        return json.loads(data) if path != "/metricsz" else data.decode()


def concurrent(url, bodies):
    """POST every body at once, one thread each; answers in body order."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = post(url, bodies[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    return out


def start_port(lm, name, **extra):
    module, params, model = lm
    server = ModelServer(model, None, ServingConfig(**{**BASE, **CONFIGS[name], **extra}),
                         device="cpu")
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


def jax_answers(lm, name, bodies):
    """The JAX package's ModelServer in the same config, answering each
    body through its own inline path."""
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    module, params, _ = lm
    server = JaxServer(module, params, model_name="small",
                       config=JaxConfig(**{**BASE, **CONFIGS[name]}))
    return [server.generate(b)["tokens"] for b in bodies]


def greedy_bodies(prompts):
    return [{"tokens": [p], "maxNewTokens": NEW} for p in prompts]


def assert_no_leak(server):
    kv = server.stats()["kv"]
    assert kv["active_rows"] == 0 and kv["pages_reserved"] == 0
    # the scratch page plus the prefix cache's warm pages, nothing else
    assert kv["pages_used"] == 1 + kv["prefix"]["held_pages"], kv


@pytest.fixture(scope="module", params=["dense", "paged"])
def served(request, lm):
    name = request.param
    prompts = traffic()
    # a second wave after the first is done: its shared prefix is cached
    waves = [greedy_bodies(prompts), greedy_bodies(traffic(seed=1))]
    server, url = start_port(lm, name)
    try:
        answers = [concurrent(url, wave) for wave in waves]
        ref = jax_answers(lm, name, waves[0] + waves[1])
        yield name, server, url, waves, answers, ref
    finally:
        server.stop()


def test_concurrent_greedy_matches_jax_server(served, lm):
    name, server, url, waves, answers, ref = served
    bodies = waves[0] + waves[1]
    got = [a for wave in answers for a in wave]
    assert all(code == 200 for code, _ in got), got
    assert [out["tokens"] for _, out in got] == ref
    for body, (_, out) in zip(bodies, got):
        prompt = torch.tensor(body["tokens"])
        direct = generate(lm[2], prompt, max_new_tokens=NEW).tolist()
        assert out["tokens"] == direct
        assert len(out["tokens"][0]) == len(body["tokens"][0]) + NEW
    stats = server.stats()
    assert stats["requests"] == len(bodies)
    assert stats["mean_batch_occupancy"] > 1  # concurrent rows coalesced
    if name == "paged":
        assert stats["kv"]["prefix"]["hits"] >= 1
        assert_no_leak(server)


def test_sampled_rows_equal_dense_and_paged(lm):
    """A sampled body (two rows, seed 9 → rows draw seed 9 and 10) gives the
    same tokens through the dense and the paged config, and the same as
    the direct `generate` with those per-row seeds."""
    prompt = traffic(seed=3, n=2)[1]
    body = {"tokens": [prompt, prompt[::-1]], "maxNewTokens": NEW,
            "temperature": 0.9, "topK": 30, "seed": 9}
    outs = []
    for name in ("dense", "paged"):
        server, url = start_port(lm, name)
        try:
            code, out = post(url, body)
        finally:
            server.stop()
        assert code == 200
        outs.append(out["tokens"])
    assert outs[0] == outs[1]
    direct = generate(lm[2], torch.tensor(body["tokens"]), max_new_tokens=NEW,
                      temperature=0.9, top_k=30, seed=[9, 10]).tolist()
    assert outs[0] == direct


# the reference's serving series (polyaxon_tpu/serving/server.py) that the
# port registers, by their Prometheus names
SERIES = [
    "serving_requests_total", "serving_batches_total", "serving_request_seconds",
    "serving_queue_wait_seconds", "serving_batch_occupancy", "serving_shed_total",
    "serving_deadline_exceeded_total", "serving_worker_restarts_total",
    "serving_breaker_state", "serving_ready", "serving_queue_depth",
    "serving_kv_pages_total", "serving_kv_pages_used", "serving_kv_pages_prefix_held",
    "serving_prefix_cache_hits_total", "serving_prefix_cache_misses_total",
    "serving_ttft_ms", "serving_prefill_chunks_total", "serving_step_tokens",
    "serving_prefill_queue_depth", "serving_http_requests_total",
    "serving_http_errors_total", "serving_client_disconnects_total",
]


def _series(text):
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


def test_statsz_and_metricsz_carry_the_reference_series(served, lm):
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    name, server, url, *_ = served
    ours = _series(get(url, "/metricsz"))
    ref = _series(JaxServer(lm[0], lm[1], config=JaxConfig(**BASE)).telemetry.render_prometheus())
    assert set(SERIES) <= ours
    assert set(SERIES) <= ref
    stats = get(url, "/statsz")
    for key in ("kv", "chunked", "queue_depth", "shed", "deadline_exceeded", "breaker",
                "requests", "batches", "mean_batch_occupancy", "latency_ms",
                "queue_wait_ms", "ttft_ms", "prompt_buckets", "max_new_buckets"):
        assert key in stats, key
    assert stats["kv"]["enabled"] is (name == "paged")
    assert get(url, "/healthz")["status"] == "ok"
    assert get(url, "/readyz")["ready"] is True
    kvz = get(url, "/kvz")
    assert kvz["enabled"] is (name == "paged")
    if name == "paged":
        assert kvz["pageTokens"] == 8 and kvz["heads"]
    # /tracez is served now (tests/test_torch_tracing.py holds it against
    # the reference): GET answers the ring, POST has no route
    assert "traces" in get(url, "/tracez")
    code, out = post(url, {}, path="/tracez")
    assert code == 404


def test_full_queue_sheds_503_and_past_deadline_answers_504(lm):
    """The worker is held (the test takes the server's device lock), so the
    first request sits in flight, the second waits in the queue past its
    deadline, and the third finds the queue full."""
    server, url = start_port(lm, "dense", max_queue=2, max_wait_ms=0.0)
    prompt = traffic()[1]
    results = {}
    try:
        with server._lock:
            def send(tag, body):
                results[tag] = post(url, body)

            a = threading.Thread(target=send, args=("a", {"tokens": [prompt], "maxNewTokens": 2}))
            a.start()
            # depth counts a from admission on: wait until the worker has
            # also taken it out of the queue, or b could join a's batch
            co = server._coalescer
            _wait(lambda: co.depth == 1 and co._queue.empty() and not co._pending)
            b = threading.Thread(target=send, args=(
                "b", {"tokens": [prompt], "maxNewTokens": 2, "deadlineMs": 1000}))
            b.start()
            _wait(lambda: server._coalescer.depth == 2)
            code, out = post(url, {"tokens": [prompt], "maxNewTokens": 2})
            assert code == 503 and out["reason"] == "queue_full"
            time.sleep(1.2)  # b's deadline passes while it waits
        a.join(60)
        b.join(60)
        assert results["a"][0] == 200
        assert results["b"][0] == 504 and results["b"][1]["reason"] == "deadline_exceeded"
        stats = server.stats()
        assert stats["shed"] >= 1 and stats["deadline_exceeded"] >= 1
        # a deadline already gone at admission is shed, not queued
        code, out = post(url, {"tokens": [prompt], "maxNewTokens": 2, "deadlineMs": 1e-6})
        assert code == 503 and out["reason"] == "deadline"
    finally:
        server.stop()


def test_kv_pool_exhaustion_sheds_503(lm):
    """A request that cannot reserve its pages now is shed with reason
    kv_pages (each of these rows needs 6 of the pool's 7 usable pages); one
    that can never fit the pool is a 400."""
    server, url = start_port(lm, "paged", kv_pool_pages=8, prefix_cache=False)
    try:
        with server._lock:
            t = threading.Thread(target=post, args=(
                url, {"tokens": [list(range(1, 30))], "maxNewTokens": 6}))
            t.start()
            _wait(lambda: server.stats()["kv"]["active_rows"] == 1)
            code, out = post(url, {"tokens": [list(range(1, 30))], "maxNewTokens": 6})
            assert code == 503 and out["reason"] == "kv_pages"
        t.join(60)
        code, out = post(url, {"tokens": [list(range(1, 100))], "maxNewTokens": 20})
        assert code == 400
        assert server.stats()["kv"]["pages_used"] == 1
    finally:
        server.stop()


def test_unported_options_are_refused_by_name(tmp_path, lm):
    """Every option is served now: meshes (tests/test_torch_serving_mesh.py),
    speculation, int8 weights and the int8 pool
    (tests/test_torch_serving_fast.py), tenants, adapters and the spill tier
    (tests/test_torch_tenancy.py, tests/test_torch_spill.py), the
    disaggregated roles (tests/test_torch_handoff.py) and `from_run`
    (tests/test_torch_from_run.py), and every one of them on a decode mesh
    (tests/test_torch_serving_mesh.py): a mesh is refused only for the
    ranks it lacks."""
    assert ServingConfig(mesh_axes=(("model", 2),)).mesh_axes == (("model", 2),)
    with pytest.raises(ValueError, match="needs 2 devices, only 1 visible"):
        ModelServer(lm[2], None, ServingConfig(mesh_axes=(("model", 2),), speculate=True),
                    device="cpu")
    for field in ({"role": "prefill"}, {"role": "decode"},
                  {"speculate": True}, {"kv_quant": "int8"}, {"quantize": True},
                  {"draft_model": ()}, {"adaptive_draft": True},
                  {"tenants": ((("name", "a"),),)}, {"adapter_slots": 2},
                  {"adapters": (("a", "seed:1"),)}, {"spill_dir": "/nowhere"},
                  {"spill_ram_bytes": 1 << 20, "spill_dir_bytes": 1 << 20}):
        assert ServingConfig(**field)
    # from_run resolves the run now: an unknown one is the reference's KeyError
    from polyaxon_tpu_torch.store import RunStore

    with pytest.raises(KeyError, match="no run matching 'uid'"):
        ModelServer.from_run("uid", store=RunStore(tmp_path), device="cpu")


def test_buckets_match_the_reference():
    from polyaxon_tpu.serving import batching as ref

    for lo, hi in ((32, 128), (1, 7), (16, 8192)):
        assert batching.bucket_ladder(lo, hi) == ref.bucket_ladder(lo, hi)
    ladder = batching.bucket_ladder(8, 64)
    for n in (1, 8, 9, 64, 65):
        assert batching.bucket_for(n, ladder) == ref.bucket_for(n, ladder)
        assert batching.batch_bucket(n, 8) == ref.batch_bucket(n, 8)
    for plen, new in ((40, 16), (3, 5), (60, 4), (20, 40)):
        args = (plen, new, ladder, batching.bucket_ladder(4, 64), 64)
        assert batching.choose_buckets(*args) == ref.choose_buckets(*args)


def _wait(cond, timeout=30.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise TimeoutError("condition never held")
        time.sleep(0.005)
