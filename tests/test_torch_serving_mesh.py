"""The port's ModelServer on a decode mesh on the CPU, held against the JAX
package's ModelServer on the same mesh.

One `gloo` world of 4 ranks (`tests/torch_mesh_workers.py::run_world`)
serves, in order: every config below on `{batch: 2, model: 2}` and on
`{model: 4}` (each rank builds the same small model, rank 0 answers the
bodies inline and concurrently over HTTP, the followers follow), then a
run of the port's store through `from_run(mesh_axes={data: 2, model: 2})`,
then asks for a mesh larger than the world. The paths (`PATHS`): per
request; coalesced (the dense group inline, the coalescer over HTTP);
paged (the chunked config's inline answers, which take the paged group
path) and chunked (its HTTP answers, through the step scheduler). The JAX package's servers on
the same meshes (`TRANSFORMER_RULES`, conftest's 8 virtual devices)
answer the same bodies; greedy rows must be the same tokens on every path
(per request, coalesced, paged, chunked prefill), int8 rows the JAX int8
server's, sampled rows the port's single-device server's (the JAX
package's draws differ by construction). Then: the `mesh` block of
/statsz and the two mesh gauges are the reference's, a follower holds
about 1/model of the weights, a follower's failure fails rank 0's call
instead of hanging it, `serve --mesh model=2` starts two processes that
answer over HTTP (and /readyz reports a degraded slice below
`--expected-devices`), and what a mesh does not serve yet is refused by
name."""

import concurrent.futures
import contextlib
import io
import json
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from polyaxon_tpu_torch.parallel.mesh import decode_axis_sizes
from polyaxon_tpu_torch.serving.batching import ServingConfig, normalize_mesh_axes
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.store import RunStore
from tests.test_torch_transformer import jax_lm, torch_lm
from tests.torch_mesh_workers import free_port, run_world

SMALL = {"attention": "xla", "n_kv_heads": 4}  # dim 64, 2 layers, 4/4 heads, vocab 256
MESHES = {"batch2-model2": {"batch": 2, "model": 2}, "model4": {"model": 4}}
BASE = {"max_batch": 4, "max_wait_ms": 50.0}
PAGED = {**BASE, "kv_pool_pages": 64, "kv_page_tokens": 8, "stream_chunk_tokens": 3}
CHUNKED = {**PAGED, "chunked_prefill": True, "prefill_chunk_tokens": 8, "max_step_tokens": 32}
CONFIGS = {
    "per-request": {"batching": False},
    "coalesced": BASE,
    "chunked": CHUNKED,
    "int8": {**CHUNKED, "quantize": True, "kv_quant": "int8"},
}
# path -> (config, which answers: inline rows, HTTP rows or both)
PATHS = {"per-request": ("per-request", "both"), "coalesced": ("coalesced", "both"),
         "paged": ("chunked", "inline"), "chunked": ("chunked", "http")}
NEW = 4
UUID = "1e0e0d0c0b0a09080706050403020100"


def _prompts():
    """Prompts of several lengths; half share one page-aligned prefix, so
    the second of them hits the prefix cache."""
    rng = np.random.default_rng(7)
    shared = np.random.default_rng(100).integers(1, 256, 16).tolist()
    out = []
    for i in range(4):
        own = rng.integers(1, 256, int(rng.integers(3, 12))).tolist()
        out.append(shared + own if i % 2 == 0 else own)
    return out


PROMPTS = _prompts()
GREEDY = [{"tokens": [p], "maxNewTokens": NEW} for p in PROMPTS]
TWO_ROWS = {"tokens": [PROMPTS[1][:5], PROMPTS[3][:5]], "maxNewTokens": NEW}
SAMPLED = {"tokens": [PROMPTS[0][:9], PROMPTS[1][:9]], "maxNewTokens": NEW,
           "temperature": 0.9, "topK": 20, "seed": 5}
INLINE = GREEDY + [TWO_ROWS, SAMPLED]
FROM_RUN = GREEDY[:2] + [SAMPLED]
PROGRAM = {
    "model": {"name": "transformer_lm",
              "config": {"dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 4,
                         "vocab_size": 256, "seq_len": 128, "attention": "xla"}},
    "data": {"name": "synthetic_text", "batchSize": 2,
             "config": {"seq_len": 64, "vocab_size": 256}},
    "optimizer": {"name": "adamw", "learningRate": 0.001},
    "train": {"steps": 2, "precision": "float32", "checkpointEvery": 2},
    "serving": {"maxBatch": 4, "maxWaitMs": 50.0},
}


@pytest.fixture(scope="module")
def lm():
    module, params = jax_lm(SMALL)
    model = torch_lm(module, params)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return module, params, model, state


@pytest.fixture(scope="module")
def port_run(lm, tmp_path_factory):
    """A run of the port's store whose checkpoint (step 2) holds the small
    model's weights: (home, uuid)."""
    from polyaxon_tpu_torch.runtime import Trainer
    from polyaxon_tpu_torch.runtime.checkpoint import close_all

    home = tmp_path_factory.mktemp("mesh-home")
    store = RunStore(home)
    spec = {"version": 1.1, "kind": "operation", "name": "lm-mesh",
            "component": {"kind": "component", "name": "lm-mesh",
                          "run": {"kind": "jaxjob", "program": PROGRAM}}}
    store.create_run(UUID, "lm-mesh", "default", spec)
    trainer = Trainer(PROGRAM, device="cpu",
                      checkpoint_dir=str(store.outputs_dir(UUID) / "checkpoints"))
    trainer.load_state_dict(lm[2].state_dict())
    trainer.step = 2
    assert trainer.save(2, wait=True)
    close_all()
    return home, UUID


@pytest.fixture(scope="module")
def served(lm, port_run):
    """(the 4-rank world's results, the JAX package's rows): the world runs
    in its own processes while this one runs the JAX servers."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(_world, lm, port_run)
        return world.result(), _jax_rows(lm)


@pytest.fixture(scope="module")
def world(served):
    return served[0]


@pytest.fixture(scope="module")
def jax_rows(served):
    return served[1]


def _world(lm, port_run):
    """The 4-rank world's results, by rank: [serve_mesh on each mesh,
    serve_from_run, the error of a mesh larger than the world]."""
    cfg = dict(PROGRAM["model"]["config"])
    configs = list(CONFIGS.items())
    cases = [("serve_mesh", dict(model_config=cfg, state=lm[3], mesh_axes=axes,
                                 configs=configs, inline=INLINE, http=GREEDY))
             for axes in MESHES.values()]
    cases.append(("serve_from_run", dict(home=str(port_run[0]), run=port_run[1][:8],
                                         mesh_axes={"data": 2, "model": 2},
                                         inline=FROM_RUN, http=GREEDY[:2])))
    cases.append(("mesh_error", dict(mesh_axes={"model": 8})))
    return run_world(4, cases, timeout=400)


def _jax_rows(lm):
    """The JAX package's servers: greedy rows of INLINE's greedy bodies on
    each mesh (coalesced), their /statsz `mesh` and gauges, and the int8
    rows of the first two (the int8 paged step config)."""
    from polyaxon_tpu.models.transformer import TRANSFORMER_RULES
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.batching import normalize_mesh_axes as jax_axes
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    module, params = lm[:2]
    out = {}
    for name, axes in MESHES.items():
        server = JaxServer(module, params, model_name="small", sharding_rules=TRANSFORMER_RULES,
                           config=JaxConfig(**BASE, mesh_axes=jax_axes(axes)))
        out[name] = {"rows": [server.generate(b)["tokens"] for b in INLINE[:-1]],
                     "mesh": server.stats()["mesh"],
                     "metrics": server.telemetry.render_prometheus()}
    # the int8 rows as tests/test_torch_serving_fast.py holds them: the
    # JAX server's int8 step config on one device
    server = JaxServer(module, params, model_name="small", config=JaxConfig(**CONFIGS["int8"]))
    out["int8"] = [server.generate(b)["tokens"] for b in GREEDY[:2]]
    return out


def _served(world, mesh_name):
    return world[0][list(MESHES).index(mesh_name)]


def _rows(answers) -> list:
    """A config's rows: the inline answers, then the HTTP ones."""
    assert all(code == 200 for code, _ in answers["http"]), answers["http"]
    return answers["inline"] + [out["tokens"] for _, out in answers["http"]]


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_greedy_rows_equal_the_jax_server_on_the_mesh(world, jax_rows, mesh, path):
    config, which = PATHS[path]
    got = _rows(_served(world, mesh)[config])
    ref = jax_rows[mesh]["rows"]
    if which in ("inline", "both"):
        assert got[:len(INLINE) - 1] == ref
    if which in ("http", "both"):
        assert got[len(INLINE):] == ref[:len(GREEDY)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_int8_rows_equal_the_jax_int8_server(world, jax_rows, mesh):
    got = _rows(_served(world, mesh)["int8"])
    assert got[:2] == jax_rows["int8"]  # inline: the paged group path
    assert got[len(INLINE):len(INLINE) + 2] == jax_rows["int8"]  # the step scheduler
    kv = _served(world, mesh)["int8"]["stats"]["kv"]
    model = MESHES[mesh]["model"]
    # the pool's pages stay whole-model; each rank holds its kv heads' share
    assert kv["kv_pool_bytes_per_rank"] * model == kv["kv_pool_bytes"]


@pytest.fixture(scope="module")
def one_device_sampled(lm):
    """SAMPLED on one device: per request (the request's seed) and batched
    (per-row seeds, the same tokens on every batched path)."""
    out = {}
    for name in ("per-request", "coalesced"):
        one = ModelServer(torch_lm(*lm[:2]), None, ServingConfig(**CONFIGS[name]),
                          device="cpu")
        out[name] = one.generate(SAMPLED)["tokens"]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sampled_rows_equal_the_single_device_server(world, one_device_sampled, mesh):
    for name in CONFIGS:
        want = one_device_sampled["per-request" if name == "per-request" else "coalesced"]
        assert _served(world, mesh)[name]["inline"][-1] == want, name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_block_and_gauges_are_the_references(world, jax_rows, mesh):
    def gauges(text):
        return {name: float(re.search(rf"^serving_{name}(?:{{[^}}]*}})? (\S+)$", text,
                                      re.M).group(1))
                for name in ("mesh_devices", "mesh_model")}

    for answers in _served(world, mesh).values():
        assert answers["stats"]["mesh"] == jax_rows[mesh]["mesh"]
        assert gauges(answers["metrics"]) == gauges(jax_rows[mesh]["metrics"])
        assert answers["readyz"][0] == 200


@pytest.mark.parametrize("mesh", list(MESHES))
def test_followers_hold_their_shards_and_follow_every_command(world, lm, mesh):
    whole = sum(v.nbytes for v in lm[3].values())
    model = MESHES[mesh]["model"]
    for name in CONFIGS:
        sent = _served(world, mesh)[name]["sent"]
        for rank in range(1, 4):
            commands, shard = world[rank][list(MESHES).index(mesh)][name]
            assert commands == sum(sent.values()) + 1  # and the stop
            if name != "int8":
                # the norm scales stay whole: a few hundred bytes over 1/model
                assert whole / model <= shard <= whole / model * 1.02, (shard, whole)
        assert sent["forward"] > 0


def test_from_run_on_a_mesh_equals_single_device_serving(world, port_run):
    home, uuid = port_run
    one = ModelServer.from_run(uuid, store=RunStore(home), device="cpu")
    want = [one.generate(b)["tokens"] for b in FROM_RUN]
    got = world[0][2]
    assert got["step"] == 2 and got["stats"]["mesh"]["axes"] == {"batch": 2, "model": 2}
    assert got["inline"] == want
    assert [out["tokens"] for _, out in got["http"]] == want[:2]
    # each rank read only its shards of the checkpoint
    assert got["bytes_read"] == world[1][2][2] < one.restore_info["bytes_read"] * 0.52


def test_a_mesh_larger_than_the_world_fails_by_name(world):
    assert world[0][3] == ("ValueError: decode mesh {'model': 8, 'batch': 1} needs 8 devices, "
                           "only 4 visible")


@pytest.mark.parametrize("spec,sizes", [
    (None, {"batch": 1, "model": 1}),
    ({"model": 2}, {"batch": 1, "model": 2}),
    ({"data": 2, "fsdp": 2, "model": 2}, {"batch": 4, "model": 2}),
    ({"model": -1}, {"batch": 1, "model": 8}),
    ({"batch": -1, "model": 2}, {"batch": 4, "model": 2}),
    ({"batch": 2, "data": 2}, ValueError),
    ({"model": 2, "context": 2}, ValueError),
    ({"model": 16}, ValueError),
])
def test_decode_axis_sizes_are_the_references(spec, sizes):
    import jax

    from polyaxon_tpu.parallel.mesh import decode_mesh

    if sizes is ValueError:
        with pytest.raises(ValueError) as ours:
            decode_axis_sizes(spec, 8)
        with pytest.raises(ValueError) as ref:
            decode_mesh(spec, jax.devices()[:8])
        assert str(ours.value) == str(ref.value)
        return
    assert decode_axis_sizes(spec, 8) == sizes == dict(decode_mesh(spec, jax.devices()[:8]).shape)


def test_a_follower_error_fails_the_call_on_rank_0(lm, tmp_path):
    out = tmp_path / "rank0.json"
    with pytest.raises(RuntimeError, match="injected forward failure"):
        run_world(2, [("serve_follower_fails", dict(
            model_config=dict(PROGRAM["model"]["config"]), state=lm[3],
            body=GREEDY[0], out=str(out)))], timeout=120)
    got = json.loads(out.read_text())
    assert got["error"] and got["broken"] and got["seconds"] < 60, got


@pytest.mark.parametrize("config,what", [
    ({"speculate": True}, "speculation"),
    ({"adapter_slots": 2}, "adapter slots and tenants"),
    ({"kv_pool_pages": 16, "spill_ram_bytes": 1 << 20}, "the KV spill tier"),
    ({"kv_pool_pages": 16, "chunked_prefill": True, "role": "decode"}, "'decode' handoff role"),
    ({"numBeams": 2}, "beam search"),
])
def test_what_a_mesh_does_not_serve_yet_is_refused_by_name(lm, config, what):
    import torch.distributed as dist

    from polyaxon_tpu_torch.parallel.mesh import decode_mesh

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    if "numBeams" in config:
        server = ModelServer(torch_lm(*lm[:2]), None, ServingConfig(), device="cpu",
                             mesh=decode_mesh({"model": 1}))
        try:
            with pytest.raises(NotImplementedError, match=f"{what}.*decode mesh.*ROADMAP"):
                server.generate({**GREEDY[0], **config})
        finally:
            server.stop()
        return
    with pytest.raises(NotImplementedError, match=f"{what}.*decode mesh.*ROADMAP"):
        ModelServer(torch_lm(*lm[:2]), None,
                    ServingConfig(**config, mesh_axes=normalize_mesh_axes({"model": 2})),
                    device="cpu")


def test_serve_mesh_starts_two_processes_and_reports_a_degraded_slice(port_run):
    from polyaxon_tpu_torch.cli.main import main

    home, uuid = port_run
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    answer = {}

    def ask():
        deadline = time.monotonic() + 120
        try:
            while time.monotonic() < deadline:
                try:
                    with urllib.request.urlopen(url + "/healthz", timeout=2):
                        break
                except Exception:  # noqa: BLE001 — not up yet
                    time.sleep(0.2)
            req = urllib.request.Request(url + "/generate", data=json.dumps(GREEDY[0]).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                answer["tokens"] = json.loads(r.read())["tokens"]
            with urllib.request.urlopen(url + "/statsz", timeout=10) as r:
                answer["mesh"] = json.loads(r.read())["mesh"]
            try:
                urllib.request.urlopen(url + "/readyz", timeout=10)
            except urllib.error.HTTPError as e:
                answer["readyz"] = (e.code, json.loads(e.read()))
        finally:
            # only once `serve` waits on its own handler: a SIGINT after it
            # returned would interrupt the test session itself
            stop_by = time.monotonic() + 60
            while signal.getsignal(signal.SIGINT) is original and time.monotonic() < stop_by:
                time.sleep(0.05)
            if signal.getsignal(signal.SIGINT) is not original:
                os.kill(os.getpid(), signal.SIGINT)

    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    original = handlers[signal.SIGINT]
    env = {"POLYAXON_HOME": str(home), "POLYAXON_TORCH_DEVICE": "cpu"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = io.StringIO()
    t = threading.Thread(target=ask, daemon=True)
    try:
        with contextlib.redirect_stdout(out):
            t.start()
            code = main(["serve", "-uid", uuid[:8], "--mesh", "model=2", "--port", str(port),
                         "--expected-devices", "3"])
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        for k, v in old.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    t.join(timeout=30)
    text = out.getvalue()
    assert code == 0, text
    assert '"event":"gang_start","attempt":0,"workers":2' in text, text
    one = ModelServer.from_run(uuid, store=RunStore(home), device="cpu")
    assert answer["tokens"] == one.generate(dict(GREEDY[0]))["tokens"]
    assert answer["mesh"] == {"enabled": True, "devices": 2, "axes": {"batch": 1, "model": 2}}
    code, body = answer["readyz"]
    assert code == 503 and body["reason"] == "degraded slice: expected 3 devices, found 2"
