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
package's draws differ by construction), and on `{batch: 2, model: 2}` an
MoE model's coalesced rows the JAX MoE server's on the same mesh. Then: the `mesh` block of
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
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.store import RunStore
from tests.test_torch_transformer import jax_lm, torch_lm
from tests.torch_mesh_workers import free_port, run_world

SMALL = {"attention": "xla", "n_kv_heads": 4}  # dim 64, 2 layers, 4/4 heads, vocab 256
SMALL_LAYERS = 2
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
LORA_UUID = "2e0e0d0c0b0a09080706050403020100"


# Every serving feature on each mesh (a config's plan drives rank 0; see
# tests/torch_mesh_workers.py::serve_mesh). Beam search inline (BEAMS); n-gram speculation on the chunked config (inline: the paged
# group path, HTTP: the step scheduler); a draft model (a layer of the
# target, adaptive K) on the coalesced config; two tenants on an int8 base
# with one adapter slot, so each switch evicts the idle adapter to its
# spill tier and the next acquire restores it; the spill tier on an int8
# pool (a target prompt, a flood that evicts its prefix, the target again,
# restored); and the prefill/decode roles, the mesh in each role beside a
# one-device replica of the other behind the port's router.
FEATURES = ("beams", "spec", "draft", "tenants", "spill", "roles")
BAD_DRAFT = (("n_heads", 2), ("n_kv_heads", 2))
SPEC_NEW = 12
LORA = {**SMALL, "lora_rank": 4}
ADAPTERS = {"acme": "seed:1", "globex": "seed:2"}
SPILL = {"max_batch": 4, "max_wait_ms": 2.0, "kv_pool_pages": 24, "kv_page_tokens": 8,
         "kv_quant": "int8"}
POOL = {"max_batch": 4, "max_wait_ms": 2.0, "kv_page_tokens": 8, "kv_pool_pages": 64,
        "stream_chunk_tokens": 3, "chunked_prefill": True, "prefix_cache": True,
        "speculate": True, "draft_tokens": 3}


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
# three beams of one row: on {batch: 2} a group holds two rows (and a pad),
# so parents cross groups; two rows of two beams: every parent is in its
# row's group
BEAMS = [{**GREEDY[1], "numBeams": 3}, {**TWO_ROWS, "numBeams": 2}]
SPEC_GREEDY = [{**b, "maxNewTokens": SPEC_NEW} for b in GREEDY[:2]]
SPEC_SAMPLED = {**SAMPLED, "maxNewTokens": SPEC_NEW}
TENANT_BODIES = [{**GREEDY[0], "tenant": t} for t in ("acme", "globex", "acme")]


def _spill_bodies():
    rng = np.random.RandomState(0)
    target, *flood = [rng.randint(1, 100, size=49).tolist() for _ in range(7)]
    return [{"tokens": [t], "maxNewTokens": 6} for t in [target, *flood, target]]


SPILL_BODIES = _spill_bodies()
ROLE_BODIES = [GREEDY[0], GREEDY[2]]  # 16 shared tokens and own ones: 2 pages each
# an MoE model on {batch: 2, model: 2} beside the JAX MoE server on the same
# mesh (each expert's hidden units over `model`), coalesced inline
MOE_LM = {**SMALL, "dim": 32, "n_experts": 4}
MOE_MESH = "batch2-model2"
MOE_BODIES = GREEDY + [TWO_ROWS]
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
def moe_lm():
    module, params = jax_lm(MOE_LM)
    model = torch_lm(module, params)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return module, params, model, state


@pytest.fixture(scope="module")
def lora_lm():
    module, params = jax_lm(LORA)
    model = torch_lm(module, params)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return module, params, model, state


def _tenancy(**extra):
    from polyaxon_tpu_torch.serving.tenancy import normalize_adapters, normalize_tenants

    return {**CHUNKED, "quantize": True, "adapters": normalize_adapters(ADAPTERS),
            "tenants": normalize_tenants([{"name": n, "adapter": n} for n in ADAPTERS]),
            "adapter_slots": 1, **extra}


def _feature_configs(lora_state) -> list:
    """(name, ServingConfig kwargs, plan) of FEATURES, as serve_mesh runs
    them after CONFIGS on each mesh."""
    lora_cfg = {**PROGRAM["model"]["config"], "lora_rank": LORA["lora_rank"]}
    return [
        ("beams", BASE, {"inline": BEAMS, "http": []}),
        ("spec", {**CHUNKED, "speculate": True, "draft_tokens": 3},
         {"inline": SPEC_GREEDY, "http": SPEC_GREEDY + [SPEC_SAMPLED]}),
        ("draft", {**BASE, "speculate": True, "draft_tokens": 3, "adaptive_draft": True,
                   "draft_model": (("n_layers", 1),)},
         {"inline": SPEC_GREEDY, "http": SPEC_GREEDY + [SPEC_SAMPLED]}),
        ("tenants", _tenancy(), {"model": (lora_cfg, lora_state), "inline": TENANT_BODIES,
                                 "http": TENANT_BODIES, "sequential": True}),
        ("spill", {**SPILL, "spill_ram_bytes": 32 << 20},
         {"drive": "spill", "http": SPILL_BODIES}),
        ("roles-prefill", {**POOL, "role": "prefill"},
         {"drive": "prefill", "http": ROLE_BODIES, "pool": POOL}),
        ("roles-decode", {**POOL, "role": "decode"},
         {"drive": "decode", "http": ROLE_BODIES, "pool": POOL}),
    ]


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
def lora_run(lora_lm, port_run):
    """A run of LORA's model (with the LoRA model's weights) in the same
    store: its uuid."""
    from polyaxon_tpu_torch.runtime import Trainer
    from polyaxon_tpu_torch.runtime.checkpoint import close_all

    store = RunStore(port_run[0])
    program = {**PROGRAM, "model": {**PROGRAM["model"], "config": {
        **PROGRAM["model"]["config"], "lora_rank": LORA["lora_rank"]}}}
    spec = {"version": 1.1, "kind": "operation", "name": "lora-mesh",
            "component": {"kind": "component", "name": "lora-mesh",
                          "run": {"kind": "jaxjob", "program": program}}}
    store.create_run(LORA_UUID, "lora-mesh", "default", spec)
    trainer = Trainer(program, device="cpu",
                      checkpoint_dir=str(store.outputs_dir(LORA_UUID) / "checkpoints"))
    trainer.load_state_dict(lora_lm[2].state_dict())
    trainer.step = 2
    assert trainer.save(2, wait=True)
    close_all()
    return LORA_UUID


@pytest.fixture(scope="module")
def served(request, lm, lora_lm, moe_lm):
    """(the 4-rank world's results, the JAX package's rows): the JAX servers
    run in a thread of this process from the start, while the runs are
    trained and then the world serves in its own processes."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_rows = pool.submit(_jax_rows, lm, lora_lm, moe_lm)
        world = _world(lm, lora_lm, moe_lm, request.getfixturevalue("port_run"),
                       request.getfixturevalue("lora_run"))
        return world, jax_rows.result()


@pytest.fixture(scope="module")
def world(served):
    return served[0]


@pytest.fixture(scope="module")
def jax_rows(served):
    return served[1]


def _world(lm, lora_lm, moe_lm, port_run, lora_run):
    """The 4-rank world's results, by rank: [serve_mesh on each mesh,
    serve_from_run, the error of a mesh larger than the world,
    serve_from_run of the LoRA run with tenants]."""
    cfg = dict(PROGRAM["model"]["config"])
    configs = list(CONFIGS.items()) + _feature_configs(lora_lm[3])
    moe_cfg = {**cfg, "dim": MOE_LM["dim"], "n_experts": MOE_LM["n_experts"]}
    moe = ("moe", BASE, {"model": (moe_cfg, moe_lm[3]), "inline": MOE_BODIES, "http": []})
    cases = [("serve_mesh", dict(model_config=cfg, state=lm[3], mesh_axes=axes,
                                 configs=configs + ([moe] if name == MOE_MESH else []),
                                 inline=INLINE, http=GREEDY))
             for name, axes in MESHES.items()]
    cases.append(("serve_from_run", dict(home=str(port_run[0]), run=port_run[1][:8],
                                         mesh_axes={"data": 2, "model": 2},
                                         inline=FROM_RUN, http=GREEDY[:2])))
    cases.append(("mesh_error", dict(mesh_axes={"model": 8})))
    cases.append(("serve_from_run", dict(home=str(port_run[0]), run=lora_run[:8],
                                         mesh_axes={"model": 4}, inline=TENANT_BODIES,
                                         overrides=_tenancy())))
    cases.append(("serve_error", dict(model_config=cfg, state=lm[3], mesh_axes={"model": 4},
                                      kwargs={**BASE, "speculate": True,
                                              "draft_model": BAD_DRAFT})))
    return run_world(4, cases, timeout=400)


def _jax_rows(lm, lora_lm, moe_lm):
    """The JAX package's servers: greedy rows of INLINE's greedy bodies on
    each mesh (coalesced), their /statsz `mesh` and gauges, and the int8
    rows of the first two (the int8 paged step config); on each mesh too,
    every feature's greedy rows (and the speculative configs' accepted
    drafts) from a server of the same config, the tenants' from one
    without the prefix cache; on MOE_MESH the MoE model's coalesced rows."""
    from polyaxon_tpu.models import build_model as jax_build_model
    from polyaxon_tpu.models.transformer import TRANSFORMER_RULES
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.batching import normalize_mesh_axes as jax_axes
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    module, params = lm[:2]
    features = {name: (kwargs, plan) for name, kwargs, plan in _feature_configs(None)}

    def on(axes):
        server = JaxServer(module, params, model_name="small", sharding_rules=TRANSFORMER_RULES,
                           config=JaxConfig(**BASE, mesh_axes=jax_axes(axes)))
        out = {"rows": [server.generate(b)["tokens"] for b in INLINE[:-1]],
               "mesh": server.stats()["mesh"],
               "metrics": server.telemetry.render_prometheus()}
        for feature, bodies, model in (
            ("beams", BEAMS, lm), ("spec", SPEC_GREEDY, lm), ("draft", SPEC_GREEDY, lm),
            ("tenants", TENANT_BODIES[:2], lora_lm), ("spill", SPILL_BODIES[:1], lm),
        ):
            kwargs = dict(features[feature][0])
            if feature == "tenants":
                kwargs["prefix_cache"] = False  # the reference's cache is not namespaced
            kwargs.pop("spill_ram_bytes", None)
            server = JaxServer(model[0], model[1], model_name="small",
                               sharding_rules=TRANSFORMER_RULES,
                               config=JaxConfig(**kwargs, mesh_axes=jax_axes(axes)))
            out[feature] = [server.generate(b)["tokens"] for b in bodies]
            out[f"{feature}-accepted"] = server.stats()["speculation"]["accepted"]
        if axes == MESHES[MOE_MESH]:
            rules = jax_build_model("transformer_lm", {**MOE_LM}).sharding_rules
            server = JaxServer(moe_lm[0], moe_lm[1], model_name="small", sharding_rules=rules,
                               config=JaxConfig(**BASE, mesh_axes=jax_axes(axes)))
            out["moe"] = [server.generate(b)["tokens"] for b in MOE_BODIES]
        return out

    # one thread a mesh (the compiles release the GIL; each thread binds its
    # own mesh)
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        out = dict(zip(MESHES, pool.map(on, MESHES.values())))
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


def test_moe_rows_equal_the_jax_server_on_the_mesh(world, jax_rows):
    got = _served(world, MOE_MESH)["moe"]
    assert got["inline"] == jax_rows[MOE_MESH]["moe"]
    assert got["sent"]["forward"] > 0 and got["stats_inline"]["mesh"]["axes"] == MESHES[MOE_MESH]


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

    for name, answers in _served(world, mesh).items():
        # the reference's block, and the port's commands by op beside it
        block = dict(answers["stats"]["mesh"])
        commands = block.pop("commands")
        assert block == jax_rows[mesh]["mesh"], name
        assert commands and set(commands) <= set(answers["sent"]), name
        if "metrics" in answers:
            assert gauges(answers["metrics"]) == gauges(jax_rows[mesh]["metrics"])
            assert answers["readyz"][0] == 200


@pytest.mark.parametrize("mesh", list(MESHES))
def test_followers_hold_their_shards_and_follow_every_command(world, lm, mesh):
    whole = sum(v.nbytes for v in lm[3].values())
    model = MESHES[mesh]["model"]
    for name in _served(world, mesh):
        sent = _served(world, mesh)[name]["sent"]
        for rank in range(1, 4):
            commands, shard = world[rank][list(MESHES).index(mesh)][name]
            assert commands == sum(sent.values()) + 1  # and the stop
            if name in CONFIGS and name != "int8":
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


def test_from_run_on_a_mesh_serves_tenants_as_one_device(world, port_run, lora_run):
    """The CLI's path for `serve --mesh ... --adapter`: the LoRA run read
    into slot-stacked shards (lora_a in every slot, lora_b in slot 0), the
    registry's slots filled by commands."""
    one = ModelServer.from_run(lora_run, store=RunStore(port_run[0]),
                               config_overrides=_tenancy(), device="cpu")
    want = [one.generate(b)["tokens"] for b in TENANT_BODIES]
    got = world[0][4]
    assert got["inline"] == want and want[0] != want[1]
    assert got["stats"]["tenancy"]["adapters"]["evictions"] >= 2


def test_a_draft_that_does_not_split_fails_by_name(world):
    """A draft of 2 kv heads on a model axis of 4: every rank refuses it
    by name before any command."""
    want = ("ValueError: the draft model (dim 64, 2 heads, 2 kv heads, ffn 256, vocab 256) "
            "does not split over the decode mesh's model axis of 4: 2 heads do not split "
            "4 ways over the decode mesh's model axis")
    assert [world[rank][5] for rank in range(4)] == [want] * 4


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


@pytest.fixture(scope="module")
def one_device_features(lm):
    """On one device (the port's): the speculative configs' sampled row,
    and the spill drive's demoted payloads."""
    from tests.torch_mesh_workers import _spill_drive

    configs = {name: (kwargs, plan) for name, kwargs, plan in _feature_configs(None)}
    out = {}
    for name in ("spec", "draft"):
        one = ModelServer(torch_lm(*lm[:2]), None, ServingConfig(**configs[name][0]),
                          device="cpu")
        out[name] = one.generate(SPEC_SAMPLED)["tokens"]
        one.stop()
    kwargs, plan = configs["spill"]
    one = ModelServer(torch_lm(*lm[:2]), None, ServingConfig(**kwargs), device="cpu")
    try:
        out["spill"] = _spill_drive(one, plan["http"])
    finally:
        one.stop()
    return out


def _pages_match(got: list, want: list, exact_layers: int) -> None:
    """Payload pages (per page, per leaf in the pool's leaf order: layer_0
    k, [k scale], v, [v scale], layer_1 ...) equal in shape and dtype; the
    first `exact_layers` layers byte for byte, the rest within the rounding
    of a sum over `model`: the o and down projections add partial products
    in another order than one device's product, from the second layer on
    (an int8 payload may then sit one step over; its f32 scale 1e-5)."""
    assert len(got) == len(want)
    for page_got, page_want in zip(got, want):
        per_layer = len(page_want) // 2
        for j, (a, b) in enumerate(zip(page_got, page_want)):
            assert a.shape == b.shape and a.dtype == b.dtype
            if j // per_layer < exact_layers:
                assert a.tobytes() == b.tobytes()
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1.0 if a.dtype == np.int8
                                           else 1e-5)


@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_feature_serves_on_the_mesh_as_the_jax_server(world, jax_rows,
                                                            one_device_features, mesh, feature):
    served = _served(world, mesh)
    ref = jax_rows[mesh]
    if feature == "roles":
        # the mesh prefills and a one-device replica decodes, then the
        # other way round: real handoffs, the direct greedy rows
        want = [ref["rows"][0], ref["rows"][2]]
        for name, exporter, importer in (("roles-prefill", "mesh", "one"),
                                         ("roles-decode", "one", "mesh")):
            got = served[name]
            assert [out["tokens"] for _, out in got["http"]] == want, name
            h = got["handoff"]
            assert h[exporter]["exports"] == 2 and h[exporter]["fallbacks"] == 0, h
            assert h[importer]["imports"] == 2, h
        # the mesh's export is whole pages: a page set it adopted reads back
        # as the bytes the one-device replica shipped
        got = served["roles-decode"]
        assert len(got["exported"]) == len(got["readback"]) == 2
        for sent, back in zip(got["exported"], got["readback"]):
            _pages_match(back, sent, exact_layers=SMALL_LAYERS)
        assert served["roles-prefill"]["sent"]["pages_read"] == 2
        assert got["sent"]["pages_write"] == 2
        return
    got = served[feature]
    sent = got["sent"]
    if feature == "spill":
        rows = [out["tokens"] for _, out in got["http"]]
        assert rows[0] == rows[-1] == ref["spill"][0]
        spill = got["stats"]["kv"]["spill"]
        assert spill["spills"] >= 1 and spill["restores"] >= 1, spill
        assert sent["pages_read"] >= 1 and sent["pages_write"] >= 1
        # the segments are a one-device server's: the same entries, tokens,
        # hashes and leaves, the first layer byte for byte
        one = one_device_features["spill"]["demoted"]
        assert set(got["demoted"]) == set(one)
        for head, (tokens, hashes, pages) in got["demoted"].items():
            assert (tokens, hashes) == one[head][:2]
            _pages_match(pages, one[head][2], exact_layers=1)
        return
    rows = _rows(got)
    if feature == "beams":
        assert got["inline"] == ref["beams"]
        assert sent["reorder"] > 0
        return
    if feature == "tenants":
        acme, globex = ref["tenants"]
        assert rows == [acme, globex, acme] * 2
        assert acme != globex  # the adapters differ: the identity is not vacuous
        adapters = got["stats"]["tenancy"]["adapters"]
        assert adapters["evictions"] >= 4 and adapters["restores"] >= 3, adapters
        assert sent["slot_write"] == adapters["loads"] and sent["slot_read"] >= 4
        return
    # speculation: the greedy rows and the accepted drafts are the
    # reference's; the sampled row is one device's
    assert rows[:2] == rows[2:4] == ref[feature]
    accepted = got["stats_inline"]["speculation"]["accepted"]
    assert accepted == ref[f"{feature}-accepted"] > 0
    assert rows[4] == one_device_features[feature]
    if feature == "draft":
        assert sent["draft_forward"] > 0 and sent["draft_cache"] > 0


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
    assert answer["mesh"].pop("commands")["forward"] > 0
    assert answer["mesh"] == {"enabled": True, "devices": 2, "axes": {"batch": 1, "model": 2}}
    code, body = answer["readyz"]
    assert code == 503 and body["reason"] == "degraded slice: expected 3 devices, found 2"
