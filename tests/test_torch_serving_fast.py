"""The port's fast decode in the batched ModelServer over real HTTP on the
CPU, held against the JAX package's ModelServer config by config.

Configs: speculation (n-gram drafts, K = 3) on the dense, paged and step
paths; a draft model (the config's own defaults: half depth by layer
truncation) with the adaptive controller on the step path; int8 weights
quantized on load with the int8 paged pool on the step path. Each port
server answers two waves of concurrent greedy requests (repetitive
prompts, so drafts are accepted and rejected), and every row must be the
JAX server's tokens for the same body (its inline path, in the same
config; f32, where logits differ by sum order only) and, without int8,
the port's own non-speculative `generate`. A sampled body gives the same
tokens speculating and not; bodies with an eos give the JAX server's
tokens on the paged and step speculative paths. `/statsz` carries the reference's speculation
and quant keys; no KV page leaks; the int8 pool is exactly the formula's
bytes. `numBeams` over HTTP gives the JAX server's beams."""

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch.models.generate import beam_search, generate
from polyaxon_tpu_torch.models.quant import kv_pool_bytes
from polyaxon_tpu_torch.serving.batching import ServingConfig, normalize_draft_model
from polyaxon_tpu_torch.serving.server import ModelServer
from tests.test_torch_serving_batch import (
    BASE, CONFIGS, assert_no_leak, concurrent, get, lm, post,  # noqa: F401
)

NEW = 8
SPEC = {"speculate": True, "draft_tokens": 3}
FAST = {
    "spec-dense": {**CONFIGS["dense"], **SPEC},
    "spec-paged": {**CONFIGS["paged"], **SPEC},
    "spec-step": {**CONFIGS["step"], **SPEC},
    "draft-step": {**CONFIGS["step"], **SPEC, "draft_model": (), "adaptive_draft": True},
    "int8-step": {**CONFIGS["step"], "quantize": True, "kv_quant": "int8"},
}


def prompts(seed, n=4):
    """Repetitive prompts of several lengths; half share one page-aligned
    prefix (the same in every wave)."""
    rng = np.random.default_rng(seed)
    shared = np.tile(np.random.default_rng(100).integers(1, 256, 4), 4).tolist()
    out = []
    for i in range(n):
        motif = rng.integers(1, 256, int(rng.integers(2, 5))).tolist()
        own = (motif * 6)[: int(rng.integers(4, 13))]
        out.append(shared + own if i % 2 == 0 else own)
    return out


def bodies(seed):
    return [{"tokens": [p], "maxNewTokens": NEW} for p in prompts(seed)]


def start(lm, config):  # noqa: F811
    server = ModelServer(lm[2], None, ServingConfig(**{**BASE, **config}), device="cpu")
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


def jax_server(lm, config):  # noqa: F811
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    return JaxServer(lm[0], lm[1], model_name="small", config=JaxConfig(**{**BASE, **config}))


@pytest.fixture(scope="module", params=list(FAST))
def fast(request, lm):  # noqa: F811
    name = request.param
    waves = [bodies(seed=20), bodies(seed=21)]
    server, url = start(lm, FAST[name])
    try:
        answers = [concurrent(url, wave) for wave in waves]
        stats = get(url, "/statsz")
    finally:
        server.stop()
    ref_server = jax_server(lm, FAST[name])
    ref = [ref_server.generate(b)["tokens"] for b in waves[0] + waves[1]]
    yield name, server, waves, answers, stats, ref, ref_server.stats()


def test_fast_configs_match_jax_server(fast, lm):  # noqa: F811
    name, server, waves, answers, stats, ref, _ = fast
    got = [a for wave in answers for a in wave]
    assert all(code == 200 for code, _ in got), got
    assert [out["tokens"] for _, out in got] == ref
    if name != "int8-step":
        for body, (_, out) in zip(waves[0] + waves[1], got):
            direct = generate(lm[2], torch.tensor(body["tokens"]), max_new_tokens=NEW)
            assert out["tokens"] == direct.tolist()
    if server.stats()["kv"]["enabled"]:
        assert_no_leak(server)


def test_fast_statsz_matches_jax_keys(fast):
    name, server, _, _, stats, _, ref_stats = fast
    spec, ref_spec = stats["speculation"], ref_stats["speculation"]
    assert set(spec) == set(ref_spec)
    assert set(stats["quant"]) == set(ref_stats["quant"])
    assert spec["enabled"] is ref_spec["enabled"]
    if name.startswith(("spec", "draft")):
        assert spec["proposed"] > 0 and spec["accepted"] > 0
        assert spec["proposed"] == spec["accepted"] + spec["rollbacks"]
    if name == "draft-step":
        assert spec["draft_model"] == ref_spec["draft_model"] == {"n_layers": 1,
                                                                   "derived": True}
        assert spec["adaptive"] and set(spec["controller"]) == set(ref_spec["controller"])
    if name == "int8-step":
        assert stats["quant"] == ref_stats["quant"]
        cfg = server.module.cfg
        kv = stats["kv"]
        assert kv["kv_quant"] == "int8" and kv["kv_pool_bytes"] == ref_stats["kv"]["kv_pool_bytes"]
        assert kv["kv_pool_bytes"] == kv_pool_bytes(server._kv.layout, cfg.n_layers,
                                                    cfg.n_kv_heads, cfg.head_dim)
        live = sum(t.numel() * t.element_size() for layer in server._kv.cache for t in layer)
        assert kv["kv_pool_bytes"] == live


def test_sampled_speculation_equals_plain_sampling(lm):  # noqa: F811
    """Sampled rows (per-row seeds 5 and 6): the step path speculating with
    n-gram drafts, with the draft model, and not speculating."""
    p = prompts(seed=22, n=1)[0]
    body = {"tokens": [p, p[::-1]], "maxNewTokens": NEW, "temperature": 0.8,
            "topK": 40, "seed": 5}
    outs = []
    for config in (FAST["spec-step"], FAST["draft-step"], CONFIGS["step"], FAST["spec-dense"],
                   FAST["spec-paged"]):
        server, url = start(lm, config)
        try:
            code, out = post(url, body)
            assert code == 200, out
            outs.append(out["tokens"])
        finally:
            server.stop()
    assert outs[0] == outs[1] == outs[2] == outs[3] == outs[4]
    direct = generate(lm[2], torch.tensor([p]), max_new_tokens=NEW, temperature=0.8,
                      top_k=40, seed=[5])
    assert outs[0][0] == direct[0].tolist()


@pytest.mark.parametrize("name", ["spec-paged", "spec-step"])
def test_speculation_with_eos_matches_jax(lm, name):  # noqa: F811
    """Greedy rows with an eos that one row really emits: the paged group
    and the step lane latch and pin it as the JAX server and the plain
    generate do."""
    body_rows = prompts(seed=24, n=3)
    free = generate(lm[2], torch.tensor([body_rows[0]]), max_new_tokens=NEW)[0].tolist()
    eos = free[len(body_rows[0]) + 2]
    bodies = [{"tokens": [p], "maxNewTokens": NEW, "eosId": eos} for p in body_rows]
    server, url = start(lm, FAST[name])
    try:
        got = concurrent(url, bodies)
    finally:
        server.stop()
    assert all(code == 200 for code, _ in got), got
    ref_server = jax_server(lm, FAST[name])
    for body, (_, out) in zip(bodies, got):
        assert out["tokens"] == ref_server.generate(body)["tokens"]
        direct = generate(lm[2], torch.tensor(body["tokens"]), max_new_tokens=NEW, eos_id=eos)
        assert out["tokens"] == direct.tolist()
    assert got[0][1]["tokens"][0][len(body_rows[0]) + 3:] == [eos] * (NEW - 3)
    assert_no_leak(server)


def test_beams_over_http_match_jax(lm):  # noqa: F811
    p = prompts(seed=23, n=2)
    server, url = start(lm, CONFIGS["step"])
    ref_server = jax_server(lm, CONFIGS["step"])
    try:
        free = beam_search(lm[2], torch.tensor([p[1]]), max_new_tokens=NEW,
                           num_beams=4)[0].tolist()
        for body in (
            {"tokens": [p[0], p[0][::-1]], "maxNewTokens": NEW, "numBeams": 4},
            {"tokens": [p[1]], "maxNewTokens": NEW, "numBeams": 4,
             "eosId": free[len(p[1]) + 2], "lengthPenalty": 1.4},
        ):
            code, out = post(url, body)
            assert code == 200, out
            assert out["tokens"] == ref_server.generate(body)["tokens"]
            direct = beam_search(
                lm[2], torch.tensor(body["tokens"]), max_new_tokens=NEW, num_beams=4,
                eos_id=body.get("eosId"), length_penalty=body.get("lengthPenalty", 1.0))
            assert out["tokens"] == direct.tolist()
        code, one = post(url, {"tokens": [p[1]], "maxNewTokens": NEW, "numBeams": 1})
        assert one["tokens"] == generate(lm[2], torch.tensor([p[1]]),
                                         max_new_tokens=NEW).tolist()
        code, out = post(url, {"tokens": [p[1]], "maxNewTokens": NEW, "numBeams": 33})
        assert code == 400 and "numBeams" in out["error"]
        assert_no_leak(server)
    finally:
        server.stop()


def test_cross_field_rules_match_the_reference(lm):  # noqa: F811
    with pytest.raises(ValueError, match="kv_pool_pages"):
        ModelServer(lm[2], None, ServingConfig(kv_quant="int8"), device="cpu")
    for extra in ({"draft_model": ()}, {"adaptive_draft": True}):
        with pytest.raises(ValueError, match="speculate"):
            ModelServer(lm[2], None, ServingConfig(**extra), device="cpu")
    assert normalize_draft_model({"n_layers": 1, "x": [1, 2]}) == (("n_layers", 1),
                                                                  ("x", (1, 2)))
    assert normalize_draft_model({}) == () and normalize_draft_model(None) is None
