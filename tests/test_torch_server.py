"""The port's ModelServer on the CPU over real HTTP: /healthz, /generate
answering exactly what a direct `generate` call gives (and what the JAX
package's greedy decode gives), and 400 on bad bodies."""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.generate import generate as jax_generate
from polyaxon_tpu_torch.models.generate import generate
from polyaxon_tpu_torch.serving.batching import ServingConfig, ServingError
from polyaxon_tpu_torch.serving.server import ModelServer
from tests.test_torch_transformer import jax_lm, tokens, torch_lm


@pytest.fixture(scope="module")
def served():
    module, params = jax_lm({"attention": "xla"})
    model = torch_lm(module, params)
    # the server takes the JAX package's param tree as it is
    server = ModelServer(model, params, ServingConfig(max_batch=4), device="cpu")
    port = server.start("127.0.0.1", 0)
    try:
        yield server, f"http://127.0.0.1:{port}", module, params
    finally:
        server.stop()


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(served):
    _, url, _, _ = served
    assert _call(url + "/healthz") == (
        200, {"status": "ok", "model": "transformer_lm", "step": 0}
    )


def test_generate_over_http_equals_direct_generate(served):
    server, url, module, params = served
    prompt = tokens(B=2, S=7, seed=6)
    body = {"tokens": prompt.tolist(), "maxNewTokens": 5}
    code, out = _call(url + "/generate", body)
    assert code == 200
    direct = generate(server.module, torch.from_numpy(prompt), max_new_tokens=5)
    assert out["tokens"] == direct.tolist()
    ref = jax_generate(module, params, jnp.asarray(prompt), max_new_tokens=5)
    assert out["tokens"] == np.asarray(ref).tolist()
    # the batched path (the default) gives row i the per-row stream of
    # seed + i, as the reference's coalescer does
    sampled = {**body, "temperature": 0.8, "topK": 20, "seed": 4, "eosId": 3}
    code, out = _call(url + "/generate", sampled)
    assert code == 200
    assert out["tokens"] == generate(
        server.module, torch.from_numpy(prompt), max_new_tokens=5,
        temperature=0.8, top_k=20, seed=[4, 5], eos_id=3,
    ).tolist()


@pytest.mark.parametrize(
    "body",
    [
        {},
        {"tokens": []},
        {"tokens": [[1, 2], [3]]},
        {"tokens": [[1, 256]]},
        {"tokens": [[-1]]},
        {"tokens": [[1]], "maxNewTokens": 0},
        {"tokens": [[1]], "maxNewTokens": "many"},
        {"tokens": [[1] * 120], "maxNewTokens": 9},
        {"tokens": [[1]] * 5},
        {"tokens": [[1]], "temperature": "hot"},
        {"tokens": [[1]], "eosId": 256},
        {"tokens": [[1]], "numBeams": 0},
        [1, 2],
    ],
    ids=["empty", "no-rows", "ragged", "id-too-big", "id-negative", "zero-new",
         "new-not-int", "past-seq-len", "too-many-rows", "temp-not-number",
         "eos-out-of-range", "beams", "not-object"],
)
def test_bad_bodies_are_400(served, body):
    server, url, _, _ = served
    code, out = _call(url + "/generate", body)
    assert code == 400 and out["reason"] == "invalid_request", out
    with pytest.raises(ServingError):
        server.generate(body)


def test_unknown_routes_are_404(served):
    _, url, _, _ = served
    assert _call(url + "/nope")[0] == 404
    assert _call(url + "/nope", {"tokens": [[1]]})[0] == 404
