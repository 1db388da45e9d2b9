"""An MoE model (`n_experts: 4`, top-1 switch routing) on every batched
serving path of the port, on the CPU in f32.

The reference's `MoEFeedForward` has no pad mask and takes its capacity
per row from the S of each forward, so a served MoE row depends on its
bucket's padding, its prefill chunks, a prefix hit's suffix forward and a
verify window's width: it is held against the JAX package's ModelServer
in the same config, never against an unpadded `generate`. Both servers
answer the same bodies over HTTP one at a time (so each group and each
step holds one request, and the routing is a function of the body):

- the coalescer, the paged pool with the prefix cache (the second body
  hits the first one's pages), the step scheduler (8-token chunks, the
  prompts end in a ragged chunk), n-gram and draft speculation on the
  step path, int8 weights (q/k/v/o only: the router and the experts stay
  f32) with the int8 pool, and `numBeams: 2` inline;
- the paged prefill's logits against the JAX forward within 1e-4 (the
  transformer tests' tolerance).

Adapters (two tenants in one slot), the spill tier, the prefill/decode
handoff and a `{model: 2}` decode mesh (the step and int8 configs) are
held against the port's own one-device MoE server, token for token. Their prefill chunks equal the
page size, so a prefix hit's suffix forward is the chunk a cold prefill
runs there. Every server leaves no page behind."""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from polyaxon_tpu_torch.models.generate import make_paged_cache
from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.router import P2CBalancer, Router
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.serving.tenancy import normalize_adapters, normalize_tenants
from tests.test_torch_handoff import _router, drained
from tests.test_torch_serving_batch import BASE, assert_no_leak, post
from tests.test_torch_transformer import LOGIT_TOL, jax_lm, torch_lm
from tests.torch_mesh_workers import run_world

pytestmark = pytest.mark.serving

MOE = {"attention": "xla", "dim": 32, "n_experts": 4}  # 2 layers, 4/2 heads, vocab 256
NEW = 6
PAGED = {**BASE, "kv_pool_pages": 64, "kv_page_tokens": 8}
STEP = {**PAGED, "chunked_prefill": True, "prefill_chunk_tokens": 8, "max_step_tokens": 32}
SPEC = {"speculate": True, "draft_tokens": 3}
PATHS = {
    "coalescer": BASE,
    "paged": PAGED,
    "step": STEP,
    "ngram": {**STEP, **SPEC},
    "draft": {**STEP, **SPEC, "draft_model": ()},
    "int8": {**STEP, "quantize": True, "kv_quant": "int8"},
}


def _prompts():
    """Two repetitive prompts (drafts are accepted and rejected) of 21 and
    27 tokens: ragged last chunks; the second shares the first's two full
    pages."""
    rng = np.random.default_rng(11)
    shared = (rng.integers(1, 256, 3).tolist() * 6)[:16]
    return [shared + (rng.integers(1, 256, 2).tolist() * 3)[:5],
            shared + (rng.integers(1, 256, 4).tolist() * 3)[:11]]


PROMPTS = _prompts()
BODIES = [{"tokens": [p], "maxNewTokens": NEW} for p in PROMPTS]


@pytest.fixture(scope="module")
def moe():
    module, params = jax_lm(MOE)
    return module, params, torch_lm(module, params)


def _port(model, config):
    server = ModelServer(model, None, ServingConfig(**config), model_name="small", device="cpu")
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


def _sequential(url, bodies):
    out = []
    for body in bodies:
        code, answer = post(url, body)
        assert code == 200, answer
        out.append(answer["tokens"])
    return out


def _jax_rows(moe, config):
    """The JAX server's rows of BODIES over HTTP, one at a time."""
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    ref = JaxServer(moe[0], moe[1], model_name="small", config=JaxConfig(**config))
    ref_url = f"http://127.0.0.1:{ref.start('127.0.0.1', 0)}"
    try:
        return _sequential(ref_url, BODIES)
    finally:
        ref.stop()


@pytest.fixture(scope="module", params=list(PATHS))
def served(request, moe):
    """The port's rows and stats beside the JAX server's rows, the JAX side
    on a thread of its own (its compiles release the GIL)."""
    name = request.param
    with ThreadPoolExecutor(1) as pool:
        want = pool.submit(_jax_rows, moe, PATHS[name])
        server, url = _port(moe[2], PATHS[name])
        try:
            rows = _sequential(url, BODIES)
            stats = server.stats()
        finally:
            server.stop()
        return name, server, rows, stats, want.result()


def test_moe_rows_equal_the_jax_server(served):
    name, server, rows, stats, want = served
    assert rows == want, name
    if name != "coalescer":
        assert stats["kv"]["prefix"]["hits"] >= 1
        assert_no_leak(server)
    if name in ("ngram", "draft"):
        assert stats["speculation"]["proposed"] > 0
    if name == "int8":
        assert stats["quant"]["enabled"] and stats["kv"]["kv_quant"] == "int8"
    if name in ("step", "int8"):
        assert stats["chunked"]["prefill_chunks"] >= 2 * len(BODIES)


def test_moe_int8_quantizes_attention_only(moe):
    """q/k/v/o become int8; the router and the stacked expert kernels keep
    the checkpoint's precision, as the reference's QUANT_TARGETS do."""
    from polyaxon_tpu_torch.models.quant import Int8Linear, decode_weight_bytes, quantize_module

    q, saved = quantize_module(moe[2])
    int8 = {n for n, m in q.named_modules() if isinstance(m, Int8Linear)}
    assert int8 == {f"layers.{i}.attention.{p}_proj" for i in range(2) for p in "qkvo"}
    block = q.layers[0].moe
    assert block.gate_kernel.dtype == block.router.weight.dtype == torch.float32
    target, total = decode_weight_bytes(moe[2])
    experts = sum(p.numel() * 4 for n, p in moe[2].named_parameters() if "moe." in n)
    assert total == sum(v.numel() * 4 for v in moe[2].state_dict().values())
    assert total - target >= experts > 0
    attn = sum(p.numel() * 4 for n, p in moe[2].named_parameters() if "attention." in n
               and n.endswith("_proj.weight"))
    assert target == attn and saved == attn - attn // 4 - 4 * sum(
        m.scale.numel() for m in q.modules() if isinstance(m, Int8Linear))


def test_moe_beams_equal_the_jax_server(moe):
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    body = {"tokens": [PROMPTS[0], PROMPTS[1][:21]], "maxNewTokens": NEW, "numBeams": 2}
    ours = ModelServer(moe[2], None, ServingConfig(**STEP), device="cpu").generate(body)
    ref = JaxServer(moe[0], moe[1], model_name="small", config=JaxConfig(**STEP))
    assert ours["tokens"] == ref.generate(body)["tokens"]


def test_moe_paged_prefill_logits_match_jax(moe):
    import jax
    import jax.numpy as jnp

    module, params, model = moe
    toks = np.asarray([PROMPTS[0][:16], PROMPTS[1][5:21]], np.int32)
    want = np.asarray(jax.jit(lambda p, t: module.apply({"params": p}, t, train=False))(
        params, jnp.asarray(toks)))
    layout = PagedKVLayout(pool_pages=8, page_tokens=8)
    cache = make_paged_cache(model, layout)
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long(), cache=cache, pos=0,
                    pad=torch.zeros(2, dtype=torch.long),
                    pages=torch.tensor([[1, 2], [3, 4]]), kv_layout=layout)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


# ----------------------------------- held against the port's one device
ADAPTERS = {"acme": "seed:1", "globex": "seed:2"}


def _tenancy(adapters, **extra):
    return {**STEP, "adapters": normalize_adapters(adapters),
            "tenants": normalize_tenants([{"name": n, "adapter": n} for n in adapters]),
            **extra}


def test_moe_tenants_in_one_slot_equal_solo_servers():
    """Two adapters through one slot (every switch evicts the idle one):
    each tenant's rows are those of a server holding only its adapter."""
    module, params = jax_lm({**MOE, "lora_rank": 4})
    model = torch_lm(module, params)
    bodies = [{**BODIES[i % 2], "tenant": t}
              for i, t in enumerate(("acme", "globex", "acme", "globex"))]
    server, url = _port(model, _tenancy(ADAPTERS, adapter_slots=1))
    try:
        got = _sequential(url, bodies)
        assert server.stats()["tenancy"]["adapters"]["evictions"] >= 2
        assert_no_leak(server)
    finally:
        server.stop()
    for tenant in ADAPTERS:
        solo, solo_url = _port(model, _tenancy({tenant: ADAPTERS[tenant]}))
        try:
            mine = [b for b in bodies if b["tenant"] == tenant]
            want = _sequential(solo_url, mine)
        finally:
            solo.stop()
        assert [g for g, b in zip(got, bodies) if b["tenant"] == tenant] == want, tenant
    assert got[0] != got[1]


def test_moe_spilled_prefix_restores_to_the_warm_rows(moe):
    """A flood evicts the target's prefix into the spill tier; the target
    again restores it and answers what a pool that never evicted it
    answers (both take the same prefix hit)."""
    rng = np.random.RandomState(0)
    target, *flood = [rng.randint(1, 100, size=41).tolist() for _ in range(6)]
    bodies = [{"tokens": [t], "maxNewTokens": NEW} for t in [target, *flood, target]]
    small = {**STEP, "kv_pool_pages": 20, "spill_ram_bytes": 32 << 20}
    server, url = _port(moe[2], small)
    try:
        got = _sequential(url, bodies)
        spill = server.stats()["kv"]["spill"]
        assert spill["restores"] >= 1, spill
        assert_no_leak(server)
    finally:
        server.stop()
    warm, warm_url = _port(moe[2], STEP)
    try:
        want = _sequential(warm_url, bodies)
    finally:
        warm.stop()
    assert got == want


def test_moe_handoff_equals_one_device(moe):
    """The router over a prefill and a decode replica: the decode replica
    adopts the exported pages and answers a monolithic server's tokens."""
    pool = {**STEP, "max_wait_ms": 2.0}
    pre, pre_url = _port(moe[2], {**pool, "role": "prefill"})
    dec, dec_url = _port(moe[2], {**pool, "role": "decode"})
    direct, direct_url = _port(moe[2], pool)
    router, url = _router(Router, P2CBalancer(seed=7), [pre_url, dec_url])
    try:
        got = _sequential(url, BODIES)
        assert got == _sequential(direct_url, BODIES)
        assert pre.stats()["handoff"]["exports"] >= 1
        assert dec.stats()["handoff"]["imports"] >= 1
        drained(pre_url)
        drained(dec_url)
    finally:
        for s in (router, pre, dec, direct):
            s.stop()


MESH_CONFIGS = {"step": STEP, "int8": PATHS["int8"]}


def test_moe_on_a_model_mesh_equals_one_device(moe):
    """A `{model: 2}` decode mesh of two gloo ranks (each expert's hidden
    units split over `model`) against the port's one-device server."""
    model = moe[2]
    cfg = json.loads(json.dumps({k: v for k, v in vars(model.cfg).items()
                                 if not isinstance(v, tuple)}))
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    configs = [(name, kwargs, {"inline": [], "http": BODIES, "sequential": True})
               for name, kwargs in MESH_CONFIGS.items()]
    world = run_world(2, [("serve_mesh", dict(model_config=cfg, state=state,
                                              mesh_axes={"model": 2}, configs=configs))],
                      timeout=300)
    for name, kwargs in MESH_CONFIGS.items():
        one, url = _port(model, kwargs)
        try:
            want = _sequential(url, BODIES)
        finally:
            one.stop()
        answers = world[0][0][name]["http"]
        assert [out["tokens"] for _, out in answers] == want, name
        commands, shard = world[1][0][name]
        assert commands == sum(world[0][0][name]["sent"].values()) + 1
