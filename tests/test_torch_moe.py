"""The port's switch-MoE feed-forward and the transformer with `n_experts`
against the JAX package's, on the CPU, from the same weights.

- `MoEFeedForward` alone: the output, the sown balance loss and the
  gradients within 1e-5 relative (f32, sum order only), with tokens
  overflowing their expert's capacity (zeros on both sides), and with
  exact argmax ties (a zero router), which go to the first expert;
- the transformer with `n_experts: 4` (2 layers): logits within 1e-4 (the
  transformer tests' tolerance), the aux loss summed over layers within
  1e-6 relative, gradients within 1e-4 relative Frobenius; dense
  `generate` gives identical greedy tokens on a left-padded batch;
- the paged pool, int8 projections and every batched serving path take
  an MoE model (`tests/test_torch_serving_moe.py` holds them against the
  JAX server).

`router_noise` is held at 0: its draws come from `jax.random` there and a
torch generator here (ROADMAP.md, Queue C record 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from polyaxon_tpu.models import build_model as jax_build_model
from polyaxon_tpu.models.generate import generate as jax_generate
from polyaxon_tpu.models.moe import MoEFeedForward as JaxMoE

from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.models.generate import generate, make_paged_cache
from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
from polyaxon_tpu_torch.models.layers import collecting
from polyaxon_tpu_torch.models.moe import MoEFeedForward
from polyaxon_tpu_torch.models.quant import quantize_module
from polyaxon_tpu_torch.models.transformer import Transformer, _make_config
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.server import ModelServer

MOE_LM = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256, seq_len=64,
              n_experts=4, capacity_factor=1.0, attention="xla")


def _redraw(tree, seed):
    """Every weight redrawn from a numpy seed: kernels N(0, 1/fan_in) with
    fan_in the input axis (axis 1 of an expert stack [E, in, out]), norm
    scales 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        if a.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        fan_in = a.shape[1] if a.ndim == 3 else a.shape[0]
        return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, tree)


def _moe_pair(S=16, zero_router=False, **kw):
    jmod = JaxMoE(dim=32, ffn_dim=48, n_experts=4, **kw)
    x = np.random.default_rng(5).standard_normal((2, S, 32)).astype(np.float32)
    params = _redraw(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                                      jnp.asarray(x)))["params"], 1)
    if zero_router:
        params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    ours = MoEFeedForward(32, 48, 4, **kw)
    ours.load_state_dict(params_from_jax(params, None))
    return jmod, params, ours, x


def _run_moe(jmod, params, ours, x):
    def loss(p):
        out, sown = jmod.apply({"params": p}, jnp.asarray(x), train=True,
                               mutable=["losses"])
        aux = sown["losses"]["moe_aux"][0]
        return (out ** 2).mean() + aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ours.train()
    with collecting() as box:
        got = ours(torch.from_numpy(x))
    ours_aux = box.aux_loss("cpu")
    ((got ** 2).mean() + ours_aux).backward()
    return (np.asarray(out), float(aux), jax.tree.map(np.asarray, grads),
            got.detach().numpy(), float(ours_aux.detach()))


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0], ids=["overflow", "roomy"])
def test_moe_matches_jax(capacity_factor):
    jmod, params, ours, x = _moe_pair(capacity_factor=capacity_factor)
    out, aux, grads, got, got_aux = _run_moe(jmod, params, ours, x)
    assert _rel(got, out) < 1e-5
    assert abs(got_aux - aux) <= 1e-6 * abs(aux)
    want = params_from_jax(grads, None)
    for name, p in ours.named_parameters():
        assert (p.grad - want[name]).abs().max() <= 1e-5 * want[name].abs().max(), name
    dropped = (np.abs(out).sum(-1) == 0)  # tokens past their expert's capacity
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0, dropped)
    assert dropped.any() == (capacity_factor == 1.0)


def test_capacity_and_argmax_ties():
    """A zero router ties every expert: all tokens go to expert 0 (the first
    index, as jnp.argmax), the first C of each row are kept and the rest
    get zeros, on both sides."""
    moe = MoEFeedForward(8, 8, 4, capacity_factor=1.25)
    assert [moe.capacity(s) for s in (1, 3, 16, 2048)] == [1, 1, 5, 640]
    jmod, params, ours, x = _moe_pair(zero_router=True, capacity_factor=1.0)
    out, aux, _, got, got_aux = _run_moe(jmod, params, ours, x)
    C = ours.capacity(16)
    kept = np.abs(got).sum(-1) != 0
    assert (kept[:, :C]).all() and not kept[:, C:].any()
    assert _rel(got, out) < 1e-5
    # every token on expert 0 with probability 1/E: aux = 0.01 * E * (1 * 1/E)
    assert got_aux == pytest.approx(0.01) and aux == pytest.approx(0.01)


@pytest.fixture(scope="module")
def lm_pair():
    bundle = jax_build_model("transformer_lm", dict(MOE_LM))
    shapes = jax.eval_shape(lambda: bundle.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), train=False))
    params = _redraw(shapes["params"], 2)
    cfg = _make_config(dict(MOE_LM))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg))
    return bundle, params, model.eval()


def test_transformer_with_experts_matches_jax(lm_pair):
    bundle, params, model = lm_pair
    assert bundle.aux_losses
    toks = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(np.int32)

    def loss(p):
        logits, sown = bundle.module.apply({"params": p}, jnp.asarray(toks), train=True,
                                           mutable=["losses"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(sown))
        return (logits ** 2).mean() + aux, (logits, aux)

    (_, (logits, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model.train()
    with collecting() as box:
        ours = model(torch.from_numpy(toks).long())
    ours_aux = box.aux_loss("cpu")
    ((ours ** 2).mean() + ours_aux).backward()
    model.eval()
    assert len(box.losses) == MOE_LM["n_layers"]
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(logits), atol=1e-4, rtol=1e-4)
    assert float(ours_aux.detach()) == pytest.approx(float(aux), rel=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, grads), model.cfg)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want) and "layers.0.moe.gate_kernel" in got
    num = sum(((got[k] - want[k]) ** 2).sum() for k in want)
    den = sum((want[k] ** 2).sum() for k in want)
    assert (num / den).sqrt() < 1e-4
    model.zero_grad(set_to_none=True)


def test_dense_generate_with_experts_identical(lm_pair):
    bundle, params, model = lm_pair
    prompt = np.random.default_rng(4).integers(0, 256, (3, 10)).astype(np.int32)
    lengths = np.array([10, 4, 7], np.int32)
    for b, n in enumerate(lengths):
        prompt[b, : 10 - n] = 0
    ref = jax_generate(bundle.module, params, jnp.asarray(prompt), max_new_tokens=8,
                       prompt_lengths=lengths)
    out = generate(model, torch.from_numpy(prompt), max_new_tokens=8,
                   prompt_lengths=lengths)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_serving_paths_refuse_experts(lm_pair):
    """No serving path refuses experts any longer: the paged pool's prefill
    gives the dense cache's logits, int8 quantizes the attention
    projections, and every batched config serves the rows of the per-request
    path for an unpadded body (tests/test_torch_serving_moe.py holds each
    path against the JAX server)."""
    _, _, model = lm_pair
    layout = PagedKVLayout(pool_pages=4, page_tokens=8)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (1, 16))).long()
    pad = torch.zeros(1, dtype=torch.long)
    with torch.no_grad():
        paged = model(toks, cache=make_paged_cache(model, layout), pos=0, pad=pad,
                      pages=torch.tensor([[1, 2]]), kv_layout=layout)
        dense = model(toks, cache=model.make_cache(1), pos=0, pad=pad)
    torch.testing.assert_close(paged, dense, rtol=1e-6, atol=1e-6)
    q, saved = quantize_module(model)
    assert saved > 0 and q.cfg.quant == "int8" and q.cfg.n_experts == 4
    assert Transformer(_make_config({**MOE_LM, "quant": "int8"}), device="cpu").cfg.n_experts
    body = {"tokens": [toks[0, :8].tolist()], "maxNewTokens": 4}
    want = ModelServer(model, None, ServingConfig(batching=False), device="cpu").generate(body)
    for config in (ServingConfig(max_batch=1), ServingConfig(kv_pool_pages=8),
                   ServingConfig(batching=False, quantize=True)):
        served = ModelServer(model, None, config, device="cpu")
        assert served.module.cfg.n_experts == 4
        if not config.quantize:
            assert served.generate(body) == want
    # an inference forward sows nothing (no collection is open, none is left
    # behind); inside `collecting()` each layer's aux loss is collected once
    from polyaxon_tpu_torch.models import layers

    assert layers._box() is None
    with torch.no_grad(), collecting() as box:
        model(toks)
    assert len(box.losses) == MOE_LM["n_layers"] and layers._box() is None
