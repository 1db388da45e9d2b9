"""The port's int8 weight-only quantization and int8 KV pool against the
JAX package's `models/quant.py`, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides. What is
held, with its tolerance:
- `quantize_kernel` / `quantize_kv`: the int8 payloads are byte-equal (the
  port's [out, in] weight is the reference's [in, out] kernel transposed)
  and the scales within 1e-7 relative (f32, the same formula);
- `Int8Linear` (its plain version on the CPU) within 1e-5 of `Int8Dense`
  (f32 sums in another order);
- `quantize_module`'s saved bytes and `decode_weight_bytes` are equal
  integers on both sides, with the LoRA base quantized and the adapters
  kept at checkpoint precision;
- `kv_pool_bytes` is equal on both sides and equals the port's live pool;
- the quantized transformer's logits (full sequence and paged decode on
  the int8 pool) within 1e-4 of the JAX quantized module's, both holding
  the reference's quantized tree (`params_from_jax`), whose int8 payloads
  equal the port's own `quantize_module` output byte for byte;
- on the int8 pool, chunked prefill leaves the same payload bytes and
  tokens as one-shot prefill; the scales agree within 1e-6 relative (from
  layer 1 on the K/V themselves differ by f32 sum order between the two
  shapes, as the fp pool's do in test_torch_paged_generate.py)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import quant as jq
from polyaxon_tpu.models.kv_pages import PagedKVLayout as JLayout
from polyaxon_tpu_torch.models import quant as tq
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
from polyaxon_tpu_torch.models.transformer import Transformer, _make_config
from polyaxon_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference
from tests.test_torch_transformer import LOGIT_TOL, SMALL, jax_lm, torch_lm

jgen = importlib.import_module("polyaxon_tpu.models.generate")
tgen = importlib.import_module("polyaxon_tpu_torch.models.generate")
SCALE_RTOL = 1e-7
LINEAR_TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    module, params = jax_lm({"attention": "xla"})
    return module, params, torch_lm(module, params)


@pytest.fixture(scope="module")
def quantized(pair):
    """(JAX int8 module, its quantized tree, the port's module holding that
    tree, the port's own quantize_module of the fp model, its bytes saved,
    the reference's bytes saved)."""
    module, params, model = pair
    jmod, jparams, jsaved = jq.quantize_module(module, params)
    jparams = {k: np.asarray(v) if not hasattr(v, "items") else v
               for k, v in jparams.items()}
    cfg = _make_config({**SMALL, "quant": "int8"})
    ported = Transformer(cfg, device="cpu")
    ported.load_state_dict(params_from_jax(_np(jparams), cfg))
    own, saved = tq.quantize_module(model)
    return jmod, jparams, ported.eval(), own, saved, jsaved


def _np(tree):
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 40)], ids=["2d", "stacked"])
def test_quantize_kernel_bytes_equal_jax(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[-1])).astype(np.float32)
    w[..., 0, 1] = 0.0  # an all-but-zero column keeps its 1e-8 floor path honest
    q_ref, s_ref = (np.asarray(a) for a in jq.quantize_kernel(jnp.asarray(w)))
    q, s = tq.quantize_kernel(torch.from_numpy(np.swapaxes(w, -1, -2).copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(q.numpy(), -1, -2), q_ref)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=SCALE_RTOL, atol=0)


def test_quantize_kv_bytes_equal_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 3, 16)) * 4).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero vector: scale 1e-8 / 127, payload 0
    q_ref, s_ref = (np.asarray(a) for a in jq.quantize_kv(jnp.asarray(x)))
    q, s = tq.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=SCALE_RTOL, atol=0)
    back = tq.dequantize_kv(q, s)
    np.testing.assert_allclose(back.numpy(), np.asarray(jq.dequantize_kv(q_ref, s_ref)),
                               rtol=SCALE_RTOL, atol=0)


def test_int8_linear_matches_int8_dense():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((48, 32)).astype(np.float32) / 7
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    kernel, scale = jq.quantize_kernel(jnp.asarray(w))
    ref = jq.Int8Dense(32).apply({"params": {"kernel": kernel, "scale": scale}},
                                 jnp.asarray(x))
    lin = tq.Int8Linear(48, 32, device="cpu")
    lin.weight.copy_(torch.from_numpy(np.asarray(kernel).T.copy()))
    lin.scale.copy_(torch.from_numpy(np.array(scale)))
    out = lin(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (2, 5, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LINEAR_TOL, rtol=LINEAR_TOL)
    # bf16 activations: the sum stays f32, one rounding to bf16 at the end
    xb = torch.from_numpy(x).bfloat16()
    want = int8_matmul_reference(xb, lin.weight, lin.scale)
    assert lin(xb).dtype == torch.bfloat16 and torch.equal(lin(xb), want)
    assert torch.equal(int8_matmul(xb, lin.weight, lin.scale), want)


def test_int8_matmul_refuses_bad_inputs():
    w = torch.zeros(8, 16, dtype=torch.int8)
    s = torch.ones(8)
    from polyaxon_tpu_torch.ops.int8_matmul import INT8_MATMUL
    with pytest.raises(TypeError):
        INT8_MATMUL(torch.zeros(2, 16, dtype=torch.float16), w, s)
    with pytest.raises(TypeError):
        INT8_MATMUL(torch.zeros(2, 16), w.float(), s)
    with pytest.raises(ValueError, match="shapes"):
        INT8_MATMUL(torch.zeros(2, 15), w, s)
    with pytest.raises(ValueError, match="K % 16"):
        INT8_MATMUL(torch.zeros(2, 8), w[:, :8], s)


def test_quantize_module_matches_jax_payloads_and_bytes(pair, quantized):
    module, params, model = pair
    jmod, jparams, ported, own, saved, jsaved = quantized
    assert saved == jsaved
    assert tq.decode_weight_bytes(own) == jq.decode_weight_bytes(jparams)
    assert tq.decode_weight_bytes(model) == jq.decode_weight_bytes(params)
    mine, theirs = own.state_dict(), ported.state_dict()
    assert mine.keys() == theirs.keys()
    for name, t in mine.items():
        if t.dtype == torch.int8:
            assert torch.equal(t, theirs[name]), name
        else:
            np.testing.assert_allclose(t.numpy(), theirs[name].numpy(),
                                       rtol=SCALE_RTOL, atol=0, err_msg=name)
    assert isinstance(own.layers[0].mlp.down_proj, tq.Int8Linear)
    with pytest.raises(ValueError, match="already quantized"):
        tq.quantize_module(own)


def test_quantize_module_lora_keeps_adapters_fp():
    module, params = jax_lm({"attention": "xla", "lora_rank": 4, "lora_alpha": 8.0,
                             "lora_targets": ("q_proj", "v_proj")}, seed=3)
    model = torch_lm(module, params)
    jmod, jparams, jsaved = jq.quantize_module(module, params)
    own, saved = tq.quantize_module(model)
    assert saved == jsaved
    assert tq.decode_weight_bytes(own) == jq.decode_weight_bytes(_np(jparams))
    q = own.layers[1].attention.q_proj
    assert isinstance(q, tq.Int8LoRALinear) and q.lora_a.dtype == torch.float32
    assert torch.equal(q.lora_b, model.layers[1].attention.q_proj.lora_b)
    with pytest.raises(ValueError, match="LoRA"):
        tq.quantize_params(model.state_dict())
    toks = np.random.default_rng(4).integers(1, 256, (2, 12)).astype(np.int32)
    ref = jmod.apply({"params": jparams}, jnp.asarray(toks), train=False)
    with torch.no_grad():
        out = own(torch.from_numpy(toks).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_quantized_forward_matches_jax(quantized):
    jmod, jparams, ported, own, _, _ = quantized
    toks = np.random.default_rng(5).integers(1, 256, (2, 20)).astype(np.int32)
    ref = np.asarray(jmod.apply({"params": jparams}, jnp.asarray(toks), train=False))
    with torch.no_grad():
        for m in (ported, own):
            out = m(torch.from_numpy(toks).long())
            np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_kv_pool_bytes_equal_jax_and_live(pair, kv_quant):
    model = pair[2]
    cfg = model.cfg
    tl = PagedKVLayout(8, 24, kv_quant=kv_quant)
    jl = JLayout(8, 24, kv_quant=kv_quant)
    args = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 4)
    assert tq.kv_pool_bytes(tl, *args) == jq.kv_pool_bytes(jl, *args)
    pool = tgen.make_paged_cache(model, tl)
    live = sum(t.numel() * t.element_size() for layer in pool for t in layer)
    assert live == tq.kv_pool_bytes(tl, *args)


def test_int8_pool_paged_decode_matches_jax(quantized):
    """A quantized module on the int8 pool: a left-padded prefill of two
    rows, then two steps; logits within 1e-4 of the JAX module's, and the
    payloads of the live slots equal but for a rounding at a .5 boundary
    (the K/V differ by f32 sum order before they are quantized)."""
    jmod, jparams, ported, _, _, _ = quantized
    pt, pb = 4, 8
    jl, tl = JLayout(pt, 16, kv_quant="int8"), PagedKVLayout(pt, 16, kv_quant="int8")
    cache_j = jgen.make_paged_cache(jmod, jparams, jl)
    cache_t = tgen.make_paged_cache(ported, tl)
    rng = np.random.default_rng(6)
    toks = rng.integers(1, 256, (2, pb)).astype(np.int32)
    pad = np.array([0, 3])
    pages = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pos = 0
    for step in range(3):
        ref, out_vars = jmod.apply(
            {"params": jparams, "cache": cache_j}, jnp.asarray(toks), train=False,
            decode=True, mutable=["cache"], kv_layout=jl, pad=jnp.asarray(pad, jnp.int32),
            pages=jnp.asarray(pages), pos=jnp.asarray(pos, jnp.int32))
        cache_j = out_vars["cache"]
        with torch.inference_mode():
            out = ported(torch.from_numpy(toks).long(), cache=cache_t, kv_layout=tl,
                         pad=torch.from_numpy(pad), pages=torch.from_numpy(pages), pos=pos)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        pos += toks.shape[1]
        toks = np.asarray(ref)[:, -1:].argmax(-1).astype(np.int32)
    jk = np.asarray(cache_j["layer_1"]["attention"]["cached_key"])
    jks = np.asarray(cache_j["layer_1"]["attention"]["cached_key_scale"])
    tk, _, tks, _ = (t.numpy() for t in cache_t[1])
    live = pages.ravel()
    diff = np.abs(tk[live].astype(np.int32) - jk[live].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    np.testing.assert_allclose(tks[live], jks[live], rtol=1e-5, atol=0)


def test_int8_pool_chunked_prefill_equals_one_shot(quantized):
    """Slices of 5 then 3, against one prefill of 8: every payload byte of
    the pool and the sampled decode after it are equal, the scales within
    1e-6 relative."""
    model = quantized[3]
    B, P, nb = 2, 8, 6
    prompt = np.random.RandomState(7).randint(1, 256, size=(B, P))
    seeds, pads = [7, 11], np.zeros(B, np.int64)
    layout = PagedKVLayout(4, 32, kv_quant="int8")
    n_pages = -(-(P + nb) // 4)
    tables = 1 + np.arange(B * n_pages).reshape(B, n_pages)

    def decode(cache, first):
        toks, _ = tgen.paged_decode_chunk(
            model, cache, first, torch.zeros(B, dtype=torch.bool), steps=nb - 1,
            pos=P, start_g=1, pad=pads, pages=tables, kv_layout=layout,
            prefix_len=0, temperature=0.8, top_k=40, eos_id=None, seeds=seeds)
        return torch.cat([first[:, None], toks], dim=1).numpy()

    one_cache = tgen.make_paged_cache(model, layout)
    first = tgen.paged_prefill(model, one_cache, prompt, pad=pads, pages=tables,
                               kv_layout=layout, prefix_len=0, temperature=0.8,
                               top_k=40, seeds=seeds)
    one_pool = [t.clone() for layer in one_cache for t in layer]
    one = decode(one_cache, first)
    two_cache = tgen.make_paged_cache(model, layout)
    tgen.paged_prefill_chunk(model, two_cache, prompt[:, :5], pad=pads, pages=tables,
                             kv_layout=layout, prefix_lens=[0, 0], pos=0, final=False)
    first2 = tgen.paged_prefill_chunk(
        model, two_cache, prompt[:, 5:], pad=pads, pages=tables, kv_layout=layout,
        prefix_lens=[0, 0], pos=5, temperature=0.8, top_k=40, seeds=seeds, final=True)
    two_pool = [t.clone() for layer in two_cache for t in layer]
    for a, b in zip(one_pool, two_pool):
        if a.dtype == torch.int8:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(one, decode(two_cache, first2))
