"""The grouped int8 projection (`int8_matmul_group`) and the model's grouped
q/k/v and gate/up launches, on the CPU.

What is held, with its tolerance:
- `int8_matmul_group` on CPU tensors equals its members' separate
  `int8_matmul_reference` calls bit for bit (1-4 members, mixed N and K,
  a leading batch shape or none, f32 and bf16): on the CPU a group is
  exactly those calls;
- it refuses what the kernels do not take, on any device: mismatched K,
  unsupported dtypes, weights on another device, more than four members,
  weights that are not int8;
- a quantized 2-layer `transformer_lm`, plain and with `lora_rank > 0` on
  only some projections: logits within 1e-5 (`Int8Linear`'s tolerance in
  test_torch_quant.py; they read up to 2.7e-6 here) of the JAX package's
  `Int8Dense` model holding the same quantized tree (f32, sum order only)
  and greedy tokens equal to the JAX `generate`; each layer's q/k/v and
  gate/up reach `int8_matmul_group` once each, LoRA members included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import quant as jq
from polyaxon_tpu.models.generate import generate as jax_generate
from polyaxon_tpu_torch.models import quant as tq
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.models.generate import generate
from polyaxon_tpu_torch.models.transformer import Transformer, _make_config
from polyaxon_tpu_torch.ops import int8_matmul as im
from tests.test_torch_quant import LINEAR_TOL
from tests.test_torch_transformer import SMALL, jax_lm

K = 48


def _pairs(Ns, k=K, seed=0):
    rng = np.random.default_rng(seed)
    return [tq.quantize_kernel(torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)))
            for n in Ns]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [16, K, 112])
@pytest.mark.parametrize(
    "Ns,lead",
    [((40,), (5,)), ((64, 16), (3,)), ((32, 8, 8), (2, 4)), ((24, 72, 16, 40), (2, 1, 3)),
     ((8,), ()), ((128, 8), (1,))],
    ids=["one", "two", "qkv-like", "four", "one-row", "gate-up-like"],
)
def test_group_equals_separate_plain_calls(Ns, lead, k, dtype):
    pairs = _pairs(Ns, k=k)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((*lead, k))
                         .astype(np.float32)).to(dtype)
    ys = im.int8_matmul_group(x, pairs)
    assert isinstance(ys, tuple) and len(ys) == len(Ns)
    for y, (wq, scale), n in zip(ys, pairs, Ns):
        assert y.shape == (*lead, n) and y.dtype == dtype
        assert torch.equal(y, im.int8_matmul_reference(x, wq, scale))
        assert torch.equal(y, im.int8_matmul(x, wq, scale))


def test_group_refuses_what_the_kernels_do_not_take():
    pairs = _pairs((16, 8))
    x = torch.zeros(2, K)
    with pytest.raises(ValueError, match="shapes"):
        im.int8_matmul_group(x, [pairs[0], _pairs((8,), k=32)[0]])  # mismatched K
    with pytest.raises(TypeError):
        im.int8_matmul_group(x.half(), pairs)
    with pytest.raises(TypeError):
        im.int8_matmul_group(x, [(pairs[0][0].float(), pairs[0][1])])  # not int8
    with pytest.raises(TypeError):
        im.int8_matmul_group(x, [(pairs[0][0], pairs[0][1].double())])
    with pytest.raises(ValueError, match="1 to 4"):
        im.int8_matmul_group(x, pairs * 3)
    with pytest.raises(ValueError, match="1 to 4"):
        im.int8_matmul_group(x, [])
    meta = (pairs[0][0].to("meta"), pairs[0][1])
    with pytest.raises(ValueError, match="one device"):
        im.int8_matmul_group(x, [meta])
    with pytest.raises(ValueError, match="K % 16"):
        im.int8_matmul_group(torch.zeros(2, 8), [(torch.zeros(4, 8, dtype=torch.int8),
                                                  torch.ones(4))])
    # the kernel object itself launches only on CUDA tensors
    with pytest.raises(ValueError, match="CUDA"):
        im.INT8_MATMUL.group(x, pairs)


CONFIGS = {
    "int8": ({"attention": "xla"}, 0),
    "int8-lora-qv-down": ({"attention": "xla", "lora_rank": 4, "lora_alpha": 8.0,
                           "lora_targets": ("q_proj", "v_proj", "down_proj")}, 3),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def quantized_pair(request):
    """(JAX int8 module's logits and greedy tokens on a fixed prompt, the
    port's module holding the same quantized tree, that prompt)."""
    overrides, seed = CONFIGS[request.param]
    module, params = jax_lm(overrides, seed=seed)
    jmod, jparams, _ = jq.quantize_module(module, params)
    cfg = _make_config({**SMALL, **overrides, "quant": "int8"})
    ported = Transformer(cfg, device="cpu")
    ported.load_state_dict(params_from_jax(_np(jparams), cfg))
    prompt = np.random.default_rng(seed + 10).integers(1, 256, (2, 9)).astype(np.int32)
    logits = np.asarray(jmod.apply({"params": jparams}, jnp.asarray(prompt), train=False))
    tokens = np.asarray(jax_generate(jmod, jparams, jnp.asarray(prompt), max_new_tokens=8))
    return logits, tokens, ported.eval(), prompt


def _np(tree):
    if hasattr(tree, "items"):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_grouped_int8_model_logits_match_jax(quantized_pair):
    ref, _, model, prompt = quantized_pair
    with torch.no_grad():
        out = model(torch.from_numpy(prompt).long())
    np.testing.assert_allclose(out.numpy(), ref, atol=LINEAR_TOL, rtol=LINEAR_TOL)


def test_grouped_int8_model_greedy_tokens_match_jax(quantized_pair):
    _, ref, model, prompt = quantized_pair
    out = generate(model, torch.from_numpy(prompt), max_new_tokens=8)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_each_layer_groups_qkv_and_gate_up(quantized_pair, monkeypatch):
    """One forward calls the group twice a layer (q/k/v, gate/up), every
    member int8 (LoRA ones add their delta after), and o/down alone."""
    _, _, model, prompt = quantized_pair
    calls = []
    real = tq.int8_matmul_group

    def spy(x, pairs):
        calls.append(len(pairs))
        return real(x, pairs)

    monkeypatch.setattr(tq, "int8_matmul_group", spy)
    with torch.no_grad():
        model(torch.from_numpy(prompt).long())
    assert calls == [3, 2] * model.cfg.n_layers
    lora = [m for m in model.modules() if isinstance(m, tq.Int8LoRALinear)]
    assert len(lora) == (3 * model.cfg.n_layers if model.cfg.lora_rank else 0)


def test_project_keeps_fp_projections_separate():
    """A set that is not all int8 (nn.Linear, LoRADense) is called one
    projection at a time, as before."""
    cfg = _make_config({**SMALL, "lora_rank": 2, "lora_targets": ("q_proj",)})
    model = Transformer(cfg, device="cpu").eval()
    attn = model.layers[0].attention
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 3, SMALL["dim"]))
                         .astype(np.float32))
    with torch.no_grad():
        q, k, v = tq.project(x, (attn.q_proj, attn.k_proj, attn.v_proj))
        assert torch.equal(q, attn.q_proj(x)) and torch.equal(v, attn.v_proj(x))
