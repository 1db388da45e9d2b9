"""HF Llama checkpoints ↔ the port's Transformer, on the CPU: a tiny random
`LlamaForCausalLM` built from a `LlamaConfig` (nothing downloaded) is
converted by `models/convert_hf.py`, and the port's logits match HF's and
the JAX package's conversion of the same model (f32: within 2e-4
absolute + 1e-4 relative, the reference test's limits); the config dicts of
both packages are equal; `to_hf_llama_state_dict` gives HF's state back
bit for bit, and `merge_lora` folds adapters as the reference's does.
It skips only where `transformers` is absent."""

import os

import numpy as np
import pytest
import torch

# these tests build torch models only: without USE_TF=0 transformers imports
# TensorFlow where it is installed, most of its import time
_use_tf = os.environ.get("USE_TF")
os.environ["USE_TF"] = "0"
try:
    pytest.importorskip("transformers")
finally:
    if _use_tf is None:
        del os.environ["USE_TF"]
    else:
        os.environ["USE_TF"] = _use_tf

from polyaxon_tpu.models.convert_hf import from_hf_llama as jax_from_hf  # noqa: E402
from polyaxon_tpu.models.convert_hf import merge_lora as jax_merge_lora  # noqa: E402
from polyaxon_tpu_torch.models import (  # noqa: E402
    build_model, from_hf_llama, merge_lora, to_hf_llama_state_dict,
)
from polyaxon_tpu_torch.models.convert import params_from_jax  # noqa: E402
from polyaxon_tpu_torch.models.transformer import _make_config  # noqa: E402


def _tiny_hf(tie=False, seed=0):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tie,
    )
    torch.manual_seed(seed)
    return LlamaForCausalLM(cfg).eval()


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_logit_parity_with_hf_and_jax(tie):
    import jax
    import jax.numpy as jnp

    from polyaxon_tpu.models import build_model as jax_build

    hf = _tiny_hf(tie=tie)
    cfg, state = from_hf_llama(hf)
    jax_cfg, jax_params = jax_from_hf(hf)
    assert cfg == jax_cfg
    module = build_model("transformer_lm", dict(cfg), device="cpu").module.eval()
    module.load_state_dict(state)
    tokens = np.random.default_rng(0).integers(0, 128, (2, 16))
    with torch.no_grad():
        ours = module(torch.from_numpy(tokens)).float().numpy()
        theirs = hf(torch.from_numpy(tokens)).logits.float().numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-4)
    jax_module = jax_build("transformer_lm", dict(jax_cfg)).module
    ref = np.asarray(jax.jit(lambda p, t: jax_module.apply({"params": p}, t, train=False))(
        jax_params, jnp.asarray(tokens, jnp.int32)))
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-4)
    # the same weights as the JAX conversion carried by params_from_jax
    via_jax = params_from_jax(jax_params, _make_config(dict(jax_cfg)))
    assert set(via_jax) == set(state)
    assert all(torch.equal(via_jax[k], state[k]) for k in state)


def test_state_dict_and_config_dict_inputs():
    hf = _tiny_hf(seed=2)
    cfg, state = from_hf_llama(hf)
    cfg2, state2 = from_hf_llama(hf.state_dict(), config=hf.config.to_dict())
    assert cfg == cfg2 and all(torch.equal(state[k], state2[k]) for k in state)
    with pytest.raises(ValueError, match="Llama-family"):
        from_hf_llama({"model.embed_tokens.weight": torch.zeros(1)},
                      config=hf.config.to_dict())


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_round_trip_is_exact(tie):
    hf = _tiny_hf(tie=tie, seed=3)
    cfg, state = from_hf_llama(hf)
    back = to_hf_llama_state_dict(cfg, state)
    theirs = {k: v for k, v in hf.state_dict().items() if k in back}
    assert set(back) == set(theirs)
    assert all(torch.equal(back[k], theirs[k]) for k in back)
    fresh = _tiny_hf(tie=tie, seed=4)
    missing, unexpected = fresh.load_state_dict(back, strict=False)
    assert not unexpected
    assert all("rotary" in k or (tie and k == "lm_head.weight") for k in missing)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (1, 12)))
    with torch.no_grad():
        assert torch.equal(fresh(tokens).logits, hf(tokens).logits)


def test_merge_lora_matches_the_reference():
    """A LoRA model's state merged in the port equals the reference's merge
    of the same tree, and the merged model computes the LoRA model's
    function."""
    model = build_model("transformer_lm", dict(
        dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128, seq_len=32,
        lora_rank=4, lora_alpha=8.0), device="cpu").module.eval()
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.1)
    merged = merge_lora(model.state_dict(), alpha=8.0)
    assert not any(k.endswith(("lora_a", "lora_b")) for k in merged)
    plain = build_model("transformer_lm", dict(
        dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128, seq_len=32),
        device="cpu").module.eval()
    plain.load_state_dict(merged)
    tokens = torch.from_numpy(rng.integers(0, 128, (2, 16)))
    with torch.no_grad():
        torch.testing.assert_close(plain(tokens), model(tokens), atol=1e-5, rtol=1e-5)
    # the reference's merge of the same weights, in its [in, out] tree
    tree = {}
    for name, value in model.state_dict().items():
        parts = name.split(".")
        if parts[0] != "layers" or parts[-1] not in ("weight", "lora_a", "lora_b"):
            continue
        node = tree.setdefault(f"layer_{parts[1]}", {}).setdefault(parts[2], {})
        leaf = node.setdefault(parts[3], {})
        leaf["kernel" if parts[-1] == "weight" else parts[-1]] = (
            value.T.numpy() if parts[-1] == "weight" else value.numpy())
    ref = jax_merge_lora(tree, alpha=8.0)
    for layer, node in ref.items():
        for block, projs in node.items():
            for proj, leaf in projs.items():
                ours = merged[f"layers.{layer[6:]}.{block}.{proj}.weight"]
                np.testing.assert_allclose(ours.numpy(), leaf["kernel"].T, rtol=1e-6, atol=1e-6)
