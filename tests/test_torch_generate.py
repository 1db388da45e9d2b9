"""The port's dense-KV-cache decode against the JAX package's, on the CPU.

Greedy tokens must be identical to the JAX `generate`; the logits of each
prefill/step through the cache agree within 1e-4 (f32, sum order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.generate import generate as jax_generate
from polyaxon_tpu_torch.models.generate import generate
from tests.test_torch_transformer import LOGIT_TOL, jax_lm, tokens, torch_lm


@pytest.fixture(scope="module")
def pair():
    module, params = jax_lm({"attention": "xla"})
    return module, params, torch_lm(module, params)


def _both(pair, prompt, **kw):
    module, params, model = pair
    ref = jax_generate(module, params, jnp.asarray(prompt), **kw)
    out = generate(model, torch.from_numpy(prompt), **kw)
    return out.numpy(), np.asarray(ref)


def test_greedy_tokens_identical(pair):
    out, ref = _both(pair, tokens(B=2, S=12), max_new_tokens=10)
    assert out.shape == (2, 22)
    np.testing.assert_array_equal(out, ref)


def test_greedy_left_padded_tokens_identical(pair):
    prompt = tokens(B=3, S=10, seed=2)
    lengths = np.array([10, 4, 7], np.int32)
    for b, n in enumerate(lengths):
        prompt[b, : 10 - n] = 0
    out, ref = _both(pair, prompt, max_new_tokens=8, prompt_lengths=lengths)
    np.testing.assert_array_equal(out, ref)
    # row 1 alone, unpadded, continues exactly as inside the padded batch
    solo, _ = _both(pair, prompt[1:2, 6:], max_new_tokens=8)
    np.testing.assert_array_equal(solo[0, 4:], out[1, 10:])


def test_greedy_eos_latch_identical(pair):
    prompt = tokens(B=2, S=8, seed=3)
    free, _ = _both(pair, prompt, max_new_tokens=10)
    eos = int(free[0, 8 + 2])  # a token row 0 really generates
    out, ref = _both(pair, prompt, max_new_tokens=10, eos_id=eos)
    np.testing.assert_array_equal(out, ref)
    assert (out[0, 8 + 3:] == eos).all()


def test_decode_step_logits_match_jax(pair):
    """Prefill then three cached steps, both sides fed the same tokens."""
    module, params, model = pair
    prompt = tokens(B=2, S=9, seed=4)
    pad = np.array([0, 3], np.int32)
    _, vars0 = module.apply(
        {"params": params}, jnp.zeros((2, 1), jnp.int32), train=False,
        decode=True, mutable=["cache"],
    )
    cache_j = vars0["cache"]
    cache_t = model.make_cache(2)
    feeds = [prompt] + [tokens(B=2, S=1, seed=10 + i) for i in range(3)]
    pos = 0
    for feed in feeds:
        ref, out_vars = module.apply(
            {"params": params, "cache": cache_j}, jnp.asarray(feed), train=False,
            decode=True, mutable=["cache"], pad=jnp.asarray(pad),
        )
        cache_j = out_vars["cache"]
        with torch.no_grad():
            out = model(
                torch.from_numpy(feed).long(), cache=cache_t, pos=pos,
                pad=torch.from_numpy(pad),
            )
        pos += feed.shape[1]
        np.testing.assert_allclose(
            out.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=LOGIT_TOL
        )
    k_ref = np.asarray(cache_j["layer_1"]["attention"]["cached_key"])
    np.testing.assert_allclose(
        cache_t[1][0].numpy()[:, :pos], k_ref[:, :pos], atol=LOGIT_TOL, rtol=LOGIT_TOL
    )


def test_sampling_streams(pair):
    """Sampled draws differ from jax.random's by construction, so these pin
    the port's own contract: same seed → same tokens; per-row streams do
    not depend on batch mates; top_k=1 is greedy."""
    _, _, model = pair
    prompt = torch.from_numpy(tokens(B=2, S=6, seed=5))
    kw = dict(max_new_tokens=6, temperature=0.9)
    a = generate(model, prompt, seed=7, **kw)
    assert torch.equal(a, generate(model, prompt, seed=7, **kw))
    rows = generate(model, prompt, seed=[11, 12], **kw)
    solo = generate(model, prompt[1:], seed=[12], **kw)
    assert torch.equal(rows[1], solo[0])
    greedy = generate(model, prompt, max_new_tokens=6)
    assert torch.equal(generate(model, prompt, top_k=1, seed=3, **kw), greedy)


def test_generate_refuses_too_long_and_adapters(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="seq_len"):
        generate(model, torch.zeros(1, 120, dtype=torch.long), max_new_tokens=9)
    # per-row adapter slots need a slot-stacked model, as in the reference
    # (tests/test_torch_lora_slots.py decodes through the slots)
    with pytest.raises(ValueError, match="adapter_slots"):
        generate(model, torch.zeros(1, 4, dtype=torch.long), max_new_tokens=2,
                 adapter_ix=[0])
