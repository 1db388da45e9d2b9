"""The port's beam search against the JAX package's, on the CPU.

The same weights (numpy-seeded) and prompts go through the JAX
`beam_search` and the port's; the sequences must be the same tokens for
nb in {1, 4}, with and without eos, and with a length penalty other than
1 (f32 on both sides: the log-probs differ by sum order only, far below
the gaps between the kept candidates). nb = 1 is greedy decoding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.generate import beam_search as jax_beam_search
from polyaxon_tpu_torch.models.generate import beam_search, generate
from tests.test_torch_transformer import jax_lm, tokens, torch_lm


@pytest.fixture(scope="module")
def pair():
    module, params = jax_lm({"attention": "xla"})
    return module, params, torch_lm(module, params)


def _both(pair, prompt, **kw):
    module, params, model = pair
    ref = jax_beam_search(module, params, jnp.asarray(prompt), **kw)
    out = beam_search(model, torch.from_numpy(prompt), **kw)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("num_beams", [1, 4])
@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
def test_beams_match_jax(pair, num_beams, length_penalty):
    prompt = tokens(B=2, S=9, seed=11)
    out, ref = _both(pair, prompt, max_new_tokens=8, num_beams=num_beams,
                     length_penalty=length_penalty)
    assert out.shape == (2, 17)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("num_beams", [1, 4])
def test_beams_with_eos_match_jax(pair, num_beams):
    """eos taken from a token the beams really emit, so the finished
    buffer is exercised; a penalty > 1 favours the longer hypotheses."""
    prompt = tokens(B=2, S=7, seed=12)
    free, _ = _both(pair, prompt, max_new_tokens=8, num_beams=num_beams)
    eos = int(free[0, 7 + 2])
    for lp in (1.0, 1.5):
        out, ref = _both(pair, prompt, max_new_tokens=8, num_beams=num_beams,
                         eos_id=eos, length_penalty=lp)
        np.testing.assert_array_equal(out, ref)


def test_one_beam_is_greedy(pair):
    _, _, model = pair
    prompt = torch.from_numpy(tokens(B=2, S=10, seed=13))
    greedy = generate(model, prompt, max_new_tokens=6)
    assert torch.equal(beam_search(model, prompt, max_new_tokens=6, num_beams=1), greedy)


def test_beam_search_refuses_bad_arguments(pair):
    _, _, model = pair
    with pytest.raises(ValueError, match="seq_len"):
        beam_search(model, torch.zeros(1, 120, dtype=torch.long), max_new_tokens=9)
    with pytest.raises(ValueError, match="num_beams"):
        beam_search(model, torch.zeros(1, 4, dtype=torch.long), max_new_tokens=2,
                    num_beams=0)
