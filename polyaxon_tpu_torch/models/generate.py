"""Autoregressive generation with a dense per-layer KV cache (counterpart
of `polyaxon_tpu/models/generate.py::generate`).

One batched prefill forward over the whole prompt fills every layer's
cache and samples the first new token; then one cached decode step per
further token. The cache is allocated up front, [B, seq_len, n_kv, hd] per
layer (no creation pass), and written in place. The reference is
functional (each step returns a new cache pytree); the tokens are the same.

Sampling: temperature 0 is greedy (argmax, first index on ties) and gives
the reference's tokens exactly. With temperature > 0 the noise comes from
a torch.Generator keyed like the reference's jax.random streams — a scalar
seed by (seed, absolute position), per-row seeds by (row seed, generation
index) — so a row's tokens do not depend on its batch or padding. The
draws themselves differ from jax.random's by construction.
"""

from __future__ import annotations

from typing import Optional

import torch


def _top_k_mask(logits, top_k: Optional[int]):
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, torch.full_like(logits, -1e30))
    return logits


def _stream_seed(seed: int, index: int) -> int:
    """One 64-bit generator seed per (seed, index) pair."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(index) & 0xFFFFFFFF)


def _gumbel(shape, seed: int, index: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(_stream_seed(seed, index))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2**-24)))


def _sample(logits, seed: int, index: int, temperature: float, top_k: Optional[int]):
    """logits [B, V] f32 → [B] ids, one stream (seed, index) for the batch."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _top_k_mask(logits / temperature, top_k)
    return torch.argmax(logits + _gumbel(logits.shape, seed, index, logits.device), dim=-1)


def _sample_rows(logits, seeds, index: int, temperature: float, top_k: Optional[int]):
    """Per-row streams: row b draws from (seeds[b], index), so coalescing
    rows into one batch never correlates or changes their samples."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _top_k_mask(logits / temperature, top_k)
    V = logits.shape[-1]
    noise = torch.stack(
        [_gumbel((V,), int(s), index, logits.device) for s in seeds]
    )
    return torch.argmax(logits + noise, dim=-1)


@torch.inference_mode()
def generate(
    module,
    prompt,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    seed=0,
    prompt_lengths=None,
    adapter_ix=None,
) -> torch.Tensor:
    """Generate `max_new_tokens` continuations of `prompt` [B, P].

    Returns [B, P + max_new_tokens] int64 on the model's device. `seed` is
    an int, or a length-B sequence of per-row seeds. With `prompt_lengths`
    [B] the prompt is LEFT-padded to P: row b's tokens are
    `prompt[b, P - prompt_lengths[b]:]`, pad slots never attend and rotary
    positions shift per row. With `eos_id`, a row that feeds a generated
    eos emits eos from then on."""
    if adapter_ix is not None:
        raise NotImplementedError(
            "adapter_ix (multi-tenant LoRA slots) is not ported yet (ROADMAP.md)"
        )
    cfg = module.cfg
    device = module.device
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(device)
    B, P = prompt.shape
    total = P + int(max_new_tokens)
    if total > cfg.seq_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds the model's seq_len {cfg.seq_len} (the KV cache size)"
        )
    pad = None
    if prompt_lengths is not None:
        lengths = torch.as_tensor(prompt_lengths, dtype=torch.long, device=device)
        pad = P - lengths
    seeds = torch.as_tensor(seed).reshape(-1).tolist()
    per_row = torch.as_tensor(seed).ndim == 1
    if per_row and len(seeds) != B:
        raise ValueError(f"{len(seeds)} per-row seeds for a batch of {B}")

    def sample(logits, index):
        if per_row:
            return _sample_rows(logits, seeds, index, temperature, top_k)
        return _sample(logits, seeds[0], index, temperature, top_k)

    cache = module.make_cache(B)
    logits = module(prompt, cache=cache, pos=0, pad=pad)
    buf = torch.zeros((B, total), dtype=torch.long, device=device)
    buf[:, :P] = prompt
    buf[:, P] = sample(logits[:, -1].float(), 0)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    for t in range(P, total - 1):  # t = position of the token being fed
        tok = buf[:, t:t + 1]
        logits = module(tok, cache=cache, pos=t, pad=pad)
        # per-row streams key on generation index (invariant to the pad);
        # the scalar stream keys on absolute position, as in the reference
        nxt = sample(logits[:, -1].float(), (t - P + 1) if per_row else t)
        if eos_id is not None:
            # latch only on GENERATED eos (prompts may hold eos separators)
            done = done | (tok[:, 0] == eos_id)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        buf[:, t + 1] = nxt
    return buf
