"""Procedural token streams, counterpart of the token part of
`polyaxon_tpu/data/synthetic.py`: sequences from a fixed bigram chain, so a
language model beats uniform loss quickly. Batches are byte-identical to
the reference's for the same seed, config and process index."""

from __future__ import annotations

import numpy as np

from .registry import DataSpec, register_dataset


def _bigram_stream(batch_size, seq_len, vocab, seed, process_index, mlm, mask_rate):
    """Bigram-chain token stream served from a pre-generated corpus: one
    corpus is rolled once at build time with each token having 8 likely
    successors, and batches are random windows into it (a tokenized corpus
    plus random crops)."""
    chain_rng = np.random.default_rng(seed)
    # successor table: token -> 8 likely next tokens (peaked transitions)
    succ = chain_rng.integers(0, vocab, size=(vocab, 8))
    corpus_len = max(65536, 4 * batch_size * (seq_len + 1))
    walk_rng = np.random.default_rng(seed + 7)
    choices = walk_rng.integers(0, 8, size=corpus_len)
    corpus = np.empty(corpus_len, np.int64)
    corpus[0] = walk_rng.integers(0, vocab)
    # one-time sequential roll (numpy-level loop, ~corpus_len steps)
    for t in range(1, corpus_len):
        corpus[t] = succ[corpus[t - 1], choices[t]]
    rng = np.random.default_rng(seed * 1000003 + process_index + 1)
    while True:
        starts = rng.integers(0, corpus_len - seq_len - 1, size=batch_size)
        toks = corpus[starts[:, None] + np.arange(seq_len + 1)[None, :]]
        if mlm:
            inputs = toks[:, :-1].copy()
            labels = np.full_like(inputs, -100)
            mask = rng.random(inputs.shape) < mask_rate
            mask[:, 0] = True  # >= 1 masked position per row keeps loss defined
            labels[mask] = inputs[mask]
            inputs[mask] = 1  # [MASK] token id
            yield {"inputs": inputs.astype(np.int32), "labels": labels.astype(np.int32)}
        else:
            yield {
                "inputs": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
            }


@register_dataset("synthetic_lm")
@register_dataset("synthetic_text")
def synthetic_text(batch_size, config, seed, process_index):
    """Causal-LM token stream (Llama configs): inputs + next-token labels."""
    seq_len = int(config.get("seq_len", 512))
    vocab = int(config.get("vocab_size", 32000))
    return DataSpec(
        name="synthetic_text",
        iterator=_bigram_stream(batch_size, seq_len, vocab, seed, process_index, False, 0.0),
        batch_size=batch_size,
        meta={"seq_len": seq_len, "vocab_size": vocab},
    )


@register_dataset("synthetic_mlm")
def synthetic_mlm(batch_size, config, seed, process_index):
    """Masked-LM stream: 15% of positions masked to id 1."""
    seq_len = int(config.get("seq_len", 128))
    vocab = int(config.get("vocab_size", 30522))
    mask_rate = float(config.get("mask_rate", 0.15))
    return DataSpec(
        name="synthetic_mlm",
        iterator=_bigram_stream(batch_size, seq_len, vocab, seed, process_index, True, mask_rate),
        batch_size=batch_size,
        meta={"seq_len": seq_len, "vocab_size": vocab},
    )
