"""Procedural datasets, counterpart of `polyaxon_tpu/data/synthetic.py`.

Classification sets (`synthetic`, `mnist`, `synthetic_imagenet`) draw each
example as `prototype[label] + noise` (NHWC images or flat vectors), so a
model that learns the prototypes drives the loss towards 0. Token sets emit
sequences from a fixed bigram chain, so a language model beats uniform
loss quickly; `synthetic_seq2seq` is a reversal task packed for the
encoder-decoder. Batches are byte-identical to the reference's for the same
seed, config and process index."""

from __future__ import annotations

import numpy as np

from .registry import DataSpec, register_dataset


def _class_image_stream(shape, num_classes, batch_size, seed, process_index, noise=0.3):
    rng = np.random.default_rng(seed * 1000003 + process_index)
    protos = np.random.default_rng(seed).normal(size=(num_classes, *shape)).astype(
        np.float32
    )
    while True:
        labels = rng.integers(0, num_classes, size=(batch_size,))
        x = protos[labels] + noise * rng.normal(size=(batch_size, *shape)).astype(
            np.float32
        )
        yield {"inputs": x.astype(np.float32), "labels": labels.astype(np.int32)}


@register_dataset("synthetic")
def synthetic(batch_size, config, seed, process_index):
    """The default stream of a program without `data`: 32-dim vectors of 10
    classes unless `shape` / `num_classes` say otherwise."""
    shape = tuple(config.get("shape", (32,)))
    num_classes = int(config.get("num_classes", 10))
    return DataSpec(
        name="synthetic",
        iterator=_class_image_stream(shape, num_classes, batch_size, seed, process_index),
        batch_size=batch_size,
        meta={"shape": shape, "num_classes": num_classes},
    )


@register_dataset("mnist")
def mnist(batch_size, config, seed, process_index):
    """MNIST-shaped learnable stand-in: 784-dim flat, or 28x28x1 images
    with `flat: false`."""
    flat = bool(config.get("flat", True))
    shape = (784,) if flat else (28, 28, 1)
    return DataSpec(
        name="mnist",
        iterator=_class_image_stream(shape, 10, batch_size, seed, process_index),
        batch_size=batch_size,
        meta={"shape": shape, "num_classes": 10},
    )


@register_dataset("synthetic_imagenet")
def synthetic_imagenet(batch_size, config, seed, process_index):
    """ImageNet-shaped stream [B, size, size, 3] for ResNet and ViT."""
    size = int(config.get("image_size", 224))
    num_classes = int(config.get("num_classes", 1000))
    shape = (size, size, 3)
    return DataSpec(
        name="synthetic_imagenet",
        iterator=_class_image_stream(
            shape, num_classes, batch_size, seed, process_index, noise=1.0
        ),
        batch_size=batch_size,
        meta={"shape": shape, "num_classes": num_classes},
    )


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


def _seq2seq_stream(batch_size, src_len, tgt_len, vocab, seed, process_index):
    """Reversal task packed for models/seq2seq.py: the target is the source
    reversed. Inputs [src | BOS + tgt[:-1]] (width src_len + tgt_len),
    labels [B, tgt_len] aligned with the decoder logits."""
    rng = np.random.default_rng(seed * 1000003 + process_index + 41)
    bos = 1
    while True:
        src = rng.integers(2, vocab, size=(batch_size, src_len))
        tgt = src[:, ::-1][:, :tgt_len]
        tgt_in = np.concatenate([np.full((batch_size, 1), bos), tgt[:, :-1]], axis=1)
        inputs = np.concatenate([src, tgt_in], axis=1).astype(np.int32)
        yield {"inputs": inputs, "labels": tgt.astype(np.int32)}


@register_dataset("synthetic_seq2seq")
def synthetic_seq2seq(batch_size, config, seed, process_index):
    src_len = int(config.get("src_len", 32))
    tgt_len = int(config.get("tgt_len", src_len))
    if tgt_len > src_len:
        raise ValueError(
            f"reversal task needs tgt_len <= src_len, got {tgt_len} > {src_len}"
        )
    vocab = int(config.get("vocab_size", 1024))
    return DataSpec(
        name="synthetic_seq2seq",
        iterator=_seq2seq_stream(batch_size, src_len, tgt_len, vocab, seed, process_index),
        batch_size=batch_size,
        meta={"src_len": src_len, "tgt_len": tgt_len, "vocab_size": vocab},
    )
