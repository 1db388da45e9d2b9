"""Encoder-decoder transformer (T5-shaped), counterpart of
`polyaxon_tpu/models/seq2seq.py`.

One packed token stream per example, `[src_0..src_{S-1}, tgt_in_0..
tgt_in_{T-1}]`, and decoder-only logits [B, T, V], aligned with the
`synthetic_seq2seq` labels, so the generic trainer and the `masked_lm` loss
apply unchanged. The encoder is pre-LN `EncoderBlock`s (full attention);
each decoder block is pre-LN causal self-attention, cross-attention over
the encoder's output, and a GELU MLP. Under `attention: flash` the card
runs the flash kernels on the encoder (`causal=False`) and on the
decoder's self-attention (`causal=True`), one query head per kv head;
cross-attention always runs the einsum path (`xla`), as in the
reference, since the kernels assume as many queries as keys. LayerNorms
keep flax's epsilon 1e-6; the logits are f32 against the tied embedding.

Under a `context` axis each rank holds a chunk of the packed stream and
of the labels. The tokens are gathered (integers: no gradient) and each
rank takes its chunk of the source and of the target: the encoder's and
the decoder's self-attention run on the ring over `context`
(`split_attention`, the decoder causal by global position), the
encoder's memory is gathered whole for cross-attention (`gather_seq`,
its backward a reduce-scatter), and the logits are this rank's target
chunk, aligned with its labels."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from ..parallel.collectives import all_gather_cat, copy_to, gather_seq
from ..parallel.ring import model_group as _model_group
from .encoder import (EncoderBlock, block_dropout, row_parallel, sequence_chunk,
                      sequence_group, split_attention)
from .layers import numbered, Dense, LayerNorm, gelu, seeded_init

PRESETS = {
    "tiny-test": dict(
        dim=128, n_layers=2, n_heads=4, src_len=32, tgt_len=32, vocab_size=1024
    ),
    "small": dict(
        dim=512, n_layers=6, n_heads=8, src_len=512, tgt_len=512, vocab_size=32128
    ),
    "base": dict(
        dim=768, n_layers=12, n_heads=12, src_len=512, tgt_len=512, vocab_size=32128
    ),
}
_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj")


class CrossAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, **factory):
        super().__init__()
        self.dim, self.n_heads = dim, n_heads
        for name in _PROJ:
            self.add_module(name, Dense(dim, dim, **factory))

    def forward(self, x, memory):
        return split_attention(self, x, memory)


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, mlp_dim: int, dropout_rate: float = 0.0,
                 backend: str = "xla", **factory):
        super().__init__()
        self.dim, self.n_heads = dim, n_heads
        self.dropout_rate, self.backend = dropout_rate, backend
        for name in _PROJ:
            self.add_module(name, Dense(dim, dim, **factory))
        self.cross = CrossAttention(dim, n_heads, **factory)
        self.mlp_dim = mlp_dim
        self.fc1 = Dense(dim, mlp_dim, **factory)
        self.fc2 = Dense(mlp_dim, dim, **factory)
        for name in ("norm1", "norm2", "norm3"):
            self.add_module(name, LayerNorm(dim, **factory))

    def _self_attn(self, h, seq_group=None):
        return split_attention(self, h, causal=True, backend=self.backend,
                               seq_group=seq_group)

    def forward(self, x, memory, generator=None, seq_group=None):
        def drop(h):
            if self.dropout_rate and self.training:
                return block_dropout(h, self.dropout_rate, generator, seq_group)
            return h

        x = x + drop(self._self_attn(self.norm1(x), seq_group))
        x = x + drop(self.cross(self.norm2(x), memory))
        h = self.norm3(x)
        group = _model_group(self.fc1.weight.shape[0], self.mlp_dim)
        return x + drop(row_parallel(self.fc2, gelu(self.fc1(copy_to(h, group))), group))


class Seq2Seq(nn.Module):
    def __init__(self, vocab_size: int = 32128, dim: int = 512, n_layers: int = 6,
                 n_heads: int = 8, src_len: int = 512, tgt_len: int = 512,
                 mlp_ratio: int = 4, dropout_rate: float = 0.0, attention: str = "xla",
                 *, device="cuda", dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        self.src_len, self.tgt_len = src_len, tgt_len
        self.split_widths = (n_heads, dim * mlp_ratio)
        self.embed = nn.Embedding(vocab_size, dim, **factory)
        self.src_pos = nn.Parameter(torch.empty(1, src_len, dim, **factory))
        self.tgt_pos = nn.Parameter(torch.empty(1, tgt_len, dim, **factory))
        mlp_dim = dim * mlp_ratio
        for i in range(n_layers):
            self.add_module(f"enc_{i}", EncoderBlock(
                dim, n_heads, mlp_dim, dropout_rate, pre_norm=True, backend=attention,
                **factory))
        self.enc_norm = LayerNorm(dim, **factory)
        for i in range(n_layers):
            self.add_module(f"dec_{i}", DecoderBlock(
                dim, n_heads, mlp_dim, dropout_rate, backend=attention, **factory))
        self.dec_norm = LayerNorm(dim, **factory)
        seeded_init(self, seed, normal_002=("src_pos", "tgt_pos"))

    def forward(self, tokens, *, dropout_generator=None):
        """tokens [B, src_len + tgt_len] → decoder logits [B, tgt_len, vocab]."""
        group = sequence_group()
        tokens = all_gather_cat(tokens, group, 1)
        src, tgt = tokens[:, : self.src_len], tokens[:, self.src_len:]
        src_at, tgt_at = sequence_chunk(src.shape[1], group), sequence_chunk(tgt.shape[1], group)
        h = self.embed(src[:, src_at]) + self.src_pos[:, src_at]
        for block in numbered(self, "enc_"):
            h = block(h, dropout_generator, group)
        memory = gather_seq(self.enc_norm(h), group, 1)
        d = self.embed(tgt[:, tgt_at]) + self.tgt_pos[:, tgt_at]
        for block in numbered(self, "dec_"):
            d = block(d, memory, dropout_generator, group)
        return F.linear(self.dec_norm(d).float(), self.embed.weight.float())
