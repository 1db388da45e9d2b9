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
keep flax's epsilon 1e-6; the logits are f32 against the tied embedding."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from .encoder import EncoderBlock
from .layers import numbered, Dense, LayerNorm, dropout, gelu, seeded_init

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
        B, T, _ = x.shape
        S = memory.shape[1]
        hd = self.dim // self.n_heads
        q = self.q_proj(x).reshape(B, T, self.n_heads, hd)
        k = self.k_proj(memory).reshape(B, S, self.n_heads, hd)
        v = self.v_proj(memory).reshape(B, S, self.n_heads, hd)
        out = dot_product_attention(q, k, v, causal=False, backend="xla")
        return self.o_proj(out.reshape(B, T, self.dim))


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, mlp_dim: int, dropout_rate: float = 0.0,
                 backend: str = "xla", **factory):
        super().__init__()
        self.dim, self.n_heads = dim, n_heads
        self.dropout_rate, self.backend = dropout_rate, backend
        for name in _PROJ:
            self.add_module(name, Dense(dim, dim, **factory))
        self.cross = CrossAttention(dim, n_heads, **factory)
        self.fc1 = Dense(dim, mlp_dim, **factory)
        self.fc2 = Dense(mlp_dim, dim, **factory)
        for name in ("norm1", "norm2", "norm3"):
            self.add_module(name, LayerNorm(dim, **factory))

    def _self_attn(self, h):
        B, T, _ = h.shape
        hd = self.dim // self.n_heads
        q = self.q_proj(h).reshape(B, T, self.n_heads, hd)
        k = self.k_proj(h).reshape(B, T, self.n_heads, hd)
        v = self.v_proj(h).reshape(B, T, self.n_heads, hd)
        out = dot_product_attention(q, k, v, causal=True, backend=self.backend)
        return self.o_proj(out.reshape(B, T, self.dim))

    def forward(self, x, memory, generator=None):
        def drop(h):
            if self.dropout_rate and self.training:
                return dropout(h, self.dropout_rate, generator)
            return h

        x = x + drop(self._self_attn(self.norm1(x)))
        x = x + drop(self.cross(self.norm2(x), memory))
        return x + drop(self.fc2(gelu(self.fc1(self.norm3(x)))))


class Seq2Seq(nn.Module):
    def __init__(self, vocab_size: int = 32128, dim: int = 512, n_layers: int = 6,
                 n_heads: int = 8, src_len: int = 512, tgt_len: int = 512,
                 mlp_ratio: int = 4, dropout_rate: float = 0.0, attention: str = "xla",
                 *, device="cuda", dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        self.src_len, self.tgt_len = src_len, tgt_len
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
        src, tgt = tokens[:, : self.src_len], tokens[:, self.src_len:]
        h = self.embed(src) + self.src_pos[:, : src.shape[1]]
        for block in numbered(self, "enc_"):
            h = block(h, dropout_generator)
        memory = self.enc_norm(h)
        d = self.embed(tgt) + self.tgt_pos[:, : tgt.shape[1]]
        for block in numbered(self, "dec_"):
            d = block(d, memory, dropout_generator)
        return F.linear(self.dec_norm(d).float(), self.embed.weight.float())
