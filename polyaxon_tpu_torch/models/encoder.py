"""Bidirectional transformer encoder blocks shared by ViT, BERT and the
seq2seq encoder, counterpart of `polyaxon_tpu/models/encoder.py`.

Projection names match the reference's (q/k/v/o_proj, fc1/fc2,
norm1/norm2), each a Dense with bias. Attention is full (no causal mask)
through `ops.attention.dot_product_attention` with the model's backend:
under `attention: flash` the card runs the flash kernels with
`causal=False`, one query head per kv head. Pre-LN (ViT, seq2seq) or
post-LN (BERT); LayerNorm epsilon 1e-6, the tanh GELU. Dropout (when
`dropout_rate` > 0, in training) follows the attention and the MLP on the
residual path; there is no attention-probability dropout."""

from __future__ import annotations

from torch import nn

from ..ops.attention import dot_product_attention
from .layers import Dense, LayerNorm, dropout, gelu


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, backend: str = "xla", **factory):
        super().__init__()
        self.dim, self.n_heads, self.backend = dim, n_heads, backend
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.add_module(name, Dense(dim, dim, **factory))

    def forward(self, x):
        B, S, _ = x.shape
        hd = self.dim // self.n_heads
        q = self.q_proj(x).reshape(B, S, self.n_heads, hd)
        k = self.k_proj(x).reshape(B, S, self.n_heads, hd)
        v = self.v_proj(x).reshape(B, S, self.n_heads, hd)
        out = dot_product_attention(q, k, v, causal=False, backend=self.backend)
        return self.o_proj(out.reshape(B, S, self.dim))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, mlp_dim: int, dropout_rate: float = 0.0,
                 pre_norm: bool = True, eps: float = 1e-6, backend: str = "xla",
                 **factory):
        super().__init__()
        self.dropout_rate, self.pre_norm = dropout_rate, pre_norm
        self.attention = MultiHeadAttention(dim, n_heads, backend, **factory)
        self.fc1 = Dense(dim, mlp_dim, **factory)
        self.fc2 = Dense(mlp_dim, dim, **factory)
        self.norm1 = LayerNorm(dim, eps, **factory)
        self.norm2 = LayerNorm(dim, eps, **factory)

    def forward(self, x, generator=None):
        def drop(h):
            if self.dropout_rate and self.training:
                return dropout(h, self.dropout_rate, generator)
            return h

        def mlp(h):
            return self.fc2(gelu(self.fc1(h)))

        if self.pre_norm:
            x = x + drop(self.attention(self.norm1(x)))
            return x + drop(mlp(self.norm2(x)))
        x = self.norm1(x + drop(self.attention(x)))
        return self.norm2(x + drop(mlp(x)))
