"""BERT encoder for MLM pretraining (BASELINE configuration #3), counterpart
of `polyaxon_tpu/models/bert.py`: token embeddings plus learned positions,
an embedding LayerNorm, post-LN encoder blocks (full attention: under
`attention: flash` the flash kernels with `causal=False`), then the MLM
head: a dense transform, tanh GELU, LayerNorm, and f32 logits against the
tied embedding table (the reference's `embed.attend(x.astype(f32))`, so a
bf16-valued table meets f32 features) plus the f32 `mlm_bias`."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from .encoder import EncoderBlock
from .layers import numbered, Dense, LayerNorm, gelu, seeded_init

PRESETS = {
    "tiny-test": dict(dim=128, n_layers=2, n_heads=4, seq_len=64, vocab_size=1024),
    "bert-base": dict(dim=768, n_layers=12, n_heads=12, seq_len=512, vocab_size=30522),
    "bert-large": dict(dim=1024, n_layers=24, n_heads=16, seq_len=512, vocab_size=30522),
}


class Bert(nn.Module):
    def __init__(self, vocab_size: int = 30522, dim: int = 768, n_layers: int = 12,
                 n_heads: int = 12, seq_len: int = 512, mlp_ratio: int = 4,
                 dropout_rate: float = 0.0, attention: str = "xla", *,
                 device="cuda", dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        self.seq_len = seq_len
        self.split_widths = (n_heads, dim * mlp_ratio)
        self.embed = nn.Embedding(vocab_size, dim, **factory)
        self.pos_embed = nn.Parameter(torch.empty(1, seq_len, dim, **factory))
        self.embed_norm = LayerNorm(dim, **factory)
        for i in range(n_layers):
            self.add_module(f"block_{i}", EncoderBlock(
                dim, n_heads, dim * mlp_ratio, dropout_rate, pre_norm=False,
                backend=attention, **factory))
        self.mlm_transform = Dense(dim, dim, **factory)
        self.mlm_norm = LayerNorm(dim, **factory)
        self.mlm_bias = nn.Parameter(torch.zeros(vocab_size, **factory))
        seeded_init(self, seed, normal_002=("pos_embed",))
        with torch.no_grad():
            self.mlm_bias.zero_()

    def forward(self, tokens, *, dropout_generator=None):
        x = self.embed(tokens) + self.pos_embed[:, : tokens.shape[1]]
        x = self.embed_norm(x)
        for block in numbered(self, "block_"):
            x = block(x, dropout_generator)
        x = self.mlm_norm(gelu(self.mlm_transform(x)))
        logits = F.linear(x.float(), self.embed.weight.float())
        return logits + self.mlm_bias
