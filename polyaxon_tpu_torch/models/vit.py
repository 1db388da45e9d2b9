"""Vision Transformer (BASELINE configuration #4, ViT-S/16), counterpart of
`polyaxon_tpu/models/vit.py`: a strided conv patchifies the NHWC image,
tokens in the reference's row-major (h, w) order plus learned positions,
pre-LN encoder blocks, a final LayerNorm, mean-pool and a dense head.

ViT-S/16 at 224 px has 196 tokens, which the flash kernels' 128-row q
block does not divide: `attention: flash` raises there, as in the
reference, and the configuration runs `attention: xla`."""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .encoder import EncoderBlock
from .layers import numbered, Conv, Dense, LayerNorm, seeded_init

PRESETS = {
    "tiny-test": dict(dim=128, n_layers=2, n_heads=4, patch=8, image_size=32),
    "vit-s16": dict(dim=384, n_layers=12, n_heads=6, patch=16, image_size=224),
    "vit-b16": dict(dim=768, n_layers=12, n_heads=12, patch=16, image_size=224),
}


class ViT(nn.Module):
    def __init__(self, dim: int = 384, n_layers: int = 12, n_heads: int = 6,
                 patch: int = 16, image_size: int = 224, num_classes: int = 1000,
                 mlp_ratio: int = 4, dropout_rate: float = 0.0, attention: str = "xla",
                 *, device="cuda", dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        self.image_size, self.patch = image_size, patch
        self.patch_embed = Conv(3, dim, patch, stride=patch, padding="VALID", **factory)
        n_tokens = (image_size // patch) ** 2
        self.pos_embed = nn.Parameter(torch.empty(1, n_tokens, dim, **factory))
        for i in range(n_layers):
            self.add_module(f"block_{i}", EncoderBlock(
                dim, n_heads, dim * mlp_ratio, dropout_rate, pre_norm=True,
                backend=attention, **factory))
        self.final_norm = LayerNorm(dim, **factory)
        self.head = Dense(dim, num_classes, **factory)
        seeded_init(self, seed, normal_002=("pos_embed",))

    def forward(self, x, *, dropout_generator=None):
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # NHWC → NCHW
        x = x.flatten(2).transpose(1, 2)  # [B, H*W, C], (h, w) row-major
        x = x + self.pos_embed
        for block in numbered(self, "block_"):
            x = block(x, dropout_generator)
        return self.head(self.final_norm(x).mean(dim=1))
