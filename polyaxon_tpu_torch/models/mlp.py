"""MLP (BASELINE configuration #1, MNIST), counterpart of
`polyaxon_tpu/models/mlp.py`: the input flattened as given (a [B, 28, 28, 1]
`mnist` batch with `flat: false` becomes [B, 784] in NHWC order), dense
layers with ReLU and optional dropout, and a classification head. It
computes in f32 whatever the precision (the reference's `dtype=float32`):
the input is cast to f32, so under `mixed` the bf16-valued weights meet
f32 activations and promote to f32."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from .layers import Dense, dropout, rank_block, seeded_init


class MLP(nn.Module):
    def __init__(self, input_dim: int = 784, hidden: Sequence[int] = (512, 256),
                 num_classes: int = 10, dropout_rate: float = 0.0, *,
                 device="cuda", dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dropout_rate = dropout_rate
        factory = dict(device=dev, dtype=dtype)
        widths = (input_dim, *hidden)
        for i, width in enumerate(hidden):
            self.add_module(f"dense_{i}", Dense(widths[i], width, **factory))
        self.n_hidden = len(hidden)
        self.head = Dense(widths[-1], num_classes, **factory)
        seeded_init(self, seed)

    def forward(self, x, *, dropout_generator=None):
        x = x.reshape(x.shape[0], -1).float()
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
            if self.dropout_rate and self.training:
                x = dropout(x, self.dropout_rate, dropout_generator, block=rank_block(x))
        return self.head(x)
