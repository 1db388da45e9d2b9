"""ResNet-v1.5 (BASELINE configuration #2, ResNet-50), counterpart of
`polyaxon_tpu/models/resnet.py`: a 7x7/2 stem conv, BatchNorm, ReLU, a
3x3/2 max-pool, then bottleneck (depth 50/101/152) or basic (18/34) stages.

The stream's NHWC images are convolved as NCHW inside the model. Every conv
pads "SAME" as XLA does (`layers.Conv`): a 3x3 stride-2 conv of an even
input pads (0, 1). The stem's (3, 3) padding and the max-pool's -inf (1, 1)
padding are symmetric. BatchNorm is the reference's (`layers.BatchNorm`):
f32 compute and output, so under `mixed` every conv after the stem runs in
f32 on bf16-valued weights, as flax's dtype promotion runs them there; the
last BatchNorm of each block (`bn3`, or `bn2` of a basic block) starts its
scale at zero. The running statistics are buffers, updated by the training
step (`layers.collecting`) and read in eval mode."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from .layers import BatchNorm, Conv, Dense, seeded_init

STAGE_SIZES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK = {50, 101, 152}


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int = 1, **factory):
        super().__init__()
        out = filters * 4
        self.conv1 = Conv(in_ch, filters, 1, bias=False, **factory)
        self.bn1 = BatchNorm(filters, **factory)
        self.conv2 = Conv(filters, filters, 3, stride=strides, bias=False, **factory)
        self.bn2 = BatchNorm(filters, **factory)
        self.conv3 = Conv(filters, out, 1, bias=False, **factory)
        self.bn3 = BatchNorm(out, zero_scale=True, **factory)
        if in_ch != out or strides != 1:
            self.proj = Conv(in_ch, out, 1, stride=strides, bias=False, **factory)
            self.proj_bn = BatchNorm(out, **factory)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.proj_bn(self.proj(x)) if hasattr(self, "proj") else x
        return torch.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int = 1, **factory):
        super().__init__()
        self.conv1 = Conv(in_ch, filters, 3, stride=strides, bias=False, **factory)
        self.bn1 = BatchNorm(filters, **factory)
        self.conv2 = Conv(filters, filters, 3, bias=False, **factory)
        self.bn2 = BatchNorm(filters, zero_scale=True, **factory)
        if in_ch != filters or strides != 1:
            self.proj = Conv(in_ch, filters, 1, stride=strides, bias=False, **factory)
            self.proj_bn = BatchNorm(filters, **factory)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.proj_bn(self.proj(x)) if hasattr(self, "proj") else x
        return torch.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, num_classes: int = 1000, width: int = 64, *,
                 device="cuda", dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        block_cls = BottleneckBlock if depth in BOTTLENECK else BasicBlock
        self.stem_conv = Conv(3, width, 7, stride=2, padding=((3, 3), (3, 3)),
                              bias=False, **factory)
        self.stem_bn = BatchNorm(width, **factory)
        in_ch = width
        for stage, n_blocks in enumerate(STAGE_SIZES[depth]):
            for b in range(n_blocks):
                filters = width * 2 ** stage
                self.add_module(f"stage{stage + 1}_block{b}", block_cls(
                    in_ch, filters, strides=2 if stage > 0 and b == 0 else 1, **factory))
                in_ch = filters * block_cls.expansion
        self.head = Dense(in_ch, num_classes, **factory)
        seeded_init(self, seed)

    def blocks(self) -> list:
        return [m for name, m in self.named_children() if name.startswith("stage")]

    def forward(self, x):
        x = self.stem_conv(x.permute(0, 3, 1, 2))  # NHWC → NCHW
        x = torch.relu(self.stem_bn(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # -inf padding, as nn.max_pool
        for block in self.blocks():
            x = block(x)
        return self.head(x.mean(dim=(2, 3)))
