"""The flax layers the model zoo is built from, as the reference computes
them (`flax.linen` defaults, not torch's):

- `Dense` / `Conv`: the product runs in the promoted dtype of input and
  weight (flax's `promote_dtype`), so an f32 activation meets a bf16-valued
  weight in f32. `Conv` takes NCHW and pads `"SAME"` as XLA does: the
  total padding of an axis is max((ceil(n / s) - 1) s + k - n, 0), the odd
  unit on the high side, so a 3x3 stride-2 conv of an even input pads
  (0, 1), not (1, 1). Weights are [out, in] and [out, in, kh, kw]
  (`models/convert.py` transposes the reference's [in, out] and HWIO).
- `LayerNorm` (epsilon 1e-6) and `BatchNorm` (epsilon 1e-5, momentum 0.9):
  statistics in f32 as mean(x^2) - mean(x)^2 clipped at 0 (flax's
  `use_fast_variance`), the scale folded into rsqrt(var + eps) before it
  multiplies x - mean. LayerNorm returns the promoted dtype of x and its
  parameters; BatchNorm computes and returns f32 (the reference's
  `dtype=jnp.float32`). BatchNorm's running statistics are the buffers
  `running_mean` and `running_var` (flax `batch_stats` `mean`/`var`):
  running = 0.9 running + 0.1 batch, with the biased batch variance, and no
  `num_batches_tracked`. In eval mode it normalises by them. Under the
  trainer's mesh the batch statistics are the global batch's, as GSPMD
  takes them in the reference: the ranks that split the batch add up
  their sums of x and x^2 (`parallel.collectives.sum_over`, whose backward
  sums the gradients the same way), so every rank holds the same running
  statistics.
- `gelu` is flax's `nn.gelu`, the tanh approximation.

What a forward sows (flax `self.sow("losses", ...)`: the MoE aux loss) and
the statistics BatchNorm would update reach the caller through
`collecting()`: inside it they are collected, not applied, so the trainer
takes them from the forward it ran once, and a recompute of that forward
(`torch.utils.checkpoint`) cannot apply them a second time. Outside it a
training-mode BatchNorm updates its buffers in place and sown losses are
dropped, as flax drops a sow without `mutable`.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

_LECUN_STD_CORRECTION = 0.87962566103423978  # std of N(0, 1) truncated at +-2


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: truncated at 2 sigma, variance-corrected."""
    std = fan_in ** -0.5 / _LECUN_STD_CORRECTION
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def gelu(x):
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------- collection
class Collected:
    """What one forward sowed (`losses`) and the buffer updates it asks for
    (`updates`: (module, buffer name, new value))."""

    def __init__(self):
        self.losses: list[torch.Tensor] = []
        self.updates: list[tuple[nn.Module, str, torch.Tensor]] = []

    def aux_loss(self, device) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float32, device=device)
        for value in self.losses:
            total = total + value.float().sum()
        return total

    def apply_updates(self) -> None:
        with torch.no_grad():
            for module, name, value in self.updates:
                getattr(module, name).copy_(value)


_LOCAL = threading.local()


@contextlib.contextmanager
def collecting():
    stack = _LOCAL.__dict__.setdefault("stack", [])
    box = Collected()
    stack.append(box)
    try:
        yield box
    finally:
        stack.pop()


def _box() -> Optional[Collected]:
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


def sowing() -> bool:
    """True inside `collecting()`: a sown loss is kept. An inference
    forward (serving, generate) sows nothing and need not compute it."""
    return _box() is not None


def sow_loss(value: torch.Tensor) -> None:
    box = _box()
    if box is not None:
        box.losses.append(value)


# ----------------------------------------------------------------- layers
class Dense(nn.Linear):
    """flax nn.Dense: y = x W^T + b in the promoted dtype of x and W."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)

    @torch.no_grad()
    def reset_with(self, gen: torch.Generator) -> None:
        lecun_normal_(self.weight, self.in_features, gen)
        if self.bias is not None:
            self.bias.zero_()


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax nn.Conv on NCHW: weight [out, in, kh, kw], padding "SAME",
    "VALID" or explicit ((top, bottom), (left, right))."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding="SAME", bias: bool = True, device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, **factory))
        self.bias = nn.Parameter(torch.zeros(out_ch, **factory)) if bias else None

    def _pads(self, h: int, w: int) -> tuple[int, int, int, int]:
        if self.padding == "VALID":
            return 0, 0, 0, 0
        if self.padding == "SAME":
            (t, b), (l, r) = (same_padding(n, self.kernel, self.stride) for n in (h, w))
        else:
            (t, b), (l, r) = self.padding
        return l, r, t, b

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt)
        left, right, top, bottom = self._pads(x.shape[2], x.shape[3])
        if left == right and top == bottom:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, stride=self.stride, padding=pad)

    @torch.no_grad()
    def reset_with(self, gen: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.kernel * self.kernel
        lecun_normal_(self.weight, fan_in, gen)
        if self.bias is not None:
            self.bias.zero_()


def _fast_stats(x32: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    mean = x32.mean(dims)
    var = ((x32 * x32).mean(dims) - mean * mean).clamp_min(0.0)
    return mean, var


def _batch_stats(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm's per-channel mean and variance of NCHW `x32`: on a bound
    mesh with batch axes, over the global batch (the ranks' sums of x and
    x^2 added up, differentiably, and divided by the global count; a mesh
    whose batch axes have size 1 takes the same sums without a
    collective)."""
    from ..parallel.collectives import axis_group, sum_over
    from ..parallel.mesh import BATCH_AXES
    from ..parallel.ring import current_mesh

    mesh = current_mesh()
    if mesh is None or not set(BATCH_AXES) & set(mesh.mesh_dim_names):
        return _fast_stats(x32, (0, 2, 3))
    groups = [g for g in (axis_group(mesh, ax) for ax in BATCH_AXES) if g is not None]
    count = x32.numel() // x32.shape[1]
    for g in groups:
        count *= torch.distributed.get_world_size(g)
    sums = sum_over(torch.stack([x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3))]), groups)
    mean = sums[0] / count
    return mean, (sums[1] / count - mean * mean).clamp_min(0.0)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        out_dtype = torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype
        )
        x32 = x.float()
        mean, var = _fast_stats(x32, -1)
        mul = torch.rsqrt(var[..., None] + self.eps) * self.weight.float()
        return ((x32 - mean[..., None]) * mul + self.bias.float()).to(out_dtype)

    @torch.no_grad()
    def reset_with(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, dtype=float32) over NCHW channels."""

    def __init__(self, channels: int, zero_scale: bool = False, momentum: float = 0.9,
                 eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.momentum, self.eps, self.zero_scale = momentum, eps, zero_scale
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x):
        x32 = x.float()
        if self.training:
            mean, var = _batch_stats(x32)
            m = self.momentum
            new_mean = m * self.running_mean + (1 - m) * mean.detach()
            new_var = m * self.running_var + (1 - m) * var.detach()
            box = _box()
            if box is None:
                with torch.no_grad():
                    self.running_mean.copy_(new_mean)
                    self.running_var.copy_(new_var)
            else:
                box.updates.append((self, "running_mean", new_mean))
                box.updates.append((self, "running_var", new_var))
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x32 - mean[:, None, None]) * mul[:, None, None]
        return y + self.bias.float()[:, None, None]

    @torch.no_grad()
    def reset_with(self, gen: torch.Generator) -> None:
        self.weight.fill_(0.0 if self.zero_scale else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


def dropout(x, rate: float, generator=None, block=None):
    """flax nn.Dropout in training: keep each element with probability
    1 - rate and scale it by 1 / (1 - rate), the mask drawn from
    `generator` (its draws differ from jax.random's by construction).
    `block` (`rank_block`): `x` is one rank's block of a tensor split over
    a mesh, one (global size, this rank's slice) per leading dim, and its
    mask is that block of the mask drawn at the global shape, so every
    rank draws what one device would and keeps its own part: k times its
    own share in time and transient memory, k the number of blocks."""
    keep_prob = 1.0 - rate
    u = draw_block(lambda shape: torch.rand(shape, generator=generator, device=x.device),
                   x.shape, block)
    return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


def draw_block(sample, shape, block=None):
    """`sample(shape)` where `block` is None, else `sample` of the global
    shape `block` describes (`rank_block`), cut to this rank's block."""
    if block is None:
        return sample(shape)
    full = sample((*(n for n, _ in block), *shape[len(block):]))
    return full[tuple(rows for _, rows in block)]


def rank_block(x, seq: bool = False):
    """`dropout`'s `block` for `x` on the bound mesh: dim 0 holds this
    rank's rows of the batch split over the batch axes (`batch`, `data`,
    `fsdp` in mesh order, as `parallel.sharding.batch_sharding` splits
    it; a gang's replicas are rows of `data`), and with `seq` dim 1 its
    chunk of the sequence split over `context`. None off a mesh or where
    neither is split. The ranks of `model`, `expert` and `pipeline` hold
    the same tokens and get the same block."""
    from ..parallel.collectives import axis_index
    from ..parallel.mesh import BATCH_AXES, axis_sizes
    from ..parallel.ring import current_mesh

    mesh = current_mesh()
    sizes = axis_sizes(mesh)
    shards, index = 1, 0
    for ax in sizes:
        if ax in BATCH_AXES:
            shards, index = shards * sizes[ax], index * sizes[ax] + axis_index(mesh, ax)
    ctx = sizes.get("context", 1) if seq else 1
    if shards == 1 and ctx == 1:
        return None
    B = x.shape[0]
    block = [(B * shards, slice(index * B, (index + 1) * B))]
    if ctx > 1:
        S, c = x.shape[1], axis_index(mesh, "context")
        block.append((S * ctx, slice(c * S, (c + 1) * S)))
    return tuple(block)


def seeded_init(root: nn.Module, seed: int, normal_002: tuple = ()) -> None:
    """Seeded random weights with the reference's distributions (different
    draws: torch.Generator against jax.random): every layer above resets
    itself, `nn.Embedding` and the parameters named in `normal_002` draw
    N(0, 0.02)."""
    device = next(root.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with torch.no_grad():
        for mod in root.modules():
            if hasattr(mod, "reset_with"):
                mod.reset_with(gen)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 0.02, generator=gen)
        params = dict(root.named_parameters())
        for name in normal_002:
            params[name].normal_(0.0, 0.02, generator=gen)


def numbered(root: nn.Module, prefix: str) -> list:
    """The children named `<prefix>0`, `<prefix>1`, ... in order (the
    reference's `block_{i}`-style module names)."""
    out = []
    while hasattr(root, f"{prefix}{len(out)}"):
        out.append(getattr(root, f"{prefix}{len(out)}"))
    return out
