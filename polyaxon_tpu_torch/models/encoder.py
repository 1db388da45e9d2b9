"""Bidirectional transformer encoder blocks shared by ViT, BERT and the
seq2seq encoder, counterpart of `polyaxon_tpu/models/encoder.py`.

Projection names match the reference's (q/k/v/o_proj, fc1/fc2,
norm1/norm2), each a Dense with bias. Attention is full (no causal mask)
through `ops.attention.dot_product_attention` with the model's backend:
under `attention: flash` the card runs the flash kernels with
`causal=False`, one query head per kv head. Pre-LN (ViT, seq2seq) or
post-LN (BERT); LayerNorm epsilon 1e-6, the tanh GELU. Dropout (when
`dropout_rate` > 0, in training) follows the attention and the MLP on the
residual path; there is no attention-probability dropout.

Under the trainer's mesh with a `model` axis the blocks run Megatron
tensor parallelism when the trainer hands the forward its `model` slices
(`ENCODER_RULES`, `ENCODER_TENSOR_PARALLEL`): q/k/v and `fc1` are
column-parallel (a rank's heads and hidden units, their biases sliced
alike), entered through `copy_to`; `o_proj` and `fc2` are row-parallel,
their partial products summed by `reduce_from` before the bias is added
once. The seq2seq decoder's self- and cross-attention take the same path
(`split_attention`).

Under a `context` axis BERT and seq2seq hand their blocks the axis's group
(`sequence_group`): each rank holds a chunk of the sequence, and
self-attention runs on the ring over `context` (`parallel/ring.py`: each
hop attends this rank's queries against one rank's keys, the flash
kernels at the chunk's length). Dropout draws its mask at the whole
sequence's shape and keeps this rank's rows, so it is one device's mask.
ViT's batch stays whole on every `context` rank, so its blocks get no
group and attend their whole sequence."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import dot_product_attention, whole_sequence_attention
from ..parallel.collectives import axis_group, axis_index, copy_to, reduce_from
from ..parallel.ring import current_mesh, model_group as _model_group
from .layers import Dense, LayerNorm, dropout, gelu, rank_block


def row_parallel(dense: Dense, h, group):
    """`dense(h)` where `dense` holds this rank's rows of the input dim:
    the partial products summed over `group`, then the bias."""
    if group is None:
        return dense(h)
    dt = torch.promote_types(h.dtype, dense.weight.dtype)
    y = reduce_from(F.linear(h.to(dt), dense.weight.to(dt)), group)
    return y + dense.bias.to(dt)


def sequence_group():
    """The bound mesh's `context` group (the trainer shards an mlm
    model's token sequence over it), or None without one."""
    return axis_group(current_mesh(), "context")


def sequence_chunk(full: int, group) -> slice:
    """This rank's positions of a `full`-long sequence split over `group`."""
    if group is None:
        return slice(0, full)
    n = full // torch.distributed.get_world_size(group)
    r = axis_index(current_mesh(), "context")
    return slice(r * n, (r + 1) * n)


def split_attention(mod: nn.Module, x, memory=None, *, causal: bool = False,
                    backend: str = "xla", seq_group=None):
    """Multi-head attention through `mod`'s q/k/v/o_proj (`mod.dim`,
    `mod.n_heads`): queries from `x`, keys and values from `memory` (`x`
    when None). Under tensor parallelism the projections hold this rank's
    heads. With `seq_group` (self-attention over a sequence split over
    the bound mesh's `context` group) `x` is this rank's chunk and
    attention runs on the ring (causal by global position); without one
    `x` and `memory` hold their whole sequence."""
    B, T, _ = x.shape
    hd = mod.dim // mod.n_heads
    group = _model_group(mod.q_proj.weight.shape[0], mod.dim)
    x = copy_to(x, group)
    kv = x if memory is None else copy_to(memory, group)
    S = kv.shape[1]
    q = mod.q_proj(x).reshape(B, T, -1, hd)
    k = mod.k_proj(kv).reshape(B, S, -1, hd)
    v = mod.v_proj(kv).reshape(B, S, -1, hd)
    attend = whole_sequence_attention if seq_group is None else dot_product_attention
    out = attend(q, k, v, causal=causal, backend=backend)
    return row_parallel(mod.o_proj, out.reshape(B, T, -1), group)


def block_dropout(h, rate: float, generator, seq_group=None):
    """`layers.dropout` of a block's residual branch `h`: this rank's
    rows of the batch, and under `seq_group` its chunk of the sequence
    (dim 1), of the mask drawn for the global batch and sequence."""
    return dropout(h, rate, generator, block=rank_block(h, seq=seq_group is not None))


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, backend: str = "xla", **factory):
        super().__init__()
        self.dim, self.n_heads, self.backend = dim, n_heads, backend
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.add_module(name, Dense(dim, dim, **factory))

    def forward(self, x, seq_group=None):
        return split_attention(self, x, backend=self.backend, seq_group=seq_group)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, mlp_dim: int, dropout_rate: float = 0.0,
                 pre_norm: bool = True, eps: float = 1e-6, backend: str = "xla",
                 **factory):
        super().__init__()
        self.dropout_rate, self.pre_norm, self.mlp_dim = dropout_rate, pre_norm, mlp_dim
        self.attention = MultiHeadAttention(dim, n_heads, backend, **factory)
        self.fc1 = Dense(dim, mlp_dim, **factory)
        self.fc2 = Dense(mlp_dim, dim, **factory)
        self.norm1 = LayerNorm(dim, eps, **factory)
        self.norm2 = LayerNorm(dim, eps, **factory)

    def forward(self, x, generator=None, seq_group=None):
        def drop(h):
            if self.dropout_rate and self.training:
                return block_dropout(h, self.dropout_rate, generator, seq_group)
            return h

        def mlp(h):
            group = _model_group(self.fc1.weight.shape[0], self.mlp_dim)
            return row_parallel(self.fc2, gelu(self.fc1(copy_to(h, group))), group)

        if self.pre_norm:
            x = x + drop(self.attention(self.norm1(x), seq_group))
            return x + drop(mlp(self.norm2(x)))
        x = self.norm1(x + drop(self.attention(x, seq_group)))
        return self.norm2(x + drop(mlp(x)))


# The reference's ENCODER_RULES in the port's layouts (an nn.Linear-shaped
# `weight` [out, in] swaps flax's [in, out] entries); the biases carry no
# rule (replicated), as in the reference.
ENCODER_RULES = (
    (r"(q_proj|k_proj|v_proj)\.weight$", ("model", "fsdp")),
    (r"o_proj\.weight$", ("fsdp", "model")),
    (r"fc1\.weight$", ("model", "fsdp")),
    (r"fc2\.weight$", ("fsdp", "model")),
)

# How the blocks' forward keeps each parameter split over `model`
# (`parallel/params.py`): column-parallel q/k/v/fc1 weights and biases on
# their output dim, row-parallel o_proj/fc2 weights on their input dim.
ENCODER_TENSOR_PARALLEL = (
    (r"(q_proj|k_proj|v_proj|fc1)\.(weight|bias)$", 0),
    (r"(o_proj|fc2)\.weight$", 1),
)
