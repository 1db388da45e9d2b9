"""Ulysses sequence parallelism, counterpart of
`polyaxon_tpu/parallel/ulysses.py`: two all-to-alls flip a rank's block
from sequence-sharded [B, S/c, H, D] to head-sharded [B, S, H/c, D], the
flash kernel attends over the whole sequence locally, and one more
all-to-all flips the output back. Each token crosses the fabric twice
whatever the ring size, and no softmax merges are needed; heads must
divide by the context degree (use `attention: ring` otherwise).

Inputs are this rank's local blocks or DTensors, as for
`parallel.ring.ring_attention`."""

from __future__ import annotations

import torch

from .collectives import all_to_all, axis_group
from .ring import current_mesh, with_dtensors


def _ulysses_body(q, k, v, *, group, causal: bool, block_kv: int):
    from ..ops.flash_attention import flash_attention

    def seq_to_heads(x):  # [B, S/c, H, D] → [B, S, H/c, D]
        return all_to_all(x, group, split_dim=2, concat_dim=1)

    def heads_to_seq(x):  # [B, S, H/c, D] → [B, S/c, H, D]
        return all_to_all(x, group, split_dim=1, concat_dim=2)

    o = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                        causal=causal, block_kv=block_kv)
    return heads_to_seq(o)


def _ulysses_local(q, k, v, *, mesh, axis_name: str, block_kv: int, causal: bool):
    from ..ops.attention import local_attention

    group = axis_group(mesh, axis_name)
    if group is None:
        return local_attention(q, k, v, causal=causal, backend="flash",
                                     block_kv=block_kv)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    H, KV = q.shape[2], k.shape[2]
    if H % n:
        raise ValueError(
            f"ulysses needs local head count {H} divisible by the context "
            f"degree {n} (heads are scattered); use attention: ring for this shape"
        )
    if KV != H and KV % n:
        # the kv heads do not scatter with the query heads: expand them
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    return _ulysses_body(q, k, v, group=group, causal=causal, block_kv=block_kv)


def ulysses_attention(q, k, v, *, axis_name: str = "context", block_kv: int = 512,
                      causal: bool = True, mesh=None):
    """Attention with Q/K/V sequence-sharded over `axis_name` (see the
    module docstring); GQA kv ride the all-to-all at their own head width
    when the local kv heads divide the context degree, else they are
    expanded. Without a context axis: the flash dispatch."""
    from torch.distributed.tensor import DTensor

    def local(mesh_, ql, kl, vl):
        return _ulysses_local(ql, kl, vl, mesh=mesh_, axis_name=axis_name,
                              block_kv=block_kv, causal=causal)

    if isinstance(q, DTensor):
        return with_dtensors(local, q, k, v, axis_name=axis_name, causal=causal)
    return local(mesh if mesh is not None else current_mesh(), q, k, v)
