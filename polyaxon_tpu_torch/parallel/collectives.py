"""Differentiable collectives over `torch.distributed` process groups.

The reference gets its backward passes by differentiating through
`jax.lax.ppermute`, `all_to_all` and GSPMD's own collectives. Here each
collective the forward runs is a `torch.autograd.Function` whose backward
is the collective's transpose:

- `ppermute(tensors, group, shift)`: group member i sends to i + shift and
  receives from i - shift (`batch_isend_irecv`); the backward permutes the
  cotangents the inverse way;
- `all_to_all(x, group, split_dim, concat_dim)`: the tiled all-to-all
  (`jax.lax.all_to_all(..., tiled=True)`); the backward is the inverse
  all-to-all;
- `copy_to(x, group)` / `reduce_from(x, group)`: Megatron's f and g, the
  identity whose backward all-reduces, and the all-reduce whose backward
  is the identity; the pair around a tensor-parallel block;
- `sum_over(x, groups)`: the all-reduce every member goes on to use,
  whose backward all-reduces too (BatchNorm's global statistics);
- `broadcast_from(x, group, src)`: one member's value on all of them,
  whose backward sums the cotangents onto that member (the pipeline's
  last stage).

`group=None` (no such axis on the mesh, or an axis of size 1) makes each of
them the identity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def axis_group(mesh, axis: str):
    """The process group along `axis` of `mesh`, or None when the mesh has
    no such axis or it has size 1."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    if mesh.size(mesh.mesh_dim_names.index(axis)) == 1:
        return None
    return mesh.get_group(axis)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 when the mesh lacks it)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def all_reduce(t: torch.Tensor, groups: Sequence, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over each group in turn (a reduction
    over their product); not differentiable. Returns `t`."""
    for g in groups:
        if g is not None:
            dist.all_reduce(t, op=op, group=g)
    return t


def _permute(tensors, group, shift: int) -> list:
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    out, ops = [], []
    for t in tensors:
        t = t.contiguous()
        r = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, r, src, group))
        out.append(r)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, shift, *tensors):
        ctx.group, ctx.shift = group, shift
        return tuple(_permute(tensors, group, shift))

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, None, *_permute(grads, ctx.group, -ctx.shift))


def ppermute(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> tuple:
    """Rotate `tensors` by `shift` members around `group` (the reference's
    `ppermute` with perm [(j, (j + shift) % n)])."""
    if group is None:
        return tuple(tensors)
    return _PPermute.apply(group, shift, *tensors)


def _all_to_all(x, group, split_dim: int, concat_dim: int):
    n = dist.get_world_size(group)
    chunks = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    out = [torch.empty_like(c) for c in chunks]
    dist.all_to_all(out, chunks, group=group)
    return torch.cat(out, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Split `x` into n chunks along `split_dim`, send chunk j to member j,
    and concatenate what arrives along `concat_dim` in member order."""
    if group is None:
        return x
    if x.shape[split_dim] % dist.get_world_size(group):
        raise ValueError(
            f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
            f"{dist.get_world_size(group)} ways"
        )
    return _AllToAll.apply(x, group, split_dim, concat_dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Identity forward, all-reduce backward: the input of a block whose
    members each compute a part of its output from all of `x`."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """All-reduce (sum) forward, identity backward: the members' partial
    outputs of a block summed into the whole."""
    return x if group is None else _ReduceFrom.apply(x, group)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return all_reduce(x.contiguous().clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.groups), None


def sum_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of `x` over the members of each group (an all-reduce), when
    every member goes on to use the sum: the backward sums the members'
    cotangents the same way (SyncBatchNorm's statistics)."""
    groups = [g for g in groups if g is not None]
    return _SumOver.apply(x, groups) if groups else x


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.group, ctx.src = group, src
        out = x.contiguous().clone()
        dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        if dist.get_rank(ctx.group) != ctx.src:
            g = torch.zeros_like(g)
        return g, None, None


def broadcast_from(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Member `src`'s `x` on every member of `group`; the backward sums the
    members' cotangents onto `src` (the others' `x` gets zeros)."""
    return x if group is None else _BroadcastFrom.apply(x, group, src)


def exclusive_prefix(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the members of `group` ranked before this one
    (zeros on the first); not differentiable."""
    if group is None:
        return torch.zeros_like(t)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    me = dist.get_rank(group)
    return sum(parts[:me], torch.zeros_like(t))
