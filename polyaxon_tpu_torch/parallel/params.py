"""A module's parameters sharded over the mesh by its rules: the trainer's
FSDP and tensor parallelism, in the DTensor idiom (each parameter a
DTensor, gathered for the forward by `redistribute`).

- storage: each parameter becomes a DTensor with the placements of its
  rule (`sharding.param_shardings`), so a rank keeps exactly the shard the
  reference's device keeps; the optimizer's states follow it;
- the forward's view (`views`): the parameter redistributed to its
  compute placements, gathered over every axis but those where the
  forward keeps a split (`split`: per axis, the model's rules of the dim
  it keeps split, or "partial"): `model` (tensor parallelism, the
  model's `TENSOR_PARALLEL`), `expert` (each rank's experts) and
  `pipeline` (each rank's stage), and cast to the compute dtype first
  when asked, so the gather moves the narrow type;
- its gradient: the local view's gradient is declared `Partial` over the
  axes whose ranks add up to the loss (data, fsdp, context: each rank saw
  other tokens; pipeline: each rank holds its share of the loss), and
  over `model` for "partial" parameters; over `model` and `expert`, whose
  ranks see the same tokens and compute the same loss, it is the same on
  every rank (`SAME_TOKENS`). Autograd's redistribute back to the storage
  placements reduce-scatters it over `fsdp`, and `reduce_grads`
  all-reduces what is still partial once the step's backward passes are
  done. A mesh dim of size 1 costs no collective.
"""

from __future__ import annotations

import re
from typing import Iterable

import torch
from torch import nn

from .mesh import axis_sizes
from .sharding import local_shard, param_shardings, shard_tensor


# axes whose ranks hold the same tokens and compute the same loss: a
# parameter the forward does not split over one of them gets the same
# gradient on each of its ranks
SAME_TOKENS = ("model", "expert")


def _split_rule(name: str, rules: Iterable) -> object:
    for pattern, how in rules:
        if re.search(pattern, name):
            return how
    return None


class ShardedParameters:
    """Replace `module`'s parameters by DTensors on `mesh` per `rules`
    (the module must hold the same full values on every rank). `split`:
    mesh axis → ((name regex, how), ...), how the forward keeps a
    parameter split over that axis: the tensor dim it keeps split (when
    the axis divides it), or "partial" (replicated, but used inside a
    split block: its per-rank gradients are partial sums)."""

    def __init__(self, module: nn.Module, mesh, rules, split=None):
        from torch.distributed.tensor import Partial, Replicate, Shard

        self.mesh = mesh
        names = list(mesh.mesh_dim_names)
        sizes = axis_sizes(mesh)
        named = list(module.named_parameters())
        self.storage = param_shardings(named, rules, mesh)
        self.compute: dict[str, list] = {}
        self.grad: dict[str, list] = {}
        for name, p in named:
            compute = [Replicate() for _ in names]
            grad = [Replicate() if sizes[n] == 1 or n in SAME_TOKENS else Partial()
                    for n in names]
            for axis, table in (split or {}).items():
                if sizes.get(axis, 1) == 1:
                    continue
                i = names.index(axis)
                how = _split_rule(name, table)
                if how == "partial":
                    grad[i] = Partial()
                elif isinstance(how, int) and p.shape[how] % sizes[axis] == 0:
                    compute[i] = grad[i] = Shard(how)
            self.compute[name], self.grad[name] = compute, grad
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            setattr(mod, leaf, nn.Parameter(
                shard_tensor(p.detach(), mesh, self.storage[name]),
                requires_grad=p.requires_grad))

    def views(self, params: dict, dtype=None) -> dict:
        """name → the local tensor the forward reads, differentiable back
        to the DTensor parameter."""
        out = {}
        for name, p in params.items():
            t = p.to(dtype) if dtype is not None and p.is_floating_point() else p
            compute = self.compute[name]
            if tuple(compute) != tuple(p.placements):
                t = t.redistribute(self.mesh, compute)
            out[name] = t.to_local(grad_placements=self.grad[name])
        return out

    def reduce_grads(self, module: nn.Module) -> None:
        """Bring each gradient to its parameter's placements: a gradient
        still `Partial` (its view needed no gather) is all-reduced (or
        reduce-scattered) here, once per step whatever the microbatches."""
        for p in module.parameters():
            g = p.grad
            if g is not None and tuple(g.placements) != tuple(p.placements):
                p.grad = g.redistribute(self.mesh, p.placements)

    def load_full(self, module: nn.Module, state: dict) -> None:
        """Copy full tensors (the same on every rank) into the parameters'
        local shards."""
        with torch.no_grad():
            for name, p in module.named_parameters():
                full = torch.as_tensor(state[name]).to(device=p.device, dtype=p.dtype)
                p.to_local().copy_(local_shard(full, self.mesh, p.placements))


def full_tensors(tree):
    """`tree` with every DTensor gathered to its full value (a collective:
    every rank calls it)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tensors(v) for v in tree)
    return tree
