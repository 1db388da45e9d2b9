"""Parameter and batch sharding: the models' logical rules as DTensor
placements, counterpart of `polyaxon_tpu/parallel/sharding.py`.

A model declares `(name-regex, logical-axes)` rules (`models/registry.py`
`ModelBundle.sharding_rules`). Each parameter's name is matched against
them and the first match gives one entry per tensor dim: a mesh axis, a
tuple of axes (the first one major), or None. Axes missing from the mesh,
of size 1, or not dividing the dim degrade to replication (`live_axes`),
so one rule set serves every mesh. `_spec_for` returns that entry tuple,
the reference's `PartitionSpec`; `placements` turns it into one DTensor
placement per mesh dim: `Shard(d)` where an axis splits tensor dim d,
`Replicate()` elsewhere, and `_StridedShard` where a dim is split by two
axes in the opposite order to the mesh's (the embedding's
`("model", "fsdp")`, model major on a mesh that lists fsdp first), so a
rank's local shard is the one the reference's device holds.

The rules are written against the port's parameter names and layouts:
`nn.Linear` keeps `weight` as [out, in] where flax keeps `kernel` as [in,
out], so a kernel rule's two entries appear swapped (`models/transformer.py`
`TRANSFORMER_RULES`).

`constrain` is the reference's sharding hint. The forward computes on
local tensors that already hold the rank's shard in the layout the hint
names, so on a plain tensor it is the identity; a DTensor is redistributed
only when its placements differ from the hint's.
"""

from __future__ import annotations

import contextlib
import re
import threading
from typing import Iterable, Optional

import torch

from .mesh import BATCH_AXES, axis_sizes


def live_axes(mesh, axes, dim_size: int) -> tuple:
    """Subset of `axes` present in `mesh` whose joint product divides
    `dim_size`: an axis that does not divide is dropped (replicate) while
    the rest keep sharding."""
    sizes = axis_sizes(mesh)
    live: list = []
    size = 1
    for a in axes:
        if not a or sizes.get(a, 1) == 1:
            continue
        if dim_size % (size * sizes[a]) == 0:
            live.append(a)
            size *= sizes[a]
    return tuple(live)


def _as_spec_entry(live: tuple):
    if not live:
        return None
    return live[0] if len(live) == 1 else tuple(live)


def _resolve(axes, shape, mesh) -> tuple:
    resolved = []
    for i, ax in enumerate(tuple(axes)[: len(shape)]):
        cands = ax if isinstance(ax, tuple) else (ax,)
        resolved.append(_as_spec_entry(live_axes(mesh, cands, shape[i])))
    while resolved and resolved[-1] is None:
        resolved.pop()
    return tuple(resolved)


def _spec_for(path: str, shape, rules, mesh) -> tuple:
    """The reference's PartitionSpec of one parameter, as a tuple of
    entries (trailing Nones dropped); () replicates."""
    for pattern, axes in rules:
        if re.search(pattern, path):
            return _resolve(axes, shape, mesh)
    return ()


def placements(spec: tuple, mesh) -> tuple:
    """A spec tuple → one DTensor placement per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for j, ax in enumerate(axes):
            # axes major to `ax` that the mesh lists after it split first
            factor = 1
            for major in axes[:j]:
                if names.index(major) > names.index(ax):
                    factor *= sizes[major]
            out[names.index(ax)] = (
                _StridedShard(dim, split_factor=factor) if factor > 1 else Shard(dim)
            )
    return tuple(out)


def param_specs(named_params: Iterable, rules, mesh) -> dict[str, tuple]:
    """name → spec tuple for (name, tensor) pairs."""
    return {n: _spec_for(n, tuple(p.shape), rules, mesh) for n, p in named_params}


def param_shardings(named_params: Iterable, rules, mesh) -> dict[str, tuple]:
    """name → DTensor placements for (name, tensor) pairs."""
    return {n: placements(s, mesh) for n, s in param_specs(named_params, rules, mesh).items()}


def batch_sharding(mesh, extra_axes: Optional[dict[str, str]] = None) -> tuple:
    """Placements of a batch array: its batch dim over the batch axes of
    size > 1 (data major), plus e.g. {'1': 'context'} to shard the
    sequence dim for context parallelism."""
    sizes = axis_sizes(mesh)
    spec: list = [_as_spec_entry(tuple(ax for ax in BATCH_AXES if sizes.get(ax, 1) > 1))]
    for d, ax in (extra_axes or {}).items():
        spec += [None] * (int(d) - len(spec) + 1)
        if sizes.get(ax, 1) > 1:
            spec[int(d)] = ax
    return placements(tuple(spec), mesh)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def shard_tensor(full: torch.Tensor, mesh, pl) -> "torch.distributed.tensor.DTensor":
    """A DTensor of `full` (the same on every rank) with placements `pl`:
    each rank keeps its own shard; no communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full, mesh, list(pl), src_data_rank=None)


def local_shard(full: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's shard of `full` under placements `pl`."""
    return shard_tensor(full, mesh, pl).to_local()


_CONSTRAIN_STATE = threading.local()


@contextlib.contextmanager
def suspend_constraints():
    """Disable `constrain` inside code that works on per-rank views."""
    prev = getattr(_CONSTRAIN_STATE, "suspended", False)
    _CONSTRAIN_STATE.suspended = True
    try:
        yield
    finally:
        _CONSTRAIN_STATE.suspended = prev


def constraints_suspended() -> bool:
    return getattr(_CONSTRAIN_STATE, "suspended", False)


def constrain(x, *axes):
    """Pin `x`'s layout to `axes` (mesh axes or tuples of them, per dim) on
    the bound mesh (`parallel.ring.current_mesh`). A plain tensor is
    already this rank's shard in the forward's layout: returned as it is.
    A DTensor is redistributed only when its placements differ."""
    from torch.distributed.tensor import DTensor

    from .ring import current_mesh

    mesh = current_mesh()
    if mesh is None or constraints_suspended() or not isinstance(x, DTensor):
        return x
    target = placements(_resolve(axes, tuple(x.shape), mesh), mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, list(target))


def make_global_batch(batch: dict, mesh, pl) -> dict:
    """Host batch (the same on every rank) → this rank's slice of each
    array under placements `pl` (`batch_sharding`), as local tensors."""
    return {k: local_shard(torch.as_tensor(v), mesh, pl) for k, v in batch.items()}
