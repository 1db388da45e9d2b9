"""The device mesh from the Polyaxonfile `mesh:` block, counterpart of
`polyaxon_tpu/parallel/mesh.py`.

A rank of the `torch.distributed` world plays the part of a JAX device id:
`mesh_ranks` lays the ranks out exactly as the reference lays its devices
out (`Mesh.devices`), and `build_mesh` names the dims of a
`torch.distributed.device_mesh.DeviceMesh` after the axes, in `AXIS_ORDER`.
Each process drives one device (one GPU, or the CPU under `gloo`).

`slices > 1` is the hybrid (ICI x DCN) mesh: the `data` axis is split
slice-major, so index i of the data axis lives in slice i // (data /
slices), and every other axis stays inside one slice. Slices are
contiguous blocks of ranks, as the reference lays out virtual slices.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

# outer -> inner, the reference's order: the innermost axes (model,
# context) map to adjacent ranks
AXIS_ORDER = ("batch", "pipeline", "data", "fsdp", "expert", "context", "model")

# the global batch dim is split across these
BATCH_AXES = ("batch", "data", "fsdp")

# the serving mesh is deliberately 2-D: see decode_mesh()
DECODE_AXES = ("batch", "model")


def resolve_axis_sizes(
    spec_sizes: Optional[dict[str, int]], n_devices: int
) -> dict[str, int]:
    """Fill the -1 axis, default to pure data parallelism, validate the
    product; the axes in `AXIS_ORDER`."""
    sizes = dict(spec_sizes or {})
    if not sizes:
        sizes = {"data": n_devices}
    fixed = math.prod(v for v in sizes.values() if v != -1)
    fill_axes = [k for k, v in sizes.items() if v == -1]
    if fill_axes:
        if n_devices % fixed != 0:
            raise ValueError(f"mesh {sizes} does not divide {n_devices} devices")
        sizes[fill_axes[0]] = n_devices // fixed
    elif fixed != n_devices:
        raise ValueError(
            f"mesh {sizes} multiplies to {fixed}, but {n_devices} devices present"
        )
    return {ax: sizes[ax] for ax in AXIS_ORDER if ax in sizes}


def mesh_ranks(sizes: dict[str, int], slices: int = 1) -> np.ndarray:
    """The ranks 0..n-1 laid out on the mesh of `sizes` (already resolved,
    in `AXIS_ORDER`): the reference's `Mesh.devices` by device id."""
    n = math.prod(sizes.values())
    shape = tuple(sizes.values())
    if slices <= 1:
        return np.arange(n).reshape(shape)
    if n % slices:
        raise ValueError(f"{n} devices do not split into {slices} slices")
    data = sizes.get("data", 1)
    if data % slices:
        raise ValueError(
            f"multi-slice meshes split the data axis across slices: "
            f"data={data} must be divisible by slices={slices} (mesh {sizes})"
        )
    per_slice = dict(sizes)
    per_slice["data"] = data // slices
    arr = np.arange(n).reshape((slices,) + tuple(per_slice.values()))
    arr = np.moveaxis(arr, 0, list(per_slice).index("data"))
    return arr.reshape(shape)


def build_mesh(
    spec_sizes: Optional[dict[str, int]] = None,
    *,
    slices: int = 1,
    device_type: Optional[str] = None,
):
    """A `DeviceMesh` over the whole world with one dim per axis, named
    after it; `slices > 1` builds the hybrid layout. Needs an initialized
    process group; `device_type` defaults to "cuda" under `nccl` and "cpu"
    otherwise."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs torch.distributed initialized (runtime/worker.py, or "
            "init_process_group with this process's rank and the world size)"
        )
    sizes = resolve_axis_sizes(spec_sizes, dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = tuple(sizes)
    if slices <= 1:
        return init_device_mesh(device_type, tuple(sizes.values()), mesh_dim_names=names)
    ranks = torch.from_numpy(mesh_ranks(sizes, slices))
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def decode_axis_sizes(spec_sizes: Optional[dict[str, int]], n_devices: int) -> dict[str, int]:
    """The `batch` x `model` sizes of a decode mesh over `n_devices` ranks
    (the reference's `decode_mesh` rules): legacy `data`/`fsdp` fold into
    `batch` (giving both is an error), other axes are refused, a missing
    axis is 1 and a -1 takes what the others leave. Raises ValueError when
    the mesh needs more ranks than there are, with both counts."""
    sizes = {ax: int(n) for ax, n in (spec_sizes or {}).items()}
    folded = 1
    for legacy in ("data", "fsdp"):
        n = sizes.pop(legacy, 1)
        folded = -1 if (n == -1 or folded == -1) else folded * n
    if folded != 1:
        if sizes.get("batch", 1) != 1:
            raise ValueError("decode mesh: give `batch` OR legacy data/fsdp, not both")
        sizes["batch"] = folded
    bad = sorted(set(sizes) - set(DECODE_AXES))
    if bad:
        raise ValueError(f"decode mesh allows axes {DECODE_AXES}, got extra {bad}")
    if not sizes:
        n_devices = min(n_devices, 1)
    sizes.setdefault("batch", 1)
    sizes.setdefault("model", 1)
    if -1 in sizes.values():
        sizes = resolve_axis_sizes(sizes, n_devices)
    need = math.prod(sizes.values())
    if need > n_devices:
        raise ValueError(
            f"decode mesh {sizes} needs {need} devices, only {n_devices} visible"
        )
    return {ax: sizes[ax] for ax in DECODE_AXES}


def decode_mesh(spec_sizes: Optional[dict[str, int]] = None, *,
                device_type: Optional[str] = None):
    """The named 2-D serving mesh (`batch` x `model`) over the world's
    first prod(sizes) ranks (`decode_axis_sizes`), the reference's
    `decode_mesh`: `batch` splits concurrent sequences, `model`
    tensor-parallels the seven projections, the embedding's hidden dim and
    the LM head's vocabulary. No spec is one rank. Needs an initialized
    process group; every rank of the world calls it."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a decode mesh needs torch.distributed initialized (one process per "
            "device: init_process_group with this process's rank and the world size)"
        )
    sizes = decode_axis_sizes(spec_sizes, dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(math.prod(sizes.values())).reshape(tuple(sizes.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=DECODE_AXES)


def batch_rows(batch: int, groups: int, index: int):
    """(rows each `batch` group runs, the rows group `index` runs) of a
    decode forward of `batch` rows over `groups` groups: m =
    ceil(batch / groups) contiguous rows a group, the tail padded with
    copies of the last row (whose outputs and writes are dropped)."""
    import torch

    m = max(1, -(-batch // groups))
    return m, torch.arange(index * m, (index + 1) * m).clamp(max=batch - 1)


def is_decode_mesh(mesh) -> bool:
    return mesh is not None and tuple(mesh.mesh_dim_names or ()) == DECODE_AXES


def axis_sizes(mesh) -> dict[str, int]:
    """axis name -> size of a `DeviceMesh` (the reference's `mesh.shape`)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def local_batch_slice(mesh) -> int:
    """How many ways the batch dimension is split on this mesh."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(ax, 1) for ax in BATCH_AXES)
