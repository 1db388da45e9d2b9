"""Trial placement, the port's counterpart of `polyaxon_tpu/tuner/placement.py`:
concurrent Polytune trials get disjoint groups of the device pool.

The pool is the card's CUDA devices in index order (`device_pool`), or
the list a caller passes. With a declared grid (`tpu: {topology: 2x4}` in
the operation's environment) whose product is the pool's size, trials get
axis-aligned blocks of that grid; without one, contiguous equal splits of
the pool. A device is never split between trials: one card gives one
group, and `SweepDriver` then runs its trials one at a time. Groups are the
same blocks of indices that the reference makes from its device ids.

The block math is shared with the fleet (`scheduler/topology.py`)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

from ..scheduler.topology import (  # noqa: F401 — re-exported for callers
    choose_block_shape,
    grid_blocks,
    parse_topology,
)


def device_pool(device=None) -> list:
    """The devices trials share: every visible CUDA device in index order
    when `device` (default: `POLYAXON_TORCH_DEVICE`, unset meaning the
    card) is `cuda` without an index, else `device` alone (one card, or
    the CPU)."""
    import torch

    from ..device import env_device, resolve_device

    dev = resolve_device(device if device is not None else env_device())
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def sub_slices(
    n_trials: int,
    devices: Optional[list] = None,
    topology: Optional[Sequence[int]] = None,
) -> list[list]:
    """Partition devices into up to n_trials disjoint groups.

    Returns fewer groups than requested when devices don't divide: the
    caller then throttles trial concurrency to len(result)."""
    devices = list(devices) if devices is not None else device_pool()
    n = len(devices)
    if n_trials <= 0:
        raise ValueError("n_trials must be positive")

    if topology is not None:
        if math.prod(topology) != n:
            raise ValueError(
                f"topology {tuple(topology)} names {math.prod(topology)} chips "
                f"but {n} devices are available"
            )
        block = choose_block_shape(topology, n_trials)
        # the grid is the pool in index order, row-major
        strides = [math.prod(topology[i + 1:]) for i in range(len(topology))]
        blocks = grid_blocks(topology, block)[:n_trials]
        return [
            [devices[sum(c * s for c, s in zip(coord, strides))] for coord in coords]
            for coords in blocks
        ]

    group = max(1, n // n_trials)
    # keep groups equal-sized: drop the ragged tail trials, never split a
    # device between trials
    n_groups = min(n_trials, n // group)
    return [devices[i * group : (i + 1) * group] for i in range(n_groups)]
