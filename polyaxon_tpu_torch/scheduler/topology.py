"""Block math over a device grid, an own copy of
`polyaxon_tpu/scheduler/topology.py`: one implementation for sweep
placement (`tuner/placement.py`) and, once ported, the fleet inventory.

A pool of devices declared as a grid (`tpu: {topology: 2x4}` in the
operation's environment) is carved into axis-aligned blocks whose dims
divide the grid's dims, so no two tenants' blocks overlap.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence


def parse_topology(spec) -> Optional[tuple[int, ...]]:
    """V1TpuSpec (or its `topology` string, or an already-parsed dim
    sequence) → dim tuple, else None — including malformed strings
    (callers fall back to list-order splits)."""
    topo = getattr(spec, "topology", spec)
    if isinstance(topo, (tuple, list)):
        if topo and all(isinstance(d, int) and d > 0 for d in topo):
            return tuple(topo)
        return None
    if not topo or not isinstance(topo, str):
        return None
    parts = topo.lower().split("x")
    if not all(p.isdigit() and int(p) > 0 for p in parts):
        return None
    return tuple(int(p) for p in parts)


def divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def choose_block_shape(
    topology: Sequence[int], n_trials: int
) -> tuple[int, ...]:
    """Largest legal sub-grid shape that yields >= n_trials disjoint tiles.

    Legal = every block dim divides its torus dim (blocks tile the torus).
    Among shapes with the minimal sufficient tile count, prefer the most
    balanced block (smallest max/min dim ratio) — balanced sub-tori have
    the best bisection bandwidth for a trial's own collectives."""
    if n_trials <= 0:
        raise ValueError("n_trials must be positive")
    best = None
    for shape in itertools.product(*[divisors(t) for t in topology]):
        tiles = 1
        for t, s in zip(topology, shape):
            tiles *= t // s
        if tiles < n_trials:
            continue
        balance = max(shape) / max(1, min(shape))
        key = (tiles, balance, -min(shape))
        if best is None or key < best[0]:
            best = (key, shape)
    if best is None:  # n_trials > chip count: every trial gets one chip
        return tuple(1 for _ in topology)
    return best[1]


def grid_blocks(
    topology: Sequence[int], block: Sequence[int]
) -> list[list[tuple]]:
    """Coordinate blocks tiling the torus, lexicographic tile order."""
    ranges = [range(0, t, s) for t, s in zip(topology, block)]
    blocks = []
    for origin in itertools.product(*ranges):
        coords = [
            tuple(o + d for o, d in zip(origin, delta))
            for delta in itertools.product(*[range(s) for s in block])
        ]
        blocks.append(coords)
    return blocks


def fits_torus(topology: Sequence[int], block: Sequence[int]) -> bool:
    """True when `block` is a legal sub-grid request for `topology`:
    same rank (after right-padding the block with 1s) and every block
    dim divides its torus dim."""
    if len(block) > len(topology):
        return False
    padded = tuple(block) + (1,) * (len(topology) - len(block))
    return all(t % b == 0 for t, b in zip(topology, padded))
