"""Pipeline parallelism: the GPipe schedule over the mesh's `pipeline`
axis, counterpart of `polyaxon_tpu/parallel/pipeline.py`.

Each rank of the `pipeline` group holds one stage's weights (the stacked
[P, Lp, ...] parameters placed `Shard(0)` over `pipeline`, so its local
slice is [1, Lp, ...]). The schedule is the reference's wavefront:
T = n_micro + P - 1 ticks; at tick t stage 0 takes microbatch t (zeros
past the last one), every other stage the activation its predecessor sent
at tick t - 1, every stage applies its layers, and the activation moves on
to the next stage through the differentiable `ppermute`. The last stage
collects microbatch t - (P - 1) from tick P - 1 on, and its output reaches
every rank of the group through `broadcast_from`, so the final norm and
the head run as on any other mesh.

Every stage computes at every tick, as in the reference (its `where`
selects the input): the ranks' autograd graphs then hold the same
collectives in the same order, and the backward wavefront comes from
autograd running them in reverse, each `ppermute`'s backward sending the
cotangents back the way the activations came. The stages' outputs at the
bubble ticks reach no loss and get zero cotangents.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .collectives import broadcast_from, ppermute


def pipeline_apply(stage_fn: Callable, stage_params: dict, x: torch.Tensor, *,
                   group, n_micro: int, stages: int) -> torch.Tensor:
    """`stage_fn(params, h) -> h'` as a P-stage pipeline over `group`.

    stage_params: name → this rank's stage slice [1, Lp, ...] of the
    `stages` stacked ones; x: [B, ...] this rank's activations (the same on
    every stage); returns [B, ...], the last stage's output on every
    member."""
    n_stages = dist.get_world_size(group)
    if stages != n_stages:
        raise ValueError(
            f"stage_params leading dim {stages} != pipeline axis size {n_stages}")
    stage = dist.get_rank(group)
    params = {k: v[0] for k, v in stage_params.items()}
    B = x.shape[0]
    if B < n_micro or B % n_micro:
        raise ValueError(
            f"per-device batch {B} must be a multiple of pipeline_microbatches {n_micro}"
        )
    xs = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    zeros = torch.zeros_like(xs[0])
    first = torch.tensor(stage == 0, device=x.device)
    carry = zeros  # the activation arriving from the previous stage
    outs = []
    T = n_micro + n_stages - 1
    for t in range(T):
        feed = xs[t] if t < n_micro else zeros
        y = stage_fn(params, torch.where(first, feed, carry))
        if t >= n_stages - 1:  # the last stage emits microbatch t - (P - 1)
            outs.append(y)
        if t != T - 1:
            (carry,) = ppermute([y], group, 1)
    out = torch.stack(outs).reshape(B, *x.shape[1:])
    return broadcast_from(out, group, n_stages - 1)
