"""Mixture-of-Experts feed-forward with top-1 (switch) routing, counterpart
of `polyaxon_tpu/models/moe.py::MoEFeedForward`.

- Router logits and probabilities in f32; each token goes to its argmax
  expert (ties to the first index) with that expert's probability as its
  gate.
- Capacity C = max(1, int(capacity_factor * S / E)) per batch row: a
  token's place in its expert's queue is the running count over the row
  (a cumsum over S); tokens past C get zeros, so the block's residual
  passes them through unchanged.
- Dispatch and combine are one-hot einsums and the experts' SwiGLU runs on
  the stacked weights `gate_kernel`/`up_kernel` [E, D, F] and
  `down_kernel` [E, F, D] (the reference's layout), all plain PyTorch
  products (plain XLA in the reference, outside any Pallas kernel).
- The load-balancing loss aux_weight * E * sum_e f_e p_e is sown
  (`layers.sow_loss`); the trainer adds it to the training loss only. It
  is computed only inside `layers.collecting()`: an inference forward
  (generate, every serving path) takes no aux loss and issues no
  collective for it.
- There is no pad mask, as in the reference: on the serving paths a
  row's left-pad tokens take places in their experts' queues, and C
  comes from the S of each forward (a bucket's width, a prefill chunk, a
  verify window; a decode step's S = 1 keeps every token).

`router_noise` adds Gaussian noise to the logits in training, drawn from
the dropout generator; its draws differ from `jax.random`'s by
construction (the transformer's MoE leaves it at 0).

Under the trainer's mesh the forward computes what the reference's GSPMD
partitioning of the same einsums computes, on the rank's tokens (its
batch rows, its `context` chunk of the sequence):
- the aux loss takes f_e and p_e over the global batch and sequence (the
  counts all-reduced over the batch axes and `context`; p_e's sum is the
  rank's share, so the ranks' losses add up to the reference's);
- capacity is per row of the global sequence, C from the global S, and a
  token's queue place counts the earlier chunks' tokens first (an
  exclusive prefix sum over `context`);
- over `expert` (which does not split the tokens) each rank runs its own
  experts on all its tokens and the combine sums over the expert ranks
  (`reduce_from`); the tokens and the gates enter through `copy_to`, so
  their gradients are the experts' summed;
- over `model` each expert's hidden units are split (column-parallel
  gate/up, row-parallel down), in training and on a decode mesh
  (`serving/mesh.py`, `MOE_SPLIT["model"]`), where the experts stay whole
  over `batch`.

The stacked kernels may carry more leading dims (a scanned stack's
[n_layers, E, ...]): `reset_with` takes the fan-in from the second to
last dim."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.collectives import (
    all_reduce, axis_group, axis_index, copy_to, exclusive_prefix, reduce_from)
from ..parallel.mesh import BATCH_AXES, axis_sizes
from ..parallel.ring import current_mesh
from ..parallel.ring import model_group as _model_group
from .layers import Dense, draw_block, lecun_normal_, rank_block, sow_loss, sowing


class MoEFeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, n_experts: int,
                 capacity_factor: float = 1.25, router_noise: float = 0.0,
                 aux_weight: float = 0.01, device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.n_experts, self.capacity_factor = n_experts, capacity_factor
        self.ffn_dim = ffn_dim
        self.router_noise, self.aux_weight = router_noise, aux_weight
        self.router = Dense(dim, n_experts, bias=False, **factory)
        E = n_experts
        self.gate_kernel = nn.Parameter(torch.empty(E, dim, ffn_dim, **factory))
        self.up_kernel = nn.Parameter(torch.empty(E, dim, ffn_dim, **factory))
        self.down_kernel = nn.Parameter(torch.empty(E, ffn_dim, dim, **factory))

    @torch.no_grad()
    def reset_with(self, gen: torch.Generator) -> None:
        """The expert kernels (the router, a Dense, resets itself)."""
        for w in (self.gate_kernel, self.up_kernel, self.down_kernel):
            lecun_normal_(w, w.shape[-2], gen)  # fan_in: [.., E, in, out]

    def capacity(self, seq: int) -> int:
        return max(1, int(self.capacity_factor * seq / self.n_experts))

    def _aux_loss(self, mesh, onehot, probs):
        """The load-balancing aux loss (Switch eq. 4): E * sum_e f_e * p_e,
        taken only where a caller collects it (the trainer): an inference
        forward, on a decode mesh too, issues no collective for it."""
        B, S, E = onehot.shape
        tokens = [axis_group(mesh, ax) for ax in (*BATCH_AXES, "context")]
        if any(g is not None for g in tokens):
            # over the global batch and sequence: f_e from the summed
            # counts; p_e's sum is this rank's share, so the ranks' losses
            # add up to the loss and its gradient
            n = all_reduce(torch.tensor(float(B * S), device=onehot.device), tokens)
            density = all_reduce(onehot.sum(dim=(0, 1)), tokens) / n
            return E * torch.sum(density * (probs.sum(dim=(0, 1)) / n))
        return E * torch.sum(onehot.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))

    def forward(self, x, generator=None):
        B, S, D = x.shape
        mesh = current_mesh()
        ctx = axis_group(mesh, "context")
        # capacity per row of the global sequence (the context chunks)
        E, C = self.n_experts, self.capacity(S * axis_sizes(mesh).get("context", 1))
        logits = self.router(x).float()  # [B, S, E]
        if self.training and self.router_noise > 0:
            # this rank's block of the global batch and sequence's noise
            noise = draw_block(
                lambda shape: torch.randn(shape, generator=generator, device=x.device),
                logits.shape, rank_block(logits, seq=True))
            logits = logits + self.router_noise * noise
        probs = torch.softmax(logits, dim=-1)
        onehot = F.one_hot(probs.argmax(-1), E).float()  # [B, S, E]
        gate = (probs * onehot).sum(-1)  # the chosen expert's probability

        if sowing():
            sow_loss(self.aux_weight * self._aux_loss(mesh, onehot, probs))

        # queue place: the running count over the row, after the earlier
        # context chunks' counts
        before = exclusive_prefix(onehot.sum(dim=1), ctx)[:, None, :]  # [B, 1, E]
        position = (torch.cumsum(onehot, dim=1) + before - 1.0) * onehot
        keep = (position < C).float() * onehot
        slot = F.one_hot(position.clamp(max=C - 1).long(), C).float()
        dispatch = keep[..., None] * slot  # [B, S, E, C]

        # the experts this rank holds (all of them without an expert axis)
        group = axis_group(mesh, "expert")
        local = self.gate_kernel.shape[0]
        if local != E:
            if group is None:
                raise ValueError(
                    f"{local} of {E} experts need a bound mesh with an expert axis "
                    "(parallel.ring.set_current_mesh)"
                )
            start = axis_index(mesh, "expert") * local
            dispatch = dispatch[:, :, start:start + local]
        x, gate = copy_to(x, group), copy_to(gate, group)
        combine = dispatch * gate[:, :, None, None]

        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
        wg, wu, wd = (w.to(x.dtype) for w in (self.gate_kernel, self.up_kernel,
                                                self.down_kernel))
        # tensor parallelism inside each expert: this rank's hidden units
        tp = _model_group(wg.shape[-1], self.ffn_dim)
        expert_in = copy_to(expert_in, tp)
        h = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, wg))
        h = h * torch.einsum("ebcd,edf->ebcf", expert_in, wu)
        expert_out = reduce_from(torch.einsum("ebcf,efd->ebcd", h, wd), tp)
        out = torch.einsum("ebcd,bsec->bsd", expert_out, combine.to(x.dtype))
        return reduce_from(out, group)  # the expert ranks' shares summed


# The reference's MOE_RULES (the stacked expert kernels keep its layout:
# [E, D, F] and [E, F, D]; the router, an nn.Linear-shaped Dense, stays
# replicated), and how the forward keeps them split (`parallel/params.py`):
# each rank's experts over `expert`, its hidden units over `model`.
MOE_RULES = (
    (r"(gate_kernel|up_kernel)$", ("expert", "fsdp", "model")),
    (r"down_kernel$", ("expert", "model", "fsdp")),
    (r"router\.weight$", (None, None)),
)
MOE_SPLIT = {
    "expert": ((r"moe\.(gate|up|down)_kernel$", 0),),
    "model": ((r"moe\.(gate|up)_kernel$", 2), (r"moe\.down_kernel$", 1)),
}
