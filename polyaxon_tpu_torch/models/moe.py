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
  (`layers.sow_loss`); the trainer adds it to the training loss only.

`router_noise` adds Gaussian noise to the logits in training, drawn from
the dropout generator; its draws differ from `jax.random`'s by
construction (the transformer's MoE leaves it at 0)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Dense, lecun_normal_, sow_loss


class MoEFeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, n_experts: int,
                 capacity_factor: float = 1.25, router_noise: float = 0.0,
                 aux_weight: float = 0.01, device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.n_experts, self.capacity_factor = n_experts, capacity_factor
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
            lecun_normal_(w, w.shape[1], gen)

    def capacity(self, seq: int) -> int:
        return max(1, int(self.capacity_factor * seq / self.n_experts))

    def forward(self, x, generator=None):
        B, S, D = x.shape
        E, C = self.n_experts, self.capacity(S)
        logits = self.router(x).float()  # [B, S, E]
        if self.training and self.router_noise > 0:
            noise = torch.randn(logits.shape, generator=generator, device=x.device)
            logits = logits + self.router_noise * noise
        probs = torch.softmax(logits, dim=-1)
        onehot = F.one_hot(probs.argmax(-1), E).float()  # [B, S, E]
        gate = (probs * onehot).sum(-1)  # the chosen expert's probability

        # load-balancing aux loss (Switch eq. 4): E * sum_e f_e * p_e
        aux = E * torch.sum(onehot.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
        sow_loss(self.aux_weight * aux)

        position = (torch.cumsum(onehot, dim=1) - 1.0) * onehot  # queue place
        keep = (position < C).float() * onehot
        slot = F.one_hot(position.clamp(max=C - 1).long(), C).float()
        dispatch = keep[..., None] * slot  # [B, S, E, C]
        combine = dispatch * gate[:, :, None, None]

        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(x.dtype), x)
        wg, wu, wd = (w.to(x.dtype) for w in (self.gate_kernel, self.up_kernel,
                                                self.down_kernel))
        h = F.silu(torch.einsum("ebcd,edf->ebcf", expert_in, wg))
        h = h * torch.einsum("ebcd,edf->ebcf", expert_in, wu)
        expert_out = torch.einsum("ebcf,efd->ebcd", h, wd)
        return torch.einsum("ebcd,bsec->bsd", expert_out, combine.to(x.dtype))
