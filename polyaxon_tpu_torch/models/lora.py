"""The LoRA delta of a projection, single or slot-stacked (the reference's
`LoRADense`, `polyaxon_tpu/models/transformer.py:150-215`).

Single adapter: `lora_a` [in, r], `lora_b` [r, out] and
delta = (x A) B. Slot-stacked (multi-tenant serving, `adapter_slots > 0`):
`lora_a` [slots, in, r], `lora_b` [slots, r, out], and row b of the batch
gathers slot `adapter_ix[b]` (slot 0 for every row when `adapter_ix` is
None), so one batch mixes tenants. The gathered factors are rank-r slivers,
activation-sized, and the two products are batched matmuls; a row's delta
does not depend on which slot its adapter sits in or who shares its batch.
"""

from __future__ import annotations

import torch


def lora_delta(x, a, b, adapter_ix=None) -> torch.Tensor:
    """(x A) B in x's dtype, x [B, ..., in]; A and B are single [in, r] /
    [r, out] or stacked [slots, in, r] / [slots, r, out] factors, gathered
    per row by `adapter_ix` [B] (long, on x's device)."""
    if a.dim() == 2:
        return (x @ a.to(x.dtype)) @ b.to(x.dtype)
    B = x.shape[0]
    if adapter_ix is None:
        adapter_ix = torch.zeros(B, dtype=torch.long, device=x.device)
    aa = a.index_select(0, adapter_ix).to(x.dtype)  # [B, in, r]
    bb = b.index_select(0, adapter_ix).to(x.dtype)  # [B, r, out]
    delta = torch.bmm(torch.bmm(x.reshape(B, -1, x.shape[-1]), aa), bb)
    return delta.reshape(*x.shape[:-1], bb.shape[-1])


def run_proj(proj, x, adapter_ix=None):
    """Apply a projection, routing the per-row adapter slots only to LoRA
    projections (the reference's `_run_proj`); without `adapter_ix` every
    projection is called exactly as before slots existed."""
    if adapter_ix is not None and hasattr(proj, "lora_a"):
        return proj(x, adapter_ix)
    return proj(x)
