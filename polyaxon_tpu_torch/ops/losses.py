"""Loss registry, counterpart of `polyaxon_tpu/ops/losses.py`.

All losses take (logits, batch) and return a scalar f32, computed in
float32 whatever the compute dtype. Batch schema: a dict with "inputs" plus
task-specific targets:
  classification: "labels" int [B]
  mlm:            "labels" int [B,S] with -100 = unmasked (ignored)
  lm:             "labels" int [B,S] shifted next-token targets, -100 pad

`fused_linear_masked_lm` is the chunked lm-head + cross-entropy: plain
PyTorch matrix products (the reference leaves them to XLA), with the chunk
logits as f32 products of the operands, as `preferred_element_type=f32`
gives them there.
"""

from __future__ import annotations

from typing import Callable

import torch

_LOSSES: dict[str, Callable] = {}


def register_loss(name: str):
    def deco(fn):
        _LOSSES[name] = fn
        return fn

    return deco


def build_loss(name: str) -> Callable:
    if name not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}; registered: {sorted(_LOSSES)}")
    return _LOSSES[name]


def _cross_entropy(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels: logsumexp - the
    label's logit, per position, in f32."""
    logits = logits.float()
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


@register_loss("softmax_cross_entropy")
def softmax_cross_entropy(logits, batch):
    return _cross_entropy(logits, batch["labels"]).mean()


@register_loss("masked_lm")
def masked_lm(logits, batch):
    """Cross entropy over positions with label != -100 (BERT MLM / causal
    LM), as a masked mean."""
    labels = batch["labels"]
    mask = (labels != -100).float()
    safe = torch.where(labels == -100, torch.zeros_like(labels), labels)
    losses = _cross_entropy(logits, safe)
    return (losses * mask).sum() / mask.sum().clamp_min(1.0)


@register_loss("mse")
def mse(logits, batch):
    target = batch["labels"].float()
    return ((logits.float() - target) ** 2).mean()


def accuracy(logits, batch) -> torch.Tensor:
    """Classification accuracy metric (not a loss)."""
    labels = batch["labels"]
    pred = logits.argmax(-1)
    if labels.ndim == pred.ndim:  # token-level with ignore index
        mask = (labels != -100).float()
        hits = (pred == labels).float() * mask
        return hits.sum() / mask.sum().clamp_min(1.0)
    return (pred == labels).float().mean()


# ---------------------------------------------------------- fused lm head
def fused_linear_masked_lm(features, kernel, labels, *, chunk_size=8192):
    """Masked LM cross-entropy straight from pre-head FEATURES: the lm-head
    product and the softmax run over vocab chunks with an online logsumexp,
    so the [B, S, V] logits never exist; the backward recomputes each
    chunk's logits instead of saving them. Peak extra memory is one [N, C]
    f32 block.

    features: [B, S, D] (any float dtype; math accumulates f32)
    kernel:   [D, V] lm-head weight (the reference's orientation: pass
              `lm_head.weight.T`, or `embed.weight.T` when tied)
    labels:   [B, S] int, -100 = ignore
    → scalar f32 mean over unmasked positions (the same as `masked_lm`).
    """
    if chunk_size < 1:
        raise ValueError(f"fused_loss_chunk must be >= 1, got {chunk_size}")
    B, S, D = features.shape
    return _FusedLinearMaskedLM.apply(
        features.reshape(B * S, D), kernel, labels.reshape(B * S), int(chunk_size)
    )


def _chunks(V, chunk_size):
    return [(lo, min(lo + chunk_size, V)) for lo in range(0, V, chunk_size)]


def _chunk_logits(x32, kernel, lo, hi):
    # f32 products of the operands' values, accumulated in f32
    return x32 @ kernel[:, lo:hi].float()


class _FusedLinearMaskedLM(torch.autograd.Function):
    """`_fused_lm` with its custom VJP (`_fused_lm_fwd` / `_fused_lm_bwd`)."""

    @staticmethod
    def forward(ctx, x, kernel, flat, chunk_size):
        N, V = x.shape[0], kernel.shape[1]
        x32 = x.float()
        mask = (flat != -100).float()
        safe = torch.where(flat == -100, torch.zeros_like(flat), flat).long()
        m = torch.full((N,), float("-inf"), device=x.device)
        l = torch.zeros(N, device=x.device)
        label_logit = torch.zeros(N, device=x.device)
        for lo, hi in _chunks(V, chunk_size):
            logits = _chunk_logits(x32, kernel, lo, hi)  # [N, C] f32
            m_new = torch.maximum(m, logits.amax(1))
            l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(1)
            m = m_new
            in_chunk = (safe >= lo) & (safe < hi)
            idx = (safe - lo).clamp(0, hi - lo - 1)
            picked = logits.gather(1, idx[:, None])[:, 0]
            label_logit = torch.where(in_chunk, picked, label_logit)
        lse = m + torch.log(l)
        denom = mask.sum().clamp_min(1.0)
        ctx.save_for_backward(x, kernel, lse, mask, safe, denom)
        ctx.chunk_size = chunk_size
        return ((lse - label_logit) * mask).sum() / denom

    @staticmethod
    def backward(ctx, dloss):
        x, kernel, lse, mask, safe, denom = ctx.saved_tensors
        V = kernel.shape[1]
        x32 = x.float()
        # d loss / d logits[n, v] = (softmax - onehot) * mask_n / denom * dloss
        scale = (mask / denom * dloss)[:, None]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dws = []
        for lo, hi in _chunks(V, ctx.chunk_size):
            logits = _chunk_logits(x32, kernel, lo, hi)  # recomputed
            p = torch.exp(logits - lse[:, None])
            in_chunk = (safe >= lo) & (safe < hi)
            idx = (safe - lo).clamp(0, hi - lo - 1)
            onehot = torch.zeros_like(p).scatter_(1, idx[:, None], 1.0)
            g = (p - onehot * in_chunk[:, None]) * scale  # [N, C] f32
            w = kernel[:, lo:hi].float()
            dx = dx + g @ w.T
            dws.append(x32.T @ g)
        dkernel = torch.cat(dws, dim=1).to(kernel.dtype)
        return dx.to(x.dtype), dkernel, None, None
