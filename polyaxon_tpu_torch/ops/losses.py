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

Under a mesh (`runtime/trainer.py`) every loss, `accuracy` and the fused
loss take `count`: the global number of counted positions, examples or
elements (summed over the ranks that split the batch and the sequence),
so a rank returns its share of the global mean and the shares add up to
it, not to a mean of per-rank means. `masked_lm`, `accuracy` and the
fused loss also take `vocab=(group, start)`: the logits (or the lm
head) are this rank's slice [start, start + V_local) of a vocabulary split
over `group` (the `model` axis); the logsumexp's max and sum are
all-reduced over it and the target logit comes from the rank that owns it.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..parallel.collectives import reduce_from

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


def _cross_entropy(logits, labels, vocab=None):
    """optax.softmax_cross_entropy_with_integer_labels: logsumexp - the
    label's logit, per position, in f32 (vocabulary-split with `vocab`)."""
    logits = logits.float()
    if vocab is None:
        picked = logits.gather(-1, labels.long()[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - picked
    group, start = vocab
    n = logits.shape[-1]
    m = logits.detach().amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    lse = m + torch.log(reduce_from(torch.exp(logits - m[..., None]).sum(-1), group))
    local = labels.long() - start
    owned = (local >= 0) & (local < n)
    picked = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse - reduce_from(torch.where(owned, picked, 0.0), group)


@register_loss("softmax_cross_entropy")
def softmax_cross_entropy(logits, batch, *, count=None):
    losses = _cross_entropy(logits, batch["labels"])
    return losses.mean() if count is None else losses.sum() / count


@register_loss("masked_lm")
def masked_lm(logits, batch, *, count=None, vocab=None):
    """Cross entropy over positions with label != -100 (BERT MLM / causal
    LM), as a masked mean (over `count` positions when given)."""
    labels = batch["labels"]
    mask = (labels != -100).float()
    safe = torch.where(labels == -100, torch.zeros_like(labels), labels)
    losses = _cross_entropy(logits, safe, vocab)
    denom = mask.sum() if count is None else count
    return (losses * mask).sum() / denom.clamp_min(1.0)


@register_loss("mse")
def mse(logits, batch, *, count=None):
    target = batch["labels"].float()
    err = (logits.float() - target) ** 2
    return err.mean() if count is None else err.sum() / count


def accuracy(logits, batch, *, count=None, vocab=None) -> torch.Tensor:
    """Classification accuracy metric (not a loss)."""
    labels = batch["labels"]
    pred = logits.argmax(-1)
    if vocab is not None:  # the global argmax: the lowest index of the max
        group, start = vocab
        best = logits.amax(-1)
        top = best.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        pred = torch.where(best == top, pred + start, torch.iinfo(torch.long).max)
        dist.all_reduce(pred, op=dist.ReduceOp.MIN, group=group)
    if labels.ndim == pred.ndim:  # token-level with ignore index
        mask = (labels != -100).float()
        hits = (pred == labels).float() * mask
        denom = mask.sum() if count is None else count
        return hits.sum() / denom.clamp_min(1.0)
    hits = (pred == labels).float()
    return hits.mean() if count is None else hits.sum() / count


# ---------------------------------------------------------- fused lm head
def fused_linear_masked_lm(features, kernel, labels, *, chunk_size=8192, count=None,
                           vocab=None):
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

    With `vocab=(group, start)` the kernel is this rank's [D, V_local]
    slice; the features' gradient is then this rank's part, which the
    caller sums over the group (`parallel.collectives.copy_to`).
    """
    if chunk_size < 1:
        raise ValueError(f"fused_loss_chunk must be >= 1, got {chunk_size}")
    B, S, D = features.shape
    return _FusedLinearMaskedLM.apply(
        features.reshape(B * S, D), kernel, labels.reshape(B * S), int(chunk_size),
        count, vocab,
    )


def _chunks(V, chunk_size):
    return [(lo, min(lo + chunk_size, V)) for lo in range(0, V, chunk_size)]


def _chunk_logits(x32, kernel, lo, hi):
    # f32 products of the operands' values, accumulated in f32
    return x32 @ kernel[:, lo:hi].float()


class _FusedLinearMaskedLM(torch.autograd.Function):
    """`_fused_lm` with its custom VJP (`_fused_lm_fwd` / `_fused_lm_bwd`)."""

    @staticmethod
    def forward(ctx, x, kernel, flat, chunk_size, count, vocab):
        N, V = x.shape[0], kernel.shape[1]
        x32 = x.float()
        mask = (flat != -100).float()
        safe = torch.where(flat == -100, torch.zeros_like(flat), flat).long()
        if vocab is not None:  # label ids relative to this rank's slice
            safe = safe - vocab[1]
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
        if vocab is not None:
            m_all = m.clone()
            dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=vocab[0])
            l = l * torch.exp(m - m_all)
            dist.all_reduce(l, group=vocab[0])
            dist.all_reduce(label_logit, group=vocab[0])
            m = m_all
        lse = m + torch.log(l)
        denom = (mask.sum() if count is None else count).clamp_min(1.0)
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
        return dx.to(x.dtype), dkernel, None, None, None, None
