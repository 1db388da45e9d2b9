"""Scaled-dot-product attention dispatch (counterpart of
`polyaxon_tpu/ops/attention.py`).

Backends:
  xla   — the plain einsum path: f32 scores / sqrt(hd), the -1e30 causal
          mask, f32 softmax, probs cast to q's dtype, kv repeated for GQA.
          (The name is kept from the reference so configs carry over.)
  flash — `ops/flash_attention.py`: the hand-written kernel on CUDA.
  ring / ulysses — context parallelism over the bound mesh's `context`
          axis (`parallel/ring.py`, `parallel/ulysses.py`); without one,
          the flash dispatch.

Under a bound mesh (`parallel.ring.set_current_mesh`) q/k/v are the rank's
local blocks: batch over the batch axes, heads over `model` (each rank runs
the kernel on its own heads), sequence over `context`. With a context axis
of size > 1 every backend attends through the ring, the only one of them
that sees the whole sequence.
"""

from __future__ import annotations

import math

import torch

from .flash_attention import SUPPORTED_HEAD_DIMS, flash_attention

FLASH_MIN_SEQ = 2048
_FLASH_BLOCK_Q = 128  # flash_attention's default q block


def resolve_auto_backend(
    seq_len: int, block_kv: int, head_dim: int | None = None, device="cuda"
) -> str:
    """`auto` policy: the flash kernel on CUDA once seq >= 2048 (where the
    [B,H,S,S] f32 score matrix starts to dominate memory traffic), when both
    blocks divide the sequence and the kernel supports `head_dim`; the
    einsum path otherwise. The reference's TPU guards (Mosaic's
    head_dim % 64, the single-device and mesh rules) do not apply here."""
    if torch.device(device).type != "cuda" or seq_len < FLASH_MIN_SEQ:
        return "xla"
    blocks_ok = (
        seq_len % min(block_kv, seq_len) == 0
        and seq_len % min(_FLASH_BLOCK_Q, seq_len) == 0
    )
    head_ok = head_dim is None or head_dim in SUPPORTED_HEAD_DIMS
    return "flash" if blocks_ok and head_ok else "xla"


def _context_split() -> bool:
    """True when the bound mesh splits the sequence over `context`."""
    from ..parallel.mesh import axis_sizes
    from ..parallel.ring import current_mesh

    return axis_sizes(current_mesh()).get("context", 1) > 1


def dot_product_attention(
    q, k, v, *, causal: bool, backend: str = "xla", block_kv: int = 512
):
    """q: [B, S, H, D]; k/v: [B, S, KV, D] with KV dividing H → [B, S, H, D]."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"query heads {q.shape[2]} not divisible by kv heads {k.shape[2]}"
        )
    if backend == "auto":
        backend = resolve_auto_backend(
            q.shape[1], block_kv, q.shape[-1], device=q.device
        )
    if backend in ("ring", "ulysses") or _context_split():
        from ..parallel.ring import ring_attention
        from ..parallel.ulysses import ulysses_attention

        fn = ulysses_attention if backend == "ulysses" else ring_attention
        return fn(q, k, v, causal=causal, block_kv=block_kv)
    return local_attention(q, k, v, causal=causal, backend=backend, block_kv=block_kv)


def local_attention(q, k, v, *, causal: bool, backend: str = "xla", block_kv: int = 512):
    """The `flash` or `xla` backend on the tensors as given (a rank's own
    batch and heads over its whole sequence)."""
    if backend == "flash":
        return flash_attention(q, k, v, causal=causal, block_kv=block_kv)
    if backend != "xla":
        raise ValueError(f"unknown attention backend {backend!r}")
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    hd = q.shape[-1]
    # f32 scores from the input dtype's exact products (preferred_element_type)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        S = q.shape[1]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
