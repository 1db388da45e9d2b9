"""Blockwise (flash) attention forward: a hand-written Hopper kernel.

Counterpart of `polyaxon_tpu/ops/flash_attention.py`. Same public API and
the same validation, forward only:

- on CUDA tensors `flash_attention` / `flash_attention_lse` launch the
  CUDA kernel in `csrc/flash_fwd.cu` (built at first use by `_build.py`)
  or raise; nothing falls back to another implementation;
- on CPU tensors they run `flash_attention_reference`, the plain PyTorch
  version of the same function, which the tests hold against the JAX
  package and `chip_smoke.py` holds the kernel against on the card.

The kernel has no backward yet: under grad mode with an input that
requires grad the CUDA path raises NotImplementedError (the backward
kernels are the training slice in ROADMAP.md).

`block_q`/`block_kv` are the TPU kernel's tile sizes. They are validated
exactly as the reference validates them, so callers see the same errors;
the CUDA kernel tiles by 64 x 64 for the SM, which changes only the order
of f32 sums, not the function.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_shapes_ok(seq: int, block_q: int = 128, block_kv: int = 128) -> bool:
    """True when `seq` divides into both (clamped) blocks and each block is
    the whole sequence or a multiple of 8 — the reference's predicate."""
    bq, bkv = min(block_q, seq), min(block_kv, seq)
    if seq % bq or seq % bkv:
        return False
    return all(b == seq or b % 8 == 0 for b in (bq, bkv))


def _check(q, k, v, block_q, block_kv):
    B, S, H, D = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"query heads {H} not divisible by kv heads {KV}")
    block_q = min(block_q, S)
    block_kv = min(block_kv, S)
    if S % block_q or S % block_kv:
        raise ValueError(f"seq len {S} not divisible by blocks {block_q}/{block_kv}")
    if k.shape != (B, S, KV, D) or v.shape != k.shape:
        raise ValueError(
            f"k/v must be [B, S, KV, D] = {(B, S, KV, D)}; "
            f"got {tuple(k.shape)} / {tuple(v.shape)}"
        )


def flash_attention_reference(q, k, v, *, causal=True, sm_scale=None):
    """Plain PyTorch version of the kernel: (o [B,S,H,D], lse [B,H,S] f32).

    Same arithmetic as the TPU kernel, in one block: f32 scores scaled
    after the dot, the -1e30 causal mask, p = exp(s - max) rounded to v's
    dtype before P.V, o = acc / max(l, 1e-30), lse = max + log(l)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    # query head h reads kv head h // G: repeat_interleave == jnp.repeat
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vv.float())
    o = (acc / l).to(q.dtype).transpose(1, 2)
    return o, (m + torch.log(l)).squeeze(-1)


class FlashFwdKernel:
    """ctypes binding of `polyaxon_flash_fwd` with its launch count.

    `launches` goes up by one each time the CUDA kernel is launched, and
    nowhere else, so a run can show that its main path went through it."""

    name = "flash_fwd"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            from ._build import load

            fn = load(self.name).polyaxon_flash_fwd
            fn.argtypes = (
                [ctypes.c_void_p] * 5
                + [ctypes.c_int] * 6
                + [ctypes.c_longlong] * 9
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q, k, v, *, causal: bool, scale: float):
        """q [B,S,H,D], k/v [B,S,KV,D] on one CUDA device → (o, lse)."""
        B, S, H, D = q.shape
        KV = k.shape[2]
        if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(
                f"flash kernel takes float32 or bfloat16 q/k/v of one dtype; "
                f"got {q.dtype}/{k.dtype}/{v.dtype}"
            )
        if D not in SUPPORTED_HEAD_DIMS:
            raise ValueError(
                f"flash kernel supports head_dim {SUPPORTED_HEAD_DIMS}; got {D}"
            )
        if not (q.device == k.device == v.device):
            raise ValueError("q, k and v must be on one device")
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            raise ValueError("flash kernel needs a contiguous last (head) dim")
        if B * H > 65535:
            raise ValueError(f"B*H = {B * H} exceeds the kernel grid limit 65535")
        fn = self._bind()
        o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), lse.data_ptr(),
                _DTYPE_CODES[q.dtype], B, S, H, KV, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                float(scale), int(bool(causal)), stream,
            )
        if err != 0:
            raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
        self.launches += 1
        return o, lse


FLASH_FWD = FlashFwdKernel()


def _forward(q, k, v, causal, block_q, block_kv, sm_scale):
    _check(q, k, v, block_q, block_kv)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention on CUDA is forward-only: its backward kernels "
            "(_dq_kernel/_dkv_kernel) are the training slice in ROADMAP.md; "
            "run under torch.no_grad()/inference_mode()"
        )
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return FLASH_FWD(q, k, v, causal=causal, scale=scale)


def flash_attention_lse(
    q, k, v, *, causal=True, block_q=128, block_kv=128, sm_scale=None
):
    """flash_attention that also returns the logsumexp:
    (o [B,S,H,D], lse [B,H,S] f32)."""
    return _forward(q, k, v, causal, block_q, block_kv, sm_scale)


def flash_attention(
    q, k, v, *, causal=True, block_q=128, block_kv=128, sm_scale=None
):
    """q: [B, S, H, D]; k/v: [B, S, KV, D] with KV dividing H → [B, S, H, D].

    GQA is native: query head h reads kv head h // (H / KV); K/V are never
    repeated in device memory on the CUDA path."""
    return _forward(q, k, v, causal, block_q, block_kv, sm_scale)[0]
