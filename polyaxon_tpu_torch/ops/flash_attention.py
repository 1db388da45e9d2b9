"""Blockwise (flash) attention, forward and backward: hand-written Hopper
kernels.

Counterpart of `polyaxon_tpu/ops/flash_attention.py`. Same public API and
the same validation:

- on CUDA tensors `flash_attention` / `flash_attention_lse` launch the
  forward kernel in `csrc/flash_fwd.cu`, and their gradients the backward
  kernels in `csrc/flash_bwd.cu` (dq, then dk/dv), built at first use by
  `_build.py`, or raise; nothing falls back to another implementation. In
  both directions bf16 runs on the tensor cores (wgmma) and f32 on the
  CUDA cores (scalar FMA);
- on CPU tensors they run `flash_attention_reference` and
  `flash_attention_bwd_reference`, the plain PyTorch versions of the same
  functions, through the same `torch.autograd.Function`s. The tests hold
  them against the JAX package, and `chip_smoke.py` holds the kernels
  against them on the card.

`block_q`/`block_kv` are the TPU kernels' tile sizes. They are validated
exactly as the reference validates them, so callers see the same errors;
the CUDA kernels tile by 64 x 64 for the SM, which changes only the order
of f32 sums, not the function. The bf16 kernels, forward and backward,
read q, k, v (and dO) by stride but need 16-byte aligned rows; the wrappers
raise otherwise.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64  # rows of the CUDA kernels' q and kv tiles


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


def _scores(q, kk, causal, scale):
    """f32 scores [B,H,Sq,Sk] scaled after the dot, with the -1e30 mask."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    return s


def flash_attention_reference(q, k, v, *, causal=True, sm_scale=None):
    """Plain PyTorch version of the forward kernel: (o [B,S,H,D], lse
    [B,H,S] f32).

    Same arithmetic as the TPU kernel, in one block: f32 scores scaled
    after the dot, the -1e30 causal mask, p = exp(s - max) rounded to v's
    dtype before P.V, o = acc / max(l, 1e-30), lse = max + log(l)."""
    G = q.shape[2] // k.shape[2]
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    # query head h reads kv head h // G: repeat_interleave == jnp.repeat
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2)
    s = _scores(q, kk, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vv.float())
    o = (acc / l).to(q.dtype).transpose(1, 2)
    return o, (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_reference(
    q, k, v, o, lse, do, delta, *, causal=True, sm_scale=None
):
    """Plain PyTorch version of the backward kernels (`_bwd_impl`):
    (q, k, v, o, lse [B,H,S], dO, delta [B,H,S]) → (dq, dk, dv).

    p = exp(s - lse), ds = p * (dO.V^T - delta) * scale, with the TPU
    kernels' rounding points: ds to k's dtype before ds.K, p to dO's dtype
    before p^T.dO, ds to q's dtype before ds^T.Q; dk/dv summed over the
    query heads of each kv head's group; outputs in the input dtypes. `o`
    is unused, as in the reference: `delta` already carries it."""
    del o
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = sm_scale if sm_scale is not None else D ** -0.5
    kk = k.repeat_interleave(G, dim=2).float()
    vv = v.repeat_interleave(G, dim=2).float()
    p = torch.exp(_scores(q, kk, causal, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vv)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kk)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())

    def fold(x):  # query head h = kv * G + g → sum over g
        return x.reshape(B, S, KV, G, D).sum(3)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


class _CudaKernel:
    """ctypes binding of one C entry point of `csrc/<lib>.cu`, with its
    launch count.

    `launches` goes up by one each time the CUDA kernel is launched, and
    nowhere else, so a run can show that its main path went through it."""

    lib = ""
    symbol = ""
    argtypes: tuple = ()

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launch(self, *args) -> None:
        if self._fn is None:
            from ._build import load

            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = list(self.argtypes)
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1


def _check_kernel_inputs(q, k, v, *rest):
    """The checks every kernel wrapper makes before passing pointers."""
    B, S, H, D = q.shape
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, *rest)):
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype; "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
            + "".join(f"/{t.dtype}" for t in rest)
        )
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"flash kernel supports head_dim {SUPPORTED_HEAD_DIMS}; got {D}"
        )
    if any(t.device != q.device for t in (k, v, *rest)):
        raise ValueError("flash kernel inputs must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v, *rest)):
        raise ValueError("flash kernel needs a contiguous last (head) dim")


def _check_rows_aligned(kernel: str, **tensors):
    """The bf16 kernels (forward and backward) copy each row of q, k, v and
    dO into shared memory 16 bytes at a time (cp.async), so every row must
    start on a 16-byte boundary: the data pointer and the batch, row and
    head strides. Raises, naming the kernel, rather than copying to an
    aligned layout."""
    for name, t in tensors.items():
        size = t.element_size()
        strides = [s for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(s * size % 16 for s in strides):
            raise ValueError(
                f"{kernel} (bf16) needs 16-byte aligned rows: {name} has "
                f"data_ptr % 16 = {t.data_ptr() % 16} and strides {t.stride()} "
                f"of {size}-byte elements"
            )


def _stream(t) -> int:
    """The handle of the current stream on t's device, as
    `torch.cuda.current_stream(t.device).cuda_stream` gives it, without
    building a Stream object (~5 us a call on the host, which a decode
    step pays for every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


class FlashFwdKernel(_CudaKernel):
    """`polyaxon_flash_fwd` (csrc/flash_fwd.cu): (q, k, v) → (o, lse); the
    `_fwd_kernel` port (`flash_fwd_wgmma_kernel` for bf16,
    `flash_fwd_kernel` for f32)."""

    name = "flash_fwd"
    lib = "flash_fwd"
    symbol = "polyaxon_flash_fwd"
    argtypes = (
        (ctypes.c_void_p,) * 5
        + (ctypes.c_int,) * 6
        + (ctypes.c_longlong,) * 9
        + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
    )

    def __call__(self, q, k, v, *, causal: bool, scale: float):
        """q [B,S,H,D], k/v [B,S,KV,D] on one CUDA device → (o, lse)."""
        _check_kernel_inputs(q, k, v)
        B, S, H, D = q.shape
        if q.dtype == torch.bfloat16:
            _check_rows_aligned(self.name, q=q, k=k, v=v)
        if B * H > 65535 or -(-S // _TILE) > 65535:
            raise ValueError(
                f"B*H = {B * H} or seq len {S} exceeds the kernel grid limit"
            )
        o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            self._launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), lse.data_ptr(),
                _DTYPE_CODES[q.dtype], B, S, H, k.shape[2], D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                float(scale), int(bool(causal)), _stream(q),
            )
        return o, lse


_BWD_ARGTYPES = (
    (ctypes.c_void_p,) * 7
    + (ctypes.c_int,) * 6
    + (ctypes.c_longlong,) * 12
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
)


def _bwd_args(q, k, v, do, lse, delta, causal, scale):
    """The arguments both backward entry points share, after the checks;
    lse and delta as [B,H,S] f32 contiguous."""
    _check_kernel_inputs(q, k, v, do)
    B, S, H, D = q.shape
    if do.shape != q.shape:
        raise ValueError(f"dO must be {tuple(q.shape)}; got {tuple(do.shape)}")
    if q.dtype == torch.bfloat16:
        _check_rows_aligned("flash backward", q=q, k=k, v=v, dO=do)
    if -(-S // _TILE) > 65535:
        raise ValueError(f"seq len {S} exceeds the kernel grid limit")
    stats = []
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, S) or t.device != q.device:
            raise ValueError(f"{name} must be [B,H,S] = {(B, H, S)} on {q.device}")
        stats.append(t.float().contiguous())
    return stats, (
        _DTYPE_CODES[q.dtype], B, S, H, k.shape[2], D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        float(scale), int(bool(causal)), _stream(q),
    )


class FlashDqKernel(_CudaKernel):
    """`polyaxon_flash_dq` (csrc/flash_bwd.cu): the `_dq_kernel` port
    (`flash_dq_wgmma_kernel` for bf16, `flash_dq_kernel` for f32)."""

    name = "flash_dq"
    lib = "flash_bwd"
    symbol = "polyaxon_flash_dq"
    argtypes = _BWD_ARGTYPES

    def __call__(self, q, k, v, do, lse, delta, *, causal: bool, scale: float):
        """q/dO [B,S,H,D], k/v [B,S,KV,D], lse/delta [B,H,S] → dq."""
        (lse, delta), tail = _bwd_args(q, k, v, do, lse, delta, causal, scale)
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        with torch.cuda.device(q.device):
            self._launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail,
            )
        return dq


class FlashDkvKernel(_CudaKernel):
    """`polyaxon_flash_dkv` (csrc/flash_bwd.cu): the `_dkv_kernel` port
    (`flash_dkv_wgmma_kernel` for bf16, `flash_dkv_kernel` for f32)."""

    name = "flash_dkv"
    lib = "flash_bwd"
    symbol = "polyaxon_flash_dkv"
    argtypes = (ctypes.c_void_p,) + _BWD_ARGTYPES

    def __call__(self, q, k, v, do, lse, delta, *, causal: bool, scale: float):
        """q/dO [B,S,H,D], k/v [B,S,KV,D], lse/delta [B,H,S] → (dk, dv)."""
        (lse, delta), tail = _bwd_args(q, k, v, do, lse, delta, causal, scale)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        with torch.cuda.device(q.device):
            self._launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *tail,
            )
        return dk, dv


FLASH_FWD = FlashFwdKernel()
FLASH_DQ = FlashDqKernel()
FLASH_DKV = FlashDkvKernel()
KERNELS = (FLASH_FWD, FLASH_DQ, FLASH_DKV)


def _fwd(q, k, v, causal, scale):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, sm_scale=scale)
    return FLASH_FWD(q, k, v, causal=causal, scale=scale)


def _bwd(q, k, v, o, lse, do, delta, causal, scale):
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, o, lse, do, delta, causal=causal, sm_scale=scale
        )
    if do.stride(-1) != 1:
        do = do.contiguous()
    dq = FLASH_DQ(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = FLASH_DKV(q, k, v, do, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


def _delta(do, o):
    """rowsum(dO * o) in f32, [B,H,S] like lse (`_flash_bwd`)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2)


class _Flash(torch.autograd.Function):
    """`_flash`: o, with the backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o

    @staticmethod
    def backward(ctx, do):
        if do is None:
            return None, None, None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do, _delta(do, o), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


class _FlashLse(torch.autograd.Function):
    """`_flash_lse`: (o, lse), the lse cotangent folded into delta as
    delta - dlse (d lse / d s = p). An output whose gradient is not needed
    arrives as None (the reference's SymbolicZero) and costs nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if do is None and dlse is None:
            return None, None, None, None, None
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = _delta(do, o)
        if dlse is not None:
            delta = delta - dlse.float()
        dq, dk, dv = _bwd(q, k, v, o, lse, do, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _prepare(q, k, v, block_q, block_kv, sm_scale):
    _check(q, k, v, block_q, block_kv)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def flash_attention_lse(
    q, k, v, *, causal=True, block_q=128, block_kv=128, sm_scale=None
):
    """flash_attention that also returns the logsumexp: (o [B,S,H,D],
    lse [B,H,S] f32). Both are differentiable."""
    scale = _prepare(q, k, v, block_q, block_kv, sm_scale)
    return _FlashLse.apply(q, k, v, causal, scale)


def flash_attention(
    q, k, v, *, causal=True, block_q=128, block_kv=128, sm_scale=None
):
    """q: [B, S, H, D]; k/v: [B, S, KV, D] with KV dividing H → [B, S, H, D].

    GQA is native: query head h reads kv head h // (H / KV); K/V are never
    repeated in device memory on the CUDA path, and dk/dv are summed over
    each group inside the dk/dv kernel."""
    scale = _prepare(q, k, v, block_q, block_kv, sm_scale)
    return _Flash.apply(q, k, v, causal, scale)
