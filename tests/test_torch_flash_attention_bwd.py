"""The port's flash-attention backward against the JAX package's, and the
alignment checks of the bf16 kernel wrappers (forward and backward).

On the CPU the port's autograd Functions run the plain forward and the
plain backward (`flash_attention_bwd_reference`); the JAX package runs its
Pallas kernels in interpret mode, as its own tests run them. dq/dk/dv agree
within 5e-5 (f32 on both sides, the JAX package's own backward tolerance in
tests/test_attention.py). The hand-written kernels themselves are tested on
the card by `test_torch_kernels_cuda.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops import flash_attention as jax_fa
from polyaxon_tpu_torch.ops import flash_attention as fa

TOL = 5e-5


def _arrays(B=2, S=64, H=4, KV=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    dlse = rng.standard_normal((B, H, S)).astype(np.float32)
    return q, k, v, do, dlse


CASES = [
    # causal, S, H, KV, sm_scale, block_q, block_kv
    (True, 64, 4, 4, None, 32, 32),
    (False, 64, 4, 4, None, 32, 32),
    (True, 128, 8, 2, None, 64, 32),
    (False, 128, 8, 2, 0.3, 32, 64),
    (True, 96, 8, 2, 0.2, 32, 32),
]
IDS = ["causal-mha", "mha", "causal-gqa", "gqa-scale", "causal-gqa-scale"]


def _close(ours, ref):
    np.testing.assert_allclose(
        ours.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL
    )


@pytest.mark.parametrize("causal,S,H,KV,sm_scale,block_q,block_kv", CASES, ids=IDS)
def test_plain_backward_matches_bwd_impl(causal, S, H, KV, sm_scale, block_q, block_kv):
    """flash_attention_bwd_reference against `_bwd_impl` (the dq and dkv
    Pallas kernels) on the same o, lse and delta."""
    q, k, v, do, dlse = _arrays(S=S, H=H, KV=KV)
    B, D = q.shape[0], q.shape[-1]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal=causal, sm_scale=scale)
    delta = (tdo * o).sum(-1).transpose(1, 2) - torch.from_numpy(dlse)
    dq, dk, dv = fa.flash_attention_bwd_reference(
        tq, tk, tv, o, lse, tdo, delta, causal=causal, sm_scale=scale
    )

    def to_bh(x):  # [B,S,h,D] -> [B*h, S, D]
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(-1, S, D)

    def from_bh(x, h):
        return np.asarray(x).reshape(B, h, S, D).transpose(0, 2, 1, 3)

    rq, rk, rv = jax_fa._bwd_impl(
        to_bh(q), to_bh(k), to_bh(v), to_bh(o.numpy()),
        jnp.asarray(lse.numpy()).reshape(B * H, S, 1), to_bh(do),
        jnp.asarray(delta.numpy()).reshape(B * H, S, 1),
        causal, scale, block_q, block_kv, H // KV,
    )
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    _close(dq, from_bh(rq, H))
    _close(dk, from_bh(rk, KV))
    _close(dv, from_bh(rv, KV))


def _torch_grads(fn, q, k, v, cotangents):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(
        [o for o, c in zip(outs, cotangents) if c is not None],
        [torch.from_numpy(c) for c in cotangents if c is not None],
    )
    return outs, [t.grad for t in leaves]


@pytest.mark.parametrize("causal,S,H,KV,sm_scale,block_q,block_kv", CASES, ids=IDS)
def test_flash_attention_vjp_matches_jax(causal, S, H, KV, sm_scale, block_q, block_kv):
    q, k, v, do, _ = _arrays(S=S, H=H, KV=KV, seed=1)
    kw = dict(causal=causal, block_q=block_q, block_kv=block_kv, sm_scale=sm_scale)
    _, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention(a, b, c, **kw), q, k, v)
    ref = vjp(jnp.asarray(do))
    _, grads = _torch_grads(lambda a, b, c: fa.flash_attention(a, b, c, **kw), q, k, v, [do])
    for ours, want in zip(grads, ref):
        _close(ours, want)


@pytest.mark.parametrize("causal,S,H,KV,sm_scale,block_q,block_kv", CASES, ids=IDS)
def test_flash_attention_lse_vjp_matches_jax(causal, S, H, KV, sm_scale, block_q, block_kv):
    """Cotangents on both o and lse: the lse one folds into delta."""
    q, k, v, do, dlse = _arrays(S=S, H=H, KV=KV, seed=2)
    kw = dict(causal=causal, block_q=block_q, block_kv=block_kv, sm_scale=sm_scale)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_fa.flash_attention_lse(a, b, c, **kw), q, k, v
    )
    ref = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    _, grads = _torch_grads(
        lambda a, b, c: fa.flash_attention_lse(a, b, c, **kw), q, k, v, [do, dlse]
    )
    for ours, want in zip(grads, ref):
        _close(ours, want)


@pytest.mark.parametrize("which", ["o", "lse"])
def test_flash_attention_lse_one_cotangent(which):
    """Only o or only lse is used downstream: the other's cotangent arrives
    as None (the reference's SymbolicZero) and the gradient matches JAX's
    with a zero cotangent there."""
    q, k, v, do, dlse = _arrays(S=64, H=8, KV=2, seed=3)
    kw = dict(causal=True, block_q=32, block_kv=32)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_fa.flash_attention_lse(a, b, c, **kw), q, k, v
    )
    zero_o, zero_lse = np.zeros_like(do), np.zeros_like(dlse)
    cts = (do, zero_lse) if which == "o" else (zero_o, dlse)
    ref = vjp(tuple(jnp.asarray(c) for c in cts))
    _, grads = _torch_grads(
        lambda a, b, c: fa.flash_attention_lse(a, b, c, **kw), q, k, v,
        [do, None] if which == "o" else [None, dlse],
    )
    for ours, want in zip(grads, ref):
        _close(ours, want)


def test_cpu_backward_never_touches_the_kernels():
    q, k, v, do, _ = _arrays(S=64)
    before = [kern.launches for kern in fa.KERNELS]
    _torch_grads(fa.flash_attention, q, k, v, [do])
    assert [kern.launches for kern in fa.KERNELS] == before


def test_bf16_backward_rounds_like_the_tpu_kernels():
    """In bf16 the plain backward rounds ds and p where the TPU kernels do:
    its dq equals an f32 recomputation that rounds ds to bf16 before ds.K,
    exactly, and differs from one that does not."""
    q, k, v, do, _ = _arrays(B=1, S=32, H=2, KV=1, D=32, seed=4)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = fa.flash_attention_reference(tq, tk, tv)
    delta = (tdo.float() * o.float()).sum(-1).transpose(1, 2)
    dq, _, _ = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, delta)
    kk = tk.float().repeat_interleave(2, dim=2)
    scale = 32 ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", tq.float(), kk) * scale
    s = s.masked_fill(~torch.ones(32, 32, dtype=torch.bool).tril(), fa.NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", tdo.float(), tv.float().repeat_interleave(2, 2))
    ds = p * (dp - delta[..., None]) * scale
    rounded = torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(), kk).bfloat16()
    unrounded = torch.einsum("bhqk,bkhd->bqhd", ds, kk).bfloat16()
    assert dq.dtype == torch.bfloat16
    assert torch.equal(dq, rounded)
    assert not torch.equal(dq, unrounded)


def _misaligned(name, B=1, S=64, H=4, KV=2, D=64):
    """bf16 kernel inputs with one tensor's rows off the 16-byte grid: a
    row stride 4 elements (8 bytes) longer than the row, or a start 2 bytes
    into its storage. The kernels' copies read 16 bytes at a time."""
    shapes = {"q": (B, S, H, D), "k": (B, S, KV, D), "v": (B, S, KV, D), "dO": (B, S, H, D)}
    ts = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    b, s, h, d = shapes[name.split(":")[0]]
    if name.endswith(":stride"):
        wide = torch.zeros(b, s, h * d + 4, dtype=torch.bfloat16)
        ts[name.split(":")[0]] = wide[..., : h * d].view(b, s, h, d)
    else:
        flat = torch.zeros(b * s * h * d + 1, dtype=torch.bfloat16)
        ts[name.split(":")[0]] = flat[1:].view(b, s, h, d)
    lse = torch.zeros(B, H, S)
    return ts["q"], ts["k"], ts["v"], ts["dO"], lse, lse


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("name", ["q:stride", "k:stride", "v:offset", "dO:stride", "dO:offset"])
def test_bf16_kernel_wrappers_refuse_misaligned_rows(kernel, name):
    """The wrappers raise on a row that is not 16-byte aligned before any
    launch, and never copy to an aligned layout in silence."""
    q, k, v, do, lse, delta = _misaligned(name)
    wrapper = fa.FLASH_DQ if kernel == "dq" else fa.FLASH_DKV
    before = wrapper.launches
    with pytest.raises(ValueError, match="16-byte aligned rows: " + name.split(":")[0]):
        wrapper(q, k, v, do, lse, delta, causal=True, scale=0.125)
    assert wrapper.launches == before


@pytest.mark.parametrize("name", [f"{t}:{how}" for t in "qkv" for how in ("stride", "offset")])
def test_bf16_forward_wrapper_refuses_misaligned_rows(name):
    """The bf16 forward copies q, k and v by rows of 16 bytes too: its
    wrapper raises, naming the kernel and the tensor, before any launch."""
    q, k, v, _, _, _ = _misaligned(name)
    before = fa.FLASH_FWD.launches
    with pytest.raises(ValueError, match="flash_fwd .* 16-byte aligned rows: " + name[0]):
        fa.FLASH_FWD(q, k, v, causal=True, scale=0.125)
    assert fa.FLASH_FWD.launches == before
