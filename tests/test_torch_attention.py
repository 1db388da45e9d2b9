"""The port's attention dispatch against the JAX package's, on the CPU
(f32; outputs within 2e-5, the JAX package's own flash-vs-xla tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops.attention import dot_product_attention as jax_dpa
from polyaxon_tpu_torch.ops.attention import dot_product_attention, resolve_auto_backend

TOL = 2e-5


def _qkv(B=2, S=128, H=4, KV=2, D=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    )


@pytest.mark.parametrize("backend", ["xla", "flash"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("KV", [4, 2, 1])
def test_backends_match_jax(backend, causal, KV):
    q, k, v = _qkv(KV=KV)
    kw = dict(causal=causal, backend=backend, block_kv=64)
    ref = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out = dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_auto_on_cpu_is_the_einsum_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    auto = dot_product_attention(q, k, v, causal=True, backend="auto")
    xla = dot_product_attention(q, k, v, causal=True, backend="xla")
    assert torch.equal(auto, xla)


@pytest.mark.parametrize(
    "seq,block_kv,head_dim,device,expected",
    [
        (4096, 512, 64, "cuda", "flash"),
        (2048, 512, 128, "cuda", "flash"),
        (8192, 512, 32, "cuda", "flash"),
        (1024, 512, 64, "cuda", "xla"),  # short: the einsum path wins
        (4096, 512, 96, "cuda", "xla"),  # head dim the kernel lacks
        (4000, 512, 64, "cuda", "xla"),  # blocks do not divide
        (4096, 512, 64, "cpu", "xla"),  # no kernel off the card
    ],
)
def test_resolve_auto_backend(seq, block_kv, head_dim, device, expected):
    assert resolve_auto_backend(seq, block_kv, head_dim, device=device) == expected


@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_context_parallel_backends_not_ported(backend):
    """Context parallelism is ported (`parallel/`,
    tests/test_torch_context_parallel.py); without a bound mesh the ring
    and ulysses backends are the flash dispatch, as in the reference."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=16))
    out = dot_product_attention(q, k, v, causal=True, backend=backend)
    assert torch.equal(out, dot_product_attention(q, k, v, causal=True, backend="flash"))


def test_bad_backend_and_heads_raise():
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=16, H=4, KV=3))
    with pytest.raises(ValueError, match="not divisible"):
        dot_product_attention(q, k, v, causal=True)
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=16))
    with pytest.raises(ValueError, match="unknown attention backend"):
        dot_product_attention(q, k, v, causal=True, backend="sparse")
