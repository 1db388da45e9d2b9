"""The port's flash-attention forward against the JAX package's.

On the CPU the port runs its plain version and the JAX package its Pallas
kernel in interpret mode; o and lse agree within 2e-5 (f32 on both sides,
the tolerance the JAX package holds its own kernel to). The hand-written
kernel itself is tested on the card by `test_torch_kernels_cuda.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops import flash_attention as jax_fa
from polyaxon_tpu_torch.ops import flash_attention as fa

TOL = 2e-5


def _qkv(B=2, S=128, H=4, KV=4, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return q, k, v


CASES = [
    # causal, H, KV, block_q, block_kv
    (True, 4, 4, 64, 64),
    (False, 4, 4, 64, 64),
    (True, 4, 2, 32, 64),
    (False, 8, 2, 64, 32),
    (True, 8, 2, 128, 32),
]


@pytest.mark.parametrize("causal,H,KV,block_q,block_kv", CASES)
def test_flash_lse_matches_jax(causal, H, KV, block_q, block_kv):
    q, k, v = _qkv(H=H, KV=KV)
    kw = dict(causal=causal, block_q=block_q, block_kv=block_kv)
    o_ref, lse_ref = jax_fa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw
    )
    o, lse = fa.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw
    )
    assert o.shape == (2, 128, H, 32) and lse.shape == (2, H, 128)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_with_sm_scale(causal):
    q, k, v = _qkv(B=1, S=64, H=4, KV=1)
    kw = dict(causal=causal, block_q=32, block_kv=32, sm_scale=0.3)
    ref = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "S,H,KV,blocks",
    [(100, 4, 4, (64, 64)), (128, 4, 3, (64, 64)), (96, 4, 4, (64, 32))],
    ids=["indivisible-seq", "heads-not-grouped", "indivisible-q-block"],
)
def test_flash_rejects_what_jax_rejects(S, H, KV, blocks):
    q, k, v = _qkv(S=S, H=H, KV=KV)
    kw = dict(block_q=blocks[0], block_kv=blocks[1])
    with pytest.raises(ValueError):
        jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    with pytest.raises(ValueError):
        fa.flash_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw
        )


def test_flash_shapes_ok_matches_jax():
    for seq in (1, 7, 8, 24, 64, 100, 128, 192, 2048, 4096):
        for bq in (8, 12, 64, 128):
            for bkv in (16, 128, 512):
                assert fa.flash_shapes_ok(seq, bq, bkv) == jax_fa.flash_shapes_ok(
                    seq, bq, bkv
                ), (seq, bq, bkv)


def test_cpu_path_never_touches_the_kernel():
    q, k, v = (torch.from_numpy(a) for a in _qkv(S=64))
    before = fa.FLASH_FWD.launches
    fa.flash_attention(q, k, v)
    assert fa.FLASH_FWD.launches == before
