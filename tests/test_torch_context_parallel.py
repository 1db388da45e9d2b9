"""The port's ring and ulysses attention against the JAX package's on the
same mesh, on the CPU.

The JAX side runs on the 8 virtual CPU devices of `tests/conftest.py`
(`ring_attention` / `ulysses_attention` under `set_current_mesh`); the
port's runs in one `gloo` world of 4 ranks (`tests/torch_mesh_workers.py`,
all cases in one world) on DTensors built from the same numpy arrays with
the JAX shard_map's layout: batch over the batch axes, sequence over
`context`, heads over `model`, and k/v replicated over `model` where the
kv heads do not divide it (the reference's GQA expansion branch).

Each case holds o and the q/k/v gradients of sum(o * dO), gathered in
full, within 2e-5 (forward) and 5e-5 (gradients), absolute and relative,
the JAX package's own ring tolerances. Both ring bodies run: the flash hops
where the chunk fits the kernel's blocks and head_dim is 64, the einsum
body at head_dim 32. `flash_attention_lse`'s backward with a cotangent on
the lse (what the ring's logaddexp merge hands each hop) is held against
the JAX function's directly.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops.flash_attention import flash_attention_lse as jax_flash_lse
from polyaxon_tpu.parallel.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu.parallel.ring import ring_attention as jax_ring
from polyaxon_tpu.parallel.ring import set_current_mesh as jax_set_mesh
from polyaxon_tpu.parallel.sharding import live_axes as jax_live_axes
from polyaxon_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from polyaxon_tpu_torch.ops.flash_attention import flash_attention_lse
from polyaxon_tpu_torch.parallel.ring import use_flash_body
from torch_mesh_workers import run_world

WORLD = 4
BATCH_AXES = ("batch", "data", "fsdp")

# name: (fn, mesh, B, S, H, KV, D, causal)
CASES = {
    "ring-flash-causal": ("ring", {"context": 4}, 1, 64, 4, 2, 64, True),
    "ring-einsum-data": ("ring", {"data": 2, "context": 2}, 2, 64, 4, 2, 32, True),
    "ring-flash-model-grouped-noncausal": (
        "ring", {"context": 2, "model": 2}, 1, 64, 4, 2, 64, False),
    "ring-flash-model-expand": ("ring", {"context": 2, "model": 2}, 1, 64, 4, 1, 64, True),
    "ulysses-grouped": ("ulysses", {"context": 2, "model": 2}, 1, 64, 8, 4, 64, True),
    "ulysses-expand-noncausal": ("ulysses", {"context": 2, "model": 2}, 1, 64, 8, 2, 64, False),
    # 66 tokens do not split 4 ways: the einsum attention on the gathered
    # sequence (the reference's fallback)
    "ring-indivisible-seq": ("ring", {"context": 4}, 1, 66, 4, 2, 32, True),
}


def _arrays(B, S, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, D), dtype=np.float32)
    do = rng.standard_normal((B, S, H, D), dtype=np.float32)
    return q, k, v, do


def _layout(mesh, B, H, KV):
    """The reference shard_map's specs: (q spec, kv spec) as tuples of
    mesh-axis entries per dim."""
    batch = jax_live_axes(mesh, BATCH_AXES, B) or None
    batch = batch[0] if batch and len(batch) == 1 else batch
    head = "model" if jax_live_axes(mesh, ("model",), H) else None
    kv_head = head if head and KV % mesh.shape.get("model", 1) == 0 else None
    return (batch, "context", head, None), (batch, "context", kv_head, None)


def _jax_run(name):
    """(o, dq, dk, dv) of the JAX function on its mesh, as numpy."""
    fn, axes, B, S, H, KV, D, causal = CASES[name]
    q, k, v, do = _arrays(B, S, H, KV, D, seed=len(name))
    mesh = jax_build_mesh(axes, devices=jax.devices()[:WORLD])
    body = jax_ring if fn == "ring" else jax_ulysses
    jax_set_mesh(mesh)  # thread-local: each case binds its own
    try:
        def loss(q, k, v):
            o = body(q, k, v, causal=causal)
            return jnp.sum(o * do), o

        (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    finally:
        jax_set_mesh(None)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


@functools.cache
def results():
    """Every case: (the JAX outputs, the port's outputs on rank 0). The
    port's world runs while the JAX cases compile, on threads of their own
    (XLA compiles outside the GIL)."""
    work = []
    for name, (fn, axes, B, S, H, KV, D, causal) in CASES.items():
        q, k, v, do = _arrays(B, S, H, KV, D, seed=len(name))
        mesh = jax_build_mesh(axes, devices=jax.devices()[:WORLD])
        qs, kvs = _layout(mesh, B, H, KV)
        work.append(("attention", dict(fn=fn, mesh_axes=axes, q=q, k=k, v=v, do=do,
                                       placements={"q": qs, "kv": kvs}, causal=causal)))
    with ThreadPoolExecutor(4) as pool:
        port = pool.submit(run_world, WORLD, work)
        jax_out = list(pool.map(_jax_run, CASES))
        ours = port.result()[0]
    return {name: (want, got) for name, want, got in zip(CASES, jax_out, ours)}


def test_cases_cover_both_ring_bodies():
    bodies = {use_flash_body(S // axes.get("context", 1), D)
              for fn, axes, B, S, H, KV, D, causal in CASES.values()
              if fn == "ring" and S % axes.get("context", 1) == 0}
    assert bodies == {True, False}


@pytest.mark.parametrize("name", list(CASES))
def test_output_matches_jax(name):
    want, ours = results()[name]
    np.testing.assert_allclose(ours[0], want[0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("which", ["dq", "dk", "dv"])
def test_gradients_match_jax(name, which):
    want, ours = results()[name]
    i = ["dq", "dk", "dv"].index(which) + 1
    assert ours[i].shape == want[i].shape
    np.testing.assert_allclose(ours[i], want[i], atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_cotangent_matches_jax(causal):
    """The gradient through both of flash_attention_lse's outputs: the
    merge weights of the ring's hops depend on each hop's lse."""
    q, k, v, do = _arrays(1, 64, 4, 2, 64, seed=7)
    dl = np.random.default_rng(8).standard_normal((1, 4, 64), dtype=np.float32)

    def jloss(q, k, v):
        o, lse = jax_flash_lse(q, k, v, causal=causal, block_q=32, block_kv=32)
        return jnp.sum(o * do) + jnp.sum(lse * dl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = flash_attention_lse(*ts, causal=causal, block_q=32, block_kv=32)
    ((o * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dl)).sum()).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-5, rtol=5e-5)
