"""The port's losses against the JAX package's `ops/losses.py`, on the CPU.

Same inputs (numpy, from a seed) on both sides, f32. Values and gradients
agree within 1e-5 relative (f32 sum order: logsumexp over a few hundred
logits, products over a 32-wide feature dim)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops import losses as jax_losses
from polyaxon_tpu_torch.ops import losses

TOL = 1e-5


def _logits_labels(shape=(3, 7), V=50, seed=0, ignore=True):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((*shape, V))).astype(np.float32)
    labels = rng.integers(0, V, shape).astype(np.int32)
    if ignore:
        labels[rng.random(shape) < 0.3] = -100
    return logits, labels


def _both(name, logits, labels):
    ref = jax_losses.build_loss(name)(
        jnp.asarray(logits), {"labels": jnp.asarray(labels)}
    )
    ours = losses.build_loss(name)(
        torch.from_numpy(logits), {"labels": torch.from_numpy(labels)}
    )
    return ours, ref


@pytest.mark.parametrize("ignore", [True, False], ids=["with-ignored", "all-labelled"])
def test_masked_lm_matches_jax(ignore):
    ours, ref = _both("masked_lm", *_logits_labels(ignore=ignore))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.item(), float(ref), rtol=TOL)


def test_masked_lm_all_ignored_is_zero_on_both_sides():
    logits, labels = _logits_labels()
    labels[:] = -100
    ours, ref = _both("masked_lm", logits, labels)
    assert ours.item() == float(ref) == 0.0


def test_softmax_cross_entropy_matches_jax():
    logits, labels = _logits_labels(shape=(16,), ignore=False)
    ours, ref = _both("softmax_cross_entropy", logits, labels)
    np.testing.assert_allclose(ours.item(), float(ref), rtol=TOL)


def test_mse_matches_jax():
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((4, 3)).astype(np.float32)
    target = rng.standard_normal((4, 3)).astype(np.float32)
    ours, ref = _both("mse", pred, target)
    np.testing.assert_allclose(ours.item(), float(ref), rtol=TOL)


@pytest.mark.parametrize("shape", [(16,), (3, 7)], ids=["classification", "token"])
def test_accuracy_matches_jax(shape):
    logits, labels = _logits_labels(shape=shape, V=5, ignore=len(shape) > 1)
    ref = jax_losses.accuracy(jnp.asarray(logits), {"labels": jnp.asarray(labels)})
    ours = losses.accuracy(torch.from_numpy(logits), {"labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(ours.item(), float(ref), rtol=TOL)


def test_masked_lm_gradient_matches_jax():
    logits, labels = _logits_labels()
    ref = jax.grad(lambda x: jax_losses.masked_lm(x, {"labels": jnp.asarray(labels)}))(
        jnp.asarray(logits)
    )
    x = torch.from_numpy(logits).requires_grad_()
    losses.masked_lm(x, {"labels": torch.from_numpy(labels)}).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), atol=1e-7, rtol=TOL)


def test_unknown_loss_raises_like_jax():
    with pytest.raises(ValueError, match="unknown loss"):
        jax_losses.build_loss("nope")
    with pytest.raises(ValueError, match="unknown loss"):
        losses.build_loss("nope")


def _fused_inputs(B=2, S=9, D=32, V=250, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    # labels on both sides of every chunk edge of 64, the last id, and an
    # all-ignored row
    labels[0, :6] = [0, 63, 64, 127, 128, V - 1]
    labels[1, :] = -100
    labels[0, 6] = -100
    return x, w, labels


@pytest.mark.parametrize("chunk", [64, 250, 1000], ids=["64-ragged", "whole", "past-V"])
def test_fused_linear_masked_lm_matches_jax(chunk):
    """Value and gradients (dx, dkernel) against the reference's custom
    VJP, with a chunk that does not divide V=250."""
    x, w, labels = _fused_inputs()

    def ref_loss(x, w):
        return jax_losses.fused_linear_masked_lm(x, w, jnp.asarray(labels), chunk_size=chunk)

    ref, (rdx, rdw) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w)
    )
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    ours = losses.fused_linear_masked_lm(tx, tw, torch.from_numpy(labels), chunk_size=chunk)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rdx), atol=1e-7, rtol=TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(rdw), atol=1e-7, rtol=TOL)
    # and the same function as masked_lm over the full logits
    full = losses.masked_lm(
        torch.from_numpy(x) @ torch.from_numpy(w), {"labels": torch.from_numpy(labels)}
    )
    np.testing.assert_allclose(ours.item(), full.item(), rtol=TOL)


def test_fused_linear_masked_lm_bf16_logits_are_f32_products():
    """bf16 features and kernel: the chunk logits are f32 products of the
    bf16 values (no bf16 rounding of the logits), as
    preferred_element_type=f32 gives them in the reference."""
    x, w, labels = _fused_inputs(seed=4)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    ours = losses.fused_linear_masked_lm(xb, wb, torch.from_numpy(labels), chunk_size=64)
    f32 = losses.masked_lm(xb.float() @ wb.float(), {"labels": torch.from_numpy(labels)})
    rounded = losses.masked_lm(xb @ wb, {"labels": torch.from_numpy(labels)})
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.item(), f32.item(), rtol=TOL)
    assert abs(ours.item() - rounded.item()) > 10 * abs(ours.item() - f32.item())
    ref = jax_losses.fused_linear_masked_lm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(labels), chunk_size=64,
    )
    np.testing.assert_allclose(ours.item(), float(ref), rtol=TOL)


@pytest.mark.parametrize("chunk", [0, -3])
def test_fused_chunk_below_one_raises(chunk):
    x, w, labels = _fused_inputs()
    with pytest.raises(ValueError, match="fused_loss_chunk"):
        jax_losses.fused_linear_masked_lm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), chunk_size=chunk
        )
    with pytest.raises(ValueError, match="fused_loss_chunk"):
        losses.fused_linear_masked_lm(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels),
            chunk_size=chunk,
        )
