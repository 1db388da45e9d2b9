"""The port's optimizers and schedules against the JAX package's (optax), on
the CPU.

Schedules agree within 1e-6 relative at every step (the reference evaluates
them in f32, the port in f64). Parameters after 5 updates agree within 1e-6
relative (f32 element-wise arithmetic in another order), with optax's
defaults on both sides."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.ops import optimizers as jax_opt
from polyaxon_tpu_torch.ops import optimizers as opt

TOTAL = 12

SCHEDULES = {
    "none": None,
    "constant": {"name": "constant"},
    "cosine": {"name": "cosine", "alpha": 0.1},
    "linear": {"name": "linear", "end_value": 1e-5},
    "rsqrt": {"name": "rsqrt"},
    "step": {"name": "step", "boundaries": [3, 7], "scales": [0.5, 0.1]},
    "exponential": {"name": "exponential", "decay_rate": 0.5},
    "exponential-staircase": {"name": "exponential", "decay_rate": 0.5,
                              "staircase": True, "decay_steps": 6},
}


@pytest.mark.parametrize("warmup", [0, 3], ids=["no-warmup", "warmup"])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax(name, warmup):
    spec = SCHEDULES[name]
    if spec is not None:
        spec = {**spec, "warmup_steps": warmup}
    ref = jax_opt.build_schedule(0.1, spec, TOTAL)
    ours = opt.build_schedule(0.1, spec, TOTAL)
    for step in range(TOTAL + 3):
        np.testing.assert_allclose(
            ours(step), float(ref(jnp.asarray(step))), rtol=1e-6, atol=1e-12,
            err_msg=f"step {step}",
        )


def _params_and_grads(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "b": rng.standard_normal(3).astype(np.float32),
    }
    grads = [
        {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()}
        for _ in range(steps)
    ]
    return params, grads


def _run_both(name, config, schedule=None, steps=5):
    params, grads = _params_and_grads(steps=steps)
    tx, _ = jax_opt.build_optimizer(name, 0.05, config, schedule, total_steps=steps)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    optimizer, _ = opt.build_optimizer(
        tp.values(), name, 0.05, config, schedule, total_steps=steps
    )
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
    return tp, jp, params


CASES = {
    "adamw": ("adamw", None),
    "adamw-decay": ("adamw", {"weight_decay": 0.1, "b1": 0.8, "eps": 1e-6}),
    "adam": ("adam", {"b2": 0.99}),
    "sgd": ("sgd", None),
    "sgd-momentum": ("sgd", {"momentum": 0.9}),
    "sgd-nesterov": ("sgd", {"momentum": 0.9, "nesterov": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_updates_match_optax(case):
    name, config = CASES[case]
    ours, ref, start = _run_both(
        name, config, schedule={"name": "cosine", "warmup_steps": 2}
    )
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
        assert not np.allclose(ours[k].numpy(), start[k])


def test_adamw_default_weight_decay_is_optax_s():
    """1e-4 (optax), not torch's 1e-2: with zero gradients only the decay
    moves the weights, by lr * 1e-4 * w per step."""
    p = torch.ones(3)
    optimizer, _ = opt.build_optimizer([p], "adamw", 0.5)
    p.grad = torch.zeros(3)
    optimizer.step()
    np.testing.assert_allclose(p.numpy(), 1 - 0.5 * 1e-4, rtol=1e-7)


@pytest.mark.parametrize("clip", [0.1, 100.0], ids=["above-threshold", "below-threshold"])
def test_grad_clip_matches_optax(clip):
    ours, ref, _ = _run_both("adamw", {"grad_clip_norm": clip})
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [0.5, 2.0], ids=["above-threshold", "below-threshold"])
def test_clip_by_global_norm_matches_optax(clip):
    _, grads = _params_and_grads(steps=1)
    g = grads[0]
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
    assert (norm > clip) == (clip == 0.5)
    ref, _ = optax.clip_by_global_norm(clip).update(
        {k: jnp.asarray(v) for k, v in g.items()}, None
    )
    ours = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    opt.clip_by_global_norm(list(ours.values()), clip)
    for k in g:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6)
    np.testing.assert_allclose(
        opt.global_norm(ours.values()).item(),
        float(optax.global_norm(ref)), rtol=1e-6,
    )


def test_unknown_names_raise_like_the_reference():
    with pytest.raises(ValueError, match="unknown optimizer"):
        jax_opt.build_optimizer("adamax")
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.build_optimizer([torch.zeros(1)], "adamax")
    with pytest.raises(ValueError, match="unknown schedule"):
        jax_opt.build_schedule(0.1, {"name": "triangle"}, 10)
    with pytest.raises(ValueError, match="unknown schedule"):
        opt.build_schedule(0.1, {"name": "triangle"}, 10)


@pytest.mark.parametrize("name", ["lamb", "lion", "adafactor", "rmsprop", "adagrad"])
def test_unported_optimizers_raise(name):
    jax_opt.build_optimizer(name)  # the reference has them
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        opt.build_optimizer([torch.zeros(1)], name)
