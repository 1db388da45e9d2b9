"""The port's optimizers and schedules against the JAX package's (optax), on
the CPU.

Schedules agree within 1e-6 relative at every step (the reference evaluates
them in f32, the port in f64). Parameters after 5 updates agree within 1e-6
relative (f32 element-wise arithmetic in another order), with optax's
defaults on both sides. `opt_state_from_jax` is held the same way: two
optax updates, the state converted into the port's optimizer, two more
updates on each side."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.ops import optimizers as jax_opt
from polyaxon_tpu_torch.models.convert import opt_state_from_jax
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
    "lamb": ("lamb", None),
    "lamb-decay": ("lamb", {"weight_decay": 0.1, "eps_root": 1e-8}),
    "lion": ("lion", None),
    "lion-no-decay": ("lion", {"weight_decay": 0.0, "b2": 0.9}),
    # the (4, 3) leaf is unfactored at the default minimum of 128 ...
    "adafactor": ("adafactor", None),
    # ... and factored at 3; the (3,) leaf never is
    "adafactor-factored": ("adafactor", {"min_dim_size_to_factor": 3}),
    "adafactor-momentum-decay": ("adafactor", {
        "min_dim_size_to_factor": 3, "momentum": 0.9, "weight_decay_rate": 0.01,
        "clipping_threshold": 0.5}),
    "adafactor-no-scale-no-clip": ("adafactor", {
        "multiply_by_parameter_scale": False, "clipping_threshold": None}),
    "rmsprop": ("rmsprop", None),
    "rmsprop-eps-outside-sqrt": ("rmsprop", {
        "eps_in_sqrt": False, "initial_scale": 0.1, "bias_correction": True}),
    # (centered with bias correction is left out: at step 1 the centered
    # variance is exactly 0 and only rounding decides the update)
    "rmsprop-centered-nesterov": ("rmsprop", {
        "centered": True, "momentum": 0.9, "nesterov": True}),
    "adagrad": ("adagrad", None),
    "adagrad-zero-start": ("adagrad", {"initial_accumulator_value": 0.0, "eps": 1e-5}),
    # Nesterov's Adam and the moment dtypes, by the names a Polyaxonfile
    # gives them (optax takes the strings as they are)
    "adam-nesterov": ("adam", {"nesterov": True}),
    "adam-mu-bf16": ("adam", {"mu_dtype": "bfloat16"}),
    "adamw-nesterov-mu-bf16": ("adamw", {"nesterov": True, "mu_dtype": "bfloat16",
                                         "weight_decay": 0.1}),
    "lion-mu-bf16": ("lion", {"mu_dtype": "bfloat16"}),
    "sgd-momentum-bf16": ("sgd", {"momentum": 0.9, "accumulator_dtype": "bfloat16"}),
    "sgd-nesterov-bf16": ("sgd", {"momentum": 0.9, "nesterov": True,
                                  "accumulator_dtype": "bfloat16"}),
    "adafactor-momentum-bf16": ("adafactor", {
        "min_dim_size_to_factor": 3, "momentum": 0.9, "dtype_momentum": "bfloat16"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_updates_match_optax(case):
    name, config = CASES[case]
    ours, ref, start = _run_both(
        name, config, schedule={"name": "cosine", "warmup_steps": 2}
    )
    for k in ref:
        assert np.isfinite(ours[k].numpy()).all()
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
        assert not np.allclose(ours[k].numpy(), start[k])


@pytest.mark.parametrize("name,key", [
    ("adamw", "mask"), ("lamb", "mask"), ("lion", "mask"),
    ("adafactor", "weight_decay_mask"),
])
def test_masks_are_refused_by_name(name, key):
    """A decay mask names the parameters that take weight decay: as a
    mapping from the port's names (optax: the same pytree) or a callable
    over the named parameters, the masked-out bias gets optax's update
    (no decay); without the names it is refused."""
    decay = {"weight_decay_rate": 0.01} if name == "adafactor" else {"weight_decay": 0.1}
    params, grads = _params_and_grads()
    runs = []
    for mask in ({"w": True, "b": False},
                 lambda named: {n: p.ndim > 1 for n, p in named.items()}):
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        optimizer, _ = opt.build_optimizer(tp, name, 0.05, {**decay, key: mask}, total_steps=5)
        for g in grads:
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k])
            optimizer.step()
        runs.append(tp)
    tx, _ = jax_opt.build_optimizer(name, 0.05, {**decay, key: {"w": True, "b": False}},
                                    None, total_steps=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
    unmasked, _, _ = _run_both(name, decay, steps=5)
    for k in params:
        np.testing.assert_allclose(runs[0][k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        assert torch.equal(runs[0][k], runs[1][k])
    # the mask moved the bias only: the decayed kernel is the unmasked run's
    assert torch.equal(runs[0]["w"], unmasked["w"])
    assert not torch.equal(runs[0]["b"], unmasked["b"])
    with pytest.raises(ValueError, match="named parameters"):
        opt.build_optimizer([torch.zeros(3)], name, 0.1, {key: {"w": True}})
    with pytest.raises(ValueError, match="does not name"):
        opt.build_optimizer({"w": torch.zeros(3), "b": torch.zeros(3)}, name, 0.1,
                            {key: {"w": True}})


def test_moment_dtypes_are_kept_through_a_checkpoint():
    """The stored moment stays in its dtype, also after load_state_dict
    (torch would cast it to the parameter's dtype)."""
    p = torch.ones(4)
    optimizer, _ = opt.build_optimizer([p], "adamw", 0.1, {"mu_dtype": "bfloat16"})
    p.grad = torch.full((4,), 0.5)
    optimizer.step()
    state = optimizer.state_dict()
    again, _ = opt.build_optimizer([p], "adamw", 0.1, {"mu_dtype": "bfloat16"})
    again.load_state_dict(state)
    assert again.state[p]["mu"].dtype == torch.bfloat16
    assert again.state[p]["nu"].dtype == torch.float32
    assert again.count == 1


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


def test_all_reference_optimizers_build():
    """Each of the reference's eight names builds here too."""
    names = sorted(jax_opt._OPTIMIZERS)
    assert names == sorted(opt._OPTIMIZERS)
    for name in names:
        optimizer, _ = opt.build_optimizer([torch.zeros(2)], name)
        assert optimizer.count == 0


def test_adafactor_factors_the_two_largest_dims():
    """A [256, 640] weight keeps a 256-row and a 640-column mean (896
    floats), far under Adam's two full moments; a bias keeps its own."""
    w, b = torch.zeros(256, 640), torch.zeros(640)
    factored, _ = opt.build_optimizer([w, b], "adafactor")
    adam, _ = opt.build_optimizer([w, b], "adam")
    assert {k: tuple(v.shape) for k, v in factored.state[w].items()} == {
        "v_row": (256,), "v_col": (640,)}
    assert {k: tuple(v.shape) for k, v in factored.state[b].items()} == {"v": (640,)}
    assert sum(v.numel() for v in factored.state[w].values()) == 896
    assert sum(v.numel() for v in adam.state[w].values()) == 2 * 256 * 640


CONVERT_CASES = {
    "adamw": ("adamw", {"weight_decay": 0.1}),
    "sgd-momentum": ("sgd", {"momentum": 0.9}),
    "lamb": ("lamb", None),
    "lion": ("lion", None),
    "adafactor-factored": ("adafactor", {"min_dim_size_to_factor": 3, "momentum": 0.5}),
    "rmsprop-centered": ("rmsprop", {"centered": True, "momentum": 0.9}),
    "adagrad": ("adagrad", None),
    # a LoRA run: the reference wraps the chain in multi_transform, with
    # set_to_zero on the frozen parameters ("s" here); the port gives the
    # optimizer only the trainable ones
    "adamw-lora": ("adamw", {"weight_decay": 0.1}),
}
FROZEN = {"adamw-lora": ("s",)}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_opt_state_from_jax_continues_optax(case):
    """Two optax updates; the state converted into the port (each matrix
    held transposed, as the port holds kernels); two more updates on each
    side. The square (3, 3) leaf checks that adafactor's row and column
    factors swap with the transpose."""
    name, config = CONVERT_CASES[case]
    rng = np.random.default_rng(3)
    shapes = {"w": (4, 3), "s": (3, 3), "b": (3,)}
    params = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    grads = [{k: (0.3 * rng.standard_normal(v)).astype(np.float32) for k, v in shapes.items()}
             for _ in range(4)]
    sched = {"name": "cosine", "warmup_steps": 1}
    tx, _ = jax_opt.build_optimizer(name, 0.05, config, sched, total_steps=4)
    frozen = FROZEN.get(case, ())
    if frozen:
        tx = optax.multi_transform(
            {"train": tx, "freeze": optax.set_to_zero()},
            {k: "freeze" if k in frozen else "train" for k in shapes},
        )
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    mid = None
    for i, g in enumerate(grads):
        if i == 2:
            mid = (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, state))
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    def port(a):  # the port holds every matrix transposed
        t = torch.from_numpy(np.array(a, copy=True))
        return t.T.contiguous() if t.ndim == 2 else t

    tp = {k: port(v) for k, v in mid[0].items()}
    trained = [p for k, p in tp.items() if k not in frozen]
    optimizer, _ = opt.build_optimizer(trained, name, 0.05, config, sched, total_steps=4)
    layout = {k: ((k,), len(v) == 2) for k, v in shapes.items()}
    opt_state_from_jax(mid[1], optimizer, tp, layout)
    assert optimizer.count == 2
    for g in grads[2:]:
        for k, p in tp.items():
            p.grad = port(g[k])
        optimizer.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), port(jp[k]).numpy(), rtol=1e-6, atol=1e-7)
    for k in frozen:  # frozen on both sides
        np.testing.assert_array_equal(tp[k].numpy(), port(params[k]).numpy())
    # without the conversion the port's continuation differs
    fresh = {k: port(v) for k, v in mid[0].items()}
    other, _ = opt.build_optimizer([p for k, p in fresh.items() if k not in frozen], name,
                                   0.05, config, sched, total_steps=4)
    for g in grads[2:]:
        for k, p in fresh.items():
            p.grad = port(g[k])
        other.step()
    assert not all(np.allclose(fresh[k].numpy(), tp[k].numpy()) for k in shapes)


def test_state_dict_carries_the_count():
    """`count` (the updates made, which the schedule reads) survives a
    state_dict round trip; torch's own state_dict has no place for it."""
    sched = {"name": "cosine", "warmup_steps": 2}
    p = torch.ones(3)
    optimizer, schedule = opt.build_optimizer([p], "adamw", 0.1, schedule=sched, total_steps=8)
    for _ in range(3):
        p.grad = torch.full((3,), 0.5)
        optimizer.step()
    buf = io.BytesIO()
    torch.save(optimizer.state_dict(), buf)
    buf.seek(0)
    sd = torch.load(buf, weights_only=True)
    assert sd["count"] == 3
    q = p.detach().clone()
    again, _ = opt.build_optimizer([q], "adamw", 0.1, schedule=sched, total_steps=8)
    again.load_state_dict(sd)
    assert again.count == 3
    assert torch.equal(again.state[q]["mu"], optimizer.state[p]["mu"])
    for o, t in ((optimizer, p), (again, q)):
        t.grad = torch.full((3,), 0.5)
        o.step()
    assert torch.equal(p, q) and schedule(3) != schedule(0)
