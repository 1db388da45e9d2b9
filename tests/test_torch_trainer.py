"""The port's Trainer against the JAX package's Trainer, on the CPU.

Both run the same program on the `tiny` preset at seq 64, batch 4, from the
same initial parameters: the JAX trainer's own initial `state.params`,
turned into numpy and converted with `params_from_jax`. Optimizer state
starts at zero on both sides. The JAX trainer is pinned to one device. The
data streams are byte-identical (`test_torch_data.py`), so the two runs see
the same batches; what differs is the order of f32 sums, and under
`mixed` where bf16 rounding lands.

Tolerances, per step and on the final parameters:
- float32: loss and grad_norm within 5e-5 relative (the JAX package's own
  backward tolerance; four steps of f32 sum-order noise), learning_rate
  within 1e-6 (the reference evaluates the schedule in f32, the port in
  f64). The update each run made to the parameters (final - initial)
  agrees within 1e-3 relative Frobenius: Adam divides each gradient by its
  own running magnitude, so f32 noise in near-zero gradients shows in
  those elements' updates (read: up to 6e-5).
- mixed: both sides round the same tensors to bf16, but not always to the
  same side of a rounding point, so loss within 5e-4 and grad_norm within
  5e-3 relative (read: 1.9e-4 and 2.1e-3), and the updates within 0.1
  relative Frobenius (read: 0.042; bf16 noise in the smallest gradients
  flips the sign of their Adam update). These limits cannot tell a bf16
  forward from an f32 one: the port computing in f32 against the same JAX
  mixed run reads 3.1e-4, 4.3e-3 and 0.049, and at step 1 it sits closer
  to the JAX run (4.6e-5 on the loss) than the sound port does (8.1e-5).
  On the tiny preset bf16 sum-order noise is as large as the whole bf16
  rounding, so `test_forward_sees_the_compute_dtype` holds the cast itself.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from pydantic_core import PydanticUndefined

from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas import run_kinds
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu.telemetry import stats as jax_stats
from polyaxon_tpu_torch import schemas
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.runtime import Trainer
from polyaxon_tpu_torch.telemetry import stats

STEPS = 4


def program(model=None, train=None, optimizer=None):
    return {
        "model": {"name": "transformer_lm",
                  "config": {"preset": "tiny", "seq_len": 64, **(model or {})}},
        "data": {"name": "synthetic_text", "batchSize": 4,
                 "config": {"seq_len": 64, "vocab_size": 4096}},
        "optimizer": {"name": "adamw", "learningRate": 3e-3,
                      "schedule": {"name": "cosine", "warmup_steps": 1},
                      "config": {"grad_clip_norm": 1.0}, **(optimizer or {})},
        "train": {"steps": STEPS, "logEvery": 1, **(train or {})},
    }


RUNS = {
    "float32": program(train={"precision": "float32", "evalEvery": 2, "evalSteps": 2}),
    "mixed": program(train={"precision": "mixed"}),
    "fused-accum": program(
        model={"fused_lm_loss": True, "fused_loss_chunk": 1000},
        train={"precision": "float32", "gradAccum": 2},
    ),
    "lora": program(
        model={"lora": {"rank": 4, "alpha": 8, "targets": ["q_proj"]}},
        train={"precision": "float32"},
        optimizer={"config": {"weight_decay": 0.1}},
    ),
    "flash": program(model={"attention": "flash"}, train={"precision": "float32"}),
}
TOL = {  # loss, grad_norm, update relative Frobenius
    "float32": (5e-5, 5e-5, 1e-3),
    "mixed": (5e-4, 5e-3, 0.1),
}


def _port(prog, init_np, **extra_train):
    prog = {**prog, "train": {**prog["train"], **extra_train}}
    trainer = Trainer(prog, device="cpu")
    trainer.load_state_dict(params_from_jax(init_np, trainer.module.cfg))
    return trainer, trainer.run()


@functools.cache
def run_pair(name):
    """(JAX history, initial and final JAX params as numpy, port trainer,
    port result), computed once per run name (the JAX builds compile
    slowly)."""
    jt = JaxTrainer(JaxProgram.from_dict(RUNS[name]), devices=jax.devices()[:1])
    init = jax.tree.map(np.asarray, jt.state.params)
    jr = jt.run()
    final = jax.tree.map(np.asarray, jr.state.params)
    trainer, result = _port(RUNS[name], init)
    return jr.history, init, final, trainer, result


def _train_rows(history):
    return [h for h in history if "loss" in h]


def _tol(name):
    return TOL["mixed" if name == "mixed" else "float32"]


# this file holds the float32 and mixed runs; fused-accum, lora and flash
# run in tests/test_torch_trainer_variants.py (one JAX compile set a file,
# so the two files run on two workers)
HERE_RUNS = ["float32", "mixed"]


def check_step_metrics(name):
    ref, _, _, _, result = run_pair(name)
    loss_tol, norm_tol, _ = _tol(name)
    ours, want = _train_rows(result.history), _train_rows(ref)
    assert [h["step"] for h in ours] == [h["step"] for h in want] == list(range(1, STEPS + 1))
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=loss_tol)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=norm_tol)
        np.testing.assert_allclose(a["learning_rate"], b["learning_rate"], rtol=1e-6, atol=1e-12)
    assert ours[-1]["loss"] < ours[0]["loss"] or name == "lora"


def check_final_params(name):
    _, init, final, trainer, _ = run_pair(name)
    cfg = trainer.module.cfg
    start, want = params_from_jax(init, cfg), params_from_jax(final, cfg)
    ours = trainer.module.state_dict()
    assert set(ours) == set(want)
    num = sum(((ours[k].float() - want[k]) ** 2).sum() for k in want)
    den = sum(((want[k] - start[k]) ** 2).sum() for k in want)
    assert den > 0
    assert (num / den).sqrt().item() < _tol(name)[2]


@pytest.mark.parametrize("name", HERE_RUNS)
def test_step_metrics_match_jax(name):
    check_step_metrics(name)


@pytest.mark.parametrize("name", HERE_RUNS)
def test_final_params_match_jax(name):
    check_final_params(name)


def test_eval_metrics_match_jax():
    ref, _, _, _, result = run_pair("float32")
    ours = [h for h in result.history if "eval.loss" in h]
    want = [h for h in ref if "eval.loss" in h]
    assert [h["step"] for h in ours] == [h["step"] for h in want] == [2, 4]
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a["eval.loss"], b["eval.loss"], rtol=5e-5)
        # the mean of exp(loss) over the eval batches: 5e-5 relative on a
        # loss near 9 nats moves exp(loss) by up to 4.5e-4 relative
        np.testing.assert_allclose(a["eval.perplexity"], b["eval.perplexity"], rtol=5e-4)


REMAT_STEPS = 2  # the bitwise equalities hold or fail from the first update on


@functools.cache
def _port_once(dropout, remat):
    """One port run of the remat program, shared between the cases: the
    dropout case's run without dropout is the plain case's plain run."""
    _, init, _, _, _ = run_pair("float32")
    return _port(_remat_program(dropout), init, remat=remat)


def _remat_program(dropout):
    return program(model={"dropout_rate": dropout},
                   train={"precision": "float32", "steps": REMAT_STEPS})


@pytest.mark.parametrize("dropout", [0.0, 0.2], ids=["plain", "dropout"])
def test_remat_equals_no_remat(dropout):
    """Recomputing the forward in the backward changes nothing, dropout
    included: the recompute draws the same mask."""
    _, init, _, _, _ = run_pair("float32")
    _, plain = _port_once(dropout, False)
    t_remat, remat = _port_once(dropout, True)
    _, again = _port(_remat_program(dropout), init)
    assert len(plain.history) == REMAT_STEPS
    assert [h["loss"] for h in plain.history] == [h["loss"] for h in remat.history]
    assert [h["loss"] for h in plain.history] == [h["loss"] for h in again.history]
    for a, b in zip(plain.state.module.state_dict().values(),
                    t_remat.module.state_dict().values()):
        assert torch.equal(a, b)
    if dropout:
        nodrop = _port_once(0.0, False)[1]
        assert plain.history[0]["loss"] != nodrop.history[0]["loss"]


@pytest.mark.parametrize(
    "precision,compute,master",
    [("mixed", torch.bfloat16, torch.float32),
     ("float32", torch.float32, torch.float32),
     ("bfloat16", torch.bfloat16, torch.bfloat16)],
)
def test_forward_sees_the_compute_dtype(monkeypatch, precision, compute, master):
    """Every parameter reaches the forward in the compute dtype, norm scales
    and the embedding included, and its gradient lands on the master in the
    master dtype."""
    from polyaxon_tpu_torch.runtime import trainer as trainer_mod

    seen = []
    real = trainer_mod.functional_call

    def spy(module, params, *args, **kwargs):
        seen.append({name: p.dtype for name, p in params.items()})
        return real(module, params, *args, **kwargs)

    monkeypatch.setattr(trainer_mod, "functional_call", spy)
    trainer = Trainer(program(train={"precision": precision, "steps": 1}), device="cpu")
    masters = dict(trainer.module.named_parameters())
    assert any(n.endswith("scale") for n in masters) and any("embed" in n for n in masters)
    trainer.train_step(trainer._to_device(next(trainer.data.iterator)))
    assert len(seen) == 1 and seen[0].keys() == masters.keys()
    assert set(seen[0].values()) == {compute}
    for name, p in masters.items():
        assert p.dtype == p.grad.dtype == master, name
    assert all(p.grad.abs().sum() > 0 for p in masters.values())


def test_grad_accum_adjusts_to_a_divisor():
    events = []
    trainer = Trainer(
        program(train={"gradAccum": 3, "steps": 1}), device="cpu",
        event_fn=lambda kind, body: events.append((kind, body)),
    )
    assert trainer.grad_accum == 4
    assert events == [("grad_accum_adjusted", {
        "requested": 3, "effective": 4, "global_batch": 4, "batch_shards": 1,
    })]


def test_program_without_data_raises():
    """Without `data` both packages fall back to the image dataset
    `synthetic` (32-dim vectors), which a token model cannot take: the
    data/model shape check raises, as the reference's does
    (`tests/test_torch_zoo_trainer.py` trains a classifier on it)."""
    prog = program()
    del prog["data"]
    with pytest.raises(ValueError, match="shape mismatch"):
        JaxTrainer(JaxProgram.from_dict(prog), devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="shape mismatch"):
        Trainer(prog, device="cpu")


def test_mesh_axes_raise():
    """A mesh over more than one device needs the caller's world (one
    process per device: tests/test_torch_trainer_mesh.py); a zoo model on
    a mesh of one trains under its rules (tests/test_torch_zoo_mesh.py
    holds the larger meshes)."""
    with pytest.raises(RuntimeError, match="torch.distributed world"):
        Trainer(program(), device="cpu", mesh_axes={"data": 2})
    zoo = {"model": {"name": "mlp", "config": {"input_dim": 784}},
           "data": {"name": "mnist", "batchSize": 8}, "train": {"steps": 1}}
    trainer = Trainer(zoo, device="cpu", mesh_axes={"data": 1})
    assert trainer.sharded is not None and trainer.bundle.sharding_rules
    assert np.isfinite(trainer.run().history[-1]["loss"])


def test_fused_loss_refuses_another_loss():
    with pytest.raises(ValueError, match="fused_lm_loss"):
        Trainer(program(model={"fused_lm_loss": True}, train={"loss": "mse"}), device="cpu")


def test_profile_window_writes_a_trace(tmp_path):
    trainer = Trainer(
        program(train={"steps": 3, "profileStart": 1, "profileStop": 2}),
        device="cpu", artifacts_dir=str(tmp_path),
    )
    trainer.run()
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0
    assert trainer.profile is not None and len(trainer.profile.key_averages()) > 0


@pytest.mark.parametrize(
    "name", ["V1ModelSpec", "V1DataSpec", "V1OptimizerSpec", "V1TrainSpec"]
)
def test_program_specs_have_the_reference_fields_and_defaults(name):
    ref, ours = getattr(run_kinds, name), getattr(schemas, name)
    fields = {f: info.default for f, info in ref.model_fields.items()}
    ours_fields = {f.name: f.default for f in dataclasses.fields(ours)}
    assert ours_fields.keys() == fields.keys()
    for f, default in fields.items():
        if default is not PydanticUndefined:
            assert ours_fields[f] == default, f


def test_program_parses_like_the_reference():
    """camelCase and snake_case keys, one program both sides accept, and
    the unknown keys both reject."""
    program = {
        "model": {"name": "transformer_lm", "config": {"preset": "tiny"}},
        "data": {"name": "synthetic_text", "batchSize": 8, "config": {}},
        "optimizer": {"name": "adamw", "learning_rate": 2e-4},
        "train": {"steps": 3, "logEvery": 1, "grad_accum": 2, "rematPolicy": "nothing"},
    }
    ref = JaxProgram.from_dict(program).model_dump()
    ours = dataclasses.asdict(schemas.V1Program.from_dict(program))
    assert ours == ref
    for bad in ({**program, "extra": 1},
                {**program, "train": {"stepz": 3}},
                {**program, "train": {"precision": "fp8"}}):
        with pytest.raises(ValueError):
            JaxProgram.from_dict(bad)
        with pytest.raises(ValueError):
            schemas.V1Program.from_dict(bad)
    with pytest.raises(ValueError, match="name"):
        schemas.V1Program.from_dict({"model": {}})


def test_throughput_formulas_match_the_reference():
    args = (1_498_482_688, 16, 2048, 8192, 4096)
    assert stats.train_step_flops(*args) == jax_stats.train_step_flops(*args)
    assert stats.mfu(989e12 / 2, "NVIDIA H100 80GB HBM3") == 0.5
    assert stats.mfu(1e12, "cpu") is None
