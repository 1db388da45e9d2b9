"""The port's switch-MoE transformer on device meshes against the JAX
package's, on the CPU: the expert axis, expert parallelism composed with
data and fsdp, tensor parallelism inside each expert, and the capacity
positions of a sequence split over `context`.

The model: the flagship at dim 64 with 2 layers, 4 heads (2 kv), vocab
256, seq 32, 4 experts at capacity factor 1.0 (C = 8 tokens of 32 per
row), so tokens do overflow their expert's queue; batch 4, AdamW with
clipping, float32, 3 steps from the JAX trainer's own initial parameters
(`params_from_jax`). The meshes: {expert: 2}, {data: 2, expert: 2},
{model: 2} and {context: 2}, and, marked slow as its reference is,
{fsdp: 2, expert: 2, data: 2} (the reference's composed case,
`tests/test_parallel.py::test_composed_mesh_trains`), all held against
the JAX Trainer on {data: 2, expert: 2} (the 8 virtual CPU devices of
`tests/conftest.py`; GSPMD computes the same function on every mesh),
the port's in `gloo` worlds of 2, 4 and 8 ranks
(`tests/torch_mesh_workers.py`).

Per step the loss (the aux loss of both layers in it) and grad_norm
within 5e-5 relative, and the update (final - initial) within 1e-3
relative Frobenius, `tests/test_torch_trainer_mesh.py`'s tolerances. On
the stream's first batch, one forward and backward on each mesh: the aux
loss within 1e-5 relative and the gradients of the router and the expert
kernels within 1e-4 relative Frobenius of the reference's `jax.grad`
(the same function; the ranks' sums run in another order), and the
tokens past capacity in each layer equal to the one-process count, which
is above zero: under {context: 2} a chunk's queue places start after the
earlier chunk's counts.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polyaxon_tpu.models.registry import build_model as jax_build_model
from polyaxon_tpu.ops.losses import masked_lm as jax_masked_lm
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.models.transformer import _make_config
from polyaxon_tpu_torch.runtime import Trainer
from torch_mesh_workers import moe_step, run_world

STEPS = 3
MODEL = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256, seq_len=32,
             n_experts=4, capacity_factor=1.0)
PROGRAM = {
    "model": {"name": "transformer_lm", "config": MODEL},
    "data": {"name": "synthetic_text", "batchSize": 4,
             "config": {"seq_len": 32, "vocab_size": 256}},
    "optimizer": {"name": "adamw", "learningRate": 3e-3,
                  "schedule": {"name": "cosine", "warmup_steps": 1},
                  "config": {"grad_clip_norm": 1.0}},
    "train": {"steps": STEPS, "logEvery": 1, "precision": "float32"},
}
DENSE = {**PROGRAM, "model": {"name": "transformer_lm", "config": {
    k: v for k, v in MODEL.items() if k not in ("n_experts", "capacity_factor")}}}
THREE = {**PROGRAM, "model": {"name": "transformer_lm", "config": {**MODEL, "n_experts": 3}}}
MESHES = {
    "expert2": {"expert": 2},
    "data2-expert2": {"data": 2, "expert": 2},
    "model2": {"model": 2},
    "context2": {"context": 2},
}
# the reference's composed case: 8 ranks, marked slow as its reference
# counterpart is
COMPOSED = {"fsdp2-expert2-data2": {"fsdp": 2, "expert": 2, "data": 2}}
# the mesh of the JAX Trainer every case is held against: the reference's
# own expert parallelism (GSPMD partitions dispatch and combine over it)
REFERENCE_MESH = {"data": 2, "expert": 2}


def _world(axes):
    return int(np.prod(list(axes.values())))


def _jax_trainer(axes):
    jt = JaxTrainer(JaxProgram.from_dict(PROGRAM), mesh_axes=axes,
                    devices=jax.devices()[:_world(axes)])
    return jt, jax.tree.map(np.asarray, jt.state.params)


def _jax_run(jt):
    jr = jt.run()
    return jr.history, jax.tree.map(np.asarray, jr.state.params)


def _state(params):
    return {k: v.numpy() for k, v in params_from_jax(params, _make_config(MODEL)).items()}


def mesh_runs(meshes: dict, extra=()) -> dict:
    """name → (JAX initial params, history, final params; the port's
    trainer run and first-batch step on every rank) for each mesh, against
    the JAX Trainer on REFERENCE_MESH (GSPMD computes the same function on
    every mesh; one reference keeps the JAX compiles within the suite's
    time), the worlds one after another beside it; `extra`: (name,
    [cases]) for the 2-rank world, their results by name; "reference":
    the reference's first-batch step and one process's."""
    jt, init = _jax_trainer(REFERENCE_MESH)
    state = _state(init)
    by_world: dict = {}
    for name, axes in meshes.items():
        by_world.setdefault(_world(axes), []).append((name, [
            ("trainer_run", dict(program=PROGRAM, mesh_axes=axes, state=state)),
            ("moe_step", dict(program=PROGRAM, mesh_axes=axes, state=state))]))
    if extra:
        by_world.setdefault(2, []).extend(extra)
    with ThreadPoolExecutor(1) as pool:
        worlds = pool.submit(lambda: {n: run_world(n, [c for _, cases in work for c in cases])
                                      for n, work in by_world.items()})
        ran = _jax_run(jt)
        per_world = worlds.result()
    port = {}
    for n, work in by_world.items():
        i = 0
        for name, cases in work:
            port[name] = [[rank[i + j] for rank in per_world[n]] for j in range(len(cases))]
            i += len(cases)
    out = {n: (init, *ran, *port[n]) for n in meshes}
    out.update({name: port[name] for name, _ in extra})
    out["reference"] = (_jax_step(init), moe_step(PROGRAM, None, state))
    return out


@pytest.fixture(scope="module")
def runs():
    return mesh_runs(MESHES, extra=[("refusals", [
        ("trainer_error", dict(program=DENSE, mesh_axes={"expert": 2})),
        ("trainer_error", dict(program=THREE, mesh_axes={"expert": 2}))])])


def _first_batch():
    trainer = Trainer(PROGRAM, device="cpu")
    batch = next(trainer.data.iterator)
    trainer.close()
    return {k: np.asarray(v) for k, v in batch.items()}


def _jax_step(params):
    from polyaxon_tpu.parallel.ring import set_current_mesh

    set_current_mesh(None)  # one device: the mesh a JAX Trainer left bound
    bundle = jax_build_model("transformer_lm", dict(MODEL))
    batch = _first_batch()

    def loss_fn(p):
        logits, sown = bundle.module.apply({"params": p}, jnp.asarray(batch["inputs"]),
                                           train=True, mutable=["losses"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(sown["losses"]))
        return jax_masked_lm(logits, {"labels": jnp.asarray(batch["labels"])}) + aux, aux

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), float(aux), jax.tree.map(np.asarray, grads)


def check_steps(run):
    _, history, _, trained, _ = run
    ours = [h for h in trained[0]["history"] if "loss" in h]
    want = [h for h in history if "loss" in h]
    assert [h["step"] for h in ours] == [h["step"] for h in want] == list(range(1, STEPS + 1))
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5)


def check_final_params(run):
    init, _, final, trained, _ = run
    start, want = _state(init), _state(final)
    ours = trained[0]["params"]
    assert set(ours) == set(want)
    num = sum(((ours[k] - want[k]) ** 2).sum() for k in want)
    den = sum(((want[k] - start[k]) ** 2).sum() for k in want)
    assert den > 0 and np.sqrt(num / den) < 1e-3


def check_aux_and_expert_gradients(run, reference):
    _, _, _, _, stepped = run
    loss, aux, grads = reference[0]
    want = _state(grads)  # the gradient tree in the port's names and layouts
    for rank in stepped:
        np.testing.assert_allclose(rank["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(rank["aux"], aux, rtol=1e-5)
        assert set(rank["grads"]) == {k for k in want if ".moe." in k}
        for k, g in rank["grads"].items():
            err = np.linalg.norm(g - want[k]) / np.linalg.norm(want[k])
            assert err < 1e-4, (k, err)


def check_tokens_past_capacity(run, reference):
    _, _, _, _, stepped = run
    single = reference[1]
    assert len(single["dropped"]) == 2 and min(single["dropped"]) > 0
    for rank in stepped:
        assert rank["dropped"] == single["dropped"]


@pytest.mark.parametrize("name", list(MESHES))
def test_step_metrics_match_jax(runs, name):
    check_steps(runs[name])


@pytest.mark.parametrize("name", list(MESHES))
def test_final_params_match_jax(runs, name):
    check_final_params(runs[name])


@pytest.mark.parametrize("name", list(MESHES))
def test_aux_loss_and_expert_gradients_match_jax(runs, name):
    check_aux_and_expert_gradients(runs[name], runs["reference"])


@pytest.mark.parametrize("name", list(MESHES))
def test_tokens_past_capacity_match_one_process(runs, name):
    """Tokens do overflow (C = 8 of 32 a row), and the mesh drops exactly
    the tokens one process drops: under {context: 2} the second chunk's
    queue places count the first chunk's tokens."""
    check_tokens_past_capacity(runs[name], runs["reference"])


@pytest.mark.slow
def test_composed_fsdp_expert_data_mesh_matches_jax():
    """{fsdp: 2, expert: 2, data: 2}: tests/test_parallel.py's composed
    case, held like the meshes above."""
    out = mesh_runs(COMPOSED)
    run = out["fsdp2-expert2-data2"]
    check_steps(run)
    check_final_params(run)
    check_aux_and_expert_gradients(run, out["reference"])
    check_tokens_past_capacity(run, out["reference"])


def test_expert_axis_refusals_match_jax(runs):
    """An expert axis needs experts, and one that divides them, in both
    packages (the reference's `_validate_mesh_fit`)."""
    for prog, per_rank in zip((DENSE, THREE), runs["refusals"]):
        kind, msg = per_rank[0]
        with pytest.raises(ValueError) as ref:
            JaxTrainer(JaxProgram.from_dict(prog), mesh_axes={"expert": 2},
                       devices=jax.devices()[:2])
        assert kind == "ValueError"
        for phrase in ("no experts", "n_experts (3)"):
            assert (phrase in msg) == (phrase in str(ref.value)), (msg, ref.value)
        assert "no experts" in msg or "n_experts (3)" in msg
