"""The port's Trainer on a device mesh against the JAX package's Trainer on
the same mesh, on the CPU.

Both run the same program (a 1-layer flagship, GQA 4/2 at head_dim 32,
seq 64, batch 2, AdamW with clipping and a cosine schedule, float32) for 3
steps from the same initial parameters: the JAX trainer's own, converted
with `params_from_jax`. The JAX trainer runs on the 8 virtual CPU devices
of `tests/conftest.py`; the port's in `gloo` worlds of 2 and 4 ranks
(`tests/torch_mesh_workers.py`, one world per size for every case). The
meshes: {data: 2}, {fsdp: 2}, {model: 2}, {context: 2} with ring (its
einsum body: head_dim 32 is below the flash gate in both packages; the
flash hops are `tests/test_torch_context_parallel.py`'s) and with ulysses
(flash on the gathered sequence), {fsdp: 2, model: 2} and the hybrid
{data: 2, model: 2} with slices: 2.

Tolerances, as `tests/test_torch_trainer.py` holds the single-device
pair: loss and grad_norm within 5e-5 relative per step, learning_rate
within 1e-6, and the update each run made (final - initial) within 1e-3
relative Frobenius. Against the port's own single-process Trainer the mesh
run holds loss and grad_norm within 2e-6 relative: the same function, with
the sums of the reductions in another order.

A checkpoint saved on {fsdp: 2} holds the full tensors in the
single-device format: a single-process Trainer, a Trainer on {data: 2} and
`ModelServer.from_run` each restore the saved weights exactly, and the two
resumed runs train alike.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.models.transformer import _make_config
from polyaxon_tpu_torch.runtime import Trainer
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.store import RunStore
from torch_mesh_workers import run_world

STEPS = 3
MODEL = dict(dim=128, n_layers=1, n_heads=4, n_kv_heads=2, vocab_size=256, seq_len=64)


def program(model=None, train=None):
    return {
        "model": {"name": "transformer_lm", "config": {**MODEL, **(model or {})}},
        "data": {"name": "synthetic_text", "batchSize": 2,
                 "config": {"seq_len": 64, "vocab_size": 256}},
        "optimizer": {"name": "adamw", "learningRate": 3e-3,
                      "schedule": {"name": "cosine", "warmup_steps": 1},
                      "config": {"grad_clip_norm": 1.0}},
        "train": {"steps": STEPS, "logEvery": 1, "precision": "float32", **(train or {})},
    }


# name: (mesh axes, slices, model overrides)
CASES = {
    "data2": ({"data": 2}, 1, {}),
    "fsdp2": ({"fsdp": 2}, 1, {}),
    "model2": ({"model": 2}, 1, {}),
    "context2-ring": ({"context": 2}, 1, {"attention": "ring"}),
    "context2-ulysses": ({"context": 2}, 1, {"attention": "ulysses"}),
    "fsdp2-model2": ({"fsdp": 2, "model": 2}, 1, {}),
    "data2-model2-slices2": ({"data": 2, "model": 2}, 2, {}),
}


def _world(axes):
    return int(np.prod(list(axes.values())))


def _jax_trainer(name):
    axes, slices, model = CASES[name]
    return JaxTrainer(JaxProgram.from_dict(program(model)), mesh_axes=axes,
                      devices=jax.devices()[:_world(axes)], slices=slices)


@functools.cache
def jax_init():
    """The initial parameters, as numpy: every case's JAX trainer starts
    from these (same seed and shapes; `test_jax_cases_share_the_init`)."""
    return jax.tree.map(np.asarray, _jax_trainer("data2").state.params)


def _jax_run(name):
    jt = _jax_trainer(name)
    init = jax.tree.map(np.asarray, jt.state.params)
    jr = jt.run()
    return init, jr.history, jax.tree.map(np.asarray, jr.state.params)


@functools.cache
def jax_runs():
    """name → (initial params as numpy, history, final params as numpy);
    the runs compile and train on threads of their own (XLA compiles
    outside the GIL; each trainer binds its mesh to its own thread)."""
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(CASES, pool.map(_jax_run, CASES)))


def _state(params_np):
    cfg = _make_config(MODEL)
    return {k: v.numpy() for k, v in params_from_jax(params_np, cfg).items()}


def port_runs(tmp):
    """name → the port's run on rank 0 (history, final full params), plus
    the checkpoint cases; the worlds run while the JAX trainers do."""
    init = _state(jax_init())
    store = RunStore(tmp)
    store.create_run(RUN, "mesh-save", "default",
                     {"component": {"run": {"kind": "jaxjob", "program": program()}}})
    ckpt = str(store.outputs_dir(RUN) / "checkpoints")
    by_world: dict = {2: [], 4: []}
    for name, (axes, slices, model) in CASES.items():
        by_world[_world(axes)].append((name, ("trainer_run", dict(
            program=program(model), mesh_axes=axes, slices=slices, state=init))))
    saving = program(train={"steps": 2, "checkpointEvery": 2})
    by_world[2].append(("save-fsdp2", ("trainer_run", dict(
        program=saving, mesh_axes={"fsdp": 2}, state=init, checkpoint_dir=ckpt))))
    by_world[2].append(("resume-data2", ("trainer_run", dict(
        program=program(train={"resume": True}), mesh_axes={"data": 2},
        checkpoint_dir=ckpt))))
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(run_world, n, [case for _, case in work])
                   for n, work in by_world.items()}
        jax_runs()
        for model in {tuple(sorted(c[2].items())) for c in CASES.values()}:
            single_process(model)
        out = {}
        for n, work in by_world.items():
            out.update({name: r for (name, _), r in zip(work, futures[n].result()[0])})
    return out, store, ckpt


RUN = "0123456789abcdef0123456789abcdef"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return port_runs(str(tmp_path_factory.mktemp("mesh-home")))


def _rows(history):
    return [h for h in history if "loss" in h]


@pytest.mark.parametrize("name", list(CASES))
def test_jax_cases_share_the_init(runs, name):
    init = jax_runs()[name][0]
    for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(jax_init())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_step_metrics_match_jax(runs, name):
    ours = _rows(runs[0][name]["history"])
    want = _rows(jax_runs()[name][1])
    assert [h["step"] for h in ours] == [h["step"] for h in want] == list(range(1, STEPS + 1))
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5)
        np.testing.assert_allclose(a["learning_rate"], b["learning_rate"], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_final_params_match_jax(runs, name):
    init, _, final = jax_runs()[name]
    model = CASES[name][2]
    start, want = _state(init), _state(final)
    ours = runs[0][name]["params"]
    assert set(ours) == set(want)
    num = sum(((ours[k] - want[k]) ** 2).sum() for k in want)
    den = sum(((want[k] - start[k]) ** 2).sum() for k in want)
    assert den > 0 and np.sqrt(num / den) < 1e-3


@functools.cache
def single_process(model_items):
    model = dict(model_items)
    trainer = Trainer(program(model), device="cpu")
    trainer.load_state_dict({k: torch.from_numpy(v) for k, v in _state(jax_init()).items()})
    return trainer.run().history


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_equals_the_single_process_trainer(runs, name):
    ours = _rows(runs[0][name]["history"])
    want = _rows(single_process(tuple(sorted(CASES[name][2].items()))))
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=2e-6)


def test_mesh_checkpoint_resumes_on_one_process_and_on_another_mesh(runs):
    results, _, ckpt = runs
    saved = results["save-fsdp2"]
    assert saved["step"] == 2
    trainer = Trainer(program(train={"resume": True}), device="cpu", checkpoint_dir=ckpt)
    assert trainer.restore() == 2
    for k, v in trainer.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved["params"][k])
    trainer = Trainer(program(train={"resume": True}), device="cpu", checkpoint_dir=ckpt)
    single = trainer.run()
    resumed = results["resume-data2"]
    assert resumed["step"] == single.state.step == STEPS
    ours, want = _rows(resumed["history"]), _rows(single.history)
    assert [h["step"] for h in ours] == [h["step"] for h in want] == [STEPS]
    np.testing.assert_allclose(ours[0]["loss"], want[0]["loss"], rtol=2e-6)
    for k, v in single.state.module.state_dict().items():
        np.testing.assert_allclose(resumed["params"][k], v.numpy(), rtol=1e-5, atol=1e-6)


def test_mesh_checkpoint_serves_from_run(runs):
    results, store, _ = runs
    server = ModelServer.from_run(RUN, store=store, device="cpu")
    assert server.restore_info["step"] == 2
    saved = results["save-fsdp2"]["params"]
    for k, v in server.module.state_dict().items():
        if k in saved:
            np.testing.assert_array_equal(v.float().numpy(), saved[k])


@pytest.mark.slow
def test_composed_mesh_trains():
    """tp + context + dp compose on 8 ranks (the counterpart of
    tests/test_parallel.py::test_composed_mesh_trains' first case; its
    pipeline and expert cases are not ported)."""
    prog = program({"attention": "ring"}, {"steps": 2})
    out = run_world(8, [("trainer_run", dict(
        program=prog, mesh_axes={"model": 2, "context": 2, "data": 2}))])[0][0]
    assert np.isfinite(out["history"][-1]["loss"])
