"""The port's GPipe pipeline (`parallel/pipeline.py`, the transformer's
`PipelinedLayers`) against the sequential model and the JAX package's
pipelined Trainer, on the CPU.

The model: the flagship at dim 64 with 4 layers, 4 heads (2 kv), vocab
256, seq 32, weights stacked [P, Lp, ...] under `pipeline.stages`, the
reference's `pipeline/stages/...` tree carried over by `params_from_jax`.

- forward and gradients on {pipeline: 2} and {pipeline: 4} (the GPipe
  schedule over `ppermute`, 2 and 4 microbatches) equal the same weights
  run as one process's plain loop over stages and layers, logits within
  2e-5 and gradients within 1e-4 (the reference's
  `tests/test_parallel.py` tolerances), and that loop equals the
  reference's nested scan on one device (logits within 2e-5);
- the Trainer on {data: 2, pipeline: 2} and (marked slow, as its
  reference is) {model: 2, pipeline: 2, data: 2} against the JAX Trainer
  on the same mesh, 3 float32 steps:
  loss and grad_norm within 5e-5 relative, the update within 1e-3
  relative Frobenius (`tests/test_torch_trainer_mesh.py`'s tolerances);
- `pipeline_microbatches` 1, 2 and 4 on {pipeline: 2} train alike (loss
  within 1e-6 relative: the same function, products of other batch sizes);
- the optimizer's moments carry across (`opt_state_from_jax`), and a
  pipelined run's checkpoint restores on one process and on a mesh;
- the reference's refusals: dropout and MoE with pipeline stages, the
  KV-cache decode and `adapter_ix` on a pipelined model, layers that do
  not split into the stages or over the pipeline axis.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import build_model as jax_build_model
from polyaxon_tpu.models.transformer import _make_config as jax_make_config
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu_torch.models.convert import (
    opt_state_from_jax, params_from_jax, transformer_layout)
from polyaxon_tpu_torch.models.transformer import Transformer, _make_config
from polyaxon_tpu_torch.runtime import Trainer
from torch_mesh_workers import forward_grads, run_world

STEPS = 3
MODEL = dict(dim=64, n_layers=4, n_heads=4, n_kv_heads=2, vocab_size=256, seq_len=32)


def model(stages, **extra):
    return {**MODEL, "pipeline_stages": stages, **extra}


def program(config, **train):
    return {
        "model": {"name": "transformer_lm", "config": config},
        "data": {"name": "synthetic_text", "batchSize": 4,
                 "config": {"seq_len": 32, "vocab_size": 256}},
        "optimizer": {"name": "adamw", "learningRate": 3e-3,
                      "schedule": {"name": "cosine", "warmup_steps": 1},
                      "config": {"grad_clip_norm": 1.0}},
        "train": {"steps": STEPS, "logEvery": 1, "precision": "float32", **train},
    }


TRAINER_MESHES = {"data2-pipeline2": {"data": 2, "pipeline": 2}}
# the reference's composed case: 8 ranks and a JAX Trainer on 8 devices,
# marked slow as its reference counterpart is
COMPOSED = {"model2-pipeline2-data2": {"model": 2, "pipeline": 2, "data": 2}}
TOKENS = np.random.default_rng(0).integers(0, 256, (8, 32)).astype(np.int64)


def _world(axes):
    return int(np.prod(list(axes.values())))


def _no_mesh():
    """Unbind the mesh a JAX Trainer built on this thread left bound."""
    from polyaxon_tpu.parallel.ring import set_current_mesh

    set_current_mesh(None)


def _jax_params(stages):
    """The reference's initial parameters of the pipelined model, as numpy
    (no mesh bound: the plain nested scan)."""
    _no_mesh()
    bundle = jax_build_model("transformer_lm", model(stages))
    params = bundle.module.init({"params": jax.random.PRNGKey(0)},
                                jnp.asarray(TOKENS[:1], jnp.int32), train=False)["params"]
    return bundle, jax.tree.map(np.asarray, params)


def _state(params, stages, **extra):
    cfg = _make_config(model(stages, **extra))
    return {k: v.numpy() for k, v in params_from_jax(params, cfg).items()}


def _jax_trainer(axes):
    jt = JaxTrainer(JaxProgram.from_dict(program(model(2))), mesh_axes=axes,
                    devices=jax.devices()[:_world(axes)])
    return jt, jax.tree.map(np.asarray, jt.state.params)


def _jax_run(jt):
    jr = jt.run()
    return (jr.history, jax.tree.map(np.asarray, jr.state.params),
            jax.tree.map(np.asarray, jr.state.opt_state))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("pipeline-ckpt"))
    trainers = {n: _jax_trainer(axes) for n, axes in TRAINER_MESHES.items()}
    fwd = {stages: _jax_params(stages)[1] for stages in (2, 4)}
    work: dict = {4: [], 2: []}  # run in this order: the resume follows the save
    for stages in (2, 4):
        work[stages].append((f"forward-{stages}", ("forward_grads", dict(
            program=program(model(stages)), mesh_axes={"pipeline": stages},
            state=_state(fwd[stages], stages), tokens=TOKENS))))
    for name, axes in TRAINER_MESHES.items():
        work[_world(axes)].append((name, ("trainer_run", dict(
            program=program(model(2)), mesh_axes=axes, state=_state(trainers[name][1], 2)))))
    init = _state(trainers["data2-pipeline2"][1], 2)
    for n_micro in (1, 2, 4):
        work[2].append((f"micro-{n_micro}", ("trainer_run", dict(
            program=program(model(2, pipeline_microbatches=n_micro)),
            mesh_axes={"pipeline": 2}, state=init))))
    work[4].append(("save", ("trainer_run", dict(
        program=program(model(2), steps=2, checkpointEvery=2),
        mesh_axes={"data": 2, "pipeline": 2}, state=init, checkpoint_dir=ckpt))))
    work[2].append(("resume-pipeline2", ("trainer_run", dict(
        program=program(model(2), resume=True), mesh_axes={"pipeline": 2},
        checkpoint_dir=ckpt))))
    work[4].append(("layers-over-axis", ("trainer_error", dict(
        program=program(model(2, n_layers=2)), mesh_axes={"pipeline": 4}))))
    work[4].append(("stages-over-axis", ("trainer_step_error", dict(
        program=program(model(2)), mesh_axes={"pipeline": 4}))))
    with ThreadPoolExecutor(1) as pool:
        worlds = pool.submit(lambda: {n: run_world(n, [c for _, c in cases])
                                      for n, cases in work.items()})
        ran = {n: _jax_run(trainers[n][0]) for n in TRAINER_MESHES}
        results = worlds.result()
    port = {}
    for n, cases in work.items():
        for i, (name, _) in enumerate(cases):
            port[name] = [rank[i] for rank in results[n]]
    jax_out = {n: (trainers[n][1], *ran[n]) for n in TRAINER_MESHES}
    return jax_out, port, fwd, ckpt


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_forward_and_gradients_match_sequential(runs, stages):
    _, port, fwd, _ = runs
    state = _state(fwd[stages], stages)
    want = forward_grads(program(model(stages)), None, state, TOKENS)
    for rank in port[f"forward-{stages}"]:
        np.testing.assert_allclose(rank["logits"], want["logits"], atol=2e-5, rtol=2e-5)
        assert set(rank["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(rank["grads"][k], g, atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("stages", [2, 4])
def test_sequential_loop_matches_the_reference_scan(stages):
    bundle, params = _jax_params(stages)
    ref = bundle.module.apply({"params": params}, jnp.asarray(TOKENS, jnp.int32), train=False)
    module = Transformer(_make_config(model(stages)), device="cpu")
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            _state(params, stages).items()})
    with torch.no_grad():
        ours = module(torch.from_numpy(TOKENS)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5, rtol=2e-5)
    assert module.pipeline.stages.attention.q_proj.weight.shape == (stages, 4 // stages, 64, 64)


def check_trainer(jax_run, ours_history, ours_params):
    init, history, final, _ = jax_run
    ours = [h for h in ours_history if "loss" in h]
    want = [h for h in history if "loss" in h]
    assert [h["step"] for h in ours] == [h["step"] for h in want] == list(range(1, STEPS + 1))
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5)
    start, end = _state(init, 2), _state(final, 2)
    assert set(ours_params) == set(end)
    num = sum(((ours_params[k] - end[k]) ** 2).sum() for k in end)
    den = sum(((end[k] - start[k]) ** 2).sum() for k in end)
    assert den > 0 and np.sqrt(num / den) < 1e-3


@pytest.mark.parametrize("name", list(TRAINER_MESHES))
def test_trainer_matches_jax(runs, name):
    jax_out, port, _, _ = runs
    check_trainer(jax_out[name], port[name][0]["history"], port[name][0]["params"])


@pytest.mark.slow
def test_composed_model_pipeline_data_mesh_matches_jax():
    """{model: 2, pipeline: 2, data: 2}: tests/test_parallel.py's
    tp+pipeline+dp case, against the JAX Trainer on the same mesh."""
    (name, axes), = COMPOSED.items()
    jt, init = _jax_trainer(axes)
    ours = run_world(8, [("trainer_run", dict(program=program(model(2)), mesh_axes=axes,
                                               state=_state(init, 2)))])[0][0]
    check_trainer((init, *_jax_run(jt)), ours["history"], ours["params"])


def test_microbatch_counts_train_alike(runs):
    _, port, _, _ = runs
    base = [h["loss"] for h in port["micro-1"][0]["history"]]
    for n_micro in (2, 4):
        got = [h["loss"] for h in port[f"micro-{n_micro}"][0]["history"]]
        np.testing.assert_allclose(got, base, rtol=1e-6)


def _field(state, name):
    """The first `name` tree in optax's (nested tuple) state."""
    if hasattr(state, name):
        return getattr(state, name)
    for node in state if isinstance(state, (list, tuple)) else ():
        found = _field(node, name)
        if found is not None:
            return found
    return None


def test_optimizer_moments_carry_across(runs):
    jax_out, _, _, _ = runs
    _, _, final, opt_state = jax_out["data2-pipeline2"]
    trainer = Trainer(program(model(2)), device="cpu")
    cfg = trainer.module.cfg
    trainer.load_state_dict(params_from_jax(final, cfg))
    named = dict(trainer.module.named_parameters())
    for p in named.values():
        p.grad = torch.zeros_like(p)
    trainer.optimizer.step()  # creates the moments; then overwritten
    layout = transformer_layout(final, cfg)
    opt_state_from_jax(opt_state, trainer.optimizer, named, layout)
    mu = _field(opt_state, "mu")["pipeline"]["stages"]["mlp"]["up_proj"]
    got = trainer.optimizer.state[named["pipeline.stages.mlp.up_proj.weight"]]["mu"]
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(mu["kernel"], -1, -2))
    trainer.close()


def test_pipelined_checkpoint_restores_on_one_process_and_on_a_mesh(runs):
    _, port, _, ckpt = runs
    saved = port["save"][0]
    assert saved["step"] == 2
    trainer = Trainer(program(model(2), resume=True), device="cpu", checkpoint_dir=ckpt)
    assert trainer.restore() == 2
    for k, v in trainer.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved["params"][k])
    single = trainer.run()
    resumed = port["resume-pipeline2"][0]
    assert resumed["step"] == single.state.step == STEPS
    np.testing.assert_allclose(resumed["history"][-1]["loss"], single.history[-1]["loss"],
                               rtol=2e-6)


@pytest.mark.parametrize("extra", [{"dropout_rate": 0.1}, {"n_experts": 2}],
                         ids=["dropout", "moe"])
def test_pipelined_config_refusals_match_jax(extra):
    with pytest.raises(ValueError) as ref:
        jax_make_config(model(2, **extra))
    with pytest.raises(ValueError) as ours:
        _make_config(model(2, **extra))
    assert str(ours.value) == str(ref.value)


def test_pipelined_forward_refusals_match_jax(runs):
    """Decode and per-row adapters refuse on a pipelined model in both
    packages, layers that do not split into the stages at build, and
    layers that do not split over the pipeline axis in the Trainer."""
    _no_mesh()
    bundle = jax_build_model("transformer_lm", model(2))
    tokens = jnp.asarray(TOKENS[:1], jnp.int32)
    with pytest.raises(ValueError, match="KV-cache decode"):
        bundle.module.init({"params": jax.random.PRNGKey(0)}, tokens, decode=True)
    module = Transformer(_make_config(model(2)), device="cpu")
    with pytest.raises(ValueError, match="KV-cache decode"):
        module(torch.from_numpy(TOKENS[:1]), cache=[], pos=0)
    slots = model(2, lora_rank=2, adapter_slots=2)
    jax_slots = jax_build_model("transformer_lm", slots)
    with pytest.raises(ValueError, match="adapter_ix"):
        jax_slots.module.init({"params": jax.random.PRNGKey(0)}, tokens,
                              adapter_ix=jnp.zeros((1,), jnp.int32))
    with pytest.raises(ValueError, match="adapter_ix"):
        Transformer(_make_config(slots), device="cpu")(
            torch.from_numpy(TOKENS[:1]), adapter_ix=[0])
    with pytest.raises(ValueError, match="not divisible by pipeline_stages"):
        jax_build_model("transformer_lm", model(3)).module.init(
            {"params": jax.random.PRNGKey(0)}, tokens)
    with pytest.raises(ValueError, match="not divisible by pipeline_stages"):
        Transformer(_make_config(model(3)), device="cpu")
    jax_out, port, _, _ = runs
    for prog, key in ((program(model(2, n_layers=2)), "layers-over-axis"),
                      (program(model(2)), "stages-over-axis")):
        with pytest.raises(ValueError) as ref:
            JaxTrainer(JaxProgram.from_dict(prog), mesh_axes={"pipeline": 4},
                       devices=jax.devices()[:4])
        for kind, msg in port[key]:
            assert kind == "ValueError"
            assert ("n_layers (2)" in msg) == ("n_layers (2)" in str(ref.value)), (msg, ref)
            assert ("pipeline axis size 4" in msg) == (
                "pipeline axis size 4" in str(ref.value)), (msg, ref)
