"""The port's Trainer on a device mesh for each zoo family against the JAX
package's Trainer on the same mesh, on the CPU.

Each family (the MLP, ResNet-18 at width 8, and ViT, BERT and seq2seq at
their `tiny-test` widths with 1 layer, as
`tests/test_torch_zoo_trainer.py` takes them) trains for 3 float32 steps
on {data: 2}, {fsdp: 2} and {model: 2}, and ResNet also on {data: 4},
from the JAX trainer's own initial parameters and `batch_stats`, carried
over by `params_from_jax`, against the family's JAX Trainer on {data: 2}
(the 8 virtual CPU devices of `tests/conftest.py`): GSPMD computes the
same function on every mesh, and one reference a family keeps the JAX
compiles within the suite's time. Each mesh's shardings are the
reference's rules resolved on that mesh. The port runs in one `gloo`
world of 2 ranks and one of 4 (`tests/torch_mesh_workers.py`). ResNet trains with `examples/resnet50.yaml`'s rule (SGD with
Nesterov momentum), the others with AdamW, as
`tests/test_torch_zoo_trainer.py` holds the single-device pairs.

Tolerances, `tests/test_torch_trainer_mesh.py`'s for the flagship on a
mesh: loss and grad_norm within 5e-5 relative per step, accuracy within
1e-6, the update each run made (final - initial) within 1e-3 relative
Frobenius, and BatchNorm's running statistics within 5e-5 of each
buffer's largest magnitude (the same on every rank). Each rank's local
shard of one parameter of each rule, after loading, equals the
addressable shard of the JAX array on the device whose id is that rank.
A checkpoint of ResNet on {fsdp: 2} restores on one process, running
statistics included.
"""

import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from polyaxon_tpu.models.registry import build_model as jax_build_model
from polyaxon_tpu.parallel.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu.parallel.sharding import param_shardings as jax_param_shardings
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu_torch.models import build_model
from polyaxon_tpu_torch.models.convert import params_from_jax, zoo_layout
from polyaxon_tpu_torch.runtime import Trainer
from torch_mesh_workers import run_world

STEPS = 3
ADAMW = {"name": "adamw", "learningRate": 3e-3,
         "schedule": {"name": "cosine", "warmup_steps": 1},
         "config": {"grad_clip_norm": 1.0}}
SGD = {"name": "sgd", "learningRate": 0.1, "config": {"momentum": 0.9, "nesterov": True},
       "schedule": {"name": "cosine", "warmup_steps": 1}}
IMAGES = {"name": "synthetic_imagenet", "batchSize": 4,
          "config": {"image_size": 32, "num_classes": 10}}


def program(model, data, optimizer=ADAMW):
    return {"model": model, "data": data, "optimizer": optimizer,
            "train": {"steps": STEPS, "logEvery": 1, "precision": "float32"}}


FAMILIES = {
    "mlp": program({"name": "mlp", "config": {"hidden": [64, 32]}},
                   {"name": "mnist", "batchSize": 8, "config": {"flat": False}}),
    "resnet": program({"name": "resnet", "config": {"depth": 18, "width": 8,
                                                   "num_classes": 10, "image_size": 32}},
                      IMAGES, SGD),
    "vit": program({"name": "vit", "config": {"preset": "tiny-test", "num_classes": 10,
                                               "n_layers": 1}}, IMAGES),
    "bert": program({"name": "bert", "config": {"preset": "tiny-test", "n_layers": 1}},
                    {"name": "synthetic_mlm", "batchSize": 4,
                     "config": {"seq_len": 64, "vocab_size": 1024}}),
    "seq2seq": program({"name": "seq2seq", "config": {"preset": "tiny-test", "n_layers": 1}},
                       {"name": "synthetic_seq2seq", "batchSize": 4,
                        "config": {"src_len": 32, "tgt_len": 32, "vocab_size": 1024}}),
}
CLASSIFIERS = {"mlp", "resnet", "vit"}
MESHES = {"data2": {"data": 2}, "fsdp2": {"fsdp": 2}, "model2": {"model": 2}}
CASES = {f"{fam}-{mesh}": (fam, axes) for fam in FAMILIES for mesh, axes in MESHES.items()}
CASES["resnet-data4"] = ("resnet", {"data": 4})
REFERENCE_MESH = {"data": 2}


def _world(axes):
    return int(np.prod(list(axes.values())))


def rule_params(family) -> list:
    """The first parameter each of the family's rules places."""
    bundle = build_model(FAMILIES[family]["model"]["name"],
                         FAMILIES[family]["model"]["config"], device="cpu")
    names = [n for n, _ in bundle.module.named_parameters()]
    out = []
    for pattern, _ in bundle.sharding_rules:
        hit = next(n for n in names if re.search(pattern, n))
        out.append(hit)
    return out


def _orient(a, how):
    if how is True:
        return a.T
    return np.transpose(a, how) if how else a


def _jax_family(fam):
    """The family's JAX Trainer on {data: 2}, with its initial params and
    extra state. GSPMD computes the same function on every mesh, so its
    numbers hold each of the port's meshes (within the f32 order of the
    ranks' sums)."""
    jt = JaxTrainer(JaxProgram.from_dict(FAMILIES[fam]), mesh_axes=REFERENCE_MESH,
                    devices=jax.devices()[:_world(REFERENCE_MESH)])
    return (jt, jax.tree.map(lambda a: np.array(a, copy=True), jt.state.params),
            jax.tree.map(lambda a: np.array(a, copy=True), jt.state.extra))


def _jax_run(jt):
    jr = jt.run()
    return (jr.history, jax.tree.map(np.asarray, jr.state.params),
            jax.tree.map(np.asarray, jr.state.extra))


def _jax_shards(name, init):
    """The rule parameters' shards by device id on the case's own mesh: the
    reference's shardings (its rules resolved on that mesh, no compile)
    placing the initial parameters."""
    fam, axes = CASES[name]
    rules = jax_build_model(FAMILIES[fam]["model"]["name"],
                            dict(FAMILIES[fam]["model"]["config"])).sharding_rules
    mesh = jax_build_mesh(axes, devices=jax.devices()[:_world(axes)])
    shardings = jax_param_shardings(init, rules, mesh)
    layout = zoo_layout(init)
    shards = {}
    for port_name in rule_params(fam):
        path, how = layout[port_name]
        leaf, sharding = init, shardings
        for key in path:
            leaf, sharding = leaf[key], sharding[key]
        arr = jax.device_put(leaf, sharding)
        shards[port_name] = {s.device.id: _orient(np.array(s.data, copy=True), how)
                             for s in arr.addressable_shards}
    return shards


def _state(params, extra):
    return {k: v.numpy() for k, v in params_from_jax(
        params, None, extra.get("batch_stats")).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name → (the JAX case, the port's results on every rank); the JAX
    references train beside the port's two worlds (processes)."""
    ckpt = str(tmp_path_factory.mktemp("zoo-mesh-ckpt"))
    trainers = {fam: _jax_family(fam) for fam in FAMILIES}
    by_world: dict = {2: [], 4: []}
    for name, (fam, axes) in CASES.items():
        _, init, extra = trainers[fam]
        by_world[_world(axes)].append((name, ("trainer_run", dict(
            program=FAMILIES[fam], mesh_axes=axes, state=_state(init, extra),
            shards=rule_params(fam)))))
    by_world[2].append(("save-resnet-fsdp2", ("trainer_run", dict(
        program={**FAMILIES["resnet"], "train": {**FAMILIES["resnet"]["train"], "steps": 2,
                                                  "checkpointEvery": 2}},
        mesh_axes={"fsdp": 2}, state=_state(*trainers["resnet"][1:]), checkpoint_dir=ckpt))))
    by_world[2].append(("context-bert", ("trainer_error", dict(
        program=FAMILIES["bert"], mesh_axes={"context": 2}))))
    with ThreadPoolExecutor(1) as pool:  # the worlds, one after the other
        worlds = pool.submit(lambda: {n: run_world(n, [case for _, case in work])
                                      for n, work in by_world.items()})
        ran = {fam: _jax_run(trainers[fam][0]) for fam in FAMILIES}
        per_world = worlds.result()
    port = {}
    for n, work in by_world.items():
        for i, (name, _) in enumerate(work):
            port[name] = [rank[i] for rank in per_world[n]]
    # name → (initial params, initial extra, shards, history, final
    # params, final extra)
    jax_out = {name: (*trainers[fam][1:], _jax_shards(name, trainers[fam][1]), *ran[fam])
               for name, (fam, _) in CASES.items()}
    return jax_out, port, ckpt


def _rows(history, key="loss"):
    return [h for h in history if key in h]


@pytest.mark.parametrize("name", list(CASES))
def test_step_metrics_match_jax(runs, name):
    jax_out, port, _ = runs
    ours, want = _rows(port[name][0]["history"]), _rows(jax_out[name][3])
    assert [h["step"] for h in ours] == [h["step"] for h in want] == list(range(1, STEPS + 1))
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5)
        if CASES[name][0] in CLASSIFIERS:
            np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_final_params_match_jax(runs, name):
    jax_out, port, _ = runs
    init, extra, _, _, final, final_extra = jax_out[name]
    start, want = _state(init, extra), _state(final, final_extra)
    ours = port[name][0]["params"]
    assert set(ours) <= set(want)
    num = sum(((ours[k] - want[k]) ** 2).sum() for k in ours)
    den = sum(((want[k] - start[k]) ** 2).sum() for k in ours)
    assert den > 0 and np.sqrt(num / den) < 1e-3
    for rank in port[name][1:]:  # every rank gathers the same parameters
        for k, v in rank["params"].items():
            np.testing.assert_array_equal(v, ours[k])


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("resnet")])
def test_batch_stats_match_jax_on_every_rank(runs, name):
    """The running statistics of the global batch: the reference's, and
    the same on every rank."""
    jax_out, port, _ = runs
    _, extra, _, _, _, final_extra = jax_out[name]
    start = _state({}, extra)
    want = _state({}, final_extra)
    ours = port[name][0]["buffers"]
    assert set(ours) == set(want)
    for k in want:
        assert not np.array_equal(want[k], start[k]), k
        assert np.abs(ours[k] - want[k]).max() / np.abs(want[k]).max() < 5e-5, k
    for rank in port[name][1:]:
        for k, v in rank["buffers"].items():
            np.testing.assert_array_equal(v, ours[k])


@pytest.mark.parametrize("name", list(CASES))
def test_rank_shards_equal_jax_addressable_shards(runs, name):
    jax_out, port, _ = runs
    shards = jax_out[name][2]
    assert shards
    for param, by_device in shards.items():
        for rank, result in enumerate(port[name]):
            np.testing.assert_array_equal(result["shards"][param], by_device[rank],
                                          err_msg=f"{param} on rank {rank}")


def test_zoo_checkpoint_restores_on_one_process(runs):
    """ResNet's checkpoint from {fsdp: 2} holds the full parameters and the
    running statistics once: one process restores both exactly."""
    _, port, ckpt = runs
    saved = port["save-resnet-fsdp2"][0]
    assert saved["step"] == 2
    prog = {**FAMILIES["resnet"], "train": {**FAMILIES["resnet"]["train"], "resume": True}}
    trainer = Trainer(prog, device="cpu", checkpoint_dir=ckpt)
    assert trainer.restore() == 2
    state = trainer.module.state_dict()
    for k, v in saved["params"].items():
        np.testing.assert_array_equal(state[k].numpy(), v)
    assert saved["buffers"] and set(saved["buffers"]) == {k for k in state if "running" in k}
    for k, v in saved["buffers"].items():
        np.testing.assert_array_equal(state[k].numpy(), v)


def test_zoo_context_axis_is_refused(runs):
    """A context axis over an encoder would split the sequence its
    attention reads whole: refused by name (ROADMAP.md) on every rank."""
    for err in runs[1]["context-bert"]:
        assert err[0] == "NotImplementedError"
        assert re.search(r"context axis over model 'bert'.*ROADMAP\.md", err[1]), err
