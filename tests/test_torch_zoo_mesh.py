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

BERT, seq2seq and the MLP also train on {context: 2}, each against its
JAX Trainer on {context: 2}, which shards the token sequence over
`context` (its positions those of the global sequence): the port's
encoders run their self-attention on the ring, seq2seq gathers its
encoder's memory for cross-attention, and the MLP's batch stays whole on
both ranks. BERT with dropout trains on {context: 2} as the port does on
one process: each rank's mask is its rows of the whole sequence's. So do
the flagship on {data: 2}, {fsdp: 2} and {context: 2}, BERT and the MLP
on {data: 2}, at dropout 0.3 (each rank's mask its block of the global
batch's and sequence's), the two ranks of {data: 2} given the same rows
draw different masks, and the MoE router's noise on {data: 2} and
{fsdp: 2} is each rank's rows of one process's. The
gather (`parallel.collectives.gather_seq`) is held on a 2-rank world of
its own: its forward concatenates the ranks' chunks, its backward sums
the cotangents of each rank's slice (a reduce-scatter).
"""

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import build_model as jax_build_model
from polyaxon_tpu.parallel.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu.parallel.sharding import param_shardings as jax_param_shardings
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu_torch.models import build_model
from polyaxon_tpu_torch.models.convert import params_from_jax, zoo_layout
from polyaxon_tpu_torch.runtime import Trainer
from torch_mesh_workers import MOE_NOISE_SHAPE, REPO, free_port, run_world

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
CONTEXT_MESH = {"context": 2}
CONTEXT_FAMILIES = ("mlp", "bert", "seq2seq")
CASES.update({f"{fam}-context2": (fam, CONTEXT_MESH) for fam in CONTEXT_FAMILIES})
# BERT with dropout on {context: 2}, against the port on one process
DROPOUT_BERT = {**FAMILIES["bert"], "model": {"name": "bert", "config": {
    **FAMILIES["bert"]["model"]["config"], "dropout_rate": 0.3}}}
# dropout 0.3 on every batch axis and `context`, each against the port on
# one process from the same weights: family -> program
DROPOUT = {
    "bert": DROPOUT_BERT,
    "mlp": {**FAMILIES["mlp"], "model": {"name": "mlp", "config": {
        **FAMILIES["mlp"]["model"]["config"], "dropout_rate": 0.3}}},
    "lm": program({"name": "transformer_lm", "config": dict(
        dim=64, n_layers=1, n_heads=4, n_kv_heads=2, vocab_size=256, seq_len=64,
        dropout_rate=0.3)},
        {"name": "synthetic_text", "batchSize": 4, "config": {"seq_len": 64, "vocab_size": 256}}),
}
# name -> (family, mesh)
DROPOUT_CASES = {
    "dropout-bert-context2": ("bert", CONTEXT_MESH),
    "dropout-bert-data2": ("bert", {"data": 2}),
    "dropout-mlp-data2": ("mlp", {"data": 2}),
    "dropout-lm-data2": ("lm", {"data": 2}),
    "dropout-lm-context2": ("lm", CONTEXT_MESH),
    "dropout-lm-fsdp2": ("lm", {"fsdp": 2}),
}
# the MoE router's noise on each batch axis: a module on 4 rows of 8
# tokens, its weights from a seed
MOE_NOISE_MESHES = {"data2": {"data": 2}, "fsdp2": {"fsdp": 2}}
MOE_INPUTS = np.random.default_rng(4).normal(size=(4, 8, MOE_NOISE_SHAPE[0])).astype(np.float32)


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


def _reference(name):
    """The JAX Trainer a case is held against, (family, mesh name): the
    family's on {context: 2} for a context case, else on {data: 2}."""
    fam, axes = CASES[name]
    return fam, "context2" if "context" in axes else "data2"


def _jax_family(fam, axes):
    """The family's JAX Trainer on `axes`, with its initial params and
    extra state. GSPMD computes the same function on every mesh, so the
    {data: 2} numbers hold each of the port's batch and model meshes
    (within the f32 order of the ranks' sums)."""
    jt = JaxTrainer(JaxProgram.from_dict(FAMILIES[fam]), mesh_axes=axes,
                    devices=jax.devices()[:_world(axes)])
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


def _one_process(program, state):
    """`program`'s history on the port's Trainer in this process, from
    `state`."""
    one = Trainer(program, device="cpu")
    one.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return one.run().history


# the MLP's mask probe: both ranks of {data: 2} get these rows
MASK_INPUTS = np.random.default_rng(3).normal(size=(4, 28, 28, 1)).astype(np.float32)
MASK_SEED = 11


def _one_forward(program, state, inputs):
    """The training-mode output of `program`'s forward on one process, on
    `inputs`, with the dropout seed `MASK_SEED`."""
    one = Trainer(program, device="cpu")
    one.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    one.module.train()
    with torch.no_grad():
        out, _, _ = one._apply(one._compute_params(), torch.from_numpy(inputs), MASK_SEED)
    return out.numpy().copy()


def _moe_noise_state():
    from polyaxon_tpu_torch.models.moe import MoEFeedForward

    rng = np.random.default_rng(6)
    moe = MoEFeedForward(*MOE_NOISE_SHAPE)
    return {k: (0.3 * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in moe.state_dict().items()}


def _moe_noise_one(state, inputs):
    """The noisy MoE's training-mode output on one process, all rows."""
    from polyaxon_tpu_torch.models.moe import MoEFeedForward

    moe = MoEFeedForward(*MOE_NOISE_SHAPE, router_noise=1.0)
    moe.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    moe.train()
    with torch.no_grad():
        return moe(torch.from_numpy(inputs), torch.Generator().manual_seed(MASK_SEED)).numpy()


def _state(params, extra):
    return {k: v.numpy() for k, v in params_from_jax(
        params, None, extra.get("batch_stats")).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name → (the JAX case, the port's results on every rank); the JAX
    references train beside the port's two worlds (processes). Every case
    starts from its family's {data: 2} initial state (the seed's, on any
    mesh), so the {context: 2} references are built once the worlds run."""
    ckpt = str(tmp_path_factory.mktemp("zoo-mesh-ckpt"))
    trainers = {(fam, "data2"): _jax_family(fam, REFERENCE_MESH) for fam in FAMILIES}

    def trainer(name):
        return trainers[_reference(name)]

    by_world: dict = {2: [], 4: []}
    for name, (fam, axes) in CASES.items():
        _, init, extra = trainers[fam, "data2"]
        by_world[_world(axes)].append((name, ("trainer_run", dict(
            program=FAMILIES[fam], mesh_axes=axes, state=_state(init, extra),
            shards=rule_params(fam)))))
    by_world[2].append(("save-resnet-fsdp2", ("trainer_run", dict(
        program={**FAMILIES["resnet"], "train": {**FAMILIES["resnet"]["train"], "steps": 2,
                                                  "checkpointEvery": 2}},
        mesh_axes={"fsdp": 2}, state=_state(*trainer("resnet-fsdp2")[1:]),
        checkpoint_dir=ckpt))))
    states = {fam: _state(*trainers[fam, "data2"][1:]) for fam in ("bert", "mlp")}
    states["lm"] = {k: v.numpy() for k, v in build_model(
        "transformer_lm", DROPOUT["lm"]["model"]["config"], device="cpu",
        seed=0).module.state_dict().items()}
    for name, (fam, axes) in DROPOUT_CASES.items():
        by_world[2].append((name, ("trainer_run", dict(
            program=DROPOUT[fam], mesh_axes=axes, state=states[fam]))))
    by_world[2].append(("dropout-masks-mlp-data2", ("dropout_forward", dict(
        program=DROPOUT["mlp"], mesh_axes={"data": 2}, state=states["mlp"],
        inputs=MASK_INPUTS, seed=MASK_SEED))))
    moe_state = _moe_noise_state()
    for mesh, axes in MOE_NOISE_MESHES.items():
        by_world[2].append((f"moe-noise-{mesh}", ("moe_noise_forward", dict(
            mesh_axes=axes, state=moe_state, inputs=MOE_INPUTS, seed=MASK_SEED))))
    with ThreadPoolExecutor(1) as pool:  # the worlds, one after the other
        worlds = pool.submit(lambda: {n: run_world(n, [case for _, case in work])
                                      for n, work in by_world.items()})
        one = {f"dropout-{fam}-one": pool.submit(_one_process, DROPOUT[fam], states[fam])
               for fam in DROPOUT}
        one["dropout-masks-one"] = pool.submit(_one_forward, DROPOUT["mlp"], states["mlp"],
                                               np.concatenate([MASK_INPUTS] * 2))
        trainers.update({(fam, "context2"): _jax_family(fam, CONTEXT_MESH)
                         for fam in CONTEXT_FAMILIES})
        ran = {key: _jax_run(t[0]) for key, t in trainers.items()}
        per_world = worlds.result()
    port = {name: f.result() for name, f in one.items()}
    port["moe-noise-one"] = _moe_noise_one(moe_state, MOE_INPUTS)
    for n, work in by_world.items():
        for i, (name, _) in enumerate(work):
            port[name] = [rank[i] for rank in per_world[n]]
    # name → (initial params, initial extra, shards, history, final
    # params, final extra)
    jax_out = {name: (*trainer(name)[1:], _jax_shards(name, trainer(name)[1]),
                      *ran[_reference(name)]) for name in CASES}
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
    """A context axis over the zoo trains: BERT, seq2seq and the MLP on
    {context: 2} give every rank the JAX Trainer's numbers on {context:
    2}, whose encoders see the sequence sharded over `context`."""
    jax_out, port, _ = runs
    for fam in CONTEXT_FAMILIES:
        name = f"{fam}-context2"
        # the reference started where the port did: the {data: 2} state
        for ours, started in ((jax_out[name][0], jax_out[f"{fam}-data2"][0]),
                              (jax_out[name][1], jax_out[f"{fam}-data2"][1])):
            assert jax.tree.all(jax.tree.map(np.array_equal, ours, started)), name
        want = _rows(jax_out[name][3])
        assert len(port[name]) == 2
        for rank in port[name]:
            ours = _rows(rank["history"])
            assert [h["step"] for h in ours] == list(range(1, STEPS + 1)), name
            for a, b in zip(ours, want):
                np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5, err_msg=name)
                np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5,
                                           err_msg=name)


def test_context_dropout_masks_are_one_devices(runs):
    """BERT with dropout 0.3 on {context: 2} trains as the port does on
    one process from the same weights: each rank's mask is its rows of
    the whole sequence's (chunks drawing one mask alike would not)."""
    jax_out, port, _ = runs
    want = _rows(port["dropout-bert-one"])
    plain = _rows(jax_out["bert-context2"][3])
    assert abs(want[0]["loss"] - plain[0]["loss"]) > 1e-3  # the dropout is live
    for rank in port["dropout-bert-context2"]:
        ours = _rows(rank["history"])
        assert len(ours) == len(want) == STEPS
        for a, b in zip(ours, want):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5)


@pytest.mark.parametrize("name", [n for n in DROPOUT_CASES if n != "dropout-bert-context2"])
def test_dropout_masks_are_one_devices(runs, name):
    """With dropout 0.3 on {data: 2} (the flagship, BERT, the MLP),
    {fsdp: 2} and {context: 2} (the flagship), every rank trains as the port does on
    one process from the same weights: each rank's mask is its block of
    the mask drawn at the global batch and sequence."""
    _, port, _ = runs
    fam, _ = DROPOUT_CASES[name]
    want = _rows(port[f"dropout-{fam}-one"])
    assert len(want) == STEPS
    for rank in port[name]:
        ours = _rows(rank["history"])
        assert len(ours) == len(want)
        for a, b in zip(ours, want):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5, err_msg=name)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5,
                                       err_msg=name)


def test_data_ranks_draw_different_masks(runs):
    """Both ranks of {data: 2} forward the same rows with one seed: their
    masks differ (each is its rows of the global batch's mask), and side
    by side they are one process's forward of both ranks' rows."""
    _, port, _ = runs
    r0, r1 = port["dropout-masks-mlp-data2"]
    assert r0.shape == r1.shape == (len(MASK_INPUTS), 10)
    assert not np.allclose(r0, r1)
    np.testing.assert_allclose(np.concatenate([r0, r1]), port["dropout-masks-one"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh", list(MOE_NOISE_MESHES))
def test_moe_router_noise_is_one_devices(runs, mesh):
    """The MoE router's noise on {data: 2} and {fsdp: 2}: each rank's is
    its rows of the noise drawn for the global batch, so the ranks' outputs
    side by side are one process's on all the rows."""
    _, port, _ = runs
    ranks = port[f"moe-noise-{mesh}"]
    np.testing.assert_allclose(np.concatenate(ranks), port["moe-noise-one"],
                               rtol=1e-5, atol=1e-6)


_GATHER_RANK = """
import json, os, sys, torch, torch.distributed as dist
from polyaxon_tpu_torch.parallel.collectives import gather_seq
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", rank=rank, world_size=2)
g = dist.new_group([0, 1])
x = (torch.arange(2 * 3 * 4, dtype=torch.float64).reshape(2, 3, 4) + 100 * rank)
x.requires_grad_(True)
y = gather_seq(x, g, 1)
w = torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape) * (rank + 1)
(y * w).sum().backward()
print(json.dumps({"y": y.tolist(), "grad": x.grad.tolist()}))
dist.destroy_process_group()
"""


def test_gather_seq_forward_and_reduce_scatter_backward():
    """Rank r's chunk x_r: every rank gets [x_0 | x_1] along dim 1, and
    the gradient of sum_r <y, w_r> with respect to x_r is the sum over
    ranks of w_r's slice r."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _GATHER_RANK], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    xs = [np.arange(24, dtype=np.float64).reshape(2, 3, 4) + 100 * r for r in range(2)]
    full = np.concatenate(xs, axis=1)
    w = np.arange(full.size, dtype=np.float64).reshape(full.shape)
    for r in range(2):
        np.testing.assert_array_equal(np.array(got[r]["y"]), full)
        want = sum((k + 1) * w for k in range(2))[:, 3 * r: 3 * (r + 1)]
        np.testing.assert_array_equal(np.array(got[r]["grad"]), want)
