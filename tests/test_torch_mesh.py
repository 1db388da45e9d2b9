"""The port's mesh and sharding rules against the JAX package's, on the
CPU.

- `resolve_axis_sizes` and the rank layout (`mesh_ranks`, and the
  `DeviceMesh` a trainer builds) equal the reference's sizes and
  `Mesh.devices` ids, the hybrid `slices` layouts included: a rank plays
  the JAX device of the same id;
- the eight optimizer rules (with clipping) on parameters and states
  sharded over {fsdp: 2, model: 2} (strided splits included) take the
  same steps as on full tensors in one process, within 1e-6 relative
  (lamb's norms and adafactor's means reduce in another order);
- the vocab-parallel losses (`masked_lm`, the fused LM head and
  `accuracy`, the vocabulary split over `model`, the batch over `data`):
  the ranks' shares add up to the one-process values over the global
  token count, and the gradients assembled from the shards equal the
  one-process ones, within 1e-6 relative;
- `runtime/health.py::check_slice` all-reduces over the world and refuses
  a world short of the devices expected;
- on three meshes, for the tiny flagship and its LoRA variant, every
  parameter's spec equals the reference's `PartitionSpec` (the port's
  `nn.Linear` weights are the transposes of flax's kernels, so their two
  entries swap), and each rank's local shard after loading the same
  parameters (`params_from_jax` of the reference's tree, filled from a
  numpy seed) equals, exactly, the addressable shard of
  the JAX array on the device whose id is that rank. The port's side runs
  in one `gloo` world of 4 ranks (`tests/torch_mesh_workers.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

from polyaxon_tpu.models.registry import build_model as jax_build_model
from polyaxon_tpu.parallel.mesh import build_mesh as jax_build_mesh
from polyaxon_tpu.parallel.mesh import resolve_axis_sizes as jax_resolve
from polyaxon_tpu.parallel.sharding import param_shardings as jax_param_shardings
from polyaxon_tpu.runtime.trainer import make_param_init
from polyaxon_tpu_torch.models.convert import params_from_jax, transformer_layout
from polyaxon_tpu_torch.models.transformer import _make_config
from polyaxon_tpu_torch.parallel.mesh import mesh_ranks, resolve_axis_sizes
from torch_mesh_workers import run_world

WORLD = 4


@pytest.mark.parametrize("spec,n", [
    (None, 8), ({"data": -1}, 8), ({"data": 2, "model": -1}, 8),
    ({"model": 2, "fsdp": 2, "data": 2}, 8), ({"context": 4, "data": -1}, 4),
    ({"model": 3}, 8), ({"data": -1, "model": 3}, 8),
])
def test_resolve_axis_sizes_matches_jax(spec, n):
    try:
        want = jax_resolve(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError, match="mesh"):
            resolve_axis_sizes(spec, n)
        assert "mesh" in str(e)
        return
    got = resolve_axis_sizes(spec, n)
    assert got == want and list(got) == list(want)


@pytest.mark.parametrize("spec,slices", [
    ({"data": 8}, 1), ({"data": 2, "fsdp": 2, "model": 2}, 1),
    ({"data": 2, "context": 2, "model": 2}, 1), ({"pipeline": 2, "data": 4}, 1),
    ({"data": 4, "model": 2}, 2), ({"data": 8}, 4), ({"pipeline": 2, "data": 4}, 2),
    ({"data": 2, "fsdp": 2, "model": 2}, 2),
])
def test_rank_layout_matches_jax_devices(spec, slices):
    mesh = jax_build_mesh(spec, devices=jax.devices(), slices=slices)
    want = np.vectorize(lambda d: d.id)(mesh.devices)
    sizes = resolve_axis_sizes(spec, 8)
    assert tuple(sizes) == mesh.axis_names
    np.testing.assert_array_equal(mesh_ranks(sizes, slices), want)


@pytest.mark.parametrize("spec,slices", [({"model": 8}, 2), ({"data": 2, "model": 4}, 4)])
def test_hybrid_layout_refusals_match_jax(spec, slices):
    with pytest.raises(ValueError, match="data"):
        jax_build_mesh(spec, devices=jax.devices(), slices=slices)
    with pytest.raises(ValueError, match="data"):
        mesh_ranks(resolve_axis_sizes(spec, 8), slices)


MODEL = dict(dim=64, n_layers=1, n_heads=4, n_kv_heads=2, vocab_size=128, seq_len=16)
MODELS = {"tiny": MODEL,
          "lora": dict(MODEL, lora={"rank": 4, "alpha": 8.0,
                                    "targets": ["q_proj", "k_proj", "o_proj", "down_proj"]})}
MESHES = {"fsdp2-model2": ({"fsdp": 2, "model": 2}, 1),
          "data2-model2-slices2": ({"data": 2, "model": 2}, 2),
          "fsdp4": ({"fsdp": 4}, 1)}


def _program(model):
    return {"model": {"name": "transformer_lm", "config": model},
            "data": {"name": "synthetic_lm", "batchSize": 4,
                     "config": {"seq_len": 16, "vocab_size": 128}},
            "train": {"steps": 1, "precision": "float32"}}


@functools.cache
def jax_params(model_name):
    """The reference's parameter tree for the model (shapes by
    `jax.eval_shape` of its init, no compile), filled from a numpy seed."""
    bundle = jax_build_model("transformer_lm", MODELS[model_name])
    init_fn = make_param_init(bundle, jnp.float32, bundle.example_inputs(1))
    abstract, _ = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(model_name))
    return bundle, jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), abstract)


OPTIMIZERS = {
    "adamw": {"weight_decay": 0.1, "grad_clip_norm": 1.0}, "adam": {"nesterov": True},
    "sgd": {"momentum": 0.9}, "lamb": {"weight_decay": 0.01}, "lion": {},
    "adafactor": {"min_dim_size_to_factor": 8, "momentum": 0.9}, "rmsprop": {"centered": True},
    "adagrad": {},
}


@functools.cache
def port_layouts():
    work = []
    for model_name in MODELS:
        _, params = jax_params(model_name)
        state = {k: v.numpy() for k, v in params_from_jax(
            params, _make_config(MODELS[model_name])).items()}
        for axes, slices in MESHES.values():
            work.append(("param_layout", dict(program=_program(MODELS[model_name]),
                                              mesh_axes=axes, state=state, slices=slices)))
    for name, config in OPTIMIZERS.items():
        work.append(("optimizer_steps", dict(name=name, config=config,
                                             mesh_axes={"fsdp": 2, "model": 2})))
    work.append(("vocab_parallel_losses", dict(**LOSS_INPUTS, mesh_axes={"data": 2, "model": 2})))
    work += [("health", {}), ("health", {"expected_devices": 8})]
    per_rank = run_world(WORLD, work)
    keys = ([(m, name) for m in MODELS for name in MESHES] + list(OPTIMIZERS)
            + ["losses", "health", "health-short"])
    return {key: [rank[i] for rank in per_rank] for i, key in enumerate(keys)}


_rng = np.random.default_rng(11)
LOSS_INPUTS = {
    "logits": _rng.standard_normal((4, 6, 32), dtype=np.float32) * 3,
    "features": _rng.standard_normal((4, 6, 8), dtype=np.float32),
    "kernel": _rng.standard_normal((8, 32), dtype=np.float32),
    "labels": np.where(_rng.random((4, 6)) < 0.3, -100,
                       _rng.integers(0, 32, (4, 6))).astype(np.int64),
}


def test_check_slice_all_reduces_over_the_world():
    layouts = port_layouts()
    for ok, short in zip(layouts["health"], layouts["health-short"]):
        assert ok["devices"] == WORLD and ok["all_reduce_ok"] and ok["platform"] == "cpu"
        assert short == f"SliceHealthError: expected 8 devices, found {WORLD}"


def test_vocab_parallel_losses_add_up_to_the_global_mean():
    import torch

    from polyaxon_tpu_torch.ops.losses import accuracy, fused_linear_masked_lm, masked_lm

    lg, ft, ker = (torch.from_numpy(LOSS_INPUTS[k]).requires_grad_()
                   for k in ("logits", "features", "kernel"))
    lab = torch.from_numpy(LOSS_INPUTS["labels"])
    loss = masked_lm(lg, {"labels": lab})
    fused = fused_linear_masked_lm(ft, ker, lab, chunk_size=7)
    (loss + fused).backward()
    acc = accuracy(lg.detach(), {"labels": lab})
    ranks = port_layouts()["losses"]
    for r, got in enumerate(ranks):  # (data, model) = divmod(rank, 2)
        np.testing.assert_allclose(got[:3], [loss.item(), fused.item(), acc.item()], rtol=1e-6)
    d_lg = np.concatenate([np.concatenate([ranks[2 * d + m][3] for m in range(2)], -1)
                           for d in range(2)], 0)
    d_ft = np.concatenate([ranks[2 * d][4] for d in range(2)], 0)
    d_ker = np.concatenate([ranks[m][5] + ranks[2 + m][5] for m in range(2)], -1)
    for got, want in ((d_lg, lg.grad), (d_ft, ft.grad), (d_ker, ker.grad)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_rules_on_sharded_parameters(name):
    from torch_mesh_workers import optimizer_steps

    want = optimizer_steps(name, OPTIMIZERS[name])
    for got in port_layouts()[name]:  # every rank gathers the same
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _jax_side(model_name, mesh_name):
    bundle, params = jax_params(model_name)
    axes, slices = MESHES[mesh_name]
    mesh = jax_build_mesh(axes, devices=jax.devices()[:WORLD], slices=slices)
    shardings = jax_param_shardings(params, bundle.sharding_rules, mesh)
    layout = transformer_layout(params, _make_config(MODELS[model_name]))
    return mesh, params, shardings, layout


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("model_name", list(MODELS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_match_jax_partition_specs(model_name, mesh_name):
    mesh, _, shardings, layout = _jax_side(model_name, mesh_name)
    ours = port_layouts()[(model_name, mesh_name)]
    np.testing.assert_array_equal(ours[0]["ranks"], np.vectorize(lambda d: d.id)(mesh.devices))
    specs = ours[0]["specs"]
    assert set(specs) == set(layout)
    sharded = 0
    for name, (path, transposed) in layout.items():
        want = tuple(_at(shardings, path).spec)
        got = specs[name]
        if transposed:  # [out, in] against flax's [in, out]
            got = tuple(reversed(got + (None,) * (2 - len(got))))
        while got and got[-1] is None:
            got = got[:-1]
        while want and want[-1] is None:
            want = want[:-1]
        assert got == want, (name, got, want)
        sharded += bool(want)
    assert sharded >= 5


@pytest.mark.parametrize("model_name", list(MODELS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rank_shards_equal_jax_addressable_shards(model_name, mesh_name):
    _, params, shardings, layout = _jax_side(model_name, mesh_name)
    ours = port_layouts()[(model_name, mesh_name)]
    for name, (path, transposed) in layout.items():
        arr = jax.device_put(_at(params, path), _at(shardings, path))
        assert isinstance(_at(shardings, path), NamedSharding)
        by_device = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
        for rank in range(WORLD):
            got = ours[rank]["shards"][name]
            np.testing.assert_array_equal(got.T if transposed else got, by_device[rank],
                                          err_msg=f"{name} on rank {rank}")
