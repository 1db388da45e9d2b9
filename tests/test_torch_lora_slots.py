"""Slot-stacked LoRA adapters (multi-tenant serving) in the port, held
against the JAX package on the CPU in f32.

- `LoRADense` and `Int8LoRALinear` with slots: each row gathers its own
  adapter by `adapter_ix`, as the JAX `LoRADense` does (fp and int8 bases,
  prefill and decode shapes), within 1e-5;
- with `slots == 0` both compute exactly the single-adapter formula they
  computed before slots existed (the training path), bit for bit;
- the int8 `project` keeps q/k/v in one grouped call with per-row slots,
  equal bit for bit to the members' separate calls;
- a slot-stacked tree (the reference's `stack_adapter_params`, after its
  `quantize_module` for the int8 base) loads through `params_from_jax`; the
  port's own stacking gives the same tensors; the forward and the decode
  paths with per-row slots give the JAX logits and greedy tokens;
- `synth_adapter` gives the reference's bytes for a seed, and an `.npz`
  adapter saved by either package loads in the other.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.kv_pages import PagedKVLayout as JLayout
from polyaxon_tpu.models.transformer import LoRADense as JLoRADense
from polyaxon_tpu.serving import adapters as jad
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
from polyaxon_tpu_torch.models.quant import Int8LoRALinear, project
from polyaxon_tpu_torch.models.spec_decode import spec_generate
from polyaxon_tpu_torch.models.transformer import LoRADense, Transformer, _make_config
from polyaxon_tpu_torch.ops.int8_matmul import int8_matmul_reference
from polyaxon_tpu_torch.serving import adapters as tad

from tests.test_torch_transformer import LOGIT_TOL, jax_lm

jgen = importlib.import_module("polyaxon_tpu.models.generate")
tgen = importlib.import_module("polyaxon_tpu_torch.models.generate")

SLOTS, IN, OUT, RANK, ALPHA = 3, 32, 48, 4, 8.0
TOL = 1e-5  # f32, sum order only
IX = np.array([2, 0, 1, 2])


def _factors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "kernel": (rng.standard_normal((IN, OUT)) / np.sqrt(IN)).astype(np.float32),
        "lora_a": rng.standard_normal((SLOTS, IN, RANK)).astype(np.float32) * 0.1,
        "lora_b": rng.standard_normal((SLOTS, RANK, OUT)).astype(np.float32) * 0.1,
    }


def _x(S, seed=1):
    return np.random.default_rng(seed).standard_normal((len(IX), S, IN)).astype(np.float32)


def _port_dense(p, slots=SLOTS):
    m = LoRADense(IN, OUT, RANK, ALPHA, slots=slots)
    m.load_state_dict({"weight": torch.from_numpy(p["kernel"].T.copy()),
                       "lora_a": torch.from_numpy(p["lora_a"]),
                       "lora_b": torch.from_numpy(p["lora_b"])})
    return m


def _port_int8(p, kernel, scale, slots=SLOTS):
    m = Int8LoRALinear(IN, OUT, RANK, ALPHA, slots=slots)
    m.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                       "scale": torch.from_numpy(scale),
                       "lora_a": torch.from_numpy(p["lora_a"]),
                       "lora_b": torch.from_numpy(p["lora_b"])})
    return m


def _int8_kernel(p):
    amax = np.abs(p["kernel"]).max(axis=0)
    scale = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
    return np.clip(np.round(p["kernel"] / scale), -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("S", [1, 7], ids=["decode", "prefill"])
@pytest.mark.parametrize("base", ["fp", "int8"])
def test_slotted_lora_matches_jax(S, base):
    p = _factors()
    x = _x(S)
    if base == "fp":
        jmod = JLoRADense(OUT, rank=RANK, alpha=ALPHA, slots=SLOTS)
        jp = p
        port = _port_dense(p)
    else:
        kernel, scale = _int8_kernel(p)
        jmod = JLoRADense(OUT, rank=RANK, alpha=ALPHA, quant="int8", slots=SLOTS)
        jp = {**p, "kernel": kernel, "scale": scale}
        port = _port_int8(p, kernel, scale)
    ref = jmod.apply({"params": jp}, jnp.asarray(x), jnp.asarray(IX))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(IX))
        # no adapter_ix: slot 0 for every row
        out0 = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    ref0 = jmod.apply({"params": jp}, jnp.asarray(x))
    np.testing.assert_allclose(out0.numpy(), np.asarray(ref0), atol=TOL, rtol=TOL)


def test_zero_slots_is_the_single_adapter_formula():
    """slots == 0 is the training path: exactly the expression the
    projections computed before slots existed."""
    p = _factors()
    single = {"kernel": p["kernel"], "lora_a": p["lora_a"][1], "lora_b": p["lora_b"][1]}
    x = torch.from_numpy(_x(5))
    a, b = torch.from_numpy(single["lora_a"]), torch.from_numpy(single["lora_b"])
    with torch.no_grad():
        dense = _port_dense(single, slots=0)
        want = torch.nn.functional.linear(x, dense.weight) + (ALPHA / RANK) * ((x @ a) @ b)
        assert torch.equal(dense(x), want)
        kernel, scale = _int8_kernel(single)
        q = _port_int8(single, kernel, scale, slots=0)
        want = int8_matmul_reference(x, q.weight, q.scale) + (ALPHA / RANK) * ((x @ a) @ b)
        assert torch.equal(q(x), want)


def test_grouped_project_with_slots_equals_separate_calls():
    ix = torch.from_numpy(IX)
    projs = []
    for seed in range(3):
        p = _factors(seed)
        kernel, scale = _int8_kernel(p)
        projs.append(_port_int8(p, kernel, scale))
    x = torch.from_numpy(_x(3))
    with torch.no_grad():
        grouped = project(x, tuple(projs), ix)
        separate = tuple(m(x, ix) for m in projs)
    assert all(torch.equal(g, s) for g, s in zip(grouped, separate))


# ------------------------------------------------------- the whole model
LORA = {"attention": "xla", "lora_rank": 4, "seq_len": 64}


def _stacked_pair(quant: bool):
    """(JAX module, JAX stacked params, port module from params_from_jax of
    the stacked tree, port module stacked by the port itself)."""
    module, params = jax_lm(LORA)
    cfg = _make_config(dataclasses.asdict(module.cfg))
    port = Transformer(cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, cfg))
    if quant:
        from polyaxon_tpu.models.quant import quantize_module as jquant
        from polyaxon_tpu_torch.models.quant import quantize_module

        module, params, _ = jquant(module, params)
        port, _ = quantize_module(port)
    jmodule, jparams = jad.stack_adapter_params(module, params, slots=SLOTS)
    jparams = jax.tree.map(np.asarray, jparams)
    own = tad.stack_adapter_params(port, slots=SLOTS)
    tmpl = tad.adapter_template(own)
    # the same synthetic adapter in slot 2 on every side
    adapter = jad.synth_adapter(jad.adapter_template(jparams), 3)
    for path, arr in adapter.items():
        node = jparams
        *head, leaf = path.split("/")
        for k in head:
            node = node[k]
        node[leaf] = node[leaf].copy()
        node[leaf][2] = arr
    scfg = dataclasses.replace(cfg, adapter_slots=SLOTS,
                               quant="int8" if quant else "none")
    loaded = Transformer(scfg, device="cpu")
    loaded.load_state_dict(params_from_jax(jparams, scfg))
    with torch.no_grad():
        for name, p in own.named_parameters():
            path = tad.ref_path(name)
            if path in tmpl:
                p[2].copy_(torch.from_numpy(adapter[path]))
    return jmodule, jparams, loaded.eval(), own.eval()


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_stacked_tree_loads_and_matches_jax(quant):
    jmodule, jparams, loaded, own = _stacked_pair(quant)
    for (name, a), (_, b) in zip(loaded.state_dict().items(), own.state_dict().items()):
        assert torch.equal(a, b), name
    toks = np.random.default_rng(2).integers(0, 256, (4, 12)).astype(np.int32)
    ix = np.array([0, 2, 1, 2])
    ref = jmodule.apply({"params": jparams}, jnp.asarray(toks), train=False,
                        adapter_ix=jnp.asarray(ix))
    ref0 = jmodule.apply({"params": jparams}, jnp.asarray(toks), train=False)
    with torch.no_grad():
        out = loaded(torch.from_numpy(toks).long(), adapter_ix=torch.from_numpy(ix))
        out0 = loaded(torch.from_numpy(toks).long())  # slot 0 for every row
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(out0.numpy(), np.asarray(ref0), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # dense decode with per-row slots: greedy tokens equal the JAX package's
    got = tgen.generate(loaded, torch.from_numpy(toks), max_new_tokens=6,
                        adapter_ix=torch.from_numpy(ix))
    want = jgen.generate(jmodule, jparams, jnp.asarray(toks), max_new_tokens=6,
                         adapter_ix=jnp.asarray(ix))
    assert got.tolist() == np.asarray(want).tolist()
    # the slot matters: slot 2 is not slot 0
    plain = tgen.generate(loaded, torch.from_numpy(toks), max_new_tokens=6)
    assert got.tolist() != plain.tolist()


def test_paged_and_speculative_decode_with_slots_match_jax():
    jmodule, jparams, model, _ = _stacked_pair(False)
    B, P, pt, new = 4, 12, 4, 6
    toks = np.random.default_rng(3).integers(0, 256, (B, P)).astype(np.int32)
    ix = np.array([2, 0, 2, 1])
    n_pages = -(-(P + new) // pt)
    tables = (1 + np.arange(B * n_pages)).reshape(B, n_pages)
    pads, seeds = np.zeros(B, np.int64), list(range(B))
    jl, tl = JLayout(pt, 64), PagedKVLayout(pt, 64)
    jcache = jgen.make_paged_cache(jmodule, jparams, jl)
    jcache, jfirst = jgen.paged_prefill(
        jmodule, jparams, jcache, jnp.asarray(toks), pad=jnp.asarray(pads, jnp.int32),
        pages=jnp.asarray(tables, jnp.int32), kv_layout=jl, prefix_len=0,
        temperature=0.0, top_k=None, seeds=jnp.asarray(seeds, jnp.int32),
        adapter_ix=jnp.asarray(ix))
    _, jtoks, _ = jgen.paged_decode_chunk(
        jmodule, jparams, jcache, jfirst, jnp.zeros(B, bool), steps=new - 1,
        pos=jnp.asarray(P, jnp.int32), start_g=jnp.asarray(1, jnp.int32),
        pad=jnp.asarray(pads, jnp.int32), pages=jnp.asarray(tables, jnp.int32),
        kv_layout=jl, prefix_len=0, temperature=0.0, top_k=None, eos_id=None,
        seeds=jnp.asarray(seeds, jnp.int32), adapter_ix=jnp.asarray(ix))
    cache = tgen.make_paged_cache(model, tl)
    first = tgen.paged_prefill(model, cache, toks, pad=pads, pages=tables, kv_layout=tl,
                               prefix_len=0, temperature=0.0, top_k=None, seeds=seeds,
                               adapter_ix=torch.from_numpy(ix))
    rest, _ = tgen.paged_decode_chunk(
        model, cache, first, torch.zeros(B, dtype=torch.bool), steps=new - 1, pos=P,
        start_g=1, pad=pads, pages=tables, kv_layout=tl, prefix_len=0, temperature=0.0,
        top_k=None, eos_id=None, seeds=seeds, adapter_ix=torch.from_numpy(ix))
    assert first.tolist() == np.asarray(jfirst).tolist()
    assert rest.tolist() == np.asarray(jtoks).tolist()
    dense = tgen.generate(model, torch.from_numpy(toks), max_new_tokens=new,
                          adapter_ix=torch.from_numpy(ix))
    assert dense[:, P:].tolist() == [[f] + r for f, r in zip(first.tolist(), rest.tolist())]
    spec = spec_generate(model, toks, max_new_tokens=new, draft_tokens=3,
                         adapter_ix=torch.from_numpy(ix))
    assert spec.tolist() == dense.tolist()


# ------------------------------------------------------------ adapter files
TEMPLATES = {
    "f32": {"layer_0/attention/q_proj/lora_a": ((8, 2), "float32"),
            "layer_0/attention/q_proj/lora_b": ((2, 8), "float32")},
    "bf16": {"layer_0/mlp/up_proj/lora_a": ((16, 4), "bfloat16"),
             "layer_1/mlp/up_proj/lora_b": ((4, 16), "bfloat16")},
}


def _jax_template(tmpl):
    return {k: (shape, np.dtype(dt)) for k, (shape, dt) in tmpl.items()}


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("kind", list(TEMPLATES))
def test_synth_adapter_bytes_equal_the_reference(kind):
    tmpl = TEMPLATES[kind]
    for seed in (1, 2, 77):
        ours = tad.synth_adapter(tmpl, seed)
        ref = jad.synth_adapter(_jax_template(tmpl), seed)
        for path in tmpl:
            assert ours[path].dtype == getattr(torch, tmpl[path][1])
            assert _bits(ours[path]).tobytes() == ref[path].tobytes(), (kind, seed, path)


def test_npz_adapters_load_in_both_packages(tmp_path):
    f32 = TEMPLATES["f32"]
    # port → reference, reference → port (f32)
    ours = tad.synth_adapter(f32, 5)
    tad.save_adapter(tmp_path / "port.npz", ours)
    back = jad.load_adapter(str(tmp_path / "port.npz"), _jax_template(f32))
    jad.save_adapter(tmp_path / "ref.npz", jad.synth_adapter(_jax_template(f32), 6))
    mine = tad.load_adapter(str(tmp_path / "ref.npz"), f32)
    want = jad.synth_adapter(_jax_template(f32), 6)
    for path in f32:
        np.testing.assert_array_equal(back[path], ours[path].numpy())
        np.testing.assert_array_equal(mine[path].numpy(), want[path])
    # bf16: the reference's file (numpy stores its bf16 as 2-byte records)
    # reads bit for bit here, and the port writes the same records
    bf = TEMPLATES["bf16"]
    ref = jad.synth_adapter(_jax_template(bf), 8)
    jad.save_adapter(tmp_path / "ref16.npz", ref)
    mine = tad.load_adapter(str(tmp_path / "ref16.npz"), bf)
    tad.save_adapter(tmp_path / "port16.npz", mine)
    again = tad.load_adapter(str(tmp_path / "port16.npz"), bf)
    with np.load(tmp_path / "ref16.npz") as a, np.load(tmp_path / "port16.npz") as b:
        for path in bf:
            assert _bits(mine[path]).tobytes() == ref[path].tobytes()
            assert torch.equal(again[path], mine[path])
            assert a[path].dtype == b[path].dtype and a[path].tobytes() == b[path].tobytes()
    with pytest.raises(ValueError, match="shape"):
        tad.save_adapter(tmp_path / "bad.npz", {p: np.zeros((3, 3), np.float32) for p in f32})
        tad.load_adapter(str(tmp_path / "bad.npz"), f32)
