"""`scan_layers: true` in the port against the JAX package's `nn.scan`
stack, on the CPU in f32.

- A scanned JAX `Transformer`'s params (`layers/block/...`, kernels
  [L, in, out]) load with `params_from_jax` into the port's `scan.block`
  ([L, out, in]): logits within 1e-4 (the transformer tests' tolerance)
  and greedy `generate` of a left-padded batch token for token. The
  scanned module equals the unscanned one holding the same weights
  (`stack_layers`) bit for bit, its int8 payloads are the reference's
  (per layer and column) and its layer-truncated draft slices the stack.
- A scanned MoE (`n_experts: 4`): logits within 1e-4, the aux loss summed
  over the layers within 1e-6 relative, gradients within 1e-4 relative
  Frobenius, as `tests/test_torch_moe.py` holds the unscanned one.
- The Trainer: the JAX Trainer's scanned run against the port's from the
  same initial params, under `tests/test_torch_trainer.py`'s float32
  tolerances (loss and grad_norm 5e-5 relative per step, the update 1e-3
  relative Frobenius), on one device and on `{fsdp: 2}` (a `gloo` world
  of 2 ranks; the same function, so it is held against the same JAX run,
  as `tests/test_torch_trainer_mesh.py` holds a mesh within the same
  tolerances). Adafactor's
  factored state of the stacked kernels carries across
  (`opt_state_from_jax`): two more updates on each side agree within 1e-6.
- A scanned run's checkpoint resumes and serves through
  `ModelServer.from_run`.
- Adapter slots on a scanned LoRA model: the reference's template and
  synthetic bytes, and two tenants through one slot give the unscanned
  model's rows."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.models.generate import generate as jax_generate
from polyaxon_tpu.ops import optimizers as jax_opt
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu_torch.models.convert import (
    opt_state_from_jax, params_from_jax, transformer_layout)
from polyaxon_tpu_torch.models.draft import build_draft
from polyaxon_tpu_torch.models.generate import generate
from polyaxon_tpu_torch.models.layers import collecting
from polyaxon_tpu_torch.models.quant import quantize_module
from polyaxon_tpu_torch.models.transformer import stack_layers
from polyaxon_tpu_torch.ops import optimizers as opt
from polyaxon_tpu_torch.runtime import Trainer
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.store import RunStore
from tests.test_torch_transformer import LOGIT_TOL, jax_lm, tokens, torch_lm
from tests.torch_mesh_workers import run_world

SCAN = {"attention": "xla", "scan_layers": True}  # dim 64, 2 layers, 4/2 heads


@pytest.fixture(scope="module")
def scanned():
    module, params = jax_lm(SCAN)
    return module, params, torch_lm(module, params)


def test_scanned_jax_checkpoint_loads_and_matches(scanned):
    module, params, model = scanned
    assert set(params) == {"embed", "layers", "final_norm", "lm_head"}
    q = model.scan.block.attention.q_proj.weight
    np.testing.assert_array_equal(
        q.detach().numpy(), np.swapaxes(params["layers"]["block"]["attention"]["q_proj"]
                                        ["kernel"], 1, 2))
    toks = tokens()
    want = np.asarray(module.apply({"params": params}, jnp.asarray(toks), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    prompt = tokens(B=3, S=10, seed=4)
    lengths = np.array([10, 4, 7], np.int32)
    for b, n in enumerate(lengths):
        prompt[b, : 10 - n] = 0
    ref = jax_generate(module, params, jnp.asarray(prompt), max_new_tokens=8,
                       prompt_lengths=lengths)
    out = generate(model, torch.from_numpy(prompt), max_new_tokens=8, prompt_lengths=lengths)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _unscanned(model):
    """The unscanned module holding `model`'s weights (its layers unstacked)."""
    import dataclasses

    from polyaxon_tpu_torch.models.transformer import Transformer

    flat = Transformer(dataclasses.replace(model.cfg, scan_layers=False), device="cpu")
    state = {k: v for k, v in model.state_dict().items() if not k.startswith("scan.")}
    for name, t in model.state_dict().items():
        if name.startswith("scan.block."):
            for i in range(t.shape[0]):
                state[f"layers.{i}.{name[len('scan.block.'):]}"] = t[i]
    flat.load_state_dict(state)
    return flat.eval()


def test_scanned_equals_unscanned_and_quantizes_per_layer(scanned):
    from polyaxon_tpu.models.quant import quantize_params as jax_quantize

    module, params, model = scanned
    flat = _unscanned(model)
    assert len(flat.layers) == 2 and not hasattr(flat, "scan")
    stacked = stack_layers(flat.state_dict(), 2)
    assert set(stacked) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(stacked[name], t), name
    toks = torch.from_numpy(tokens(S=32)).long()
    with torch.no_grad():
        assert torch.equal(model(toks), flat(toks))
    assert torch.equal(generate(model, toks[:, :9], max_new_tokens=6),
                       generate(flat, toks[:, :9], max_new_tokens=6))
    # int8 per (layer, column): the reference's payloads and scales
    q, _ = quantize_module(model)
    jq, _ = jax_quantize(jax.tree.map(np.asarray, params))
    want = params_from_jax(jax.tree.map(np.asarray, jq), q.cfg)
    for name, t in q.state_dict().items():
        assert torch.equal(t, want[name].to(t.dtype)), name
    assert q.scan.block.attention.q_proj.scale.shape == (2, 64)
    # a draft by layer truncation holds the stack's first layer, shared
    draft, derived = build_draft(model)
    assert derived and draft.cfg.n_layers == 1
    w = draft.scan.block.attention.q_proj.weight
    assert w.shape[0] == 1 and w.data_ptr() == model.scan.block.attention.q_proj.weight.data_ptr()


def test_scanned_moe_aux_loss_and_grads_match_jax():
    module, params = jax_lm({**SCAN, "dim": 32, "n_experts": 4})
    model = torch_lm(module, params)
    toks = tokens(S=32)

    def loss(p):
        logits, sown = module.apply({"params": p}, jnp.asarray(toks), train=True,
                                    mutable=["losses"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(sown))
        return (logits ** 2).mean() + aux, (logits, aux)

    (_, (logits, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model.train()
    with collecting() as box:
        ours = model(torch.from_numpy(toks).long())
    ours_aux = box.aux_loss("cpu")
    ((ours ** 2).mean() + ours_aux).backward()
    assert len(box.losses) == 2  # one a layer, summed as the stacked [L] losses are
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(logits), atol=1e-4, rtol=1e-4)
    assert float(ours_aux.detach()) == pytest.approx(float(aux), rel=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, grads), model.cfg)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want) and "scan.block.moe.gate_kernel" in got
    num = sum(((got[k] - want[k]) ** 2).sum() for k in want)
    den = sum((want[k] ** 2).sum() for k in want)
    assert (num / den).sqrt() < 1e-4


def test_adafactor_state_of_stacked_kernels_carries_across(scanned):
    """optax's factored v_row/v_col of the [L, in, out] kernels land in the
    port's [L, out, in] state (every 2-D factor turned) and the next two
    updates agree."""
    module, params, model = scanned
    config = {"min_dim_size_to_factor": 8, "momentum": 0.9}
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
                          params) for _ in range(4)]
    tx, _ = jax_opt.build_optimizer("adafactor", 0.05, config, None, total_steps=4)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    for i, g in enumerate(grads):
        if i == 2:
            mid_params, mid_state = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, state)
        updates, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
    model.load_state_dict(params_from_jax(mid_params, model.cfg))
    named = dict(model.named_parameters())
    optimizer, _ = opt.build_optimizer(named, "adafactor", 0.05, config, total_steps=4)
    opt_state_from_jax(mid_state, optimizer, named, transformer_layout(mid_params, model.cfg))
    for g in grads[2:]:
        for name, t in params_from_jax(g, model.cfg).items():
            named[name].grad = t
        optimizer.step()
    want = params_from_jax(jax.tree.map(np.asarray, jp), model.cfg)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    model.load_state_dict(params_from_jax(params, model.cfg))  # as the fixture made it


# ------------------------------------------------------------- the Trainer
STEPS = 3
MODEL = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256, seq_len=64,
             scan_layers=True)


def program(train=None):
    return {
        "model": {"name": "transformer_lm", "config": dict(MODEL)},
        "data": {"name": "synthetic_text", "batchSize": 2,
                 "config": {"seq_len": 64, "vocab_size": 256}},
        "optimizer": {"name": "adamw", "learningRate": 3e-3,
                      "schedule": {"name": "cosine", "warmup_steps": 1},
                      "config": {"grad_clip_norm": 1.0}},
        "train": {"steps": STEPS, "logEvery": 1, "precision": "float32", **(train or {})},
    }


@functools.cache
def runs():
    """mesh name → (JAX initial params, JAX history, JAX final params, the
    port's history, the port's final params as numpy): the port's fsdp
    world trains beside the JAX trainer and the port's one-device run."""
    with ThreadPoolExecutor(1) as pool:
        jt = JaxTrainer(JaxProgram.from_dict(program()), devices=jax.devices()[:1])
        init = jax.tree.map(np.asarray, jt.state.params)
        state = {k: v.numpy() for k, v in params_from_jax(init, _scan_cfg()).items()}
        world = pool.submit(run_world, 2, [("trainer_run", dict(
            program=program(), mesh_axes={"fsdp": 2}, state=state))])
        jr = jt.run()
        ref = (init, jr.history, jax.tree.map(np.asarray, jr.state.params))
        trainer = Trainer(program(), device="cpu")
        trainer.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        one = trainer.run().history
        final_one = {k: v.detach().numpy().copy() for k, v in trainer.module.state_dict().items()}
        fsdp = world.result()[0][0]
    return {"one": (*ref, one, final_one), "fsdp2": (*ref, fsdp["history"], fsdp["params"])}


def _scan_cfg():
    from polyaxon_tpu_torch.models.transformer import _make_config

    return _make_config(dict(MODEL))


@pytest.mark.parametrize("mesh", ["one", "fsdp2"])
def test_scanned_trainer_matches_the_jax_scanned_trainer(mesh):
    init, ref, final, ours, got = runs()[mesh]
    ours = [h for h in ours if "loss" in h]
    want = [h for h in ref if "loss" in h]
    assert [h["step"] for h in ours] == [h["step"] for h in want] == list(range(1, STEPS + 1))
    for a, b in zip(ours, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5)
        np.testing.assert_allclose(a["learning_rate"], b["learning_rate"], rtol=1e-6, atol=1e-12)
    cfg = _scan_cfg()
    start, want_p = params_from_jax(init, cfg), params_from_jax(final, cfg)
    assert set(got) == set(want_p)
    num = sum(((torch.from_numpy(got[k]) - want_p[k]) ** 2).sum() for k in want_p)
    den = sum(((want_p[k] - start[k]) ** 2).sum() for k in want_p)
    assert den > 0 and (num / den).sqrt().item() < 1e-3


def test_scanned_run_resumes_and_serves_from_run(tmp_path):
    store = RunStore(tmp_path)
    uid = "5ca11ed0" + "0" * 24
    spec = {"component": {"run": {"kind": "jaxjob", "program": program(
        {"checkpointEvery": 2, "steps": 2})}}}
    store.create_run(uid, "scan", "default", spec)
    ckpt = str(store.outputs_dir(uid) / "checkpoints")
    trainer = Trainer(program({"checkpointEvery": 2, "steps": 2}), device="cpu",
                      checkpoint_dir=ckpt)
    trainer.run()
    trainer.close()
    saved = {k: v.clone() for k, v in trainer.module.state_dict().items()}
    again = Trainer(program({"checkpointEvery": 2, "steps": 3, "resume": True}),
                    device="cpu", checkpoint_dir=ckpt)
    again.restore()
    assert again.step == 2
    for k, v in again.module.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert [h["step"] for h in again.run().history if "loss" in h] == [3]
    again.close()
    server = ModelServer.from_run(uid[:8], store=store, config_overrides={
        "kv_pool_pages": 32, "kv_page_tokens": 8, "chunked_prefill": True,
        "prefill_chunk_tokens": 8}, device="cpu")
    assert server.module.cfg.scan_layers and server.step == 3  # the resumed run's last
    body = {"tokens": [tokens(B=1, S=11, seed=6)[0].tolist()], "maxNewTokens": 5}
    model = again.module.eval()
    direct = ModelServer(model, None, ServingConfig(**server.config.__dict__), device="cpu")
    assert server.generate(body)["tokens"] == direct.generate(body)["tokens"]
    flat = _unscanned(model)
    assert server.generate(body)["tokens"] == generate(
        flat, torch.tensor(body["tokens"]), max_new_tokens=5).tolist()


def test_scanned_tenants_equal_the_unscanned_server(tmp_path):
    """Adapter slots on a scanned LoRA model: the slot axis at ndim-3
    ([L, slots, ...], the reference's layout), the adapter template the
    reference's (`layers/block/...` paths, [L, in, r] leaves, the same
    synthetic bytes by seed), and two adapters through one slot give the
    rows of the unscanned model holding the same weights and adapters."""
    from polyaxon_tpu.serving import adapters as jax_adapters
    from polyaxon_tpu_torch.serving import adapters
    from polyaxon_tpu_torch.serving.tenancy import normalize_adapters, normalize_tenants

    module, params = jax_lm({**SCAN, "lora_rank": 4})
    model = torch_lm(module, params)
    flat = _unscanned(model)
    stacked = adapters.stack_adapter_params(model, slots=2)
    assert stacked.scan.block.attention.q_proj.lora_a.shape == (2, 2, 64, 4)
    template = adapters.adapter_template(stacked)
    _, jparams = jax_adapters.stack_adapter_params(module, params, slots=2)
    jtemplate = jax_adapters.adapter_template(jparams)
    assert {k: v[0] for k, v in template.items()} == {k: v[0] for k, v in jtemplate.items()}
    for path, value in jax_adapters.synth_adapter(jtemplate, 3).items():
        np.testing.assert_array_equal(adapters.synth_adapter(template, 3)[path].numpy(), value)
    flat_template = adapters.adapter_template(adapters.stack_adapter_params(flat, slots=2))
    files = {}
    for name, seed in (("acme", 1), ("globex", 2)):
        one = adapters.synth_adapter(flat_template, seed)
        files[name] = {"flat": str(tmp_path / f"{name}-flat.npz"),
                       "scan": str(tmp_path / f"{name}-scan.npz")}
        adapters.save_adapter(files[name]["flat"], one)
        adapters.save_adapter(files[name]["scan"], {
            path: torch.stack([one[path.replace("layers/block", f"layer_{i}")]
                               for i in range(2)])
            for path in template})
    bodies = [{"tokens": [tokens(B=1, S=12, seed=7)[0].tolist()], "maxNewTokens": 5,
               "tenant": t} for t in ("acme", "globex", "acme")]
    rows = {}
    for layout, m in (("scan", model), ("flat", flat)):
        config = ServingConfig(
            max_batch=4, max_wait_ms=5.0, kv_pool_pages=32, kv_page_tokens=8,
            adapters=normalize_adapters({n: f[layout] for n, f in files.items()}),
            adapter_slots=1,
            tenants=normalize_tenants([{"name": n, "adapter": n} for n in files]))
        server = ModelServer(m, None, config, device="cpu")
        rows[layout] = [server.generate(b)["tokens"] for b in bodies]
        assert server.stats()["tenancy"]["adapters"]["evictions"] >= 2
    assert rows["scan"] == rows["flat"] and rows["scan"][0] != rows["scan"][1]
