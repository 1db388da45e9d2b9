"""The PyTorch port's transformer against the JAX package's, on the CPU.

Both sides get the same weights: the JAX module's param tree is redrawn
from a numpy seed and carried into the port by `params_from_jax`. The
JAX flash backend runs its Pallas kernel in interpret mode, as the JAX
package's own tests run it; the port's flash backend runs its plain
version on CPU tensors. Logits agree within 1e-4 (f32 on both sides; the
difference is the order of f32 sums)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import build_model as jax_build_model
from polyaxon_tpu.models.transformer import _make_config as jax_make_config
from polyaxon_tpu_torch.models import build_model
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.models.transformer import Transformer, _make_config

SMALL = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256, seq_len=128)
LOGIT_TOL = 1e-4


def jax_lm(overrides=None, seed=0):
    """(JAX module, params as a nested numpy dict) at the small size, with
    every weight redrawn from `seed`: kernels N(0, 1/fan_in), LoRA B a
    tenth of that (so alpha/r does not blow the residual stream up), norm
    scales 1 + N(0, 0.01): no factor is a trivial zero or one."""
    bundle = jax_build_model("transformer_lm", {**SMALL, **(overrides or {})})
    params = bundle.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32), train=False
    )["params"]
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        if a.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        w = rng.standard_normal(a.shape) / np.sqrt(a.shape[0])
        if "lora_b" in jax.tree_util.keystr(path):
            w *= 0.1
        return w.astype(np.float32)

    return bundle.module, jax.tree_util.tree_map_with_path(redraw, params)


def torch_lm(jax_module, params_np, **overrides):
    """The port's Transformer on the CPU holding the same weights."""
    cfg = dataclasses.replace(
        _make_config(dataclasses.asdict(jax_module.cfg)), **overrides
    )
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params_np, cfg))
    return model.eval()


def tokens(B=2, S=64, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _both_logits(overrides, attention):
    module, params = jax_lm({**overrides, "attention": attention})
    toks = tokens()
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(toks), train=False))
    model = torch_lm(module, params)
    with torch.no_grad():
        out = model(torch.from_numpy(toks).long()).numpy()
    return out, ref


@pytest.mark.parametrize("attention", ["flash", "xla"])
def test_forward_matches_jax(attention):
    out, ref = _both_logits({}, attention)
    assert out.shape == ref.shape == (2, 64, 256)
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize(
    "overrides",
    [{"lora_rank": 4}, {"tie_embeddings": True},
     {"lora_rank": 2, "lora_targets": ("q_proj", "down_proj")}],
    ids=["lora", "tied", "lora-targets"],
)
def test_forward_variants_match_jax(overrides):
    out, ref = _both_logits(overrides, "flash")
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    if overrides.get("tie_embeddings"):
        assert out.dtype == np.float32


def test_features_match_jax():
    module, params = jax_lm({"attention": "xla"})
    toks = tokens(B=1, S=32)
    ref = module.apply(
        {"params": params}, jnp.asarray(toks), train=False, return_features=True
    )
    with torch.no_grad():
        out = torch_lm(module, params)(torch.from_numpy(toks).long(), return_features=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize(
    "config",
    [
        {"preset": "llama3-1b"},
        {"variant": "8B", "max_len": 4096},
        {"preset": "tiny", "lora": {"rank": 4, "alpha": 8, "targets": ["q_proj"]}},
        {"dim": 96, "n_heads": 3, "draft": None, "dropout_rate": 0.1},
    ],
)
def test_make_config_matches_jax(config):
    """Every field the port keeps equals the reference's, the training
    fields (dropout, fused loss), int8 `quant`, the draft model's overrides,
    the MoE capacity factor and the pipeline's stages and microbatches
    included."""
    ours = dataclasses.asdict(_make_config(config))
    ref = dataclasses.asdict(jax_make_config(config))
    assert ours == {name: ref[name] for name in ours}
    assert {"dropout_rate", "fused_lm_loss", "fused_loss_chunk", "quant", "draft"} <= set(ours)
    assert {"capacity_factor", "pipeline_stages", "pipeline_microbatches"} <= set(ours)


@pytest.mark.parametrize(
    "config",
    [{"draft": {"n_layers": 1, "dim": 48}},
     {"fused_lm_loss": True, "fused_loss_chunk": 100}],
    ids=["draft", "fused_lm_loss"],
)
def test_unported_config_keys_raise(config):
    """Both keys are ported now and carried as the reference carries them:
    the speculative draft model's overrides, normalized to a sorted
    (key, value) tuple, and the fused LM loss."""
    if "draft" in config:
        ours = _make_config({**SMALL, **config})
        ref = jax_make_config({**SMALL, **config})
        assert ours.draft == ref.draft == (("dim", 48), ("n_layers", 1))
        return
    ours = _make_config({**SMALL, **config})
    ref = jax_make_config({**SMALL, **config})
    assert (ours.fused_lm_loss, ours.fused_loss_chunk) == (True, 100)
    assert (ref.fused_lm_loss, ref.fused_loss_chunk) == (True, 100)


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        _make_config({"preset": "llama3-70b"})


@pytest.mark.parametrize(
    "field",
    [{"n_experts": 4}, {"pipeline_stages": 2}, {"quant": "int8"},
     {"adapter_slots": 2}, {"scan_layers": True}],
    ids=lambda f: next(iter(f)),
)
def test_unported_config_fields_raise(field):
    """Every field is ported now. int8 `quant` builds the int8 projections
    (and refuses an unknown kind), `adapter_slots` stacks each LoRA pair to
    [slots, ...], `n_experts` makes each block's FFN an MoE under `moe`
    (with int8, its attention projections int8 and its experts not),
    `pipeline_stages` stacks the blocks' weights to [stages, layers per
    stage, ...] under `pipeline.stages` (tests/test_torch_trainer_pipeline.py
    runs them) and `scan_layers` to [layers, ...] under `scan.block`
    (tests/test_torch_scan.py runs them)."""
    if "pipeline_stages" in field:
        model = Transformer(_make_config({**SMALL, **field}), device="cpu")
        q = model.pipeline.stages.attention.q_proj.weight
        assert len(model.layers) == 0 and q.shape[:2] == (2, SMALL["n_layers"] // 2)
        return
    if "n_experts" in field:
        from polyaxon_tpu_torch.models.moe import MoEFeedForward

        model = Transformer(_make_config({**SMALL, **field}), device="cpu")
        assert isinstance(model.layers[0].moe, MoEFeedForward)
        assert not hasattr(model.layers[0], "mlp")
        from polyaxon_tpu_torch.models.quant import Int8Linear

        q = Transformer(_make_config({**SMALL, **field, "quant": "int8"}), device="cpu")
        assert isinstance(q.layers[0].attention.o_proj, Int8Linear)
        assert q.layers[0].moe.gate_kernel.dtype == torch.float32
        return
    if "adapter_slots" in field:
        model = Transformer(_make_config({**SMALL, **field, "lora_rank": 4}), device="cpu")
        q = model.layers[0].attention.q_proj
        assert q.lora_a.shape == (2, SMALL["dim"], 4) and q.lora_b.shape[0] == 2
        return
    if "quant" in field:
        from polyaxon_tpu_torch.models.quant import Int8Linear

        model = Transformer(_make_config({**SMALL, **field}), device="cpu")
        assert isinstance(model.layers[0].attention.q_proj, Int8Linear)
        with pytest.raises(ValueError, match="quant"):
            Transformer(_make_config({**SMALL, "quant": "int4"}), device="cpu")
        return
    model = Transformer(_make_config({**SMALL, **field}), device="cpu")
    q = model.scan.block.attention.q_proj.weight
    assert len(model.layers) == 0 and q.shape == (SMALL["n_layers"], SMALL["dim"], SMALL["dim"])


@pytest.mark.parametrize(
    "kwargs,error",
    [({"pages": torch.zeros(1, 1)}, ValueError),
     ({"kv_layout": object()}, ValueError),
     ({"prefix_len": 4}, ValueError),
     ({"prefix_lens": torch.zeros(1)}, ValueError),
     ({"adapter_ix": torch.zeros(1)}, ValueError),
     ({"pos": torch.zeros(1, dtype=torch.long)}, ValueError)],
    ids=["pages", "kv_layout", "prefix_len", "prefix_lens", "adapter_ix", "per-row-pos"],
)
def test_unported_decode_arguments_raise(kwargs, error):
    """The decode arguments raise where they are misused: adapter_ix on a
    model without stacked adapter slots (as the reference does), and on the
    dense cache pages without the pool's layout (or a layout without
    pages), a shared prefix without the paged pool, per-row frontiers
    without pad widths."""
    model = Transformer(_make_config(SMALL), device="cpu")
    cache = model.make_cache(1)
    with pytest.raises(error):
        model(torch.zeros(1, 1, dtype=torch.long), cache=cache, **kwargs)


def test_pad_without_cache_raises():
    model = Transformer(_make_config(SMALL), device="cpu")
    with pytest.raises(ValueError, match="pad"):
        model(torch.zeros(1, 4, dtype=torch.long), pad=torch.zeros(1))


def test_seeded_init_is_deterministic():
    a = build_model("transformer_lm", SMALL, device="cpu", seed=3).module
    b = build_model("transformer_lm", SMALL, device="cpu", seed=3).module
    c = build_model("transformer_lm", SMALL, device="cpu", seed=4).module
    for (name, pa), pb, pc in zip(
        a.state_dict().items(), b.state_dict().values(), c.state_dict().values()
    ):
        assert torch.equal(pa, pb), name
        if name.endswith("weight"):
            assert not torch.equal(pa, pc), name
    assert set(a.state_dict()) == set(params_from_jax(jax_lm()[1], a.cfg))


def test_bf16_model_keeps_f32_norm_scales():
    model = build_model(
        "llama", {**SMALL, "hidden_dim": 128}, device="cpu", dtype=torch.bfloat16
    ).module
    assert model.cfg.dim == 64  # explicit fields win over the llama preset
    assert model.layers[0].attention.q_proj.weight.dtype == torch.bfloat16
    assert model.final_norm.scale.dtype == torch.float32
    with torch.no_grad():
        out = model(torch.zeros(1, 8, dtype=torch.long))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def _dropout_model(rate):
    cfg = dict(SMALL, dropout_rate=rate, attention="xla")
    return build_model("transformer_lm", cfg, device="cpu", seed=5).module


def test_dropout_rate_zero_is_no_dropout():
    model = _dropout_model(0.0)
    toks = torch.from_numpy(tokens()).long()
    with torch.no_grad():
        want = model.eval()(toks)
        got = model.train()(toks, dropout_generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, want)


def test_dropout_eval_mode_is_the_identity():
    """In eval mode dropout does nothing, so the output equals the same
    weights with dropout_rate 0 — and the reference's eval output."""
    module, params = jax_lm({"dropout_rate": 0.5, "attention": "xla"})
    toks = tokens()
    ref = module.apply({"params": params}, jnp.asarray(toks), train=False)
    model = torch_lm(module, params)
    assert model.cfg.dropout_rate == 0.5
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(toks).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_zeroes_rate_and_rescales_the_rest(rate):
    """flax's rule: keep with probability 1 - rate, scale kept elements by
    1 / (1 - rate). The zeroed share is within 5 sigma of `rate`."""
    from polyaxon_tpu_torch.models.transformer import dropout

    x = torch.full((64, 1024), 3.0)
    out = dropout(x, rate, torch.Generator().manual_seed(0))
    dropped = (out == 0).float().mean().item()
    sigma = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(dropped - rate) < 5 * sigma
    kept = out[out != 0]
    assert torch.equal(kept, torch.full_like(kept, 3.0) / (1 - rate))


def test_dropout_mask_follows_the_generator_seed():
    """The same seed (the trainer keys it by seed and step) gives the same
    mask; another seed another one; training mode differs from eval."""
    model = _dropout_model(0.3).train()
    toks = torch.from_numpy(tokens()).long()

    def run(seed):
        with torch.no_grad():
            return model(toks, dropout_generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    with torch.no_grad():
        assert not torch.equal(run(7), model.eval()(toks))
