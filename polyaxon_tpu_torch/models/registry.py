"""Model registry: model name → builder (counterpart of
`polyaxon_tpu/models/registry.py`): the flagship `transformer_lm`/`llama`
and the zoo — `mlp`, `resnet`/`resnet50`, `vit`, `bert` and `seq2seq`.
Each builder reads the reference's config keys, with its defaults and
presets, and ignores the keys the reference ignores."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

_REGISTRY: dict[str, Callable[..., "ModelBundle"]] = {}


@dataclasses.dataclass
class ModelBundle:
    """A built model and what the trainer needs to drive it generically.

    - `loss`: default loss name (ops/losses.py) if the train spec picks none;
    - `task`: "classification" | "mlm" | "lm" — selects the batch schema;
    - `trainable_patterns`: if non-empty, only parameters whose name (the
      module's `named_parameters` path) matches one of these regexes are
      trained; the rest are frozen (zero updates, no weight decay);
    - `fused_loss`: optional fused head + loss, (params, features, batch)
      → scalar, where `params` maps parameter names to the tensors the
      forward used; the trainer then runs the module with
      `return_features=True` and the [B, S, V] logits never exist;
    - `rngs`: the random streams the forward draws from; "dropout" (dropout
      and MoE router noise) makes the trainer hand the module a seeded
      `dropout_generator`;
    - `mutable`: the collections a training step updates besides the
      parameters, by the reference's names: "batch_stats" is BatchNorm's
      running statistics, held as buffers and updated from what the step's
      forward collects (`layers.collecting`);
    - `aux_losses`: the forward sows auxiliary losses (the MoE balance
      loss), which the trainer adds to the training loss;
    - `input_shape`: one example's input, the shape `example_inputs` gives
      the reference (flat or NHWC images, token ids).
    """

    name: str
    module: nn.Module
    loss: str = "softmax_cross_entropy"
    task: str = "classification"
    trainable_patterns: tuple = ()
    fused_loss: Optional[Callable] = None
    rngs: tuple = ("dropout",)
    mutable: tuple = ()
    aux_losses: bool = False
    input_shape: tuple = ()


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def registered_models() -> list[str]:
    return sorted(_REGISTRY)


def build_model(
    name: str,
    config: Optional[dict] = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
) -> ModelBundle:
    """Build `name` from its Polyaxonfile config dict on `device` with
    seeded random weights of `dtype`."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](dict(config or {}), device=device, dtype=dtype, seed=seed)


@register("transformer_lm")
def build_transformer(config: dict, **kw) -> ModelBundle:
    from .transformer import Transformer, _make_config

    cfg = _make_config(config)
    fused = None
    if cfg.fused_lm_loss:
        from ..ops.losses import fused_linear_masked_lm

        def fused(params, features, batch):
            # the reference's [dim, vocab] kernel orientation
            name = "embed.weight" if cfg.tie_embeddings else "lm_head.weight"
            return fused_linear_masked_lm(
                features, params[name].T, batch["labels"],
                chunk_size=cfg.fused_loss_chunk,
            )

    return ModelBundle(
        "transformer_lm",
        Transformer(cfg, **kw),
        loss="masked_lm",
        task="lm",
        trainable_patterns=(r"lora_[ab]$",) if cfg.lora_rank > 0 else (),
        fused_loss=fused,
        aux_losses=cfg.n_experts > 0,
        input_shape=(cfg.seq_len,),
    )


@register("llama")
def build_llama(config: dict, **kw) -> ModelBundle:
    if "preset" not in config and "variant" not in config:
        config["preset"] = "llama3-8b"
    return dataclasses.replace(build_transformer(config, **kw), name="llama")


def _preset(family: str, presets: dict, default: str, config: dict) -> dict:
    """The preset's fields updated by the config's (None values dropped, as
    the reference's seq2seq drops them; the other builders see none)."""
    preset = config.pop("preset", None)
    if preset is not None and preset not in presets:
        raise ValueError(f"unknown {family} preset {preset!r}; known: {sorted(presets)}")
    base = dict(presets.get(preset, presets[default]))
    base.update({k: v for k, v in config.items() if v is not None})
    return base


@register("mlp")
def build_mlp(config: dict, **kw) -> ModelBundle:
    from .mlp import MLP

    input_dim = int(config.pop("input_dim", 784))
    module = MLP(
        input_dim=input_dim,
        hidden=tuple(config.get("hidden", (512, 256))),
        num_classes=int(config.get("num_classes", 10)),
        dropout_rate=float(config.get("dropout_rate", 0.0)),
        **kw,
    )
    return ModelBundle("mlp", module, input_shape=(input_dim,))


@register("vit")
def build_vit(config: dict, **kw) -> ModelBundle:
    from .vit import PRESETS, ViT

    variant = config.pop("variant", None)
    if variant is not None:  # Polyaxonfile alias: "S/16" → preset vit-s16
        config.setdefault("preset", "vit-" + str(variant).replace("/", "").lower())
    base = _preset("ViT", PRESETS, "vit-s16", config)
    module = ViT(
        dim=int(base.get("dim", 384)),
        n_layers=int(base.get("n_layers", 12)),
        n_heads=int(base.get("n_heads", 6)),
        patch=int(base.get("patch", 16)),
        image_size=int(base.get("image_size", 224)),
        num_classes=int(base.get("num_classes", 1000)),
        mlp_ratio=int(base.get("mlp_ratio", 4)),
        dropout_rate=float(base.get("dropout_rate", 0.0)),
        attention=str(base.get("attention", "xla")),
        **kw,
    )
    size = module.image_size
    return ModelBundle("vit", module, input_shape=(size, size, 3))


@register("bert")
def build_bert(config: dict, **kw) -> ModelBundle:
    """The reference's BERT reads only these keys: a Polyaxonfile's
    `num_layers`, `hidden_dim`, `num_heads`, `mlp_dim` and `max_len` are
    ignored there, so `examples/bert.yaml` builds the `bert-base` preset."""
    from .bert import PRESETS, Bert

    base = _preset("BERT", PRESETS, "bert-base", config)
    module = Bert(
        vocab_size=int(base.get("vocab_size", 30522)),
        dim=int(base.get("dim", 768)),
        n_layers=int(base.get("n_layers", 12)),
        n_heads=int(base.get("n_heads", 12)),
        seq_len=int(base.get("seq_len", 512)),
        mlp_ratio=int(base.get("mlp_ratio", 4)),
        dropout_rate=float(base.get("dropout_rate", 0.0)),
        attention=str(base.get("attention", "xla")),
        **kw,
    )
    return ModelBundle("bert", module, loss="masked_lm", task="mlm",
                       input_shape=(module.seq_len,))


@register("seq2seq")
def build_seq2seq(config: dict, **kw) -> ModelBundle:
    from .seq2seq import PRESETS, Seq2Seq

    base = _preset("seq2seq", PRESETS, "small", config)
    module = Seq2Seq(
        vocab_size=int(base.get("vocab_size", 32128)),
        dim=int(base.get("dim", 512)),
        n_layers=int(base.get("n_layers", 6)),
        n_heads=int(base.get("n_heads", 8)),
        src_len=int(base.get("src_len", 512)),
        tgt_len=int(base.get("tgt_len", 512)),
        mlp_ratio=int(base.get("mlp_ratio", 4)),
        dropout_rate=float(base.get("dropout_rate", 0.0)),
        attention=str(base.get("attention", "xla")),
        **kw,
    )
    return ModelBundle("seq2seq", module, loss="masked_lm", task="mlm",
                       input_shape=(module.src_len + module.tgt_len,))


@register("resnet")
def build_resnet(config: dict, **kw) -> ModelBundle:
    from .resnet import STAGE_SIZES, ResNet

    depth = int(config.get("depth", 50))
    if depth not in STAGE_SIZES:
        raise ValueError(f"resnet depth {depth} not in {sorted(STAGE_SIZES)}")
    module = ResNet(
        depth=depth,
        num_classes=int(config.get("num_classes", 1000)),
        width=int(config.get("width", 64)),
        **kw,
    )
    size = int(config.get("image_size", 224))
    return ModelBundle("resnet", module, input_shape=(size, size, 3), rngs=(),
                       mutable=("batch_stats",))


@register("resnet50")
def build_resnet50(config: dict, **kw) -> ModelBundle:
    return build_resnet(dict(config, depth=50), **kw)
