"""Model registry: model name → builder (counterpart of
`polyaxon_tpu/models/registry.py`)."""

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
      `return_features=True` and the [B, S, V] logits never exist.
    """

    name: str
    module: nn.Module
    loss: str = "softmax_cross_entropy"
    task: str = "classification"
    trainable_patterns: tuple = ()
    fused_loss: Optional[Callable] = None


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


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
    )


@register("llama")
def build_llama(config: dict, **kw) -> ModelBundle:
    if "preset" not in config and "variant" not in config:
        config["preset"] = "llama3-8b"
    return dataclasses.replace(build_transformer(config, **kw), name="llama")
