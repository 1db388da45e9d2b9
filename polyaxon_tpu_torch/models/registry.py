"""Model registry: model name → builder (counterpart of
`polyaxon_tpu/models/registry.py`, inference part only)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

_REGISTRY: dict[str, Callable[..., "ModelBundle"]] = {}


@dataclasses.dataclass
class ModelBundle:
    """A built model: its registered name and the module."""

    name: str
    module: nn.Module


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

    return ModelBundle("transformer_lm", Transformer(_make_config(config), **kw))


@register("llama")
def build_llama(config: dict, **kw) -> ModelBundle:
    if "preset" not in config and "variant" not in config:
        config["preset"] = "llama3-8b"
    return dataclasses.replace(build_transformer(config, **kw), name="llama")
