"""Models: the flagship transformer LM, its registry, weight import from the
JAX package, and dense-KV-cache generation."""

from .registry import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
