"""PyTorch / CUDA port of polyaxon_tpu, held against the JAX package.

The JAX package `polyaxon_tpu/` is the reference; this package imports
nothing of it (nor of JAX). Module names mirror the reference so each
counterpart is easy to find:

- `ops/flash_attention.py`: flash-attention forward, a hand-written
  Hopper kernel (`ops/csrc/flash_fwd.cu`) on CUDA tensors, the plain
  PyTorch version on CPU tensors;
- `ops/attention.py`: the attention backend dispatch;
- `models/transformer.py`, `models/convert.py`, `models/generate.py`,
  `models/registry.py`: the flagship LM and its dense-KV-cache decode;
- `serving/server.py`: `ModelServer`, the per-request `/generate` path.

Entry points run on the card (`device="cuda"`) unless told otherwise.
"""

from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
