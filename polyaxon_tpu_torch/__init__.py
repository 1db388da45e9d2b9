"""PyTorch / CUDA port of polyaxon_tpu, held against the JAX package.

The JAX package `polyaxon_tpu/` is the reference; this package imports
nothing of it (nor of JAX). Module names mirror the reference so each
counterpart is easy to find:

- `ops/flash_attention.py`: flash attention with its gradient, hand-written
  Hopper kernels (`ops/csrc/flash_fwd.cu`, `ops/csrc/flash_bwd.cu`) on
  CUDA tensors, the plain PyTorch versions on CPU tensors;
- `ops/attention.py`: the attention backend dispatch;
- `ops/losses.py`, `ops/optimizers.py`: the loss registry with the fused
  LM-head loss, and optax's optimizers and schedules;
- `models/transformer.py`, `models/convert.py`, `models/generate.py`,
  `models/registry.py`: the flagship LM and its dense-KV-cache decode;
- `data/` (with `native/`), `schemas/`, `telemetry/stats.py`: the token
  streams and file corpora, the run spec (`program:`, `serving:`,
  `observability:`) and the throughput formulas the trainer reads;
- `store/`, `settings.py`: the run store (event log, timelines) that
  training writes and `ModelServer.from_run` serves from;
- `runtime/trainer.py`: `Trainer`, single-GPU training of a program;
  `runtime/checkpoint.py` its checkpoints (two tiers, quarantine),
  `runtime/preemption.py` SIGTERM as a preemption notice;
- `telemetry/registry.py`, `telemetry/spans.py`, `tracking/monitors.py`,
  `chaos/`, `retry.py`: the trainer's metrics, spans, device memory gauges,
  fault injection and failure classes (own copies of stdlib modules of the
  reference);
- `serving/`: `ModelServer` (batched, paged and step decode, int8,
  speculation, tenants, `from_run`), the router and the replica set.

- `polyaxonfile/` (with its own YAML reader), `compiler/`,
  `runtime/executor.py`, `client/` and `cli/`: a Polyaxonfile on disk to a
  run on the card, as `python -m polyaxon_tpu_torch check|run|ops|serve`.

Entry points run on the card (`device="cuda"`) unless told otherwise; the
CLI reads `POLYAXON_TORCH_DEVICE` (`cpu` for the plain path).
"""

from .device import DEFAULT_DEVICE, ENV_DEVICE, env_device, resolve_device

__all__ = ["DEFAULT_DEVICE", "ENV_DEVICE", "env_device", "resolve_device"]
__version__ = "0.1.0"
