"""Device selection for the port's entry points.

Every entry point takes `device=` and defaults to the card. Asking for CUDA
where there is none raises: the port never carries on on the CPU unless the
caller asked for the CPU (as the tests do).

The CLI, the `Executor` and the serve children take their device from the
environment (`env_device`): `POLYAXON_TORCH_DEVICE`, unset meaning the
card, `cpu` the plain PyTorch path (the counterpart of the reference's
`POLYAXON_JAX_PLATFORM`).
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"
ENV_DEVICE = "POLYAXON_TORCH_DEVICE"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """`device` (str or torch.device) → torch.device; raises RuntimeError
    when CUDA is asked for and `torch.cuda.is_available()` is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def env_device() -> str:
    """The device named by `POLYAXON_TORCH_DEVICE` (unset or empty: the
    card). A name torch does not know raises here, once, rather than in
    each process that reads it."""
    name = os.environ.get(ENV_DEVICE, "").strip() or DEFAULT_DEVICE
    try:
        torch.device(name)
    except RuntimeError as e:
        raise ValueError(f"{ENV_DEVICE}={name!r} is not a torch device: {e}") from None
    return name


def visible_gpus() -> int:
    """The CUDA devices this process sees (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
