"""Device selection for the port's entry points.

Every entry point takes `device=` and defaults to the card. Asking for CUDA
where there is none raises: the port never carries on on the CPU unless the
caller asked for the CPU (as the tests do).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


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
