"""The analytic train-step FLOPs formula and MFU, counterparts of
`train_step_flops` and `mfu` in `polyaxon_tpu/telemetry/stats.py`, with the
peak of the one NVIDIA card the port runs on instead of TPU generations."""

from __future__ import annotations

from typing import Optional

# Dense bf16 tensor-core peak of the NVIDIA H100 SXM, FLOP/s: the data sheet
# figure (989 TFLOP/s at the full 700 W power limit). A card set below
# 700 W reaches less.
H100_PEAK_BF16_FLOPS = 989e12


def peak_bf16_flops(device_name: str) -> Optional[float]:
    """Peak bf16 FLOP/s for a `torch.cuda.get_device_name()` string; None if
    unknown (CPU, another card) — MFU is then unreportable, not 0."""
    return H100_PEAK_BF16_FLOPS if "h100" in device_name.lower() else None


def train_step_flops(
    n_params: int, n_layers: int, dim: int, seq_len: int, tokens: int
) -> float:
    """Analytic transformer train-step FLOPs for `tokens` tokens: 6 per
    parameter per token for the matmuls plus the 12*L*d*s attention term."""
    return float((6 * n_params + 12 * n_layers * dim * seq_len) * tokens)


def mfu(flops_per_sec: float, device_name: str) -> Optional[float]:
    """Model FLOPs utilization of one card against its peak bf16 rate; None
    when the peak is unknown."""
    peak = peak_bf16_flops(device_name)
    if not peak or flops_per_sec <= 0:
        return None
    return flops_per_sec / peak
