"""The analytic train-step FLOPs formula and MFU, and the exact sample
quantiles, counterparts of `train_step_flops`, `mfu`, `quantile` and
`summarize` in `polyaxon_tpu/telemetry/stats.py`, with the
peak of the one NVIDIA card the port runs on instead of TPU generations."""

from __future__ import annotations

from typing import Optional, Sequence

# Dense bf16 tensor-core peak of the NVIDIA H100 SXM, FLOP/s: the data sheet
# figure (989 TFLOP/s at the full 700 W power limit). A card set below
# 700 W reaches less.
H100_PEAK_BF16_FLOPS = 989e12


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """Exact sample quantile with linear interpolation between order
    statistics (numpy's default, type 7), q in [0, 1]; None on empty
    input."""
    if not values:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    s = sorted(float(v) for v in values)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


def summarize(values: Sequence[float]) -> dict:
    """count/mean/p50/p95/p99 of a sample."""
    n = len(values)
    return {
        "count": n,
        "mean": (sum(values) / n) if n else None,
        "p50": quantile(values, 0.5),
        "p95": quantile(values, 0.95),
        "p99": quantile(values, 0.99),
    }


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


def mfu(flops_per_sec: float, device_name: str, n_devices: int = 1) -> Optional[float]:
    """Model FLOPs utilization of `n_devices` cards against their peak bf16
    rate; None when the peak is unknown."""
    peak = peak_bf16_flops(device_name)
    if not peak or flops_per_sec <= 0:
        return None
    return flops_per_sec / (peak * max(1, n_devices))
