"""Device memory readings, the counterpart of `device_metrics` in
`polyaxon_tpu/tracking/monitors.py` (HBM of each TPU chip from JAX there,
each visible CUDA card here). The background `SystemMonitor` is not
ported."""

from __future__ import annotations

import torch


def device_metrics() -> dict[str, float]:
    """Per card: `sys.gpu{i}.hbm_used_gb` (`torch.cuda.memory_allocated`,
    the tensors PyTorch holds) and `sys.gpu{i}.hbm_percent` (of the card's
    total, `torch.cuda.mem_get_info`). `{}` without CUDA."""
    out: dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        used = torch.cuda.memory_allocated(i)
        _free, total = torch.cuda.mem_get_info(i)
        out[f"sys.gpu{i}.hbm_used_gb"] = used / 1e9
        if total:
            out[f"sys.gpu{i}.hbm_percent"] = 100.0 * used / total
    return out
