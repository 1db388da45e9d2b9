"""Slice health check, counterpart of `polyaxon_tpu/runtime/health.py`:
prove the devices and the collective path work before a long run starts.
A tiny all-reduce over the whole world right after the process group
starts exercises each rank's device, its memory and the backend's
collectives in one call; the chief logs the report as a run event."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class SliceHealthError(RuntimeError):
    pass


def check_slice(expected_devices: Optional[int] = None, device=None,
                processes: Optional[int] = None) -> dict:
    """→ {"devices": world size, "platform", "device_kind",
    "all_reduce_ok": True, "process_count"}; raises SliceHealthError on
    any failure. `device`: where this rank's tensor lives (the current
    CUDA device under `nccl`, else the CPU). `processes`: the reference's
    process count, one per replica (default: one per rank)."""
    if not dist.is_initialized():
        raise SliceHealthError("torch.distributed is not initialized")
    n = dist.get_world_size()
    if expected_devices is not None and n < expected_devices:
        raise SliceHealthError(f"expected {expected_devices} devices, found {n}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    try:
        x = torch.ones(1, dtype=torch.float32, device=device)
        dist.all_reduce(x)
        total = float(x.item())
    except Exception as e:  # noqa: BLE001
        raise SliceHealthError(f"collective check failed: {e}") from e
    if total != float(n):
        raise SliceHealthError(f"all-reduce returned {total}, expected {n}")
    device = torch.device(device)
    return {
        "devices": n,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "all_reduce_ok": True,
        "process_count": n if processes is None else processes,
    }
