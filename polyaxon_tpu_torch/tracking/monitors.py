"""System monitors, the counterpart of `polyaxon_tpu/tracking/monitors.py`:
host metrics and the cards' memory, sampled in the background into the
run store and a telemetry registry.

Host numbers come from `/proc` and `os` (the reference reads them with
psutil, which the port does not depend on), under the reference's names:
`sys.cpu_percent` (busy share of all CPUs since the last sample,
`/proc/stat`), `sys.memory_percent` and `sys.memory_used_gb`
(`/proc/meminfo`: total less available, as psutil 7 counts it), `sys.disk_percent` (`os.statvfs`
of `/`) and `sys.load1`. Device numbers come from `device_metrics`: HBM
of each TPU chip from JAX there, each visible CUDA card here.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import torch

from ..telemetry import get_registry

_cpu_last: Optional[tuple[int, int]] = None  # (busy, total) jiffies of the last read
_cpu_lock = threading.Lock()


def _cpu_times() -> tuple[int, int]:
    with open("/proc/stat") as f:
        fields = [int(x) for x in f.readline().split()[1:]]
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0)  # idle + iowait
    # guest time is already counted in user/nice
    total = sum(fields[:8])
    return total - idle, total


def prime_cpu_percent() -> None:
    """Start the CPU window, so the first sample measures real load (as
    psutil's first `cpu_percent(interval=None)` call does)."""
    global _cpu_last
    with _cpu_lock:
        _cpu_last = _cpu_times()


def _cpu_percent() -> float:
    global _cpu_last
    with _cpu_lock:
        now = _cpu_times()
        last, _cpu_last = _cpu_last, now
    if last is None or now[1] <= last[1]:
        return 0.0
    return 100.0 * (now[0] - last[0]) / (now[1] - last[1])


def _meminfo() -> dict[str, int]:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            parts = rest.split()
            if parts:
                out[key] = int(parts[0]) * 1024
    return out


def host_metrics() -> dict[str, float]:
    mem = _meminfo()
    total = mem["MemTotal"]
    available = mem.get("MemAvailable", mem.get("MemFree", 0))
    out = {
        "sys.cpu_percent": float(_cpu_percent()),
        "sys.memory_percent": 100.0 * (total - available) / total if total else 0.0,
        "sys.memory_used_gb": (total - available) / 1e9,
    }
    try:
        st = os.statvfs("/")
        disk_used = (st.f_blocks - st.f_bfree) * st.f_frsize
        disk_free = st.f_bavail * st.f_frsize
        if disk_used + disk_free:
            out["sys.disk_percent"] = 100.0 * disk_used / (disk_used + disk_free)
    except OSError:
        pass
    try:
        out["sys.load1"] = float(os.getloadavg()[0])
    except OSError:
        pass
    return out


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


class SystemMonitor:
    """Background sampler: `with SystemMonitor(store, run_uuid): ...` or
    `start()`/`stop()`. A sample goes to the run store (the per-run
    history the CLI reads) and to a registry's gauges (the live
    `/metricsz` view); a failure inside the loop never reaches training.
    `stop()` takes one last sample."""

    def __init__(self, store=None, run_uuid: Optional[str] = None, interval: float = 10.0):
        from ..store import RunStore

        self.store = store or RunStore()
        self.run_uuid = run_uuid or os.environ.get("POLYAXON_RUN_UUID")
        if self.run_uuid is None:
            raise ValueError("SystemMonitor needs a run uuid")
        self.interval = interval
        self.registry = get_registry()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples = 0

    def _sample_once(self):
        metrics = {**host_metrics(), **device_metrics()}
        self.store.log_metrics(self.run_uuid, self._samples, metrics)
        for name, val in metrics.items():
            self.registry.gauge(name).set(val)
        self._samples += 1

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001 — sampling never fails the run
                pass
            self._stop.wait(self.interval)

    def start(self) -> "SystemMonitor":
        if self._thread is None:
            try:
                prime_cpu_percent()
            except OSError:
                pass
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="polyaxon-sysmon")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1)
            self._thread = None
            try:
                self._sample_once()
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
