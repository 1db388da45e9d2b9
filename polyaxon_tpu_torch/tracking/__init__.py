"""Run tracking: the in-job client that attaches to a run (`run.py`:
`init`, `Run`, `log_metrics`, `end`), the framework callbacks
(`callbacks.py`), and the host and device readings the trainer publishes
with the background `SystemMonitor` an `observability:` block starts
(`monitors.py`)."""

from .monitors import SystemMonitor, device_metrics, host_metrics
from .run import Run, end, get_or_create_run, init, log_metrics

__all__ = ["Run", "SystemMonitor", "device_metrics", "end", "get_or_create_run",
           "host_metrics", "init", "log_metrics"]
