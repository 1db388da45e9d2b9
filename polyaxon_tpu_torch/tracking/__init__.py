"""Run tracking: the host and device readings the trainer publishes and
the background `SystemMonitor` an `observability:` block starts."""

from .monitors import SystemMonitor, device_metrics, host_metrics

__all__ = ["SystemMonitor", "device_metrics", "host_metrics"]
