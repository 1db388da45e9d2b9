"""Run tracking: the device memory readings the trainer publishes."""

from .monitors import device_metrics

__all__ = ["device_metrics"]
