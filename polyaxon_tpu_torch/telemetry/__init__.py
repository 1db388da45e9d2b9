"""The trainer's telemetry: the metrics registry, span tracing and the
throughput formulas (`stats.py`). Stdlib only, so any module of the
package may import it."""

from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry, now
from .spans import SpanTracer, get_tracer
from .stats import mfu, peak_bf16_flops, train_step_flops

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
    "get_registry", "get_tracer", "mfu", "now", "peak_bf16_flops",
    "train_step_flops",
]
