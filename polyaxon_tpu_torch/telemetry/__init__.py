"""Telemetry of the port, stdlib only, so any module of the package may
import it (own copies of `polyaxon_tpu/telemetry/`):

- `MetricsRegistry` (registry.py): counters, gauges and fixed-bucket
  histograms (with exemplars), rendered as a snapshot dict (`/statsz`) or
  Prometheus text (`/metricsz`) from the same objects;
- `SpanTracer` (spans.py): the trainer's nested spans;
- `RequestTrace`/`TraceRing` (tracing.py): per-request serving traces and
  the tail-sampling ring behind `/tracez`;
- `SLOEngine`/`FlightRecorder` (slo.py): multi-window burn rates and the
  breach bundle (with a `torch.profiler` window);
- `HistoryStore`/`HistorySampler` (history.py): the crash-consistent
  metrics history behind `/queryz`; `RegressionSentinel` (detect.py)
  fires edge-triggered rules over it;
- `federate` (federate.py): one Prometheus parser and the router's
  federated `/metricsz`;
- `mfu`, `quantile`, `summarize`, `train_step_flops` (stats.py);
- `now()`: the monotonic clock every duration measurement goes through.
"""

from .detect import DEFAULT_SERVING_RULES, RegressionRule, RegressionSentinel, build_rules
from .federate import (
    PromSample,
    PromSnapshot,
    federate,
    parse_prometheus_text,
    queue_wait_delta_ms,
)
from .history import HistorySampler, HistoryStore, queryz_payload
from .registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry, now
from .slo import (
    AvailabilityObjective,
    FlightRecorder,
    LatencyObjective,
    SLOEngine,
    build_objectives,
)
from .spans import SpanTracer, get_tracer
from .stats import mfu, peak_bf16_flops, quantile, summarize, train_step_flops
from .tracing import RequestTrace, TraceRing, new_trace_id, tracez_payload

__all__ = [
    "AvailabilityObjective", "Counter", "DEFAULT_SERVING_RULES", "FlightRecorder",
    "Gauge", "Histogram", "HistorySampler", "HistoryStore", "LatencyObjective",
    "MetricsRegistry", "PromSample", "PromSnapshot", "RegressionRule",
    "RegressionSentinel", "RequestTrace", "SLOEngine", "SpanTracer", "TraceRing",
    "build_objectives", "build_rules", "federate", "get_registry", "get_tracer",
    "mfu", "new_trace_id", "now", "parse_prometheus_text", "peak_bf16_flops",
    "quantile", "queue_wait_delta_ms", "queryz_payload", "summarize",
    "tracez_payload", "train_step_flops",
]
