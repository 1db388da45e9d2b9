"""Early stopping, an own copy of `polyaxon_tpu/tuner/early_stopping.py`:
the sweep-level metric gate (stop the sweep when a trial crosses a
threshold), median stopping (stop a trial whose running metric is worse
than the median of the others at the same step) and truncation stopping
(stop the bottom X percent)."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from ..schemas.matrix import (
    V1MedianStoppingPolicy,
    V1MetricEarlyStopping,
    V1TruncationStoppingPolicy,
)


def metric_triggered(
    policies: Optional[Iterable[V1MetricEarlyStopping]],
    metrics: dict[str, float],
) -> bool:
    """True if any policy's threshold is crossed by `metrics` (one trial's
    latest values) — the sweep driver then stops suggesting."""
    for p in policies or ():
        if p.metric not in metrics:
            continue
        v = float(metrics[p.metric])
        if p.optimization == "maximize" and v >= p.value:
            return True
        if p.optimization == "minimize" and v <= p.value:
            return True
    return False


def median_should_stop(
    policy: V1MedianStoppingPolicy,
    history: Sequence[float],
    others_at_step: Sequence[float],
    *,
    maximize: bool,
) -> bool:
    """Stop if this trial's current value is worse than the median of other
    trials' values at the same step (after min_interval/min_samples)."""
    step = len(history)
    if policy.min_interval and step < policy.min_interval:
        return False
    if step % max(1, policy.evaluation_interval) != 0:
        return False
    if policy.min_samples and len(others_at_step) < policy.min_samples:
        return False
    if not others_at_step or not history:
        return False
    ordered = sorted(others_at_step)
    m = ordered[len(ordered) // 2]
    cur = history[-1]
    return cur < m if maximize else cur > m


def truncation_should_stop(
    policy: V1TruncationStoppingPolicy,
    value: float,
    all_values: Sequence[float],
    *,
    maximize: bool,
) -> bool:
    """Stop if `value` lands in the worst `percent` of `all_values`."""
    if not all_values:
        return False
    if policy.min_samples and len(all_values) < policy.min_samples:
        return False
    ordered = sorted(all_values, reverse=maximize)  # best → worst
    # cutoff marks the boundary of the worst `percent` tail
    k = min(len(ordered) - 1, int(len(ordered) * (1 - policy.percent / 100.0)))
    cutoff = ordered[k]
    return value < cutoff if maximize else value > cutoff
