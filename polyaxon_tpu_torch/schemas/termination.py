"""Termination policy (`V1Termination`): retries, their backoff, TTL and
timeout. An own copy of `polyaxon_tpu/schemas/termination.py`; the
executor builds its `retry.RetryPolicy` from it."""

from __future__ import annotations

import dataclasses
from typing import Optional

from .base import Spec


@dataclasses.dataclass
class V1Termination(Spec):
    max_retries: Optional[int] = None
    ttl: Optional[int] = None  # seconds after finish before cleanup
    timeout: Optional[int] = None  # max runtime seconds
    backoff: Optional[float] = None  # initial retry delay seconds (0 = now)
    backoff_factor: Optional[float] = None  # exponential growth per attempt
    backoff_max: Optional[float] = None  # delay ceiling seconds
    jitter: Optional[float] = None  # max fractional delay shrink [0, 1)
