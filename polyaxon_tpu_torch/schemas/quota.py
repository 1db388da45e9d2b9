"""V1QuotaSpec: per-project / per-queue admission limits for the fleet
scheduler (`scheduler/admission.py`), an own copy of
`polyaxon_tpu/schemas/quota.py` on the port's spec base.

A quota bounds what one tenant may hold at any instant:

  quota:
    scope: team-a          # project name, or "queue:<name>" for a queue
    maxChips: 16           # chips reserved concurrently (gangs count whole)
    maxRuns: 4             # concurrently admitted runs
    weight: 2.0            # fair-share weight when demand exceeds capacity

`weight` orders admission among tenants competing at the same priority:
the tenant with the smallest reserved_chips/weight ratio admits first.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .base import Spec


@dataclasses.dataclass
class V1QuotaSpec(Spec):
    scope: str
    max_chips: Optional[int] = None
    max_runs: Optional[int] = None
    weight: float = 1.0

    @classmethod
    def _check_scope(cls, v: str) -> str:
        if not v or not v.strip():
            raise ValueError("quota scope must be a non-empty project name "
                             "or 'queue:<name>'")
        return v.strip()

    @classmethod
    def _check_limits(cls, v: Optional[int]) -> Optional[int]:
        if v is not None and v < 0:
            raise ValueError(f"quota limits must be >= 0, got {v}")
        return v

    _check_max_chips = _check_limits
    _check_max_runs = _check_limits

    @classmethod
    def _check_weight(cls, v: float) -> float:
        if v <= 0:
            raise ValueError(f"quota weight must be > 0, got {v}")
        return v

    @property
    def is_queue_scope(self) -> bool:
        return self.scope.startswith("queue:")

    @property
    def scope_name(self) -> str:
        """The bare project or queue name the quota binds to."""
        return self.scope.split(":", 1)[1] if self.is_queue_scope else self.scope
