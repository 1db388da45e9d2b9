"""The Polyaxonfile specs the port reads, as plain dataclasses
(counterparts of the reference's pydantic V1* schemas): the run lifecycle
(`lifecycle.py`) and the `jaxjob` run spec with its `program:`, `serving:`
and `observability:` blocks (`run_kinds.py`)."""

from .lifecycle import DONE_STATUSES, V1Statuses, can_transition, is_done
from .run_kinds import (
    V1DataSpec,
    V1HistorySpec,
    V1JAXJob,
    V1MeshSpec,
    V1ModelSpec,
    V1ObservabilitySpec,
    V1OptimizerSpec,
    V1PoolsSpec,
    V1Program,
    V1RegressionRuleSpec,
    V1ServingSpec,
    V1SLOSpec,
    V1TenantSpec,
    V1TrainSpec,
)

__all__ = [
    "DONE_STATUSES", "V1DataSpec", "V1HistorySpec", "V1JAXJob", "V1MeshSpec",
    "V1ModelSpec", "V1ObservabilitySpec", "V1OptimizerSpec", "V1PoolsSpec",
    "V1Program", "V1RegressionRuleSpec", "V1SLOSpec", "V1ServingSpec",
    "V1Statuses", "V1TenantSpec", "V1TrainSpec", "can_transition", "is_done",
]
