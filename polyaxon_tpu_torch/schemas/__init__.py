"""The Polyaxonfile specs as plain dataclasses (counterparts of the
reference's pydantic V1* schemas, on `schemas/base.py`): the run lifecycle
(`lifecycle.py`), operations and components (`operation.py`,
`component.py`), their inputs, termination, environment and matrix
(`io.py`, `termination.py`, `environment.py`, `matrix.py`), and the run
kinds with the `program:`, `serving:` and `observability:` blocks
(`run_kinds.py`)."""

from .base import Spec, SpecError, to_camel
from .component import V1Build, V1Cache, V1Component, V1Plugins
from .environment import CHIPS_PER_HOST, TPU_TYPES, V1Environment, V1Resources, V1TpuSpec
from .io import V1IO, V1Param
from .lifecycle import DONE_STATUSES, V1Statuses, can_transition, is_done
from .matrix import V1MatrixField, parse_matrix
from .operation import V1Hook, V1Join, V1Operation, V1Schedule
from .run_kinds import (
    RUN_KINDS,
    V1Container,
    V1Dag,
    V1DataSpec,
    V1HistorySpec,
    V1Init,
    V1JAXJob,
    V1Job,
    V1KFReplica,
    V1MeshSpec,
    V1ModelSpec,
    V1ObservabilitySpec,
    V1OperationRef,
    V1OptimizerSpec,
    V1PoolsSpec,
    V1Program,
    V1RegressionRuleSpec,
    V1RunKindField,
    V1Service,
    V1ServingSpec,
    V1SLOSpec,
    V1TenantSpec,
    V1TrainSpec,
    V1TunerJob,
    parse_run,
    run_num_slices,
)
from .termination import V1Termination

__all__ = [
    "CHIPS_PER_HOST", "DONE_STATUSES", "RUN_KINDS", "Spec", "SpecError", "TPU_TYPES",
    "V1Build", "V1Cache", "V1Component", "V1Container", "V1Dag", "V1DataSpec",
    "V1Environment", "V1HistorySpec", "V1Hook", "V1IO", "V1Init", "V1JAXJob", "V1Job",
    "V1Join", "V1KFReplica", "V1MatrixField", "V1MeshSpec", "V1ModelSpec",
    "V1ObservabilitySpec", "V1Operation", "V1OperationRef", "V1OptimizerSpec", "V1Param",
    "V1Plugins", "V1PoolsSpec", "V1Program", "V1RegressionRuleSpec", "V1Resources",
    "V1RunKindField", "V1SLOSpec", "V1Schedule", "V1Service", "V1ServingSpec",
    "V1Statuses", "V1TenantSpec", "V1Termination", "V1TpuSpec", "V1TrainSpec",
    "V1TunerJob", "can_transition", "is_done", "parse_matrix", "parse_run", "run_num_slices",
    "to_camel",
]
