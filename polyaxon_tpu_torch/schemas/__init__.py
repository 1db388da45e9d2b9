"""The Polyaxonfile `program:` block the trainer reads, as plain
dataclasses (counterparts of the reference's pydantic V1* schemas)."""

from .program import (
    V1DataSpec,
    V1ModelSpec,
    V1OptimizerSpec,
    V1Program,
    V1TrainSpec,
)

__all__ = ["V1DataSpec", "V1ModelSpec", "V1OptimizerSpec", "V1Program", "V1TrainSpec"]
