"""Deterministic fault injection for the trainer, its checkpoints and the
serving spill tier and adapter registry:
`FaultPlan`/`Fault` (plan.py) and the failpoint machinery the runtime's
instrumented sites consult (injector.py), a no-op unless a plan is armed."""

from .injector import (
    ChaosError,
    SimulatedKill,
    active,
    arm,
    corrupt_checkpoint,
    corrupt_segment_frame,
    disarm,
    inject,
    scramble_tail,
)
from .plan import Fault, FaultPlan

__all__ = [
    "ChaosError", "Fault", "FaultPlan", "SimulatedKill", "active", "arm",
    "corrupt_checkpoint", "corrupt_segment_frame", "disarm", "inject", "scramble_tail",
]
