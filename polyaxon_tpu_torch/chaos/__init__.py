"""Deterministic fault injection for the trainer and its checkpoints:
`FaultPlan`/`Fault` (plan.py) and the failpoint machinery the runtime's
instrumented sites consult (injector.py), a no-op unless a plan is armed."""

from .injector import (
    ChaosError,
    SimulatedKill,
    active,
    arm,
    corrupt_checkpoint,
    disarm,
    inject,
)
from .plan import Fault, FaultPlan

__all__ = [
    "ChaosError", "Fault", "FaultPlan", "SimulatedKill", "active", "arm",
    "corrupt_checkpoint", "disarm", "inject",
]
