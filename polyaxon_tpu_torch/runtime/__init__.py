"""The training runtime: `Trainer(program).run()` on one GPU."""

from .trainer import Trainer, TrainResult, TrainState

__all__ = ["Trainer", "TrainResult", "TrainState"]
