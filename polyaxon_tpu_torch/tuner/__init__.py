"""Polytune, hyperparameter search: an own copy of `polyaxon_tpu/tuner/`.

Managers (managers.py) turn a `matrix:` spec into suggestion batches; the
SweepDriver (driver.py) runs them as child runs on disjoint groups of the
device pool (placement.py) with early stopping (early_stopping.py).
"""

from .driver import SweepDriver, SweepResult, TrialResult, run_sweep  # noqa: F401
from .managers import (  # noqa: F401
    BayesSearchManager,
    GridSearchManager,
    HyperbandManager,
    HyperoptManager,
    IterativeManager,
    MappingManager,
    RandomSearchManager,
    Suggestion,
    build_manager,
)
