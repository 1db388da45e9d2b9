"""The search-space and search-algorithm specs (`matrix:`), an own copy of
`polyaxon_tpu/schemas/matrix.py`. The search managers read them
(`tuner/managers.py`) and `tuner/driver.py::run_sweep` runs the sweep."""

from __future__ import annotations

import dataclasses
from typing import Annotated, Any, Literal, Optional, Union

from .base import Spec, Tagged


# ---------------------------------------------------------------- hp params
@dataclasses.dataclass(kw_only=True)
class V1HpChoice(Spec):
    kind: Literal["choice"] = "choice"
    value: list[Any]


@dataclasses.dataclass(kw_only=True)
class V1HpPChoice(Spec):
    """Weighted choice: value is a list of [item, probability] pairs."""

    kind: Literal["pchoice"] = "pchoice"
    value: list[list[Any]]

    @classmethod
    def _check_value(cls, v):
        total = 0.0
        for entry in v:
            if not isinstance(entry, (list, tuple)) or len(entry) != 2:
                raise ValueError(
                    f"pchoice entries must be [item, probability] pairs, got {entry!r}"
                )
            try:
                total += float(entry[1])
            except (TypeError, ValueError):
                raise ValueError(
                    f"pchoice probability must be a number, got {entry[1]!r}"
                ) from None
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"pchoice probabilities must sum to 1, got {total}")
        return v


@dataclasses.dataclass(kw_only=True)
class V1HpRange(Spec):
    """Integer range [start, stop) with step."""

    kind: Literal["range"] = "range"
    value: dict[str, int]

    def __post_init__(self):
        missing = {"start", "stop"} - set(self.value)
        if missing:
            raise ValueError(f"range needs start/stop, missing {missing}")
        self.value.setdefault("step", 1)
        step = self.value["step"]
        if step == 0:
            raise ValueError("range step must not be zero")
        if (self.value["stop"] - self.value["start"]) * step < 0:
            raise ValueError(
                f"range start={self.value['start']} stop={self.value['stop']} "
                f"step={step} is empty (step sign mismatch)"
            )

    def to_list(self) -> list[int]:
        return list(range(self.value["start"], self.value["stop"], self.value["step"]))


@dataclasses.dataclass(kw_only=True)
class V1HpLinSpace(Spec):
    kind: Literal["linspace"] = "linspace"
    value: dict[str, float]

    def __post_init__(self):
        missing = {"start", "stop", "num"} - set(self.value)
        if missing:
            raise ValueError(f"linspace needs start/stop/num, missing {missing}")

    def to_list(self) -> list[float]:
        start, stop, num = self.value["start"], self.value["stop"], int(self.value["num"])
        if num == 1:
            return [start]
        step = (stop - start) / (num - 1)
        return [start + i * step for i in range(num)]


@dataclasses.dataclass(kw_only=True)
class V1HpLogSpace(Spec):
    kind: Literal["logspace"] = "logspace"
    value: dict[str, float]

    def __post_init__(self):
        missing = {"start", "stop", "num"} - set(self.value)
        if missing:
            raise ValueError(f"logspace needs start/stop/num, missing {missing}")

    def to_list(self) -> list[float]:
        base = self.value.get("base", 10.0)
        start, stop, num = self.value["start"], self.value["stop"], int(self.value["num"])
        if num == 1:
            return [base**start]
        step = (stop - start) / (num - 1)
        return [base ** (start + i * step) for i in range(num)]


@dataclasses.dataclass(kw_only=True)
class V1HpUniform(Spec):
    kind: Literal["uniform"] = "uniform"
    value: dict[str, float]  # {low, high}

    def __post_init__(self):
        if {"low", "high"} - set(self.value):
            raise ValueError("uniform needs low/high")


@dataclasses.dataclass(kw_only=True)
class V1HpQUniform(Spec):
    kind: Literal["quniform"] = "quniform"
    value: dict[str, float]  # {low, high, q}


@dataclasses.dataclass(kw_only=True)
class V1HpLogUniform(Spec):
    kind: Literal["loguniform"] = "loguniform"
    value: dict[str, float]  # {low, high} in log space


@dataclasses.dataclass(kw_only=True)
class V1HpNormal(Spec):
    kind: Literal["normal"] = "normal"
    value: dict[str, float]  # {loc, scale}


@dataclasses.dataclass(kw_only=True)
class V1HpLogNormal(Spec):
    kind: Literal["lognormal"] = "lognormal"
    value: dict[str, float]  # {loc, scale}


V1HpParam = Union[
    V1HpChoice, V1HpPChoice, V1HpRange, V1HpLinSpace, V1HpLogSpace, V1HpUniform,
    V1HpQUniform, V1HpLogUniform, V1HpNormal, V1HpLogNormal,
]

DISCRETE_KINDS = {"choice", "pchoice", "range", "linspace", "logspace"}


# ---------------------------------------------------------------- early stopping
@dataclasses.dataclass(kw_only=True)
class V1MetricEarlyStopping(Spec):
    kind: Literal["metric_early_stopping"] = "metric_early_stopping"
    metric: str
    value: float
    optimization: Literal["maximize", "minimize"] = "maximize"


@dataclasses.dataclass
class V1MedianStoppingPolicy(Spec):
    kind: Literal["median"] = "median"
    evaluation_interval: int = 1
    min_interval: Optional[int] = None
    min_samples: Optional[int] = None


@dataclasses.dataclass
class V1TruncationStoppingPolicy(Spec):
    kind: Literal["truncation"] = "truncation"
    percent: float = 50.0
    evaluation_interval: int = 1
    min_interval: Optional[int] = None
    min_samples: Optional[int] = None


V1EarlyStopping = Union[V1MetricEarlyStopping]
V1StoppingPolicy = Union[V1MedianStoppingPolicy, V1TruncationStoppingPolicy]


@dataclasses.dataclass(kw_only=True)
class V1OptimizationMetric(Spec):
    name: str
    optimization: Literal["maximize", "minimize"] = "maximize"


@dataclasses.dataclass(kw_only=True)
class V1OptimizationResource(Spec):
    """The resource Hyperband allocates (e.g. steps or epochs)."""

    name: str
    type: Literal["int", "float"] = "int"


# ---------------------------------------------------------------- matrix kinds
@dataclasses.dataclass(kw_only=True)
class V1MatrixBase(Spec):
    concurrency: Optional[int] = None
    early_stopping: Optional[list[V1MetricEarlyStopping]] = None


@dataclasses.dataclass(kw_only=True)
class V1GridSearch(V1MatrixBase):
    kind: Literal["grid"] = "grid"
    params: dict[str, V1HpParam]
    num_runs: Optional[int] = None

    @classmethod
    def _check_params(cls, v):
        for name, p in v.items():
            if p.kind not in DISCRETE_KINDS:
                raise ValueError(f"grid search param {name!r} must be discrete, got {p.kind}")
        return v


@dataclasses.dataclass(kw_only=True)
class V1RandomSearch(V1MatrixBase):
    kind: Literal["random"] = "random"
    params: dict[str, V1HpParam]
    num_runs: int
    seed: Optional[int] = None


@dataclasses.dataclass(kw_only=True)
class V1Hyperband(V1MatrixBase):
    kind: Literal["hyperband"] = "hyperband"
    params: dict[str, V1HpParam]
    max_iterations: int  # R: max resource per config
    eta: int = 3  # downsampling rate
    resource: V1OptimizationResource
    metric: V1OptimizationMetric
    resume: Optional[bool] = None
    seed: Optional[int] = None


@dataclasses.dataclass(kw_only=True)
class V1Asha(V1MatrixBase):
    """Asynchronous successive halving; `maxIterations` trial executions."""

    kind: Literal["asha"] = "asha"
    params: dict[str, V1HpParam]
    max_iterations: int
    eta: int = 3
    min_resource: int | float = 1
    max_resource: int | float
    resource: V1OptimizationResource
    metric: V1OptimizationMetric
    seed: Optional[int] = None

    def __post_init__(self):
        if self.min_resource <= 0 or self.max_resource < self.min_resource:
            raise ValueError("asha needs 0 < minResource <= maxResource")
        if self.eta < 2:
            raise ValueError("asha eta must be >= 2")


@dataclasses.dataclass(kw_only=True)
class V1Bayes(V1MatrixBase):
    kind: Literal["bayes"] = "bayes"
    params: dict[str, V1HpParam]
    num_initial_runs: int
    max_iterations: int
    metric: V1OptimizationMetric
    utility_function: Optional[dict] = None
    algorithm: Literal["gp", "turbo", "baxus"] = "gp"
    trust_region: Optional[dict] = None
    initial_target_dim: Optional[int] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.algorithm != "gp" and self.utility_function:
            raise ValueError(
                f"utilityFunction only applies to algorithm 'gp'; "
                f"{self.algorithm!r} uses Thompson sampling (tune trustRegion instead)"
            )
        if self.algorithm == "gp" and self.trust_region:
            raise ValueError("trustRegion requires algorithm 'turbo' or 'baxus'")


@dataclasses.dataclass(kw_only=True)
class V1Hyperopt(V1MatrixBase):
    kind: Literal["hyperopt"] = "hyperopt"
    params: dict[str, V1HpParam]
    num_runs: int
    algorithm: Literal["tpe", "rand", "anneal"] = "tpe"
    metric: Optional[V1OptimizationMetric] = None
    seed: Optional[int] = None


@dataclasses.dataclass(kw_only=True)
class V1Iterative(V1MatrixBase):
    kind: Literal["iterative"] = "iterative"
    params: dict[str, V1HpParam]
    max_iterations: int
    seed: Optional[int] = None
    tuner: Optional[dict] = None


@dataclasses.dataclass(kw_only=True)
class V1Mapping(V1MatrixBase):
    kind: Literal["mapping"] = "mapping"
    values: list[dict[str, Any]]


V1Matrix = Union[
    V1GridSearch, V1RandomSearch, V1Hyperband, V1Asha, V1Bayes, V1Hyperopt,
    V1Iterative, V1Mapping,
]

V1MatrixField = Annotated[V1Matrix, Tagged("kind")]

MATRIX_KINDS = {
    "grid": V1GridSearch, "random": V1RandomSearch, "hyperband": V1Hyperband,
    "asha": V1Asha, "bayes": V1Bayes, "hyperopt": V1Hyperopt,
    "iterative": V1Iterative, "mapping": V1Mapping,
}


def parse_matrix(data: dict) -> V1Matrix:
    kind = data.get("kind")
    if kind not in MATRIX_KINDS:
        raise ValueError(f"unknown matrix kind {kind!r}; one of {sorted(MATRIX_KINDS)}")
    return MATRIX_KINDS[kind].from_dict(data)
