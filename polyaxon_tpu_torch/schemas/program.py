"""`V1Program` and its parts, counterparts of `V1ModelSpec`, `V1DataSpec`,
`V1OptimizerSpec`, `V1TrainSpec` and `V1Program` in
`polyaxon_tpu/schemas/run_kinds.py`, as plain dataclasses.

Same fields and defaults as the reference. `from_dict` takes the YAML
surface: each key in snake_case or camelCase (`batchSize`, `logEvery`),
unknown keys rejected as the reference's `extra="forbid"` rejects them.
Scalar fields keep what they are given (a `{{ params.x }}` template stays
a string); the trainer converts them with int()/float(). `serving` and
`observability` are carried as plain dicts: the trainer does not read
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional, Union

PRECISIONS = ("bfloat16", "float32", "mixed")
REMAT_POLICIES = (None, "nothing", "dots", "dots_no_batch")


def to_camel(s: str) -> str:
    parts = s.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


class _Spec:
    """`from_dict` for the dataclasses below."""

    _nested: ClassVar[dict[str, type]] = {}

    @classmethod
    def from_dict(cls, data: Union[dict, "_Spec"]):
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise TypeError(f"{cls.__name__} takes a dict, got {type(data).__name__}")
        names = {f.name for f in dataclasses.fields(cls)}
        aliases = {to_camel(n): n for n in names}
        kwargs: dict[str, Any] = {}
        for key, value in data.items():
            name = key if key in names else aliases.get(key)
            if name is None:
                raise ValueError(
                    f"{cls.__name__}: unknown field {key!r} (extra fields are "
                    f"not permitted; known: {sorted(aliases)})"
                )
            if name in kwargs:
                raise ValueError(f"{cls.__name__}: field {name!r} given twice")
            nested = cls._nested.get(name)
            kwargs[name] = (
                nested.from_dict(value) if nested and value is not None else value
            )
        try:
            return cls(**kwargs)
        except TypeError as e:  # a required field is missing
            raise ValueError(f"{cls.__name__}: {e}") from None


@dataclasses.dataclass
class V1ModelSpec(_Spec):
    """A model from the registry (`models/registry.py`)."""

    name: str
    config: Optional[dict[str, Any]] = None


@dataclasses.dataclass
class V1DataSpec(_Spec):
    name: str = "synthetic"
    batch_size: Union[int, str] = 32
    config: Optional[dict[str, Any]] = None


@dataclasses.dataclass
class V1OptimizerSpec(_Spec):
    name: str = "adamw"
    learning_rate: Union[float, str] = 1e-3
    config: Optional[dict[str, Any]] = None
    schedule: Optional[dict[str, Any]] = None


@dataclasses.dataclass
class V1TrainSpec(_Spec):
    steps: Union[int, str] = 100
    eval_every: Optional[Union[int, str]] = None
    eval_steps: Optional[Union[int, str]] = None
    # profiler capture window [start_step, end_step)
    profile_start: Optional[Union[int, str]] = None
    profile_stop: Optional[Union[int, str]] = None
    log_every: Union[int, str] = 10
    checkpoint_every: Optional[Union[int, str]] = None
    checkpoint_keep: Optional[Union[int, str]] = None
    checkpoint_local_dir: Optional[str] = None
    resume: Optional[bool] = None
    seed: Union[int, str] = 0
    precision: str = "mixed"
    remat: Optional[bool] = None
    remat_policy: Optional[str] = None
    donate_state: bool = True
    loss: Optional[str] = None
    grad_accum: Optional[Union[int, str]] = None

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"V1TrainSpec: precision must be one of {PRECISIONS}, "
                f"got {self.precision!r}"
            )
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"V1TrainSpec: remat_policy must be one of {REMAT_POLICIES}, "
                f"got {self.remat_policy!r}"
            )
        if isinstance(self.checkpoint_keep, int) and self.checkpoint_keep < 1:
            raise ValueError(
                f"checkpointKeep must be >= 1, got {self.checkpoint_keep}"
            )


@dataclasses.dataclass
class V1Program(_Spec):
    """A native training program: what `runtime/trainer.py` runs."""

    model: V1ModelSpec
    data: Optional[V1DataSpec] = None
    optimizer: Optional[V1OptimizerSpec] = None
    train: Optional[V1TrainSpec] = None
    serving: Optional[dict[str, Any]] = None
    observability: Optional[dict[str, Any]] = None

    _nested: ClassVar[dict[str, type]] = {
        "model": V1ModelSpec, "data": V1DataSpec,
        "optimizer": V1OptimizerSpec, "train": V1TrainSpec,
    }
