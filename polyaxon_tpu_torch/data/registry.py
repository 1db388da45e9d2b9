"""Dataset registry, counterpart of `polyaxon_tpu/data/registry.py` for one
process."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

_DATASETS: dict[str, Callable[..., "DataSpec"]] = {}


@dataclasses.dataclass
class DataSpec:
    """A built pipeline: `iterator` yields dict batches forever."""

    name: str
    iterator: Iterator[dict[str, Any]]
    batch_size: int
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


def register_dataset(name: str):
    def deco(fn):
        _DATASETS[name] = fn
        return fn

    return deco


def build_data(
    name: str,
    batch_size: int,
    config: Optional[dict] = None,
    *,
    seed: int = 0,
    process_index: int = 0,
) -> DataSpec:
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset {name!r}; registered: {sorted(_DATASETS)}")
    # the procedural streams decorrelate streams by process_index alone
    return _DATASETS[name](
        batch_size=batch_size,
        config=dict(config or {}),
        seed=seed,
        process_index=process_index,
    )
