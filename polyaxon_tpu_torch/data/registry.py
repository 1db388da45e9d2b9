"""Dataset registry, counterpart of `polyaxon_tpu/data/registry.py`."""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Iterator, Optional

_DATASETS: dict[str, Callable[..., "DataSpec"]] = {}


@dataclasses.dataclass
class DataSpec:
    """A built pipeline: `iterator` yields dict batches forever;
    `batch_size` is the per-process batch (global batch / process_count).
    `close` releases pipeline resources deterministically (the native
    loader's prefetch threads and its corpus mmap), not at GC time."""

    name: str
    iterator: Iterator[dict[str, Any]]
    batch_size: int
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    close: Optional[Callable[[], None]] = None

    def shutdown(self) -> None:
        """Idempotent teardown hook (the trainer's `close` calls it)."""
        fn, self.close = self.close, None
        if fn is not None:
            fn()


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
    process_count: int = 1,
) -> DataSpec:
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset {name!r}; registered: {sorted(_DATASETS)}")
    if batch_size % process_count != 0:
        raise ValueError(
            f"global batch {batch_size} not divisible by {process_count} hosts"
        )
    kwargs = dict(
        batch_size=batch_size // process_count,
        config=dict(config or {}),
        seed=seed,
        process_index=process_index,
    )
    # the file pipelines shard windows by process_count; the procedural
    # streams decorrelate by process_index alone
    if "process_count" in inspect.signature(_DATASETS[name]).parameters:
        kwargs["process_count"] = process_count
    return _DATASETS[name](**kwargs)
