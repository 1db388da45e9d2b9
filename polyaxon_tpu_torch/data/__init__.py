"""Data pipelines: `program.data.name` → an infinite iterator of numpy
batches (own copies of the reference's procedural token streams)."""

from . import synthetic  # noqa: F401  (registers the datasets)
from .registry import DataSpec, build_data, register_dataset

__all__ = ["DataSpec", "build_data", "register_dataset"]
