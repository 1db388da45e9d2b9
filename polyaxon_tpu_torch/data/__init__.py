"""Data pipelines: `program.data.name` → an infinite iterator of numpy
batches. Own copies of the reference's procedural streams (`synthetic.py`:
classification images and vectors, token streams, the seq2seq reversal
task) and of its file-backed pipelines (`files.py`: memory-
mapped token corpora, with the native prefetch loader, and .npy array
datasets)."""

from . import files  # noqa: F401  (registers token_file/array_file)
from . import synthetic  # noqa: F401  (registers the procedural streams)
from .registry import DataSpec, build_data, register_dataset

__all__ = ["DataSpec", "build_data", "register_dataset"]
