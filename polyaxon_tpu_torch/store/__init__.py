"""The run store (own copies of `polyaxon_tpu/store/`): `RunStore` over the
crash-consistent event log, run timelines, and the CRC framing that the
event log and the serving spill tier share."""

from .local import RunStore, UnknownRunError, polyaxon_home  # noqa: F401
