"""Polyaxonfile reading (`reader.py`) over the port's own YAML reader
(`yaml_lite.py`)."""

from .reader import (
    PolyaxonfileError,
    check_polyaxonfile,
    parse_cli_param,
    read_polyaxonfile,
    read_specs,
)

__all__ = [
    "PolyaxonfileError", "check_polyaxonfile", "parse_cli_param", "read_polyaxonfile",
    "read_specs",
]
