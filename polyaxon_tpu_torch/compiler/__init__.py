"""The compiler: an operation with its params → a concrete
`CompiledOperation` (`resolver.py`), with the template interpolation
(`interpolation.py`) and contexts (`contexts.py`) it uses."""

from .contexts import build_context, build_globals, resolve_params
from .interpolation import CompilationError, has_template, interpolate, interpolate_str
from .resolver import CompiledOperation, apply_suggestion, compile_operation, spec_fingerprint

__all__ = [
    "CompilationError", "CompiledOperation", "apply_suggestion", "build_context",
    "build_globals", "compile_operation", "has_template", "interpolate", "interpolate_str",
    "resolve_params", "spec_fingerprint",
]
