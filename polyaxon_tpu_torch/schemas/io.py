"""Inputs/outputs (`V1IO`) and param values (`V1Param`): an own copy of
`polyaxon_tpu/schemas/io.py` on the port's dataclass specs."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .base import Spec

IO_TYPES = {
    "int", "float", "bool", "str", "dict", "list", "path", "uri", "auth",
    "artifacts", "git", "image", "event", "dockerfile", "tensorboard",
    "datetime", "uuid",
}


@dataclasses.dataclass(kw_only=True)
class V1IO(Spec):
    name: str
    type: Optional[str] = None
    description: Optional[str] = None
    value: Optional[Any] = None
    is_optional: Optional[bool] = None
    is_list: Optional[bool] = None
    is_flag: Optional[bool] = None
    arg_format: Optional[str] = None
    connection: Optional[str] = None
    to_init: Optional[bool] = None
    to_env: Optional[str] = None
    options: Optional[list[Any]] = None

    @classmethod
    def _check_type(cls, v: Optional[str]) -> Optional[str]:
        if v is not None and v not in IO_TYPES:
            raise ValueError(f"unknown IO type {v!r}; one of {sorted(IO_TYPES)}")
        return v

    def validate_value(self, value: Any) -> Any:
        """Coerce/validate a concrete value against this IO's declared type."""
        if value is None:
            if self.is_optional or self.value is not None:
                return self.value
            raise ValueError(f"input {self.name!r} is required but no value given")
        t = self.type
        coercers = {"int": int, "float": float, "str": str}
        coerced = value
        if t == "bool":
            if isinstance(value, bool):
                coerced = value
            elif isinstance(value, str) and value.lower() in ("true", "1", "yes"):
                coerced = True
            elif isinstance(value, str) and value.lower() in ("false", "0", "no"):
                coerced = False
            else:
                raise ValueError(f"input {self.name!r}: cannot coerce {value!r} to bool")
        elif t in coercers:
            try:
                coerced = coercers[t](value)
            except (TypeError, ValueError) as e:
                raise ValueError(f"input {self.name!r}: cannot coerce {value!r} to {t}") from e
        elif t == "dict" and not isinstance(value, dict):
            raise ValueError(f"input {self.name!r}: expected dict, got {type(value)}")
        elif t == "list" and not isinstance(value, list):
            raise ValueError(f"input {self.name!r}: expected list, got {type(value)}")
        if self.options and coerced not in self.options:
            raise ValueError(f"input {self.name!r}: {coerced!r} not in options {self.options}")
        return coerced


@dataclasses.dataclass
class V1Param(Spec):
    """A param passed to an operation: a literal value or a ref."""

    value: Optional[Any] = None
    ref: Optional[str] = None
    context_only: Optional[bool] = None
    connection: Optional[str] = None
    to_init: Optional[bool] = None
