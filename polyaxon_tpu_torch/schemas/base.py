"""The spec base of the port's schemas: plain dataclasses with the
reference's YAML surface (`polyaxon_tpu/schemas/base.py` does this with
pydantic).

`Spec.from_dict` takes each key in snake_case or camelCase (`batchSize`,
`logEvery`) and rejects unknown keys, as the reference's `extra="forbid"`
does. Scalar fields keep what they are given (a `{{ params.x }}` template
stays a string); consumers convert them with int()/float(). A field named
in `_nested` is built from its dict by that spec class, and one named in
`_nested_lists` from each dict of its list. Cross-field rules run in each
spec's `__post_init__` and raise ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Union


def to_camel(s: str) -> str:
    parts = s.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _build(cls, value):
    return cls.from_dict(value) if isinstance(value, (dict, cls)) else value


class Spec:
    """`from_dict` for the dataclass specs."""

    _nested: ClassVar[dict[str, type]] = {}
    _nested_lists: ClassVar[dict[str, type]] = {}

    @classmethod
    def from_dict(cls, data: Union[dict, "Spec"]):
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
            if name in cls._nested and value is not None:
                value = _build(cls._nested[name], value)
            elif name in cls._nested_lists and isinstance(value, list):
                value = [_build(cls._nested_lists[name], v) for v in value]
            kwargs[name] = value
        try:
            return cls(**kwargs)
        except TypeError as e:  # a required field is missing
            raise ValueError(f"{cls.__name__}: {e}") from None
