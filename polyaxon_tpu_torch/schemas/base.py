"""The spec base of the port's schemas: plain dataclasses with the
reference's YAML surface and validation (`polyaxon_tpu/schemas/base.py`
does this with pydantic, which the port does not depend on).

`Spec.from_dict` validates a dict the way the reference's
`model_validate` does, field by field in declaration order:

- each key in snake_case or camelCase (`batchSize`, `logEvery`); an
  unknown key is refused (the reference's `extra="forbid"`);
- each value against its annotation, with pydantic's lax coercions: an
  `int` takes `1.0`, `True` and `" 5 "`, a `float` takes `1` and `"1e-3"`,
  a `bool` takes `1`, `"yes"` and `"off"`, a `str` takes only strings. A
  union is "smart": a member the value already is wins, then the first
  member that takes it strictly, then the first that takes it laxly, so
  `int | str` keeps a `{{ params.x }}` template as a string and `"5"` as
  the string "5". A `Tagged` union picks its member by the `kind` key;
- `_before_<field>` (a classmethod) runs before a field's own check and
  `_check_<field>` after it; `__post_init__` holds the cross-field rules
  (the reference's `model_validator(mode="after")`), so direct
  construction runs them too.

Every failure raises `SpecError` (a ValueError) listing `loc: message`
pairs with the reference's wording ("Field required", "Extra inputs are
not permitted", "Value error, ..."). `to_dict()` is the reference's
`model_dump(by_alias=True, exclude_none=True, mode="json")`: camelCase
keys in field order, None fields left out, nested specs dumped.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import enum
import functools
import math
import re
import types
import typing
from typing import Any, Union


def to_camel(s: str) -> str:
    parts = s.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


class SpecError(ValueError):
    """Validation failures as (location, message) pairs."""

    def __init__(self, errors: list[tuple[tuple, str]]):
        self.errors = errors
        super().__init__("; ".join(
            f"{'.'.join(str(x) for x in loc)}: {msg}" if loc else msg for loc, msg in errors
        ))


class Tagged:
    """Marks a union (`Annotated[Union[...], Tagged("kind")]`) whose member
    is chosen by the value of `key`, each member's `Literal` default."""

    def __init__(self, key: str):
        self.key = key


class _Invalid(Exception):
    def __init__(self, errors: list[tuple[tuple, str]]):
        self.errors = errors


_BOOL_STRINGS = {
    "true": True, "false": False, "yes": True, "no": False, "on": True,
    "off": False, "1": True, "0": False, "t": True, "f": False, "y": True, "n": False,
}
_INT_STRING = re.compile(r"^[+-]?[0-9]+(?:\.0*)?$")


def _fail(loc, msg):
    raise _Invalid([(loc, msg)])


def _check_int(v, loc, strict):
    if type(v) is int:
        return v, True
    if strict:
        _fail(loc, "Input should be a valid integer")
    if isinstance(v, bool):
        return int(v), False
    if isinstance(v, float):
        if not math.isfinite(v):
            _fail(loc, "Input should be a finite number")
        if not v.is_integer():
            _fail(loc, "Input should be a valid integer, got a number with a fractional part")
        return int(v), False
    if isinstance(v, str):
        s = v.strip()
        if _INT_STRING.match(s):
            return int(s.split(".")[0]), False
        _fail(loc, "Input should be a valid integer, unable to parse string as an integer")
    _fail(loc, "Input should be a valid integer")


def _check_float(v, loc, strict):
    if type(v) is float:
        return v, True
    if type(v) is int:
        return float(v), False
    if strict:
        _fail(loc, "Input should be a valid number")
    if isinstance(v, bool):
        return float(v), False
    if isinstance(v, str):
        s = v.strip()
        try:
            if "_" in s:
                raise ValueError
            return float(s), False
        except ValueError:
            _fail(loc, "Input should be a valid number, unable to parse string as a number")
    _fail(loc, "Input should be a valid number")


def _check_bool(v, loc, strict):
    if isinstance(v, bool):
        return v, True
    if strict:
        _fail(loc, "Input should be a valid boolean")
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v), False
    if isinstance(v, str) and v.lower() in _BOOL_STRINGS:
        return _BOOL_STRINGS[v.lower()], False
    if isinstance(v, str) or type(v) is int:
        _fail(loc, "Input should be a valid boolean, unable to interpret input")
    _fail(loc, "Input should be a valid boolean")


def _check_str(v, loc, strict):
    if isinstance(v, str):
        return v, True
    _fail(loc, "Input should be a valid string")


_SCALARS = {int: _check_int, float: _check_float, bool: _check_bool, str: _check_str}


def _validate(hint, v, loc: tuple, strict: bool = False):
    """(validated value, exact) of `v` against `hint`; raises _Invalid."""
    if hint is Any or hint is object:
        return v, True
    if hint is type(None):
        if v is None:
            return None, True
        _fail(loc, "Input should be None")
    origin = typing.get_origin(hint) or (hint if hint in (list, dict) else None)
    if origin is typing.Annotated:
        base, *extras = typing.get_args(hint)
        tag = next((e for e in extras if isinstance(e, Tagged)), None)
        if tag is not None:
            return _validate_tagged(base, tag.key, v, loc, strict)
        return _validate(base, v, loc, strict)
    if origin in (Union, types.UnionType):
        return _validate_union(typing.get_args(hint), v, loc, strict)
    if hint in _SCALARS:
        return _SCALARS[hint](v, loc, strict)
    if origin is typing.Literal:
        choices = typing.get_args(hint)
        if any(v == c and type(v) is type(c) for c in choices):
            return v, True
        _fail(loc, "Input should be " + " or ".join(
            ", ".join(repr(c) for c in choices).rsplit(", ", 1)))
    if origin is list:
        if not isinstance(v, list) and (strict or not isinstance(v, (tuple, set, frozenset))):
            _fail(loc, "Input should be a valid list")
        (item,) = typing.get_args(hint) or (Any,)
        out, errors, exact = [], [], isinstance(v, list)
        for i, x in enumerate(v):
            try:
                y, e = _validate(item, x, loc + (i,), strict)
                out.append(y)
                exact = exact and e
            except _Invalid as err:
                errors.extend(err.errors)
        if errors:
            raise _Invalid(errors)
        return out, exact
    if origin is dict:
        if not isinstance(v, dict):
            _fail(loc, "Input should be a valid dictionary")
        kt, vt = typing.get_args(hint) or (Any, Any)
        out, errors, exact = {}, [], True
        for k, x in v.items():
            try:
                kk, ek = _validate(kt, k, loc + (k,), strict)
                xx, ex = _validate(vt, x, loc + (k,), strict)
                out[kk] = xx
                exact = exact and ek and ex
            except _Invalid as err:
                errors.extend(err.errors)
        if errors:
            raise _Invalid(errors)
        return out, exact
    if isinstance(hint, type) and issubclass(hint, Spec):
        if isinstance(v, hint):
            return v, True
        if not isinstance(v, dict):
            _fail(loc, f"Input should be a valid dictionary or instance of {hint.__name__}")
        try:
            return hint._from_dict(v, loc, strict), False
        except SpecError as e:
            raise _Invalid(e.errors) from None
    raise TypeError(f"no validation for annotation {hint!r}")


def _validate_union(members, v, loc, strict):
    if v is None and type(None) in members:
        return None, True
    members = [m for m in members if m is not type(None)]
    first_error = None
    best = None
    for m in members:  # strict pass: an exact member wins outright
        try:
            out, exact = _validate(m, v, loc, True)
        except _Invalid as e:
            first_error = first_error or e
            continue
        if exact:
            return out, True
        if best is None:
            best = out
    if best is not None:
        return best, False
    if not strict:
        for m in members:
            try:
                return _validate(m, v, loc, False)[0], False
            except _Invalid as e:
                first_error = first_error or e
    raise first_error or _Invalid([(loc, "Input should be None")])


def _tag_of(member) -> Any:
    f = {f.name: f for f in dataclasses.fields(member)}
    return f["kind"].default


def _validate_tagged(union, key, v, loc, strict):
    members = {_tag_of(m): m for m in typing.get_args(union)}
    if isinstance(v, tuple(members.values())):
        return v, True
    if not isinstance(v, dict):
        _fail(loc, "Input should be a valid dictionary or object to extract fields from")
    tag = v.get(key)
    if key not in v:
        _fail(loc, f"Unable to extract tag using discriminator '{key}'")
    try:
        member = members.get(tag)
    except TypeError:
        member = None
    if member is None:
        expected = ", ".join(repr(t) for t in members)
        _fail(loc, f"Input tag {tag!r} found using '{key}' does not match any of the "
                   f"expected tags: {expected}")
    return _validate(member, v, loc + (tag,), strict)


@functools.cache
def _hints(cls) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls, include_extras=True)
    return {k: v for k, v in hints.items() if k in names}


class Spec:
    """`from_dict`, `to_dict` and `copy` for the dataclass specs."""

    @classmethod
    def from_dict(cls, data: Union[dict, "Spec"]):
        if isinstance(data, cls):
            return data
        return cls._from_dict(data, (), False)

    @classmethod
    def _from_dict(cls, data, loc: tuple, strict: bool):
        if not isinstance(data, dict):
            raise SpecError([(loc, f"Input should be a valid dictionary or instance of "
                                   f"{cls.__name__}")])
        fields = dataclasses.fields(cls)
        hints = _hints(cls)
        aliases = {to_camel(f.name): f.name for f in fields}
        names = {f.name for f in fields}
        given: dict[str, Any] = {}
        errors: list[tuple[tuple, str]] = []
        for key, value in data.items():
            name = aliases.get(key) if isinstance(key, str) else None
            if name is None and isinstance(key, str) and key in names:
                name = key
            if name is None or name in given:
                errors.append((loc + (key,), "Extra inputs are not permitted"))
                continue
            given[name] = value
        kwargs: dict[str, Any] = {}
        for f in fields:
            floc = loc + (to_camel(f.name),)
            if f.name not in given:
                if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:
                    errors.append((floc, "Field required"))
                continue
            value = given[f.name]
            try:
                before = getattr(cls, f"_before_{f.name}", None)
                if before is not None:
                    value = before(value)
                value, _ = _validate(hints[f.name], value, floc, strict)
                check = getattr(cls, f"_check_{f.name}", None)
                if check is not None:
                    try:
                        value = check(value)
                    except ValueError as e:
                        raise _Invalid([(floc, f"Value error, {e}")]) from None
                kwargs[f.name] = value
            except _Invalid as e:
                errors.extend(e.errors)
        if errors:
            raise SpecError(errors)
        try:
            return cls(**kwargs)
        except SpecError:
            raise
        except ValueError as e:
            raise SpecError([(loc, f"Value error, {e}")]) from None

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is not None:
                out[to_camel(f.name)] = _dump(value)
        return out

    def copy(self, **update):
        """A shallow copy with `update` set, unvalidated (the reference's
        `model_copy(update=...)`)."""
        new = copy.copy(self)
        for k, v in update.items():
            setattr(new, k, v)
        return new


def _dump(value):
    if isinstance(value, Spec):
        return value.to_dict()
    if isinstance(value, dict):
        return {k: _dump(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_dump(v) for v in value]
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (datetime.date, datetime.datetime)):
        return value.isoformat()
    return value
