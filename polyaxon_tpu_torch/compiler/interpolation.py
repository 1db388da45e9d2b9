"""`{{ expr }}` template interpolation over nested spec structures.

An own copy of `polyaxon_tpu/compiler/interpolation.py`.
Behavior:
- a string that is EXACTLY one template (`"{{ params.lr }}"`) resolves to the
  *typed* context value (float stays float), so templated numeric spec fields
  compile to concrete numbers;
- embedded templates (`"run-{{ globals.uuid }}"`) string-substitute;
- dotted paths walk dicts and object attributes;
- unknown references raise CompilationError listing what's available.
"""

from __future__ import annotations

import re
from typing import Any


class CompilationError(Exception):
    pass


_TEMPLATE_RE = re.compile(r"\{\{\s*([^{}]+?)\s*\}\}")


def _lookup(path: str, context: dict[str, Any]) -> Any:
    parts = path.split(".")
    cur: Any = context
    for i, part in enumerate(parts):
        if isinstance(cur, dict):
            if part not in cur:
                where = ".".join(parts[:i]) or "context"
                avail = sorted(cur.keys()) if isinstance(cur, dict) else []
                raise CompilationError(
                    f"unknown reference {path!r}: {part!r} not found in {where} "
                    f"(available: {avail})"
                )
            cur = cur[part]
        elif isinstance(cur, (list, tuple)) and part.isdigit():
            idx = int(part)
            if idx >= len(cur):
                raise CompilationError(f"unknown reference {path!r}: index {idx} out of range")
            cur = cur[idx]
        elif hasattr(cur, part):
            cur = getattr(cur, part)
        else:
            raise CompilationError(
                f"unknown reference {path!r}: cannot resolve {part!r} on {type(cur).__name__}"
            )
    return cur


def interpolate_str(s: str, context: dict[str, Any]) -> Any:
    """Resolve templates in one string (typed if the whole string is one template)."""
    m = _TEMPLATE_RE.fullmatch(s.strip())
    if m:
        return _lookup(m.group(1).strip(), context)

    def _sub(match: re.Match) -> str:
        val = _lookup(match.group(1).strip(), context)
        return str(val)

    return _TEMPLATE_RE.sub(_sub, s)


def interpolate(obj: Any, context: dict[str, Any]) -> Any:
    """Recursively resolve templates in a nested dict/list/str structure."""
    if isinstance(obj, str):
        return interpolate_str(obj, context)
    if isinstance(obj, dict):
        return {k: interpolate(v, context) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [interpolate(v, context) for v in obj]
    return obj


def has_template(obj: Any) -> bool:
    if isinstance(obj, str):
        return _TEMPLATE_RE.search(obj) is not None
    if isinstance(obj, dict):
        return any(has_template(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(has_template(v) for v in obj)
    return False
