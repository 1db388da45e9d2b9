"""Search-space sampling and enumeration over the `V1Hp*` param specs, an
own copy of `polyaxon_tpu/tuner/space.py`.

Everything is numpy-seeded and deterministic: the same matrix and seed give
the JAX package's suggestions exactly."""

from __future__ import annotations

import itertools
import math
from typing import Any

import numpy as np

from ..schemas.matrix import DISCRETE_KINDS, V1HpParam


def grid_values(param: V1HpParam) -> list[Any]:
    """All values of a discrete param (grid enumeration)."""
    kind = param.kind
    if kind == "choice":
        return list(param.value)
    if kind == "pchoice":
        return [item for item, _p in param.value]
    if kind in ("range", "linspace", "logspace"):
        return param.to_list()
    raise ValueError(f"param kind {kind!r} is not discrete (one of {DISCRETE_KINDS})")


def sample(param: V1HpParam, rng: np.random.Generator) -> Any:
    """One random draw from any param kind."""
    kind, v = param.kind, param.value
    if kind == "choice":
        return v[int(rng.integers(len(v)))]
    if kind == "pchoice":
        items = [item for item, _ in v]
        probs = np.asarray([p for _, p in v], float)
        return items[int(rng.choice(len(items), p=probs / probs.sum()))]
    if kind in ("range", "linspace", "logspace"):
        values = grid_values(param)
        return values[int(rng.integers(len(values)))]
    if kind == "uniform":
        return float(rng.uniform(v["low"], v["high"]))
    if kind == "quniform":
        q = v.get("q", 1.0)
        return float(round(rng.uniform(v["low"], v["high"]) / q) * q)
    if kind == "loguniform":
        return float(math.exp(rng.uniform(v["low"], v["high"])))
    if kind == "normal":
        return float(rng.normal(v["loc"], v["scale"]))
    if kind == "lognormal":
        return float(math.exp(rng.normal(v["loc"], v["scale"])))
    raise ValueError(f"unknown param kind {kind!r}")


def sample_config(
    params: dict[str, V1HpParam], rng: np.random.Generator
) -> dict[str, Any]:
    return {name: sample(p, rng) for name, p in params.items()}


def grid_configs(params: dict[str, V1HpParam]) -> list[dict[str, Any]]:
    """Cartesian product in deterministic (sorted-name) order."""
    names = sorted(params)
    all_values = [grid_values(params[n]) for n in names]
    return [dict(zip(names, combo)) for combo in itertools.product(*all_values)]


# ------------------------------------------------------------- normalization
# For model-based search (bayes/TPE): map any param to/from [0,1]^k.
def param_bounds(param: V1HpParam):
    """(kind_class, lo, hi) for continuous params; None for discrete."""
    kind, v = param.kind, param.value
    if kind == "uniform" or kind == "quniform":
        return ("linear", v["low"], v["high"])
    if kind == "loguniform":
        return ("log", v["low"], v["high"])  # bounds already in log space
    if kind == "normal":
        return ("linear", v["loc"] - 3 * v["scale"], v["loc"] + 3 * v["scale"])
    if kind == "lognormal":
        return ("log", v["loc"] - 3 * v["scale"], v["loc"] + 3 * v["scale"])
    return None


def to_unit(param: V1HpParam, value: Any) -> float:
    """Encode a value into [0,1] (discrete → index position)."""
    bounds = param_bounds(param)
    if bounds is None:
        values = grid_values(param)
        try:
            i = values.index(value)
        except ValueError:
            i = 0
        return (i + 0.5) / len(values)
    kind, lo, hi = bounds
    x = math.log(value) if kind == "log" else float(value)
    if hi == lo:
        return 0.5
    return min(1.0, max(0.0, (x - lo) / (hi - lo)))


def from_unit(param: V1HpParam, u: float) -> Any:
    """Decode a [0,1] position back to a param value."""
    bounds = param_bounds(param)
    if bounds is None:
        values = grid_values(param)
        i = min(len(values) - 1, int(u * len(values)))
        return values[i]
    kind, lo, hi = bounds
    x = lo + u * (hi - lo)
    if kind == "log":
        return float(math.exp(x))
    if param.kind == "quniform":
        q = param.value.get("q", 1.0)
        return float(round(x / q) * q)
    return float(x)
