"""Execution environment (`V1Environment`): resources with the `tpu:`
block, scheduling hints, labels. An own copy of
`polyaxon_tpu/schemas/environment.py`: the `tpu:` block stays the YAML
surface (most Polyaxonfiles carry one), and the port reads from it only
the chip count a run asks for."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .base import Spec

TPU_TYPES = {
    "v4": {"cores_per_chip": 1, "max_topology": (4, 4, 4)},
    "v5e": {"cores_per_chip": 1, "max_topology": (16, 16)},
    "v5p": {"cores_per_chip": 1, "max_topology": (8, 8, 8)},
    "v6e": {"cores_per_chip": 1, "max_topology": (16, 16)},
}

CHIPS_PER_HOST = {"v4": 4, "v5e": 4, "v5p": 4, "v6e": 4}


@dataclasses.dataclass
class V1TpuSpec(Spec):
    """A slice request: `tpu: {type: v5e, topology: 4x8}` (or `count:`),
    `slices: N` for N identical slices."""

    type: str = "v5e"
    topology: Optional[str] = None
    count: Optional[int] = None
    megacore: Optional[bool] = None
    slices: Optional[int] = None

    @classmethod
    def _check_slices(cls, v: Optional[int]) -> Optional[int]:
        if v is not None and v < 1:
            raise ValueError(f"slices must be >= 1, got {v}")
        return v

    @classmethod
    def _check_count(cls, v: Optional[int]) -> Optional[int]:
        if v is not None and v < 1:
            raise ValueError(f"count must be >= 1, got {v}")
        return v

    @classmethod
    def _check_type(cls, v: str) -> str:
        if v not in TPU_TYPES:
            raise ValueError(f"unknown TPU type {v!r}; one of {sorted(TPU_TYPES)}")
        return v

    @classmethod
    def _check_topology(cls, v: Optional[str]) -> Optional[str]:
        if v is None:
            return v
        dims = v.lower().split("x")
        if not dims or not all(d.isdigit() and int(d) > 0 for d in dims):
            raise ValueError(f"bad topology {v!r}; expected e.g. '4x8' or '4x4x4'")
        return v.lower()

    def __post_init__(self):
        if self.topology is None and self.count is None:
            raise ValueError("tpu spec needs `topology` or `count`")
        if self.topology is not None and self.count is not None:
            raise ValueError(
                "tpu spec takes `topology` OR `count`, not both "
                f"(got topology={self.topology!r}, count={self.count})"
            )

    @property
    def dims(self) -> tuple[int, ...]:
        if self.topology:
            return tuple(int(d) for d in self.topology.split("x"))
        return (int(self.count),)

    @property
    def num_chips(self) -> int:
        """Chips in ONE slice."""
        return math.prod(self.dims)

    @property
    def num_hosts(self) -> int:
        return max(1, -(-self.num_chips // CHIPS_PER_HOST[self.type]))

    @property
    def num_slices(self) -> int:
        return self.slices or 1

    @property
    def total_chips(self) -> int:
        return self.num_chips * self.num_slices

    @property
    def total_hosts(self) -> int:
        return self.num_hosts * self.num_slices


@dataclasses.dataclass
class V1ResourceRequirements(Spec):
    limits: Optional[dict[str, float | int | str]] = None
    requests: Optional[dict[str, float | int | str]] = None


@dataclasses.dataclass
class V1Resources(Spec):
    """cpu/memory/gpu (kept for stock Polyaxonfiles), `chips:` (a plain
    accelerator count), `minChips:` (the elastic floor) and `tpu:`."""

    cpu: Optional[float | int | str] = None
    memory: Optional[str | int] = None
    gpu: Optional[int] = None
    chips: Optional[int] = None
    min_chips: Optional[int] = None
    tpu: Optional[V1TpuSpec] = None
    limits: Optional[dict[str, float | int | str]] = None
    requests: Optional[dict[str, float | int | str]] = None

    @classmethod
    def _check_chips(cls, v: Optional[int]) -> Optional[int]:
        if v is not None and v < 1:
            raise ValueError(f"chips must be >= 1, got {v}")
        return v

    def __post_init__(self):
        if self.min_chips is not None:
            if self.min_chips < 1:
                raise ValueError(f"minChips must be >= 1, got {self.min_chips}")
            full = self.tpu.total_chips if self.tpu is not None else self.chips
            if full is not None and self.min_chips > full:
                raise ValueError(
                    f"minChips {self.min_chips} exceeds the full request "
                    f"({full} chips) — the elastic range is minChips <= chips"
                )


@dataclasses.dataclass
class V1Environment(Spec):
    resources: Optional[V1Resources] = None
    labels: Optional[dict[str, str]] = None
    annotations: Optional[dict[str, str]] = None
    node_selector: Optional[dict[str, str]] = None
    node_name: Optional[str] = None
    tolerations: Optional[list[dict]] = None
    affinity: Optional[dict] = None
    service_account_name: Optional[str] = None
    priority_class_name: Optional[str] = None
    restart_policy: Optional[str] = None
    image_pull_secrets: Optional[list[str]] = None
    security_context: Optional[dict] = None
    host_network: Optional[bool] = None
    dns_policy: Optional[str] = None
