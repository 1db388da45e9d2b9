"""Fleet inventory and reservation ledger, an own copy of
`polyaxon_tpu/scheduler/fleet.py`: the control plane's model of what
hardware exists and who holds it.

- **DeviceInventory**: capacity from a `tpu: {topology: NxM}`-style spec
  (`fleet init --topology 4x8`) or a chip count, or the card's CUDA
  devices (`from_devices`; one on the CPU path). With a topology,
  reservations are axis-aligned sub-blocks of the grid (`topology.py`'s
  block math, shared with the tuner's placement); without one, the fleet
  is a flat pool of N chips.
- **ReservationLedger**: all-or-nothing gang reservations persisted in the
  store (`<home>/fleet/reservations.json`, fcntl-locked): a gang gets its
  whole slice or nothing. Released on every terminal status transition
  (`store/local.py`), so a crashed agent cannot leak chips past its runs.
- **Fleet**: the facade the agent and admission talk to: configure,
  reserve, release, usage, snapshot (the `/fleetz` body), and the
  `fleet.chips_{total,reserved}` gauges on the port's telemetry registry.

A fleet is opt-in: with no `<home>/fleet/config.json` the agent keeps its
concurrency-only gating. The files are the reference's, so a store either
package wrote reads back in the other.
"""

from __future__ import annotations

import fcntl
import json
import math
import os
from pathlib import Path
from typing import Any, Optional

from ..store.local import RunStore
from ..schemas.environment import V1TpuSpec
from .topology import grid_blocks, parse_topology


def chips_demand(spec: Any) -> int:
    """Chip demand of an operation/component/compiled-spec-shaped object.

    Resolution order: `resources.tpu.total_chips` (a topology request) →
    `resources.chips` (any-N-free-chips request) → 1 (every admitted run
    occupies at least one chip slot — a zero-cost run would make quota
    and capacity accounting meaningless).

    Accepts a V1Operation, a V1Component/run holder, or the stored spec
    dict; looks at op-level environment first, then the component run's.
    """
    for env in _environments(spec):
        resources = _get(env, "resources")
        if resources is None:
            continue
        tpu = _get(resources, "tpu")
        if tpu is not None:
            if hasattr(tpu, "total_chips"):
                return int(tpu.total_chips)
            return int(V1TpuSpec.from_dict(tpu).total_chips)
        chips = _get(resources, "chips")
        if chips:
            return int(chips)
    return 1


def min_chips_demand(spec: Any) -> Optional[int]:
    """The elastic floor (`resources.minChips`), or None when the run is
    rigid. Capped at the full demand — a floor above the request is a spec
    error the schema already rejects, but stored dicts are unchecked."""
    for env in _environments(spec):
        resources = _get(env, "resources")
        if resources is None:
            continue
        floor = _get(resources, "min_chips")
        if floor is None and isinstance(resources, dict):
            floor = resources.get("minChips")
        if floor:
            return min(int(floor), chips_demand(spec))
    return None


def shrink_candidates(
    chips: int,
    block: Optional[tuple[int, ...]],
    min_chips: int,
) -> list[tuple[int, Optional[tuple[int, ...]]]]:
    """The halving ladder strictly below the full request, floored at
    `min_chips`: each rung halves the block's largest axis (topology
    requests) or the chip count (flat requests), so gradient-accumulation
    rescaling stays integral and sub-blocks keep tiling the torus."""
    out: list[tuple[int, Optional[tuple[int, ...]]]] = []
    if block is not None:
        cur = list(block)
        while math.prod(cur) // 2 >= min_chips:
            axis = max(range(len(cur)), key=lambda i: cur[i])
            if cur[axis] % 2:
                break
            cur[axis] //= 2
            out.append((math.prod(cur), tuple(cur)))
    else:
        c = chips // 2
        while c >= min_chips:
            out.append((c, None))
            c //= 2
    return out


def topology_request(spec: Any) -> Optional[tuple[int, ...]]:
    """The requested ICI block shape, when the run pins one (`tpu:
    {topology: ...}`); None for count/chips requests."""
    for env in _environments(spec):
        resources = _get(env, "resources")
        tpu = _get(resources, "tpu") if resources is not None else None
        if tpu is not None:
            topo = _get(tpu, "topology")
            parsed = parse_topology(topo)
            if parsed is not None:
                slices = _get(tpu, "slices") or 1
                if int(slices) > 1:
                    # multi-slice gangs span DCN: each slice is its own ICI
                    # block, but the local inventory models one slice's
                    # torus — fall back to a flat chip-count grab.
                    return None
                return parsed
    return None


def _environments(spec: Any):
    """Yield candidate environment holders: op-level, then component run."""
    env = _get(spec, "environment")
    if env is not None:
        yield env
    component = _get(spec, "component")
    run = _get(component, "run") if component is not None else _get(spec, "run")
    if run is not None:
        env = _get(run, "environment")
        if env is not None:
            yield env


def _get(obj: Any, key: str):
    if obj is None:
        return None
    if isinstance(obj, dict):
        return obj.get(key)
    return getattr(obj, key, None)


class DeviceInventory:
    """What hardware exists, as reservable chip slots.

    With a torus topology, chips are coordinates and a topology-pinned
    gang must land on an axis-aligned block whose dims divide the torus
    (tiling origins only — reservations can never fragment the torus into
    un-tileable leftovers). Flat-count requests take any free chips in
    lexicographic order."""

    def __init__(
        self,
        topology: Optional[tuple[int, ...]] = None,
        chips: Optional[int] = None,
    ):
        if topology is not None:
            self.topology = tuple(int(t) for t in topology)
            self.total = math.prod(self.topology)
        elif chips is not None:
            if chips < 1:
                raise ValueError(f"inventory needs >= 1 chip, got {chips}")
            self.topology = None
            self.total = int(chips)
        else:
            raise ValueError("inventory needs a topology or a chip count")

    @classmethod
    def from_devices(cls, devices: Optional[list] = None) -> "DeviceInventory":
        """A flat pool of `devices`; by default the card's CUDA devices
        (`POLYAXON_TORCH_DEVICE` unset), or one chip on the CPU path."""
        if devices is None:
            from ..device import env_device, resolve_device, visible_gpus

            dev = resolve_device(env_device())
            devices = range(visible_gpus()) if dev.type == "cuda" else [dev]
        return cls(chips=max(1, len(devices)))

    # ------------------------------------------------------------ placement
    def _all_coords(self) -> list[tuple]:
        if self.topology is None:
            return [(i,) for i in range(self.total)]
        import itertools

        return list(itertools.product(*[range(t) for t in self.topology]))

    def place(
        self,
        chips: int,
        used: set,
        block: Optional[tuple[int, ...]] = None,
    ) -> Optional[list[tuple]]:
        """Coordinates for a new reservation, or None when it cannot fit
        RIGHT NOW (all-or-nothing: never a partial list).

        `block` pins an ICI sub-grid shape; it must legally tile the torus
        (checked by `fits`, which callers run first to distinguish
        'never fits' from 'not now')."""
        if chips > self.total - len(used):
            return None
        if block is not None and self.topology is not None:
            padded = tuple(block) + (1,) * (len(self.topology) - len(block))
            if any(t % b for t, b in zip(self.topology, padded)):
                return None
            for coords in grid_blocks(self.topology, padded):
                if not (set(coords) & used):
                    return coords
            return None
        free = [c for c in self._all_coords() if c not in used]
        if len(free) < chips:
            return None
        return free[:chips]

    def fits(self, chips: int, block: Optional[tuple[int, ...]] = None) -> bool:
        """Could this request EVER be placed on an empty fleet? False means
        the run is UNSCHEDULABLE under the current inventory, not merely
        queued behind other tenants."""
        if chips > self.total:
            return False
        if block is not None:
            if self.topology is None:
                # no torus model: a block request degrades to its chip count
                return math.prod(block) <= self.total
            padded = tuple(block) + (1,) * (len(self.topology) - len(block))
            if len(block) > len(self.topology):
                return False
            return all(t % b == 0 for t, b in zip(self.topology, padded))
        return True


class ReservationLedger:
    """Persisted gang reservations: `<home>/fleet/reservations.json`,
    one fcntl-locked read-modify-write per mutation so a CLI, an agent,
    and the streams server on the same store always agree."""

    def __init__(self, home: Path):
        self.dir = Path(home) / "fleet"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "reservations.json"
        self._lock_path = self.dir / "reservations.lock"

    def _locked(self, fn):
        """Run `fn(data) -> (result, new_data_or_None)` under the ledger
        lock. `None` for new_data means "unchanged" and skips the
        rewrite — admission probes a reservation attempt for every queued
        entry, and a failed placement must not pay a full-state write."""
        with open(self._lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                data = self._read()
                result, new_data = fn(data)
                if new_data is not None:
                    tmp = self.path.with_suffix(".json.tmp")
                    tmp.write_text(json.dumps(new_data, indent=1))
                    os.replace(tmp, self.path)
                return result
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def _read(self) -> dict:
        try:
            return json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}

    def all(self) -> dict[str, dict]:
        return self._read()

    def get(self, run_uuid: str) -> Optional[dict]:
        return self._read().get(run_uuid)

    def add(self, run_uuid: str, record: dict) -> None:
        def fn(data):
            data[run_uuid] = record
            return None, data

        self._locked(fn)

    def remove(self, run_uuid: str) -> Optional[dict]:
        def fn(data):
            if run_uuid not in data:
                return None, None
            return data.pop(run_uuid), data

        return self._locked(fn)

    def used_coords(self) -> set:
        return {
            tuple(c) for rec in self._read().values() for c in rec["coords"]
        }


class Fleet:
    """The agent/admission facade over inventory + ledger for one store."""

    def __init__(self, store: Optional[RunStore] = None, clock=None):
        from .clock import WALL

        self.store = store or RunStore()
        self.clock = clock or WALL
        self.dir = Path(self.store.home) / "fleet"
        self.config_path = self.dir / "config.json"
        self.ledger = ReservationLedger(self.store.home)

    # ------------------------------------------------------------- config
    def configure(
        self,
        topology: Optional[str] = None,
        chips: Optional[int] = None,
    ) -> dict:
        """Persist the fleet's capacity (`fleet init`). Topology wins;
        `chips` describes a flat pool; neither = the devices of this
        process at init time (`DeviceInventory.from_devices`), frozen into
        the config so admission never depends on which process asks."""
        if topology is not None and parse_topology(topology) is None:
            raise ValueError(f"bad topology {topology!r}; expected e.g. '4x8'")
        if topology is None and chips is None:
            chips = DeviceInventory.from_devices().total
        cfg = {}
        if topology is not None:
            cfg["topology"] = topology.lower()
        else:
            cfg["chips"] = int(chips)
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.config_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(cfg, indent=1))
        os.replace(tmp, self.config_path)
        self._emit_gauges()
        return cfg

    def config(self) -> Optional[dict]:
        try:
            return json.loads(self.config_path.read_text())
        except (OSError, json.JSONDecodeError):
            return None

    @property
    def configured(self) -> bool:
        return self.config() is not None

    def inventory(self) -> Optional[DeviceInventory]:
        cfg = self.config()
        if cfg is None:
            return None
        topo = parse_topology(cfg.get("topology"))
        if topo is not None:
            return DeviceInventory(topology=topo)
        return DeviceInventory(chips=int(cfg.get("chips", 1)))

    # ------------------------------------------------------- reservations
    def reserve(
        self,
        run_uuid: str,
        *,
        chips: int,
        block: Optional[tuple[int, ...]] = None,
        project: str = "default",
        queue: str = "default",
        priority: int = 0,
        requested_chips: Optional[int] = None,
        requested_block: Optional[tuple[int, ...]] = None,
    ) -> Optional[dict]:
        """All-or-nothing gang reservation: the whole slice or None.
        Idempotent per run (re-reserving returns the existing record).
        `requested_chips`/`requested_block` record the FULL elastic demand
        when `chips` is a shrunk grant, so the expansion pass can see which
        reservations are running below their ask."""
        inv = self.inventory()
        if inv is None:
            return None

        def fn(data):
            if run_uuid in data:
                return data[run_uuid], None
            used = {tuple(c) for rec in data.values() for c in rec["coords"]}
            coords = inv.place(chips, used, block=block)
            if coords is None:
                return None, None
            record = {
                "uuid": run_uuid,
                "chips": chips,
                "coords": [list(c) for c in coords],
                "block": list(block) if block else None,
                "project": project,
                "queue": queue,
                "priority": int(priority),
                "reserved_at": self.clock.time(),
            }
            if requested_chips is not None and requested_chips != chips:
                record["requested_chips"] = int(requested_chips)
                record["requested_block"] = (
                    list(requested_block) if requested_block else None
                )
            data[run_uuid] = record
            return record, data

        record = self.ledger._locked(fn)
        if record is not None:
            self._emit_gauges()
        return record

    def release(self, run_uuid: str) -> Optional[dict]:
        record = self.ledger.remove(run_uuid)
        if record is not None:
            self._emit_gauges()
        return record

    def reserved_chips(self) -> int:
        return sum(int(r["chips"]) for r in self.ledger.all().values())

    def usage(self) -> dict[str, dict]:
        """Per-project {chips, runs} currently reserved."""
        out: dict[str, dict] = {}
        for rec in self.ledger.all().values():
            row = out.setdefault(rec["project"], {"chips": 0, "runs": 0})
            row["chips"] += int(rec["chips"])
            row["runs"] += 1
        return out

    # ----------------------------------------------------------- surfaces
    def snapshot(self) -> dict:
        """The `/fleetz` body: inventory, reservations, per-project usage
        vs quota."""
        from .admission import QuotaManager

        cfg = self.config()
        inv = self.inventory()
        reservations = sorted(
            self.ledger.all().values(), key=lambda r: r.get("reserved_at", 0)
        )
        reserved = sum(int(r["chips"]) for r in reservations)
        quotas = QuotaManager(self.store).all()
        usage = self.usage()
        projects = {}
        for name in sorted(set(usage) | {q.scope_name for q in quotas
                                         if not q.is_queue_scope}):
            quota = next(
                (q for q in quotas
                 if not q.is_queue_scope and q.scope_name == name),
                None,
            )
            projects[name] = {
                "chips": usage.get(name, {}).get("chips", 0),
                "runs": usage.get(name, {}).get("runs", 0),
                "quota": quota.to_dict() if quota else None,
            }
        return {
            "configured": cfg is not None,
            "config": cfg,
            "chips_total": inv.total if inv else 0,
            "chips_reserved": reserved,
            "chips_free": (inv.total - reserved) if inv else 0,
            "reservations": reservations,
            "projects": projects,
        }

    def _emit_gauges(self) -> None:
        from ..telemetry import get_registry

        inv = self.inventory()
        if inv is None:
            return
        reg = get_registry()
        reg.gauge(
            "fleet.chips_total", help="Chips in the fleet inventory"
        ).set(inv.total)
        reg.gauge(
            "fleet.chips_reserved", help="Chips held by gang reservations"
        ).set(self.reserved_chips())
