"""Admission control, an own copy of `polyaxon_tpu/scheduler/admission.py`:
quotas, gang admission, backfill and priority preemption for the fleet
scheduler (`fleet.py`).

- **QuotaManager**: per-project (`scope: team-a`) and per-queue (`scope:
  queue:bulk`) `V1QuotaSpec` limits on reserved chips and concurrent runs,
  persisted at `<home>/fleet/quotas.json`. At equal priority candidates
  admit in fair-share order: smallest reserved_chips/weight first.
- **Gang admission**: a run's whole slice (topology block or chip count) is
  reserved all-or-nothing; a gang that cannot fit now stays QUEUED, one
  that can never fit (bigger than the fleet, or than its quota ceiling)
  goes UNSCHEDULABLE.
- **Backfill**: the claim scan walks past a blocked gang, so small runs
  slot into holes; the gang keeps its place and is tried first every pass.
- **Priority preemption**: a higher-priority gang that cannot fit picks
  the cheapest set of lower-priority running victims (fewest chips, least
  important first) and flags them (`preempt_requested`); the executor
  checkpoints each at its next step boundary, releases its chips and
  requeues it at its original priority, and it resumes from the
  checkpoint.
- **Elastic grants**: a run with `minChips` walks the halving ladder
  (`shrink_candidates`) down to its floor, and `consider_expansion` flags
  a shrunk run for requeue once its full request fits again.

All timing goes through `clock.py`, so the same controller runs
deterministically under `SimClock` (`sim.py`).
"""

from __future__ import annotations

import fcntl
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from ..schemas.quota import V1QuotaSpec
from ..store.local import RunStore
from ..telemetry import get_registry
from .fleet import (
    Fleet,
    chips_demand,
    min_chips_demand,
    shrink_candidates,
    topology_request,
)

# queue-wait-shaped buckets, in milliseconds: 1ms .. 10min
QUEUE_WAIT_BUCKETS_MS: tuple[float, ...] = (
    1, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
    10000, 30000, 60000, 300000, 600000,
)

ADMIT = "admit"
WAIT = "wait"
REJECT = "reject"


@dataclass
class Decision:
    outcome: str  # ADMIT | WAIT | REJECT
    reason: str = ""
    reservation: Optional[dict] = None
    preempt: list = field(default_factory=list)  # victim uuids requested


class QuotaManager:
    """CRUD + admission checks over `<home>/fleet/quotas.json`."""

    def __init__(self, store: Optional[RunStore] = None):
        self.store = store or RunStore()
        self.dir = Path(self.store.home) / "fleet"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "quotas.json"
        self._lock_path = self.dir / "quotas.lock"

    def _read(self) -> dict[str, dict]:
        try:
            return json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}

    def all(self) -> list[V1QuotaSpec]:
        return [V1QuotaSpec.from_dict(v) for v in self._read().values()]

    def get(self, scope: str) -> Optional[V1QuotaSpec]:
        raw = self._read().get(scope)
        return V1QuotaSpec.from_dict(raw) if raw else None

    def set(self, spec: V1QuotaSpec) -> None:
        with open(self._lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                data = self._read()
                data[spec.scope] = spec.to_dict()
                tmp = self.path.with_suffix(".json.tmp")
                tmp.write_text(json.dumps(data, indent=1))
                os.replace(tmp, self.path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def remove(self, scope: str) -> bool:
        with open(self._lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                data = self._read()
                found = data.pop(scope, None) is not None
                tmp = self.path.with_suffix(".json.tmp")
                tmp.write_text(json.dumps(data, indent=1))
                os.replace(tmp, self.path)
                return found
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    # ------------------------------------------------------------ checks
    def scopes_for(self, project: str, queue: str) -> list[V1QuotaSpec]:
        out = []
        for scope in (project, f"queue:{queue}"):
            q = self.get(scope)
            if q is not None:
                out.append(q)
        return out

    def check(
        self,
        project: str,
        queue: str,
        chips: int,
        usage: dict[str, dict],
    ) -> tuple[str, str]:
        """(outcome, reason) for admitting `chips` more for this tenant
        given current per-scope usage {scope: {chips, runs}}. REJECT means
        the request can NEVER pass this quota (ceiling too low); WAIT
        means it is over quota only because of what is running now."""
        for q in self.scopes_for(project, queue):
            used = usage.get(q.scope, {"chips": 0, "runs": 0})
            if q.max_chips is not None and chips > q.max_chips:
                return REJECT, (
                    f"requests {chips} chips but quota {q.scope!r} "
                    f"caps at {q.max_chips}"
                )
            if q.max_runs is not None and q.max_runs == 0:
                return REJECT, f"quota {q.scope!r} admits no runs (maxRuns=0)"
            if (
                q.max_chips is not None
                and used["chips"] + chips > q.max_chips
            ):
                return WAIT, (
                    f"quota {q.scope!r}: {used['chips']}/{q.max_chips} "
                    f"chips in use"
                )
            if q.max_runs is not None and used["runs"] + 1 > q.max_runs:
                return WAIT, (
                    f"quota {q.scope!r}: {used['runs']}/{q.max_runs} "
                    f"runs in flight"
                )
        return ADMIT, ""

    def weight(self, project: str) -> float:
        q = self.get(project)
        return q.weight if q is not None else 1.0


class AdmissionController:
    """One decision point between the queue and the executor."""

    def __init__(
        self,
        store: Optional[RunStore] = None,
        fleet: Optional[Fleet] = None,
        quotas: Optional[QuotaManager] = None,
        clock=None,
    ):
        from .clock import WALL

        self.store = store or RunStore()
        self.clock = clock or WALL
        self.fleet = fleet or Fleet(self.store, clock=self.clock)
        self.quotas = quotas or QuotaManager(self.store)

    @property
    def active(self) -> bool:
        """Admission gates claims only when a fleet is configured; without
        one the agent keeps its original concurrency-only behavior."""
        return self.fleet.configured

    # ------------------------------------------------------------ demand
    @staticmethod
    def demand(entry: dict) -> tuple[int, Optional[tuple[int, ...]]]:
        """(chips, block) an entry asks for. Uses the values the agent
        stamped at submit time; falls back to re-deriving from the payload
        operation (requeued/legacy entries)."""
        chips = entry.get("chips")
        block = entry.get("block")
        if chips is not None:
            return int(chips), tuple(block) if block else None
        op = (entry.get("payload") or {}).get("operation") or {}
        return chips_demand(op), topology_request(op)

    @staticmethod
    def min_demand(entry: dict) -> Optional[int]:
        """The elastic floor, or None for a rigid run. Stamped at submit
        time like `chips`; re-derived from the payload for legacy
        entries."""
        floor = entry.get("min_chips")
        if floor is not None:
            return int(floor)
        op = (entry.get("payload") or {}).get("operation") or {}
        return min_chips_demand(op)

    # ------------------------------------------------------------- order
    def order(self, entries: list[dict]) -> list[dict]:
        """Claim order: priority first; at equal priority, fair-share
        (reserved chips / quota weight, smallest first) across projects;
        FIFO (seq) last."""
        usage = self.fleet.usage()

        def share(entry):
            project = (entry.get("payload") or {}).get("project") or "default"
            used = usage.get(project, {}).get("chips", 0)
            return used / self.quotas.weight(project)

        return sorted(
            entries,
            key=lambda e: (
                -int(e.get("priority", 0)),
                share(e),
                int(e.get("seq", 0)),
            ),
        )

    # ------------------------------------------------------------ decide
    def _scope_usage(self) -> dict[str, dict]:
        """Reserved chips/runs keyed by project AND queue scope."""
        out: dict[str, dict] = {}
        for rec in self.fleet.ledger.all().values():
            for scope in (rec["project"], f"queue:{rec['queue']}"):
                row = out.setdefault(scope, {"chips": 0, "runs": 0})
                row["chips"] += int(rec["chips"])
                row["runs"] += 1
        return out

    def try_admit(self, entry: dict, queue_name: str = "default") -> Decision:
        """Full admission pass for one queue entry: quota check, gang
        reservation, then preemption-victim selection when a higher
        priority cannot fit. Elastic runs (`minChips` set) walk the
        halving ladder: the full block first, then successively smaller
        sub-blocks down to the floor, so a shrinkable run never parks in
        WAIT while an admissible smaller grant exists. Telemetry counters
        land on the global registry here so every surface (agent,
        simulator) reports the same series."""
        reg = get_registry()
        uuid = entry["uuid"]
        payload = entry.get("payload") or {}
        project = payload.get("project") or "default"
        priority = int(entry.get("priority", 0))
        chips, block = self.demand(entry)
        min_chips = self.min_demand(entry)
        inv = self.fleet.inventory()
        if inv is None:
            return Decision(ADMIT, reason="no fleet configured")

        sizes: list[tuple[int, Optional[tuple[int, ...]]]] = [(chips, block)]
        if min_chips is not None and min_chips < chips:
            sizes += shrink_candidates(chips, block, min_chips)

        floor_chips, floor_block = sizes[-1]
        if not inv.fits(floor_chips, block=floor_block):
            reg.counter(
                "admission.rejected",
                help="Runs marked unschedulable at admission",
            ).inc()
            shape = (
                "x".join(map(str, floor_block))
                if floor_block
                else str(floor_chips)
            )
            return Decision(
                REJECT,
                reason=(
                    f"requests {shape} but the fleet has "
                    f"{inv.total} chips"
                    + (
                        f" ({'x'.join(map(str, inv.topology))} torus)"
                        if inv.topology
                        else ""
                    )
                ),
            )

        usage = self._scope_usage()
        quota_wait: Optional[str] = None
        quota_reject: Optional[str] = None
        tried_reserve = False
        for cand_chips, cand_block in sizes:
            if not inv.fits(cand_chips, block=cand_block):
                continue
            outcome, reason = self.quotas.check(
                project, queue_name, cand_chips, usage
            )
            if outcome == REJECT:
                quota_reject = quota_reject or reason
                continue
            if outcome == WAIT:
                quota_wait = quota_wait or reason
                continue
            tried_reserve = True
            record = self.fleet.reserve(
                uuid,
                chips=cand_chips,
                block=cand_block,
                project=project,
                queue=queue_name,
                priority=priority,
                requested_chips=chips,
                requested_block=block,
            )
            if record is None:
                continue
            if min_chips is not None:
                self._record_grant(uuid, granted=cand_chips, requested=chips)
            return Decision(ADMIT, reservation=record)

        if tried_reserve:
            victims = self.pick_victims(floor_chips, floor_block, priority)
            if victims:
                for v in victims:
                    self.request_preemption(v["uuid"], by=uuid)
                return Decision(
                    WAIT,
                    reason=f"preempting {len(victims)} lower-priority run(s)",
                    preempt=[v["uuid"] for v in victims],
                )
            return Decision(WAIT, reason="insufficient free chips")
        if quota_wait is not None:
            reg.counter(
                "admission.throttled",
                help="Claims deferred by quota limits",
            ).inc()
            return Decision(WAIT, reason=quota_wait)
        if quota_reject is not None:
            reg.counter(
                "admission.rejected",
                help="Runs marked unschedulable at admission",
            ).inc()
            return Decision(REJECT, reason=quota_reject)
        return Decision(WAIT, reason="insufficient free chips")

    def _record_grant(self, uuid: str, granted: int, requested: int) -> None:
        """Stamp the granted gang size where the executor reads it; count
        shrunk grants. Store writes are skipped for entries with no run in
        the store (the simulator replays admission without one)."""
        if self.store.get_status(uuid):
            self.store.set_meta(
                uuid, granted_chips=granted, requested_chips=requested
            )
            if granted < requested:
                self.store.log_event(
                    uuid,
                    "elastic_shrink",
                    {"granted": granted, "requested": requested},
                )
        if granted < requested:
            get_registry().counter(
                "scheduler.elastic_shrinks",
                help="Elastic grants below the requested gang size",
            ).inc()

    def consider_expansion(self) -> list[str]:
        """Find shrunk elastic reservations whose FULL request could place
        once their own chips are freed, and flag each for the same
        checkpoint-and-requeue path preemption uses — the run re-enters
        the queue and re-admits at full size on a following pass."""
        inv = self.fleet.inventory()
        if inv is None:
            return []
        all_res = self.fleet.ledger.all()
        expanded = []
        for uuid, rec in all_res.items():
            requested = int(rec.get("requested_chips") or rec["chips"])
            if requested <= int(rec["chips"]):
                continue
            req_block = (
                tuple(rec["requested_block"])
                if rec.get("requested_block")
                else None
            )
            used = {
                tuple(c)
                for u, other in all_res.items()
                if u != uuid
                for c in other["coords"]
            }
            if inv.place(requested, used, block=req_block) is None:
                continue
            self.request_preemption(uuid, by="elastic-expansion")
            if self.store.get_status(uuid):
                self.store.log_event(
                    uuid,
                    "elastic_expand_requested",
                    {"from": int(rec["chips"]), "to": requested},
                )
            expanded.append(uuid)
        return expanded

    # -------------------------------------------------------- preemption
    def pick_victims(
        self,
        chips: int,
        block: Optional[tuple[int, ...]],
        priority: int,
    ) -> list[dict]:
        """Cheapest set of strictly-lower-priority reservations whose
        eviction lets the gang place. Greedy accumulate (least important,
        then smallest, first) until the gang fits, then trim members whose
        removal keeps it fitting — so a single exact-size victim beats two
        smaller ones, and higher-priority victims are never taken when a
        lower-priority set suffices."""
        inv = self.fleet.inventory()
        if inv is None:
            return []
        all_res = self.fleet.ledger.all()
        candidates = sorted(
            (r for r in all_res.values() if int(r["priority"]) < priority),
            key=lambda r: (int(r["priority"]), int(r["chips"]),
                           -r.get("reserved_at", 0)),
        )
        if not candidates:
            return []

        def fits_without(evicted: list[dict]) -> bool:
            gone = {r["uuid"] for r in evicted}
            used = {
                tuple(c)
                for u, rec in all_res.items()
                if u not in gone
                for c in rec["coords"]
            }
            return inv.place(chips, used, block=block) is not None

        chosen: list[dict] = []
        for cand in candidates:
            chosen.append(cand)
            if fits_without(chosen):
                break
        else:
            return []  # even evicting every lower-priority run won't fit
        # trim: drop any member (most expensive first) that isn't needed
        for cand in sorted(list(chosen), key=lambda r: -int(r["chips"])):
            rest = [c for c in chosen if c["uuid"] != cand["uuid"]]
            if fits_without(rest):
                chosen = rest
        return chosen

    def request_preemption(self, run_uuid: str, by: str = "") -> None:
        """Flag a running victim for checkpoint-and-requeue. The executor
        observes the flag at its cooperative boundary (log points), routes
        it through the SIGTERM preemption machinery (trainer checkpoints
        at the next step boundary), releases the reservation, and pushes
        the run back onto its queue at its original priority."""
        status = self.store.get_status(run_uuid)
        if not status:
            return
        if (status.get("meta") or {}).get("preempt_requested"):
            return  # already asked; don't double-count
        self.store.set_meta(run_uuid, preempt_requested=True)
        self.store.log_event(
            run_uuid, "preemption_requested", {"by": by}
        )
        get_registry().counter(
            "scheduler.preemptions",
            help="Scheduler-initiated preemptions (checkpoint-and-requeue)",
        ).inc()

    # --------------------------------------------------------- telemetry
    def observe_queue_wait(self, entry: dict) -> None:
        enqueued = entry.get("enqueued_at")
        if enqueued is None:
            return
        wait_ms = max(0.0, (self.clock.time() - float(enqueued)) * 1000.0)
        get_registry().histogram(
            "scheduler.queue_wait_ms",
            buckets=QUEUE_WAIT_BUCKETS_MS,
            help="Queue wait from enqueue to claim, milliseconds",
        ).observe(wait_ms)
