"""A deterministic fleet-scheduler simulator, an own copy of
`polyaxon_tpu/scheduler/sim.py`.

It drives the real admission stack (Fleet, ReservationLedger,
QuotaManager, AdmissionController, RunQueue) against a throwaway store
under a `SimClock`, with synthetic jobs instead of programs: every
scheduling decision (order, gang reservation, quota throttling, victim
choice, elastic grants) is the production code path, and only execution
is simulated: an admitted job runs for its remaining duration, and a
preempted one checkpoints its progress at the eviction instant, as the
trainer's step-boundary checkpoint does. `check_invariants` asserts the
scheduler's safety properties at any instant (quotas never exceeded,
reservations all-or-nothing and disjoint).
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field
from typing import Optional

from ..schemas.lifecycle import V1Statuses
from ..store.local import RunStore
from .admission import ADMIT, REJECT, AdmissionController, QuotaManager
from .clock import SimClock
from .fleet import Fleet
from .queue import RunQueue


@dataclass
class SimJob:
    name: str
    duration: float  # seconds of work at the FULL chip request
    arrival: float = 0.0
    chips: int = 1
    block: Optional[tuple[int, ...]] = None
    min_chips: Optional[int] = None  # elastic floor; None = rigid gang
    project: str = "default"
    queue: str = "default"
    priority: int = 0
    # --- filled by the simulator ---
    uuid: str = ""
    enqueued_at: Optional[float] = None
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    remaining: float = field(init=False)
    progress: float = 0.0  # checkpointed work (survives preemption)
    preemptions: int = 0
    waits: list = field(default_factory=list)  # one wait per admission
    final_status: str = ""
    granted: Optional[int] = None  # chips of the current/last grant
    grants: list = field(default_factory=list)  # grant size per admission
    resizes: int = 0  # admissions at a size != the full request

    def __post_init__(self):
        self.remaining = float(self.duration)

    @property
    def rate(self) -> float:
        """Work per wall-second: a shrunk grant runs proportionally
        slower (duration/remaining are denominated at full size)."""
        return (self.granted or self.chips) / self.chips


class FleetSimulator:
    """Event-driven simulation: arrivals and completions are the events;
    after each event the scheduler pass runs to a fixed point."""

    def __init__(
        self,
        jobs: list[SimJob],
        *,
        topology: Optional[str] = None,
        chips: Optional[int] = None,
        quotas: Optional[list] = None,
        home=None,
        invariant_fn=None,
        durable_store: bool = True,
    ):
        import tempfile

        self.clock = SimClock()
        self.home = home or tempfile.mkdtemp(prefix="polyaxon-sim-")
        # durable_store=False skips the event log's fsyncs: benchmark
        # population of 10k-run workloads is IO-bound on fsync, and the
        # scheduling decisions under test are identical either way
        self.store = RunStore(self.home, eventlog_fsync=durable_store)
        self.fleet = Fleet(self.store, clock=self.clock)
        self.fleet.configure(topology=topology, chips=chips)
        self.quotas = QuotaManager(self.store)
        for q in quotas or []:
            self.quotas.set(q)
        self.admission = AdmissionController(
            self.store, fleet=self.fleet, quotas=self.quotas, clock=self.clock
        )
        self.jobs = sorted(jobs, key=lambda j: (j.arrival, j.name))
        self.by_uuid: dict[str, SimJob] = {}
        self.running: dict[str, SimJob] = {}
        self.events = 0
        self.invariant_fn = invariant_fn

    # ------------------------------------------------------------- pieces
    def _queue(self, name: str) -> RunQueue:
        return RunQueue(self.store, name=name)

    def _queue_names(self) -> list[str]:
        return sorted({j.queue for j in self.jobs})

    def _arrive(self, job: SimJob) -> None:
        job.uuid = _uuid.uuid4().hex
        self.by_uuid[job.uuid] = job
        self.store.create_run(
            job.uuid,
            job.name,
            job.project,
            {"sim": True, "chips": job.chips},
            meta={"queue": job.queue, "priority": job.priority},
        )
        self.store.set_status(job.uuid, V1Statuses.COMPILED)
        self.store.set_status(job.uuid, V1Statuses.QUEUED)
        job.enqueued_at = self.clock.time()
        self._queue(job.queue).push(
            job.uuid,
            {"project": job.project},
            priority=job.priority,
            chips=job.chips,
            min_chips=job.min_chips,
            block=list(job.block) if job.block else None,
            enqueued_at=job.enqueued_at,
        )

    def _start(self, job: SimJob) -> None:
        job.waits.append(self.clock.time() - job.enqueued_at)
        job.started_at = self.clock.time()
        # the grant may be a rung below the full request (elastic shrink):
        # the reservation record is the source of truth, exactly as the
        # executor reads granted_chips off the run meta
        rec = self.fleet.ledger.get(job.uuid)
        job.granted = int(rec["chips"]) if rec else job.chips
        job.grants.append(job.granted)
        if job.granted != job.chips:
            job.resizes += 1
        for s in (V1Statuses.SCHEDULED, V1Statuses.STARTING, V1Statuses.RUNNING):
            self.store.set_status(job.uuid, s)
        self.running[job.uuid] = job

    def _finish(self, job: SimJob) -> None:
        del self.running[job.uuid]
        job.remaining = 0.0
        job.finished_at = self.clock.time()
        job.final_status = V1Statuses.SUCCEEDED
        # terminal transition releases the reservation via store/local.py —
        # the same choke point production runs go through
        self.store.set_status(job.uuid, V1Statuses.SUCCEEDED)

    def _preempt(self, job: SimJob) -> None:
        """The cooperative eviction the executor+trainer implement:
        checkpoint progress at this instant, release chips, requeue at the
        ORIGINAL priority with a fresh seq (back of its priority band)."""
        del self.running[job.uuid]
        # work done at the granted rate (a shrunk grant earns proportionally
        # less progress per wall-second)
        done = (self.clock.time() - job.started_at) * job.rate
        job.progress += done  # the checkpoint: completed work survives
        job.remaining -= done
        job.preemptions += 1
        job.started_at = None
        meta = self.store.get_status(job.uuid).get("meta") or {}
        self.store.set_meta(
            job.uuid,
            preempt_requested=False,
            preempt_restarts=int(meta.get("preempt_restarts", 0)) + 1,
        )
        self.store.set_status(job.uuid, V1Statuses.RETRYING, reason="evicted")
        self.store.set_status(job.uuid, V1Statuses.QUEUED)
        self.fleet.release(job.uuid)
        job.enqueued_at = self.clock.time()
        self._queue(job.queue).push(
            job.uuid,
            {"project": job.project},
            priority=job.priority,
            chips=job.chips,
            min_chips=job.min_chips,
            block=list(job.block) if job.block else None,
            enqueued_at=job.enqueued_at,
        )

    # ---------------------------------------------------------- scheduling
    def _schedule_pass(self) -> None:
        """Run admission to a fixed point: admissions free no chips, but a
        preemption request evicts victims (cooperatively, instantly in sim
        time) which can unblock the requester on the next iteration."""
        expanded_this_pass: set = set()
        while True:
            changed = False
            # grow-back: a shrunk elastic run whose full block now places
            # goes through checkpoint-and-requeue and re-admits at full
            # size in this same fixed point. At most once per job per pass
            # so a backfill stealing the freed chips cannot ping-pong it.
            for uuid in self.admission.consider_expansion():
                job = self.running.get(uuid)
                if job is not None and uuid not in expanded_this_pass:
                    expanded_this_pass.add(uuid)
                    self._preempt(job)
                    changed = True
            # one globally-ordered scan over ALL queues: the preemptor (by
            # definition higher priority) is always offered freed chips
            # before anything that could backfill into them
            entries = []
            for qname in self._queue_names():
                for e in self._queue(qname).peek_all():
                    e["_queue"] = qname
                    entries.append(e)
            for entry in self.admission.order(entries):
                qname = entry["_queue"]
                q = self._queue(qname)
                decision = self.admission.try_admit(entry, queue_name=qname)
                job = self.by_uuid[entry["uuid"]]
                if decision.outcome == ADMIT:
                    q.remove(entry["uuid"])
                    self.admission.observe_queue_wait(entry)
                    self._start(job)
                    changed = True
                elif decision.outcome == REJECT:
                    q.remove(entry["uuid"])
                    job.final_status = V1Statuses.UNSCHEDULABLE
                    self.store.set_status(
                        entry["uuid"],
                        V1Statuses.UNSCHEDULABLE,
                        reason="AdmissionRejected",
                        message=decision.reason,
                    )
                    changed = True
                elif decision.preempt:
                    evicted = False
                    for victim_uuid in decision.preempt:
                        victim = self.running.get(victim_uuid)
                        if victim is not None:
                            self._preempt(victim)
                            changed = evicted = True
                    if evicted:
                        # restart the ordered scan NOW: the preemptor must
                        # get first claim on the chips it just freed, not
                        # whatever backfill candidate the scan reaches next
                        break
                # WAIT: keep scanning — backfill
            if not changed:
                return

    # --------------------------------------------------------------- run
    def run(self, max_events: int = 100_000) -> dict:
        pending = list(self.jobs)
        while pending or self.running:
            next_arrival = pending[0].arrival if pending else None
            next_finish = (
                min(
                    j.started_at + j.remaining / j.rate
                    for j in self.running.values()
                )
                if self.running
                else None
            )
            candidates = [t for t in (next_arrival, next_finish) if t is not None]
            if not candidates:
                break
            now = min(candidates)
            self.clock.advance_to(max(now, self.clock.time()))
            while pending and pending[0].arrival <= self.clock.time():
                self._arrive(pending.pop(0))
            for job in [
                j
                for j in self.running.values()
                if j.started_at + j.remaining / j.rate
                <= self.clock.time() + 1e-9
            ]:
                self._finish(job)
            self._schedule_pass()
            self.events += 1
            if self.invariant_fn is not None:
                self.invariant_fn(self)
            if self.events > max_events:
                raise RuntimeError("simulation did not converge")
        return self.report()

    # ------------------------------------------------------------ results
    def report(self) -> dict:
        done = [j for j in self.jobs if j.finished_at is not None]
        waits = sorted(w for j in self.jobs for w in j.waits)
        makespan = max((j.finished_at for j in done), default=0.0)
        chip_seconds = sum(j.chips * j.duration for j in done)
        total = self.fleet.inventory().total
        return {
            "jobs": len(self.jobs),
            "succeeded": len(done),
            "unschedulable": sum(
                1 for j in self.jobs
                if j.final_status == V1Statuses.UNSCHEDULABLE
            ),
            "makespan_s": round(makespan, 3),
            "wait_p50_s": round(_pct(waits, 0.50), 3),
            "wait_p95_s": round(_pct(waits, 0.95), 3),
            "utilization": round(
                chip_seconds / (total * makespan), 4
            ) if makespan else 0.0,
            "preemptions": sum(j.preemptions for j in self.jobs),
            "elastic_resizes": sum(j.resizes for j in self.jobs),
            "events": self.events,
        }

    # ----------------------------------------------------------- checking
    def check_invariants(self) -> None:
        """Assert scheduler safety properties at the current instant."""
        inv = self.fleet.inventory()
        reservations = self.fleet.ledger.all()
        # all-or-nothing gangs: a reservation holds exactly its chips
        seen: set = set()
        for rec in reservations.values():
            coords = {tuple(c) for c in rec["coords"]}
            assert len(coords) == int(rec["chips"]), (
                f"partial gang: {rec['uuid']} holds {len(coords)} of "
                f"{rec['chips']} chips"
            )
            assert not (coords & seen), f"overlapping reservation {rec['uuid']}"
            seen |= coords
        assert len(seen) <= inv.total, "reserved more chips than exist"
        # quotas hold at every instant, for every scope
        usage: dict[str, dict] = {}
        for rec in reservations.values():
            for scope in (rec["project"], f"queue:{rec['queue']}"):
                row = usage.setdefault(scope, {"chips": 0, "runs": 0})
                row["chips"] += int(rec["chips"])
                row["runs"] += 1
        for quota in self.quotas.all():
            used = usage.get(quota.scope, {"chips": 0, "runs": 0})
            if quota.max_chips is not None:
                assert used["chips"] <= quota.max_chips, (
                    f"quota {quota.scope} exceeded: {used['chips']} > "
                    f"{quota.max_chips} chips at t={self.clock.time()}"
                )
            if quota.max_runs is not None:
                assert used["runs"] <= quota.max_runs, (
                    f"quota {quota.scope} exceeded: {used['runs']} > "
                    f"{quota.max_runs} runs at t={self.clock.time()}"
                )


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return float(sorted_vals[idx])


def synthetic_workload(
    seed: int,
    n_jobs: int,
    *,
    topology: str = "4x4",
    projects: tuple = ("alpha", "beta", "gamma"),
) -> list[SimJob]:
    """Seeded random workload: mixed sizes (flat chip counts + a few
    topology-pinned gangs), arrival bursts, a sprinkle of high-priority
    jobs. Same seed → same workload → same schedule."""
    import random

    from .topology import parse_topology

    rng = random.Random(seed)
    topo = parse_topology(topology)
    total = 1
    for t in topo:
        total *= t
    jobs = []
    t = 0.0
    for i in range(n_jobs):
        t += rng.expovariate(1 / 20.0)  # mean 20s between arrivals
        chips = rng.choice([1, 1, 2, 2, 4, 4, 8, total // 2])
        block = None
        if rng.random() < 0.25 and len(topo) == 2:
            block = rng.choice([(2, 2), (2, 4), (topo[0], topo[1])])
            chips = block[0] * block[1]
        jobs.append(
            SimJob(
                name=f"job-{i:04d}",
                duration=rng.uniform(30.0, 300.0),
                arrival=round(t, 3),
                chips=min(chips, total),
                block=block,
                project=rng.choice(list(projects)),
                priority=10 if rng.random() < 0.1 else 0,
            )
        )
    return jobs
