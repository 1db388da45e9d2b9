"""The agent, an own copy of `polyaxon_tpu/scheduler/agent.py`: drains the
run queues and executes the runs.

Each claimed run executes through `runtime/executor.py` on this host's
devices (the card, or the CPU when `POLYAXON_TORCH_DEVICE=cpu`), a queued
sweep through `tuner/driver.py::run_sweep`. With a configured fleet
(`fleet init`) every claim passes admission (`admission.py`): quotas,
all-or-nothing gang reservations, backfill, preemption of lower-priority
runs and elastic grants; without one the agent claims by queue
concurrency alone. A `submit_fn(compiled) -> status` replaces the executor
(an injectable submitter). The reference's cluster path (`cluster=`, a
`ClusterSubmitter`, and the reconciler its `serve` loop runs) belongs with
`k8s/` and is refused by name (ROADMAP.md).

`drain()` processes until the queues are empty (tests, one-shot CLIs);
`serve()` is the long-running loop (`agent start`): it fires due
schedules, drains, and blocks on the store's event cursor between passes.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..compiler.resolver import CompiledOperation, compile_operation
from ..runtime.executor import Executor
from ..schemas.lifecycle import DONE_STATUSES, V1Statuses
from ..schemas.operation import V1Operation
from ..store.local import RunStore
from .admission import ADMIT, REJECT, AdmissionController
from .queue import QueueRegistry, RunQueue

CLUSTER_REFUSAL = ("submitting runs to a cluster (`cluster=`, ClusterSubmitter and the "
                   "reconciler, k8s/) is not ported to PyTorch yet (see ROADMAP.md)")


class Agent:
    def __init__(
        self,
        store: Optional[RunStore] = None,
        queue: Optional[RunQueue] = None,
        submit_fn: Optional[Callable[[CompiledOperation], str]] = None,
        devices: Optional[list] = None,
        queues: Optional[list[str]] = None,
        cluster=None,
    ):
        if cluster is not None or getattr(submit_fn, "cluster", None) is not None:
            raise NotImplementedError(CLUSTER_REFUSAL)
        self.store = store or RunStore()
        self.registry = QueueRegistry(self.store)
        # `queue` pins the agent to one queue (tests, embedding); otherwise
        # it drains every queue of the registry, `queues` filtering them
        self.queue = queue or RunQueue(self.store)
        self._pinned = queue is not None
        self.queue_filter = queues
        self.executor = Executor(store=self.store, devices=devices)
        self.submit_fn = submit_fn
        # admission gates the claims once a fleet is configured; without
        # one the agent keeps the pop-based claiming
        self.admission = AdmissionController(self.store)

    def submit(
        self,
        op: V1Operation,
        *,
        project: str = "default",
        priority: int = 0,
        meta: Optional[dict] = None,
        prepare_fn: Optional[Callable] = None,
    ) -> str:
        """Compile and enqueue (the control-plane half of `run`).
        `prepare_fn(compiled)` runs after the run exists but before it is
        queued: restart and resume seed the new run's outputs there without
        racing a draining agent. A spec the port cannot run raises
        NotImplementedError before any run exists."""
        from ..compiler.resolver import spec_fingerprint
        from ..runtime.executor import refusal
        from .fleet import chips_demand, min_chips_demand, topology_request

        if op.joins:
            from .joins import resolve_joins

            op = resolve_joins(op, self.store)
        compiled = compile_operation(op, project=project, artifacts_root=str(self.store.runs_dir))
        why = refusal(compiled)
        if why is not None:
            raise NotImplementedError(why)
        routed_queue = self.queue_for(op)
        self.store.create_run(
            compiled.run_uuid,
            compiled.name,
            compiled.project,
            compiled.to_dict(),
            tags=compiled.operation.tags,
            # `queue` is the routed queue (a pinned agent routes every op to
            # its own); `priority` the original one an evicted run keeps
            meta={
                "fingerprint": spec_fingerprint(compiled),
                "queue": routed_queue.name,
                "priority": int(priority),
                **(meta or {}),
            },
        )
        if prepare_fn is not None:
            prepare_fn(compiled)
        self.store.set_status(compiled.run_uuid, V1Statuses.COMPILED)
        self.store.set_status(compiled.run_uuid, V1Statuses.QUEUED)
        # the demand rides on the entry, so admission never recompiles a spec
        block = topology_request(compiled.operation)
        routed_queue.push(
            compiled.run_uuid,
            {"operation": compiled.operation.to_dict(), "project": compiled.project},
            priority=priority,
            chips=chips_demand(compiled.operation),
            min_chips=min_chips_demand(compiled.operation),
            block=list(block) if block else None,
        )
        return compiled.run_uuid

    def _process(self, entry: dict) -> str:
        # a client may have stopped or deleted the run while it was queued
        status_data = self.store.get_status(entry["uuid"])
        if not status_data:
            return "deleted"  # the run is gone: never resurrect it
        current = status_data.get("status")
        if current in DONE_STATUSES:
            return current
        op = V1Operation.from_dict(entry["payload"]["operation"])
        if op.matrix is not None:
            if self.submit_fn is not None:
                raise RuntimeError(
                    "matrix (sweep) operations cannot be driven by a submitting "
                    "agent; route them to an executing agent's queue"
                )
            # a queued sweep runs under this run's uuid, so its watchers see
            # the sweep's lifecycle and iterations
            from ..tuner.driver import run_sweep

            summary = run_sweep(
                op,
                store=self.store,
                project=entry["payload"].get("project"),
                devices=self.executor.devices,
                sweep_uuid=entry["uuid"],
                log_fn=lambda line: self.store.append_log(entry["uuid"], str(line)),
            )
            self.store.append_log(
                entry["uuid"],
                f"sweep done: {len(summary['trials'])} trials, best {summary['best']}",
            )
            return self.store.get_status(entry["uuid"]).get("status")
        compiled = compile_operation(
            op,
            run_uuid=entry["uuid"],
            project=entry["payload"].get("project"),
            artifacts_root=str(self.store.runs_dir),
        )
        if self.submit_fn is not None:
            return self.submit_fn(compiled)
        return self.executor.execute(compiled)

    def queue_for(self, op: V1Operation) -> RunQueue:
        """The queue an operation routes to: its `queue:` field, unless
        this agent is pinned to one."""
        if self._pinned or not op.queue:
            return self.queue
        return self.registry.get(op.queue)

    def _queues(self) -> list[tuple[RunQueue, dict]]:
        """(queue, settings) this agent drains, highest priority first."""
        if self._pinned:
            return [(self.queue, {"concurrency": 1, "priority": 0})]
        cfg = self.registry.config()
        names = self.registry.names(cfg) or ["default"]
        if self.queue_filter is not None:
            names = [n for n in names if n in self.queue_filter]
        return [(self.registry.get(n), self.registry.settings(n, cfg)) for n in names]

    def _safe_process(self, entry: dict) -> None:
        uid = entry.get("uuid")
        try:
            self._process(entry)
        except Exception as e:  # noqa: BLE001 — record on the run, keep draining
            try:
                self.store.append_log(uid, f"agent: {type(e).__name__}: {e}")
                self.store.set_status(uid, V1Statuses.FAILED, reason=type(e).__name__,
                                      message=str(e))
            except Exception:  # noqa: BLE001
                pass
        finally:
            # the store releases reservations on terminal transitions, but a
            # run deleted or settled before its claim never transitions
            if self.admission.active:
                status = self.store.get_status(uid).get("status")
                if not status or status in DONE_STATUSES:
                    self.admission.fleet.release(uid)

    def _claim(self, q: RunQueue, take: int) -> list[dict]:
        """Up to `take` entries of one queue. Without a fleet, plain pops;
        with one, every claim passes admission: the quota check, the gang
        reservation, UNSCHEDULABLE for a run that can never fit, backfill
        past blocked gangs, and preemption requests for higher priorities."""
        if not self.admission.active:
            batch = []
            for _ in range(take):
                entry = q.pop()
                if entry is None:
                    break
                batch.append(entry)
            return batch
        batch: list[dict] = []
        for entry in self.admission.order(q.peek_all()):
            if len(batch) >= take:
                break
            decision = self.admission.try_admit(entry, queue_name=q.name)
            if decision.outcome == ADMIT:
                if not q.remove(entry["uuid"]):
                    # another agent claimed it first: give the chips back
                    self.admission.fleet.release(entry["uuid"])
                    continue
                self.admission.observe_queue_wait(entry)
                batch.append(entry)
            elif decision.outcome == REJECT:
                q.remove(entry["uuid"])
                try:
                    self.store.set_status(entry["uuid"], V1Statuses.UNSCHEDULABLE,
                                          reason="AdmissionRejected",
                                          message=decision.reason)
                except (ValueError, OSError, KeyError):
                    pass  # deleted or settled elsewhere; the entry is gone
            # WAIT: stays queued, later entries may backfill around it
        return batch

    def drain(self, max_runs: Optional[int] = None) -> int:
        """Process queued runs until every watched queue is empty (or
        `max_runs`); returns the count. Queues drain in their configured
        priority order; a queue of concurrency > 1 runs that many entries
        at once (threads). A bad entry fails its own run, never the loop."""
        count = 0
        while max_runs is None or count < max_runs:
            progressed = False
            if self.admission.active:
                # shrunk elastic runs grow back through checkpoint-and-requeue
                try:
                    self.admission.consider_expansion()
                except Exception:  # noqa: BLE001 — expansion is best-effort
                    pass
            for q, settings in self._queues():
                conc = int(settings.get("concurrency", 1))
                if conc <= 0:
                    continue  # concurrency 0: a paused queue
                budget = (max_runs - count) if max_runs is not None else None
                take = conc if budget is None else max(1, min(conc, budget))
                batch = self._claim(q, take)
                if not batch:
                    continue
                progressed = True
                if len(batch) == 1:
                    self._safe_process(batch[0])
                else:
                    from concurrent.futures import ThreadPoolExecutor

                    with ThreadPoolExecutor(max_workers=len(batch)) as pool:
                        list(pool.map(self._safe_process, batch))
                count += len(batch)
                break  # re-read the queues' priority order after each batch
            if not progressed:
                break
        return count

    def serve(self, poll_interval: float = 1.0, stop_when=lambda: False):
        """The long-running loop: fire due schedules, drain the queues, then
        block on the store's event cursor until something changes (or
        `poll_interval` passes: schedules need a heartbeat)."""
        from .schedules import ScheduleRegistry

        registry = ScheduleRegistry(self.store)
        try:
            self.store.recover()  # heal an interrupted batch of an earlier writer
        except Exception as e:  # noqa: BLE001 — recovery is best-effort here
            print(f"store recovery error: {e}")
        cursor = self.store.head_cursor()
        while not stop_when():
            try:
                registry.tick(self)
            except Exception as e:  # noqa: BLE001 — a bad schedule never kills the agent
                print(f"schedule tick error: {e}")
            # an uncapped drain per tick, so per-queue concurrency batches form
            if self.drain() == 0:
                _, cursor = self.store.wait_events(cursor, timeout=poll_interval)
