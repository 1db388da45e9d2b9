"""The sweep driver, an own copy of `polyaxon_tpu/tuner/driver.py`: an
operation with a `matrix:` → child runs → the best trial.

The loop is in-process: manager.suggest() → compile children with
`apply_suggestion` → execute (a thread pool bounded by `concurrency`, each
trial on a disjoint group of the device pool, `tuner/placement.py`) → read
the objective from the run store → manager.observe() → repeat. One card is
one group, so its trials run one at a time. A trial's `Executor` trains
an in-process program under its group's first device (`torch.cuda.device`):
the port's kernels launch on the calling thread's current device. A gang
trial's workers see only the group's GPUs.

Hyperband's resource budget is injected as the param named by
`matrix.resource.name` (conventionally `steps`), so the component's
Polyaxonfile decides what "resource" means.

The sweep run walks compiled → queued → scheduled → running and settles
succeeded, failed (no trial logged the objective) or stopped (a stop
between iterations, or during the final batch). Each trial carries its
sweep in `meta.sweep` with its iteration and spec fingerprint; each
iteration logs a `sweep_iteration` event and the end a `sweep_summary`.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from ..compiler.resolver import apply_suggestion, compile_operation, spec_fingerprint
from ..runtime.executor import Executor
from ..schemas.lifecycle import V1Statuses, can_transition
from ..schemas.operation import V1Operation
from ..store import RunStore
from .early_stopping import metric_triggered
from .managers import Suggestion, build_manager
from .placement import device_pool, parse_topology, sub_slices


@dataclasses.dataclass
class TrialResult:
    run_uuid: str
    params: dict[str, Any]
    objective: Optional[float]
    status: str


@dataclasses.dataclass
class SweepResult:
    sweep_uuid: str
    trials: list[TrialResult]
    best: Optional[TrialResult]


def _objective_from_store(
    store: RunStore, run_uuid: str, metric: str
) -> Optional[float]:
    """Last logged value of the metric — RAW, exactly as the trial logged it.
    Sign-flipping for minimize happens only inside manager scoring, never in
    anything user-facing."""
    last = None
    for rec in store.read_metrics(run_uuid):
        if metric in rec:
            last = float(rec[metric])
    return last


class SweepDriver:
    def __init__(
        self,
        op: V1Operation,
        *,
        store: Optional[RunStore] = None,
        project: Optional[str] = None,
        devices: Optional[list] = None,
        sweep_uuid: Optional[str] = None,
        log_fn=print,
    ):
        if op.matrix is None:
            raise ValueError("operation has no matrix: nothing to sweep")
        self.op = op
        self.matrix = op.matrix
        self.store = store or RunStore()
        self.project = project
        self.devices = devices
        # an existing run as the sweep's record (the agent's queued sweep);
        # else run() creates one
        self.sweep_uuid: Optional[str] = sweep_uuid
        self.log = log_fn
        metric = getattr(self.matrix, "metric", None)
        self.metric_name = metric.name if metric else "loss"
        self.maximize = (metric.optimization if metric else "minimize") == "maximize"

    # ------------------------------------------------------------------
    def run(self) -> SweepResult:
        import uuid as _uuid

        mgr = build_manager(self.matrix)
        if self.sweep_uuid is not None:
            sweep_uuid = self.sweep_uuid  # the queued run is the sweep's record
        else:
            sweep_uuid = self.sweep_uuid = _uuid.uuid4().hex
            # the RAW operation wholesale, so clones (ops restart) rebuild a
            # submittable sweep — templates, matrix, pathRef all intact
            self.store.create_run(
                sweep_uuid,
                (self.op.name or "sweep") + "-sweep",
                self.project or "default",
                {
                    "name": self.op.name,
                    "operation": self.op.to_dict(),
                    "matrix": self.matrix.to_dict(),
                },
                tags=["sweep"],
            )
        for s in (
            V1Statuses.COMPILED,
            V1Statuses.QUEUED,
            V1Statuses.SCHEDULED,
            V1Statuses.RUNNING,
        ):
            # a queued sweep arrives QUEUED: the earlier rungs are skipped
            current = self.store.get_status(sweep_uuid).get("status")
            if current != s and can_transition(V1Statuses(current), s):
                self.store.set_status(sweep_uuid, s)
        trials: list[TrialResult] = []
        iteration = 0
        stopped = False
        try:
            while not mgr.done:
                # cooperative stop: a client may stop the sweep run
                # mid-flight; halt between iterations — in-flight trials of
                # the current batch run to completion
                current = self.store.get_status(sweep_uuid).get("status")
                if current in (V1Statuses.STOPPING, V1Statuses.STOPPED):
                    self.log("sweep stop requested; halting")
                    stopped = True
                    break
                batch = mgr.suggest()
                if not batch:
                    break
                results = self._run_batch(batch, sweep_uuid, iteration)
                mgr.observe([(s, self._score(r)) for s, r in results])
                trials.extend(r for _, r in results)
                iteration += 1
                stop_early = any(
                    r.objective is not None
                    and metric_triggered(
                        self.matrix.early_stopping,
                        {self.metric_name: r.objective},
                    )
                    for _, r in results
                )
                best = self._best(trials)
                self.store.log_event(
                    sweep_uuid,
                    "sweep_iteration",
                    {
                        "iteration": iteration,
                        "trials": len(trials),
                        "best": best.objective if best else None,
                    },
                )
                if stop_early:
                    self.log("early stopping: metric threshold crossed")
                    break
        except BaseException as e:
            self._settle(sweep_uuid, V1Statuses.FAILED, message=str(e))
            raise
        best = self._best(trials)
        self.store.log_event(
            sweep_uuid,
            "sweep_summary",
            {
                "trials": len(trials),
                "best_params": best.params if best else None,
                "best_objective": best.objective if best else None,
            },
        )
        # a stop may also have landed DURING the final batch (loop exits
        # via mgr.done without re-reaching the check): STOPPING can only
        # legally settle to STOPPED, never SUCCEEDED
        current = self.store.get_status(sweep_uuid).get("status")
        if stopped or current in (V1Statuses.STOPPING, V1Statuses.STOPPED):
            self._settle(sweep_uuid, V1Statuses.STOPPED, reason="stop requested")
        elif best is None:
            # every trial failed or none logged the objective metric: a
            # sweep that produced nothing must not read as success (and a
            # DAG must not hand downstream nodes an empty winner)
            self._settle(
                sweep_uuid,
                V1Statuses.FAILED,
                message=(
                    f"no trial produced objective metric "
                    f"{self.metric_name!r} ({len(trials)} trials)"
                ),
            )
        else:
            self._settle(sweep_uuid, V1Statuses.SUCCEEDED)
        return SweepResult(sweep_uuid=sweep_uuid, trials=trials, best=best)

    def _settle(self, sweep_uuid: str, target: V1Statuses, **kw) -> None:
        """Transition-guarded terminal status (a concurrent stop may have
        already settled the run — never raise over bookkeeping)."""
        current = self.store.get_status(sweep_uuid).get("status")
        if current == target:
            return
        if can_transition(V1Statuses(current), target):
            self.store.set_status(sweep_uuid, target, **kw)

    def _score(self, trial: TrialResult) -> Optional[float]:
        """Manager-facing score: higher is better."""
        if trial.objective is None:
            return None
        return trial.objective if self.maximize else -trial.objective

    def _best(self, trials) -> Optional[TrialResult]:
        scored = [t for t in trials if t.objective is not None]
        return max(scored, key=self._score) if scored else None

    def _topology(self):
        """The grid of `environment.resources.tpu.topology`, when declared
        and its product is the pool's size: groups then tile that grid
        instead of splitting the pool in index order."""
        run = getattr(self.op.component, "run", None) if self.op.component else None
        env = getattr(run, "environment", None)
        res = getattr(env, "resources", None)
        tpu = getattr(res, "tpu", None)
        topo = parse_topology(tpu) if tpu is not None else None
        if topo is None:
            return None
        import math

        n = len(self.devices) if self.devices is not None else len(device_pool())
        return topo if math.prod(topo) == n else None

    # ------------------------------------------------------------------
    def _run_batch(
        self, batch: list[Suggestion], sweep_uuid: str, iteration: int
    ) -> list[tuple[Suggestion, TrialResult]]:
        concurrency = self.matrix.concurrency or 1
        slices = (
            sub_slices(concurrency, self.devices, topology=self._topology())
            if concurrency > 1
            else [self.devices]
        )
        concurrency = max(1, len(slices))
        if concurrency == 1:
            return [
                (s, self._run_trial(s, sweep_uuid, iteration, slices[0]))
                for s in batch
            ]
        # each worker checks a group out of the pool and returns it when
        # the trial ends — two live trials can never share devices, whatever
        # order the pool completes in
        import queue as _queue

        free: _queue.Queue = _queue.Queue()
        for sl in slices:
            free.put(sl)

        def one(sug):
            devices = free.get()
            try:
                return sug, self._run_trial(sug, sweep_uuid, iteration, devices)
            finally:
                free.put(devices)

        with ThreadPoolExecutor(max_workers=concurrency) as pool:
            return list(pool.map(one, batch))

    def _run_trial(
        self, sug: Suggestion, sweep_uuid: str, iteration: int, devices
    ) -> TrialResult:
        params = sug.run_params()
        if sug.resource is not None:
            name = self.matrix.resource.name
            value = sug.resource
            params[name] = int(value) if self.matrix.resource.type == "int" else value
        child_op = apply_suggestion(self.op, params)
        compiled = compile_operation(
            child_op,
            project=self.project,
            # trials live in the same store tree as every other run —
            # {{ globals.run_outputs_path }} must resolve under runs_dir
            artifacts_root=str(self.store.runs_dir),
            iteration=iteration,
        )
        self.log(
            f"trial {compiled.run_uuid[:8]} params={params}"
            + (f" [bracket {sug.bracket} rung {sug.rung}]" if sug.bracket is not None else "")
        )
        # create the record up front so the trial carries its sweep lineage.
        # The executor's later create_run is a no-op for existing runs, so
        # everything it would have written must be merged here: the spec
        # fingerprint (run-cache lookups key on it) and the operation's own
        # tags (index filtering)
        self.store.create_run(
            compiled.run_uuid,
            compiled.name,
            compiled.project,
            compiled.to_dict(),
            tags=["trial", *(compiled.operation.tags or [])],
            meta={
                "sweep": sweep_uuid,
                "iteration": iteration,
                "fingerprint": spec_fingerprint(compiled),
            },
        )
        status = Executor(store=self.store, devices=devices).execute(compiled)
        objective = _objective_from_store(
            self.store, compiled.run_uuid, self.metric_name
        )
        return TrialResult(
            run_uuid=compiled.run_uuid,
            params=params,
            objective=objective,
            status=status,
        )


def run_sweep(
    op: V1Operation,
    *,
    store: Optional[RunStore] = None,
    project: Optional[str] = None,
    devices: Optional[list] = None,
    sweep_uuid: Optional[str] = None,
    log_fn=print,
) -> dict:
    """Run the sweep; returns a JSON-able summary (the CLI prints it).
    `sweep_uuid`: an existing run as the sweep's record (the agent's
    queued sweep)."""
    driver = SweepDriver(
        op,
        store=store,
        project=project,
        sweep_uuid=sweep_uuid,
        devices=devices,
        log_fn=log_fn,
    )
    result = driver.run()
    store = driver.store
    return {
        "sweep": result.sweep_uuid,
        # terminal status of the sweep run: succeeded | failed | stopped —
        # callers (DAG sweep nodes) must distinguish a user stop from a
        # failure or a full search
        "status": store.get_status(result.sweep_uuid).get("status"),
        "trials": [
            {
                "uuid": t.run_uuid,
                "params": t.params,
                "objective": t.objective,
                "status": str(t.status),
            }
            for t in result.trials
        ],
        "best": {
            "uuid": result.best.run_uuid,
            "params": result.best.params,
            "objective": result.best.objective,
        }
        if result.best
        else None,
    }
