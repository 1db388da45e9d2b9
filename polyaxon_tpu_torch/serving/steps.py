"""Token-budget step scheduler: chunked prefill + continuous batching (own
copy of `polyaxon_tpu/serving/steps.py`).

`DecodeCoalescer` (batching.py) treats one coalesced group as one blocking
execute — a long prefill monopolizes the single decode worker and every
co-resident row pays for it in TTFT. `StepScheduler` replaces the group
loop with a *device step* loop:

- every step packs ALL active decode rows (grouped into lanes by the
  engine) plus AT MOST ONE prefill slice of `prefill_chunk_tokens` prompt
  tokens;
- a step's total token count is bounded by `max_step_tokens`, so the
  worst-case step latency — and therefore short-request TTFT — is
  independent of whatever prompt lengths happen to be co-resident;
- new requests join mid-flight (continuous batching): admission happens
  between steps under the same token budget, not at group boundaries;
- deadline-expired and cancelled rows are evicted BETWEEN steps (both
  pending and mid-flight), so no decode slot is spent on them;
- rows the engine cannot step fall back to the classic blocking group
  execute, scheduled as an exclusive step, and forced to run after
  `CLASSIC_STARVE_STEPS` consecutive steppable steps so sustained
  steppable load cannot starve them.

The scheduler subclasses `DecodeCoalescer` so admission (`submit`,
shed/breaker/queue bounds), drain/stop and the crash watchdog are shared;
only the worker loop body differs. All per-row device state lives on
`req.step` (a `RowStep`), so a watchdog restart starts from a clean slate —
the crashed rows were failed fast and their KV pages released through
`on_finish`.

Clock-free: deadline math delegates to `PendingRequest.expired()` and every
latency observation happens in the engine.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

from ..chaos.injector import inject
from .batching import (
    CircuitBreaker,
    ClientDisconnectedError,
    DeadlineExceededError,
    DecodeCoalescer,
    PendingRequest,
    ServerClosingError,
)


@dataclasses.dataclass
class RowStep:
    """Scheduler-visible slice of one row's step state. The engine owns
    the rest (suffix array, frontier, sampling cursor) on the same
    object — the scheduler reads only these three fields."""

    phase: str = "prefill"  # prefill → decode → done
    next_chunk: int = 0  # prompt tokens the next prefill slice consumes
    cost: int = 1  # device tokens one decode step spends on this row


class StepEngine:
    """What the scheduler needs from the model side. server.py implements
    this against the paged decode functions; tests drive the scheduler
    with a fake. Engines must set `req.step = RowStep(...)` in `begin` and keep
    `phase`/`next_chunk`/`cost` current."""

    def supports(self, req: PendingRequest) -> bool:  # pragma: no cover
        raise NotImplementedError

    def begin(self, req: PendingRequest) -> None:  # pragma: no cover
        raise NotImplementedError

    def prefill_chunk(self, req: PendingRequest) -> int:  # pragma: no cover
        """Run ONE prefill slice; returns tokens consumed. Sets
        `req.step.phase = "decode"` (or "done") when prefill completes."""
        raise NotImplementedError

    def lanes(self, rows: list) -> list[list]:  # pragma: no cover
        """Group decode rows into lanes that share one batched step."""
        raise NotImplementedError

    def decode(self, lane: list) -> int:  # pragma: no cover
        """Run ONE decode step for a lane; returns tokens consumed.
        Finishes rows that complete (phase = "done" + req.finish)."""
        raise NotImplementedError


class StepScheduler(DecodeCoalescer):
    """Continuous-batching worker loop over a `StepEngine`.

    Inherits the producer side (bounded queue, shed, breaker, drain,
    stop, watchdog) from `DecodeCoalescer` unchanged; `_loop` is the
    step loop described in the module docstring."""

    #: consecutive steppable steps a non-empty classic (beam) pool may
    #: wait before an exclusive classic step is forced. Mirrors the
    #: `_starved` prefill flag: under sustained decode load the classic
    #: pool would otherwise never see the "both pools empty" condition
    #: and starve until deadline eviction (or forever, with no deadline).
    CLASSIC_STARVE_STEPS = 8

    def __init__(
        self,
        execute: Callable[[list[PendingRequest]], None],
        engine: StepEngine,
        *,
        prefill_chunk_tokens: int = 64,
        max_step_tokens: int = 256,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 64,
        breaker: Optional[CircuitBreaker] = None,
        observer: Optional[Callable[..., None]] = None,
        tenancy=None,  # serving.tenancy.TenantAdmission
    ):
        super().__init__(
            execute,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            max_queue=max_queue,
            breaker=breaker,
            observer=observer,
            tenancy=tenancy,
        )
        if prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got {prefill_chunk_tokens}"
            )
        if max_step_tokens < 1:
            raise ValueError(
                f"max_step_tokens must be >= 1, got {max_step_tokens}"
            )
        self._engine = engine
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.max_step_tokens = int(max_step_tokens)
        # scheduler state — owned by the worker thread only
        self._prefilling: deque[PendingRequest] = deque()
        self._decoding: list[PendingRequest] = []
        self._classic: deque[PendingRequest] = deque()
        self._starved = False  # budget excluded prefill last step
        self._classic_waits = 0  # steppable steps run while classic waited
        # step telemetry (read by /statsz and the interference bench)
        self.steps_run = 0
        self.prefill_only_steps = 0
        self.classic_forced_steps = 0
        self.evicted_midflight = 0

    # ---------------------------------------------------------- introspection
    @property
    def prefill_queue_depth(self) -> int:
        """Rows admitted but not yet past prefill (pending + mid-prefill).
        The serving.prefill_queue_depth gauge on /statsz + /metricsz."""
        return len(self._pending) + len(self._prefilling)

    def _active(self) -> list[PendingRequest]:
        return list(self._prefilling) + self._decoding + list(self._classic)

    # -------------------------------------------------------------- internals
    def _row_cost(self, req: PendingRequest) -> int:
        """Steady-state decode tokens per step for one row: speculative
        rows verify a (draft_tokens+1)-wide window, plain rows one token."""
        k = req.key
        return (k.draft_tokens + 1) if k.speculate else 1

    def _fail_active(self, error: BaseException) -> None:
        active = self._active()
        self._prefilling.clear()
        self._decoding.clear()
        self._classic.clear()
        # only rows not already terminal count: after a crash the
        # watchdog failed AND resolved the in-flight rows still sitting
        # in the pools (the done-row sweep runs after the stop check),
        # so resolving them again would undercount _outstanding and let
        # drain() report idle with admitted requests still unresolved
        n = 0
        for r in active:
            if not r.done.is_set():
                r.finish(error=error)
                n += 1
        if n:
            self._resolve(n)

    def _evict_expired_active(self) -> None:
        """Mid-flight eviction: a row whose deadline passed is
        evicted between steps — it 504s without spending step tokens, and
        `on_finish` releases its (possibly partial) KV pages. Cancelled
        rows (client disconnected) leave the same way, freeing
        their decode slot and pages for clients still listening."""
        for pool in (self._prefilling, self._decoding, self._classic):
            gone = [r for r in pool if r.cancelled]
            for r in gone:
                pool.remove(r)
                self.evicted_midflight += 1
                self.cancel_dropped += 1
                self._observe("client_cancelled")
                r.finish(error=ClientDisconnectedError(
                    "client disconnected mid-flight: evicted between steps"
                ))
                self._resolve()
            dead = [r for r in pool if r.expired()]
            for r in dead:
                pool.remove(r)
                self.evicted_midflight += 1
                self.deadline_dropped += 1
                self._observe("deadline_dropped")
                r.finish(error=DeadlineExceededError(
                    "deadline exceeded mid-flight: evicted between steps"
                ))
                self._resolve()

    def _admit_active(self) -> None:
        """pending → active under the token budget: a row joins only while
        the steady decode cost of everything active (plus it) fits in
        max_step_tokens. FIFO — or, with tenancy, weighted fair (smallest
        outstanding tokens / weight first, FIFO within a tenant); rows that
        don't fit yet stay pending (and still purge on expiry) until
        finishing rows free budget."""
        budget = self.max_step_tokens
        active_cost = sum(r.step.cost for r in self._decoding)
        active_cost += sum(self._row_cost(r) for r in self._prefilling)
        while self._pending:
            if self.tenancy is not None and len(self._pending) > 1:
                r = min(self._pending,
                        key=lambda p: (self.tenancy.share(p.tenant), p.enqueued_at))
            else:
                r = self._pending[0]
            if not self._engine.supports(r):
                self._pending.remove(r)
                self._classic.append(r)
                continue
            cost = self._row_cost(r)
            if self._decoding or self._prefilling:
                if active_cost + cost > budget:
                    break
            self._pending.remove(r)
            try:
                self._engine.begin(r)
            except BaseException as e:  # noqa: BLE001 — fail the row, not the loop
                self._observe("decode_error", error=type(e).__name__)
                if not r.done.is_set():
                    r.finish(error=e)
                self._resolve()
                continue
            active_cost += cost
            self._prefilling.append(r)

    def _run_classic_step(self) -> None:
        """Blocking fallback for rows the engine cannot step (beam
        search): one classic same-key group, executed exclusively."""
        head = self._classic[0]
        batch = [r for r in self._classic if r.key == head.key][: self.max_batch]
        for r in batch:
            self._classic.remove(r)
        self._inflight = batch
        self.batches_run += 1
        self.rows_run += len(batch)
        try:
            self._execute(batch)
        except BaseException as e:  # noqa: BLE001 — scatter, don't die
            if self._breaker is not None:
                self._breaker.record_failure()
            self._observe("decode_error", error=type(e).__name__)
            for r in batch:
                if not r.done.is_set():
                    r.finish(error=e)
        else:
            if self._breaker is not None:
                self._breaker.record_success()
        self._inflight = None
        self._resolve(len(batch))

    # ------------------------------------------------------------ worker loop
    def _loop(self):
        alive = True
        while True:
            if self._stop.is_set():
                # stop() fail-fasts the queue + pending; mid-flight rows
                # are ours to fail — nobody else holds a reference
                self._fail_active(ServerClosingError(
                    "server shutting down: request aborted"
                ))
                return
            # after a watchdog restart the crashed step's rows were already
            # failed fast AND resolved by _run — sweep them out of the
            # pools without resolving again (everything alive stays)
            for pool in (self._prefilling, self._decoding, self._classic):
                for r in [r for r in pool if r.done.is_set()]:
                    pool.remove(r)
            active = self._prefilling or self._decoding or self._classic
            if not alive and not self._pending and not active:
                break
            # 1. intake — never block while there is device work to do
            if alive:
                block = not (active or self._pending)
                alive = self._drain_into_pending(
                    timeout=0.05 if block else None
                )
            # 2. deadline sweeps: pending (before a slot is spent) and
            # mid-flight (between steps) both 504 on expiry
            self._purge_expired()
            self._evict_expired_active()
            # 3. continuous admission under the token budget
            self._admit_active()
            if not (self._prefilling or self._decoding or self._classic):
                continue
            # 4. classic fallback groups run as exclusive steps:
            # immediately when nothing is steppable, and FORCED after
            # CLASSIC_STARVE_STEPS consecutive steppable steps so beam
            # rows cannot starve under sustained steppable load
            if self._classic:
                forced = self._classic_waits >= self.CLASSIC_STARVE_STEPS
                if forced or not (self._prefilling or self._decoding):
                    if forced and (self._prefilling or self._decoding):
                        self.classic_forced_steps += 1
                    self._classic_waits = 0
                    self._run_classic_step()
                    continue
                self._classic_waits += 1
            else:
                self._classic_waits = 0
            # 5. compose the step: all decode lanes + at most one prefill
            # slice, within max_step_tokens
            decode_rows = list(self._decoding)
            decode_cost = sum(r.step.cost for r in decode_rows)
            pf = self._prefilling[0] if self._prefilling else None
            run_prefill = False
            if pf is not None:
                chunk = max(1, pf.step.next_chunk)
                if not decode_rows or decode_cost + chunk <= self.max_step_tokens:
                    run_prefill = True
                elif self._starved:
                    # anti-starvation: budget excluded prefill last step
                    # too — run a prefill-only step so prefill always
                    # makes progress under sustained decode load
                    decode_rows = []
                    run_prefill = True
                    self.prefill_only_steps += 1
            self._starved = pf is not None and not run_prefill
            # 6. execute — the chaos kill point sits OUTSIDE the per-lane
            # try so a "serving.worker" fault takes the thread down and
            # exercises the watchdog, exactly like the classic loop
            step_rows = decode_rows + ([pf] if run_prefill else [])
            self._inflight = step_rows
            inject("serving.worker", rows=len(step_rows))
            self.steps_run += 1
            self.batches_run += 1
            self.rows_run += len(step_rows)
            tokens = 0
            step_failed = False
            for lane in self._engine.lanes(decode_rows):
                try:
                    tokens += int(self._engine.decode(lane))
                except BaseException as e:  # noqa: BLE001 — fail the lane only
                    step_failed = True
                    self._observe("decode_error", error=type(e).__name__)
                    for r in lane:
                        if not r.done.is_set():
                            r.finish(error=e)
                        if r in self._decoding:
                            self._decoding.remove(r)
                        self._resolve()
            if run_prefill:
                try:
                    tokens += int(self._engine.prefill_chunk(pf))
                except BaseException as e:  # noqa: BLE001 — fail the row only
                    step_failed = True
                    self._observe("decode_error", error=type(e).__name__)
                    if not pf.done.is_set():
                        pf.finish(error=e)
                    self._prefilling.remove(pf)
                    self._resolve()
                else:
                    if pf.step.phase != "prefill":
                        self._prefilling.remove(pf)
                        if pf.step.phase == "decode" and not pf.done.is_set():
                            self._decoding.append(pf)
                        else:
                            # the row finished during its final slice
                            # (EOS as first token, maxNewTokens <= 1):
                            # the step-7 reap scans only _decoding, so
                            # it must resolve here or _outstanding
                            # leaks +1 until submit sheds everything
                            self._resolve()
                    elif len(self._prefilling) > 1:
                        # round-robin: later arrivals get the next slices
                        self._prefilling.rotate(-1)
            if self._breaker is not None:
                if step_failed:
                    self._breaker.record_failure()
                else:
                    self._breaker.record_success()
            # 7. reap rows the engine finished during decode
            for r in list(self._decoding):
                if r.step.phase == "done" or r.done.is_set():
                    self._decoding.remove(r)
                    self._resolve()
            self._inflight = None
            self._observe("step", tokens=tokens, rows=len(step_rows))
        self._stop.set()
