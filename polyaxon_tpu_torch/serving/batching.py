"""Shape bucketing, cross-request coalescing and the resilience layer of
the serving fast path (own copy of `polyaxon_tpu/serving/batching.py`; the
port imports nothing of the JAX package).

**Bucketing** — prompts are LEFT-padded up to a small geometric ladder of
widths and `maxNewTokens` rounds up the same way (`choose_buckets`), so
requests of different lengths share one batched decode shape; the model
masks the pad out of attention and offsets rotary positions per row.

**Coalescing** — `DecodeCoalescer` runs ONE worker thread fed by a queue:
the HTTP handlers are producers only, and compatible requests (same
`GroupKey`; the seed is a per-row runtime argument) merge into one batched
decode of up to `max_batch` rows, waiting at most `max_wait_ms` for
stragglers. Responses scatter back through per-request events, and all
device work stays on the one worker thread.

**Resilience** — `submit` sheds (`ShedError`, HTTP 503 + Retry-After) at
`max_queue` unfinished requests, on an expired deadline and while the
`CircuitBreaker` is open; the worker drops expired or cancelled requests
BEFORE spending a decode slot on them (`DeadlineExceededError`, HTTP 504).
A crash of the worker fails its in-flight group fast (`WorkerCrashError`)
and the loop restarts; `stop(drain_s=...)` drains gracefully. Deadline
math uses `time.monotonic`. Chaos points `serving.worker` (here) and
`serving.decode` / `serving.slow` (the server's group execute) hook the
seeded FaultPlan machinery into this path.

**Tenancy** — with a `serving.tenancy.TenantAdmission`, `submit` charges
each row's token budget against its tenant BEFORE the global queue check
(a capped tenant's flood sheds `tenant_quota` on that tenant alone, and a
row refused later is never charged), and the worker picks the next group's
head by weighted fair share (smallest outstanding tokens / weight, FIFO
within a tenant). Groups still mix tenants.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..chaos.injector import inject
from ..telemetry import now as _metrics_now


# ------------------------------------------------------------------ errors
class ServingError(RuntimeError):
    """Client-visible serving failure. The HTTP layer maps the base class
    to 400 (validation); the resilience subclasses below carry their own
    status codes."""


class ShedError(ServingError):
    """Request shed at admission — queue full, breaker open, deadline
    already expired, or the server is draining. HTTP 503 + Retry-After:
    the request was NOT queued and is safe to retry elsewhere."""

    def __init__(
        self,
        message: str,
        *,
        reason: str = "overload",
        retry_after_s: float = 1.0,
    ):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class ServerClosingError(ShedError):
    """Terminal: the server is draining or shutting down. Queued requests
    failed with this will never be retried here — go elsewhere."""

    def __init__(
        self, message: str = "server shutting down", *, reason: str = "closing"
    ):
        super().__init__(message, reason=reason, retry_after_s=1.0)


class DeadlineExceededError(ServingError):
    """The request's deadline passed while it waited — dropped before a
    decode slot was spent on it (goodput, not throughput). HTTP 504."""


class ClientDisconnectedError(ServingError):
    """The streaming client went away mid-request (broken pipe). Nobody
    is listening for the result: the row is cancelled, its KV pages and
    decode slot released promptly. Never surfaces over HTTP — there is
    no client left to see it."""


class WorkerCrashError(RuntimeError):
    """The decode worker died with this group in flight; the watchdog
    failed the group fast and restarted the worker. NOT a ServingError:
    the client sees a 500, the request may or may not be safe to retry."""


def bucket_ladder(lo: int, hi: int, factor: int = 2) -> tuple[int, ...]:
    """Geometric ladder lo, lo*factor, ... capped at (and including) hi."""
    if hi < 1:
        raise ValueError(f"ladder upper bound must be >= 1, got {hi}")
    lo = max(1, min(lo, hi))
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= factor
    out.append(hi)
    return tuple(out)


def bucket_for(n: int, ladder: tuple[int, ...]) -> Optional[int]:
    """Smallest bucket >= n, or None when n exceeds the ladder."""
    for b in ladder:
        if b >= n:
            return b
    return None


def choose_buckets(
    prompt_len: int,
    max_new: int,
    prompt_ladder: tuple[int, ...],
    new_ladder: tuple[int, ...],
    seq_len: int,
) -> tuple[int, int]:
    """(prompt_bucket, new_bucket) for one request, guaranteeing
    prompt_bucket + new_bucket <= seq_len (the KV-cache size).

    Rounding both up can overflow the cache even when the raw request
    fits (seq 64, len 40 → bucket 64, new 16 → 80): prefer the largest
    ladder pair that fits, and degrade to the EXACT request shape as the
    escape hatch — correctness first, compile-sharing when possible."""
    nb = bucket_for(max_new, new_ladder) or max_new
    pb = None
    for b in prompt_ladder:
        if b >= prompt_len and b + nb <= seq_len:
            pb = b
            break
    if pb is None:
        pb = prompt_len
        if pb + nb > seq_len:
            nb = max_new
    return pb, nb


def batch_bucket(n: int, max_batch: int) -> int:
    """Round a partial batch up to the next power of two <= max_batch, so
    compiled batch shapes also form a small ladder (padded rows are dummy
    length-1 prompts whose outputs are dropped)."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs for the serving fast path, with the reference's defaults.

    `batching=False` keeps the per-request path (one request at a time,
    exact shapes). With batching, `kv_pool_pages` switches the dense
    per-group caches for the paged pool (and `prefix_cache` on it), and
    `chunked_prefill` (paged only) runs the continuous-batching step
    scheduler. The fast decode: `speculate` (verify windows of
    `draft_tokens` n-gram drafts, or a draft model with `draft_model`, and
    `adaptive_draft` steering K), `quantize` (int8 weight-only projections,
    quantized on load) and `kv_quant="int8"` (the int8 paged pool).
    Multi-tenant serving: `adapters`, `tenants`, `adapter_slots`; the
    spill tier: `spill_ram_bytes`, `spill_dir`, `spill_dir_bytes`.
    Disaggregated pools: `role`. Per-request traces: `trace`,
    `trace_ring`. `mesh_axes`: the decode mesh (`normalize_mesh_axes`),
    served by `ModelServer` over `parallel.mesh.decode_mesh`."""

    max_batch: int = 8
    max_wait_ms: float = 5.0
    prompt_buckets: Optional[tuple[int, ...]] = None  # None = auto ladder
    max_new_buckets: Optional[tuple[int, ...]] = None
    batching: bool = True
    request_timeout_s: float = 600.0
    # resilience layer
    max_queue: int = 64  # unfinished requests admitted before shedding
    default_deadline_ms: Optional[float] = None  # per-request deadlineMs wins
    drain_grace_s: float = 5.0  # stop(): budget to flush in-flight work
    breaker_threshold: int = 5  # consecutive decode failures → open
    breaker_cooldown_s: float = 1.0  # open → half-open probe interval
    # paged KV cache + streaming; kv_pool_pages=None → dense path
    kv_page_tokens: int = 128
    kv_pool_pages: Optional[int] = None
    prefix_cache: bool = True
    stream: bool = True  # expose POST /generate?stream=1
    stream_chunk_tokens: int = 8  # decode steps per emitted chunk
    # fast decode: speculative verify windows of draft_tokens drafts (the
    # same tokens as plain decode; sampled rows carry per-row seeds, which
    # serving always gives) and int8 weight-only projections (quantize on
    # load). draft_model: `draft:` overrides for a draft model, a sorted
    # (key, value) tuple (normalize_draft_model; () = the defaults, None =
    # the n-gram drafter); adaptive_draft: accept-rate-driven K (needs
    # speculate); kv_quant "int8": the int8 paged pool (needs
    # kv_pool_pages)
    speculate: bool = False
    draft_tokens: int = 4
    quantize: bool = False
    draft_model: Optional[tuple[tuple[str, object], ...]] = None
    adaptive_draft: bool = False
    kv_quant: str = "none"
    # per-request span traces and the tail-sampling ring behind /tracez
    trace: bool = True
    trace_ring: int = 256
    mesh_axes: Optional[tuple[tuple[str, int], ...]] = None
    # chunked prefill + step scheduling: slice prefill into
    # prefill_chunk_tokens-wide device steps interleaved with decode;
    # max_step_tokens bounds the tokens of one device step (all decode
    # rows plus at most one prefill slice) — the admission budget.
    # Requires the paged KV path (kv_pool_pages).
    chunked_prefill: bool = False
    prefill_chunk_tokens: int = 64
    max_step_tokens: int = 256
    # tiered prefix spill: evicted PrefixCache entries demote to a host-RAM
    # tier (spill_ram_bytes budget) and overflow to CRC-framed segment
    # files under spill_dir (spill_dir_bytes budget; None = unbounded); a
    # prefix hit on a spilled entry restores its pages into the pool
    # instead of re-prefilling. Requires kv_pool_pages + prefix_cache
    spill_ram_bytes: Optional[int] = None
    spill_dir: Optional[str] = None
    spill_dir_bytes: Optional[int] = None
    # multi-tenant serving: named LoRA adapters hot-swapped into the stacked
    # slot params (serving/adapters.py) and per-tenant admission contracts
    # (serving/tenancy.py).
    # adapters — sorted (name, source) pairs; source is an .npz path or
    #   "seed:<int>". Requires lora_rank > 0 on the served model.
    # tenants — sorted TenantSpec pair-tuples (tenancy.normalize_tenants);
    #   each may bind an adapter and carry outstanding/token caps and a
    #   fair-share weight.
    # adapter_slots — device-resident adapter slots BEYOND slot 0 (the
    #   checkpoint's own adapter); 0 = one slot per configured adapter
    adapters: tuple = ()
    tenants: tuple = ()
    adapter_slots: int = 0
    # disaggregated pools: "both" (the default) is the monolithic server;
    # "prefill" runs chunked prefill and ships the finished page set to the
    # decode replica the router names, over POST /kv_import (falling back
    # to local decode when the import fails); "decode" advertises itself
    # as an adoption target and still serves whole requests, so an outage
    # of the prefill pool degrades instead of failing
    role: str = "both"

    def ladders(self, seq_len: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
        pl = self.prompt_buckets or bucket_ladder(min(32, seq_len), seq_len)
        nl = self.max_new_buckets or bucket_ladder(min(16, seq_len), seq_len)
        return tuple(sorted(pl)), tuple(sorted(nl))


def normalize_mesh_axes(spec) -> Optional[tuple[tuple[str, int], ...]]:
    """dict or pair-tuple → the frozen `ServingConfig.mesh_axes` form,
    sorted; a mesh of all-1 axes is the single-card path and normalizes to
    None (the reference's normalizer): `ModelServer` then serves on one
    device, and any other mesh on `parallel.mesh.decode_mesh`."""
    if not spec:
        return None
    pairs = sorted(
        (str(ax), int(n))
        for ax, n in (spec.items() if hasattr(spec, "items") else spec)
    )
    for ax, n in pairs:
        if n < 1 and n != -1:
            raise ValueError(f"mesh axis {ax}={n}: sizes are >=1 (or -1)")
    if all(n == 1 for _, n in pairs):
        return None
    return tuple(pairs)


def normalize_draft_model(spec) -> Optional[tuple[tuple[str, object], ...]]:
    """dict or pair-tuple of `draft:` overrides → the frozen, hashable
    `ServingConfig.draft_model` (sorted (key, value) pairs, list values as
    tuples). None means no draft model; an EMPTY dict or tuple means "auto"
    (the model config's own `draft` defaults) and normalizes to (), which
    is not None, so the server still builds a draft."""
    if spec is None:
        return None
    pairs = spec.items() if hasattr(spec, "items") else spec
    return tuple(sorted(
        (str(k), tuple(v) if isinstance(v, list) else v) for k, v in pairs
    ))


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """Requests coalesce iff their keys are equal: one batched dispatch per
    group. Seed is deliberately absent — it is a [B] runtime argument, not
    part of the signature."""

    prompt_bucket: int
    new_bucket: int
    temperature: float
    top_k: Optional[int]
    eos_id: Optional[int]
    num_beams: int = 1
    length_penalty: float = 1.0
    # paged path: rows in one group share the (L, pb, nb) shape;
    # prompt_bucket then sizes the SUFFIX (tokens beyond the cached prefix)
    prefix_len: int = 0
    # decode mode: speculative groups run verify windows of draft_tokens + 1
    # tokens, so groups never mix modes
    speculate: bool = False
    draft_tokens: int = 0  # verify window width - 1 (0 when not speculating)
    quantize: bool = False  # server-wide, but part of the mode signature


@dataclasses.dataclass
class PendingRequest:
    tokens: list  # [prompt_len] int token ids (single row)
    prompt_len: int
    max_new: int  # what the client asked for (<= key.new_bucket)
    seed: int
    key: GroupKey
    # absolute monotonic deadline; None = no deadline (wait forever)
    deadline: Optional[float] = None
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[list] = None  # row token ids on success
    error: Optional[BaseException] = None
    # paged KV + streaming
    kv_plan: Optional[object] = None  # serving.kv.RowPlan when paged
    on_tokens: Optional[object] = None  # callable(list[int]) per decoded chunk
    on_finish: Optional[object] = None  # callable(req) on ANY terminal path
    t0: Optional[float] = None  # telemetry clock at admission (TTFT anchor)
    first_token_at: Optional[float] = None
    # the HTTP request's id, this row's index in its body, and the
    # telemetry-clock times it was submitted and finished
    request_id: Optional[str] = None
    row: int = 0
    submitted_t: Optional[float] = None
    finished_t: Optional[float] = None
    # mid-stream client disconnect: the HTTP layer flips this when the
    # socket breaks; the coalescer/scheduler notice at their next sweep and
    # release the row's resources promptly
    cancelled: bool = False
    step: Optional[object] = None  # serving.steps.RowStep on the step path
    # multi-tenant serving: the tenant this row bills against and the
    # adapter slot its decode gathers (0 = the base adapter). Per-row
    # runtime state, deliberately NOT part of GroupKey: a group mixes tenants
    tenant: str = "default"
    adapter: str = ""  # adapter name, for the registry's release on finish
    adapter_slot: int = 0
    # the request's RequestTrace (shared by its rows), or None
    trace: Optional[object] = None
    # disaggregated handoff: on a prefill-role server the router names a
    # decode replica (X-Handoff-Target); after the final prefill slice the
    # step engine exports the finished page set, parks the wire bytes
    # here and resolves the row with a sentinel error, so the HTTP handler
    # thread (not the decode worker) runs the transfer
    handoff_target: Optional[str] = None
    handoff_epoch: int = 0
    handoff_payload: Optional[bytes] = None

    def cancel(self) -> None:
        """Mark the row as abandoned by its client. Safe from any thread;
        a no-op once the row already resolved."""
        if not self.done.is_set():
            self.cancelled = True

    def finish(self, result=None, error=None):
        # idempotent: losing racers (deadline sweep vs decode completion)
        # must not clobber the outcome or re-fire resource release
        if self.done.is_set():
            return
        self.result = result
        self.error = error
        self.finished_t = _metrics_now()
        if self.on_finish is not None:
            try:
                self.on_finish(self)
            except Exception:  # noqa: BLE001 — release must not mask result
                pass
        self.done.set()

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline


class CircuitBreaker:
    """Consecutive-failure circuit breaker for the decode path.

    closed → (threshold consecutive failures) → open → (cooldown elapses,
    one probe admitted) → half_open → success closes / failure reopens.
    A probe that never reports an outcome (dropped on deadline, shed on
    shutdown) self-heals: another probe is admitted one cooldown later.

    `threshold <= 0` disables the breaker (always closed). Thread-safe:
    `allow()` runs on producer threads, `record_*` on the worker."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(
        self,
        threshold: int = 5,
        cooldown_s: float = 1.0,
        on_change: Optional[Callable[[int], None]] = None,
    ):
        self.threshold = int(threshold)
        self.cooldown_s = max(0.0, float(cooldown_s))
        self._on_change = on_change
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def state_code(self) -> int:
        """0 closed, 1 open, 2 half-open — the serving.breaker_state gauge."""
        return self._CODES[self.state]

    def _set(self, state: str) -> None:
        # callers hold _lock
        if state == self._state:
            return
        self._state = state
        if self._on_change is not None:
            try:
                self._on_change(self._CODES[state])
            except Exception:  # noqa: BLE001 — telemetry must not break flow
                pass

    def allow(self) -> bool:
        """Admission gate. In OPEN, flips to HALF_OPEN and admits ONE
        probe once the cooldown has elapsed; in HALF_OPEN, re-admits a
        probe every cooldown until some probe reports an outcome."""
        if self.threshold <= 0:
            return True
        now = time.monotonic()
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if now - self._opened_at >= self.cooldown_s:
                    self._set(self.HALF_OPEN)
                    self._probe_at = now
                    return True
                return False
            # HALF_OPEN: one probe per cooldown window
            if now - self._probe_at >= self.cooldown_s:
                self._probe_at = now
                return True
            return False

    def record_success(self) -> None:
        if self.threshold <= 0:
            return
        with self._lock:
            self._failures = 0
            self._set(self.CLOSED)

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        now = time.monotonic()
        with self._lock:
            if self._state == self.HALF_OPEN:
                # the probe failed: straight back to open, restart cooldown
                self._failures = self.threshold
                self._opened_at = now
                self._set(self.OPEN)
                return
            self._failures += 1
            if self._failures >= self.threshold:
                self._opened_at = now
                self._set(self.OPEN)


class DecodeCoalescer:
    """Single consumer thread over a BOUNDED request queue.

    The worker drains the queue into a pending deque, drops anything whose
    deadline already passed, takes the OLDEST live request's key, and
    gathers every same-key request (arrival order kept) up to `max_batch`.
    A full batch flushes immediately; a partial one waits until the oldest
    member is `max_wait_ms` old, so an isolated request pays at most the
    wait and a burst pays (almost) nothing. Requests with other keys stay
    pending — never reordered relative to their own group, never starved
    (oldest-first head selection).

    Resilience: `submit` sheds (`ShedError`) at `max_queue` unfinished
    requests, on expired deadlines, and while the breaker is open; the
    worker thread is supervised (a crash fails its in-flight group fast
    and the loop restarts); `stop(drain_s=...)` drains gracefully before
    failing the remainder with `ServerClosingError`."""

    _SHUTDOWN = object()

    def __init__(
        self,
        execute: Callable[[list[PendingRequest]], None],
        *,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 64,
        breaker: Optional[CircuitBreaker] = None,
        observer: Optional[Callable[..., None]] = None,
        tenancy=None,  # serving.tenancy.TenantAdmission
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._execute = execute
        self.max_batch = int(max_batch)
        self.max_wait = max(0.0, float(max_wait_ms)) / 1000.0
        self.max_queue = int(max_queue)
        self._breaker = breaker
        self._observer = observer
        self.tenancy = tenancy
        self._queue: queue.Queue = queue.Queue()
        self._pending: deque[PendingRequest] = deque()
        self._inflight: Optional[list[PendingRequest]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._draining = threading.Event()
        # unfinished requests in the coalescer's custody (queued, pending,
        # or in flight) — the admission bound and the drain/idle signal
        self._count_lock = threading.Lock()
        self._outstanding = 0
        # occupancy + resilience telemetry (read by /statsz and benches)
        self.batches_run = 0
        self.rows_run = 0
        self.shed_total = 0
        self.deadline_dropped = 0
        self.cancel_dropped = 0
        self.worker_restarts = 0

    # ----------------------------------------------------------- observers
    def _observe(self, event: str, **ctx) -> None:
        if self._observer is None:
            return
        try:
            self._observer(event, **ctx)
        except Exception:  # noqa: BLE001 — telemetry must not break serving
            pass

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        return self._breaker

    @property
    def depth(self) -> int:
        """Unfinished requests admitted and not yet resolved."""
        with self._count_lock:
            return self._outstanding

    @property
    def idle(self) -> bool:
        return self.depth == 0

    def _admit(self) -> None:
        with self._count_lock:
            self._outstanding += 1

    def _resolve(self, n: int = 1) -> None:
        with self._count_lock:
            self._outstanding = max(0, self._outstanding - n)

    # ------------------------------------------------------------ producer
    def submit(self, req: PendingRequest):
        """Admit one request, or shed it. Sheds are IMMEDIATE (the request
        is never queued): `ShedError` for overload/breaker/expired-at-
        admission, `ServerClosingError` while draining or stopped."""
        if self._stop.is_set():
            raise ServerClosingError("coalescer is stopped: shutting down")
        if self._draining.is_set():
            raise ServerClosingError(
                "server draining: admission closed", reason="draining"
            )
        if req.expired():
            self._shed(
                "deadline", "request deadline already expired at admission",
                tenant=req.tenant,
            )
        if self._breaker is not None and not self._breaker.allow():
            self._shed(
                "breaker_open",
                "circuit breaker open: decode is failing, try again later",
                retry_after_s=max(1.0, self._breaker.cooldown_s),
                tenant=req.tenant,
            )
        # per-tenant admission: charge the row's token budget against its
        # tenant BEFORE the global queue check, so a tenant's flood sheds as
        # `tenant_quota` on THAT tenant while everyone else's requests never
        # see a fuller queue
        release = None
        if self.tenancy is not None:
            try:
                release = self.tenancy.admit(req.tenant, req.prompt_len + req.max_new)
            except ShedError as e:
                with self._count_lock:
                    self.shed_total += 1
                self._observe("shed", reason=e.reason, tenant=req.tenant)
                raise
            prev = req.on_finish

            def _finish_release(r, _prev=prev, _rel=release):
                try:
                    if _prev is not None:
                        _prev(r)
                finally:
                    _rel()  # idempotent: exactly once per admitted row

            req.on_finish = _finish_release
        try:
            if self.depth >= self.max_queue:
                self._shed(
                    "queue_full",
                    f"decode queue full ({self.max_queue} requests in flight)",
                    tenant=req.tenant,
                )
        except BaseException:
            if release is not None:
                release()  # never charge a tenant for a row we refused
            raise
        self._admit()
        self._queue.put(req)

    def _shed(self, reason: str, message: str, retry_after_s: float = 1.0,
              tenant: Optional[str] = None):
        with self._count_lock:
            self.shed_total += 1
        self._observe("shed", reason=reason, tenant=tenant)
        raise ShedError(message, reason=reason, retry_after_s=retry_after_s)

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="decode-coalescer", daemon=True
        )
        self._thread.start()

    def drain(self, grace_s: float) -> bool:
        """Close admission and wait up to `grace_s` for every admitted
        request (queued + in flight) to resolve. Partial batches flush
        immediately while draining. Returns True when fully flushed."""
        self._draining.set()
        end = time.monotonic() + max(0.0, float(grace_s))
        while time.monotonic() < end:
            if self.idle:
                return True
            time.sleep(0.005)
        return self.idle

    def stop(self, timeout: float = 10.0, drain_s: float = 0.0):
        """Shut down. With `drain_s > 0`, first drain gracefully; whatever
        remains (queued or parked) is failed FAST with a terminal
        `ServerClosingError` — no client is left to ride out
        `request_timeout_s` against a dead server."""
        if self._thread is not None and drain_s > 0:
            self.drain(drain_s)
        self._draining.set()
        self._stop.set()
        self._queue.put(self._SHUTDOWN)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # fail fast for anything still parked — the server is going away
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not self._SHUTDOWN:
                self._pending.append(item)
        for req in list(self._pending):
            if not req.done.is_set():
                req.finish(error=ServerClosingError(
                    "server shutting down: request aborted"
                ))
            self._resolve()
        self._pending.clear()

    # ------------------------------------------------------------ consumer
    def _drain_into_pending(self, timeout: Optional[float]) -> bool:
        """Move queued requests into pending; block up to `timeout` for the
        first one. Returns False on shutdown."""
        try:
            item = self._queue.get(timeout=timeout) if timeout else self._queue.get_nowait()
        except queue.Empty:
            return True
        if item is self._SHUTDOWN:
            return False
        self._pending.append(item)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return True
            if item is self._SHUTDOWN:
                return False
            self._pending.append(item)

    def _drop_expired(self, req: PendingRequest) -> None:
        self.deadline_dropped += 1
        self._observe("deadline_dropped")
        budget = ""
        if req.deadline is not None:
            budget = f" ({(req.deadline - req.enqueued_at) * 1e3:.0f}ms budget)"
        req.finish(error=DeadlineExceededError(
            f"deadline exceeded before decode dispatch{budget}"
        ))
        self._resolve()

    def _drop_cancelled(self, req: PendingRequest) -> None:
        self.cancel_dropped += 1
        self._observe("client_cancelled")
        req.finish(error=ClientDisconnectedError(
            "client disconnected before decode dispatch"
        ))
        self._resolve()

    def _purge_expired(self) -> None:
        """Drop every pending request whose deadline has passed — BEFORE a
        decode slot is spent on it (goodput over throughput). Cancelled
        rows (client gone) go the same way: nobody wants their tokens."""
        if not self._pending:
            return
        now = time.monotonic()
        for r in [r for r in self._pending if r.cancelled]:
            self._pending.remove(r)
            self._drop_cancelled(r)
        dead = [r for r in self._pending if r.expired(now)]
        for r in dead:
            self._pending.remove(r)
            self._drop_expired(r)

    def _run(self):
        """Worker thread body: `_loop` under a watchdog. A crash anywhere
        in the loop fails the in-flight group fast (the clients see a
        `WorkerCrashError`, not a `request_timeout_s` hang), counts a
        breaker failure, and restarts the loop over the surviving queue."""
        while True:
            try:
                self._loop()
                return  # clean shutdown
            except BaseException as e:  # noqa: BLE001 — supervise, restart
                batch, self._inflight = self._inflight, None
                for r in batch or ():
                    if not r.done.is_set():
                        r.finish(error=WorkerCrashError(
                            f"decode worker crashed mid-group: {e!r}"
                        ))
                if batch:
                    self._resolve(len(batch))
                if self._breaker is not None:
                    self._breaker.record_failure()
                self.worker_restarts += 1
                self._observe("worker_restart", error=repr(e))
                if self._stop.is_set():
                    return

    def _loop(self):
        alive = True
        while alive or self._pending:
            if self._stop.is_set():
                # stop() is failing the remainder fast — decoding on past
                # the drain budget would silently overrun it
                return
            self._purge_expired()
            if not self._pending:
                alive = self._drain_into_pending(timeout=0.1)
                continue
            # weighted fair head pick: among tenants with pending work, serve
            # the one with the smallest outstanding tokens / weight (FIFO
            # within a tenant by enqueue time); without tenancy this is the
            # oldest-first rule. The group still mixes tenants: the head
            # only chooses WHICH key flushes next
            if self.tenancy is not None and len(self._pending) > 1:
                head = min(
                    self._pending,
                    key=lambda r: (self.tenancy.share(r.tenant), r.enqueued_at),
                )
            else:
                head = self._pending[0]
            batch = [r for r in self._pending if r.key == head.key][
                : self.max_batch
            ]
            now = time.monotonic()
            # cap the wait at the earliest pending deadline so the purge
            # above runs the moment any row expires: no row is dropped
            # after the group's tokens were spent around it
            dmin = min(
                (r.deadline for r in self._pending if r.deadline is not None),
                default=None,
            )
            if dmin is not None and dmin <= now:
                self._purge_expired()
                continue
            deadline = head.enqueued_at + self.max_wait
            if dmin is not None:
                deadline = min(deadline, dmin)
            if (
                len(batch) < self.max_batch
                and now < deadline
                and alive
                and not self._draining.is_set()
            ):
                # wait (bounded by the head's age AND the earliest pending
                # deadline) for coalescable arrivals
                alive = self._drain_into_pending(timeout=deadline - now)
                continue
            for r in batch:
                self._pending.remove(r)
            # last look before spending the slot: drop the already-dead
            now = time.monotonic()
            live = []
            for r in batch:
                if r.cancelled:
                    self._drop_cancelled(r)
                elif r.expired(now):
                    self._drop_expired(r)
                else:
                    live.append(r)
            if not live:
                continue
            batch = live
            self._inflight = batch
            # chaos point: a "kill" here takes the worker thread down with
            # this group in flight — the watchdog must recover
            inject("serving.worker", rows=len(batch))
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
            # opportunistically pick up anything that arrived mid-execute
            if alive:
                alive = self._drain_into_pending(timeout=None)
        self._stop.set()
