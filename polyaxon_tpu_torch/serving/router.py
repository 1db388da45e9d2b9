"""Fleet-facing HTTP router over N ModelServer replicas, an own copy of
`polyaxon_tpu/serving/router.py`.

One replica caps serving throughput at one coalescer and makes every
redeploy an outage; the router is the horizontal layer that turns a set
of replicas into one service. It is deliberately model-free — no torch
import, and tokens are parsed off the wire only when prefix affinity has
somewhere to send them — so it forwards bytes at HTTP speed while the
replicas do the math:

**Discovery + health** — a poll loop re-reads the endpoint provider
(static list or `ReplicaSetManager.endpoints`) and probes each replica's
`/readyz`, `/metricsz`, and `/kvz` every `poll_interval_s`. A replica is
routable when ready and not marked draining; its scraped
`serving_queue_depth` and the delta of
`serving_queue_wait_seconds_sum/_count` between polls feed the balancer,
its `/metricsz` text is parsed ONCE per poll and that one snapshot feeds
the balancer, `/statsz` cluster rollups, and metrics federation alike,
and its `/kvz` prefix advertisement feeds the affinity directory.

**Balancing** — join-shortest-queue with power-of-two-choices: two
distinct candidates are sampled (seeded RNG, deterministic in tests) and
the one with the smaller (router-local in-flight + scraped queue depth,
weighted by the replica's scraped device count so a 2x slice absorbs 2x
queue, queue-wait tiebreak) score wins. In-flight counts are the
router's own, updated synchronously around each forward, so the signal
does not stale between scrapes the way pure JSQ-on-metrics would.

**Prefix affinity** — replicas advertise the content-hash
chain heads of their resident + spilled KV prefixes on `/kvz`; the
router keeps a `serving/affinity.py` PrefixDirectory and, when a
routable replica holds a prefix of the incoming prompt, routes there
first so the warm replica reuses (or restores from spill) the prefill
instead of a cold sibling re-computing it. Stickiness yields to load:
when the best holder's weighted queue exceeds the fleet minimum by more
than `affinity_imbalance`, the request falls back to plain JSQ+P2C —
a hot prefix must not melt one replica while siblings idle. The
directory is a hint; the replica re-verifies token content, so stale
advertisements cost one prefill, never wrong KV.

**Retry on sibling** — a 503 shed is, by the replica's own contract,
"never queued, safe to retry" (serving/batching.py), so the router
replays it on the next-best sibling instead of bouncing it to the
client; likewise connection failures and worker-crash 500s (decode is
deterministic, so the replay is idempotent). Deadline sheds are NOT
retried — the deadline is just as expired on the sibling. Mid-stream
failover replays the whole request on a sibling and trims the tokens
each row already received (exact, because decode is byte-identical for
a given seed), so a replica kill mid-SSE is invisible to the client.

**Autoscale** — the SLO burn-rate engine watches upstream sheds
over router requests; a breach edge scales the replica set up (through
`ReplicaSetManager.scale_to`), and a sustained calm window scales it
back down. Both respect the policy's min/max and cooldown.

Clocks: ONLY `telemetry.registry.now()` (the sanctioned monotonic
metrics clock) — wall clocks would make queue-wait math and the burn
engine lie across NTP steps.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence
from urllib import error as urlerror
from urllib import request as urlrequest

from ..telemetry import (
    HistoryStore,
    MetricsRegistry,
    RequestTrace,
    TraceRing,
    new_trace_id,
    now as _now,
    queryz_payload,
)
from ..telemetry.history import sample_from_snapshots, sample_registry
from ..telemetry.federate import (
    PromSnapshot,
    federate,
    parse_prometheus_text,
    queue_wait_delta_ms,
    sum_values,
)
from ..telemetry.slo import AvailabilityObjective, SLOEngine
from ..telemetry.tracing import graft_spans, tracez_payload
from .affinity import PrefixDirectory

# replica 503 reasons that must NOT be replayed on a sibling: the
# request's own budget is spent, not the replica's
_NO_RETRY_REASONS = frozenset({"deadline"})


def parse_prometheus(text: str) -> dict[str, float]:
    """Flat name → value view of a Prometheus exposition (back-compat
    shim over the shared parser in telemetry/federate.py; labeled
    samples are excluded — a flat dict cannot hold them)."""
    return parse_prometheus_text(text).flat()


def _trace_status(code: int) -> str:
    """HTTP status → trace status, mirroring the replica's taxonomy so
    a stitched timeline reads one vocabulary end to end."""
    if 200 <= code < 400:
        return "ok"
    if code == 503:
        return "shed"
    if code == 504:
        return "deadline_exceeded"
    return "error"


@dataclasses.dataclass
class ReplicaState:
    """What the router knows about one replica between polls."""

    url: str  # base URL, e.g. http://127.0.0.1:8301
    slug: str  # stable metric suffix, e.g. r0
    healthy: bool = False
    draining: bool = False  # rolling redeploy: routable = healthy & ~draining
    queue_depth: float = 0.0  # scraped serving_queue_depth
    queue_wait_ms: float = 0.0  # EWMA of scraped queue-wait deltas
    inflight: int = 0  # router-local outstanding forwards
    requests: int = 0  # forwards attempted at this replica
    # last successful /metricsz scrape, verbatim — the federation source
    # (None = last scrape failed: federation_source_up goes 0)
    metrics_text: Optional[str] = None
    # the SAME scrape parsed once: balancer,
    # federation, cluster_stats, and the prefix directory all read this
    # snapshot instead of re-parsing the text per consumer
    metrics_snap: Optional[PromSnapshot] = None
    # scraped capacity weight (serving_mesh_devices): a 2x slice absorbs
    # 2x queue before weighted-JSQ considers it equally loaded
    weight: float = 1.0
    # /kvz advertisement: page size of this replica's KV pool (0 = no
    # paged KV / prefix cache disabled / scrape failed)
    kv_page_tokens: int = 0
    kv_heads: int = 0  # advertised prefix head count (stats surface)
    # disaggregated pools: the role the replica advertises on
    # /readyz — "prefill" replicas get a decode sibling named in
    # X-Handoff-Target; "both" (monolithic) is the safe default
    role: str = "both"
    # last scraped cumulative queue-wait sums, for the delta
    _wait_sum: float = 0.0
    _wait_count: float = 0.0

    @property
    def routable(self) -> bool:
        return self.healthy and not self.draining

    def load(self) -> float:
        """Weighted effective queue: (router-local in-flight + scraped
        depth) per unit of scraped capacity."""
        return (self.inflight + self.queue_depth) / max(self.weight, 1e-9)

    def score(self) -> tuple[float, float]:
        """JSQ key: shortest weighted queue first, queue-wait tiebreak."""
        return (self.load(), self.queue_wait_ms)


class P2CBalancer:
    """Join-shortest-queue with power-of-two-choices: against stale
    scrape data, sampling two and taking the shorter queue avoids the
    thundering-herd-on-the-one-idle-replica failure of full JSQ while
    staying within a constant factor of it. Seeded RNG: tests inject a
    known seed and get a deterministic pick sequence."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def pick(self, candidates: Sequence[ReplicaState]) -> ReplicaState:
        if not candidates:
            raise ValueError("no candidates")
        if len(candidates) <= 2:
            return min(candidates, key=ReplicaState.score)
        with self._lock:
            two = self._rng.sample(list(candidates), 2)
        return min(two, key=ReplicaState.score)

    def order(
        self, candidates: Sequence[ReplicaState]
    ) -> list[ReplicaState]:
        """First choice via P2C, then every remaining candidate by score
        — the retry ladder walks this list."""
        if not candidates:
            return []
        first = self.pick(candidates)
        rest = sorted(
            (c for c in candidates if c is not first),
            key=ReplicaState.score,
        )
        return [first, *rest]


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """When to grow/shrink the replica set. Scale-up rides the SLO
    burn engine (shed fraction over router requests); scale-down needs
    a sustained calm window so one quiet poll doesn't thrash."""

    min_replicas: int = 1
    max_replicas: int = 4
    objective: float = 0.99  # <=1% of requests shed upstream
    windows_s: tuple[float, ...] = (15.0, 60.0)
    burn_threshold: float = 1.0
    cooldown_s: float = 30.0  # min gap between scaling actions
    calm_queue_wait_ms: float = 50.0  # every replica under this, and
    calm_for_s: float = 120.0  # ...for this long → scale down


class Router:
    """The replica-fleet front door. `endpoints` is a static URL list or
    a zero-arg callable returning one (ReplicaSetManager.endpoints) —
    the poll loop re-reads it, so replicas that restart on new ports or
    appear via autoscale are picked up within one poll interval."""

    def __init__(
        self,
        endpoints,
        *,
        registry: Optional[MetricsRegistry] = None,
        balancer: Optional[P2CBalancer] = None,
        poll_interval_s: float = 0.5,
        probe_timeout_s: float = 2.0,
        request_timeout_s: float = 600.0,
        scaler=None,  # needs .scale_to(n) and .target (ReplicaSetManager)
        autoscale: Optional[AutoscalePolicy] = None,
        trace: bool = True,
        trace_ring: int = 256,
        stitch: bool = True,
        federate: bool = True,
        affinity: bool = True,
        affinity_imbalance: float = 4.0,
        history: Optional[dict] = None,
    ):
        self._provider: Callable[[], Sequence[str]] = (
            endpoints if callable(endpoints) else (lambda: endpoints)
        )
        self.telemetry = registry or MetricsRegistry()
        self.balancer = balancer or P2CBalancer()
        self.poll_interval_s = float(poll_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self._states: list[ReplicaState] = []
        self._rlock = threading.Lock()
        self._m_requests = self.telemetry.counter(
            "router.requests", help="Client requests accepted by the router"
        )
        self._m_retries = self.telemetry.counter(
            "router.retries",
            help="Forwards replayed on a sibling replica "
            "(shed / connection failure / mid-stream failover)",
        )
        self._m_upstream_shed = self.telemetry.counter(
            "router.upstream_shed",
            help="503 sheds received from replicas (autoscale signal)",
        )
        self._m_errors = self.telemetry.counter(
            "router.errors",
            help="Requests that failed on every candidate replica",
        )
        self._m_latency = self.telemetry.histogram(
            "router.request_seconds",
            help="Router-side end-to-end request latency, seconds",
        )
        self._m_healthy_total = self.telemetry.gauge(
            "router.replicas_routable",
            help="Replicas currently healthy and not draining",
        )
        # prefix-affinity routing: replicas advertise resident
        # prefix heads on /kvz; warm prompts stick to their holder unless
        # its weighted load exceeds the fleet minimum by more than
        # `affinity_imbalance` effective-queue units
        self.affinity_enabled = bool(affinity)
        self.affinity_imbalance = float(affinity_imbalance)
        self.directory = PrefixDirectory()
        self._m_affinity_hits = self.telemetry.counter(
            "router.affinity_hits",
            help="Requests routed to a replica advertising a prefix of "
            "the prompt (cluster-wide warm-KV reuse)",
        )
        # cluster observability plane: router-side request traces (with
        # the replica-side timeline grafted in) + metrics federation
        self.trace_enabled = bool(trace)
        self.stitch_enabled = bool(trace and stitch)
        self.federate_enabled = bool(federate)
        self.traces = TraceRing(capacity=max(1, int(trace_ring)))
        self._m_stitched = self.telemetry.counter(
            "router.traces_stitched",
            help="Replica-side traces grafted into router traces",
        )
        self._m_stitch_misses = self.telemetry.counter(
            "router.stitch_misses",
            help="Upstream attempts whose replica trace could not be "
            "fetched (sampler dropped it, or the replica died)",
        )
        # stitching happens at READ time (`tracez`), never on the
        # serving path: the remote /tracez fetch is paid by the operator
        # looking at a trace, not by the request being traced.
        self._stitch_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        self._stop_poll = threading.Event()
        # autoscale (optional): shed-burn breach edge → scale up; calm
        # window → scale down. The engine's gauges land on /metricsz.
        self.scaler = scaler
        self.autoscale = autoscale
        self.slo_engine: Optional[SLOEngine] = None
        self._last_scale_t = 0.0
        self._calm_since: Optional[float] = None
        if scaler is not None and autoscale is not None:
            self.slo_engine = SLOEngine(
                [
                    AvailabilityObjective(
                        "router-upstream-shed",
                        autoscale.objective,
                        bad=[self._m_upstream_shed],
                        total=[self._m_requests],
                        windows_s=autoscale.windows_s,
                        burn_threshold=autoscale.burn_threshold,
                    )
                ],
                self.telemetry,
                on_breach=self._scale_up,
            )
        # FEDERATED metrics history: one store on the router
        # holds every replica's series (`<name>{replica="rN"}`) plus
        # `cluster:*:sum` rollups plus the router's own registry — the
        # poll loop appends one sample per pass, so history cadence rides
        # poll_interval_s, and /queryz answers fleet-wide trend queries.
        # `history` is {"dir", "interval_s", "max_bytes", "segment_bytes"}.
        self.history: Optional[HistoryStore] = None
        self._m_history_samples = None
        self._m_history_bytes = None
        if history is not None and history.get("dir"):
            self.history = HistoryStore(
                history["dir"],
                max_bytes=int(
                    history.get("max_bytes") or HistoryStore.DEFAULT_MAX_BYTES
                ),
                segment_bytes=int(
                    history.get("segment_bytes")
                    or HistoryStore.DEFAULT_SEGMENT_BYTES
                ),
            )
            self._m_history_samples = self.telemetry.counter(
                "history.samples",
                help="Federated history samples committed to the store",
            )
            self._m_history_bytes = self.telemetry.gauge(
                "history.bytes",
                help="Total bytes across history segments (all tiers)",
            )
        self.refresh()

    # ---------------------------------------------------------- replicas
    def refresh(self) -> None:
        """Sync states with the provider; slugs are positional (r0, r1,
        ...) so a replica restarted on a new port keeps its series."""
        urls = list(self._provider())
        with self._rlock:
            for i, url in enumerate(urls):
                if i < len(self._states):
                    if self._states[i].url != url:
                        self._states[i] = ReplicaState(url=url, slug=f"r{i}")
                else:
                    self._states.append(ReplicaState(url=url, slug=f"r{i}"))
            del self._states[len(urls):]

    def states(self) -> list[ReplicaState]:
        with self._rlock:
            return list(self._states)

    def mark_draining(self, url: str, draining: bool = True) -> None:
        """Rolling redeploy: take a replica out of rotation BEFORE its
        drain starts, so no request races the admission close."""
        with self._rlock:
            for s in self._states:
                if s.url == url:
                    s.draining = draining

    def _probe(self, s: ReplicaState) -> None:
        role = s.role
        try:
            with urlrequest.urlopen(
                s.url + "/readyz", timeout=self.probe_timeout_s
            ) as r:
                adv = json.loads(r.read())
                ready = adv.get("ready", False)
                role = str(adv.get("role") or "both")
        except urlerror.HTTPError as e:
            # /readyz answers 503 with the same body while draining —
            # including the role, so a draining replica keeps its pool
            try:
                adv = json.loads(e.read())
                ready = bool(adv.get("ready", False))
                role = str(adv.get("role") or "both")
            except Exception:
                ready = False
        except Exception:
            s.healthy = False
            return
        s.healthy = bool(ready)
        s.role = role
        try:
            with urlrequest.urlopen(
                s.url + "/metricsz", timeout=self.probe_timeout_s
            ) as r:
                text = r.read().decode()
        except Exception:
            # keep last-known queue signal for balancing, but mark the
            # federation source down — an absent replica must be visible
            s.metrics_text = None
            s.metrics_snap = None
            self._probe_kv(s)
            return
        # parse ONCE: this snapshot serves the balancer (below), metrics
        # federation, and /statsz cluster rollups for the whole interval
        snap = parse_prometheus_text(text)
        s.metrics_text = text
        s.metrics_snap = snap
        s.queue_depth = snap.value("serving_queue_depth", 0.0)
        s.weight = snap.value("serving_mesh_devices", 0.0) or 1.0
        delta_ms, wsum, wcount = queue_wait_delta_ms(
            snap, s._wait_sum, s._wait_count
        )
        if delta_ms is not None:
            # EWMA so one anomalous poll doesn't own the routing decision
            s.queue_wait_ms = (
                delta_ms
                if s._wait_count == 0
                else 0.5 * s.queue_wait_ms + 0.5 * delta_ms
            )
        s._wait_sum, s._wait_count = wsum, wcount
        self._probe_kv(s)

    def _probe_kv(self, s: ReplicaState) -> None:
        """Refresh the prefix directory from the replica's `/kvz`
        advertisement (same poll pass as /metricsz — no extra cadence).
        Any failure, including an older replica 404ing the route, clears
        the replica's entry: no advertisement, no affinity."""
        if not self.affinity_enabled:
            return
        try:
            with urlrequest.urlopen(
                s.url + "/kvz", timeout=self.probe_timeout_s
            ) as r:
                adv = json.loads(r.read())
            heads = adv.get("heads") or []
            pt = int(adv.get("pageTokens") or 0) if adv.get("enabled") else 0
            namespaces = adv.get("namespaces") or {}
        except Exception:
            heads, pt, namespaces = [], 0, {}
        s.kv_page_tokens = pt
        s.kv_heads = len(heads) if pt else 0
        self.directory.update(s.slug, pt, heads, namespaces)

    def poll_once(self) -> None:
        """One discovery + health pass (the loop body; tests call it
        directly for determinism)."""
        self.refresh()
        for s in self.states():
            self._probe(s)
            self.telemetry.gauge(
                f"router.replica_healthy.{s.slug}",
                help="1 when the replica is ready and routable",
            ).set(1.0 if s.routable else 0.0)
            self.telemetry.gauge(
                f"router.replica_queue_wait_ms.{s.slug}",
                help="Scraped queue-wait EWMA driving JSQ, milliseconds",
            ).set(round(s.queue_wait_ms, 3))
            self.telemetry.gauge(
                f"router.replica_queue_depth.{s.slug}",
                help="Scraped coalescer queue depth",
            ).set(s.queue_depth)
            if self.affinity_enabled:
                self.telemetry.gauge(
                    f"router.replica_prefix_heads.{s.slug}",
                    help="Prefix chain heads the replica advertises on "
                    "/kvz (resident + spilled)",
                ).set(s.kv_heads)
        self._m_healthy_total.set(
            sum(1 for s in self.states() if s.routable)
        )
        self._autoscale_tick()
        self._record_history()

    def _record_history(self) -> None:
        """Append one federated sample: the router's own registry merged
        with every replica's `replica=`-labeled series and `cluster:*`
        rollups (built from the poll pass's parsed snapshots — no extra
        scrape). Advisory: a full disk must never kill the poll loop."""
        if self.history is None:
            return
        t = _now()
        try:
            rec = sample_registry(self.telemetry, t)
            fed = sample_from_snapshots(
                [(s.slug, s.metrics_snap) for s in self.states()], t
            )
            rec["s"].update(fed["s"])
            self.history.append(rec)
            self._m_history_samples.inc()
            self._m_history_bytes.set(float(self.history.total_bytes()))
        except Exception:
            pass

    def _poll_loop(self) -> None:
        while not self._stop_poll.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:
                pass  # discovery must outlive any one bad poll

    # --------------------------------------------------------- autoscale
    def _scale_up(self, breach: dict) -> None:
        if self.scaler is None or self.autoscale is None:
            return
        t = _now()
        if t - self._last_scale_t < self.autoscale.cooldown_s:
            return
        target = min(self.autoscale.max_replicas, self.scaler.target + 1)
        if target > self.scaler.target:
            self._last_scale_t = t
            self._calm_since = None
            self.scaler.scale_to(target)

    def _autoscale_tick(self) -> None:
        if self.slo_engine is not None:
            self.slo_engine.evaluate()  # breach edge calls _scale_up
        if self.scaler is None or self.autoscale is None:
            return
        pol = self.autoscale
        states = self.states()
        calm = (
            len(states) > 0
            and all(s.routable for s in states)
            and all(s.queue_wait_ms <= pol.calm_queue_wait_ms for s in states)
            and all(s.inflight + s.queue_depth == 0 for s in states)
        )
        t = _now()
        if not calm:
            self._calm_since = None
            return
        if self._calm_since is None:
            self._calm_since = t
            return
        if (
            t - self._calm_since >= pol.calm_for_s
            and t - self._last_scale_t >= pol.cooldown_s
            and self.scaler.target > pol.min_replicas
        ):
            self._last_scale_t = t
            self._calm_since = None
            self.scaler.scale_to(self.scaler.target - 1)

    # -------------------------------------------------------- forwarding
    def _candidates(self) -> list[ReplicaState]:
        with self._rlock:
            routable = [s for s in self._states if s.routable]
            # nothing probed healthy yet (cold start): try them all
            # rather than bouncing the request
            return routable or [
                s for s in self._states if not s.draining
            ] or list(self._states)

    def _order(
        self, body: bytes, trace: Optional[RequestTrace] = None, tenant: str = ""
    ) -> list[ReplicaState]:
        """Candidate order for one request: affinity-first when some
        candidate advertises a prefix of the prompt (and isn't drowning),
        else plain JSQ+P2C. The body is parsed for tokens ONLY when the
        directory is non-empty — an affinity-less fleet keeps the
        zero-parse happy path."""
        candidates = self._candidates()
        order = self.balancer.order(candidates)
        roles = {s.role for s in order}
        if "prefill" in roles and len(roles) > 1:
            # disaggregated pools: a fresh prompt starts on
            # the best prefill replica; decode-capable siblings follow —
            # exactly where the post-handoff retry (the 503 with reason
            # kv_handoff_done, or the in-band stream error frame) lands.
            # A prefill-only fleet keeps plain JSQ order and decodes
            # monolithically; affinity below may still promote a warm
            # holder to the front.
            pre = [s for s in order if s.role == "prefill"]
            rest = [s for s in order if s.role != "prefill"]
            order = [pre[0], *rest, *pre[1:]]
        if (
            not self.affinity_enabled
            or len(order) < 2  # nothing to choose between
            or self.directory.empty
        ):
            return order
        tokens, body_tenant = _first_row_tokens(body)
        if not tokens:
            return order
        # the body's tenant wins over the header's, as on the replica
        matches = self.directory.match(tokens, body_tenant or tenant)
        holders = [s for s in order if matches.get(s.slug)]
        if not holders:
            return order
        # longest prefix wins; weighted load breaks ties between holders
        best = min(holders, key=lambda s: (-matches[s.slug], s.score()))
        # stickiness yields to imbalance: a hot prefix must not melt its
        # holder while siblings idle
        min_load = min(s.load() for s in order)
        if best.load() - min_load > self.affinity_imbalance:
            if trace is not None:
                trace.annotate(
                    "affinity_overload", replica=best.slug,
                    pages=matches[best.slug],
                )
            return order
        self._m_affinity_hits.inc()
        if trace is not None:
            trace.annotate(
                "affinity", replica=best.slug, pages=matches[best.slug]
            )
        return [best, *[s for s in order if s is not best]]

    def forward(
        self,
        body: bytes,
        rid: str,
        *,
        query: str = "",
        tenant: str = "",
        trace: Optional[RequestTrace] = None,
    ) -> tuple[int, bytes, dict]:
        """Non-streaming forward: returns (status, payload bytes,
        headers) of the first acceptable upstream answer — payload bytes
        verbatim, so the client sees exactly what the replica wrote."""
        t_bal = _now()
        order = self._order(body, trace, tenant)
        if trace is not None:
            trace.add(
                "balance", start=t_bal, dur_s=_now() - t_bal,
                candidates=len(order),
            )
        if not order:
            if trace is not None:
                trace.annotate("no_replicas")
            return 503, json.dumps(
                {"error": "router: no replicas", "reason": "no_replicas"}
            ).encode(), {}
        last: tuple[int, bytes, dict] = (
            502,
            json.dumps(
                {"error": "router: all replicas failed", "reason": "upstream"}
            ).encode(),
            {},
        )
        for i, s in enumerate(order):
            if i > 0:
                self._m_retries.inc()
            t_att = _now()
            status, payload, headers = self._forward_once(
                s, body, rid, query, tenant,
                handoff=self._handoff_for(s, order, i),
            )
            retryable = self._retryable(status, payload)
            if trace is not None:
                trace.add(
                    "upstream_attempt", start=t_att, dur_s=_now() - t_att,
                    replica=s.slug, url=s.url, attempt=i, status=status,
                )
                if retryable and i + 1 < len(order):
                    trace.annotate(
                        "retry", attempt=i, from_replica=s.slug,
                        status=status,
                    )
            if not retryable:
                return status, payload, headers
            last = (status, payload, headers)
        self._m_errors.inc()
        return last

    def _retryable(self, status: int, payload: bytes) -> bool:
        if status in (502, 599):  # router-synthesized connection failure
            return True
        if status == 500:
            return True  # worker crash; decode is deterministic → idempotent
        if status == 503:
            self._m_upstream_shed.inc()
            try:
                reason = json.loads(payload).get("reason")
            except Exception:
                reason = None
            return reason not in _NO_RETRY_REASONS
        return False

    def _handoff_for(
        self, s: ReplicaState, order: list[ReplicaState], attempt: int
    ) -> Optional[tuple[str, int]]:
        """(decode target URL, epoch) for a forward to `s`, or None.
        Only a prefill replica gets a target, and only when a
        decode-capable sibling is in the candidate order — otherwise the
        header is omitted and the prefill replica degrades to monolithic
        decode locally. The epoch is the router attempt index: a
        failed-over request's later exporter always outranks the stale
        one at the decode side's lease table."""
        if s.role != "prefill":
            return None
        sinks = [c for c in order if c is not s and c.role != "prefill"]
        if not sinks:
            return None
        return sinks[0].url, attempt

    def _forward_once(
        self, s: ReplicaState, body: bytes, rid: str, query: str,
        tenant: str = "",
        handoff: Optional[tuple[str, int]] = None,
    ) -> tuple[int, bytes, dict]:
        url = s.url + "/generate" + (f"?{query}" if query else "")
        headers = {
            "Content-Type": "application/json",
            "X-Request-Id": rid,
        }
        # tenancy: the client's X-Tenant rides every upstream
        # hop — body bytes stay verbatim, the replica folds the header
        # into admission exactly as on a direct request
        if tenant:
            headers["X-Tenant"] = tenant
        if handoff is not None:
            headers["X-Handoff-Target"] = handoff[0]
            headers["X-Handoff-Epoch"] = str(handoff[1])
        req = urlrequest.Request(
            url,
            data=body,
            headers=headers,
            method="POST",
        )
        with self._rlock:
            s.inflight += 1
            s.requests += 1
        try:
            with urlrequest.urlopen(
                req, timeout=self.request_timeout_s
            ) as r:
                return r.status, r.read(), dict(r.headers)
        except urlerror.HTTPError as e:
            try:
                payload = e.read()
            except Exception:
                payload = b"{}"
            return e.code, payload, dict(e.headers or {})
        except Exception as e:  # URLError, ConnectionError, timeout
            return 599, json.dumps(
                {"error": f"router: {type(e).__name__}: {e}",
                 "reason": "connect"}
            ).encode(), {}
        finally:
            with self._rlock:
                s.inflight -= 1

    # -------------------------------------------------------- streaming
    def forward_stream(
        self,
        body: bytes,
        rid: str,
        *,
        query: str = "",
        tenant: str = "",
        trace: Optional[RequestTrace] = None,
    ):
        """Generator of raw SSE frame bytes, with mid-stream failover.

        The happy path relays the replica's frames VERBATIM (byte
        identity with a direct request holds because the replica embeds
        the same X-Request-Id). Every frame is also parsed to track how
        many tokens each row has already received; when an upstream dies
        mid-stream — connection drop or the in-band row-less error frame
        — the whole request replays on the next sibling and each row's
        already-delivered prefix is trimmed (decode is deterministic per
        seed, so the replay's tokens match what the dead replica sent).

        Raises _StreamError(status, payload, headers) if no upstream
        could even start a stream; yields frames otherwise.
        """
        sent: dict[int, int] = {}  # row → tokens already delivered
        done_rows: set[int] = set()
        t_bal = _now()
        order = self._order(body, trace, tenant)
        if trace is not None:
            trace.add(
                "balance", start=t_bal, dur_s=_now() - t_bal,
                candidates=len(order), streamed=True,
            )
        if not order:
            if trace is not None:
                trace.annotate("no_replicas")
            raise _StreamError(
                503,
                json.dumps(
                    {"error": "router: no replicas", "reason": "no_replicas"}
                ).encode(),
                {},
            )
        started = False
        last_err: Optional[_StreamError] = None
        for i, s in enumerate(order):
            if i > 0:
                self._m_retries.inc()
                if trace is not None:
                    # mid-stream death replays on a sibling (failover);
                    # a pre-stream refusal is an ordinary retry
                    trace.annotate(
                        "failover" if started else "retry",
                        attempt=i, to_replica=s.slug,
                    )
            t_att = _now()
            try:
                gen = self._stream_once(
                    s, body, rid, query, sent, done_rows, tenant,
                    handoff=self._handoff_for(s, order, i),
                )
                for frame in gen:
                    started = True
                    yield frame
                if trace is not None:
                    trace.add(
                        "upstream_attempt", start=t_att,
                        dur_s=_now() - t_att, replica=s.slug, url=s.url,
                        attempt=i, status=200, streamed=True,
                    )
                return  # terminal {"done": true} seen
            except _StreamError as e:
                if trace is not None:
                    trace.add(
                        "upstream_attempt", start=t_att,
                        dur_s=_now() - t_att, replica=s.slug, url=s.url,
                        attempt=i, status=e.status, streamed=True,
                    )
                if not e.retryable:
                    if started:
                        break  # can't re-raise a status mid-stream
                    raise
                last_err = e
                continue
        # every sibling failed
        self._m_errors.inc()
        if started:
            yield (
                b"data: "
                + json.dumps(
                    {"error": "router: upstream lost mid-stream and no "
                     "sibling could resume", "requestId": rid}
                ).encode()
                + b"\n\n"
            )
            return
        raise last_err if last_err is not None else _StreamError(
            502,
            json.dumps(
                {"error": "router: all replicas failed", "reason": "upstream"}
            ).encode(),
            {},
        )

    def _stream_once(
        self,
        s: ReplicaState,
        body: bytes,
        rid: str,
        query: str,
        sent: dict[int, int],
        done_rows: set[int],
        tenant: str = "",
        handoff: Optional[tuple[str, int]] = None,
    ):
        q = query or "stream=1"
        if "stream=1" not in q.split("&"):
            q += "&stream=1"
        headers = {
            "Content-Type": "application/json",
            "X-Request-Id": rid,
        }
        if tenant:
            headers["X-Tenant"] = tenant
        if handoff is not None:
            headers["X-Handoff-Target"] = handoff[0]
            headers["X-Handoff-Epoch"] = str(handoff[1])
        req = urlrequest.Request(
            s.url + "/generate?" + q,
            data=body,
            headers=headers,
            method="POST",
        )
        with self._rlock:
            s.inflight += 1
            s.requests += 1
        try:
            try:
                resp = urlrequest.urlopen(req, timeout=self.request_timeout_s)
            except urlerror.HTTPError as e:
                try:
                    payload = e.read()
                except Exception:
                    payload = b"{}"
                raise _StreamError(
                    e.code,
                    payload,
                    dict(e.headers or {}),
                    retryable=self._retryable(e.code, payload),
                )
            except _StreamError:
                raise
            except Exception as e:
                raise _StreamError(
                    599,
                    json.dumps(
                        {"error": f"router: {type(e).__name__}: {e}",
                         "reason": "connect"}
                    ).encode(),
                    {},
                    retryable=True,
                )
            with resp:
                seen: dict[int, int] = {}  # row → tokens THIS attempt
                finished = False
                for frame in _iter_sse_frames(resp):
                    ev = _parse_frame(frame)
                    if ev is None:
                        continue
                    if "error" in ev:
                        # replica-side failure, whole-stream (row-less
                        # frame) or per-row (worker crash / decode error
                        # scatters {"row": i, "error": ...} to every
                        # row): fail over — the sibling replays, rows
                        # already finished dedup via done_rows, and the
                        # client never sees the error
                        raise _StreamError(
                            500, frame, {}, retryable=True
                        )
                    row = ev.get("row")
                    if row is not None and "tokens" in ev:
                        toks = ev["tokens"]
                        have = sent.get(row, 0)
                        seen[row] = seen.get(row, 0) + len(toks)
                        if seen[row] <= have:
                            continue  # replay of already-delivered tokens
                        fresh = toks[-(seen[row] - have):]
                        sent[row] = have + len(fresh)
                        if len(fresh) == len(toks):
                            yield frame  # verbatim: the byte-identity path
                        else:
                            yield (
                                b"data: "
                                + json.dumps(
                                    {**ev, "tokens": fresh}
                                ).encode()
                                + b"\n\n"
                            )
                        continue
                    if row is not None and ev.get("done"):
                        if row in done_rows:
                            continue
                        done_rows.add(row)
                        yield frame
                        continue
                    if ev.get("done"):
                        finished = True
                        yield frame
                        break
                    yield frame  # future event kinds: relay verbatim
                if not finished:
                    raise _StreamError(
                        599,
                        json.dumps(
                            {"error": "router: upstream closed mid-stream",
                             "reason": "connect"}
                        ).encode(),
                        {},
                        retryable=True,
                    )
        finally:
            with self._rlock:
                s.inflight -= 1

    # ----------------------------------------- tracing + federation
    def finish_trace(
        self,
        trace: Optional[RequestTrace],
        status: str = "ok",
        error: Optional[str] = None,
    ) -> None:
        """Close the router-side trace and admit it to the tail
        sampler. Grafting the replica-side timeline is deferred to
        :meth:`tracez` — the serving path never blocks on it."""
        if trace is None:
            return
        trace.finish(status, error)
        self.traces.record(trace.to_dict())

    def tracez(self, query: dict) -> tuple[int, dict]:
        """The `/tracez` HTTP contract (same as the replica's), with
        query-time stitching: a `?id=` read grafts each attempted
        replica's own timeline under its `upstream_attempt` span, once
        — the payload shares `spans`/`attrs` with the ring's stored
        trace, so the graft is cached and repeat reads are free."""
        code, payload = tracez_payload(self.traces, query)
        if (
            code == 200
            and self.stitch_enabled
            and "spans" in payload  # a single trace, not the list view
        ):
            with self._stitch_lock:
                if payload["attrs"].get("attempts") is None:
                    self._stitch(payload)
        return code, payload

    def _stitch(self, tdict: dict) -> None:
        rid = tdict["id"]
        attempts = [
            s for s in tdict.get("spans") or []
            if s.get("name") == "upstream_attempt"
        ]
        stitched = 0
        for att in attempts:
            url = att["attrs"].get("url")
            if not url:
                continue
            remote = self._fetch_remote_trace(url, rid)
            if remote is None:
                att["attrs"]["stitched"] = False
                self._m_stitch_misses.inc()
                continue
            att["attrs"]["stitched"] = True
            graft_spans(
                tdict, att, remote,
                replica=att["attrs"].get("replica"),
                attempt=att["attrs"].get("attempt"),
            )
            stitched += 1
        tdict["attrs"]["attempts"] = len(attempts)
        tdict["attrs"]["stitched"] = stitched
        if stitched:
            self._m_stitched.inc(stitched)

    def _fetch_remote_trace(self, url: str, rid: str) -> Optional[dict]:
        """GET <replica>/tracez?id=<rid> — the propagation contract: the
        replica traced the SAME id it got on the X-Request-Id hop. One
        short retry: the replica's sampler records a streamed trace when
        its generator closes, which can land a beat after the router has
        read the final frame. (Event.wait, not time.sleep:
        no raw clock reads in this module.)"""
        for attempt in range(3):
            if attempt:
                threading.Event().wait(0.05)
            try:
                with urlrequest.urlopen(
                    url + "/tracez?id=" + rid, timeout=self.probe_timeout_s
                ) as r:
                    return json.loads(r.read())
            except urlerror.HTTPError:
                continue  # 404: not recorded (yet), retry once or twice
            except Exception:
                return None  # replica gone: its side of the story is lost
        return None

    def render_metrics(self) -> str:
        """The federated `/metricsz` text: the router's own registry,
        every replica's last scrape re-labeled `replica="r<N>"`, and
        cluster `cluster:<series>:sum/:max` aggregates — one scrape sees
        the fleet."""
        local = self.telemetry.render_prometheus()
        if not self.federate_enabled:
            return local
        # pass the poll loop's parsed snapshots: federate() re-renders
        # them without re-parsing the exposition text
        sources = [
            (s.slug, s.metrics_snap if s.metrics_snap is not None
             else s.metrics_text)
            for s in self.states()
        ]
        return federate(sources, label="replica", local_text=local)

    def cluster_stats(self) -> dict:
        """Fleet-level rollup for `/statsz` (what `polyaxon top` renders):
        sums/maxes over the replicas' scraped series plus router-local
        inflight — no extra scrape, no re-parse: the poll loop's one
        parsed snapshot per replica serves this too."""
        states = self.states()
        snaps = [s.metrics_snap for s in states if s.metrics_snap]
        prefix_hits = sum_values(snaps, "serving_prefix_cache_hits_total")
        prefix_misses = sum_values(
            snaps, "serving_prefix_cache_misses_total"
        )
        looked = prefix_hits + prefix_misses
        return {
            "federation": self.federate_enabled,
            "replicas": len(states),
            "scraped": len(snaps),
            "queue_depth": sum(s.queue_depth for s in states),
            "inflight": sum(s.inflight for s in states),
            "queue_wait_ms_max": round(
                max((s.queue_wait_ms for s in states), default=0.0), 3
            ),
            "serving_requests": sum_values(snaps, "serving_requests_total"),
            "serving_shed": sum_values(snaps, "serving_shed_total"),
            # cluster-wide warm-KV picture
            "prefix_hits": prefix_hits,
            "prefix_misses": prefix_misses,
            "prefix_hit_rate": (
                round(prefix_hits / looked, 4) if looked else None
            ),
            "spill_restores": sum_values(
                snaps, "serving_kv_spill_restores_total"
            ),
            "spill_bytes": sum_values(snaps, "serving_kv_spill_bytes_total"),
        }

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        lat = self._m_latency.summary()
        replicas = [
            {
                "url": s.url,
                "slug": s.slug,
                "healthy": s.healthy,
                "draining": s.draining,
                "queue_depth": s.queue_depth,
                "queue_wait_ms": round(s.queue_wait_ms, 3),
                "inflight": s.inflight,
                "requests": s.requests,
                "weight": s.weight,
                "prefix_heads": s.kv_heads,
                "replica_role": s.role,
            }
            for s in self.states()
        ]
        auto = {"enabled": self.slo_engine is not None}
        if self.autoscale is not None:
            auto.update(
                min_replicas=self.autoscale.min_replicas,
                max_replicas=self.autoscale.max_replicas,
            )
        if self.scaler is not None:
            auto["target"] = self.scaler.target
        return {
            "role": "router",
            "replicas": replicas,
            "routable": sum(1 for s in self.states() if s.routable),
            "requests": int(self._m_requests.value),
            "retries": int(self._m_retries.value),
            "upstream_shed": int(self._m_upstream_shed.value),
            "errors": int(self._m_errors.value),
            "latency_ms": {
                k: (round(lat[k] * 1000.0, 3) if lat[k] is not None else None)
                for k in ("p50", "p95", "p99", "mean")
            },
            "autoscale": auto,
            "affinity": {
                "enabled": self.affinity_enabled,
                "imbalance": self.affinity_imbalance,
                "hits": int(self._m_affinity_hits.value),
                **self.directory.stats(),
            },
            "tracing": {
                "enabled": self.trace_enabled,
                "stitch": self.stitch_enabled,
                "stitched": int(self._m_stitched.value),
                "stitch_misses": int(self._m_stitch_misses.value),
                **self.traces.stats(),
            },
            "cluster": self.cluster_stats(),
        }

    def readiness(self) -> tuple[bool, str]:
        n = sum(1 for s in self.states() if s.routable)
        if n == 0:
            return False, "no routable replica"
        return True, "ok"

    # -------------------------------------------------------------- http
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        router = self
        self._stop_poll.clear()
        self.poll_once()  # synchronous first pass: routable before bound
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="router-poll", daemon=True
        )
        self._poll_thread.start()
        if self.slo_engine is not None:
            self.slo_engine.start()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, payload, headers=None):
                data = json.dumps(payload).encode()
                self._send_raw(code, data, "application/json", headers)

            def _send_raw(self, code, data, ctype, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path, _, _query = self.path.partition("?")
                if path == "/healthz":
                    self._send(
                        200,
                        {
                            "status": "ok",
                            "role": "router",
                            "replicas": len(router.states()),
                        },
                    )
                elif path == "/readyz":
                    ready, reason = router.readiness()
                    self._send(
                        200 if ready else 503,
                        {"ready": ready, "reason": reason},
                    )
                elif path == "/statsz":
                    self._send(200, router.stats())
                elif path == "/metricsz":
                    self._send_raw(
                        200,
                        router.render_metrics().encode(),
                        "text/plain; version=0.0.4",
                    )
                elif path == "/tracez":
                    code, payload = router.tracez(_query)
                    self._send(code, payload)
                elif path == "/sloz":
                    self._send(
                        200,
                        router.slo_engine.to_dict()
                        if router.slo_engine is not None
                        else {"enabled": False, "breached": False, "slos": []},
                    )
                elif path == "/queryz":
                    # fleet-wide trend queries over the FEDERATED history
                    # the poll loop records
                    code, payload = queryz_payload(router.history, _query)
                    self._send(code, payload)
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path != "/generate":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                rid = (
                    (self.headers.get("X-Request-Id") or "").strip()[:128]
                    or new_trace_id()
                )
                tenant = (self.headers.get("X-Tenant") or "").strip()[:128]
                router._m_requests.inc()
                t0 = _now()
                tr = (
                    RequestTrace(rid, role="router")
                    if router.trace_enabled
                    else None
                )
                status_out, err_out = "ok", None
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    if tr is not None:
                        tr.add(
                            "admission",
                            start=tr.t0,
                            dur_s=_now() - tr.t0,
                            bytes=len(body),
                        )
                    if "stream=1" in query.split("&"):
                        status = self._relay_stream(
                            body, rid, query, tr, tenant
                        )
                        status_out = _trace_status(status)
                    else:
                        status, payload, headers = router.forward(
                            body, rid, query=query, tenant=tenant, trace=tr
                        )
                        status_out = _trace_status(status)
                        fwd = {
                            k: v
                            for k, v in headers.items()
                            if k in ("Retry-After", "X-Request-Id")
                        }
                        fwd.setdefault("X-Request-Id", rid)
                        self._send_raw(
                            status, payload, "application/json", fwd
                        )
                except BrokenPipeError:
                    status_out, err_out = "error", "client disconnected"
                except Exception as e:  # noqa: BLE001 — surface, don't kill
                    router._m_errors.inc()
                    status_out = "error"
                    err_out = f"{type(e).__name__}: {e}"
                    try:
                        self._send(
                            500,
                            {
                                "error": f"router: {type(e).__name__}: {e}",
                                "reason": "internal",
                            },
                        )
                    except OSError:
                        pass
                finally:
                    router._m_latency.observe(_now() - t0, exemplar=rid)
                    router.finish_trace(tr, status_out, err_out)

            def _relay_stream(self, body, rid, query, tr=None, tenant=""):
                gen = router.forward_stream(
                    body, rid, query=query, tenant=tenant, trace=tr
                )
                try:
                    first = next(gen)  # admission errors raise here
                except _StreamError as e:
                    fwd = {
                        k: v
                        for k, v in e.headers.items()
                        if k in ("Retry-After", "X-Request-Id")
                    }
                    fwd.setdefault("X-Request-Id", rid)
                    self._send_raw(
                        e.status, e.payload, "application/json", fwd
                    )
                    return e.status
                except StopIteration:
                    self._send(502, {"error": "router: empty stream"})
                    return 502
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-store")
                self.send_header("Connection", "close")
                self.send_header("X-Request-Id", rid)
                self.end_headers()
                import itertools

                try:
                    for frame in itertools.chain((first,), gen):
                        self.wfile.write(frame)
                        self.wfile.flush()
                except BrokenPipeError:
                    pass
                return 200

        self._httpd = _RouterHttpd((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="router-http", daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._stop_poll.set()
        if self.slo_engine is not None:
            self.slo_engine.stop()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class _RouterHttpd(ThreadingHTTPServer):
    # same rationale as serving/_Httpd: under a burst the router's whole
    # job is to keep accepting, balancing, and (maybe) shedding fast
    daemon_threads = True
    request_queue_size = 128


class _StreamError(Exception):
    """A streaming forward failed before/mid relay; carries the upstream
    answer so the HTTP layer can relay real status codes."""

    def __init__(
        self,
        status: int,
        payload: bytes,
        headers: dict,
        *,
        retryable: bool = False,
    ):
        super().__init__(f"upstream {status}")
        self.status = status
        self.payload = payload
        self.headers = headers
        self.retryable = retryable


def _first_row_tokens(body: bytes) -> tuple[Optional[list], str]:
    """Prompt tokens of the request's first row (None when the body isn't
    the /generate shape: the replica will reject it anyway — the router
    never fails a request over affinity parsing) and the body's tenant."""
    try:
        data = json.loads(body)
        row = data.get("tokens")[0]
        tenant = str(data.get("tenant") or "").strip()
        return (row if isinstance(row, list) else None), tenant
    except Exception:
        return None, ""


def _iter_sse_frames(resp):
    """Yield complete `data: ...\\n\\n` frames from a streaming response.
    EOF mid-frame simply stops iteration — the caller decides whether the
    stream was terminal (it tracks the final done event)."""
    buf = b""
    while True:
        line = resp.readline()
        if not line:
            return
        buf += line
        if line == b"\n" and buf.strip():
            yield buf
            buf = b""


def _parse_frame(frame: bytes) -> Optional[dict]:
    for line in frame.splitlines():
        if line.startswith(b"data: "):
            try:
                return json.loads(line[len(b"data: "):])
            except ValueError:
                return None
    return None
