"""Live KV handoff between disaggregated prefill and decode replicas, an
own copy of `polyaxon_tpu/serving/handoff.py` over the port's spill tier.

A prefill replica runs only chunked-prefill steps; when the last slice
lands it harvests the finished page set into its prefix cache, captures
the host bytes, and ships them to a decode replica as the SAME
CRC-framed segment bytes the spill tier writes to disk — one
serialization, one torn/corrupt verdict path, one quarantine contract —
over `POST /kv_import`. The decode replica verifies CRC + content-hash
chains against the prompt tokens, adopts the pages into its own pool,
and the router's existing SSE failover/trim machinery continues the
response mid-flight.

Robustness invariants this module owns:

- **Single-owner leases with monotonic epochs.** Every import attempt
  carries an epoch (router attempt x client retry, strictly increasing
  per request id). `LeaseTable.acquire` refuses any epoch at or below
  the highest ever granted for the id, so a stale exporter — one the
  router already failed over past — can never double-adopt.
- **RetryPolicy-driven transfer with per-attempt deadlines.** Each
  attempt gets its own socket timeout; connection-level failures back
  off on the shared `RetryPolicy` curve; protocol refusals (409 stale,
  400 rejected, 503 shed) never burn retries — they resolve to the
  caller's fallback path immediately.
- **No hidden failure modes.** `HandoffClient.send` returns a
  `HandoffResult`, never raises for transport reasons: the server's
  fallback decision (decode locally, monolithically) is structural.

Clock-free: no wall-clock reads — backoff sleeps ride
`threading.Event.wait`, deadlines are socket timeouts.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional
from urllib import error as urlerror
from urllib import request as urlrequest

from ..chaos.injector import inject
from ..retry import RetryPolicy
from ..store.framing import frame, scan_frames
from .spill import SpillManager, SpillPayload, dtype_name, leaf_bytes

# one exporter makes at most _EPOCH_STRIDE attempts per router epoch, so
# (router_attempt, client_attempt) flattens to a single monotonic int
_EPOCH_STRIDE = 256


class HandoffError(Exception):
    """A handoff payload failed structural verification (CRC frames,
    segment shape) — the bytes cannot be adopted."""


class StaleLeaseError(HandoffError):
    """An exporter presented an epoch at or below one already granted:
    a newer owner exists (or existed) and this exporter must stand
    down, not adopt."""


@dataclasses.dataclass
class HandoffLease:
    """One granted import right: request id + the epoch that owns it."""

    rid: str
    epoch: int
    state: str = "active"  # active | done | preempted | released


class LeaseTable:
    """Single-owner handoff leases keyed by request id.

    Epochs are strictly monotonic per id: `acquire` refuses any epoch
    <= the highest ever granted (StaleLeaseError), and granting a
    higher epoch preempts the previous holder — its later `complete`
    returns False so a preempted adoption can never be reported as
    owned. Droppable state: ids are forgotten on completion bound, so
    the table cannot grow without bound under churn."""

    def __init__(self, *, max_ids: int = 4096):
        self._lock = threading.Lock()
        self._high: dict[str, int] = {}
        self._active: dict[str, HandoffLease] = {}
        self._order: list[str] = []  # insertion order for the id bound
        self.max_ids = int(max_ids)
        self.granted = 0
        self.completed = 0
        self.preempted = 0
        self.stale_rejections = 0

    def acquire(self, rid: str, epoch: int) -> HandoffLease:
        epoch = int(epoch)
        with self._lock:
            high = self._high.get(rid)
            if high is not None and epoch <= high:
                self.stale_rejections += 1
                raise StaleLeaseError(
                    f"handoff {rid!r}: epoch {epoch} <= granted {high}"
                )
            prev = self._active.get(rid)
            if prev is not None:
                prev.state = "preempted"
                self.preempted += 1
            if high is None:
                self._order.append(rid)
                if len(self._order) > self.max_ids:
                    old = self._order.pop(0)
                    self._high.pop(old, None)
                    self._active.pop(old, None)
            self._high[rid] = epoch
            lease = HandoffLease(rid, epoch)
            self._active[rid] = lease
            self.granted += 1
            return lease

    def complete(self, lease: HandoffLease) -> bool:
        """Mark the adoption owned by `lease` as done. Returns False —
        and records nothing — when the lease was preempted by a higher
        epoch: the newer owner's adoption is the real one."""
        with self._lock:
            if lease.state != "active":
                return False
            lease.state = "done"
            if self._active.get(lease.rid) is lease:
                del self._active[lease.rid]
            self.completed += 1
            return True

    def release(self, lease: HandoffLease) -> None:
        """Abort path: give the id back without completing. A later
        retry (higher epoch) proceeds normally."""
        with self._lock:
            if lease.state == "active":
                lease.state = "released"
            if self._active.get(lease.rid) is lease:
                del self._active[lease.rid]

    @property
    def active(self) -> int:
        with self._lock:
            return len(self._active)

    def stats(self) -> dict:
        with self._lock:
            return {
                "active": len(self._active),
                "granted": self.granted,
                "completed": self.completed,
                "preempted": self.preempted,
                "stale_rejections": self.stale_rejections,
            }


# ------------------------------------------------------------ wire form
def payload_to_wire(payload: SpillPayload) -> bytes:
    """SpillPayload → the CRC-framed segment bytes of the spill tier: one
    JSON meta frame then one frame per (page, leaf), page-major.
    Byte-compatible with `SpillManager._write_segment`, so both sides share
    one parser and one corruption verdict. A leaf's dtype is its numpy name
    and its bytes go through an integer view (bf16 has no numpy dtype
    here), so the bytes equal the reference's for the same pages.

    A payload of an adapter's chain adds its `namespace` to the meta: the
    decode side verifies the hashes against that namespace's chain and
    adopts the pages there. Without a namespace the bytes are the
    reference's exactly."""
    meta = {
        "h": payload.hashes[-1],
        "tokens": [int(t) for t in payload.tokens],
        "hashes": list(payload.hashes),
        "pages": len(payload.pages),
        "leaves": [
            {"dtype": dtype_name(t), "shape": list(t.shape)}
            for t in payload.pages[0]
        ],
    }
    if payload.namespace:
        meta["namespace"] = payload.namespace
    out = [frame(json.dumps(meta).encode())]
    for page in payload.pages:
        for t in page:
            out.append(frame(leaf_bytes(t)))
    return b"".join(out)


def payload_from_wire(data: bytes) -> SpillPayload:
    """Wire bytes → verified SpillPayload, or HandoffError. A torn or
    corrupt frame set is rejected whole — a partial page set must never
    be adopted (the exporter retries or falls back)."""
    payloads, verdict, _good_end = scan_frames(data)
    if verdict != "clean":
        raise HandoffError(f"handoff frames {verdict}")
    parsed = SpillManager._parse_segment(payloads)
    if parsed is None:
        raise HandoffError("malformed handoff segment")
    return parsed[1]


# --------------------------------------------------------------- client
@dataclasses.dataclass
class HandoffResult:
    """Outcome of one `HandoffClient.send`: ok with the adopted page
    count, or a failure reason the server maps to its fallback path."""

    ok: bool
    adopted_pages: int = 0
    epoch: int = -1
    attempts: int = 0
    reason: str = ""
    adopt_ms: float = 0.0  # the decode side's host time on the import


class HandoffClient:
    """Ships one payload to `<target>/kv_import` with RetryPolicy-driven
    retries and a per-attempt socket deadline.

    Only connection-level failures retry. Protocol answers are final:
    409 means a newer epoch owns the request (stand down), 400 means
    the decode side rejected the content (identical bytes will not do
    better), 503 means the import shed (`reason: kv_handoff`) — all
    three resolve immediately so the prefill replica can fall back to
    monolithic decode instead of burning the client's deadline."""

    def __init__(
        self,
        *,
        retry: Optional[RetryPolicy] = None,
        attempt_timeout_s: float = 5.0,
    ):
        self.retry = retry if retry is not None else RetryPolicy(
            max_retries=2, backoff=0.05, backoff_max=0.5
        )
        self.attempt_timeout_s = float(attempt_timeout_s)

    def send(
        self,
        target: str,
        rid: str,
        data: bytes,
        *,
        base_epoch: int = 0,
        seed: Optional[str] = None,
    ) -> HandoffResult:
        n = max(0, int(self.retry.max_retries)) + 1
        n = min(n, _EPOCH_STRIDE)  # epochs must not collide across bases
        epoch = int(base_epoch) * _EPOCH_STRIDE
        for attempt in range(n):
            epoch = int(base_epoch) * _EPOCH_STRIDE + attempt
            try:
                # chaos: the exporter dying mid-send must leak nothing
                # on either side (decode adopted fully or not at all)
                inject(
                    "serving.kv_export",
                    rid=rid, epoch=epoch, attempt=attempt, phase="send",
                )
                status, payload = self._post(target, rid, epoch, data)
            except Exception as e:
                status, payload = 599, json.dumps(
                    {"reason": "connect", "error": f"{type(e).__name__}: {e}"}
                ).encode()
            if status == 200:
                try:
                    body = json.loads(payload)
                except ValueError:
                    body = {}
                return HandoffResult(
                    ok=True,
                    adopted_pages=int(body.get("adopted_pages", 0)),
                    epoch=epoch,
                    attempts=attempt + 1,
                    adopt_ms=float(body.get("adopt_ms", 0.0)),
                )
            if status not in (599, 502):
                try:
                    reason = json.loads(payload).get("reason") or ""
                except Exception:
                    reason = ""
                if status == 409:
                    reason = reason or "stale_epoch"
                elif status == 503:
                    reason = reason or "kv_handoff"
                else:
                    reason = reason or "rejected"
                return HandoffResult(
                    ok=False, epoch=epoch, attempts=attempt + 1,
                    reason=reason,
                )
            if attempt + 1 < n:
                d = self.retry.delay(attempt, seed=seed or rid)
                if d > 0:
                    threading.Event().wait(d)  # no time.sleep: clock-free
        return HandoffResult(
            ok=False, epoch=epoch, attempts=n, reason="connect"
        )

    def _post(
        self, target: str, rid: str, epoch: int, data: bytes
    ) -> tuple[int, bytes]:
        req = urlrequest.Request(
            target.rstrip("/") + "/kv_import",
            data=data,
            headers={
                "Content-Type": "application/octet-stream",
                "X-Handoff-Id": rid,
                "X-Handoff-Epoch": str(epoch),
            },
            method="POST",
        )
        try:
            with urlrequest.urlopen(
                req, timeout=self.attempt_timeout_s
            ) as r:
                return r.status, r.read()
        except urlerror.HTTPError as e:
            try:
                return e.code, e.read()
            except Exception:
                return e.code, b"{}"
