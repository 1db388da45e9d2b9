"""Replica-set lifecycle for horizontal serving, an own copy of
`polyaxon_tpu/serving/replicas.py`.

`ReplicaSetManager` turns "N ModelServer replicas" into one managed
gang: a monitor loop restarts crashed replicas on the retry curve
(`retry.RetryPolicy`: capped exponential backoff with deterministic
jitter, so a crash-looping replica can't hammer the host), and `rolling_redeploy` drains one replica at a time — the
router keeps serving from the siblings, so a redeploy is not an
outage.

The module is deliberately torch-free: replicas are opaque lifecycle
handles. Two shapes are provided —

- `InProcessReplica`: a ModelServer born from a factory in this
  process. The test/bench correctness shape (the GIL serializes decode
  across in-process replicas, so it proves routing/failover semantics,
  not throughput).
- `SubprocessReplica`: a child process started from an argv factory
  (a command line that serves a ModelServer on port N), probed on /readyz until ready.
  The real shape — each replica owns its devices and its GIL.

With a configured fleet (`fleet=`, `scheduler/fleet.py`) each slot holds a
reservation of `chips_per_replica` chips under queue `serving` (the same
all-or-nothing placement training runs use, so serving and training never
double-book a chip), taken before the slot starts and released when it
is drained or stopped.

Slot URLs are sticky: `endpoints()` keeps a crashed slot's last URL
until the restart replaces it, so the router's positional slugs (r0,
r1, ...) never migrate between replicas mid-incident.
"""

from __future__ import annotations

import json
import socket
import subprocess
import threading
from typing import Callable, Optional
from urllib import request as urlrequest

from ..retry import RetryPolicy
from ..telemetry import MetricsRegistry, now as _now

# a replica alive this long is considered stable: its crash-retry
# budget resets, so only a crash LOOP walks the backoff ladder
_STABLE_S = 10.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class InProcessReplica:
    """A ModelServer started in this process from a zero-arg factory.
    `kill()` drops the HTTP listener without drain — the crash shape
    the monitor and the router's failover are tested against."""

    def __init__(self, factory: Callable[[], object]):
        self._factory = factory
        self.server = None
        self.url: Optional[str] = None

    def start(self) -> str:
        self.server = self._factory()
        port = self.server.start(port=0)
        self.url = f"http://127.0.0.1:{port}"
        return self.url

    def alive(self) -> bool:
        return self.server is not None and self.server._httpd is not None

    def stop(self, drain_grace_s: Optional[float] = None) -> None:
        if self.server is not None:
            self.server.stop(drain_grace_s=drain_grace_s)
            self.server = None

    def kill(self) -> None:
        """Crash, not drain: in-flight requests die with the listener."""
        srv, self.server = self.server, None
        if srv is not None and srv._httpd is not None:
            srv._httpd.shutdown()
            srv._httpd.server_close()


class SubprocessReplica:
    """A replica child process. `argv_factory(port)` returns the command
    line (the manager picks a free port); readiness is probed over HTTP
    so `start()` returns only once the replica can actually serve."""

    def __init__(
        self,
        argv_factory: Callable[[int], list[str]],
        *,
        env: Optional[dict] = None,
        ready_timeout_s: float = 120.0,
    ):
        self._argv_factory = argv_factory
        self._env = env
        self._ready_timeout_s = float(ready_timeout_s)
        self.proc: Optional[subprocess.Popen] = None
        self.url: Optional[str] = None

    def start(self) -> str:
        port = _free_port()
        self.proc = subprocess.Popen(
            self._argv_factory(port),
            env=self._env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        self.url = f"http://127.0.0.1:{port}"
        deadline = _now() + self._ready_timeout_s
        while _now() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica exited rc={self.proc.returncode} before ready"
                )
            try:
                with urlrequest.urlopen(self.url + "/readyz", timeout=2.0) as r:
                    if json.loads(r.read()).get("ready"):
                        return self.url
            except Exception:
                pass
            threading.Event().wait(0.1)
        self.kill()
        raise TimeoutError(f"replica on {self.url} not ready in time")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def stop(self, drain_grace_s: Optional[float] = None) -> None:
        if self.proc is None:
            return
        self.proc.terminate()  # SIGTERM → the child's handler drains
        try:
            self.proc.wait(timeout=(drain_grace_s or 5.0) + 10.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10.0)
        self.proc = None

    def kill(self) -> None:
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(timeout=10.0)
            self.proc = None


class ReplicaSetManager:
    """N replica slots, crash-restarted, drained one at a time. `factory(slot_index)` builds a fresh (unstarted) replica; the
    manager owns when it runs."""

    def __init__(
        self,
        factory: Callable[[int], object],
        replicas: int = 1,
        *,
        fleet=None,
        chips_per_replica: int = 1,
        name: str = "serve",
        retry: Optional[RetryPolicy] = None,
        registry: Optional[MetricsRegistry] = None,
        monitor_interval_s: float = 0.5,
    ):
        self._factory = factory
        self.target = int(replicas)
        self.fleet = fleet
        self.chips_per_replica = int(chips_per_replica)
        self.name = name
        self.retry = retry or RetryPolicy(max_retries=3, backoff=0.2)
        self.telemetry = registry or MetricsRegistry()
        self.monitor_interval_s = float(monitor_interval_s)
        self._lock = threading.RLock()
        self._replicas: dict[int, object] = {}
        self._urls: dict[int, str] = {}  # sticky slot URLs (see module doc)
        self._attempts: dict[int, int] = {}
        self._next_attempt_t: dict[int, float] = {}
        self._launched_t: dict[int, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.router = None  # attach_router(): drain coordination
        self._m_target = self.telemetry.gauge(
            "serving.replicas_target", help="Desired replica count"
        )
        self._m_live = self.telemetry.gauge(
            "serving.replicas_live", help="Replicas currently alive"
        )
        self._m_restarts = self.telemetry.counter(
            "serving.replica_restarts",
            help="Crashed replicas relaunched by the monitor",
        )
        self._m_target.set(self.target)

    # --------------------------------------------------------- lifecycle
    def attach_router(self, router) -> None:
        self.router = router

    def start(self) -> list[str]:
        with self._lock:
            for i in range(self.target):
                self._launch(i)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._monitor_loop, name="replica-monitor", daemon=True
        )
        self._thread.start()
        return self.endpoints()

    def _reservation_uuid(self, i: int) -> str:
        return f"{self.name}-r{i}"

    def _launch(self, i: int) -> None:
        """Reserve (fleet) then run slot `i`; raises if either fails so
        the monitor can apply backoff."""
        if self.fleet is not None and self.fleet.configured:
            rec = self.fleet.reserve(self._reservation_uuid(i),
                                     chips=self.chips_per_replica, queue="serving")
            if rec is None:
                raise RuntimeError(
                    f"fleet: no capacity for replica {i} ({self.chips_per_replica} chips)")
        rep = self._factory(i)
        url = rep.start()
        with self._lock:
            self._replicas[i] = rep
            self._urls[i] = url
            self._launched_t[i] = _now()

    def _release(self, i: int) -> None:
        if self.fleet is not None and self.fleet.configured:
            try:
                self.fleet.release(self._reservation_uuid(i))
            except Exception:  # noqa: BLE001 — a failed release never blocks a stop
                pass

    def endpoints(self) -> list[str]:
        """Slot URLs in slot order — the router's endpoint provider."""
        with self._lock:
            return [self._urls[i] for i in sorted(self._urls)]

    def replica(self, i: int):
        with self._lock:
            return self._replicas.get(i)

    def live(self) -> int:
        with self._lock:
            return sum(
                1 for r in self._replicas.values()
                if r is not None and r.alive()
            )

    # ----------------------------------------------------------- monitor
    def monitor_once(self) -> None:
        """One supervision pass (the loop body; tests call it directly).
        Dead slot → relaunch when its backoff deadline passes; a slot
        that exhausts max_retries stays down (the router routes around
        it) until scale/redeploy touches it again."""
        t = _now()
        with self._lock:
            slots = sorted(set(self._urls) | set(range(self.target)))
        for i in slots:
            if i >= self.target:
                continue
            rep = self.replica(i)
            if rep is not None and rep.alive():
                if t - self._launched_t.get(i, t) >= _STABLE_S:
                    self._attempts[i] = 0  # stable: crash budget resets
                continue
            attempt = self._attempts.get(i, 0)
            if attempt > self.retry.max_retries:
                continue  # gave up on this slot
            if t < self._next_attempt_t.get(i, 0.0):
                continue
            try:
                self._launch(i)
                self._m_restarts.inc()
                self._attempts[i] = attempt + 1
                self._next_attempt_t[i] = t + self.retry.delay(
                    attempt, seed=self._reservation_uuid(i)
                )
            except Exception:
                self._attempts[i] = attempt + 1
                self._next_attempt_t[i] = t + self.retry.delay(
                    attempt, seed=self._reservation_uuid(i)
                )
        self._m_live.set(self.live())

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.monitor_interval_s):
            try:
                self.monitor_once()
            except Exception:
                pass  # supervision must outlive any one bad pass

    # ------------------------------------------------------------- scale
    def scale_to(self, n: int) -> None:
        """Autoscale entry: grow launches fresh slots, shrink drains the
        highest slots first (slot 0 is the last to go)."""
        n = max(1, int(n))
        with self._lock:
            old = self.target
            self.target = n
            self._m_target.set(n)
            grow = range(old, n)
            shrink = sorted(
                (i for i in self._urls if i >= n), reverse=True
            )
            for i in grow:  # park: keep the monitor out of fresh slots
                self._attempts[i] = self.retry.max_retries + 1
        for i in grow:
            try:
                self._launch(i)
            except Exception:
                pass  # the monitor retries under backoff (unparked below)
            self._attempts[i] = 0
        for i in shrink:
            self._drain_slot(i, remove=True)
        self._m_live.set(self.live())

    def _drain_slot(self, i: int, *, remove: bool) -> None:
        with self._lock:
            rep = self._replicas.get(i)
            url = self._urls.get(i)
            # park the slot: the monitor must not race a relaunch into
            # a slot that is being deliberately drained
            self._attempts[i] = self.retry.max_retries + 1
        if self.router is not None and url is not None:
            self.router.mark_draining(url)
        if rep is not None:
            try:
                rep.stop(drain_grace_s=None)
            except Exception:
                pass
        self._release(i)
        with self._lock:
            if remove:
                self._replicas.pop(i, None)
                self._urls.pop(i, None)
                self._attempts.pop(i, None)
            else:
                self._replicas[i] = None

    # ---------------------------------------------------------- redeploy
    def rolling_redeploy(
        self, factory: Optional[Callable[[int], object]] = None
    ) -> list[str]:
        """Replace every replica one at a time: mark the slot draining at
        the router (no new requests race the admission close), drain and
        stop it, launch its successor, wait until the router sees it
        ready, undrain, move on. With >= 2 replicas the service never
        has zero routable backends."""
        if factory is not None:
            self._factory = factory
        with self._lock:
            slots = sorted(self._urls)
        for i in slots:
            self._drain_slot(i, remove=False)  # parks the slot (no races)
            self._launch(i)  # sticky slot: same slug, fresh process
            self._attempts[i] = 0
            if self.router is not None:
                self.router.poll_once()  # discover the successor NOW
        return self.endpoints()

    def stop(self, drain: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            slots = sorted(self._replicas, reverse=True)
        for i in slots:
            rep = self.replica(i)
            if rep is not None:
                try:
                    if drain:
                        rep.stop(drain_grace_s=None)
                    else:
                        rep.kill()
                except Exception:
                    pass
            self._release(i)
        with self._lock:
            self._replicas.clear()
            self._urls.clear()
