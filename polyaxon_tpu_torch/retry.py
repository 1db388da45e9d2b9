"""The failure taxonomy and the retry/backoff policy, an own copy of
`polyaxon_tpu/retry.py`: the classes the trainer and the chaos injector
raise, `classify` (preempted / permanent / transient) and `RetryPolicy`,
which the executor's attempt loop builds from a run's `termination:`
(`from_termination`) and the serving fleet (the KV handoff client, the
replica set's restarts) uses for its backoff."""

from __future__ import annotations

import dataclasses
import random
from typing import Optional


class TransientError(Exception):
    """The operation failed for an environmental reason and is worth
    retrying (network flap, injected chaos fault)."""


class PermanentError(Exception):
    """The operation can never succeed by retrying (bad config, missing
    binary, validation error)."""


class Preempted(TransientError):
    """The machine went away under us (SIGTERM grace notice, spot reclaim).
    Always retryable and never counted against the retry budget. Carries
    the last checkpointed step when known so the restart resumes warm."""

    def __init__(self, message: str = "preempted", step: Optional[int] = None):
        super().__init__(message)
        self.step = step


PERMANENT = "permanent"
TRANSIENT = "transient"
PREEMPTED = "preempted"


def classify(exc: BaseException) -> str:
    """PREEMPTED, PERMANENT or TRANSIENT. Unknown exception types are
    TRANSIENT (retry up to maxRetries); permanence is opted into by raising
    `PermanentError` or setting a truthy `permanent` attribute."""
    if isinstance(exc, Preempted):
        return PREEMPTED
    if isinstance(exc, PermanentError):
        return PERMANENT
    if getattr(exc, "permanent", False):
        return PERMANENT
    return TRANSIENT


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter: attempt `n` (0-based)
    waits `min(backoff * backoff_factor**n, backoff_max)`, shrunk by up to
    `jitter` of itself. backoff=0 retries immediately."""

    max_retries: int = 0
    backoff: float = 0.0
    backoff_factor: float = 2.0
    backoff_max: float = 60.0
    jitter: float = 0.1

    @classmethod
    def from_termination(cls, term) -> "RetryPolicy":
        """From a `V1Termination` (None: no retries)."""
        if term is None:
            return cls()

        def _f(value, default):
            return float(value) if value is not None else default

        return cls(
            max_retries=int(term.max_retries or 0),
            backoff=_f(term.backoff, 0.0),
            backoff_factor=_f(term.backoff_factor, 2.0),
            backoff_max=_f(term.backoff_max, 60.0),
            jitter=_f(term.jitter, 0.1),
        )

    def delay(self, attempt: int, *, seed: Optional[str] = None) -> float:
        """Seconds to wait before retry `attempt`. Deterministic for a
        given (seed, attempt): the jitter comes from a string-seeded PRNG,
        stable across processes."""
        base = min(self.backoff * self.backoff_factor ** max(attempt, 0), self.backoff_max)
        if base <= 0 or self.jitter <= 0:
            return max(base, 0.0)
        r = random.Random(f"{seed}:{attempt}").random()
        return base * (1.0 - self.jitter * r)
