"""The failure taxonomy the trainer and the chaos injector raise and the
backoff curve of the serving fleet (the KV handoff client, the replica
set's restarts): an own copy of the exception classes and of
`RetryPolicy.delay` of `polyaxon_tpu/retry.py`. The retry loop that
classifies failures belongs to the executor, which is not ported yet."""

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

    def delay(self, attempt: int, *, seed: Optional[str] = None) -> float:
        """Seconds to wait before retry `attempt`. Deterministic for a
        given (seed, attempt): the jitter comes from a string-seeded PRNG,
        stable across processes."""
        base = min(self.backoff * self.backoff_factor ** max(attempt, 0), self.backoff_max)
        if base <= 0 or self.jitter <= 0:
            return max(base, 0.0)
        r = random.Random(f"{seed}:{attempt}").random()
        return base * (1.0 - self.jitter * r)
