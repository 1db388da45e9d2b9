"""The failure taxonomy the trainer and the chaos injector raise, an own
copy of the exception classes of `polyaxon_tpu/retry.py`. The retry loop
that classifies them belongs to the executor, which is not ported yet."""

from __future__ import annotations

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
