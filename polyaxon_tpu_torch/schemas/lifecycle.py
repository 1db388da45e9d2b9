"""Run lifecycle: the statuses and the legal transition graph, an own copy
of `polyaxon_tpu/schemas/lifecycle.py` (the port imports nothing of the JAX
package). The run store (`store/local.py`) validates every status
transition against `TRANSITIONS`, and writes conditions as plain dicts.
"""

from __future__ import annotations

from enum import Enum


class V1Statuses(str, Enum):
    CREATED = "created"
    RESUMING = "resuming"
    ON_SCHEDULE = "on_schedule"
    COMPILED = "compiled"
    QUEUED = "queued"
    SCHEDULED = "scheduled"
    STARTING = "starting"
    RUNNING = "running"
    PROCESSING = "processing"
    STOPPING = "stopping"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    UPSTREAM_FAILED = "upstream_failed"
    STOPPED = "stopped"
    SKIPPED = "skipped"
    WARNING = "warning"
    UNSCHEDULABLE = "unschedulable"
    RETRYING = "retrying"
    UNKNOWN = "unknown"
    DONE = "done"


DONE_STATUSES = frozenset(
    {
        V1Statuses.SUCCEEDED,
        V1Statuses.FAILED,
        V1Statuses.UPSTREAM_FAILED,
        V1Statuses.STOPPED,
        V1Statuses.SKIPPED,
        V1Statuses.DONE,
    }
)

RUNNING_STATUSES = frozenset(
    {V1Statuses.STARTING, V1Statuses.RUNNING, V1Statuses.PROCESSING}
)

# status → set of legal next statuses (done statuses are terminal except via retry/resume)
TRANSITIONS: dict[V1Statuses, frozenset[V1Statuses]] = {
    V1Statuses.CREATED: frozenset(
        {V1Statuses.COMPILED, V1Statuses.ON_SCHEDULE, V1Statuses.SKIPPED, V1Statuses.STOPPED, V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED}
    ),
    V1Statuses.ON_SCHEDULE: frozenset(
        {V1Statuses.COMPILED, V1Statuses.STOPPED, V1Statuses.SKIPPED, V1Statuses.UPSTREAM_FAILED}
    ),
    V1Statuses.COMPILED: frozenset(
        {V1Statuses.QUEUED, V1Statuses.SCHEDULED, V1Statuses.STOPPED, V1Statuses.SKIPPED, V1Statuses.FAILED, V1Statuses.UNSCHEDULABLE, V1Statuses.UPSTREAM_FAILED}
    ),
    V1Statuses.QUEUED: frozenset(
        {V1Statuses.SCHEDULED, V1Statuses.STOPPED, V1Statuses.SKIPPED, V1Statuses.FAILED, V1Statuses.UNSCHEDULABLE, V1Statuses.UPSTREAM_FAILED}
    ),
    V1Statuses.SCHEDULED: frozenset(
        {V1Statuses.STARTING, V1Statuses.RUNNING, V1Statuses.FAILED, V1Statuses.STOPPED, V1Statuses.UNSCHEDULABLE, V1Statuses.UNKNOWN}
    ),
    V1Statuses.STARTING: frozenset(
        {V1Statuses.RUNNING, V1Statuses.FAILED, V1Statuses.STOPPED, V1Statuses.UNKNOWN, V1Statuses.RETRYING}
    ),
    V1Statuses.RUNNING: frozenset(
        {V1Statuses.PROCESSING, V1Statuses.SUCCEEDED, V1Statuses.FAILED, V1Statuses.STOPPING, V1Statuses.STOPPED, V1Statuses.WARNING, V1Statuses.UNKNOWN, V1Statuses.RETRYING}
    ),
    V1Statuses.PROCESSING: frozenset(
        {V1Statuses.RUNNING, V1Statuses.SUCCEEDED, V1Statuses.FAILED, V1Statuses.STOPPED}
    ),
    V1Statuses.STOPPING: frozenset({V1Statuses.STOPPED, V1Statuses.FAILED}),
    V1Statuses.WARNING: frozenset(
        {V1Statuses.RUNNING, V1Statuses.SUCCEEDED, V1Statuses.FAILED, V1Statuses.STOPPED}
    ),
    V1Statuses.RETRYING: frozenset({V1Statuses.COMPILED, V1Statuses.QUEUED, V1Statuses.FAILED, V1Statuses.STOPPED}),
    V1Statuses.RESUMING: frozenset({V1Statuses.COMPILED, V1Statuses.FAILED, V1Statuses.STOPPED}),
    V1Statuses.UNSCHEDULABLE: frozenset({V1Statuses.QUEUED, V1Statuses.FAILED, V1Statuses.STOPPED}),
    V1Statuses.UNKNOWN: frozenset(
        {V1Statuses.RUNNING, V1Statuses.FAILED, V1Statuses.STOPPED, V1Statuses.RETRYING}
    ),
    # terminal states can only be left via explicit resume/retry
    V1Statuses.SUCCEEDED: frozenset(),
    V1Statuses.FAILED: frozenset({V1Statuses.RETRYING, V1Statuses.RESUMING}),
    V1Statuses.STOPPED: frozenset({V1Statuses.RESUMING}),
    V1Statuses.UPSTREAM_FAILED: frozenset(),
    V1Statuses.SKIPPED: frozenset(),
    V1Statuses.DONE: frozenset(),
}


def can_transition(src: V1Statuses, dst: V1Statuses) -> bool:
    if src == dst:
        return True
    return dst in TRANSITIONS.get(src, frozenset())


def is_done(status: V1Statuses) -> bool:
    return status in DONE_STATUSES
