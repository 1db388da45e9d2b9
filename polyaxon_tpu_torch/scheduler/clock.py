"""The scheduler's one time source, an own copy of
`polyaxon_tpu/scheduler/clock.py`: the wall clock in production, a stepped
`SimClock` in the simulator and the tests.

Every piece of scheduling arithmetic (queue wait, reservation age, event
order in the simulator) reads `clock.time()` from an injected Clock, which
keeps the fleet scheduler deterministic under simulation. Timestamps of
status conditions and metric rows are labels, not scheduling math, and
keep reading `time.time()`.
"""

from __future__ import annotations

import time as _time


class Clock:
    """The wall clock (the default)."""

    def time(self) -> float:
        return _time.time()


class SimClock(Clock):
    """A manually advanced clock for deterministic scheduling simulation."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def time(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance the clock backwards ({dt})")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now:
            raise ValueError(f"cannot rewind SimClock from {self._now} to {t}")
        self._now = float(t)
        return self._now


WALL = Clock()
