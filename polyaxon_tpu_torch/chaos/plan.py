"""FaultPlan: a seeded, declarative schedule of faults. An own copy of
`Fault` and `FaultPlan` from `polyaxon_tpu/chaos/plan.py` (stdlib only),
with the canned scenarios the port's tests use (`corrupt_then_kill`,
`kv_handoff_crash`); the others follow the modules that use them (the
executor, the event log).

A scenario is a list of `Fault` entries bound to named injection points
(`trainer.step`, `checkpoint.save`, `checkpoint.upload`, the KV handoff's
`serving.kv_export`, `serving.kv_import` and `serving.kv_adopt`). Everything random
about a scenario is drawn from a string-seeded PRNG when the plan is built,
so one seed gives one scenario in every process. `chaos.injector.arm(plan)`
makes the instrumented points consult it.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass
class Fault:
    """One scheduled fault.

    point:   injection-point name the fault is bound to.
    action:  "raise" (TransientError), "raise_permanent" (PermanentError),
             "kill" (simulated SIGKILL), "sigterm" (a real SIGTERM to this
             process: the preemption notice), "corrupt_checkpoint" (scramble
             the step just written), "scramble_tail" (a spill segment's
             torn tail, then a kill) or "sleep" (stall `delay_ms`).
    at:      fire on the Nth hit of the point (0-based) when `step` is None.
    count:   how many times the fault fires before it is spent.
    step:    when set, fire on the hit whose ctx carries this step.
    message: text carried by raised errors.
    delay_ms: stall of the "sleep" action.
    """

    point: str
    action: str
    at: int = 0
    count: int = 1
    step: Optional[int] = None
    message: str = "chaos: injected fault"
    delay_ms: float = 50.0
    fired: int = 0

    def _due(self, hit_index: int, ctx: dict) -> bool:
        if self.fired >= self.count:
            return False
        if self.step is not None:
            return ctx.get("step") == self.step
        return self.at <= hit_index < self.at + self.count


class FaultPlan:
    """A reproducible fault scenario: faults and the seed that shaped them.
    `params` records every seed-derived choice, so tests can assert exact
    recovery points."""

    def __init__(self, faults=(), *, seed: int = 0, params: Optional[dict] = None):
        self.seed = seed
        self.faults = list(faults)
        self.params = dict(params or {})
        self._hits: dict[str, int] = {}

    def rng(self, salt: str) -> random.Random:
        """Deterministic sub-stream for `salt`, so two injectors never share
        (and thus perturb) one stream."""
        return random.Random(f"{self.seed}:{salt}")

    def fire(self, point: str, **ctx) -> Optional[Fault]:
        """Record a hit of `point`; return the fault due now (consuming one
        of its `count`), or None. At most one fault fires per hit."""
        i = self._hits.get(point, 0)
        self._hits[point] = i + 1
        for fault in self.faults:
            if fault.point == point and fault._due(i, ctx):
                fault.fired += 1
                return fault
        return None

    # ------------------------------------------------- canned scenarios
    @classmethod
    def corrupt_then_kill(cls, seed: int, steps: int, checkpoint_every: int) -> "FaultPlan":
        """The newest checkpoint is corrupted the moment it lands, then the
        process dies before the next one: resume must fall back to the
        previous intact step. The corrupted step is a seed-chosen multiple
        of `checkpoint_every` (from the second on, so a fallback exists)."""
        rng = random.Random(f"corrupt_then_kill:{seed}")
        c = rng.choice(list(range(2 * checkpoint_every, steps, checkpoint_every)))
        k = rng.randrange(c, min(c + checkpoint_every, steps))
        return cls(
            [Fault("checkpoint.save", "corrupt_checkpoint", step=c),
             Fault("trainer.step", "kill", step=k,
                   message=f"chaos: process killed at step {k}")],
            seed=seed,
            params={"corrupt_step": c, "kill_step": k,
                    "fallback_step": c - checkpoint_every},
        )

    @classmethod
    def kv_handoff_crash(
        cls, seed: int, window: int = 4, action: str = "raise"
    ) -> "FaultPlan":
        """A fault lands in a seed-chosen window of the live KV handoff:
        export capture or send on the prefill side, the import's parse on
        the decode side, or the adopt itself. Whatever the window, zero
        pages leak on either replica and the request still completes with
        the same tokens, by a clean retry or the prefill replica's local
        fallback. The point and the hit index are seed-chosen, so repeated
        runs walk different handoffs."""
        rng = random.Random(f"kv_handoff_crash:{seed}")
        point = rng.choice(
            ["serving.kv_export", "serving.kv_import", "serving.kv_adopt"]
        )
        k = rng.randrange(0, max(1, window))
        return cls(
            [Fault(point, action, at=k, message=f"chaos: handoff fault at {point} #{k}")],
            seed=seed,
            params={"fault_point": point, "fault_hit": k, "fault_action": action},
        )
