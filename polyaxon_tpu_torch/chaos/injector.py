"""Process-level fault injection (failpoint style), an own copy of
`polyaxon_tpu/chaos/injector.py` for the trainer, its checkpoints and the
serving spill tier.

Instrumented sites call `inject("<point>", **ctx)`, a module-global None
check when no plan is armed:

    trainer.step       ctx: step                       — each loop iteration
    checkpoint.save    ctx: step, directory, manager   — after a save starts
    checkpoint.upload  ctx: step, src, directory       — before the publish
    kv.spill           ctx: h, path, phase             — a spill segment's
                                                         meta / payload frames
    kv.restore         ctx: h, pages                   — a restore mid-way
    serving.adapter_restore ctx: name, slot, restored  — before a slot write

The actions are real: "sigterm" sends a SIGTERM to this process (the
preemption handler runs end to end), "corrupt_checkpoint" overwrites the
files just written, "scramble_tail" appends seeded garbage to a spill
segment (then dies); `corrupt_segment_frame` flips a byte of a segment's
first frame (bit rot). Only "kill" is simulated: `SimulatedKill` stands in for
a SIGKILL, which no in-process harness survives to observe.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from pathlib import Path
from typing import Optional

from ..retry import PermanentError, TransientError
from .plan import Fault, FaultPlan


class ChaosError(TransientError):
    """Generic injected transient fault."""


class SimulatedKill(TransientError):
    """Stand-in for an abrupt process death mid-step: no cleanup ran, no
    checkpoint was flushed; recovery comes from persisted state only."""


_active: Optional[FaultPlan] = None


def arm(plan: FaultPlan) -> None:
    global _active
    _active = plan


def disarm() -> None:
    global _active
    _active = None


@contextlib.contextmanager
def active(plan: FaultPlan):
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


def inject(point: str, **ctx) -> None:
    """Fault-injection site. No-op unless a plan is armed."""
    plan = _active
    if plan is None:
        return
    fault = plan.fire(point, **ctx)
    if fault is not None:
        # recorded before it is performed: several actions raise
        from ..telemetry import get_registry, get_tracer

        get_registry().counter("chaos.injections", help="Chaos faults actually fired").inc()
        get_tracer().event(
            "chaos.injection", point=point, action=fault.action, step=ctx.get("step")
        )
        _perform(fault, point, ctx)


def _perform(fault: Fault, point: str, ctx: dict) -> None:
    if fault.action == "raise":
        raise ChaosError(f"{fault.message} [{point} {ctx.get('step', '')}]")
    if fault.action == "raise_permanent":
        raise PermanentError(f"{fault.message} [{point}]")
    if fault.action == "kill":
        raise SimulatedKill(fault.message)
    if fault.action == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return
    if fault.action == "sleep":
        time.sleep(max(0.0, fault.delay_ms) / 1e3)
        return
    if fault.action == "corrupt_checkpoint":
        mgr = ctx.get("manager")
        if mgr is not None:
            # the write runs in the background: corrupting before it lands
            # would race the writer
            mgr.wait_until_finished()
        corrupt_checkpoint(ctx["directory"], step=ctx.get("step"))
        return
    if fault.action == "scramble_tail":
        # a crash mid-append as the disk sees it: some garbage bytes made it
        # into the segment, then the process died; recovery must truncate
        # back to the last whole frame
        scramble_tail(ctx["path"], _active.rng("scramble_tail"))
        raise SimulatedKill(fault.message)
    raise ValueError(f"unknown chaos action {fault.action!r}")


def scramble_tail(path: str, rng) -> int:
    """Append 5-40 seeded garbage bytes to a segment — the torn tail a power
    cut leaves. Returns the number of bytes appended."""
    n = rng.randrange(5, 40)
    garbage = bytes(rng.randrange(256) for _ in range(n))
    with open(path, "ab") as f:
        f.write(garbage)
    return n


def corrupt_segment_frame(path: str) -> None:
    """Flip one payload byte of the FIRST frame of a framed segment (its CRC
    now mismatches with valid data after it: the 'corrupt' verdict, not
    'torn'). No-op on segments without a whole first frame."""
    import struct

    header = struct.Struct("<II")
    p = Path(path)
    try:
        data = bytearray(p.read_bytes())
    except OSError:
        return
    if len(data) < header.size:
        return
    length, _ = header.unpack_from(data, 0)
    if length <= 0 or header.size + length > len(data):
        return
    data[header.size] ^= 0xFF
    p.write_bytes(bytes(data))


def corrupt_checkpoint(directory: str, step: Optional[int] = None) -> int:
    """Overwrite every file of one checkpoint step with garbage bytes (the
    newest step when `step` is None). Returns the corrupted step. Layout:
    <directory>/<step>/..."""
    root = Path(directory)
    steps = sorted(
        (int(p.name) for p in root.iterdir() if p.is_dir() and p.name.isdigit()),
        reverse=True,
    )
    if not steps:
        raise FileNotFoundError(f"no checkpoint steps under {directory}")
    target = int(step) if step is not None else steps[0]
    if target not in steps:
        raise FileNotFoundError(f"no checkpoint step {target} under {directory}")
    n = 0
    for f in sorted((root / str(target)).rglob("*")):
        if f.is_file():
            f.write_bytes(b"chaos: corrupted checkpoint bytes")
            n += 1
    if n == 0:
        raise FileNotFoundError(f"checkpoint step {target} has no files")
    return target
