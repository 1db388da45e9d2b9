#!/usr/bin/env python3
"""Where a step of one `examples/lm_asha.yaml` trial goes, on one NVIDIA GPU.

    python3 sweep_step_profile.py [--steps N] [--device cpu]

Builds the trial's program from the YAML with WINNER's params (the
sweep's winner on the card, lr 3.58e-3 at dim 256) and its `matrix:`
dropped, and trains it with the port's Trainer in this one process, as a
sweep's trials run. Readings, one JSON line each:

- `cadence`: at logEvery 1, twice (the process's first trial, then a
  later one): the Trainer's construction seconds, the seconds to the first
  log point (emitted once step 2 is launched: the Trainer pipelines one
  log point) and the median ms a step between log points (each reads a
  loss, so every step syncs). At the YAML's logEvery, a Trainer of
  logEvery steps and one of logEvery + N: the ms a step of the N steps
  between (the longer run less the shorter).
- `profile`: torch.profiler over a fresh Trainer of 2 steps and one of 8;
  the 6 steps between them (the 8-step run less the 2-step run) give the
  device ms, the device kernels and the profiled wall ms a step. The
  device time sums the device events only, as `key_averages().table()`'s
  "Self CUDA time total" does: summing every row's self device time also
  counts each kernel again under the host op that launched it
  (`all_rows_device_ms` shows that sum). Also the top host ops of the
  8-step run.

Ends with the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PROFILED = (2, 8)
WINNER = {"lr": 0.0035819575552404155, "dim": 256}


def _program():
    from polyaxon_tpu_torch.compiler import compile_operation
    from polyaxon_tpu_torch.polyaxonfile.reader import read_polyaxonfile

    op = read_polyaxonfile(str(HERE / "examples" / "lm_asha.yaml"),
                           params={**WINNER, "steps": 1})
    return compile_operation(op.copy(matrix=None)).run.program


def _cadence(program, device: str, every: int, steps: int, label: str) -> dict:
    from polyaxon_tpu_torch.runtime import Trainer

    stamps = []
    prog = program.copy(train=program.train.copy(log_every=every, steps=steps))
    t0 = time.perf_counter()
    trainer = Trainer(prog, device=device, log_fn=lambda step, m: stamps.append(
        (step, time.perf_counter())))
    t1 = time.perf_counter()
    trainer.run()
    t2 = time.perf_counter()
    trainer.close()
    per_step = [(b[1] - a[1]) / (b[0] - a[0]) * 1e3 for a, b in zip(stamps, stamps[1:])
                if b[0] > a[0]]
    return {"reading": "cadence", "trial": label, "log_every": every, "steps": steps,
            "construct_s": t1 - t0, "to_first_log_s": stamps[0][1] - t1, "run_s": t2 - t1,
            "step_ms_median": statistics.median(per_step) if per_step else None}


def _profiled(program, device: str, steps: int):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from polyaxon_tpu_torch.runtime import Trainer

    trainer = Trainer(program.copy(train=program.train.copy(steps=steps, log_every=steps)),
                      device=device)
    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trainer.close()
    rows = prof.key_averages()
    dev = [e for e in rows if e.device_type == DeviceType.CUDA]
    return {
        "wall_ms": wall * 1e3,
        "device_ms": sum(e.self_device_time_total for e in dev) / 1e3,
        "all_rows_device_ms": sum(e.self_device_time_total for e in rows) / 1e3,
        "kernels": sum(e.count for e in dev),
        "top_host": [(e.key, e.count, round(e.self_cpu_time_total / 1e3, 2))
                     for e in sorted(rows, key=lambda e: -e.self_cpu_time_total)[:10]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100,
                    help="N, the steps timed at the YAML's logEvery")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch

    if a.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu for a rehearsal", file=sys.stderr)
        return 2
    program = _program()
    every = int(program.train.log_every)
    for label in ("first", "later"):
        print(json.dumps(_cadence(program, a.device, 1, 20, label)), flush=True)
    short, long = (_cadence(program, a.device, every, n, "later")
                   for n in (every, every + a.steps))
    print(json.dumps({"reading": "cadence", "log_every": every, "steps": [every, every + a.steps],
                      "run_s": [short["run_s"], long["run_s"]],
                      "step_ms": (long["run_s"] - short["run_s"]) / a.steps * 1e3}), flush=True)
    short, long = (_profiled(program, a.device, n) for n in PROFILED)
    k = PROFILED[1] - PROFILED[0]
    print(json.dumps({
        "reading": "profile", "steps": list(PROFILED),
        "device_ms_per_step": (long["device_ms"] - short["device_ms"]) / k,
        "kernels_per_step": (long["kernels"] - short["kernels"]) / k,
        "profiled_wall_ms_per_step": (long["wall_ms"] - short["wall_ms"]) / k,
        "runs": {str(n): {key: r[key] for key in ("wall_ms", "device_ms",
                                                  "all_rows_device_ms", "kernels")}
                 for n, r in zip(PROFILED, (short, long))},
        "top_host_8_steps": long["top_host"],
    }), flush=True)
    if a.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
