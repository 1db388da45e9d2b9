"""Distributed JAXJob worker: one process of the gang, counterpart of
`polyaxon_tpu/runtime/worker.py`.

Launched by the port's supervisor (`native/launcher.cpp`), which injects
torch.distributed's rendezvous environment (`MASTER_ADDR`, `MASTER_PORT`,
`RANK`, `WORLD_SIZE`). Where the reference runs one process per replica
that drives all of its host's devices, each process here drives one
device: a replica of k devices (`POLYAXON_REPLICA_DEVICES`, from the
executor's `replica_devices`; the whole world when unset) is k workers,
rank r being replica r // k and `LOCAL_RANK` r % k within it. Every
process runs the same program on its own device (`cuda:LOCAL_RANK` under
`nccl`, among its replica's block of the host's GPUs, as a host of its own
would see them; the CPU under `gloo` only when `POLYAXON_TORCH_DEVICE`
asks for it); the ranks form one mesh (`runtime/trainer.py`). With fewer
visible GPUs than a replica's workers the worker refuses, naming the
counts; it never carries on on the CPU. Each worker prints one
`{"event": "worker_device", ...}` line (rank, local rank, replica,
device), which the supervisor relays into the run's logs.

SIGTERM is a preemption notice: the trainer checkpoints at the next step
and the worker exits 75, which the executor reads as `Preempted`. Rank 0
(replica 0) is the chief and the only writer: metrics, logs, events and
the summary go to the run store it shares with the supervisor. The
per-process records are the reference's, by replica: `process_id` in
`worker_preempted`, `num_processes` in `run_summary`, `process_count` in
`slice_health`.

    python -m polyaxon_tpu_torch.runtime.worker   (spec in POLYAXON_PROGRAM_SPEC)
"""

from __future__ import annotations

import json
import os
import sys


def gang_layout(rank: int, world: int) -> tuple[int, int, int]:
    """(replica, local rank, devices per replica) of `rank` in a gang of
    `world` workers, from `POLYAXON_REPLICA_DEVICES`."""
    k = int(os.environ.get("POLYAXON_REPLICA_DEVICES") or world)
    if k < 1 or world % k:
        raise ValueError(f"a gang of {world} workers does not split into replicas of {k}")
    replica, local_rank = divmod(rank, k)
    return replica, local_rank, k


def own_gpu_block(replica: int, k: int, world: int) -> None:
    """Narrow `CUDA_VISIBLE_DEVICES` to the replica's block of k GPUs of
    the host (before CUDA starts), so `cuda:LOCAL_RANK` is this worker's
    own GPU when the replicas share one host."""
    ids = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ids.split(",") if ids else [str(i) for i in range(world)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[replica * k:(replica + 1) * k])


def init_process_group(rank: int, world: int, local_rank: int,
                       replica_devices: int = 0) -> str:
    """Start the process group on this worker's device; returns the device
    name ("cuda:<local rank>" or "cpu"). `replica_devices`: the GPUs this
    worker's replica needs visible (the whole world when 0)."""
    import torch
    import torch.distributed as dist

    from ..device import env_device

    want = torch.device(env_device())
    if want.type == "cuda":
        k = replica_devices or world
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < k:
            raise RuntimeError(
                f"the gang has {world} workers (replicas: {world // k} x {k} devices), "
                f"one GPU each, but {visible} GPU(s) are visible to a replica; set "
                "POLYAXON_TORCH_DEVICE=cpu to run it on the CPU under gloo"
            )
        torch.cuda.set_device(local_rank)
        device, backend = f"cuda:{local_rank}", "nccl"
    else:
        device, backend = "cpu", "gloo"
    addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return device


def main() -> int:
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    replica, local_rank, k = gang_layout(rank, world)
    os.environ["LOCAL_RANK"] = str(local_rank)
    spec_path = os.environ["POLYAXON_PROGRAM_SPEC"]

    from ..device import env_device

    if env_device().startswith("cuda") and world > k:
        own_gpu_block(replica, k, world)

    # SIGTERM = preemption notice: flag it so the training loop can
    # checkpoint and exit instead of dying mid-write
    from . import preemption

    preemption.install()
    import torch

    if not os.environ.get("OMP_NUM_THREADS"):  # the host's cores shared by the gang
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, world)))
    device = init_process_group(rank, world, local_rank, k)
    print(json.dumps({"event": "worker_device", "rank": rank, "local_rank": local_rank,
                      "replica": replica, "device": device}, separators=(",", ":")),
          flush=True)

    # fail fast: a half-alive gang surfaces here, not as a hang inside the
    # first training collective
    from .health import check_slice

    health = check_slice(processes=world // k)

    with open(spec_path) as f:
        payload = json.load(f)

    from ..retry import Preempted
    from ..schemas.run_kinds import V1Program
    from .trainer import Trainer

    program = V1Program.from_dict(payload["program"])
    run_uuid = payload["runUuid"]
    is_chief = rank == 0  # replica 0's first worker

    store = log_fn = event_fn = None
    if is_chief:
        from ..store import RunStore

        store = RunStore()
        store.log_event(run_uuid, "slice_health", health)

        def log_fn(step: int, metrics: dict):
            store.log_metrics(run_uuid, step, metrics)
            store.append_log(run_uuid, f"step {step}: " + " ".join(
                f"{k}={v:.6g}" for k, v in metrics.items()))

        def event_fn(kind: str, body: dict):
            store.log_event(run_uuid, kind, body)

    trainer = Trainer(
        program,
        device=device,
        mesh_axes=payload.get("mesh") or {"data": -1},
        slices=int(payload.get("slices") or 1),
        log_fn=log_fn,
        event_fn=event_fn,
        checkpoint_dir=payload.get("checkpointDir"),
    )
    try:
        result = trainer.run()
    except Preempted as e:
        # the checkpoint is flushed: 75 (EX_TEMPFAIL) asks for a warm restart
        if is_chief:
            store.log_event(run_uuid, "worker_preempted",
                            {"process_id": replica, "step": e.step})
        return 75
    finally:
        trainer.close()
    if is_chief:
        store.log_event(run_uuid, "run_summary", {
            "steps_per_sec": result.steps_per_sec,
            "final_metrics": result.final_metrics,
            "num_processes": world // k,
        })
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
