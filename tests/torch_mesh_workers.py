"""Worker processes for the port's multi-rank tests on the CPU.

`run_world(n, cases)` starts n processes of this file, one rank each, that
join a `gloo` world (`MASTER_ADDR`/`MASTER_PORT`, `RANK`, `WORLD_SIZE`,
one thread each), run every case in order, each a function of this module
called with its keyword arguments, and hand back one list of results per
rank. One world serves all the cases of a test module; the workers import
torch and the port only.

    python tests/torch_mesh_workers.py <cases.pkl> <results-prefix>
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, cases: list, timeout: float = 300.0) -> list:
    """Run `cases` ([(function name, kwargs), ...]) on a world of `n`
    ranks → [results of rank 0, results of rank 1, ...]."""
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "cases.pkl")
        with open(inp, "wb") as f:
            pickle.dump(cases, f)
        env = dict(
            os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
            WORLD_SIZE=str(n), POLYAXON_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
            PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
        )
        procs = []
        for r in range(n):
            log = open(os.path.join(tmp, f"log{r}"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, __file__, inp, os.path.join(tmp, "out")],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT), log))
        try:
            codes = [p.wait(timeout=timeout) for p, _ in procs]
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            tails = []
            for r, (_, log) in enumerate(procs):
                log.seek(0)
                tails.append(f"--- rank {r} (exit {codes[r]}):\n{log.read()[-4000:]}")
            raise RuntimeError("a worker failed:\n" + "\n".join(tails))
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ------------------------------------------------------------------ cases
def _np(t):
    return t.detach().float().cpu().numpy().copy()  # never a view of live storage


def trainer_run(program, mesh_axes=None, slices=1, state=None, checkpoint_dir=None,
                restore=False, shards=()):
    """Train `program` on the mesh; (losses, grad norms, eval metrics by
    step, the final parameters in full, the buffers, the rank's local
    shards of the parameters named in `shards` before training). `state`:
    full starting weights (and buffers)."""
    import torch

    from polyaxon_tpu_torch.parallel.params import full_tensors
    from polyaxon_tpu_torch.runtime import Trainer

    trainer = Trainer(program, device="cpu", mesh_axes=mesh_axes, slices=slices,
                      checkpoint_dir=checkpoint_dir)
    if state is not None:
        trainer.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if restore:
        trainer.restore()
    named = dict(trainer.module.named_parameters())
    local = {n: _np(named[n].to_local()) for n in shards}
    result = trainer.run()
    trainer.close()
    params = full_tensors(dict(trainer.module.named_parameters()))
    return {
        "history": result.history,
        "params": {k: _np(v) for k, v in params.items()},
        "buffers": {k: _np(v) for k, v in trainer.module.named_buffers()
                    if "running" in k},
        "shards": local,
        "step": trainer.step,
    }


def moe_step(program, mesh_axes, state):
    """One forward and backward of the MoE transformer on the mesh, on the
    stream's first batch: the global loss and aux loss, the tokens past
    their expert's capacity in each layer (summed over the ranks that hold
    other tokens), and the full gradients of the MoE parameters."""
    import torch

    from polyaxon_tpu_torch.parallel.collectives import all_reduce
    from polyaxon_tpu_torch.parallel.params import full_tensors
    from polyaxon_tpu_torch.runtime import Trainer
    from polyaxon_tpu_torch.runtime.trainer import step_seed

    trainer = Trainer(program, device="cpu", mesh_axes=mesh_axes)
    trainer.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    batch = trainer._to_device(next(trainer.data.iterator))
    dropped = []
    for i, layer in enumerate(trainer.module.layers):
        layer.moe.register_forward_hook(
            lambda mod, args, out: dropped.append((out.abs().sum(-1) == 0).sum().float()))
    trainer.module.train()
    loss, _, box = trainer._loss(batch, step_seed(0, 0))
    loss.backward()
    if trainer.sharded is not None:
        trainer.sharded.reduce_grads(trainer.module)
    groups = trainer._data_groups() if trainer.mesh is not None else []
    grads = {n: _np(full_tensors(p.grad)) for n, p in trainer.module.named_parameters()
             if ".moe." in n}
    trainer.close()
    return {
        "loss": float(trainer._global(loss)),
        "aux": float(trainer._global(box.aux_loss("cpu"))),
        "dropped": [float(all_reduce(d, groups)) for d in dropped],
        "grads": grads,
    }


def forward_grads(program, mesh_axes, state, tokens):
    """The logits of `tokens` (this rank's batch slice) and the full
    gradients of their mean, through the Trainer's forward on the mesh.
    The ranks of `pipeline` hold equal shares of the loss, so each takes
    the mean over their count."""
    import torch

    from polyaxon_tpu_torch.parallel.mesh import axis_sizes
    from polyaxon_tpu_torch.parallel.params import full_tensors
    from polyaxon_tpu_torch.runtime import Trainer

    trainer = Trainer(program, device="cpu", mesh_axes=mesh_axes)
    trainer.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    params = trainer._compute_params()
    logits, _, _ = trainer._apply(params, torch.from_numpy(tokens), None)
    (logits.float().mean() / axis_sizes(trainer.mesh).get("pipeline", 1)).backward()
    if trainer.sharded is not None:
        trainer.sharded.reduce_grads(trainer.module)
    grads = {n: _np(full_tensors(p.grad)) for n, p in trainer.module.named_parameters()}
    trainer.close()
    return {"logits": _np(logits), "grads": grads}


def trainer_error(program, mesh_axes):
    """(type name, message) of what building a Trainer on the mesh
    raises, or None."""
    from polyaxon_tpu_torch.runtime import Trainer

    try:
        Trainer(program, device="cpu", mesh_axes=mesh_axes).close()
    except Exception as e:  # noqa: BLE001 — handed back to the test
        return type(e).__name__, str(e)
    return None


def trainer_step_error(program, mesh_axes):
    """(type name, message) of what the Trainer's first step on the mesh
    raises, or None."""
    from polyaxon_tpu_torch.runtime import Trainer

    trainer = Trainer(program, device="cpu", mesh_axes=mesh_axes)
    try:
        trainer.run()
    except Exception as e:  # noqa: BLE001 — handed back to the test
        return type(e).__name__, str(e)
    finally:
        trainer.close()
    return None


def param_layout(program, mesh_axes, state, slices=1):
    """Each parameter's spec (the rules resolved on the mesh) and this
    rank's local shard after loading the full `state`, with the mesh's
    rank layout."""
    import torch

    from polyaxon_tpu_torch.parallel.sharding import param_specs
    from polyaxon_tpu_torch.runtime import Trainer

    trainer = Trainer(program, device="cpu", mesh_axes=mesh_axes, slices=slices)
    trainer.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    trainer.close()
    named = list(trainer.module.named_parameters())
    return {
        "specs": param_specs(named, trainer.bundle.sharding_rules, trainer.mesh),
        "shards": {n: _np(p.to_local()) for n, p in named},
        "ranks": trainer.mesh.mesh.numpy(),
    }


def attention(fn, mesh_axes, q, k, v, do, placements, causal=True, block_kv=512):
    """ring/ulysses attention on DTensors built from the full arrays with
    `placements` ({'q': spec, 'kv': spec}: tensor dim → mesh axis or a
    tuple of axes); (o, dq, dk, dv) in full."""
    import torch
    from torch.distributed.tensor import DTensor

    from polyaxon_tpu_torch.parallel import ring, ulysses
    from polyaxon_tpu_torch.parallel.mesh import build_mesh
    from polyaxon_tpu_torch.parallel.sharding import placements as to_pl
    from polyaxon_tpu_torch.parallel.sharding import shard_tensor

    mesh = build_mesh(mesh_axes)
    ts = []
    for name, a in (("q", q), ("kv", k), ("kv", v)):
        full = torch.from_numpy(a)
        dt = shard_tensor(full, mesh, to_pl(tuple(placements[name]), mesh))
        ts.append(dt.detach().requires_grad_())
    body = {"ring": ring.ring_attention, "ulysses": ulysses.ulysses_attention}[fn]
    o = body(*ts, causal=causal, block_kv=block_kv)
    assert isinstance(o, DTensor) and tuple(o.placements) == tuple(ts[0].placements)
    g = shard_tensor(torch.from_numpy(do), mesh, o.placements)
    (o * g).sum().backward()
    return [_np(t.full_tensor()) for t in (o, *(x.grad for x in ts))]


OPT_PARAMS = [((16, 32), ("model", "fsdp")), ((32, 16), ("fsdp", "model")),
              ((8, 32), (None, ("model", "fsdp"))), ((32,), ())]


def optimizer_steps(name, config, steps=2, mesh_axes=None):
    """`steps` updates of optimizer `name` from seeded parameters and
    gradients; with `mesh_axes`, on DTensors placed by OPT_PARAMS' specs.
    → the parameters in full."""
    import torch

    from polyaxon_tpu_torch.ops.optimizers import build_optimizer
    from polyaxon_tpu_torch.parallel.mesh import build_mesh
    from polyaxon_tpu_torch.parallel.sharding import placements, shard_tensor

    gen = torch.Generator().manual_seed(0)
    full = [torch.randn(shape, generator=gen) for shape, _ in OPT_PARAMS]
    grads = [[torch.randn(shape, generator=gen) for shape, _ in OPT_PARAMS]
             for _ in range(steps)]
    mesh = build_mesh(mesh_axes) if mesh_axes else None

    def place(t, spec):
        return t.clone() if mesh is None else shard_tensor(t, mesh, placements(spec, mesh))

    params = [torch.nn.Parameter(place(t, spec)) for t, (_, spec) in zip(full, OPT_PARAMS)]
    opt, _ = build_optimizer(params, name=name, learning_rate=1e-2, config=config,
                             total_steps=steps)
    for step in grads:
        for p, g, (_, spec) in zip(params, step, OPT_PARAMS):
            p.grad = place(g, spec)
        opt.step()
    return [_np(p.full_tensor() if mesh is not None else p) for p in params]


def vocab_parallel_losses(logits, features, kernel, labels, mesh_axes):
    """masked_lm, accuracy and the fused loss with the vocabulary split over
    `model` and the batch over `data`: the global values (each rank's
    share summed) and, for the losses, the gradients in full."""
    import torch

    from polyaxon_tpu_torch.ops.losses import accuracy, fused_linear_masked_lm, masked_lm
    from polyaxon_tpu_torch.parallel.collectives import (
        all_reduce, axis_group, axis_index, copy_to)
    from polyaxon_tpu_torch.parallel.mesh import build_mesh
    from polyaxon_tpu_torch.parallel.sharding import local_shard, placements

    mesh = build_mesh(mesh_axes)
    model, data = axis_group(mesh, "model"), axis_group(mesh, "data")
    lab = local_shard(torch.from_numpy(labels), mesh, placements(("data",), mesh))
    lg = local_shard(torch.from_numpy(logits), mesh, placements(("data", None, "model"), mesh))
    lg.requires_grad_()
    ft = local_shard(torch.from_numpy(features), mesh, placements(("data",), mesh))
    ft.requires_grad_()
    ker = local_shard(torch.from_numpy(kernel), mesh, placements((None, "model"), mesh))
    ker.requires_grad_()
    vocab = (model, axis_index(mesh, "model") * lg.shape[-1])
    count = all_reduce((lab != -100).sum().float(), [data])
    batch = {"labels": lab}
    loss = masked_lm(lg, batch, count=count, vocab=vocab)
    fused = fused_linear_masked_lm(copy_to(ft, model), ker, lab, chunk_size=7,
                                   count=count, vocab=vocab)
    (loss + fused).backward()
    acc = accuracy(lg.detach(), batch, count=count, vocab=vocab)
    out = [all_reduce(t.detach().clone(), [data]) for t in (loss, fused, acc)]
    return [float(t) for t in out] + [_np(lg.grad), _np(ft.grad), _np(ker.grad)]


def health(expected_devices=None):
    """check_slice's report, or the SliceHealthError's message."""
    from polyaxon_tpu_torch.runtime.health import SliceHealthError, check_slice

    try:
        return check_slice(expected_devices=expected_devices)
    except SliceHealthError as e:
        return f"SliceHealthError: {e}"


def main() -> int:
    import torch
    import torch.distributed as dist

    inp, prefix = sys.argv[1], sys.argv[2]
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world,
    )
    with open(inp, "rb") as f:
        cases = pickle.load(f)
    results = [globals()[name](**kwargs) for name, kwargs in cases]
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{prefix}{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
