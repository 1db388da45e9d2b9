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


def dropout_forward(program, mesh_axes, state, inputs, seed):
    """The training-mode output of the Trainer's forward on the mesh, on
    `inputs` (this rank's rows) with the dropout seed `seed`."""
    import torch

    from polyaxon_tpu_torch.runtime import Trainer

    trainer = Trainer(program, device="cpu", mesh_axes=mesh_axes)
    trainer.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    trainer.module.train()
    with torch.no_grad():
        out, _, _ = trainer._apply(trainer._compute_params(), torch.from_numpy(inputs), seed)
    trainer.close()
    return _np(out)


def moe_noise_forward(mesh_axes, state, inputs, seed):
    """The training-mode output of a `MoEFeedForward` with router noise on
    the bound mesh, on this rank's rows of `inputs` (world rank r holds
    the r-th equal share), the noise drawn from a generator seeded
    `seed`."""
    import torch
    import torch.distributed as dist

    from polyaxon_tpu_torch.models.moe import MoEFeedForward
    from polyaxon_tpu_torch.parallel.mesh import build_mesh
    from polyaxon_tpu_torch.parallel.ring import set_current_mesh

    moe = MoEFeedForward(*MOE_NOISE_SHAPE, router_noise=1.0)
    moe.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    moe.train()
    rows = len(inputs) // dist.get_world_size()
    mine = torch.from_numpy(inputs[dist.get_rank() * rows:][:rows])
    set_current_mesh(build_mesh(mesh_axes))
    try:
        with torch.no_grad():
            return _np(moe(mine, torch.Generator().manual_seed(seed)))
    finally:
        set_current_mesh(None)


# (dim, ffn_dim, n_experts) of `moe_noise_forward`'s module
MOE_NOISE_SHAPE = (16, 24, 4)


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


def _serving_lm(model_config, state):
    """The port's Transformer on the CPU from a numpy state dict."""
    import torch

    from polyaxon_tpu_torch.models import build_model

    module = build_model("transformer_lm", model_config, device="cpu").module
    module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return module.eval()


def _call(url, path, body=None):
    """(status, JSON answer or /metricsz text) of one HTTP call."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            data = resp.read()
            code = resp.status
    except urllib.error.HTTPError as e:
        data, code = e.read(), e.code
    return code, (data.decode() if path == "/metricsz" else json.loads(data))


def _serve_one(server, inline, http, sequential=False):
    """Rank 0's answers of one server: `inline` bodies through
    `generate` (and /statsz right after them), `http` bodies posted at once
    (or one at a time) over HTTP, /statsz, /metricsz and /readyz."""
    import threading

    out = {"inline": [server.generate(b)["tokens"] for b in inline],
           "stats_inline": server.stats()}
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"

    def call(path, body=None):
        return _call(url, path, body)

    answers = [None] * len(http)

    def one(i):
        answers[i] = call("/generate", http[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(http))]
    for t in threads:
        t.start()
        if sequential:
            t.join(180)
    for t in threads:
        t.join(180)
    out["http"] = answers
    out["stats"] = call("/statsz")[1]
    out["metrics"] = call("/metricsz")[1]
    out["readyz"] = call("/readyz")
    return out


def _spill_drive(server, bodies):
    """Post `bodies` one at a time (a target prompt, a flood that evicts
    its prefix into the spill tier, the target again): the answers, the
    kv stats, and every payload the tier took, by its chain head, as
    numpy (tokens, hashes, per page per leaf)."""
    kv = server._kv
    demoted = {}
    put = kv._spill.put

    def record(payload):
        demoted[payload.hashes[-1]] = (list(payload.tokens), list(payload.hashes),
                                       [[_np(t) for t in page] for page in payload.pages])
        return put(payload)

    kv._spill.put = record
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    answers = [_call(url, "/generate", b) for b in bodies]
    return {"http": answers, "stats": _call(url, "/statsz")[1], "demoted": demoted}


def _pool_drive(server, model_config, state, bodies, mesh_role, pool):
    """The mesh replica (`server`, role `mesh_role`) beside a one-device
    replica of the other role (ServingConfig `pool`), behind the port's
    router: `bodies` posted through it one at a time. → the answers, both
    replicas' /statsz handoff blocks, the pages each export put on the wire
    (as numpy), by request, and, on a decode mesh, the adopted chains'
    pages read back off it."""
    import time

    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.router import P2CBalancer, Router
    from polyaxon_tpu_torch.serving.server import ModelServer

    other = ModelServer(_serving_lm(model_config, state), None,
                        ServingConfig(**pool, role="decode" if mesh_role == "prefill"
                                      else "prefill"), device="cpu")
    urls = {"mesh": f"http://127.0.0.1:{server.start('127.0.0.1', 0)}",
            "one": f"http://127.0.0.1:{other.start('127.0.0.1', 0)}"}
    prefill = server if mesh_role == "prefill" else other
    exported = []
    export = prefill._kv.export_prefix

    def record(tokens, namespace=""):
        payload = export(tokens, namespace)
        if payload is not None:
            exported.append([[_np(t) for t in page] for page in payload.pages])
        return payload

    prefill._kv.export_prefix = record
    order = [urls["mesh"], urls["one"]] if mesh_role == "prefill" else [urls["one"],
                                                                         urls["mesh"]]
    # no prefix affinity: a decode replica holding an adopted prefix would
    # take the next prompt that shares it, without a handoff
    router = Router(order, balancer=P2CBalancer(seed=7), poll_interval_s=0.1,
                    affinity=False)
    rurl = f"http://127.0.0.1:{router.start('127.0.0.1', 0)}"
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            router.poll_once()
            reps = router.stats()["replicas"]
            if len(reps) == 2 and all(r["healthy"] for r in reps):
                break
            time.sleep(0.05)
        answers = [_call(rurl, "/generate", b) for b in bodies]
        readback = []
        if mesh_role == "decode":  # the adopted chains, read back off the mesh
            for b in bodies:
                payload = server._kv.export_prefix(b["tokens"][0])
                readback.append([[_np(t) for t in page] for page in payload.pages])
        return {"http": answers, "exported": exported, "readback": readback,
                "handoff": {k: _call(u, "/statsz")[1]["handoff"] for k, u in urls.items()},
                "stats": _call(urls["mesh"], "/statsz")[1]}
    finally:
        router.stop()
        other.stop()


def serve_mesh(model_config, state, mesh_axes, configs, inline=(), http=(),
               expected_devices=None):
    """One ModelServer a config ((name, ServingConfig kwargs[, plan])) on
    the decode mesh of `mesh_axes`, every rank from `state`: rank 0 drives
    it and stops it, the followers follow. A plan overrides what rank 0
    does: "model" ((config, state) of another model), "inline", "http"
    and "sequential" (`_serve_one`'s), or "drive": "spill" (its "http"
    bodies one at a time, `_spill_drive`) or "prefill"/"decode" (the mesh
    in that role beside a one-device replica behind the router, the
    ServingConfig of which is the plan's "pool", `_pool_drive`). → rank 0:
    {name: answers}; a follower: {name: (commands run, its shard bytes)}."""
    from polyaxon_tpu_torch.parallel.mesh import decode_mesh
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    mesh = decode_mesh(mesh_axes)
    out = {}
    for name, kwargs, *rest in configs:
        plan = rest[0] if rest else {}
        mcfg, mstate = plan.get("model", (model_config, state))
        server = ModelServer(_serving_lm(mcfg, mstate), None,
                             ServingConfig(**kwargs), device="cpu", mesh=mesh,
                             expected_devices=expected_devices)
        if server.is_follower:
            out[name] = (server.follow(), server.mesh_shard_bytes)
            continue
        try:
            drive = plan.get("drive", "serve")
            if drive == "spill":
                answers = _spill_drive(server, plan["http"])
            elif drive in ("prefill", "decode"):
                answers = _pool_drive(server, mcfg, mstate, plan["http"], drive, plan["pool"])
            else:
                answers = _serve_one(server, plan.get("inline", inline), plan.get("http", http),
                                     plan.get("sequential", False))
            out[name] = {**answers,
                         "shard_bytes": server.mesh_shard_bytes,
                         "sent": dict(server._world.ops),
                         "logit_gathers": server._world.logit_gathers}
        finally:
            server.stop()
    return out


def serve_from_run(home, run, mesh_axes, inline=(), http=(), overrides=None):
    """`ModelServer.from_run` of the port run `run` in the store at `home`
    on the decode mesh of `mesh_axes` (with ServingConfig `overrides`):
    rank 0's answers, or a follower's (commands run, shard bytes, what its
    restore read)."""
    from polyaxon_tpu_torch.serving.server import ModelServer
    from polyaxon_tpu_torch.store import RunStore

    server = ModelServer.from_run(run, store=RunStore(home), mesh_axes=mesh_axes,
                                  config_overrides=overrides, device="cpu")
    if server.is_follower:
        return server.follow(), server.mesh_shard_bytes, server.restore_info["bytes_read"]
    try:
        return {**_serve_one(server, inline, http), "step": server.step,
                "bytes_read": server.restore_info["bytes_read"]}
    finally:
        server.stop()


def serve_error(model_config, state, mesh_axes, kwargs):
    """What constructing a ModelServer of ServingConfig `kwargs` on the
    decode mesh of `mesh_axes` raises on this rank ("Type: message"), or
    None."""
    from polyaxon_tpu_torch.parallel.mesh import decode_mesh
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    try:
        server = ModelServer(_serving_lm(model_config, state), None, ServingConfig(**kwargs),
                             device="cpu", mesh=decode_mesh(mesh_axes))
    except Exception as e:  # noqa: BLE001 — handed back to the test
        return f"{type(e).__name__}: {e}"
    if server.is_follower:
        server.follow()
    else:
        server.stop()
    return None


def mesh_error(mesh_axes):
    """What `decode_mesh(mesh_axes)` raises on this world."""
    from polyaxon_tpu_torch.parallel.mesh import decode_mesh

    try:
        decode_mesh(mesh_axes)
    except ValueError as e:
        return f"ValueError: {e}"
    return None


def serve_follower_fails(model_config, state, body, out):
    """A {model: 2} server whose follower fails its first decode forward:
    rank 0 writes what its `generate` raised (and how long it took) to
    `out`; the follower's process ends with the error."""
    import json
    import time

    import torch.distributed as dist

    from polyaxon_tpu_torch.models.transformer import Transformer
    from polyaxon_tpu_torch.parallel.mesh import decode_mesh
    from polyaxon_tpu_torch.serving.batching import ServingConfig
    from polyaxon_tpu_torch.serving.server import ModelServer

    server = ModelServer(_serving_lm(model_config, state), None,
                         ServingConfig(batching=False), device="cpu",
                         mesh=decode_mesh({"model": 2}))
    if server.is_follower:
        def boom(*a, **k):
            raise RuntimeError(f"rank {dist.get_rank()}: injected forward failure")

        Transformer.forward = boom
        server.follow()
        return None
    t0 = time.monotonic()
    try:
        server.generate(body)
        error = None
    except Exception as e:  # noqa: BLE001
        error = f"{type(e).__name__}: {e}"
    with open(out, "w") as f:
        json.dump({"error": error, "seconds": time.monotonic() - t0,
                   "broken": server._world.broken is not None}, f)
    return error


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
