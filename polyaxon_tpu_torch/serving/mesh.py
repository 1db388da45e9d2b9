"""Serving on a decode mesh: tensor-parallel decode with rank 0 driving
its followers step by step, the counterpart of the reference's
`ModelServer(mesh=...)` over `parallel.mesh.decode_mesh`.

The reference is one controller over several devices: GSPMD inserts the
collectives. Here each rank of the `batch` x `model` mesh is a process
with its own device, and every rank holds its own shards:

- the seven projections split as Megatron splits them (q/k/v and gate/up
  by output rows, o and down by input columns; an int8 projection's
  per-row scales go with its rows, and o/down keep the full-K scales
  whole, so the partial products sum to the one-device product), the
  embedding's hidden dim and the LM head's vocabulary over `model`
  (`DECODE_SPLIT`); norms and everything else whole. A `batch` group (the
  `model` ranks of one `batch` index) holds a full set of shards;
- the KV caches and the paged pool hold this rank's kv heads
  (`n_kv_heads / model`). Every `batch` group keeps a whole pool: the
  write of a decode forward is exchanged over `batch`, so a page written
  for a row of one group is there for a later row of any group.

Rank 0 is the server: the HTTP front, the coalescer, the step scheduler,
the KV manager's page table and prefix cache, the generators and the
metrics live there only. `MeshModule` stands in for the module on rank 0:
each call (a cache, the pool, a decode forward, a pool-to-pool page copy,
the health probe, stop) is one command, broadcast over a `gloo` group of
its own with the step's host inputs (tokens, positions, page tables), then
run on rank 0's shards. The followers run `ServingWorld.follow`, which
executes the same commands in the same order on theirs, so every
collective inside a forward (the `model` all-reduces after o and down, the
embedding's and the logits' all-gathers, the `batch` exchanges) is issued
in one order on every rank. Nothing else on rank 0 issues a collective: a
`/readyz` probe is a command too. Rank 0 samples from whole logits and the
chosen tokens ride the next command.

A follower whose command fails prints the error and ends its process
(`follow` re-raises): the `gloo` peers of a closed process fail their
pending collective, and a gang launcher tears the rest down, so rank 0 is
never left waiting. The command channel waits without a deadline: an idle
server's followers block on it.
"""

from __future__ import annotations

import datetime
import re
import threading
import traceback
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import DECODE_AXES, axis_sizes
from ..parallel.ring import set_current_mesh

# name pattern -> the dim split over `model` on a decode mesh; the rest
# (norm scales, the o/down scales: full-K, LoRA factors used whole) stays
# whole on every rank
DECODE_SPLIT = (
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.(weight|scale)$", 0),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.lora_b$", 1),
    (r"(o_proj|down_proj)\.weight$", 1),
    (r"(o_proj|down_proj)\.lora_a$", 0),
    (r"embed\.weight$", 1),
    (r"lm_head\.weight$", 0),
)

# the command channel's deadline: an idle server waits on it
_IDLE = datetime.timedelta(days=365)


def split_dim(name: str) -> Optional[int]:
    """The dim of parameter or buffer `name` split over `model`, or None."""
    for pat, dim in DECODE_SPLIT:
        if re.search(pat, name):
            return dim
    return None


def shard_slice(t: torch.Tensor, dim: Optional[int], index: int, n: int) -> torch.Tensor:
    """Member `index` of `n`'s part of `t` along `dim` (all of it for None)."""
    if dim is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(
            f"a {tuple(t.shape)} tensor does not split {n} ways along dim {dim} "
            "on the decode mesh's model axis"
        )
    return t.narrow(dim, index * (t.shape[dim] // n), t.shape[dim] // n)


class ServingWorld:
    """This process's place on a decode mesh (`parallel.mesh.decode_mesh`)
    and the command channel between rank 0 and its followers. Every rank
    of the world constructs it, in the same order as the mesh."""

    def __init__(self, mesh, device):
        if tuple(mesh.mesh_dim_names or ()) != DECODE_AXES:
            raise ValueError(f"a serving world needs a decode mesh {DECODE_AXES}")
        self.mesh = mesh
        self.device = torch.device(device)
        self.sizes = axis_sizes(mesh)
        self.ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        self.rank = dist.get_rank()
        self.leader = self.rank == self.ranks[0]
        self.model_index = mesh.get_local_rank("model")
        # the commands ride a gloo group of their own (host objects, no
        # deadline while idle), whatever backend the tensors use
        self._channel = dist.new_group(self.ranks, backend="gloo", timeout=_IDLE)
        self.commands = 0  # commands sent (rank 0) or run (a follower)
        self.ops: dict = {}  # the same by op
        self.caches: dict = {}  # a follower's caches and pools by id
        self.logit_gathers = 0  # decode forwards that gathered the logits
        self.broken: Optional[BaseException] = None
        self.stopped = False
        self._lock = threading.RLock()
        self._next_cid = 0
        self._freed: list = []
        self._freed_lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.ranks)

    def shard(self, module) -> None:
        """Replace `module`'s parameters and buffers by this rank's shards
        (`DECODE_SPLIT`), in place, on the world's device. A module built
        on the `meta` device gets empty shards to restore into (and its
        rope tables made anew). A module split over `model` once is not
        split again (build a new one for another server)."""
        n, i = self.sizes["model"], self.model_index
        held = getattr(module, "mesh_world", None)
        if held is not None and held.sizes["model"] > 1:
            raise ValueError("this module holds a decode mesh's shards already")
        with torch.no_grad():
            for name, t in list(module.named_parameters()) + list(module.named_buffers()):
                owner, _, leaf = name.rpartition(".")
                mod = module.get_submodule(owner) if owner else module
                if name in ("rope_cos", "rope_sin") and t.is_meta:
                    from ..models.transformer import rope_table

                    cfg = module.cfg
                    cos, sin = rope_table(cfg.seq_len, cfg.head_dim, cfg.rope_theta)
                    new = torch.from_numpy(cos if leaf == "rope_cos" else sin)
                    mod.register_buffer(leaf, new.to(self.device), persistent=False)
                    continue
                part = shard_slice(t, split_dim(name), i, n)
                if part is t and t.device == self.device:
                    continue  # whole and in place already (a model axis of 1)
                if t.is_meta:
                    new = torch.empty(part.shape, dtype=t.dtype, device=self.device)
                else:
                    new = part.to(self.device).clone(memory_format=torch.contiguous_format)
                if isinstance(t, torch.nn.Parameter):
                    setattr(mod, leaf, torch.nn.Parameter(new, requires_grad=t.requires_grad))
                else:
                    mod._buffers[leaf] = new
                if leaf == "weight" and hasattr(mod, "in_features") and new.ndim == 2:
                    mod.out_features, mod.in_features = new.shape
        module.mesh_world = self

    # ----------------------------------------------------- the channel
    def _broadcast(self, obj):
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self._channel)
        return box[0]

    def send(self, op: str, **args) -> None:
        """Rank 0: one command to every follower (the caller holds the
        world's lock and runs the same command on its own shards next)."""
        if self.broken is not None:
            raise RuntimeError(f"the serving mesh is down: {self.broken!r}")
        if self.stopped:
            raise RuntimeError("the serving mesh has stopped")
        with self._freed_lock:
            freed, self._freed = self._freed, []
        try:
            self._broadcast((op, args, freed))
        except BaseException as e:
            self.broken = e
            raise
        self.commands += 1
        self.ops[op] = self.ops.get(op, 0) + 1

    def new_cid(self, obj) -> int:
        """An id for a cache or pool `obj` of rank 0's; the followers drop
        theirs with the command after `obj` is collected."""
        self._next_cid += 1
        cid = self._next_cid
        weakref.finalize(obj, self._release, cid)
        return cid

    def _release(self, cid: int) -> None:
        with self._freed_lock:
            self._freed.append(cid)

    def follow(self, module) -> int:
        """A follower's loop: run rank 0's commands on this rank's shards
        until it stops the world. Returns the commands run; an error ends
        the loop (and, raised on, the process)."""
        from ..models.generate import copy_pool_pages, make_paged_cache
        from ..runtime.health import check_slice

        if self.leader:
            raise RuntimeError("rank 0 drives the serving mesh; followers follow")
        set_current_mesh(self.mesh)
        caches = self.caches
        caches.clear()
        dev = self.device
        try:
            with torch.inference_mode():
                while True:
                    op, args, freed = self._broadcast(None)
                    for cid in freed:
                        caches.pop(cid, None)
                    self.commands += 1
                    self.ops[op] = self.ops.get(op, 0) + 1
                    if op == "stop":
                        self.stopped = True
                        return self.commands
                    if op == "cache":
                        caches[args["cid"]] = module.make_cache(args["batch"])
                    elif op == "pool":
                        caches[args["cid"]] = make_paged_cache(module, args["layout"])
                    elif op == "forward":
                        kw = {k: _to_device(v, dev) for k, v in args["kw"].items()}
                        module(_to_device(args["tokens"], dev), cache=caches[args["cid"]],
                               **kw)
                    elif op == "copy":
                        copy_pool_pages(caches[args["cid"]], **args["kw"])
                    elif op == "health":
                        check_slice(device=dev)
                    else:
                        raise ValueError(f"unknown serving-mesh command {op!r}")
        except BaseException as e:
            self.broken = e
            traceback.print_exc()
            raise

    def stop(self) -> None:
        """Rank 0: end the followers' loops (a no-op once stopped or down)."""
        with self._lock:
            if self.stopped or self.broken is not None or not self.leader:
                return
            self.send("stop")
            self.stopped = True


def _host(v):
    """A forward argument as the command carries it: tensors as numpy."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return v


def _to_device(v, device):
    if isinstance(v, np.ndarray) and v.dtype != object:
        return torch.from_numpy(v).to(device)
    return v


class MeshCache(list):
    """Rank 0's KV cache or pool on a serving mesh: its own shards (a list
    per layer, as `make_cache` / `make_paged_cache` give), and the id the
    followers know theirs by."""

    cid: int = 0


class MeshModule:
    """Rank 0's stand-in for its shard module (`ServingWorld.shard`): the
    calls the serving paths make (`make_cache`, the paged pool, the decode
    forward, the pool's page copy, the health probe) run on every rank of
    the mesh, in one order; any other attribute is the local module's."""

    def __init__(self, module, world: ServingWorld):
        self.module = module
        self.world = world

    def __getattr__(self, name):
        return getattr(self.__dict__["module"], name)

    def _create(self, op: str, make, **args) -> MeshCache:
        w = self.world
        with w._lock:
            set_current_mesh(w.mesh)
            cache = MeshCache()
            cache.cid = w.new_cid(cache)
            w.send(op, cid=cache.cid, **args)
            cache.extend(make())
            return cache

    def make_cache(self, batch: int) -> MeshCache:
        return self._create("cache", lambda: self.module.make_cache(batch), batch=int(batch))

    def make_paged_cache(self, layout) -> MeshCache:
        from ..models.generate import make_paged_cache

        return self._create("pool", lambda: make_paged_cache(self.module, layout),
                            layout=layout)

    def __call__(self, tokens, *, cache=None, **kw):
        if not isinstance(cache, MeshCache):
            raise ValueError(
                "on a serving mesh the module runs the KV-cache decode only, over "
                "caches and pools of MeshModule.make_cache / make_paged_cache"
            )
        w = self.world
        with w._lock:
            set_current_mesh(w.mesh)
            w.send("forward", cid=cache.cid, tokens=_host(tokens),
                   kw={k: _host(v) for k, v in kw.items()})
            try:
                return self.module(tokens, cache=list(cache), **kw)
            except BaseException as e:
                w.broken = e
                raise

    def copy_pages(self, cache: MeshCache, **kw) -> None:
        from ..models.generate import copy_pool_pages

        w = self.world
        kw = {k: _host(v) for k, v in kw.items()}
        with w._lock:
            w.send("copy", cid=cache.cid, kw=kw)
            copy_pool_pages(list(cache), **kw)

    def health(self) -> dict:
        """`runtime.health.check_slice` over the world, as one command."""
        from ..runtime.health import check_slice

        w = self.world
        with w._lock:
            w.send("health")
            return check_slice(device=w.device)


def shard_bytes(module) -> int:
    """Device bytes of a module's weights, its state_dict (this rank's
    shards on a mesh; the rope tables, made at load, are not counted)."""
    return int(sum(t.numel() * t.element_size() for t in module.state_dict().values()))
