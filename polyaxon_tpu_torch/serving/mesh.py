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
the KV manager's page table and prefix cache, the generators, the n-gram
drafters, the adaptive-K controller, tenant admission, the adapter
registry, the spill tiers, the handoff leases and the metrics live there
only. `MeshModule` stands in for the module on rank 0 (and a second one
for a draft model, its ops named `draft_*`): each device operation is one
command, broadcast over a `gloo` group of its own with its host inputs,
then run on rank 0's shards:

- `cache`, `pool`: a dense cache or the paged pool (ids of their own);
- `forward`: a decode forward (tokens, positions, page tables; the
  logits of the last position, or of every position of a verify window);
- `copy`: a pool-to-pool page copy (the prefix harvest);
- `reorder`: a dense cache's rows by beam parent (and their tiling);
- `pages_read`, `pages_write`: whole pool pages, every kv head gathered
  over `model` (the spill mirror, a handoff export), and their write back,
  each rank its kv heads (a spill restore, a handoff adoption);
- `slot_read`, `slot_write`: one adapter slot of the stacked LoRA
  factors, gathered over `model` or written as each rank's slice;
- `health`, `stop`.

The followers run `ServingWorld.follow`, which executes the same commands
in the same order on theirs, so every collective inside a command (the
`model` all-reduces after o and down, the embedding's and the logits'
all-gathers, the `batch` exchanges, the gathers of whole pages and slots)
is issued in one order on every rank. Nothing else on rank 0 issues a
collective: a `/readyz` probe is a command too. Rank 0 samples from whole logits and the
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

from ..models.moe import MOE_SPLIT
from ..models.transformer import SCAN_BLOCK
from ..parallel.collectives import all_gather_cat
from ..parallel.mesh import DECODE_AXES, axis_sizes
from ..parallel.ring import set_current_mesh

# name pattern -> the dim split over `model` on a decode mesh; the rest
# (norm scales, the o/down scales: full-K, LoRA factors used whole, the MoE
# router) stays whole on every rank. Each expert's hidden units split as in
# training (`MOE_SPLIT["model"]`); the experts stay whole over `batch`.
# The LoRA factors count their dim from the end: one
# adapter's lora_b [r, out] and lora_a [in, r] split where the stacked
# slots' [slots, r, out] and [slots, in, r] do (the reference's rules,
# shifted right as its SCAN_RULES shift them)
DECODE_SPLIT = (
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.(weight|scale)$", 0),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.lora_b$", -1),
    (r"(o_proj|down_proj)\.weight$", 1),
    (r"(o_proj|down_proj)\.lora_a$", -2),
    (r"embed\.weight$", 1),
    (r"lm_head\.weight$", 0),
    *MOE_SPLIT["model"],
)

# the command channel's deadline: an idle server waits on it
_IDLE = datetime.timedelta(days=365)


def split_dim(name: str) -> Optional[int]:
    """The dim of parameter or buffer `name` split over `model`, or None.
    A scanned block's tensors (`scan.block.*`, [n_layers, ...]) split one
    dim on."""
    for pat, dim in DECODE_SPLIT:
        if re.search(pat, name):
            return dim + 1 if dim >= 0 and name.startswith(SCAN_BLOCK) else dim
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

    def shard(self, module, share: Optional[dict] = None) -> None:
        """Replace `module`'s parameters and buffers by this rank's shards
        (`DECODE_SPLIT`), in place, on the world's device. A module built
        on the `meta` device gets empty shards to restore into (and its
        rope tables made anew). A module split over `model` once is not
        split again (build a new one for another server). `share`: name →
        a shard already made (a draft's layers truncated from the target),
        taken as it is instead of a copy."""
        n, i = self.sizes["model"], self.model_index
        share = share or {}
        held = getattr(module, "mesh_world", None)
        if held is not None and held.sizes["model"] > 1:
            raise ValueError("this module holds a decode mesh's shards already")
        cfg = module.cfg
        for what, count in (("heads", cfg.n_heads), ("kv heads", cfg.n_kv_heads)):
            if count % n:  # a rank holds whole heads: its caches are per head
                raise ValueError(
                    f"{count} {what} do not split {n} ways over the decode mesh's model axis"
                )
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
                mine = share.get(name)
                if mine is not None and name.startswith(SCAN_BLOCK):
                    mine = mine[:part.shape[0]]  # a truncated draft's first layers
                if mine is not None and mine.shape == part.shape:
                    new = mine
                elif part is t and t.device == self.device:
                    continue  # whole and in place already (a model axis of 1)
                elif t.is_meta:
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

    def follow(self, module, draft=None) -> int:
        """A follower's loop: run rank 0's commands on this rank's shards
        (`draft`: the draft model's, for the `draft_*` ops) until it stops
        the world. Returns the commands run; an error ends the loop (and,
        raised on, the process)."""
        from ..models.generate import copy_pool_pages, make_paged_cache, reorder_rows
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
                    mod = draft if op.startswith("draft_") else module
                    base = op.removeprefix("draft_")
                    if base == "cache":
                        caches[args["cid"]] = mod.make_cache(args["batch"])
                    elif op == "pool":
                        caches[args["cid"]] = make_paged_cache(mod, args["layout"])
                    elif base == "forward":
                        kw = {k: _to_device(v, dev) for k, v in args["kw"].items()}
                        mod(_to_device(args["tokens"], dev), cache=caches[args["cid"]], **kw)
                    elif op == "copy":
                        copy_pool_pages(caches[args["cid"]], **args["kw"])
                    elif op == "reorder":
                        reorder_rows(caches[args["cid"]], args["flat"])
                    elif op == "pages_read":
                        read_pages(caches[args["cid"]], args["ids"], self)
                    elif op == "pages_write":
                        write_pages(caches[args["cid"]], args["ids"], args["values"], self)
                    elif op == "slot_read":
                        read_slot(mod, args["slot"], args["paths"], self)
                    elif op == "slot_write":
                        write_slot(mod, args["slot"], args["adapter"], self)
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


def _model_group(world: ServingWorld):
    return world.mesh.get_group("model") if world.sizes["model"] > 1 else None


def read_pages(cache, ids, world: ServingWorld) -> list:
    """Whole pages `ids` of the pool `cache` on every rank: per layer, per
    leaf (k, v and an int8 pool's scales), this rank's kv heads gathered
    over `model` in rank order, so every kv head of a page is there, as
    one device's pool holds it. Every rank of the world runs it."""
    dev = cache[0][0].device
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
    group = _model_group(world)
    return [[all_gather_cat(leaf.index_select(0, ids), group, 2) for leaf in layer]
            for layer in cache]


def write_pages(cache, ids, values: dict, world: ServingWorld) -> None:
    """Write whole pages into the pool `cache` on every rank: `values`
    maps (layer, leaf) to the pages' host values [n, page_tokens, n_kv
    (, head_dim)] with every kv head, and each rank writes its own."""
    dev = cache[0][0].device
    dst = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
    n, i = world.sizes["model"], world.model_index
    for (layer, leaf), v in values.items():
        cache[layer][leaf][dst] = shard_slice(torch.as_tensor(v), 2, i, n).to(dev)


def _slot_leaves(module) -> dict:
    from .adapters import ref_path

    return {ref_path(name): (name, p) for name, p in module.named_parameters()
            if name.rpartition(".")[2] in ("lora_a", "lora_b")}


def read_slot(module, slot: int, paths, world: ServingWorld) -> list:
    """The adapter in stacked slot `slot`, leaf by leaf in `paths` order,
    whole: each rank's slice gathered over `model` along its split dim.
    Every rank of the world runs it."""
    leaves, group = _slot_leaves(module), _model_group(world)
    out = []
    for path in paths:
        name, p = leaves[path]
        dim = split_dim(name)
        part = p.select(-3, slot).detach()
        out.append(part if dim is None or group is None else all_gather_cat(part, group, dim))
    return out


def write_slot(module, slot: int, adapter: dict, world: ServingWorld) -> None:
    """Install one whole adapter (slash-joined path → tensor) into stacked
    slot `slot`: each rank copies its slice of each factor."""
    leaves = _slot_leaves(module)
    n, i = world.sizes["model"], world.model_index
    for path, value in adapter.items():
        name, p = leaves[path]
        part = shard_slice(torch.as_tensor(value), split_dim(name), i, n)
        p.select(-3, slot).copy_(part.to(p.device, p.dtype))


class MeshModule:
    """Rank 0's stand-in for its shard module (`ServingWorld.shard`): the
    calls the serving paths make (`make_cache`, the paged pool, the decode
    forward, the pool's page copy, a cache's reorder, whole pages and
    adapter slots read and written, the health probe) run on every rank of
    the mesh, in one order; any other attribute is the local module's. A
    draft model's stand-in names its ops `draft_<op>`."""

    def __init__(self, module, world: ServingWorld, prefix: str = ""):
        self.module = module
        self.world = world
        self.prefix = prefix

    def __getattr__(self, name):
        return getattr(self.__dict__["module"], name)

    def _run(self, op: str, local, **args):
        """One command: sent to the followers, then run here; a failure
        here marks the world broken (the followers may be mid-collective)."""
        w = self.world
        with w._lock:
            set_current_mesh(w.mesh)
            w.send(self.prefix + op, **args)
            try:
                return local()
            except BaseException as e:
                w.broken = e
                raise

    def _create(self, op: str, make, **args) -> MeshCache:
        w = self.world
        with w._lock:
            cache = MeshCache()
            cache.cid = w.new_cid(cache)
            cache.extend(self._run(op, make, cid=cache.cid, **args))
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
        return self._run("forward", lambda: self.module(tokens, cache=list(cache), **kw),
                         cid=cache.cid, tokens=_host(tokens),
                         kw={k: _host(v) for k, v in kw.items()})

    def copy_pages(self, cache: MeshCache, **kw) -> None:
        from ..models.generate import copy_pool_pages

        kw = {k: _host(v) for k, v in kw.items()}
        self._run("copy", lambda: copy_pool_pages(list(cache), **kw), cid=cache.cid, kw=kw)

    def reorder_rows(self, cache: MeshCache, flat) -> None:
        """`models.generate.reorder_rows` of a dense cache on every rank."""
        from ..models.generate import reorder_rows

        flat = np.asarray(_host(flat), np.int64)
        self._run("reorder", lambda: reorder_rows(cache, flat), cid=cache.cid, flat=flat)

    def read_pages(self, cache: MeshCache, ids) -> list:
        """Whole pool pages (`read_pages`) on rank 0's device."""
        ids = np.asarray(_host(ids), np.int64)
        return self._run("pages_read", lambda: read_pages(list(cache), ids, self.world),
                         cid=cache.cid, ids=ids)

    def write_pages(self, cache: MeshCache, ids, values: dict) -> None:
        """Whole pool pages written on every rank (`write_pages`)."""
        ids = np.asarray(_host(ids), np.int64)
        values = {k: torch.as_tensor(v).cpu() for k, v in values.items()}
        self._run("pages_write", lambda: write_pages(list(cache), ids, values, self.world),
                  cid=cache.cid, ids=ids, values=values)

    def read_slot(self, slot: int, paths) -> list:
        """One adapter slot, whole (`read_slot`)."""
        paths = list(paths)
        return self._run("slot_read", lambda: read_slot(self.module, slot, paths, self.world),
                         slot=int(slot), paths=paths)

    def write_slot(self, slot: int, adapter: dict) -> None:
        """One adapter into a slot on every rank (`write_slot`)."""
        adapter = {k: torch.as_tensor(v).cpu() for k, v in adapter.items()}
        self._run("slot_write", lambda: write_slot(self.module, slot, adapter, self.world),
                  slot=int(slot), adapter=adapter)

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
