"""Hot-swapped LoRA adapters for multi-tenant serving, an own copy of
`polyaxon_tpu/serving/adapters.py`.

One base model, many tenants, each with its own LoRA adapter. The model
(`adapter_slots > 0`, `models/lora.py`) stacks every `lora_a`/`lora_b` pair
to [slots, ...] and gathers a PER-ROW adapter by index, so one coalesced
decode group mixes tenants; this module owns the slots:

* `stack_adapter_params` — load-time surgery (after quantize-on-load):
  rebuild the module with `adapter_slots = N + 1`; SLOT 0 carries the
  checkpoint's own lora_a/lora_b (the adapter of every default-tenant and
  pad row) and slots 1..N start as zero adapters (lora_b = 0, delta = 0)
  for the registry to fill.
* `AdapterRegistry` — manages slots 1..N like KV pages: refcounted
  residency (a slot is pinned while any in-flight row gathers it), LRU
  eviction of idle adapters when a request needs a slot, demotion of the
  evicted weights through a `SpillManager` keyed `adapter:<name>`, and
  restore of the exact bytes on the next acquire. Counters
  `serving.adapter_loads`, `serving.adapter_evictions`,
  `serving.adapter_restores` and the `serving.adapter_resident` gauge.

Adapter sources are an `.npz` file (keys = the reference's slash-joined
param paths, e.g. ``layer_0/attention/q_proj/lora_a``; `save_adapter`
writes the format) or the deterministic synthesizer ``seed:<int>``, which
draws the reference's numbers with numpy: same seed, same bytes in both
packages.

The device copy of an adapter IS its slot of the stacked parameters; the
registry never holds a second one. It reads and writes slots through two
callbacks (`read_slot`/`write_slot`) so the owning ModelServer keeps the
write under its own lock, on the stream that runs the step; lock order is
registry lock → server lock, never the reverse. No wall clocks here.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from ..chaos.injector import inject
from .batching import ShedError
from .spill import DTYPES, SpillManager, SpillPayload, dtype_name

__all__ = [
    "AdapterRegistry",
    "adapter_template",
    "load_adapter",
    "ref_path",
    "save_adapter",
    "stack_adapter_params",
    "synth_adapter",
]


def ref_path(name: str) -> str:
    """A port parameter name → its slash-joined path in the reference's
    tree: 'layers.3.mlp.up_proj.lora_a' → 'layer_3/mlp/up_proj/lora_a', and
    a scanned stack's 'scan.block.mlp.up_proj.lora_a' → 'layers/block/...'
    (the reference's nn.scan tree)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}", *parts[2:]]
    elif parts[:2] == ["scan", "block"]:
        parts = ["layers", *parts[1:]]
    return "/".join(parts)


def _lora_params(module) -> dict:
    return {
        ref_path(name): p for name, p in module.named_parameters()
        if name.rpartition(".")[2] in ("lora_a", "lora_b")
    }


@torch.no_grad()
def stack_adapter_params(module, *, slots: int):
    """A new module of the same type with `adapter_slots = slots`, on the
    same device and dtype: every ``lora_a`` broadcast to all slots (A is
    inert wherever B is zero) and every ``lora_b`` keeping the module's
    value at slot 0 with zeros in slots 1.. (the zero adapters the registry
    hot-swaps). The slot axis lands at ndim-3 of the new tensor: [slots,
    in, r] per layer, [n_layers, slots, in, r] in a scanned stack (the
    reference's layout), so every slot read and write selects dim -3.
    `module` itself is left as it is."""
    cfg = getattr(module, "cfg", None)
    if cfg is None or getattr(cfg, "lora_rank", 0) <= 0:
        raise ValueError(
            "adapter multiplexing needs a LoRA model (lora_rank > 0): "
            "there are no adapter params to stack"
        )
    if getattr(cfg, "adapter_slots", 0) > 0:
        raise ValueError(
            f"params are already slot-stacked (adapter_slots = {cfg.adapter_slots}) "
            "— stack-on-load runs once"
        )
    if slots < 2:
        raise ValueError("adapter stacking needs slots >= 2 (slot 0 is the base adapter)")
    state = {}
    for name, value in module.state_dict().items():
        leaf = name.rpartition(".")[2]
        if leaf == "lora_a":
            value = value.unsqueeze(-3).expand(*value.shape[:-2], slots, *value.shape[-2:])
        elif leaf == "lora_b":
            zeros = value.new_zeros(*value.shape[:-2], slots - 1, *value.shape[-2:])
            value = torch.cat([value.unsqueeze(-3), zeros], dim=-3)
        state[name] = value
    new = type(module)(
        dataclasses.replace(cfg, adapter_slots=slots), device=module.device, dtype=module.dtype
    )
    new.load_state_dict(state)
    return new.train(module.training)


def adapter_template(module) -> dict:
    """Slash-joined path → (shape, dtype name) of every slot-stacked adapter
    leaf, with the slot axis removed: the shapes ONE adapter's tensors
    must have. Paths are sorted, and every demote and restore walks them
    in this order, so spilled payloads round-trip positionally."""
    out = {
        path: (tuple(p.shape[:-3] + p.shape[-2:]), dtype_name(p))
        for path, p in _lora_params(module).items()
        if p.dim() == (4 if path.startswith("layers/block/") else 3)
    }
    if not out:
        raise ValueError("no slot-stacked lora_a/lora_b parameters in the module")
    return dict(sorted(out.items()))


def synth_adapter(template: dict, seed: int) -> dict:
    """Deterministic synthetic adapter: the reference's draws (numpy, a
    stream keyed by crc32 of the path) cast to the template's dtype, so
    the same (seed, path) gives the same bytes in both packages. lora_b is
    non-zero, so the adapter visibly changes outputs."""
    out = {}
    for path, (shape, dtype) in template.items():
        rng = np.random.default_rng([int(seed), zlib.crc32(path.encode())])
        out[path] = torch.from_numpy(rng.normal(0.0, 0.05, shape)).to(DTYPES[dtype])
    return out


def save_adapter(path, adapter: dict) -> None:
    """Write an adapter (slash-joined paths → tensors or arrays) as .npz —
    the format `load_adapter` reads. bf16 tensors are stored as the
    2-byte records numpy writes for the reference's bf16 arrays."""
    arrays = {}
    for k, v in adapter.items():
        if torch.is_tensor(v):
            v = v.detach().cpu()
            v = (v.view(torch.int16).numpy().view("V2") if v.dtype == torch.bfloat16
                 else v.numpy())
        arrays[k] = np.asarray(v)
    np.savez(path, **arrays)


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or dtype != "bfloat16":
            raise ValueError(f"cannot read {arr.dtype} records as {dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(DTYPES[dtype])


def load_adapter(source: str, template: dict) -> dict:
    """An adapter from its source: ``seed:<int>`` synthesizes
    deterministically, anything else loads as .npz. Shapes are checked
    against the template: a wrong-shape adapter fails the load, never a
    slot."""
    if source.startswith("seed:"):
        return synth_adapter(template, int(source[len("seed:"):]))
    with np.load(source) as z:
        found = {k: np.asarray(z[k]) for k in z.files}
    out = {}
    for path, (shape, dtype) in template.items():
        if path not in found:
            raise ValueError(f"adapter {source!r} is missing leaf {path!r}")
        arr = found[path]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(
                f"adapter {source!r} leaf {path!r} has shape {tuple(arr.shape)}, "
                f"model expects {tuple(shape)}"
            )
        out[path] = _as_tensor(arr, dtype)
    return out


@dataclasses.dataclass
class _Entry:
    name: str
    source: str
    slot: Optional[int] = None
    refs: int = 0
    seq: int = 0  # logical recency (LRU order among idle residents)
    loads: int = 0


class AdapterRegistry:
    """Refcounted residency manager for adapter slots 1..n_slots.

    `acquire(name)` pins the adapter's slot for one in-flight row and
    returns the slot index; `release(name)` unpins it (the serving layer
    chains release onto the request's idempotent finish, so a slot is
    never freed while a batch still gathers it). A miss loads the adapter
    into a free slot — evicting the least-recently-used IDLE adapter when
    full, demoting its weights to the spill tiers — and a spilled adapter
    restores its exact bytes on the next acquire. With every slot pinned,
    acquire sheds (`reason: adapter_capacity`) instead of blocking.

    Thread-safe; clock-free (a logical sequence number for recency)."""

    def __init__(
        self,
        *,
        slots: int,
        sources: dict,
        template: dict,
        read_slot: Callable[[int], list],
        write_slot: Callable[[int, dict], None],
        spill: Optional[SpillManager] = None,
        telemetry=None,
    ):
        if slots < 1:
            raise ValueError("AdapterRegistry needs at least 1 adapter slot")
        self.n_slots = int(slots)
        self.template = dict(template)
        self._paths = sorted(self.template)
        self._read_slot = read_slot
        self._write_slot = write_slot
        self._spill = spill
        self._lock = threading.RLock()
        self._seq = 0
        self._entries: dict[str, _Entry] = {
            str(name): _Entry(str(name), str(src)) for name, src in dict(sources).items()
        }
        self._by_slot: dict[int, str] = {}
        # cumulative counters (also exported through `telemetry`)
        self.loads = 0
        self.evictions = 0
        self.restores = 0
        self._m_loads = self._m_evict = self._m_restore = self._g_resident = None
        if telemetry is not None:
            self._m_loads = telemetry.counter(
                "serving.adapter_loads", help="Adapter weight loads from source into a slot"
            )
            self._m_evict = telemetry.counter(
                "serving.adapter_evictions", help="Idle adapters evicted from their slot (LRU)"
            )
            self._m_restore = telemetry.counter(
                "serving.adapter_restores", help="Adapter loads served from the spill tiers"
            )
            self._g_resident = telemetry.gauge(
                "serving.adapter_resident", help="Adapters currently resident in a slot"
            )
            self._g_resident.set(0.0)

    # -------------------------------------------------------------- views
    def known(self) -> list:
        return sorted(self._entries)

    def resident(self) -> dict:
        with self._lock:
            return {e.name: e.slot for e in self._entries.values() if e.slot is not None}

    def refcount(self, name: str) -> int:
        with self._lock:
            return self._entries[name].refs

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": self.n_slots,
                "resident": sum(1 for e in self._entries.values() if e.slot is not None),
                "loads": self.loads,
                "evictions": self.evictions,
                "restores": self.restores,
                "adapters": {
                    e.name: {
                        "slot": e.slot,
                        "refs": e.refs,
                        "source": e.source,
                        "state": (
                            "resident" if e.slot is not None
                            else "spilled" if self._spilled(e.name)
                            else "cold"
                        ),
                    }
                    for e in sorted(self._entries.values(), key=lambda e: e.name)
                },
            }

    def check_invariants(self) -> None:
        """Every slot maps to at most one adapter and the maps agree."""
        with self._lock:
            for slot, name in self._by_slot.items():
                e = self._entries[name]
                assert e.slot == slot, (name, slot, e.slot)
            slots = [e.slot for e in self._entries.values() if e.slot is not None]
            assert len(slots) == len(set(slots)), slots
            assert all(1 <= s <= self.n_slots for s in slots), slots

    def _spilled(self, name: str) -> bool:
        return self._spill is not None and self._spill.has(f"adapter:{name}", ())

    # ------------------------------------------------------------ acquire
    def acquire(self, name: str) -> tuple:
        """Pin `name`'s adapter and return (slot, loaded) — `loaded` True
        when this call brought the weights into the slot (the serving layer
        times exactly those acquires). Raises KeyError for an unknown
        adapter and ShedError (`adapter_capacity`) when every slot is
        pinned by in-flight rows."""
        with self._lock:
            e = self._entries[name]  # KeyError → serving 400 upstream
            self._seq += 1
            e.seq = self._seq
            if e.slot is not None:
                e.refs += 1
                return e.slot, False
            slot = self._free_slot()
            if slot is None:
                raise ShedError(
                    f"all {self.n_slots} adapter slots are pinned by in-flight requests",
                    reason="adapter_capacity",
                    retry_after_s=0.5,
                )
            self._load_into(e, slot)
            e.slot = slot
            e.refs = 1
            self._by_slot[slot] = name
            if self._g_resident is not None:
                self._g_resident.set(float(len(self._by_slot)))
            return slot, True

    def release(self, name: str) -> None:
        with self._lock:
            e = self._entries.get(name)
            if e is not None and e.refs > 0:
                e.refs -= 1

    # ------------------------------------------------------------ internal
    def _free_slot(self) -> Optional[int]:
        for s in range(1, self.n_slots + 1):
            if s not in self._by_slot:
                return s
        # no free slot: evict the least-recently-used IDLE resident
        idle = [e for e in self._entries.values() if e.slot is not None and e.refs == 0]
        if not idle:
            return None
        return self._evict(min(idle, key=lambda e: e.seq))

    def _evict(self, victim: _Entry) -> int:
        slot = victim.slot
        assert slot is not None
        if self._spill is not None:
            tensors = [t.contiguous() for t in self._read_slot(slot)]
            self._spill.put(SpillPayload(
                tokens=(), hashes=(f"adapter:{victim.name}",), pages=[tensors]
            ))
        victim.slot = None
        del self._by_slot[slot]
        self.evictions += 1
        if self._m_evict is not None:
            self._m_evict.inc()
        if self._g_resident is not None:
            self._g_resident.set(float(len(self._by_slot)))
        return slot

    def _load_into(self, e: _Entry, slot: int) -> None:
        """Bring `e`'s weights into `slot`: spill restore when available,
        source load otherwise. A failure mid-way (including an injected
        chaos kill) leaves the registry consistent — the slot stays free,
        the payload returns to the spill tier and no refcount moved — so a
        crashed restore costs a retry, never a leak."""
        payload = None
        if self._spill is not None:
            payload = self._spill.take(f"adapter:{e.name}", ())
        try:
            # chaos: a kill here lands between take and the slot write; the
            # except arm re-spills the payload
            inject("serving.adapter_restore", name=e.name, slot=slot,
                   restored=payload is not None)
            if payload is not None:
                tensors = payload.pages[0]
                self._write_slot(slot, {p: tensors[i] for i, p in enumerate(self._paths)})
                self.restores += 1
                if self._m_restore is not None:
                    self._m_restore.inc()
            else:
                self._write_slot(slot, load_adapter(e.source, self.template))
            self.loads += 1
            e.loads += 1
            if self._m_loads is not None:
                self._m_loads.inc()
        except BaseException:
            if payload is not None and self._spill is not None:
                self._spill.put(payload)
            raise
