"""Tiered spill: host-RAM and disk tiers for evicted KV prefixes and
adapters, an own copy of `polyaxon_tpu/serving/spill.py`.

When the PrefixCache evicts a cold entry, `serving/kv.py` hands its page
bytes (from the host mirror) here instead of letting them vanish: entries
land in a host-RAM tier (an LRU dict bounded by `ram_bytes`) and overflow
demotes to CRC-framed, length-prefixed segment files on disk (bounded by
`dir_bytes`). A later prefix hit on a spilled entry restores the pages
into the device pool instead of re-prefilling. The adapter registry
(`serving/adapters.py`) demotes evicted adapters through a manager of its
own, keyed `adapter:<name>`.

Disk format (the reference's, byte for byte): one segment file per entry
(`NNNNNN.seg`), frame 0 a JSON meta record (tokens, chain hashes, per-leaf
dtype and shape), then one frame per (page, leaf) payload in page-major
order (`store/framing.py`). A leaf's dtype is written by its numpy name
("bfloat16", "float32", "int8") and its bytes through an integer view of
the tensor, so a bf16 page — which has no numpy dtype here — reads back
bit for bit, and a segment written by either package reads in the other.
int8 pools spill their payloads and scales verbatim. Recovery (`_heal`,
at startup over an existing spill dir) truncates torn tails, deletes
incomplete segments and quarantines corrupt ones to `<seg>.corrupt`, so a
crash mid-spill loses only that entry and bit rot reads as a clean miss.

Payload leaves are CPU tensors. Not thread-safe by itself: the owner
serializes access under its lock. No wall clocks (recency is a logical
sequence number).
"""

from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..chaos.injector import inject
from ..store.framing import frame, scan_frames

# numpy names of the leaf dtypes a segment may carry
DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def dtype_name(t: torch.Tensor) -> str:
    return _NAMES[t.dtype]


def leaf_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's raw bytes (row-major), through a uint8 view."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def leaf_from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    raw = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    return raw.view(DTYPES[dtype]).reshape(tuple(shape))


@dataclasses.dataclass
class SpillPayload:
    """One spilled entry: verified token content, its chain hashes (one per
    page) and the raw page bytes — `pages[i][l]` is the host copy (a CPU
    tensor) of page i's slice of leaf l."""

    tokens: tuple
    hashes: tuple
    pages: list  # list[list[torch.Tensor]], page-major
    nbytes: int = 0
    # the prefix chain the hashes belong to (an adapter's, or "" for the
    # base model's); only the KV handoff's wire carries it
    namespace: str = ""

    def __post_init__(self):
        if not self.nbytes:
            self.nbytes = sum(t.numel() * t.element_size() for page in self.pages for t in page)


@dataclasses.dataclass
class _DiskRec:
    path: Path
    tokens: tuple
    nbytes: int
    seq: int


class SpillManager:
    """Two-tier LRU spill store keyed by prefix chain-head hash.

    put() at evict time, has()/take() at restore time, heads() for the
    /kvz advertisement. Byte budgets are payload bytes (frame headers and
    the JSON meta are noise next to KV pages)."""

    def __init__(self, *, ram_bytes: int = 0, dir_path: Optional[str] = None,
                 dir_bytes: Optional[int] = None):
        self.ram_budget = max(0, int(ram_bytes or 0))
        self.dir = Path(dir_path) if dir_path else None
        self.dir_budget = max(0, int(dir_bytes or 0)) if dir_bytes else None
        self._ram: "OrderedDict[str, SpillPayload]" = OrderedDict()
        self._ram_bytes = 0
        self._disk: dict[str, _DiskRec] = {}
        self._disk_bytes = 0
        self._seq = 0
        # cumulative counters (the serving layer reads them via stats())
        self.spilled_bytes = 0  # bytes accepted into ANY tier
        self.spills = 0
        self.restored_ram = 0
        self.restored_disk = 0
        self.quarantined = 0
        self.dropped = 0  # budget overflow / no-tier losses
        self.incomplete = 0  # torn/partial segments discarded at heal
        self.duplicates = 0
        self.write_errors = 0
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)
            self._heal()

    # ------------------------------------------------------------- views
    @property
    def ram_entries(self) -> int:
        return len(self._ram)

    @property
    def disk_entries(self) -> int:
        return len(self._disk)

    @property
    def ram_bytes(self) -> int:
        return self._ram_bytes

    @property
    def disk_bytes(self) -> int:
        return self._disk_bytes

    def heads(self) -> list[str]:
        """Chain-head hashes restorable from either tier."""
        return list(self._ram.keys()) + list(self._disk.keys())

    def has(self, h: str, tokens) -> bool:
        """True iff `h` is spilled AND its verified content equals `tokens`
        (forced collisions read as misses, like PrefixCache)."""
        toks = tuple(int(t) for t in tokens)
        e = self._ram.get(h)
        if e is not None:
            return e.tokens == toks
        rec = self._disk.get(h)
        return rec is not None and rec.tokens == toks

    def stats(self) -> dict:
        return {
            "ram_entries": len(self._ram),
            "ram_bytes": self._ram_bytes,
            "disk_entries": len(self._disk),
            "disk_bytes": self._disk_bytes,
            "spills": self.spills,
            "spilled_bytes": self.spilled_bytes,
            "restored_ram": self.restored_ram,
            "restored_disk": self.restored_disk,
            "quarantined": self.quarantined,
            "dropped": self.dropped,
            "incomplete": self.incomplete,
            "duplicates": self.duplicates,
        }

    # -------------------------------------------------------------- put
    def put(self, payload: SpillPayload) -> bool:
        """Accept an evicted entry. Returns True when it landed in a tier
        (False: duplicate head, or no tier configured/fits)."""
        h = payload.hashes[-1]
        if h in self._ram or h in self._disk:
            self.duplicates += 1
            return False
        if self.ram_budget > 0:
            self._ram[h] = payload
            self._ram_bytes += payload.nbytes
            self.spills += 1
            self.spilled_bytes += payload.nbytes
            self._shrink_ram()
            return True
        if self.dir is not None:
            if self._write_segment(h, payload):
                self.spills += 1
                self.spilled_bytes += payload.nbytes
                self._shrink_disk()
                return True
            return False
        self.dropped += 1
        return False

    def _shrink_ram(self) -> None:
        while self._ram_bytes > self.ram_budget and self._ram:
            h, payload = self._ram.popitem(last=False)
            self._ram_bytes -= payload.nbytes
            if self.dir is not None and self._write_segment(h, payload):
                self._shrink_disk()
            else:
                self.dropped += 1

    def _shrink_disk(self) -> None:
        if self.dir_budget is None:
            return
        while self._disk_bytes > self.dir_budget and self._disk:
            h = min(self._disk, key=lambda k: self._disk[k].seq)
            rec = self._disk.pop(h)
            self._disk_bytes -= rec.nbytes
            rec.path.unlink(missing_ok=True)
            self.dropped += 1

    # ------------------------------------------------------------- take
    def take(self, h: str, tokens) -> Optional[SpillPayload]:
        """Remove and return the spilled entry for `h` (verified against
        `tokens`), or None. A corrupt disk segment is quarantined and reads
        as None — the caller falls through to a normal miss."""
        toks = tuple(int(t) for t in tokens)
        e = self._ram.get(h)
        if e is not None:
            if e.tokens != toks:
                return None
            del self._ram[h]
            self._ram_bytes -= e.nbytes
            self.restored_ram += 1
            return e
        rec = self._disk.get(h)
        if rec is None or rec.tokens != toks:
            return None
        payload = self._read_segment(rec)
        del self._disk[h]
        self._disk_bytes -= rec.nbytes
        if payload is not None:
            rec.path.unlink(missing_ok=True)
            self.restored_disk += 1
        return payload

    # ------------------------------------------------------------- disk
    def _write_segment(self, h: str, payload: SpillPayload) -> bool:
        assert self.dir is not None
        path = self.dir / f"{self._seq:06d}.seg"
        self._seq += 1
        meta = {
            "h": h,
            "tokens": [int(t) for t in payload.tokens],
            "hashes": list(payload.hashes),
            "pages": len(payload.pages),
            "leaves": [
                {"dtype": dtype_name(t), "shape": list(t.shape)} for t in payload.pages[0]
            ],
        }
        try:
            with open(path, "wb") as f:
                f.write(frame(json.dumps(meta).encode()))
                f.flush()
                # chaos: a kill here leaves a meta-only segment — deleted as
                # incomplete at heal (ignorable, never a torn restore)
                inject("kv.spill", h=h, path=str(path), phase="meta")
                for page in payload.pages:
                    for t in page:
                        f.write(frame(leaf_bytes(t)))
                f.flush()
                # chaos: a kill here leaves a COMPLETE segment (restorable);
                # scramble_tail appends garbage the heal truncates away
                inject("kv.spill", h=h, path=str(path), phase="frames")
        except OSError:
            self.write_errors += 1
            self.dropped += 1
            path.unlink(missing_ok=True)
            return False
        self._disk[h] = _DiskRec(path, payload.tokens, payload.nbytes, self._seq - 1)
        self._disk_bytes += payload.nbytes
        return True

    def _quarantine(self, path: Path) -> None:
        path.rename(path.with_name(path.name + ".corrupt"))
        self.quarantined += 1

    def _read_segment(self, rec: _DiskRec) -> Optional[SpillPayload]:
        try:
            data = rec.path.read_bytes()
        except OSError:
            self.incomplete += 1
            return None
        payloads, verdict, _good_end = scan_frames(data)
        parsed = self._parse_segment(payloads) if verdict != "corrupt" else None
        if parsed is None:
            if verdict == "corrupt":
                self._quarantine(rec.path)
            else:
                self.incomplete += 1
                rec.path.unlink(missing_ok=True)
            return None
        return parsed[1]

    @staticmethod
    def _parse_segment(payloads: list) -> Optional[tuple]:
        """(head_hash, SpillPayload) from healed frames, or None when the
        frame set is incomplete or malformed."""
        if not payloads:
            return None
        try:
            meta = json.loads(payloads[0])
            n_pages = int(meta["pages"])
            leaves = meta["leaves"]
            hashes = tuple(meta["hashes"])
            tokens = tuple(int(t) for t in meta["tokens"])
            head = str(meta["h"])
            # the KV handoff's wire names an adapter's chain; spill segments
            # and the reference's bytes carry none
            namespace = meta.get("namespace") or ""
            if any(spec["dtype"] not in DTYPES for spec in leaves):
                return None
            if not isinstance(namespace, str):
                return None
        except (ValueError, KeyError, TypeError):
            return None
        if n_pages < 1 or not leaves or len(hashes) != n_pages:
            return None
        if len(payloads) != 1 + n_pages * len(leaves):
            return None
        pages = []
        off = 1
        try:
            for _ in range(n_pages):
                page = []
                for spec in leaves:
                    page.append(leaf_from_bytes(payloads[off], spec["dtype"], spec["shape"]))
                    off += 1
                pages.append(page)
        except RuntimeError:  # a payload whose size does not fit its shape
            return None
        return head, SpillPayload(tokens, hashes, pages, namespace=namespace)

    def _heal(self) -> None:
        """Startup scan of an existing spill dir: truncate torn tails, drop
        incomplete segments, quarantine corrupt ones, index the rest."""
        assert self.dir is not None
        for path in sorted(self.dir.glob("[0-9]*.seg")):
            try:
                data = path.read_bytes()
            except OSError:
                continue
            payloads, verdict, good_end = scan_frames(data)
            if verdict == "corrupt":
                self._quarantine(path)
                continue
            if verdict == "torn":
                with open(path, "r+b") as f:
                    f.truncate(good_end)
            parsed = self._parse_segment(payloads)
            if parsed is None:
                self.incomplete += 1
                path.unlink(missing_ok=True)
                continue
            head, payload = parsed
            if head in self._disk:  # duplicate entry: first segment wins
                path.unlink(missing_ok=True)
                continue
            seq = int(path.stem)
            self._seq = max(self._seq, seq + 1)
            self._disk[head] = _DiskRec(path, payload.tokens, payload.nbytes, seq)
            self._disk_bytes += payload.nbytes
        self._shrink_disk()
