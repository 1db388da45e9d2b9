"""File-backed datasets: memory-mapped token corpora and array datasets,
an own copy of `polyaxon_tpu/data/files.py` (the port imports nothing of
the JAX package). For the same file, seed and process layout each loader
(Python or native) yields the batches of the reference's same loader.

- token corpora are a single flat binary of token ids (`.bin` uint16/uint32
  or `.npy`), memory-mapped — random windows need no parsing, no Python-
  level tokenization on the hot path, and the OS page cache handles reuse.
- multi-host sharding by interleaved windows: process i may only draw start
  offsets congruent to i mod process_count, so hosts can never read the
  same window in the same step — disjoint by construction, no coordination.
- array datasets (`inputs.npy` + `labels.npy`) serve classification;
  batches are drawn as random rows per host.

Datasets:
  token_file:  {path, seq_len, dtype?} → {"inputs" [B,S], "labels" [B,S]}
  array_file:  {inputs, labels}        → {"inputs", "labels"}
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .registry import DataSpec, register_dataset


def _load_tokens(path: str, dtype: str | None) -> np.ndarray:
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"token file not found: {p}")
    if p.suffix == ".npy":
        arr = np.load(p, mmap_mode="r")
    else:
        arr = np.memmap(p, dtype=np.dtype(dtype or "uint16"), mode="r")
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    return arr


def _token_stream(corpus, seq_len, batch_size, seed, process_index, process_count):
    """Interleaved start offsets: process i draws only starts congruent to
    i (mod process_count), so two hosts can never sample the same window in
    any step — true disjointness, not just decorrelated seeds."""
    rng = np.random.default_rng(seed * 1000003 + process_index + 17)
    n = len(corpus)
    if n < seq_len + 2:
        raise ValueError(
            f"corpus has {n} tokens, need at least seq_len+2={seq_len + 2}"
        )
    n_starts = n - seq_len - 1
    n_mine = (n_starts - process_index + process_count - 1) // process_count
    if n_mine <= 0:
        raise ValueError(
            f"corpus too small: {n_starts} windows across {process_count} hosts"
        )
    while True:
        starts = process_index + process_count * rng.integers(
            0, n_mine, size=batch_size
        )
        toks = np.stack([np.asarray(corpus[s : s + seq_len + 1]) for s in starts])
        toks = toks.astype(np.int32)
        yield {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


@register_dataset("token_file")
def token_file(batch_size, config, seed, process_index, process_count=1):
    """Causal-LM windows from a memory-mapped token corpus.

    `loader: native|python|auto` (default auto) picks the C++ prefetch
    loader (the port's native/dataloader.cpp — worker threads gather windows ahead of
    demand, next() is one memcpy) with transparent fallback to the Python
    mmap path when the native lib can't build or the dtype is unsupported.
    """
    seq_len = int(config.get("seq_len", 1024))
    path = str(config.get("path", ""))
    loader = str(config.get("loader", "auto"))
    if loader not in ("native", "python", "auto"):
        raise ValueError(
            f"token_file loader must be native|python|auto, got {loader!r}"
        )
    corpus = _load_tokens(path, config.get("dtype"))
    # don't scan a multi-GB mmap when vocab_size is declared
    vocab = config.get("vocab_size") or int(corpus.max()) + 1
    meta = {
        "seq_len": seq_len,
        "corpus_tokens": int(len(corpus)),
        "vocab_size": int(vocab),
    }

    iterator = None
    if loader in ("native", "auto"):
        try:
            from ..native.dataloader import NativeTokenLoader

            iterator = NativeTokenLoader(
                path,
                seq_len=seq_len,
                batch_size=batch_size,
                dtype=str(config.get("dtype") or "uint16"),
                seed=int(seed),
                process_index=process_index,
                process_count=process_count,
                n_threads=int(config.get("loader_threads", 1)),
            )
            meta["loader"] = "native"
        except Exception as e:  # noqa: BLE001 — fall back, unless forced
            if loader == "native":
                raise
            meta["loader"] = f"python (native unavailable: {type(e).__name__})"
    if iterator is None:
        meta.setdefault("loader", "python")
        iterator = _token_stream(
            corpus, seq_len, batch_size, seed, process_index, process_count
        )
    return DataSpec(
        name="token_file",
        iterator=iterator,
        batch_size=batch_size,
        meta=meta,
        # native loaders own worker threads + a corpus mmap; release them
        # when the run tears down, not at interpreter GC
        close=getattr(iterator, "close", None),
    )


def _array_stream(inputs, labels, batch_size, seed, process_index):
    rng = np.random.default_rng(seed * 1000003 + process_index + 29)
    n = len(inputs)
    while True:
        idx = rng.integers(0, n, size=batch_size)
        yield {
            "inputs": np.ascontiguousarray(inputs[idx]),
            "labels": np.ascontiguousarray(labels[idx]).astype(np.int32),
        }


@register_dataset("array_file")
def array_file(batch_size, config, seed, process_index):
    """Classification rows from `inputs`/`labels` .npy files (mmap)."""
    ipath, lpath = str(config.get("inputs", "")), str(config.get("labels", ""))
    for p in (ipath, lpath):
        if not Path(p).exists():
            raise FileNotFoundError(f"array file not found: {p}")
    inputs = np.load(ipath, mmap_mode="r")
    labels = np.load(lpath, mmap_mode="r")
    if len(inputs) != len(labels):
        raise ValueError(
            f"inputs has {len(inputs)} rows but labels has {len(labels)}"
        )
    return DataSpec(
        name="array_file",
        iterator=_array_stream(inputs, labels, batch_size, seed, process_index),
        batch_size=batch_size,
        meta={
            "rows": int(len(inputs)),
            "shape": tuple(inputs.shape[1:]),
            "num_classes": int(labels.max()) + 1 if len(labels) else 0,
        },
    )
