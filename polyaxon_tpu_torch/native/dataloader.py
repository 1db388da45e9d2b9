"""ctypes bindings for the native token-corpus loader (`dataloader.cpp`), an
own copy of `polyaxon_tpu/native/dataloader.py`.

`NativeTokenLoader` is an iterator yielding {"inputs" [B,S], "labels"
[B,S]} int32 batches, with the window gather and dtype conversion done by
C++ worker threads ahead of demand. For the same file, seed and process
layout its batches are the reference loader's.

The library is built at first use from this directory's `dataloader.cpp`
with `g++ -O2 -shared -fPIC -pthread` into `build/torch_native/` at the
repository root (git-ignored), named by a hash of the source and the
flags, so an edited source builds anew. A failed build raises
`NativeBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_DTYPES = {"uint16": 0, "uint32": 1, "int32": 2}


class NativeBuildError(RuntimeError):
    pass


def compiler() -> str:
    """The C++ compiler: $CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("no C++ compiler: set CXX or put g++ on PATH")
    return cxx


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libptl-dataloader-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile `dataloader.cpp` unless this exact source is built already.
    The build writes a temporary file and renames it, so a concurrent
    loader sees the whole library or none."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"building {out.name} failed: {e}") from e
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"building {out.name} failed (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


_lock = threading.Lock()
_lib: list = []


def _load() -> ctypes.CDLL:
    with _lock:
        if not _lib:
            lib = ctypes.CDLL(str(build()))
            lib.ptl_open.restype = ctypes.c_void_p
            lib.ptl_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.ptl_next.restype = ctypes.c_int
            lib.ptl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
            lib.ptl_corpus_tokens.restype = ctypes.c_int64
            lib.ptl_corpus_tokens.argtypes = [ctypes.c_void_p]
            lib.ptl_close.restype = None
            lib.ptl_close.argtypes = [ctypes.c_void_p]
            lib.ptl_last_error.restype = ctypes.c_char_p
            _lib.append(lib)
        return _lib[0]


def npy_payload_offset(path: Path) -> tuple[int, str]:
    """(header offset, dtype name) of a 1-D .npy so the native loader can
    mmap the raw payload directly."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        np.lib.format._check_version(version)
        shape, fortran, dtype = np.lib.format._read_array_header(f, version)
        if len(shape) != 1 or fortran:
            raise ValueError(f"{path}: native loader needs a flat C-order array")
        return f.tell(), dtype.name


class NativeTokenLoader:
    """Iterator over prefetched causal-LM batches from a flat token file.

    Accepts `.bin` (raw uint16/uint32/int32, `dtype` arg) or 1-D `.npy`
    (dtype read from the header). Process i only draws window starts
    congruent to i (mod process_count), as the Python path does.
    """

    def __init__(
        self,
        path: str | Path,
        *,
        seq_len: int,
        batch_size: int,
        dtype: str = "uint16",
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        # 1 worker keeps the batch stream deterministic for a seed; more
        # prefetch faster but their order depends on thread scheduling
        n_threads: int = 1,
        queue_depth: int = 4,
    ):
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"token file not found: {path}")
        offset = 0
        if path.suffix == ".npy":
            offset, dtype = npy_payload_offset(path)
        if dtype not in _DTYPES:
            raise ValueError(
                f"native loader supports {sorted(_DTYPES)} tokens, got {dtype!r}"
            )
        self._h = None
        self._lib = _load()
        self._h = self._lib.ptl_open(
            str(path).encode(), _DTYPES[dtype], offset, seq_len, batch_size,
            seed, process_index, process_count, n_threads, queue_depth,
        )
        if not self._h:
            raise RuntimeError(f"native loader: {self._lib.ptl_last_error().decode()}")
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.corpus_tokens = int(self._lib.ptl_corpus_tokens(self._h))
        self._buf = np.empty((batch_size, seq_len + 1), np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        if self._h is None:
            raise RuntimeError("loader is closed")
        rc = self._lib.ptl_next(self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(f"native loader: {self._lib.ptl_last_error().decode()}")
        toks = self._buf  # copy per field: the next call reuses _buf
        return {"inputs": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}

    def close(self):
        if self._h is not None:
            self._lib.ptl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best effort: close() is the contract
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
