"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface, so `nvcc` compiles it in
seconds into `build/torch_kernels/lib<name>-<hash>.so` at the repository
root (listed in `.gitignore`). The hash covers the source, every file under
`csrc/` that it includes (`#include "..."`, followed transitively) and the
flags, so an edited source or header builds anew. CUTLASS's include path is
added only for a source that includes CuTe or CUTLASS headers. A failed
build raises; nothing falls back.

    from polyaxon_tpu_torch.ops._build import load
    lib = load("flash_fwd")
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# `a`: wgmma/setmaxnreg exist only for sm_90a (plain sm_90 refuses them)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CUTLASS_INCLUDE = "/usr/local/cutlass/include"
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)
_CUTLASS_INCLUDE = re.compile(r"^\s*#\s*include\s*<(?:cute|cutlass)/", re.M)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use"
    )


def sources(name: str) -> list[Path]:
    """csrc/<name>.cu and the files under csrc/ it includes with quotes,
    transitively, sorted by path."""
    root = CSRC.resolve()
    found: set[Path] = set()
    todo = [root / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.add(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            dep = (path.parent / inc).resolve()
            if dep.is_relative_to(root) and dep.is_file():
                todo.append(dep)
    return sorted(found)


def nvcc_flags(name: str) -> tuple[str, ...]:
    """NVCC_FLAGS, plus CUTLASS's include path where a source uses it."""
    if any(_CUTLASS_INCLUDE.search(p.read_text()) for p in sources(name)):
        return (*NVCC_FLAGS, "-I", CUTLASS_INCLUDE)
    return NVCC_FLAGS


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.relative_to(CSRC.resolve()).as_posix().encode() + b"\0")
        digest.update(path.read_bytes())
    digest.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless this exact source (with its headers)
    is already built.
    The compiler's register/shared-memory report (-Xptxas -v) is kept
    beside the library as `<lib>.log`."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *nvcc_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
