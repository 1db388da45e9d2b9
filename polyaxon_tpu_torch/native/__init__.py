"""Native (C++) components of the port, built at first use into
`build/torch_native/` (git-ignored), each named by a hash of its source
and flags:

- the token-corpus prefetch loader (`dataloader.cpp`, bound with ctypes in
  `dataloader.py`);
- the gang supervisor (`launcher.cpp`, `launcher_path`), which starts a
  JAXJob's worker processes with torch.distributed's rendezvous
  environment.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import threading
from pathlib import Path

from .dataloader import BUILD_DIR, NativeBuildError, compiler

LAUNCHER_SOURCE = Path(__file__).resolve().parent / "launcher.cpp"
LAUNCHER_FLAGS = ("-O2", "-std=c++17")


def launcher_path(rebuild: bool = False) -> str:
    """Path to the compiled launcher; builds it unless this exact source
    is built already (a temporary file renamed into place)."""
    digest = hashlib.sha256(LAUNCHER_SOURCE.read_bytes())
    digest.update(" ".join(LAUNCHER_FLAGS).encode())
    out = BUILD_DIR / f"polyaxon-launcher-{digest.hexdigest()[:12]}"
    if out.exists() and not rebuild:
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(), *LAUNCHER_FLAGS, "-o", str(tmp), str(LAUNCHER_SOURCE)]
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
    return str(out)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pick_port(seed: str, base: int = 23000, span: int = 20000) -> int:
    """A rendezvous port per run, with probing: hashing the run uuid
    spreads concurrent gangs apart, and probing skips ports taken now."""
    start = base + int(hashlib.sha1(seed.encode()).hexdigest(), 16) % span
    for i in range(64):
        port = base + (start - base + i) % span
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free rendezvous port found")
