#!/usr/bin/env python3
"""Time this checkout's int8_matmul against another checkout's kernel source
on one NVIDIA GPU, in turns on the same card (other, this, this, other).

    mkdir -p build/int8_compare/other
    git archive <commit> polyaxon_tpu_torch/ops/csrc | tar -x -C build/int8_compare/other
    python3 int8_compare.py build/int8_compare/other/polyaxon_tpu_torch/ops/csrc [M ...]

The other source must expose the earlier single-projection C entry point,
`polyaxon_int8_matmul(x, w, scale, y, dtype, M, N, K, ldx, ldy, stream)`.
For each M (default 8, 256, 264, 2048) it runs one llama3-1b layer's
projections, bf16, as the model launches them here (q/k/v grouped, o,
gate/up grouped, down) and as separate calls through the other kernel.
Each side is one `chip_smoke.int8_case`: held per row against the plain
version, two calls bit-equal, timed by CUDA-graph replay with the weights
cycled past the L2, beside torch.matmul on the bf16 weights and the
launch's bound. Prints each case's line, one line per projection and per
layer with the two sides' times, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROWS = (8, 256, 264, 2048)


def main() -> int:
    import torch

    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from polyaxon_tpu_torch.ops import _build
    from polyaxon_tpu_torch.ops.flash_attention import _stream

    src = Path(sys.argv[1]).resolve() / "int8_matmul.cu"
    rows = [int(a) for a in sys.argv[2:]] or list(ROWS)
    lib = HERE / "build" / "int8_compare" / "libother_int8_matmul.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).polyaxon_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def other(x, pairs):
        """The other kernel, one launch a member."""
        M, K = x.shape
        ys = []
        for wq, scale in pairs:
            N = wq.shape[0]
            y = torch.empty((M, N), dtype=x.dtype, device=x.device)
            err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(), 1, M, N, K, K,
                     N, _stream(x))
            if err:
                raise RuntimeError(f"the other int8_matmul failed: cudaError {err}")
            ys.append(y)
        return ys

    print(cs.device_line(), flush=True)
    keys = ("other_ms", "this_ms", "library_ms", "bound_ms")
    for M in rows:
        layer = dict.fromkeys(keys, 0.0)
        for name, (K, Ns) in cs.INT8_LAYER.items():
            t = [cs.int8_case(M, K, Ns, "bfloat16", name, **side)
                 for side in ({"launch": other, "kernel": "other"}, {}, {},
                              {"launch": other, "kernel": "other"})]
            was, now = (t[0]["ms"] + t[3]["ms"]) / 2, (t[1]["ms"] + t[2]["ms"]) / 2
            line = {"other_ms": was, "this_ms": now, "library_ms": t[1]["library_ms"],
                    "bound_ms": t[1]["bound_ms"]}
            cs.emit({"M": M, "projection": name, **line, "speedup": was / now,
                     "x_bound": now / line["bound_ms"], "tile_n": t[1]["tile_n"],
                     "k_splits": t[1]["k_splits"]})
            for k in keys:
                layer[k] += line[k]
        cs.emit({"M": M, "layer": layer, "speedup": layer["other_ms"] / layer["this_ms"],
                 "x_bound": layer["this_ms"] / layer["bound_ms"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
