"""Weight-only int8 projection: a hand-written Hopper kernel and its plain
version.

    y = int8_matmul(x, wq, scale)                  # x [..., K]; wq int8 [N, K]; scale f32 [N]
    q, k, v = int8_matmul_group(x, [(wq_q, s_q), (wq_k, s_k), (wq_v, s_v)])

computes `(x · wqᵀ, summed in f32) · scale[n]`, cast to x's dtype (bf16 or
f32) — the function of the reference's `Int8Dense`
(`polyaxon_tpu/models/quant.py:85-90`, XLA's mixed `dot_general` with
`preferred_element_type=f32`). PyTorch has no int8 × bf16 product
(`torch._int_mm` wants int8 on both sides), and dequantizing to bf16 before
`torch.matmul` would write a bf16 copy of every projection on every call.
`int8_matmul_group` runs up to four projections of one x (q/k/v, gate/up)
in one launch; each weight stays in its own buffer.

- On CUDA tensors it launches `csrc/int8_matmul.cu` (built at first use by
  `_build.py`) or raises: there is no dequantize-then-matmul path and no
  fallback. bf16 with M <= 8 rows (decode) streams the int8 rows through
  a cp.async ring in shared memory into mma.sync; more bf16 rows take the
  wgmma kernel (TMA-fed, bf16 tiles widened from int8 in shared memory);
  both split K across the blocks of a cluster where the group's tiles do
  not fill the card (the C side's plan, from the shapes and the SM count;
  `INT8_MATMUL.plan` reads it). f32 (the parity configs) takes the tiled
  FMA kernel at any M.
- On CPU tensors it runs `int8_matmul_reference`, the plain version the
  tests hold against the JAX package and `chip_smoke.py` holds the kernel
  against on the card; a group is exactly its members' separate calls.
"""

from __future__ import annotations

import ctypes

import torch

from .flash_attention import _CudaKernel, _stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 4  # projections of one launch


def int8_matmul_reference(x, wq, scale):
    """Plain PyTorch version: (x.float() @ wq.float().T) * scale, cast to
    x's dtype."""
    y = torch.matmul(x.float(), wq.float().T) * scale.float()
    return y.to(x.dtype)


def _check_group(x, pairs) -> tuple:
    """The checks every call makes, on any device: 1-4 (wq int8 [N, K],
    scale f32 [N]) pairs sharing x's K and device, x bf16 or f32, K % 16.
    Returns the members' N."""
    if not 1 <= len(pairs) <= MAX_GROUP:
        raise ValueError(f"int8_matmul_group takes 1 to {MAX_GROUP} projections; got {len(pairs)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 x; got {x.dtype}")
    K = x.shape[-1]
    device = x.device
    Ns = []
    for wq, scale in pairs:
        if wq.dtype is not torch.int8 or scale.dtype is not torch.float32:
            raise TypeError(
                f"int8_matmul needs int8 weights and f32 scales; got "
                f"{wq.dtype}/{scale.dtype}"
            )
        shape = wq.shape
        if len(shape) != 2 or shape[1] != K or scale.shape != shape[:1]:
            raise ValueError(
                f"int8_matmul shapes: x [..., {K}], wq {tuple(shape)}, "
                f"scale {tuple(scale.shape)}"
            )
        if wq.device != device or scale.device != device:
            raise ValueError("int8_matmul inputs must be on one device")
        Ns.append(shape[0])
    if K % 16:
        raise ValueError(f"int8_matmul needs K % 16 == 0 (16-byte rows); got K={K}")
    return tuple(Ns)


class Int8MatmulKernel(_CudaKernel):
    """`polyaxon_int8_matmul` (csrc/int8_matmul.cu): one launch for x and
    1-4 projections."""

    name = "int8_matmul"
    lib = "int8_matmul"
    symbol = "polyaxon_int8_matmul"
    argtypes = (
        (ctypes.c_void_p,) + (ctypes.c_int,) * 3 + (ctypes.c_longlong, ctypes.c_int)
        + (ctypes.c_void_p,) * (3 * MAX_GROUP) + (ctypes.c_int,) * MAX_GROUP
        + (ctypes.c_longlong, ctypes.c_void_p)
    )

    def __call__(self, x, wq, scale):
        """x [..., K] bf16/f32, wq int8 [N, K], scale f32 [N], one CUDA
        device → y [..., N] in x's dtype."""
        return self.group(x, ((wq, scale),))[0]

    def group(self, x, pairs):
        """x [..., K] and 1-4 (wq [N_i, K], scale [N_i]) on one CUDA device
        → (y_i [..., N_i], ...) in x's dtype, from one launch (f32: one
        FMA kernel a member, still one call here). The y_i are column
        slices of one [..., sum N_i] buffer (a single projection's is the
        whole, packed). Decode calls this four times a layer, so the host
        path is kept short."""
        Ns = _check_group(x, pairs)
        if not x.is_cuda:
            raise ValueError("int8_matmul launches on CUDA tensors (the plain version serves the CPU)")
        K = x.shape[-1]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, K)
        # the kernels read rows of x and wq 16 bytes at a time: a strided or
        # offset view (the attention reshapes) is copied to a packed one;
        # the weights are packed already
        if not x2.is_contiguous() or x2.data_ptr() % 16:
            x2 = x2.clone(memory_format=torch.contiguous_format)
        w_ptrs, s_ptrs = [], []
        for wq, scale in pairs:
            w, s = wq.data_ptr(), scale.data_ptr()
            if w % 16 or not wq.is_contiguous() or not scale.is_contiguous():
                raise ValueError("int8_matmul needs packed, 16-byte aligned wq and scale")
            w_ptrs.append(w)
            s_ptrs.append(s)
        M = x2.shape[0]
        total = sum(Ns)
        y = torch.empty((M, total), dtype=x.dtype, device=x.device)
        if M:
            # enter the device's context only when it is not the current one
            if x2.get_device() == torch.cuda.current_device():
                self._run(x2, w_ptrs, s_ptrs, y, Ns, M, K)
            else:
                with torch.cuda.device(x2.get_device()):
                    self._run(x2, w_ptrs, s_ptrs, y, Ns, M, K)
        y = y.view(*lead, total)
        return (y,) if len(Ns) == 1 else y.split(Ns, -1)

    def _run(self, x2, w_ptrs, s_ptrs, y, Ns, M, K):
        pad = [None] * (MAX_GROUP - len(Ns))
        y_ptrs, at, size = [], y.data_ptr(), y.element_size()
        for n in Ns:
            y_ptrs.append(at)
            at += n * size
        self._launch(
            x2.data_ptr(), _DTYPE_CODES[x2.dtype], M, K, K, len(Ns),
            *w_ptrs, *pad, *s_ptrs, *pad, *y_ptrs, *pad,
            *Ns, *[0] * len(pad), sum(Ns), _stream(x2),
        )

    def device_launches(self) -> int:
        """The launches the current CUDA device has run, by a counter the
        kernels keep on the device (one a bf16 launch, one a member for
        f32): unlike a profiler's trace it drops none. Synchronizes."""
        from ._build import load

        fn = load(self.lib).polyaxon_int8_device_launches
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
        fn.restype = ctypes.c_int
        torch.cuda.synchronize()
        n = ctypes.c_ulonglong()
        err = fn(ctypes.byref(n))
        if err:
            raise RuntimeError(f"polyaxon_int8_device_launches failed: cudaError {err}")
        return n.value

    def plan(self, M: int, K: int, Ns, dtype=torch.bfloat16) -> tuple[int, int]:
        """(prefill tile width, K splits) that a launch takes for x [M, K]
        against outputs of widths `Ns` on the current CUDA device: (0, 1)
        for f32, (0, splits) for the decode kernel. The plan lives in
        `polyaxon_int8_plan` beside the kernels' tiles; this reads it (for
        the reports) and launches nothing."""
        from ._build import load

        fn = load(self.lib).polyaxon_int8_plan
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
        tile_n, splits = ctypes.c_int(), ctypes.c_int()
        Ns = list(Ns)
        err = fn(_DTYPE_CODES[dtype], M, K, len(Ns), *Ns, *[0] * (MAX_GROUP - len(Ns)),
                 ctypes.byref(tile_n), ctypes.byref(splits))
        if err:
            raise RuntimeError(f"polyaxon_int8_plan failed: cudaError {err}")
        return tile_n.value, splits.value


INT8_MATMUL = Int8MatmulKernel()


def int8_matmul(x, wq, scale):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, scale)
    return INT8_MATMUL(x, wq, scale)


def int8_matmul_group(x, pairs):
    """`int8_matmul` of one x against 1-4 (wq, scale) pairs sharing its K:
    one launch on CUDA tensors (one count in `INT8_MATMUL.launches`), the
    members' separate plain calls on CPU tensors. Returns a tuple."""
    if x.device.type == "cpu":
        _check_group(x, pairs)
        return tuple(int8_matmul_reference(x, wq, scale) for wq, scale in pairs)
    return INT8_MATMUL.group(x, pairs)
