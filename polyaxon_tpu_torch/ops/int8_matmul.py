"""Weight-only int8 projection: a hand-written Hopper kernel and its plain
version.

    y = int8_matmul(x, wq, scale)   # x [..., K]; wq int8 [N, K]; scale f32 [N]

computes `(x · wqᵀ, summed in f32) · scale[n]`, cast to x's dtype (bf16 or
f32) — the function of the reference's `Int8Dense`
(`polyaxon_tpu/models/quant.py:85-90`, XLA's mixed `dot_general` with
`preferred_element_type=f32`). PyTorch has no int8 × bf16 product
(`torch._int_mm` wants int8 on both sides), and dequantizing to bf16 before
`torch.matmul` would write a bf16 copy of every projection on every call.

- On CUDA tensors it launches `csrc/int8_matmul.cu` (built at first use by
  `_build.py`) or raises: there is no dequantize-then-matmul path and no
  fallback. bf16 with M <= 8 rows (decode) streams the int8 rows with
  16-byte loads into mma.sync; more bf16 rows take the tiled mma.sync
  kernel, and f32 (the parity configs) the tiled FMA kernel at any M.
- On CPU tensors it runs `int8_matmul_reference`, the plain version the
  tests hold against the JAX package and `chip_smoke.py` holds the kernel
  against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from .flash_attention import _CudaKernel, _stream

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x, wq, scale):
    """Plain PyTorch version: (x.float() @ wq.float().T) * scale, cast to
    x's dtype."""
    y = torch.matmul(x.float(), wq.float().T) * scale.float()
    return y.to(x.dtype)


class Int8MatmulKernel(_CudaKernel):
    """`polyaxon_int8_matmul` (csrc/int8_matmul.cu)."""

    name = "int8_matmul"
    lib = "int8_matmul"
    symbol = "polyaxon_int8_matmul"
    argtypes = (
        (ctypes.c_void_p,) * 4
        + (ctypes.c_int,) * 4
        + (ctypes.c_longlong,) * 2
        + (ctypes.c_void_p,)
    )

    def __call__(self, x, wq, scale):
        """x [..., K] bf16/f32, wq int8 [N, K], scale f32 [N], one CUDA
        device → y [..., N] in x's dtype."""
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"int8_matmul takes float32 or bfloat16 x; got {x.dtype}")
        if wq.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(
                f"int8_matmul needs int8 weights and f32 scales; got "
                f"{wq.dtype}/{scale.dtype}"
            )
        N, K = wq.shape
        if x.shape[-1] != K or scale.dim() != 1 or scale.shape[0] != N:
            raise ValueError(
                f"int8_matmul shapes: x [..., {x.shape[-1]}], wq {tuple(wq.shape)}, "
                f"scale {tuple(scale.shape)}"
            )
        if K % 16:
            raise ValueError(f"int8_matmul needs K % 16 == 0 (16-byte rows); got K={K}")
        if wq.device != x.device or scale.device != x.device:
            raise ValueError("int8_matmul inputs must be on one device")
        lead = x.shape[:-1]
        x2 = x.reshape(-1, K)
        # the kernel reads rows of x and wq 16 bytes at a time: a strided or
        # offset view (the attention reshapes) is copied to a packed one;
        # the weights are packed already
        if not x2.is_contiguous() or x2.data_ptr() % 16:
            x2 = x2.clone(memory_format=torch.contiguous_format)
        if not wq.is_contiguous() or wq.data_ptr() % 16 or not scale.is_contiguous():
            raise ValueError("int8_matmul needs packed, 16-byte aligned wq and scale")
        M = x2.shape[0]
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        if M:
            args = (x2.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(),
                    _DTYPE_CODES[x.dtype], M, N, K, K, N, _stream(x))
            # decode calls this seven times a layer: enter the device's
            # context only when it is not the current one already
            if x.device.index in (None, torch.cuda.current_device()):
                self._launch(*args)
            else:
                with torch.cuda.device(x.device):
                    self._launch(*args)
        return y.reshape(*lead, N)


INT8_MATMUL = Int8MatmulKernel()


def int8_matmul(x, wq, scale):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, wq, scale)
    return INT8_MATMUL(x, wq, scale)
