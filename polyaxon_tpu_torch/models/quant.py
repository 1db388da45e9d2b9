"""int8 weight-only quantization for the serving decode path, counterpart
of `polyaxon_tpu/models/quant.py` (an own copy: the port imports nothing of
the JAX package).

The seven projections of each block (q/k/v/o, gate/up/down; an MoE
block's four attention projections, its router and stacked experts being
no QUANT_TARGETS) are quantized to int8 with one symmetric scale per
output channel, per layer and column on a scanned stack's [n_layers,
out, in] weights:

    scale[o] = max_i |W[o, i]| / 127        (float32)
    Wq[o, i] = round(W[o, i] / scale[o])    (int8, clipped to [-127, 127])

in `nn.Linear`'s [out, in] layout (the reference's kernels are [in, out];
the payload bytes are the same numbers transposed). `torch.round` rounds
half to even, as `jnp.round` does, so the int8 payloads equal the
reference's byte for byte. `Int8Linear` then computes
`(x · Wqᵀ in f32) · scale` through `ops.int8_matmul`: the hand-written
kernel on the card, its plain version on the CPU; no dequantized copy of a
weight is ever written. Embedding, lm_head and the norms stay at full
precision. LoRA projections quantize their frozen base and keep the
adapters (`lora_a`, `lora_b`) at checkpoint precision (`Int8LoRALinear`),
single or slot-stacked for multi-tenant serving: `project` still runs the
int8 products of q/k/v and gate/up as one grouped launch, and each member
adds its own per-row adapter delta after it. A layer launches the int8
kernel 4 times (q/k/v, o, gate/up, down), an MoE layer twice (q/k/v, o).

The same per-vector scheme backs the int8 paged KV pool: `quantize_kv`
maps each slot's per-head K/V vector to an int8 payload plus one f32 scale,
a pure function of that vector, so the pool bytes do not depend on the
order slots are written in (one-shot prefill, chunked prefill, prefix
reuse). `kv_pool_bytes` is the pool's size by formula.

Quantize-on-load: `quantize_module` rebuilds a Transformer with
`cfg.quant = "int8"` from the fp module's weights; the serving layer drops
the fp copy. No clocks in this module.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.int8_matmul import int8_matmul, int8_matmul_group
from .lora import lora_delta, run_proj

# the seven decode projections; everything else (embed, lm_head, norms,
# lora_a/b) stays at checkpoint precision
QUANT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


class Int8Linear(nn.Module):
    """Weight-only int8 projection without bias: `weight` int8 [out, in]
    (nn.Linear's layout) and `scale` f32 [out], both buffers (nothing here
    trains). The counterpart of the reference's `Int8Dense`."""

    def __init__(self, in_features: int, out_features: int, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer(
            "weight", torch.zeros(out_features, in_features, dtype=torch.int8, device=device)
        )
        self.register_buffer(
            "scale", torch.ones(out_features, dtype=torch.float32, device=device)
        )

    def forward(self, x, adapter_ix=None):
        return self.adapt(x, int8_matmul(x, self.weight, self.scale), adapter_ix)

    def adapt(self, x, y, adapter_ix=None):
        """What the projection adds to its int8 product `y` of `x`:
        nothing here (a LoRA projection adds its adapter delta, per row
        by `adapter_ix` when its adapters are slot-stacked)."""
        return y

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, int8"


class Int8LoRALinear(Int8Linear):
    """The int8 base of a LoRA projection plus its fp adapters:
    y = int8(x) + (alpha / r)(x A) B, with `lora_a` [in, r] and `lora_b`
    [r, out] in the reference's orientation — or, with `slots > 0`,
    [slots, in, r] and [slots, r, out] gathered per row (`models/lora.py`)."""

    def __init__(self, in_features, out_features, rank, alpha, slots: int = 0,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, device=device)
        self.rank, self.alpha, self.slots = rank, alpha, slots
        factory = dict(device=device, dtype=dtype)
        lead = (slots,) if slots > 0 else ()
        self.lora_a = nn.Parameter(torch.zeros(*lead, in_features, rank, **factory))
        self.lora_b = nn.Parameter(torch.zeros(*lead, rank, out_features, **factory))

    def adapt(self, x, y, adapter_ix=None):
        delta = lora_delta(x, self.lora_a, self.lora_b, adapter_ix)
        return y + (self.alpha / self.rank) * delta


def project(x, projs, adapter_ix=None) -> tuple:
    """Each of `projs` applied to the same `x`: where all are int8
    (`Int8Linear`, LoRA ones included) their int8 products come from one
    grouped kernel launch and each adds its own adapter delta (per row by
    `adapter_ix` [B] on slot-stacked adapters); any other set (nn.Linear,
    LoRADense, a mix) calls each projection in turn."""
    if len(projs) > 1 and all(isinstance(p, Int8Linear) for p in projs):
        ys = int8_matmul_group(x, [(p.weight, p.scale) for p in projs])
        return tuple(p.adapt(x, y, adapter_ix) for p, y in zip(projs, ys))
    return tuple(run_proj(p, x, adapter_ix) for p in projs)


def quantize_kernel(w) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., out, in] fp weight → (int8 weight, f32 scale [..., out]): one
    scale per output channel, amax'd over the input dim (leading layer dims
    of a scanned stack quantize per layer and column)."""
    w32 = torch.as_tensor(w).float()
    amax = w32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv(x) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., head_dim] fp K/V → (int8 payload, f32 scale [...]): one
    symmetric scale per leading index (per cache slot and kv head)."""
    x32 = torch.as_tensor(x).float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_kv: int8 [..., head_dim] + f32 scale [...] → fp
    values in `dtype`."""
    return (q.float() * scale[..., None]).to(dtype)


def kv_pool_bytes(layout, n_layers: int, n_kv_heads: int, head_dim: int,
                  kv_dtype_bytes: int = 2) -> int:
    """Device bytes of the paged K+V pool under `layout`: int8 pools pay one
    byte per element plus one f32 scale per (slot, head), fp pools
    `kv_dtype_bytes` per element."""
    slots = layout.pool_pages * layout.page_tokens
    if getattr(layout, "kv_quant", "none") == "int8":
        per_slot = n_kv_heads * (head_dim * 1 + 4)  # payload + f32 scale
    else:
        per_slot = n_kv_heads * head_dim * kv_dtype_bytes
    return 2 * n_layers * slots * per_slot  # 2 = K and V


def _split(name: str) -> tuple[str, str]:
    """'layers.0.attention.q_proj.weight' → ('layers.0.attention.q_proj', 'weight')."""
    prefix, _, leaf = name.rpartition(".")
    return prefix, leaf


def _is_target(prefix: str) -> bool:
    return prefix.rpartition(".")[2] in QUANT_TARGETS


def quantize_params(state: dict, *, allow_lora: bool = False) -> tuple[dict, int]:
    """Quantize every QUANT_TARGETS projection weight of a state_dict.
    Returns (new state_dict, device bytes saved). Other entries pass
    through. With `allow_lora` a target that carries LoRA adapters
    quantizes its frozen base `weight` and keeps `lora_a`/`lora_b`;
    without it such a target is refused (a caller that cannot rebuild the
    module with the int8 + LoRA projection must not drop the adapters)."""
    lora_prefixes = {
        _split(k)[0] for k in state if _split(k)[1] in ("lora_a", "lora_b")
    }
    saved = 0
    out = {}
    for name, value in state.items():
        prefix, leaf = _split(name)
        if leaf == "weight" and _is_target(prefix):
            if prefix in lora_prefixes and not allow_lora:
                raise ValueError(
                    f"cannot int8-quantize {prefix!r}: it carries LoRA adapter "
                    "params (pass allow_lora=True to quantize the frozen base and "
                    "keep the adapter deltas fp)"
                )
            q, s = quantize_kernel(value)
            saved += (
                value.numel() * value.element_size()
                - q.numel() * q.element_size()
                - s.numel() * s.element_size()
            )
            out[name] = q
            out[f"{prefix}.scale"] = s
        else:
            out[name] = value
    return out, int(saved)


def decode_weight_bytes(state) -> tuple[int, int]:
    """(target projection bytes, total param bytes) of a state_dict or a
    module: the reference's accounting, over the same leaves."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    target = total = 0
    for name, value in state.items():
        b = value.numel() * value.element_size()
        total += b
        if any(part in QUANT_TARGETS for part in name.split(".")):
            target += b
    return target, total


def int8_bytes_saved(module) -> int:
    """Device bytes an int8 module (`cfg.quant == "int8"`) saves against
    its fp self at the dtype of its other weights: `quantize_params`'
    accounting, for a module quantized on load."""
    fp = module.dtype.itemsize
    return int(sum(
        m.weight.numel() * (fp - 1) - m.scale.numel() * m.scale.element_size()
        for m in module.modules() if isinstance(m, Int8Linear)
    ))


@torch.no_grad()
def quantize_module(module):
    """Quantize-on-load for serving: a new module of the same type with
    `cfg.quant = "int8"` on the same device and dtype, holding the int8
    projections of `module`'s weights (its own weights are left as they
    are). Returns (module, bytes_saved)."""
    cfg = getattr(module, "cfg", None)
    if cfg is None or not hasattr(cfg, "quant"):
        raise ValueError(f"{type(module).__name__} has no quantizable decode path")
    if cfg.quant != "none":
        raise ValueError(
            f"module is already quantized (cfg.quant = {cfg.quant!r}) — "
            "quantize-on-load runs once, on the fp checkpoint"
        )
    lora = getattr(cfg, "lora_rank", 0) > 0
    state, saved = quantize_params(module.state_dict(), allow_lora=lora)
    qmodule = type(module)(
        dataclasses.replace(cfg, quant="int8"), device=module.device, dtype=module.dtype
    )
    qmodule.load_state_dict(state)
    return qmodule.train(module.training), saved
