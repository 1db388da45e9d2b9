"""The JAX package's parameter tree → this port's `state_dict`.

`params_np` is the tree `Transformer.init` builds in the reference, as a
nested dict of numpy arrays (e.g. `jax.tree.map(np.asarray, params)`):

    embed/embedding                         → embed.weight
    layer_{i}/attention/{q,k,v,o}_proj/kernel → layers.{i}.attention.*.weight
    layer_{i}/{attention,mlp}_norm/scale    → layers.{i}.*_norm.scale
    layer_{i}/mlp/{gate,up,down}_proj/kernel → layers.{i}.mlp.*.weight
    final_norm/scale, lm_head/kernel        → final_norm.scale, lm_head.weight
    .../lora_a, .../lora_b (lora_rank > 0)  → the same names, as they are

Flax Dense kernels are [in, out] and nn.Linear weights [out, in], so each
kernel is transposed (the inverse of `models/convert_hf.py` there). The
LoRA factors keep the reference's orientation in `LoRADense`.
"""

from __future__ import annotations

import numpy as np
import torch

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(sd: dict, prefix: str, node: dict) -> None:
    sd[f"{prefix}.weight"] = _tensor(node["kernel"]).T.contiguous()
    for name in ("lora_a", "lora_b"):
        if name in node:
            sd[f"{prefix}.{name}"] = _tensor(node[name])


def params_from_jax(params_np: dict, cfg) -> dict[str, torch.Tensor]:
    """Nested numpy param dict (optionally wrapped as {"params": ...}) →
    float32 CPU state_dict for `Transformer(cfg)`; `load_state_dict` casts
    it to the model's dtype and device."""
    p = params_np.get("params", params_np)
    sd: dict[str, torch.Tensor] = {"embed.weight": _tensor(p["embed"]["embedding"])}
    for i in range(cfg.n_layers):
        layer = p[f"layer_{i}"]
        pre = f"layers.{i}"
        for name in _ATTN:
            _dense(sd, f"{pre}.attention.{name}", layer["attention"][name])
        for name in _MLP:
            _dense(sd, f"{pre}.mlp.{name}", layer["mlp"][name])
        for norm in ("attention_norm", "mlp_norm"):
            sd[f"{pre}.{norm}.scale"] = _tensor(layer[norm]["scale"])
    sd["final_norm.scale"] = _tensor(p["final_norm"]["scale"])
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _tensor(p["lm_head"]["kernel"]).T.contiguous()
    return sd
