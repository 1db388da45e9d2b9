"""HuggingFace Llama checkpoints ↔ the port's `Transformer`, counterpart of
`polyaxon_tpu/models/convert_hf.py`.

    cfg, state = from_hf_llama(hf_model)        # a LlamaForCausalLM, or
    cfg, state = from_hf_llama(state_dict, config=hf_config)
    bundle = build_model("transformer_lm", cfg)
    bundle.module.load_state_dict(state)

HF's weights are [out, in] like `nn.Linear`'s, so the mapping only renames
(the reference transposes into flax's [in, out]); HF's `rotate_half` pairs
are the port's first/second-half rope pairs. The model or state dict is
read by duck typing (`.config`, `.state_dict()`, tensors or arrays): this
module never imports `transformers`. Only the Llama family is supported;
Mistral/Qwen-style variants with the same block structure pass too.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


class HFConversionError(ValueError):
    pass


def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(t, dtype=np.float32, copy=True))


def _names(n_layers: int, tie: bool):
    """(port name, HF name) of every weight."""
    yield "embed.weight", "model.embed_tokens.weight"
    yield "final_norm.scale", "model.norm.weight"
    if not tie:
        yield "lm_head.weight", "lm_head.weight"
    for i in range(n_layers):
        pre, hf = f"layers.{i}", f"model.layers.{i}"
        yield f"{pre}.attention_norm.scale", f"{hf}.input_layernorm.weight"
        yield f"{pre}.mlp_norm.scale", f"{hf}.post_attention_layernorm.weight"
        for name in _ATTN:
            yield f"{pre}.attention.{name}.weight", f"{hf}.self_attn.{name}.weight"
        for name in _MLP:
            yield f"{pre}.mlp.{name}.weight", f"{hf}.mlp.{name}.weight"


def from_hf_llama(hf_model, *, config=None) -> tuple[dict[str, Any], dict]:
    """(model_config, state_dict) from a transformers Llama-family model, or
    from its state dict with `config` (the HF config object or a dict).

    `model_config` feeds `build_model("transformer_lm", model_config)`;
    `state_dict` is the matching float32 CPU state dict."""
    if config is None:
        hf_cfg, sd = hf_model.config, hf_model.state_dict()
    else:
        hf_cfg, sd = config, hf_model

    def field(name, default=None):
        if isinstance(hf_cfg, dict):
            return hf_cfg.get(name, default)
        return getattr(hf_cfg, name, default)

    dim = int(field("hidden_size"))
    n_heads = int(field("num_attention_heads"))
    n_kv = int(field("num_key_value_heads") or n_heads)
    head_dim = int(field("head_dim") or dim // n_heads)
    if head_dim * n_heads != dim:
        raise HFConversionError(
            f"unsupported geometry: head_dim {head_dim} x n_heads {n_heads} "
            f"!= hidden_size {dim} (this framework derives head_dim from dim)"
        )
    tie = bool(field("tie_word_embeddings", False))
    cfg = {
        "dim": dim,
        "n_layers": int(field("num_hidden_layers")),
        "n_heads": n_heads,
        "n_kv_heads": n_kv,
        "hidden_dim": int(field("intermediate_size")),
        "vocab_size": int(field("vocab_size")),
        "seq_len": int(field("max_position_embeddings")),
        "rope_theta": float(field("rope_theta", 10000.0) or 10000.0),
        "norm_eps": float(field("rms_norm_eps")),
        "tie_embeddings": tie,
    }
    state = {}
    for ours, theirs in _names(cfg["n_layers"], tie):
        if theirs not in sd:
            raise HFConversionError(
                f"state dict has no {theirs!r} — not a Llama-family checkpoint? "
                f"(keys look like: {sorted(sd)[:3]} …)"
            )
        state[ours] = _f32(sd[theirs])
    return cfg, state


def merge_lora(state_dict: dict, *, alpha: float = 16.0) -> dict:
    """Fold LoRA deltas into their base weights: every projection with
    `lora_a` [in, r] / `lora_b` [r, out] becomes a plain `weight`
    W + (alpha / r)(A B)^T and the LoRA entries are dropped. The merged
    state loads into a `lora_rank: 0` model (and exports to HF through
    `to_hf_llama_state_dict`). `alpha` must match the training config's
    `lora_alpha`; the rank is read off `lora_a`."""
    out = {}
    for name, value in state_dict.items():
        if name.endswith((".lora_a", ".lora_b")):
            continue
        prefix = name[: -len(".weight")] if name.endswith(".weight") else None
        if prefix is not None and f"{prefix}.lora_a" in state_dict:
            a = _f32(state_dict[f"{prefix}.lora_a"])
            b = _f32(state_dict[f"{prefix}.lora_b"])
            merged = _f32(value) + (float(alpha) / a.shape[1]) * (a @ b).T
            out[name] = merged.to(value.dtype) if isinstance(value, torch.Tensor) else merged
        else:
            out[name] = value
    return out


def to_hf_llama_state_dict(cfg: dict, state_dict: dict) -> dict:
    """Inverse of `from_hf_llama`: the port's (config, state_dict) → an HF
    Llama state dict of float32 CPU tensors ([out, in] as HF keeps them),
    for `hf_model.load_state_dict(...)`."""
    return {
        theirs: _f32(state_dict[ours])
        for ours, theirs in _names(int(cfg["n_layers"]), bool(cfg.get("tie_embeddings")))
    }
