"""Decoder-only transformer (Llama family), counterpart of
`polyaxon_tpu/models/transformer.py`.

RMSNorm + RoPE + grouped-query attention + SwiGLU, optional LoRA on the
projections and tied embeddings. Two attention paths, as in the reference:

- the full-sequence forward (`cache=None`): rope at positions 0..S-1, then
  `ops.attention.dot_product_attention` with the config's backend (the
  flash kernel on the card under `attention: flash`, or `auto` past 2048);
- the dense-KV-cache decode (`cache=` from `make_cache`): prefill (S > 1)
  or one step (S == 1) at the scalar write position `pos`, with optional
  left-pad widths `pad`, attending the grouped cache by einsum.

Training mode is `module.train()`: it turns on dropout (`dropout_rate`,
after the attention and after the MLP of each block, as the reference
applies it), drawn from the `dropout_generator` handed to `forward`.
`fused_lm_loss` / `fused_loss_chunk` are read by the model bundle's fused
loss (`models/registry.py`), with `forward(return_features=True)`.

Config fields this port does not serve yet raise NotImplementedError
instead of being ignored: n_experts, pipeline_stages, quant,
adapter_slots, scan_layers, the config key draft, and the paged / per-row
/ shared-prefix decode arguments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from ..ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    hidden_dim: Optional[int] = None  # default 8/3 * dim rounded up to 128
    seq_len: int = 512
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dropout_rate: float = 0.0
    attention: str = "auto"  # auto | xla | flash (ring | ulysses: not ported)
    attention_block: int = 512  # kv block size handed to the flash backend
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ()  # projection names; empty = all projections
    quant: str = "none"  # not ported: must stay "none"
    adapter_slots: int = 0  # not ported: must stay 0
    tie_embeddings: bool = False
    scan_layers: bool = False  # not ported: must stay False
    n_experts: int = 0  # not ported: must stay 0
    pipeline_stages: int = 0  # not ported: must stay <= 1
    # fuse the lm head into the loss (ops/losses.fused_linear_masked_lm):
    # the [B,S,V] logits never exist
    fused_lm_loss: bool = False
    fused_loss_chunk: int = 8192

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.hidden_dim:
            return self.hidden_dim
        h = int(8 * self.dim / 3)
        return ((h + 127) // 128) * 128


def check_ported(cfg: TransformerConfig) -> None:
    """Raise NotImplementedError for config fields this slice does not serve."""
    refused = {
        "n_experts": cfg.n_experts > 0,
        "pipeline_stages": cfg.pipeline_stages > 1,
        "quant": cfg.quant not in ("none", None),
        "adapter_slots": cfg.adapter_slots > 0,
        "scan_layers": bool(cfg.scan_layers),
    }
    bad = [name for name, hit in refused.items() if hit]
    if bad:
        raise NotImplementedError(
            f"TransformerConfig fields {bad} are not ported to PyTorch yet "
            "(see ROADMAP.md)"
        )


def rope_table(seq_len: int, head_dim: int, theta: float):
    """cos/sin [seq, head_dim/2] as float32 numpy, the reference's table."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    ang = np.outer(np.arange(seq_len, dtype=np.float32), freqs)
    return np.cos(ang), np.sin(ang)


def _rotate(x, c, s):
    # the reference multiplies x by the f32 table (bf16 promotes to f32) and
    # casts back once
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def apply_rope(x, cos, sin, offset: int = 0):
    """x: [B, S, H, D]. Rotates the (first-half, second-half) pairs at
    positions offset .. offset + S - 1."""
    seq = x.shape[1]
    if offset < 0 or offset + seq > cos.shape[0]:
        raise ValueError(
            f"rope positions [{offset}, {offset + seq}) outside the table "
            f"of {cos.shape[0]}"
        )
    c = cos[offset:offset + seq][None, :, None, :]
    s = sin[offset:offset + seq][None, :, None, :]
    return _rotate(x, c, s)


def apply_rope_at(x, cos, sin, positions):
    """x: [B, S, H, D]; positions: [B, S] per-row absolute positions (the
    left-padded decode path)."""
    return _rotate(x, cos[positions][:, :, None, :], sin[positions][:, :, None, :])


class RMSNorm(nn.Module):
    """Normalised in f32, multiplied by the f32 scale, cast back."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (normed * self.scale.float()).to(x.dtype)


class LoRADense(nn.Linear):
    """y = x W + (alpha / r)(x A) B with a frozen base and trainable A/B.

    `weight` is [out, in] (nn.Linear); `lora_a` [in, r] and `lora_b`
    [r, out] keep the reference's orientation. Only the single-adapter
    form (the reference's slots == 0) is ported."""

    def __init__(self, in_features, out_features, rank, alpha, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=False, device=device, dtype=dtype)
        self.rank, self.alpha = rank, alpha
        factory = dict(device=device, dtype=dtype)
        self.lora_a = nn.Parameter(torch.zeros(in_features, rank, **factory))
        self.lora_b = nn.Parameter(torch.zeros(rank, out_features, **factory))

    def forward(self, x):
        delta = (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        return super().forward(x) + (self.alpha / self.rank) * delta


def _proj(cfg: TransformerConfig, name: str, in_f: int, out_f: int, **factory):
    if cfg.lora_rank > 0 and (not cfg.lora_targets or name in cfg.lora_targets):
        return LoRADense(in_f, out_f, cfg.lora_rank, cfg.lora_alpha, **factory)
    return nn.Linear(in_f, out_f, bias=False, **factory)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, **factory):
        super().__init__()
        self.cfg = cfg
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        self.q_proj = _proj(cfg, "q_proj", cfg.dim, nh * hd, **factory)
        self.k_proj = _proj(cfg, "k_proj", cfg.dim, nkv * hd, **factory)
        self.v_proj = _proj(cfg, "v_proj", cfg.dim, nkv * hd, **factory)
        self.o_proj = _proj(cfg, "o_proj", nh * hd, cfg.dim, **factory)

    def forward(self, x, cos, sin, *, cache=None, pos: int = 0, pad=None):
        cfg = self.cfg
        B, S, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        q = self.q_proj(x).view(B, S, nh, hd)
        k = self.k_proj(x).view(B, S, nkv, hd)
        v = self.v_proj(x).view(B, S, nkv, hd)
        if cache is not None:
            return self.o_proj(self._decode(q, k, v, cos, sin, cache, pos, pad))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # GQA expansion is the dispatch's concern (flash reads grouped kv)
        out = dot_product_attention(
            q, k, v, causal=True, backend=cfg.attention,
            block_kv=cfg.attention_block,
        )
        return self.o_proj(out.reshape(B, S, nh * hd))

    def _decode(self, q, k, v, cos, sin, cache, pos, pad):
        """Dense-cache prefill (S > 1) or step (S == 1) writing slots
        [pos, pos + S). Slot s of row b holds its true position s - pad[b];
        query i attends slots <= pos + i that are not left padding."""
        cfg = self.cfg
        B, S, nh, hd = q.shape
        nkv = cfg.n_kv_heads
        cache_k, cache_v = cache
        win = cache_k.shape[1]
        if pos + S > win:
            raise ValueError(
                f"decode writes slots [{pos}, {pos + S}) past the cache of {win}"
            )
        slots = pos + torch.arange(S, device=q.device)
        if pad is None:
            q = apply_rope(q, cos, sin, offset=pos)
            k = apply_rope(k, cos, sin, offset=pos)
        else:
            # pad slots clamp to 0: their K/V never attend, only the table
            # index must stay in range
            positions = (slots[None, :] - pad[:, None]).clamp_min(0)
            q = apply_rope_at(q, cos, sin, positions)
            k = apply_rope_at(k, cos, sin, positions)
        # written in place: the reference is functional (dynamic_update_slice
        # returns a new cache); here the preallocated cache is updated where
        # it lies, so a decode step allocates no second copy
        cache_k[:, pos:pos + S] = k
        cache_v[:, pos:pos + S] = v
        # scores straight against the grouped cache; head h = kv * G + g
        G = nh // nkv
        scores = torch.einsum(
            "bqkgd,bskd->bkgqs",
            q.reshape(B, S, nkv, G, hd).float(),
            cache_k.float(),
        ).reshape(B, nh, S, win) / math.sqrt(hd)
        ar = torch.arange(win, device=q.device)
        mask = (ar[None, :] <= slots[:, None])[None, None]  # [1, 1, S, win]
        if pad is not None:
            mask = mask & (ar[None, :] >= pad[:, None])[:, None, None, :]
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum(
            "bkgqs,bskd->bqkgd", probs.reshape(B, nkv, G, S, win), cache_v
        )
        return out.reshape(B, S, nh * hd)


class FeedForward(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: TransformerConfig, **factory):
        super().__init__()
        self.gate_proj = _proj(cfg, "gate_proj", cfg.dim, cfg.ffn_dim, **factory)
        self.up_proj = _proj(cfg, "up_proj", cfg.dim, cfg.ffn_dim, **factory)
        self.down_proj = _proj(cfg, "down_proj", cfg.ffn_dim, cfg.dim, **factory)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def dropout(x, rate: float, generator=None):
    """flax nn.Dropout in training: keep each element with probability
    1 - rate and scale it by 1 / (1 - rate). The mask comes from
    `generator` (torch's default one when None); its draws differ from
    jax.random's by construction."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=factory["device"])
        self.attention = Attention(cfg, **factory)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=factory["device"])
        self.mlp = FeedForward(cfg, **factory)

    def forward(self, x, cos, sin, *, cache=None, pos: int = 0, pad=None,
                generator=None):
        rate = self.cfg.dropout_rate if self.training else 0.0
        h = self.attention(
            self.attention_norm(x), cos, sin, cache=cache, pos=pos, pad=pad
        )
        if rate:
            h = dropout(h, rate, generator)
        x = x + h
        h = self.mlp(self.mlp_norm(x))
        if rate:
            h = dropout(h, rate, generator)
        return x + h


class Transformer(nn.Module):
    """The flagship LM. Weights are `dtype` (norm scales stay f32) on
    `device`, drawn from `seed` with a torch.Generator; load the JAX
    package's weights with `models.convert.params_from_jax`."""

    def __init__(
        self,
        cfg: TransformerConfig,
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
    ):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **factory)
        self.layers = nn.ModuleList(Block(cfg, **factory) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=dev)
        self.lm_head = (
            None if cfg.tie_embeddings
            else nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **factory)
        )
        cos, sin = rope_table(cfg.seq_len, cfg.head_dim, cfg.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(dev), persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(dev), persistent=False)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.weight.dtype

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Seeded random weights: embedding N(0, 0.02), projections
        truncated-normal LeCun (std 1/sqrt(fan_in)), LoRA A N(0, 0.01) and
        B zero, norm scales one. Same distributions as the reference's
        initializers, different draws (torch.Generator vs jax.random)."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.embed.weight.normal_(0.0, 0.02, generator=gen)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                # flax lecun_normal: truncated at 2 sigma, variance-corrected
                std = mod.in_features ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(
                    mod.weight, 0.0, std, -2 * std, 2 * std, generator=gen
                )
            if isinstance(mod, LoRADense):
                mod.lora_a.normal_(0.0, 1e-2, generator=gen)
                mod.lora_b.zero_()
            if isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)

    def make_cache(self, batch: int) -> list:
        """Zeroed dense KV cache: per layer (k, v), each
        [batch, seq_len, n_kv_heads, head_dim] in the model's dtype."""
        cfg = self.cfg
        shape = (batch, cfg.seq_len, cfg.n_kv_heads, cfg.head_dim)
        return [
            (
                torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device),
            )
            for _ in range(cfg.n_layers)
        ]

    def forward(
        self,
        tokens,
        *,
        cache=None,
        pos=0,
        pad=None,
        return_features: bool = False,
        pages=None,
        kv_layout=None,
        prefix_len: int = 0,
        prefix_lens=None,
        adapter_ix=None,
        dropout_generator: Optional[torch.Generator] = None,
    ):
        """tokens [B, S] → logits [B, S, vocab] (f32 with tied embeddings,
        the model dtype otherwise), or the final-norm features [B, S, dim]
        with `return_features`.

        cache=None: the full-sequence forward. cache=make_cache(B): the
        dense-cache decode writing slots [pos, pos + S) in place; `pad` [B]
        gives left-pad widths of a left-padded prompt batch. In training
        mode dropout draws from `dropout_generator` (on the model's
        device)."""
        unported = {
            "pages": pages is not None,
            "kv_layout": kv_layout is not None,
            "prefix_len": bool(prefix_len),
            "prefix_lens": prefix_lens is not None,
            "adapter_ix": adapter_ix is not None,
            "per-row pos": torch.is_tensor(pos) and pos.ndim > 0,
        }
        bad = [name for name, hit in unported.items() if hit]
        if bad:
            raise NotImplementedError(
                f"decode arguments {bad} (paged KV, shared prefixes, tenant "
                "adapters, speculative per-row frontiers) are not ported yet "
                "(see ROADMAP.md)"
            )
        if pad is not None and cache is None:
            raise ValueError(
                "pad (left-pad widths) only applies to the KV-cache decode path"
            )
        S = tokens.shape[1]
        if cache is None and S > self.cfg.seq_len:
            raise ValueError(f"sequence {S} exceeds the model's seq_len {self.cfg.seq_len}")
        pos = int(pos)
        if pad is not None:
            pad = torch.as_tensor(pad, dtype=torch.long, device=self.device)
        x = self.embed(tokens.to(self.device))
        for i, layer in enumerate(self.layers):
            x = layer(
                x, self.rope_cos, self.rope_sin,
                cache=None if cache is None else cache[i], pos=pos, pad=pad,
                generator=dropout_generator,
            )
        x = self.final_norm(x)
        if return_features:
            return x
        if self.lm_head is None:
            return F.linear(x.float(), self.embed.weight.float())
        return self.lm_head(x)


PRESETS: dict[str, dict] = {
    "tiny": dict(
        dim=256, n_layers=4, n_heads=8, n_kv_heads=4, vocab_size=4096, seq_len=256
    ),
    "llama3-8b": dict(
        dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, hidden_dim=14336,
        vocab_size=128256, seq_len=8192, rope_theta=500000.0,
    ),
    "llama3-1b": dict(
        dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, hidden_dim=8192,
        vocab_size=128256, seq_len=8192, rope_theta=500000.0,
    ),
}


def _make_config(config: dict) -> TransformerConfig:
    """Polyaxonfile model config → TransformerConfig, with the reference's
    aliases: variant → preset, max_len → seq_len, lora: {rank, alpha,
    targets} → lora_* fields. The reference's speculative `draft` model is
    not ported and raises NotImplementedError when set; other keys outside
    TransformerConfig are dropped, as the reference drops them."""
    config = dict(config)
    if config.get("draft"):
        raise NotImplementedError(
            "model config key 'draft' (speculative draft model) is not "
            "ported to PyTorch yet (see ROADMAP.md)"
        )
    variant = config.pop("variant", None)
    if variant is not None:
        config.setdefault("preset", f"llama3-{str(variant).lower()}")
    if "max_len" in config:
        config.setdefault("seq_len", config.pop("max_len"))
    lora = config.pop("lora", None)
    if isinstance(lora, dict):
        config.setdefault("lora_rank", int(lora.get("rank", 8)))
        config.setdefault("lora_alpha", float(lora.get("alpha", 16.0)))
        if lora.get("targets"):
            config.setdefault("lora_targets", tuple(lora["targets"]))
    preset = config.pop("preset", None)
    if preset is not None and preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; known: {sorted(PRESETS)}")
    base: dict = dict(PRESETS.get(preset, {}))
    base.update({k: v for k, v in config.items() if v is not None})
    fields = {f.name for f in dataclasses.fields(TransformerConfig)}
    return TransformerConfig(**{k: v for k, v in base.items() if k in fields})
