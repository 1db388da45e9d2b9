"""Decoder-only transformer (Llama family), counterpart of
`polyaxon_tpu/models/transformer.py`.

RMSNorm + RoPE + grouped-query attention + SwiGLU, optional LoRA on the
projections and tied embeddings. Two attention paths, as in the reference:

- the full-sequence forward (`cache=None`): rope at positions 0..S-1, then
  `ops.attention.dot_product_attention` with the config's backend (the
  flash kernel on the card under `attention: flash`, or `auto` past 2048);
- the KV-cache decode: prefill (S > 1) or one step (S == 1) writing slots
  [pos, pos + S) in place and attending the grouped cache by einsum, with
  scores in f32. The cache is either dense (`make_cache`: [B, seq_len]
  slots per row; `pos` a scalar, or per row [B] with `pad`) or the paged
  pool (`models.generate.make_paged_cache`: [pool_pages, page_tokens]
  slots shared by all rows, addressed through the page tables `pages`
  [B, n_pages]). Left-pad widths `pad` [B] mask a left-padded batch; a
  shared prefix of `prefix_len` slots (or per row, `prefix_lens` [B]) sits
  before each row's pad. The decode's index and mask plan is made once
  per forward (`_decode_plan`) and shared by every layer. An int8 pool
  (`kv_quant="int8"`) holds int8 payloads plus one f32 scale per (slot, kv
  head): K/V are quantized on write (`models.quant.quantize_kv`) and
  dequantized after the page gather, as the reference does.

`quant="int8"` (set by `models.quant.quantize_module` at serving load)
swaps every projection for `models.quant.Int8Linear` (int8 weight and
per-output-channel scale through the int8 kernel), or `Int8LoRALinear`
where LoRA applies. q/k/v and gate/up, each read from one input, then
run as one grouped int8 launch (`models.quant.project`): 4 launches a
layer instead of 7.

Multi-tenant serving (`adapter_slots > 0`, set by
`serving.adapters.stack_adapter_params` at load) stacks every LoRA pair to
[slots, ...]; the decode argument `adapter_ix` [B] picks each row's slot
(slot 0, the checkpoint's own adapter, when it is None), so one batch mixes
tenants (`models/lora.py`). The int8 projections keep their grouped launch
and add each row's delta after it.

`n_experts > 0` swaps each block's SwiGLU for `models.moe.MoEFeedForward`
(top-1 switch routing, `capacity_factor`, the sown balance loss) under the
name `moe`, on every path the dense model has: the forward, training and
the dense-KV `generate` (prefill and each decode step route their own
tokens, as the reference's decode does). The paged pool and int8
projections refuse it (NotImplementedError, see ROADMAP.md), and so does
every serving path but the per-request one (`serving/server.py`).

Training mode is `module.train()`: it turns on dropout (`dropout_rate`,
after the attention and after the MLP of each block, as the reference
applies it), drawn from the `dropout_generator` handed to `forward`.
`fused_lm_loss` / `fused_loss_chunk` are read by the model bundle's fused
loss (`models/registry.py`), with `forward(return_features=True)`.

Config fields this port does not serve yet raise NotImplementedError
instead of being ignored: pipeline_stages and scan_layers.
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
from .layers import dropout
from .lora import lora_delta, run_proj
from .moe import MoEFeedForward
from .quant import Int8Linear, Int8LoRALinear, dequantize_kv, project, quantize_kv


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
    # weight-only int8 projections for serving ("none" | "int8"); set by
    # models.quant.quantize_module at load, not a training config
    quant: str = "none"
    # multi-tenant serving: > 0 stacks every LoRA A/B pair to [slots, ...]
    # and each row gathers its adapter by `adapter_ix`; slot 0 is the
    # checkpoint's own adapter. Set by serving.adapters.stack_adapter_params
    # at load, not a training config
    adapter_slots: int = 0
    tie_embeddings: bool = False
    scan_layers: bool = False  # not ported: must stay False
    # MoE: replace the dense FFN with n_experts switch-routed experts
    n_experts: int = 0
    capacity_factor: float = 1.25
    pipeline_stages: int = 0  # not ported: must stay <= 1
    # the speculative draft model's overrides of this config
    # (models/draft.py), a sorted (key, value) tuple; () = the defaults
    draft: tuple = ()
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
    if cfg.quant not in ("none", "int8"):
        raise ValueError(f"quant must be 'none' or 'int8', got {cfg.quant!r}")
    refused = {
        "pipeline_stages": cfg.pipeline_stages > 1,
        "scan_layers": bool(cfg.scan_layers),
        "n_experts with quant='int8'": cfg.n_experts > 0 and cfg.quant == "int8",
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
    [r, out] keep the reference's orientation. With `slots > 0` they are
    [slots, in, r] and [slots, r, out], and each row of x gathers its slot
    by `adapter_ix` (`models/lora.py`)."""

    def __init__(self, in_features, out_features, rank, alpha, slots: int = 0,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=False, device=device, dtype=dtype)
        self.rank, self.alpha, self.slots = rank, alpha, slots
        factory = dict(device=device, dtype=dtype)
        lead = (slots,) if slots > 0 else ()
        self.lora_a = nn.Parameter(torch.zeros(*lead, in_features, rank, **factory))
        self.lora_b = nn.Parameter(torch.zeros(*lead, rank, out_features, **factory))

    def forward(self, x, adapter_ix=None):
        delta = lora_delta(x, self.lora_a, self.lora_b, adapter_ix)
        return super().forward(x) + (self.alpha / self.rank) * delta


def _proj(cfg: TransformerConfig, name: str, in_f: int, out_f: int, **factory):
    int8 = cfg.quant == "int8"
    if cfg.lora_rank > 0 and (not cfg.lora_targets or name in cfg.lora_targets):
        lora = Int8LoRALinear if int8 else LoRADense
        return lora(in_f, out_f, cfg.lora_rank, cfg.lora_alpha,
                    slots=cfg.adapter_slots, **factory)
    if int8:
        return Int8Linear(in_f, out_f, **factory)
    return nn.Linear(in_f, out_f, bias=False, **factory)


def _per_row(pos) -> bool:
    """True for per-row write frontiers ([B] tensor or array), False for
    one scalar position."""
    return getattr(pos, "ndim", 0) >= 1 or isinstance(pos, (list, tuple))


@dataclasses.dataclass
class _DecodePlan:
    """Where one decode forward writes and what each query may read: built
    once per forward by `Transformer._decode_plan`, shared by every layer.

    `offset` (scalar write position, no pad) or `positions` [B, S] give the
    rope positions. The write goes to `cache[:, offset:offset + S]` (dense,
    scalar pos) or to the rows `write` of the cache flattened to slots
    ([pool_pages * page_tokens] or [B * seq_len], one index per kept
    (b, s) in row-major order), restricted to the [B * S] mask `keep` when
    some slots fall past the cache or the row's table (those are dropped).
    `pages` [B, n_pages] gathers a row's window out of the pool; `win`
    slots are read, and `mask` [B or 1, 1, S, win] says which are live.
    `kv_int8`: the pool holds int8 payloads and f32 scales."""

    S: int
    win: int
    mask: torch.Tensor
    offset: Optional[int] = None
    positions: Optional[torch.Tensor] = None
    write: Optional[torch.Tensor] = None
    keep: Optional[torch.Tensor] = None
    pages: Optional[torch.Tensor] = None
    kv_int8: bool = False


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, **factory):
        super().__init__()
        self.cfg = cfg
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        self.q_proj = _proj(cfg, "q_proj", cfg.dim, nh * hd, **factory)
        self.k_proj = _proj(cfg, "k_proj", cfg.dim, nkv * hd, **factory)
        self.v_proj = _proj(cfg, "v_proj", cfg.dim, nkv * hd, **factory)
        self.o_proj = _proj(cfg, "o_proj", nh * hd, cfg.dim, **factory)

    def forward(self, x, cos, sin, *, cache=None, plan: Optional[_DecodePlan] = None,
                adapter_ix=None):
        cfg = self.cfg
        B, S, _ = x.shape
        hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        q, k, v = project(x, (self.q_proj, self.k_proj, self.v_proj), adapter_ix)
        q = q.view(B, S, nh, hd)
        k = k.view(B, S, nkv, hd)
        v = v.view(B, S, nkv, hd)
        if cache is not None:
            return run_proj(self.o_proj, self._decode(q, k, v, cos, sin, cache, plan),
                            adapter_ix)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # GQA expansion is the dispatch's concern (flash reads grouped kv)
        out = dot_product_attention(
            q, k, v, causal=True, backend=cfg.attention,
            block_kv=cfg.attention_block,
        )
        return run_proj(self.o_proj, out.reshape(B, S, nh * hd), adapter_ix)

    def _decode(self, q, k, v, cos, sin, cache, plan: _DecodePlan):
        """Prefill (S > 1) or step (S == 1): rope, write this call's K/V
        into the cache in place, then attend the plan's window. Slot s of
        row b holds its true position s - pad[b]."""
        B, S, nh, hd = q.shape
        nkv = self.cfg.n_kv_heads
        if plan.positions is None:
            q = apply_rope(q, cos, sin, offset=plan.offset)
            k = apply_rope(k, cos, sin, offset=plan.offset)
        else:
            q = apply_rope_at(q, cos, sin, plan.positions)
            k = apply_rope_at(k, cos, sin, plan.positions)
        if plan.kv_int8:
            k_all, v_all = self._int8_pool(k, v, cache, plan)
            return self._attend(q, k_all, v_all, plan)
        cache_k, cache_v = cache
        # written in place: the reference is functional (it returns a new
        # cache, or donates the pool into its compiled program); here the
        # preallocated cache or pool is updated where it lies
        if plan.write is None:
            pos = plan.offset
            cache_k[:, pos:pos + S] = k
            cache_v[:, pos:pos + S] = v
            k_all, v_all = cache_k, cache_v
        else:
            k_rows, v_rows = k.reshape(B * S, nkv, hd), v.reshape(B * S, nkv, hd)
            if plan.keep is not None:  # slots past the table or the cache are dropped
                k_rows, v_rows = k_rows[plan.keep], v_rows[plan.keep]
            cache_k.view(-1, nkv, hd).index_copy_(0, plan.write, k_rows)
            cache_v.view(-1, nkv, hd).index_copy_(0, plan.write, v_rows)
            if plan.pages is None:
                k_all, v_all = cache_k, cache_v
            else:
                # the row's whole window out of the pool; unallocated tail
                # entries alias the scratch page, masked dead below
                rows = plan.pages.reshape(-1)
                k_all = cache_k.index_select(0, rows).view(B, plan.win, nkv, hd)
                v_all = cache_v.index_select(0, rows).view(B, plan.win, nkv, hd)
        return self._attend(q, k_all, v_all, plan)

    def _int8_pool(self, k, v, cache, plan: _DecodePlan):
        """The int8 pool's write and read: quantize this call's K/V per
        (slot, kv head), write payloads and scales through the page tables,
        then gather the rows' windows and dequantize them to k's dtype. The
        fresh slots are read back dequantized like the history, so a slot
        has one value whichever path wrote it."""
        B, S, nkv, hd = k.shape
        pool_k, pool_v, pool_ks, pool_vs = cache
        rows = plan.pages.reshape(-1)
        out = []
        for x, pool, pool_s in ((k, pool_k, pool_ks), (v, pool_v, pool_vs)):
            xq, xs = quantize_kv(x.reshape(B * S, nkv, hd))
            if plan.keep is not None:  # slots past the table are dropped
                xq, xs = xq[plan.keep], xs[plan.keep]
            pool.view(-1, nkv, hd).index_copy_(0, plan.write, xq)
            pool_s.view(-1, nkv).index_copy_(0, plan.write, xs)
            out.append(dequantize_kv(
                pool.index_select(0, rows).view(B, plan.win, nkv, hd),
                pool_s.index_select(0, rows).view(B, plan.win, nkv),
                x.dtype,
            ))
        return out

    def _attend(self, q, k_all, v_all, plan: _DecodePlan):
        """Masked softmax attention of q [B, S, nh, hd] over the window
        k_all/v_all [B, win, nkv, hd], scores in f32."""
        B, S, nh, hd = q.shape
        nkv = self.cfg.n_kv_heads
        # scores straight against the grouped cache; head h = kv * G + g
        G = nh // nkv
        scores = torch.einsum(
            "bqkgd,bskd->bkgqs",
            q.reshape(B, S, nkv, G, hd).float(),
            k_all.float(),
        ).reshape(B, nh, S, plan.win) / math.sqrt(hd)
        scores.masked_fill_(~plan.mask, -1e30)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum(
            "bkgqs,bskd->bqkgd", probs.reshape(B, nkv, G, S, plan.win), v_all
        )
        return out.reshape(B, S, nh * hd)


class FeedForward(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: TransformerConfig, **factory):
        super().__init__()
        self.gate_proj = _proj(cfg, "gate_proj", cfg.dim, cfg.ffn_dim, **factory)
        self.up_proj = _proj(cfg, "up_proj", cfg.dim, cfg.ffn_dim, **factory)
        self.down_proj = _proj(cfg, "down_proj", cfg.ffn_dim, cfg.dim, **factory)

    def forward(self, x, adapter_ix=None):
        gate, up = project(x, (self.gate_proj, self.up_proj), adapter_ix)
        return run_proj(self.down_proj, F.silu(gate) * up, adapter_ix)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.attention_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=factory["device"])
        self.attention = Attention(cfg, **factory)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.norm_eps, device=factory["device"])
        if cfg.n_experts > 0:
            self.moe = MoEFeedForward(cfg.dim, cfg.ffn_dim, cfg.n_experts,
                                      capacity_factor=cfg.capacity_factor, **factory)
        else:
            self.mlp = FeedForward(cfg, **factory)

    def forward(self, x, cos, sin, *, cache=None, plan=None, generator=None,
                adapter_ix=None):
        rate = self.cfg.dropout_rate if self.training else 0.0
        h = self.attention(self.attention_norm(x), cos, sin, cache=cache, plan=plan,
                           adapter_ix=adapter_ix)
        if rate:
            h = dropout(h, rate, generator)
        x = x + h
        if self.cfg.n_experts > 0:
            h = self.moe(self.mlp_norm(x), generator)
        else:
            h = self.mlp(self.mlp_norm(x), adapter_ix)
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
        """Seeded random weights: embedding N(0, 0.02), projections (and the
        MoE router and expert kernels) truncated-normal LeCun (std
        1/sqrt(fan_in)), LoRA A N(0, 0.01) and B zero, norm scales one. Same distributions as the reference's
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
            if isinstance(mod, MoEFeedForward):
                mod.reset_with(gen)

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

        cache=None: the full-sequence forward. Otherwise the KV-cache
        decode writing slots [pos, pos + S) in place:
        - cache=make_cache(B): the dense cache; `pos` an int, or [B] per-row
          write frontiers (with `pad`);
        - cache=make_paged_cache(module, layout) with `pages` [B, n_pages]
          (and `kv_layout`, the pool's PagedKVLayout): the paged pool; `pos`
          an int or [B].
        `pad` [B] gives left-pad widths; with a shared prefix, `prefix_len`
        (or per row `prefix_lens` [B]) slots before the pad are live for
        every query. `adapter_ix` [B] gives each row's adapter slot on a
        slot-stacked model (`adapter_slots > 0`; None = slot 0 for all
        rows). In training mode dropout draws from `dropout_generator` (on
        the model's device)."""
        if adapter_ix is not None:
            if self.cfg.adapter_slots <= 0:
                raise ValueError(
                    "adapter_ix needs a slot-stacked model (adapter_slots > 0 "
                    "— serving.adapters.stack_adapter_params)"
                )
            adapter_ix = torch.as_tensor(adapter_ix, dtype=torch.long).to(self.device)
            if adapter_ix.shape != tokens.shape[:1]:
                raise ValueError(
                    f"adapter_ix must be [B]={tokens.shape[0]}, got "
                    f"{tuple(adapter_ix.shape)}"
                )
        if cache is None:
            misplaced = {
                "pad": pad is not None, "pages": pages is not None,
                "kv_layout": kv_layout is not None,
                "prefix_len": bool(prefix_len),
                "prefix_lens": prefix_lens is not None,
                "per-row pos": _per_row(pos),
            }
            bad = [name for name, hit in misplaced.items() if hit]
            if bad:
                raise ValueError(
                    f"{bad} (pad: left-pad widths, and the paged / per-row "
                    "arguments) only apply to the KV-cache decode path"
                )
        S = tokens.shape[1]
        if cache is None and S > self.cfg.seq_len:
            raise ValueError(f"sequence {S} exceeds the model's seq_len {self.cfg.seq_len}")
        plan = None
        if cache is not None:
            plan = self._decode_plan(
                S, cache, pos, pad, pages, kv_layout, prefix_len, prefix_lens
            )
        x = self.embed(tokens.to(self.device))
        for i, layer in enumerate(self.layers):
            x = layer(
                x, self.rope_cos, self.rope_sin,
                cache=None if cache is None else cache[i], plan=plan,
                generator=dropout_generator, adapter_ix=adapter_ix,
            )
        x = self.final_norm(x)
        if return_features:
            return x
        if self.lm_head is None:
            return F.linear(x.float(), self.embed.weight.float())
        return self.lm_head(x)

    def _decode_plan(self, S, cache, pos, pad, pages, kv_layout, prefix_len,
                     prefix_lens) -> _DecodePlan:
        """The write indices, rope positions and attention mask of one
        decode forward, from the reference's slot grid
        (`polyaxon_tpu/models/transformer.py:366-521`).

        Where the reference drops out-of-range writes (`mode="drop"` and a
        fill page id past the pool), torch's indexing would raise instead,
        so those slots are masked out of the write (`keep`), never clamped
        onto a live page. The dense window is the whole cache, as in the
        reference: a query whose every slot is masked (a left-pad query)
        then averages the same slots on both sides."""
        dev = self.device
        paged = pages is not None
        if paged != (kv_layout is not None):
            raise ValueError("pages and kv_layout go together (the paged pool)")
        kv_int8 = paged and kv_layout.kv_quant == "int8"
        if len(cache[0]) != (4 if kv_int8 else 2):
            raise ValueError(
                "an int8 pool holds (k, v, k_scale, v_scale) per layer and an "
                "fp cache (k, v): use models.generate.make_paged_cache for the "
                f"pool of {kv_layout}"
            )
        shape = tuple(cache[0][0].shape)
        if paged:
            if self.cfg.n_experts > 0:
                raise NotImplementedError(
                    "the paged KV pool with an MoE model (n_experts > 0) is not "
                    "ported to PyTorch yet (see ROADMAP.md)"
                )
            if shape[:2] != (kv_layout.pool_pages, kv_layout.page_tokens):
                raise ValueError(
                    f"pages need the pool of {kv_layout} (models.generate."
                    f"make_paged_cache); got a cache of {shape}"
                )
            pages = torch.as_tensor(pages, dtype=torch.long, device=dev)
        else:
            if shape[1] != self.cfg.seq_len:
                raise ValueError(
                    f"a dense decode needs the cache of make_cache; got {shape}"
                )
            if prefix_len or prefix_lens is not None:
                raise ValueError("prefix_len / prefix_lens need the paged pool (pages)")
        if pad is not None:
            pad = torch.as_tensor(pad, dtype=torch.long, device=dev)
        per_row = _per_row(pos)
        if per_row:
            if pad is None:
                raise ValueError("per-row pos needs pad (bucketed-row decode)")
            if torch.is_tensor(pos):
                hi = int(pos.max()) + S
                pos_t = pos.to(device=dev, dtype=torch.long)
            else:
                pos_np = np.asarray(pos, dtype=np.int64).reshape(-1)
                hi = int(pos_np.max()) + S
                pos_t = torch.from_numpy(pos_np).to(dev)
            row_slots = pos_t[:, None] + torch.arange(S, device=dev)[None, :]
        else:
            pos = int(pos)
            hi = pos + S
            row_slots = pos + torch.arange(S, device=dev)[None, :]  # [1, S]
        B = pages.shape[0] if paged else shape[0]
        # a verify window's rejected tail may run past the rope table near
        # the end of the cache: those slots are dropped and their logits never
        # committed, so their positions only need to stay in range
        positions = None if pad is None else (
            (row_slots - pad[:, None]).clamp(0, self.cfg.seq_len - 1)
        )
        offset = None if per_row else pos
        if paged:
            pt, n_pages = kv_layout.page_tokens, pages.shape[1]
            win = n_pages * pt
            slots = row_slots.expand(B, S)
            page_ix = slots // pt
            keep = None if hi <= win else page_ix < n_pages
            write = torch.gather(pages, 1, page_ix.clamp(max=n_pages - 1)) * pt + slots % pt
        elif per_row:
            win = self.cfg.seq_len
            keep = None if hi <= win else row_slots < win
            write = torch.arange(B, device=dev)[:, None] * win + row_slots.clamp(max=win - 1)
        else:
            if hi > self.cfg.seq_len:
                raise ValueError(
                    f"decode writes slots [{pos}, {hi}) past the cache of {self.cfg.seq_len}"
                )
            win, keep, write = self.cfg.seq_len, None, None
        if write is not None:
            write = write.reshape(-1)
            if keep is not None:
                keep = keep.reshape(-1)
                write = write[keep]
        ar = torch.arange(win, device=dev)
        mask = ar[None, None, :] <= row_slots[:, :, None]  # [B | 1, S, win]
        if pad is not None:
            if prefix_lens is not None:
                # per-row prefix boundary: [prefix | dead pad | own tokens]
                pl = torch.as_tensor(prefix_lens, dtype=torch.long, device=dev)[:, None]
                valid = (ar[None, :] < pl) | (ar[None, :] >= pl + pad[:, None])
            elif prefix_len:
                valid = (ar[None, :] < prefix_len) | (
                    ar[None, :] >= prefix_len + pad[:, None]
                )
            else:  # left-pad slots are dead for every query of that row
                valid = ar[None, :] >= pad[:, None]
            mask = mask & valid[:, None, :]
        return _DecodePlan(
            S=S, win=win, mask=mask[:, None], offset=offset, positions=positions,
            write=write, keep=keep, pages=pages if paged else None, kv_int8=kv_int8,
        )


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
    targets} → lora_* fields, and the `draft:` sub-config (overrides for the
    speculative draft model) normalized to a sorted (key, value) tuple.
    Other keys outside TransformerConfig are dropped, as the reference
    drops them."""
    config = dict(config)
    draft = config.pop("draft", None)
    if draft:
        if hasattr(draft, "items"):
            draft = sorted(
                (str(k), tuple(v) if isinstance(v, list) else v)
                for k, v in draft.items()
            )
        config["draft"] = tuple(draft)
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
