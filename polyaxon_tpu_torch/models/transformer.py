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
name `moe`, on every path the dense model has: the forward, training, the
dense and paged KV decode and every serving path. As in the reference the
experts see no pad mask and take their capacity per row from the S of each
forward (a bucket's width, a prefill chunk, a verify window), so a served
row routes as the reference's server routes it. `adapter_ix` reaches the
attention only; int8 quantizes the attention projections and leaves the
router and the experts at checkpoint precision (`models/quant.py`).

Training mode is `module.train()`: it turns on dropout (`dropout_rate`,
after the attention and after the MLP of each block, as the reference
applies it), drawn from the `dropout_generator` handed to `forward`.
`fused_lm_loss` / `fused_loss_chunk` are read by the model bundle's fused
loss (`models/registry.py`), with `forward(return_features=True)`.

Under the trainer's mesh (`parallel/`, bound by `parallel.ring.
set_current_mesh`) the full-sequence forward runs on the rank's shards:
the batch over the batch axes, the sequence over `context` (RoPE at the
chunk's global positions), and Megatron tensor parallelism over `model`
when the trainer hands the forward its `model` slices of the projections
(`TRANSFORMER_RULES`, `TENSOR_PARALLEL`): each rank projects its own heads
and hidden units, `parallel.collectives.copy_to` enters each split block
and `reduce_from` sums its row-parallel output, and a vocabulary-split LM
head leaves the logits split for the vocab-parallel loss. The `constrain`
calls mark the reference's layout hints; on local shards they are the
identity.

`pipeline_stages > 1` replaces the block list by `PipelinedLayers`
(`pipeline.stages.*`): each block parameter stacked to [P, Lp, ...], the
reference's `pipeline/stages/...` tree. Under a mesh with a `pipeline` axis
the stages run the GPipe schedule (`parallel/pipeline.py`) over
`pipeline_microbatches` microbatches (P by default); without one (or with
one of size 1) the same weights run as a plain loop over stages and
layers, the reference's nested scan. As in the reference, the pipelined
stack refuses dropout and MoE (ValueError in `_make_config`), and the
KV-cache decode and `adapter_ix` (ValueError in `forward`).

`scan_layers: true` (without pipeline stages, which take precedence as in
the reference) replaces the block list by `ScannedLayers` (`scan.block.*`):
one `Block` whose parameters and buffers carry a leading [n_layers] dim,
the reference's `layers/block/...` tree of `nn.scan`, run as a loop over
its slices through the same `functional_call` runner as the pipelined
stack (`StackedBlocks`). It computes what the per-layer stack computes,
bit for bit from the same weights (`stack_layers`): dropout draws from
the one generator in layer order and each layer sows its MoE loss, which
the trainer sums. The decode caches keep the per-layer layout of
`make_cache` and `models.generate.make_paged_cache` (a list over the
layers, not the reference's stacked [n_layers, ...] cache leaves).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.nn import functional as F

from ..device import resolve_device
from ..ops.attention import dot_product_attention
from ..parallel.collectives import (
    all_gather_cat, axis_group, axis_index, copy_to, reduce_from,
)
from ..parallel.mesh import axis_sizes, batch_rows, is_decode_mesh
from ..parallel.ring import current_mesh
from ..parallel.ring import model_group as _model_group
from ..parallel.sharding import constrain
from .layers import dropout, rank_block
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
    attention: str = "auto"  # auto | xla | flash | ring | ulysses
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
    # the blocks' weights stacked to [n_layers, ...] (ScannedLayers)
    scan_layers: bool = False
    # MoE: replace the dense FFN with n_experts switch-routed experts
    n_experts: int = 0
    capacity_factor: float = 1.25
    pipeline_stages: int = 0  # > 1: GPipe stages over the mesh's pipeline axis
    pipeline_microbatches: int = 0  # 0 = pipeline_stages
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


# the scanned stack's parameter names: SCAN_BLOCK + the Block's names
SCAN_BLOCK = "scan.block."


def scanned(cfg) -> bool:
    """True when `Transformer(cfg)` holds its blocks as `ScannedLayers`
    (`scan.block.*`): `scan_layers` without pipeline stages, which take
    precedence as in the reference."""
    return cfg.scan_layers and cfg.pipeline_stages <= 1


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


# logical axes the batch dim may be split over (constrain degrades the
# ones the live mesh lacks)
BATCH = ("batch", "data", "fsdp")


def context_offset(seq: int) -> int:
    """Global position of this rank's first token when the bound mesh
    splits the sequence over `context` (chunks of `seq` in rank order)."""
    mesh = current_mesh()
    return axis_index(mesh, "context") * seq if axis_sizes(mesh).get("context", 1) > 1 else 0


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
    # on a decode mesh with `batch` > 1: (the batch group, B), when this
    # group's rows' K/V are exchanged so that every group writes all B rows
    # (`write`/`keep` are then over all of them, the rest over its own)
    exchange: Optional[tuple] = None


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
        hd = cfg.head_dim
        # under tensor parallelism the projections hold this rank's heads
        # (training and the decode on a serving mesh alike)
        group = _model_group(self.q_proj.weight.shape[0], cfg.n_heads * hd)
        x = copy_to(x, group)
        q, k, v = project(x, (self.q_proj, self.k_proj, self.v_proj), adapter_ix)
        q = q.view(B, S, -1, hd)
        k = k.view(B, S, -1, hd)
        v = v.view(B, S, -1, hd)
        if cache is not None:
            out = self._decode(q, k, v, cos, sin, cache, plan)
            return reduce_from(run_proj(self.o_proj, out, adapter_ix), group)
        # heads on the model axis (column-parallel QKV output)
        q = constrain(q, BATCH, "context", "model", None)
        k = constrain(k, BATCH, "context", "model", None)
        v = constrain(v, BATCH, "context", "model", None)
        offset = context_offset(S)
        q = apply_rope(q, cos, sin, offset=offset)
        k = apply_rope(k, cos, sin, offset=offset)
        # GQA expansion is the dispatch's concern (flash reads grouped kv)
        out = dot_product_attention(
            q, k, v, causal=True, backend=cfg.attention,
            block_kv=cfg.attention_block,
        )
        out = constrain(out.reshape(B, S, -1), BATCH, "context", "model")
        return reduce_from(run_proj(self.o_proj, out, adapter_ix), group)

    def _decode(self, q, k, v, cos, sin, cache, plan: _DecodePlan):
        """Prefill (S > 1) or step (S == 1): rope, write this call's K/V
        into the cache in place, then attend the plan's window. Slot s of
        row b holds its true position s - pad[b]. q/k/v hold this rank's
        heads; under a plan's `exchange` this group's rows' K/V are
        gathered into all B rows before the write."""
        S, nkv, hd = q.shape[1], k.shape[2], q.shape[3]
        if plan.positions is None:
            q = apply_rope(q, cos, sin, offset=plan.offset)
            k = apply_rope(k, cos, sin, offset=plan.offset)
        else:
            q = apply_rope_at(q, cos, sin, plan.positions)
            k = apply_rope_at(k, cos, sin, plan.positions)
        if plan.exchange is not None:
            group, n = plan.exchange
            k = all_gather_cat(k, group, 0)[:n]
            v = all_gather_cat(v, group, 0)[:n]
        B = k.shape[0]  # the rows written; plan.pages holds the rows read
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
                R = plan.pages.shape[0]
                k_all = cache_k.index_select(0, rows).view(R, plan.win, nkv, hd)
                v_all = cache_v.index_select(0, rows).view(R, plan.win, nkv, hd)
        return self._attend(q, k_all, v_all, plan)

    def _int8_pool(self, k, v, cache, plan: _DecodePlan):
        """The int8 pool's write and read: quantize this call's K/V per
        (slot, kv head), write payloads and scales through the page tables,
        then gather the rows' windows and dequantize them to k's dtype. The
        fresh slots are read back dequantized like the history, so a slot
        has one value whichever path wrote it."""
        B, S, nkv, hd = k.shape
        R = plan.pages.shape[0]  # the rows read (this group's under an exchange)
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
                pool.index_select(0, rows).view(R, plan.win, nkv, hd),
                pool_s.index_select(0, rows).view(R, plan.win, nkv),
                x.dtype,
            ))
        return out

    def _attend(self, q, k_all, v_all, plan: _DecodePlan):
        """Masked softmax attention of q [B, S, nh, hd] over the window
        k_all/v_all [B, win, nkv, hd], scores in f32."""
        B, S, nh, hd = q.shape
        nkv = k_all.shape[2]
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
        self.ffn_dim = cfg.ffn_dim
        self.gate_proj = _proj(cfg, "gate_proj", cfg.dim, cfg.ffn_dim, **factory)
        self.up_proj = _proj(cfg, "up_proj", cfg.dim, cfg.ffn_dim, **factory)
        self.down_proj = _proj(cfg, "down_proj", cfg.ffn_dim, cfg.dim, **factory)

    def forward(self, x, adapter_ix=None):
        # column-parallel gate/up, row-parallel down under tensor parallelism
        group = _model_group(self.gate_proj.weight.shape[0], self.ffn_dim)
        gate, up = project(copy_to(x, group), (self.gate_proj, self.up_proj), adapter_ix)
        h = constrain(F.silu(gate) * up, BATCH, "context", "model")
        return reduce_from(run_proj(self.down_proj, h, adapter_ix), group)


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
        x = constrain(x, BATCH, "context", None)
        h = self.attention(self.attention_norm(x), cos, sin, cache=cache, plan=plan,
                           adapter_ix=adapter_ix)
        if rate:
            h = dropout(h, rate, generator, block=rank_block(h, seq=True))
        x = x + h
        if self.cfg.n_experts > 0:
            h = self.moe(self.mlp_norm(x), generator)
        else:
            h = self.mlp(self.mlp_norm(x), adapter_ix)
        if rate:
            h = dropout(h, rate, generator, block=rank_block(h, seq=True))
        return x + h


class StackedBlocks(nn.Module):
    """One `Block` whose every parameter and buffer (an int8 projection's
    payload and scales are buffers) carries the leading dims `lead`, the
    reference's stacked param tree: a layer's forward is that block called
    on its slices (`torch.func.functional_call`), so the slices' gradients
    land in the stacked parameters."""

    def _stack(self, attr: str, lead: tuple) -> None:
        """Stack the block held as `attr` to `lead` + its shapes."""
        self._attr = attr
        block = self._block
        self._names = [n for n, _ in block.named_parameters()]
        self._names += [n for n, _ in block.named_buffers()]
        for name in self._names:
            owner, _, leaf = name.rpartition(".")
            mod = block.get_submodule(owner)
            t = getattr(mod, leaf)
            new = t.detach().expand(*lead, *t.shape).clone()
            if isinstance(t, nn.Parameter):
                setattr(mod, leaf, nn.Parameter(new, requires_grad=t.requires_grad))
            else:
                mod._buffers[leaf] = new

    @property
    def _block(self) -> "Block":
        return getattr(self, self._attr)

    def stacked(self) -> dict:
        """name in the block → its stacked tensor (as it is now: a mesh's
        shards replace them)."""
        out = {}
        for name in self._names:
            owner, _, leaf = name.rpartition(".")
            out[name] = getattr(self._block.get_submodule(owner), leaf)
        return out

    def run_layer(self, params: dict, x, *args, **kwargs):
        """The block on one layer's slices `params` (name → tensor)."""
        return functional_call(self._block, params, (x, *args), kwargs)


class PipelinedLayers(StackedBlocks):
    """The block stack with stage-stacked weights [P, Lp, ...]: `stages` is
    the stacked `Block`."""

    def __init__(self, cfg: TransformerConfig, **factory):
        super().__init__()
        P = cfg.pipeline_stages
        if cfg.n_layers % P:
            raise ValueError(f"n_layers {cfg.n_layers} not divisible by pipeline_stages {P}")
        self.cfg, self.per_stage = cfg, cfg.n_layers // P
        self.stages = Block(cfg, **factory)
        self._stack("stages", (P, self.per_stage))

    def _stage(self, params: dict, h, cos, sin):
        """One stage: its Lp layers in order; `params`: name → [Lp, ...]."""
        for i in range(self.per_stage):
            h = self.run_layer({n: t[i] for n, t in params.items()}, h, cos, sin)
        return h

    def forward(self, x, cos, sin):
        stacked = self.stacked()
        group = axis_group(current_mesh(), "pipeline")
        if group is not None:
            from ..parallel.pipeline import pipeline_apply

            return pipeline_apply(
                lambda params, h: self._stage(params, h, cos, sin), stacked, x,
                group=group, stages=self.cfg.pipeline_stages,
                n_micro=self.cfg.pipeline_microbatches or self.cfg.pipeline_stages,
            )
        # no pipeline axis: the same weights as a plain loop over stages
        for s in range(self.cfg.pipeline_stages):
            x = self._stage({n: t[s] for n, t in stacked.items()}, x, cos, sin)
        return x


class ScannedLayers(StackedBlocks):
    """`scan_layers`: the reference's `nn.scan` over the blocks. `block` is
    the stacked `Block` ([n_layers, ...] on every parameter and buffer),
    run as a loop over its slices: layer i reads `caches[i]` (the decode
    caches keep the per-layer layout of `Transformer.make_cache`), every
    layer draws its dropout from the one generator in layer order and sows
    its MoE loss, so the collected losses sum over the layers."""

    def __init__(self, cfg: TransformerConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.block = Block(cfg, **factory)
        self._stack("block", (cfg.n_layers,))

    def forward(self, x, cos, sin, *, caches=None, plan=None, generator=None,
                adapter_ix=None):
        stacked = self.stacked()
        for i in range(self.cfg.n_layers):
            x = self.run_layer(
                {n: t[i] for n, t in stacked.items()}, x, cos, sin,
                cache=None if caches is None else caches[i], plan=plan,
                generator=generator, adapter_ix=adapter_ix,
            )
        return x


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
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {cfg.quant!r}")
        self.cfg = cfg
        dev = resolve_device(device)
        factory = dict(device=dev, dtype=dtype)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, **factory)
        if cfg.pipeline_stages > 1:
            self.layers = nn.ModuleList()
            self.pipeline = PipelinedLayers(cfg, **factory)
        elif scanned(cfg):
            self.layers = nn.ModuleList()
            self.scan = ScannedLayers(cfg, **factory)
        else:
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
        if self.device.type == "meta":  # shapes only: restored into (from_run)
            return
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

    @property
    def local_kv_heads(self) -> int:
        """The kv heads this module's projections hold: n_kv_heads, or this
        rank's share of them on a decode mesh."""
        if scanned(self.cfg):
            return self.scan.block.attention.k_proj.weight.shape[1] // self.cfg.head_dim
        if not len(self.layers):
            return self.cfg.n_kv_heads
        return self.layers[0].attention.k_proj.weight.shape[0] // self.cfg.head_dim

    def make_cache(self, batch: int) -> list:
        """Zeroed dense KV cache: per layer (k, v), each
        [batch, seq_len, n_kv_heads, head_dim] in the model's dtype. On a
        decode mesh (`parallel.mesh.decode_mesh`, bound by
        `set_current_mesh`) it holds this rank's kv heads and this `batch`
        group's rows of a batch of `batch`."""
        cfg = self.cfg
        mesh = current_mesh()
        if is_decode_mesh(mesh) and mesh.size(0) > 1:
            batch = batch_rows(batch, mesh.size(0), mesh.get_local_rank("batch"))[0]
        shape = (batch, cfg.seq_len, self.local_kv_heads, cfg.head_dim)
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
        all_positions: bool = False,
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
        the model's device).

        On a decode mesh (`parallel.mesh.decode_mesh` bound, this rank's
        shards from `serving.mesh.ServingWorld.shard`) the decode runs this
        `batch` group's rows (`parallel.mesh.batch_rows`) on this rank's
        heads, and returns the LAST position's whole logits [B, 1, vocab]
        of all B rows, gathered over `model` and `batch`: what the sampler
        reads; with `all_positions` every position's [B, S, vocab] (a
        speculative verify window reads each). Off a mesh every position's
        logits come back either way."""
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
        if self.cfg.pipeline_stages > 1:
            if adapter_ix is not None:
                raise ValueError("adapter_ix is not supported with pipeline_stages > 1")
            if cache is not None:
                raise ValueError(
                    "KV-cache decode is not supported with pipeline_stages > 1 (the "
                    "stage-stacked weights have no per-layer cache slots); generate "
                    "with a non-pipelined copy of the params"
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
        mesh = current_mesh() if cache is not None else None
        serving = is_decode_mesh(mesh)
        B = tokens.shape[0]
        if serving and mesh.size(0) > 1:
            tokens, plan = self._batch_share(mesh, tokens, cache, pos, pad, pages, kv_layout,
                                             prefix_len, prefix_lens)
        elif cache is not None:
            plan = self._decode_plan(
                S, cache, pos, pad, pages, kv_layout, prefix_len, prefix_lens
            )
        x = self.embed(tokens.to(self.device))
        if self.embed.weight.shape[1] != self.cfg.dim:  # the hidden dim on `model`
            x = all_gather_cat(x, _model_group(self.embed.weight.shape[1], self.cfg.dim), -1)
        x = constrain(x, BATCH, "context", None)
        if self.cfg.pipeline_stages > 1:
            x = self.pipeline(x, self.rope_cos, self.rope_sin)
        elif scanned(self.cfg):
            x = self.scan(x, self.rope_cos, self.rope_sin, caches=cache, plan=plan,
                          generator=dropout_generator, adapter_ix=adapter_ix)
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
            w = self.embed.weight
            if w.shape[1] != self.cfg.dim:  # partial sums over the hidden dim
                group = _model_group(w.shape[1], self.cfg.dim)
                lo = axis_index(mesh, "model") * w.shape[1]
                logits = reduce_from(F.linear(x[..., lo:lo + w.shape[1]].float(), w.float()),
                                     group)
            else:
                logits = F.linear(x.float(), w.float())
        else:
            # a vocabulary split over `model`: each rank's logits slice
            group = _model_group(self.lm_head.weight.shape[0], self.cfg.vocab_size)
            logits = self.lm_head(copy_to(x, group))
        if not serving:
            return logits
        return self._gather_logits(mesh, logits if all_positions else logits[:, -1:], B)

    def _gather_logits(self, mesh, logits, B: int):
        """The whole logits of all B rows on a decode mesh: this rank's
        vocabulary slice gathered over `model` (its group even at size 1,
        so the path is the same on every mesh), then the `batch` groups'
        rows."""
        if logits.shape[-1] != self.cfg.vocab_size or mesh.size(1) == 1:
            logits = all_gather_cat(logits, mesh.get_group("model"), -1)
        if mesh.size(0) > 1:
            logits = all_gather_cat(logits, mesh.get_group("batch"), 0)[:B]
        world = getattr(self, "mesh_world", None)
        if world is not None:
            world.logit_gathers += 1
        return logits

    def _batch_share(self, mesh, tokens, cache, pos, pad, pages, kv_layout,
                     prefix_len, prefix_lens):
        """This `batch` group's share of a decode forward of B rows: (its
        rows of `tokens`, its plan). A dense cache holds the
        group's rows only; on the paged pool the plan writes all B rows
        (their K/V exchanged over `batch`, `_DecodePlan.exchange`) and
        reads the group's."""
        dev = self.device
        B, S = tokens.shape
        _, rows = batch_rows(B, mesh.size(0), mesh.get_local_rank("batch"))
        rows = rows.to(dev)

        def own(v):
            return None if v is None else torch.as_tensor(v, device=dev)[rows]

        if pages is None:
            pos = own(np.asarray(pos)) if _per_row(pos) else pos
            pad, prefix_lens = own(pad), own(prefix_lens)
            plan = self._decode_plan(S, cache, pos, pad, None, kv_layout, prefix_len,
                                     prefix_lens)
            return tokens.to(dev)[rows], plan
        plan = self._decode_plan(S, cache, pos, pad, pages, kv_layout, prefix_len,
                                 prefix_lens)
        plan.pages = plan.pages[rows]
        if plan.positions is not None:
            plan.positions = plan.positions[rows]
        if plan.mask.shape[0] > 1:
            plan.mask = plan.mask[rows]
        plan.exchange = (mesh.get_group("batch"), B)
        return tokens.to(dev)[rows], plan

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


def stack_layers(state: dict, n_layers: int) -> dict:
    """A per-layer state_dict (`layers.{i}.<name>`) → the scanned module's
    (`scan.block.<name>`, the layers stacked on a leading dim); the other
    entries pass through. The same weights, for `scan_layers: true`."""
    out = {k: v for k, v in state.items() if not k.startswith("layers.")}
    for name in {k.split(".", 2)[2] for k in state if k.startswith("layers.")}:
        out[SCAN_BLOCK + name] = torch.stack(
            [state[f"layers.{i}.{name}"] for i in range(n_layers)])
    return out


# The reference's TRANSFORMER_RULES in the port's names and layouts:
# nn.Linear `weight` is [out, in] where flax's `kernel` is [in, out], so
# each kernel rule's entries are swapped; the embedding ([vocab, dim]) and
# the LoRA factors (lora_a [in, r], lora_b [r, out]) keep the reference's
# orientation. Megatron TP: column-parallel q/k/v/gate/up (out on
# `model`), row-parallel o/down (in on `model`), fsdp on the other dim.
TRANSFORMER_RULES = (
    (r"embed\.weight$", (None, ("model", "fsdp"))),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$", ("model", "fsdp")),
    (r"(o_proj|down_proj)\.weight$", ("fsdp", "model")),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.lora_a$", ("fsdp", None)),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.lora_b$", (None, "model")),
    (r"(o_proj|down_proj)\.lora_a$", ("model", None)),
    (r"(o_proj|down_proj)\.lora_b$", (None, "fsdp")),
    (r"lm_head\.weight$", ("model", "fsdp")),
)

# How the forward consumes each parameter over `model`: the tensor dim it
# keeps split (a rank's heads, hidden units or vocabulary slice), or
# "partial" for a parameter replicated over `model` but used inside a split
# block, whose per-rank gradients are partial sums. The rest is gathered
# whole for the forward.
TENSOR_PARALLEL = (
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$", 0),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.lora_b$", 1),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.lora_a$", "partial"),
    (r"(o_proj|down_proj)\.weight$", 1),
    (r"(o_proj|down_proj)\.lora_a$", 0),
    (r"(o_proj|down_proj)\.lora_b$", "partial"),
    (r"lm_head\.weight$", 0),
)

# The pipelined stack (`pipeline.stages.*`, [P, Lp, ...]): the reference's
# PIPELINE_RULES, the stage dim on `pipeline` and the block rules on the
# trailing dims, listed before the base rules so they match first; each
# rank runs its own stage (all of the stacked parameters, norm scales
# included, are split over `pipeline` for the forward).
PIPELINE_RULES = tuple(
    (r"stages\..*" + pat, ("pipeline", None, *axes))
    for pat, axes in TRANSFORMER_RULES
    if "embed" not in pat and "lm_head" not in pat
)
PIPELINE_TENSOR_PARALLEL = tuple(
    (r"stages\..*" + pat, how + 2 if isinstance(how, int) else how)
    for pat, how in TENSOR_PARALLEL if "lm_head" not in pat
)

# The scanned stack (`scan.block.*`, [L, ...]): the reference's SCAN_RULES,
# every block rule shifted one dim right (the layer dim whole), listed
# before the base rules; the forward keeps the same splits one dim on.
SCAN_PREFIX = re.escape(SCAN_BLOCK) + ".*"
SCAN_RULES = tuple(
    (SCAN_PREFIX + pat, (None, *axes))
    for pat, axes in TRANSFORMER_RULES
    if "embed" not in pat and "lm_head" not in pat
)
SCAN_TENSOR_PARALLEL = tuple(
    (SCAN_PREFIX + pat, how + 1 if isinstance(how, int) else how)
    for pat, how in TENSOR_PARALLEL if "lm_head" not in pat
)

# With experts, the reference keeps fsdp off the embedding and the LM head
# (its edge rules; first match wins).
MOE_EDGE_RULES = (
    (r"embed\.weight$", (None, ("model",))),
    (r"lm_head\.weight$", ("model", None)),
)


def sharding(cfg: TransformerConfig) -> tuple[tuple, dict]:
    """(the parameter rules, the forward's splits by mesh axis) of
    `Transformer(cfg)`, as the reference's builder composes its rules."""
    rules, split = TRANSFORMER_RULES, {"model": TENSOR_PARALLEL}
    if cfg.pipeline_stages > 1:
        rules = PIPELINE_RULES + rules
        split = {"model": PIPELINE_TENSOR_PARALLEL + TENSOR_PARALLEL,
                 "pipeline": ((r"^pipeline\.stages\.", 0),)}
    elif scanned(cfg):
        rules = SCAN_RULES + rules
        split = {"model": SCAN_TENSOR_PARALLEL + TENSOR_PARALLEL}
    if cfg.n_experts > 0:
        from .moe import MOE_RULES, MOE_SPLIT

        moe_rules, moe_split = MOE_RULES, MOE_SPLIT
        if scanned(cfg):  # the reference's MoE rules under scan: one dim on
            moe_rules = tuple((pat, (None, *axes)) for pat, axes in MOE_RULES)
            moe_split = {ax: tuple((pat, dim + 1) for pat, dim in pairs)
                         for ax, pairs in MOE_SPLIT.items()}
        rules = MOE_EDGE_RULES + moe_rules + rules
        split = {"model": moe_split["model"] + split["model"],
                 "expert": moe_split["expert"]}
    return rules, split


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
    cfg = TransformerConfig(**{k: v for k, v in base.items() if k in fields})
    if cfg.pipeline_stages > 1:
        # the reference's pipelined stack has no dropout rngs and cannot
        # sow the MoE aux loss: it refuses both rather than change the
        # training objective
        if cfg.dropout_rate > 0:
            raise ValueError("pipeline_stages > 1 does not support dropout_rate > 0")
        if cfg.n_experts > 0:
            raise ValueError(
                "pipeline_stages > 1 does not support MoE (n_experts > 0): the "
                "load-balancing aux loss cannot be sown through the pipelined stack"
            )
    return cfg
