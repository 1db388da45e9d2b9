"""The JAX package's parameter tree and optax optimizer state → this port's
`state_dict` and optimizer state.

`params_np` is the tree `Transformer.init` builds in the reference, as a
nested dict of numpy arrays (e.g. `jax.tree.map(np.asarray, params)`):

    embed/embedding                         → embed.weight
    layer_{i}/attention/{q,k,v,o}_proj/kernel → layers.{i}.attention.*.weight
    layer_{i}/{attention,mlp}_norm/scale    → layers.{i}.*_norm.scale
    layer_{i}/mlp/{gate,up,down}_proj/kernel → layers.{i}.mlp.*.weight
    final_norm/scale, lm_head/kernel        → final_norm.scale, lm_head.weight
    .../lora_a, .../lora_b (lora_rank > 0)  → the same names, as they are
    .../scale (a quantize_module tree)      → the same names, as they are
    layer_{i}/moe/router/kernel [D, E]      → layers.{i}.moe.router.weight [E, D]
    layer_{i}/moe/{gate,up,down}_kernel     → the same names, as they are
                                              ([E, D, F], [E, D, F], [E, F, D])
    pipeline/stages/<block>/... [P, Lp, ...] → pipeline.stages.<block>.* (a
                                              pipelined config: the kernels'
                                              last two dims swapped)
    layers/block/<block>/... [L, ...]       → scan.block.<block>.* (a
                                              scan_layers config: the same)

A zoo model's tree (`params_from_jax(params_np)` with no config: the MLP,
ResNet, ViT, BERT, seq2seq, a lone MoE feed-forward) maps by its module
paths, which the port's modules keep: `a/b/leaf` → `a.b.<leaf>`, where a
Dense `kernel` [in, out] becomes `weight` [out, in], a conv `kernel` HWIO
becomes `weight` OIHW, an `embedding` becomes `weight`, a LayerNorm or
BatchNorm `scale` becomes `weight`, and every other leaf (`bias`,
`pos_embed`, `mlm_bias`, the MoE kernels) keeps its name and layout. With
`batch_stats` (ResNet), its `mean`/`var` become the BatchNorm buffers
`running_mean`/`running_var`.

Flax Dense kernels are [in, out] and nn.Linear weights [out, in], so each
kernel is transposed (the inverse of `models/convert_hf.py` there). The
LoRA factors keep the reference's orientation in `LoRADense`. A tree the
reference's `quantize_module` made holds int8 kernels [in, out] and f32
scales [out]: the kernels become int8 `weight` [out, in] (the same bytes,
transposed) beside `scale`, for a module built with `quant="int8"`.

`opt_state_from_jax` puts optax's state (numpy leaves in optax's tree) into
the port's optimizer, so a JAX run's optimizer state continues here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.optimizers import Adafactor, _factored_dims

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")
# optax's per-parameter state fields, by the names of its state NamedTuples
_MOMENTS = ("mu", "nu", "trace", "ema", "sum_of_squares", "v_row", "v_col", "v")

# port parameter name → (path in the reference's tree, how it turns: False
# as it is, True transposed, or a permutation of its axes)
Layout = dict[str, tuple[tuple[str, ...], Any]]
_HWIO_TO_OIHW = (3, 2, 0, 1)
_STACKED_T = (0, 1, 3, 2)
_SCANNED_T = (0, 2, 1)
_ZOO_NAMES = {"embedding": "weight", "scale": "weight"}
_STATS_NAMES = {"mean": "running_mean", "var": "running_var"}


def _tensor(a) -> torch.Tensor:
    """float32, or int8 for the payload of a quantized kernel."""
    dtype = np.int8 if np.asarray(a).dtype == np.int8 else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True))


def _at(tree, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _unwrap(params_np: dict) -> dict:
    return params_np.get("params", params_np)


def _orient(t: torch.Tensor, how) -> torch.Tensor:
    if how is True:
        return t.T.contiguous()
    if how:
        return t.permute(*how).contiguous()
    return t


def zoo_layout(params_np: dict) -> Layout:
    """Where each parameter of a zoo model sits in the reference's tree
    (optionally wrapped as {"params": ...}): the module path, with the leaf
    renamed and turned as the module docstring says."""
    layout: Layout = {}

    def walk(node: dict, path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, (*path, key))
                continue
            how = False
            name = _ZOO_NAMES.get(key, key)
            if key == "kernel":
                name = "weight"
                ndim = len(getattr(value, "shape", ()))
                how = True if ndim == 2 else _HWIO_TO_OIHW if ndim == 4 else False
            layout[".".join((*path, name))] = ((*path, key), how)

    walk(_unwrap(params_np), ())
    return layout


def _stats_state(batch_stats: dict) -> dict[str, torch.Tensor]:
    """flax `batch_stats` ({"batch_stats": ...} or its inside) → the
    BatchNorm buffers."""
    out = {}

    def walk(node: dict, path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, (*path, key))
            else:
                out[".".join((*path, _STATS_NAMES[key]))] = _tensor(value)

    walk(batch_stats.get("batch_stats", batch_stats), ())
    return out


def transformer_layout(params_np: dict, cfg) -> Layout:
    """Where each of `Transformer(cfg)`'s parameters sits in the reference's
    tree (optionally wrapped as {"params": ...})."""
    p = _unwrap(params_np)
    layout: Layout = {"embed.weight": (("embed", "embedding"), False)}

    def dense(prefix: str, path: tuple[str, ...], how) -> None:
        layout[f"{prefix}.weight"] = ((*path, "kernel"), how)
        for name in ("lora_a", "lora_b", "scale"):
            if name in _at(p, path):
                layout[f"{prefix}.{name}"] = ((*path, name), False)

    def block(pre: str, layer: tuple[str, ...], how) -> None:
        for name in _ATTN:
            dense(f"{pre}.attention.{name}", (*layer, "attention", name), how)
        if getattr(cfg, "n_experts", 0) > 0:
            layout[f"{pre}.moe.router.weight"] = ((*layer, "moe", "router", "kernel"), how)
            for name in ("gate_kernel", "up_kernel", "down_kernel"):
                layout[f"{pre}.moe.{name}"] = ((*layer, "moe", name), False)
        else:
            for name in _MLP:
                dense(f"{pre}.mlp.{name}", (*layer, "mlp", name), how)
        for norm in ("attention_norm", "mlp_norm"):
            layout[f"{pre}.{norm}.scale"] = ((*layer, norm, "scale"), False)

    if getattr(cfg, "pipeline_stages", 0) > 1:
        # the stacked [P, Lp, in, out] kernels turn on their last two dims
        block("pipeline.stages", ("pipeline", "stages"), _STACKED_T)
    elif getattr(cfg, "scan_layers", False):
        # nn.scan's [L, in, out] kernels, likewise
        block("scan.block", ("layers", "block"), _SCANNED_T)
    else:
        for i in range(cfg.n_layers):
            block(f"layers.{i}", (f"layer_{i}",), True)
    layout["final_norm.scale"] = (("final_norm", "scale"), False)
    if not cfg.tie_embeddings:
        layout["lm_head.weight"] = (("lm_head", "kernel"), True)
    return layout


def layout_for(params_np: dict, cfg=None) -> Layout:
    """`transformer_layout` for a TransformerConfig, `zoo_layout` for None."""
    return zoo_layout(params_np) if cfg is None else transformer_layout(params_np, cfg)


def params_from_jax(params_np: dict, cfg=None, batch_stats=None) -> dict[str, torch.Tensor]:
    """Nested numpy param dict (optionally wrapped as {"params": ...}) →
    float32 CPU state_dict for `Transformer(cfg)` (int8 for quantized
    kernels), or with `cfg` None for a zoo model, plus its BatchNorm buffers
    from `batch_stats`; `load_state_dict` casts it to the model's dtype and
    device."""
    p = _unwrap(params_np)
    out = {
        name: _orient(_tensor(_at(p, path)), how)
        for name, (path, how) in layout_for(p, cfg).items()
    }
    if batch_stats is not None:
        out.update(_stats_state(batch_stats))
    return out


def _collect(node, counts: set, moments: dict) -> None:
    """Walk optax's state tree (NamedTuples, or their dict form): `count`
    leaves into `counts`, the per-parameter trees by field name."""
    fields = node._asdict() if hasattr(node, "_asdict") else None
    if fields is None and isinstance(node, dict) and any(
        k == "count" or k in _MOMENTS for k in node
    ):
        fields = node
    if fields is not None:
        for key, value in fields.items():
            if key == "count":
                counts.add(int(np.asarray(value)))
            elif key in _MOMENTS:
                if key in moments:
                    raise ValueError(f"optax state holds two {key!r} trees")
                moments[key] = value
            else:
                _collect(value, counts, moments)
    elif isinstance(node, (list, tuple)):
        for value in node:
            _collect(value, counts, moments)
    elif isinstance(node, dict):
        for value in node.values():
            _collect(value, counts, moments)


def _adafactor_source(field: str, p: torch.Tensor, group, how) -> tuple[str, list]:
    """(the optax field holding the port's factor `field` of a parameter
    turned by `how` from the reference's layout, the permutation of that
    field's axes into the port's order). Each factor is named by the axis
    it drops, and turning a kernel can change which axis is which for
    equal sizes (the dims are chosen by size)."""
    perm = (1, 0) if how is True else tuple(how)  # port axis a = JAX axis perm[a]
    port_d1, port_d0 = Adafactor.dims(p, group)
    jax_shape = tuple(p.shape[perm.index(j)] for j in range(p.ndim))
    _, jax_d0 = _factored_dims(jax_shape, group["factored"], group["min_dim_size_to_factor"])
    dropped = perm[port_d0 if field == "v_row" else port_d1]
    kept_jax = [j for j in range(p.ndim) if j != dropped]
    order = [kept_jax.index(perm[a]) for a in range(p.ndim) if perm[a] != dropped]
    return ("v_row" if dropped == jax_d0 else "v_col"), order


def opt_state_from_jax(
    opt_state_np: Any, optimizer, params: dict[str, torch.Tensor], layout: Layout
) -> None:
    """Load optax's state into `optimizer` (a rule of `ops/optimizers.py`)
    in place: its `count`, and each parameter's moments (`mu`, `nu`,
    `trace`, `ema`, `sum_of_squares`, adafactor's `v_row`/`v_col`/`v`),
    matched by field name. `params` names the optimizer's parameters
    (e.g. `dict(module.named_parameters())`) and `layout` says where each
    sits in the reference's tree and how it turns (`transformer_layout`,
    `zoo_layout`). Raises on a missing leaf or a shape mismatch."""
    counts: set[int] = set()
    moments: dict[str, Any] = {}
    _collect(opt_state_np, counts, moments)
    if len(counts) != 1:
        raise ValueError(f"optax state holds counts {sorted(counts)}, expected one")
    groups = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    with torch.no_grad():
        for name, (path, how) in layout.items():
            p = params[name]
            if id(p) not in groups:
                continue  # not trained (a frozen parameter)
            state = optimizer.state[p]
            for field, dst in state.items():
                source, order = field, None
                if how and field in ("v_row", "v_col"):
                    source, order = _adafactor_source(field, p, groups[id(p)], how)
                if source not in moments:
                    raise KeyError(f"optax state has no {source!r} tree for {name}")
                src = torch.from_numpy(np.array(_at(moments[source], path), copy=True))
                if order is not None:
                    src = src.permute(*order).contiguous()
                elif src.ndim == p.ndim:
                    src = _orient(src, how)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"{name}.{field}: optax {tuple(src.shape)}, port {tuple(dst.shape)}"
                    )
                dst.copy_(src)
    optimizer.count = counts.pop()
