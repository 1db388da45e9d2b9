"""Draft-model speculative decoding: a small LM of the same architecture and
tokenizer proposes the drafts, counterpart of `polyaxon_tpu/models/draft.py`
(an own copy: the port imports nothing of the JAX package).

The draft is the target's config with the `draft:` overrides applied
(`draft_config`; half the depth by default). Its weights come by LAYER
TRUNCATION of the served model (`derive_draft_params`: draft layer i is
base layer i; embedding, final norm and LM head shared), or are random when
the draft changes a width (`init_draft_params`). Either way the outputs
cannot change: acceptance is exact match against the target's own samples,
so the draft decides only the accept rate.

`ModelDrafter` runs K autoregressive steps through its OWN dense,
left-padded cache per window and hands the proposals to the verify and
commit of `models.spec_decode`. Its cache frontier is a function of the
generation index alone (`prompt_width + start_g - 1`): if the verify
commits n tokens, the first n - 1 drafts matched, so draft slots
[pos, pos + n - 1] already hold the committed tokens' K/V, and the stale
tail is rewritten by the next window before any query reads it. The
drafter therefore composes with any target geometry (dense, paged,
prefix-cached, chunk-prefilled). No wall clocks in this module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .generate import _host_ints, _sample_rows
from .transformer import SCAN_BLOCK

#: fields the `draft:` sub-config may NOT override — the drafter must share
#: the target's tokenizer and propose over the same vocabulary
_PINNED = ("vocab_size",)


def draft_config(cfg):
    """The draft's config: `cfg` with its `draft` overrides (a normalized
    (key, value) tuple) applied; half the target's depth unless an override
    names `n_layers`. The draft carries no `draft` of its own."""
    over = dict(cfg.draft) if cfg.draft else {}
    for k in _PINNED:
        if k in over and over[k] != getattr(cfg, k):
            raise ValueError(f"draft model must share the tokenizer: {k} may not change")
    over.setdefault("n_layers", max(1, cfg.n_layers // 2))
    over["draft"] = ()
    fields = {f.name for f in dataclasses.fields(type(cfg))}
    unknown = set(over) - fields
    if unknown:
        raise ValueError(f"unknown draft config fields: {sorted(unknown)}")
    return dataclasses.replace(cfg, **over)


def derive_draft_params(state: dict, draft_cfg, *, base_cfg=None) -> dict:
    """The draft's state_dict by LAYER TRUNCATION of the base's: entries of
    `layers.{i}.` with i < draft n_layers (a scanned stack's `scan.block.`
    entries sliced to their first n_layers), and every non-layer entry
    (embedding, final norm, LM head) shared as it is. Valid only when the
    draft keeps the base's widths."""
    n = draft_cfg.n_layers
    if base_cfg is not None:
        for f in ("dim", "n_heads", "n_kv_heads", "hidden_dim"):
            if getattr(draft_cfg, f) != getattr(base_cfg, f):
                raise ValueError(
                    f"cannot derive draft params by truncation: draft changes {f} "
                    "(train or randomly init the draft instead)"
                )
        if n > base_cfg.n_layers:
            raise ValueError(f"draft n_layers {n} exceeds base {base_cfg.n_layers}")
    out = {}
    for name, value in state.items():
        if name.startswith("layers."):
            if int(name.split(".", 2)[1]) < n:
                out[name] = value
        elif name.startswith(SCAN_BLOCK):  # [L, ...]: a view of the first n
            out[name] = value[:n]
        else:
            out[name] = value
    return out


def init_draft_params(module, seed: int = 0) -> dict:
    """Random draft weights (the accept rate will be ~0; the outputs do not
    change): the fallback when the draft changes a width."""
    module.init_weights(seed)
    return module.state_dict()


def build_draft(module, *, overrides=None):
    """(draft module, derived) for a base Transformer on its device and
    dtype. `overrides` (dict or (key, value) tuple) layer over the config's
    own `draft`. Weights derive by truncation, sharing the base's tensors,
    when the draft keeps the base's widths; else they are random and
    `derived` is False."""
    cfg = module.cfg
    if overrides:
        if hasattr(overrides, "items"):
            overrides = tuple(sorted(
                (str(k), tuple(v) if isinstance(v, list) else v)
                for k, v in overrides.items()
            ))
        cfg = dataclasses.replace(cfg, draft=tuple(overrides))
    dcfg = draft_config(cfg)
    dmodule = type(module)(dcfg, device=module.device, dtype=module.dtype)
    try:
        state = derive_draft_params(module.state_dict(), dcfg, base_cfg=cfg)
    except ValueError:
        init_draft_params(dmodule)
        return dmodule.eval(), False
    # assign: the draft's tensors ARE the base's (no copy), as the
    # reference's draft tree shares the base's arrays
    dmodule.load_state_dict(state, assign=True)
    return dmodule.eval(), True


class ModelDrafter:
    """Batched draft proposer over its own dense left-padded cache.

    Built once per group with the (bucketed) prompt batch, then
    `propose(tok, start_g, k)` each window. The first sampled token comes
    from the TARGET's prefill, never from here."""

    @torch.inference_mode()
    def __init__(self, module, prompts, lengths, *, seeds, temperature: float = 0.0,
                 top_k: Optional[int] = None):
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long)
        B, P = prompts.shape
        if P + 1 > module.cfg.seq_len:
            raise ValueError(
                f"draft seq_len {module.cfg.seq_len} cannot hold the prompt bucket {P}"
            )
        self.module = module
        self.temperature = float(temperature)
        self.top_k = top_k
        self.base = P  # cache slot of generation index 0's token
        dev = module.device
        self.pad = torch.as_tensor(P - np.asarray(lengths, np.int64), device=dev)
        self.seeds = _host_ints(seeds)
        self.cache = module.make_cache(B)
        module(prompts.to(dev), cache=self.cache, pos=0, pad=self.pad)

    @torch.inference_mode()
    def propose(self, tok, start_g, k: int) -> np.ndarray:
        """Drafts [B, k] for generation indices start_g .. start_g + k - 1.
        `tok` [B] is each row's last committed (not yet fed) token and
        `start_g` [B] the generation index of its successor. Step i feeds
        the previous token at slot pos + i and samples with the target's
        own (row seed, generation index) streams."""
        tok = np.asarray(tok, np.int64).reshape(-1)
        if k < 1:
            return np.empty((len(tok), 0), np.int64)
        start_g = np.asarray(start_g, np.int64).reshape(-1)
        pos = self.base + start_g - 1
        dev = self.module.device
        cur = torch.as_tensor(tok, device=dev)
        drafts = []
        for i in range(k):
            logits = self.module(cur[:, None], cache=self.cache, pad=self.pad, pos=pos + i)
            cur = _sample_rows(logits[:, -1].float(), self.seeds, (start_g + i).tolist(),
                               self.temperature, self.top_k)
            drafts.append(cur)
        # slots [pos, pos + k - 1] now hold [tok, d_1 .. d_{k-1}]; d_k was
        # sampled, never fed. On a full accept the bonus commit moves the
        # frontier past slot pos + k, whose token is then d_k: write its K/V
        # now (logits discarded), or the next window attends a hole
        self.module(cur[:, None], cache=self.cache, pad=self.pad, pos=pos + k)
        return torch.stack(drafts, dim=1).cpu().numpy()
