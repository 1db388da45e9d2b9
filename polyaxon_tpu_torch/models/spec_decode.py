"""Self-speculative decoding: n-gram (or draft-model) proposals and one
batched verify forward, counterpart of `polyaxon_tpu/models/spec_decode.py`
(an own copy: the port imports nothing of the JAX package).

Plain decode pays one full forward per token. Here each row's K drafts ride
one [B, K+1] verify window:

  1. DRAFT (host): `NgramDrafter` replays what followed the longest recent
     n-gram of the row's own prompt and output; a draft model
     (`models.draft.ModelDrafter`) can stand in through `drafter=`.
  2. VERIFY (one forward): the last committed token plus the K drafts go
     through the decode path at per-row frontiers `pos` [B]. Position i
     writes slot pos + i and attends slots <= pos + i, so its logits are
     what plain decode would produce after the same i tokens; each is
     sampled at generation index start_g + i from the row's own stream —
     the sampler of `models.generate` keys on (row seed, generation index)
     — giving the baseline targets t_0..t_K.
  3. ACCEPT (host): the longest prefix where draft == target commits, plus
     the target after it. Every committed token is the token the
     non-speculative sampler emits, greedy and sampled alike.

Rollback is free: a rejected draft's K/V sits in slots the next window
rewrites before any query attends them, and the live mask keeps them dead
meanwhile. On the paged pool writes past a row's table are dropped.

On a slot-stacked model every verify forward takes the rows' adapter
slots (`adapter_ix`); the drafts, n-gram or draft model, ride slot 0. On a
decode mesh a verify forward asks for the logits of every position of its
window (`all_positions`); the drafters stay on rank 0's host.

Sampled speculation needs per-row seeds: a scalar-seed stream keys on
absolute position and cannot be replayed once rows accept different
lengths, so `spec_generate` raises on it. The verify functions are plain
functions over the port's in-place caches (the reference's `jit_*`
factories have no counterpart). No wall clocks in this module.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .generate import _host_ints, _sample_rows
from .kv_pages import PagedKVLayout


# ------------------------------------------------------------------ draft side
class NgramDrafter:
    """Per-row suffix → continuation index over the row's own history.

    `index[(t_{i-n+1}..t_i)] = i` maps each n-gram (n = ngram_max..1,
    longest match wins) to the LATEST position it occurred with a
    continuation, so `propose` replays what followed last time. Misses
    repeat the last token."""

    def __init__(self, tokens, *, ngram_max: int = 3):
        self.ns = tuple(range(int(ngram_max), 0, -1))
        self.tokens: list[int] = []
        self.index: dict[tuple, int] = {}
        self.extend(tokens)

    def extend(self, tokens) -> None:
        for t in tokens:
            self.tokens.append(int(t))
            i = len(self.tokens) - 2  # newest position that has a continuation
            if i < 0:
                continue
            for n in self.ns:
                if i + 1 >= n:
                    self.index[tuple(self.tokens[i + 1 - n : i + 1])] = i

    def propose(self, k: int) -> list[int]:
        if not self.tokens:
            return [0] * k
        for n in self.ns:
            if len(self.tokens) < n:
                continue
            j = self.index.get(tuple(self.tokens[-n:]))
            if j is None:
                continue
            cont = self.tokens[j + 1 : j + 1 + k]
            if cont:
                return (cont + [cont[-1]] * k)[:k]
        return [self.tokens[-1]] * k


# ----------------------------------------------------------------- verify side
def _verify_targets(logits, fed, seeds, start_g, done, *, temperature: float,
                    top_k: Optional[int], eos_id: Optional[int]):
    """Baseline targets and accept lengths of one verify window.

    logits [B, S, V] from feeding `fed` [B, S] (fed[:, 0] the last committed
    token, fed[:, 1:] the drafts); `start_g` [B] the generation index of the
    window's first sample; `done` [B] the eos latch entering the window.
    Returns (targets [B, S], accept [B]) as tensors on the logits' device:
    targets[:, i] is the baseline sample at generation index start_g + i
    (pinned to eos once a generated eos was fed, as generate() latches) and
    accept counts the leading drafts equal to their targets."""
    B, S = fed.shape
    dev = logits.device
    fed = torch.as_tensor(np.asarray(fed), dtype=torch.long, device=dev)
    done = torch.as_tensor(np.asarray(done), dtype=torch.bool, device=dev)
    if temperature <= 0.0:  # greedy: one argmax over the window
        targets = torch.argmax(logits.float(), dim=-1)
    else:
        start_g = np.asarray(start_g, np.int64)
        seeds = _host_ints(seeds)
        targets = torch.stack([
            _sample_rows(logits[:, i].float(), seeds, (start_g + i).tolist(),
                         temperature, top_k)
            for i in range(S)
        ], dim=1)
    if eos_id is not None:
        # position i is pinned once a generated eos was fed at or before it
        latched = done[:, None] | (torch.cumsum((fed == eos_id).long(), dim=1) > 0)
        targets = torch.where(latched, torch.full_like(targets, eos_id), targets)
    match = (fed[:, 1:] == targets[:, :-1]).long()
    accept = torch.cumprod(match, dim=1).sum(dim=1)
    return targets, accept


@torch.inference_mode()
def spec_prefill(module, prompt, pad, seeds, *, temperature: float,
                 top_k: Optional[int], adapter_ix=None):
    """Dense prefill of the speculative path: (cache, first [B]) — the math
    of generate()'s prefill, generation index 0 sampled per row."""
    dev = module.device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)
    cache = module.make_cache(prompt.shape[0])
    logits = module(prompt, cache=cache, pos=0,
                    pad=torch.as_tensor(np.asarray(pad), dtype=torch.long, device=dev),
                    adapter_ix=adapter_ix)
    first = _sample_rows(logits[:, -1].float(), _host_ints(seeds), 0, temperature, top_k)
    return cache, first


@torch.inference_mode()
def spec_verify(module, cache, fed, done, pad, seeds, pos, start_g, *,
                temperature: float, top_k: Optional[int], eos_id: Optional[int],
                adapter_ix=None):
    """One dense verify window: feed `fed` [B, K+1] at per-row frontiers
    `pos` [B] (the cache is written in place; slots past seq_len drop) →
    (targets [B, K+1], accept [B]) as numpy."""
    dev = module.device
    logits = module(
        torch.as_tensor(np.asarray(fed), dtype=torch.long, device=dev), cache=cache,
        pad=torch.as_tensor(np.asarray(pad), dtype=torch.long, device=dev),
        pos=np.asarray(pos, np.int64), adapter_ix=adapter_ix, all_positions=True,
    )
    targets, accept = _verify_targets(logits, fed, seeds, start_g, done,
                                      temperature=temperature, top_k=top_k, eos_id=eos_id)
    return targets.cpu().numpy(), accept.cpu().numpy()


@torch.inference_mode()
def spec_verify_paged(module, cache, fed, done, pad, pages, seeds, pos, start_g, *,
                      kv_layout: PagedKVLayout, prefix_len: int = 0, prefix_lens=None,
                      temperature: float, top_k: Optional[int], eos_id: Optional[int],
                      adapter_ix=None):
    """One paged verify window through the page tables `pages` [B, n_pages]
    (the pool is written in place; writes past a row's table — the
    rejected tail at its edge — drop). A shared prefix is `prefix_len`
    slots, or per row `prefix_lens` [B]. → (targets, accept) as numpy."""
    dev = module.device
    kw = {}
    if prefix_lens is not None:
        kw["prefix_lens"] = torch.as_tensor(np.asarray(prefix_lens), dtype=torch.long,
                                            device=dev)
    else:
        kw["prefix_len"] = int(prefix_len)
    logits = module(
        torch.as_tensor(np.asarray(fed), dtype=torch.long, device=dev), cache=cache,
        pad=torch.as_tensor(np.asarray(pad), dtype=torch.long, device=dev),
        pages=torch.as_tensor(np.asarray(pages), dtype=torch.long, device=dev),
        pos=np.asarray(pos, np.int64), kv_layout=kv_layout, adapter_ix=adapter_ix,
        all_positions=True, **kw,
    )
    targets, accept = _verify_targets(logits, fed, seeds, start_g, done,
                                      temperature=temperature, top_k=top_k, eos_id=eos_id)
    return targets.cpu().numpy(), accept.cpu().numpy()


# ------------------------------------------------------------------- host side
def commit_window(fed, targets, accept, remaining, done, eos_id):
    """Host-side accept/commit of one verify window (spec_generate and the
    serving loops share it).

    All numpy: fed [B, K+1], targets [B, K+1], accept [B], remaining [B]
    (tokens the row may still emit; <= 0 = inactive), done [B] (the eos
    latch entering the window). Returns (committed per-row list, done',
    remaining', eos_hit [B], stats {proposed, accepted, accepted_judged,
    truncated, rollback}).

    Active rows commit ncommit = min(accept + 1, remaining) >= 1 tokens.
    `accepted` counts committed drafts (ncommit - 1); `accepted_judged`
    every draft the verify matched, truncated by the budget or not (what
    the adaptive controller reads); `truncated` is the gap. done' replays
    generate()'s latch (a GENERATED eos among fed[:ncommit]); eos_hit flags
    rows whose committed tokens hold eos."""
    fed = np.asarray(fed)
    targets = np.asarray(targets)
    accept = np.asarray(accept)
    B, S = fed.shape
    K = S - 1
    done = np.array(done, bool)
    remaining = np.array(remaining, np.int64)
    eos_hit = np.zeros(B, bool)
    committed: list[np.ndarray] = []
    proposed = accepted = judged = truncated = rollback = 0
    for b in range(B):
        if remaining[b] <= 0:
            committed.append(np.empty((0,), np.int32))
            continue
        proposed += K
        n = int(min(int(accept[b]) + 1, remaining[b]))
        toks = targets[b, :n].astype(np.int32)
        committed.append(toks)
        accepted += n - 1
        j = int(min(int(accept[b]), K))
        judged += j
        truncated += j - (n - 1)
        rollback += K - (n - 1)
        if eos_id is not None:
            if (fed[b, :n] == eos_id).any():
                done[b] = True
            if (toks == eos_id).any():
                eos_hit[b] = True
        remaining[b] -= n
    stats = {
        "proposed": proposed,
        "accepted": accepted,
        "accepted_judged": judged,
        "truncated": truncated,
        "rollback": rollback,
    }
    return committed, done, remaining, eos_hit, stats


def spec_generate(
    module,
    prompt,
    *,
    max_new_tokens: int,
    draft_tokens: int = 4,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    seeds=None,  # [B] per-row seeds; required when temperature > 0
    prompt_lengths=None,  # [B] true lengths of a LEFT-padded prompt batch
    ngram_max: int = 3,
    stats: Optional[dict] = None,  # accumulates proposed/accepted/rollback
    drafter=None,  # models.draft.ModelDrafter — replaces the n-gram index
    controller=None,  # adaptive K: window_k() / observe() / tick_plain()
    adapter_ix=None,  # [B] per-row adapter slot; None = slot 0
) -> torch.Tensor:
    """Speculative drop-in for generate() on the dense cache: the same
    [B, P + max_new_tokens] tokens per row (as generate() with per-row
    `seeds`), usually in far fewer forwards. See the module docstring.

    With `controller` (serving.adaptive.AdaptiveSpecController or a duck
    type) each window asks `window_k()` for its width, capped at
    `draft_tokens`; k == 0 is a width-1 window, exactly one plain decode
    step. The controller then gets the truncation-corrected accept counts
    (`observe`) or, for plain windows, a logical tick (`tick_plain`)."""
    cfg = module.cfg
    prompt = np.asarray(torch.as_tensor(prompt).cpu(), np.int64)
    B, P = prompt.shape
    K = int(draft_tokens)
    if K < 1:
        raise ValueError("draft_tokens must be >= 1")
    total = P + int(max_new_tokens)
    if total > cfg.seq_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds the model's seq_len {cfg.seq_len} (the KV cache size)"
        )
    if seeds is None:
        if temperature > 0.0:
            raise ValueError(
                "speculative sampling needs per-row seeds: the scalar-seed "
                "stream keys on absolute position, which cannot be replayed "
                "once rows accept different lengths — pass seeds=[B] "
                "(generate() accepts the same) or use temperature=0"
            )
        seeds = np.zeros(B, np.int64)  # greedy: the streams are never drawn
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    if seeds.shape != (B,):
        raise ValueError(f"seeds must be [B]={B}, got {seeds.shape}")
    lengths = (np.full(B, P, np.int64) if prompt_lengths is None
               else np.asarray(torch.as_tensor(prompt_lengths).cpu(), np.int64))
    pad = P - lengths

    cache, first = spec_prefill(module, prompt, pad, seeds,
                                temperature=temperature, top_k=top_k,
                                adapter_ix=adapter_ix)
    first = first.cpu().numpy()
    buf = np.zeros((B, total), np.int64)
    buf[:, :P] = prompt
    buf[:, P] = first

    drafters: list[NgramDrafter] = []
    if drafter is None:
        drafters = [NgramDrafter(prompt[b, P - lengths[b]:], ngram_max=ngram_max)
                    for b in range(B)]
        for b in range(B):
            drafters[b].extend([first[b]])

    tok = first.copy()  # last committed (not yet fed) token per row
    pos = np.full(B, P, np.int64)  # the slot `tok` will occupy
    start_g = np.ones(B, np.int64)  # generation index of the next sample
    done = np.zeros(B, bool)
    remaining = np.full(B, int(max_new_tokens) - 1, np.int64)
    if eos_id is not None:
        hit = first == eos_id
        buf[hit, P + 1:] = eos_id  # everything after a generated eos is pinned
        remaining[hit] = 0

    while (remaining > 0).any():
        k_eff = K if controller is None else min(K, int(controller.window_k()))
        fed = np.empty((B, k_eff + 1), np.int64)
        fed[:, 0] = tok
        if k_eff:
            if drafter is not None:
                fed[:, 1:] = drafter.propose(tok, start_g, k_eff)
                for b in range(B):
                    if remaining[b] <= 0:
                        fed[b, 1:] = tok[b]
            else:
                for b in range(B):
                    fed[b, 1:] = drafters[b].propose(k_eff) if remaining[b] > 0 else tok[b]
        targets, accept = spec_verify(
            module, cache, fed, done, pad, seeds, pos, start_g,
            temperature=temperature, top_k=top_k, eos_id=eos_id, adapter_ix=adapter_ix,
        )
        committed, done, remaining, eos_hit, delta = commit_window(
            fed, targets, accept, remaining, done, eos_id
        )
        if controller is not None:
            if k_eff:
                controller.observe(delta["proposed"], delta["accepted_judged"])
            else:
                controller.tick_plain(1)
        if stats is not None:
            for k, v in delta.items():
                stats[k] = stats.get(k, 0) + v
            stats["windows"] = stats.get("windows", 0) + 1
        for b in range(B):
            toks = committed[b]
            if not len(toks):
                continue
            at = P + start_g[b]
            buf[b, at:at + len(toks)] = toks
            if drafter is None:
                drafters[b].extend(toks)
            tok[b] = toks[-1]
            pos[b] += len(toks)
            start_g[b] += len(toks)
            if eos_hit[b]:
                buf[b, P + start_g[b]:] = eos_id
                remaining[b] = 0
    return torch.from_numpy(buf).to(module.device)
