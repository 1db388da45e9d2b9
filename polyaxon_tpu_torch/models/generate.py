"""Autoregressive generation through the KV cache, counterpart of
`polyaxon_tpu/models/generate.py`.

`generate`: one batched prefill forward over the whole prompt fills every
layer's dense cache and samples the first new token; then one cached
decode step per further token. The cache is allocated up front,
[B, seq_len, n_kv, hd] per layer (no creation pass), and written in place.
The reference is functional (each step returns a new cache pytree); the
tokens are the same.

The paged functions run the same decode through one pool of page-sized
blocks shared by every request (`make_paged_cache`), addressed through
per-row page tables: `paged_prefill` then `paged_decode_chunk` (a coalesced
group), `paged_prefill_chunk` (one slice of a chunked prefill) and
`paged_step` (one continuous-batching step at per-row frontiers). They
update the pool in place where the reference donates it to its compiled
programs; the reference's `jit_*` factories have no counterpart. The pool
may be int8 (`kv_quant="int8"`: int8 payloads and f32 scales). On a
slot-stacked model (multi-tenant serving) every decode function takes
`adapter_ix` [B], each row's adapter slot (None = slot 0 for every row).

`beam_search`: the reference's HF-style beam search over the dense cache,
prefilled once per row and tiled to the beams.

Sampling: temperature 0 is greedy (argmax, first index on ties) and gives
the reference's tokens exactly. With temperature > 0 the noise comes from
a torch.Generator keyed like the reference's jax.random streams — a scalar
seed by (seed, absolute position), per-row seeds by (row seed, generation
index) — so a row's tokens do not depend on its batch, its padding or
the path that decodes it (dense bucketed, paged, chunked or stepped). The
draws themselves differ from jax.random's by construction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .kv_pages import PagedKVLayout
from .transformer import _per_row


def _top_k_mask(logits, top_k: Optional[int]):
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, torch.full_like(logits, -1e30))
    return logits


def _stream_seed(seed: int, index: int) -> int:
    """One 64-bit generator seed per (seed, index) pair."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(index) & 0xFFFFFFFF)


def _gumbel(shape, seed: int, index: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(_stream_seed(seed, index))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2**-24)))


def _sample(logits, seed: int, index: int, temperature: float, top_k: Optional[int]):
    """logits [B, V] f32 → [B] ids, one stream (seed, index) for the batch."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _top_k_mask(logits / temperature, top_k)
    return torch.argmax(logits + _gumbel(logits.shape, seed, index, logits.device), dim=-1)


def _sample_rows(logits, seeds, index, temperature: float, top_k: Optional[int]):
    """Per-row streams: row b draws from (seeds[b], index[b]) — `index` is
    one generation index for the batch or one per row — so coalescing rows
    into one batch never correlates or changes their samples."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = _top_k_mask(logits / temperature, top_k)
    V = logits.shape[-1]
    seeds = [int(s) for s in seeds]
    index = [int(i) for i in index] if _per_row(index) else [int(index)] * len(seeds)
    noise = torch.stack(
        [_gumbel((V,), s, g, logits.device) for s, g in zip(seeds, index)]
    )
    return torch.argmax(logits + noise, dim=-1)


def _host_ints(x) -> list:
    """A [B] per-row argument (tensor, array or list) as Python ints."""
    if torch.is_tensor(x):
        x = x.tolist()
    return [int(v) for v in np.asarray(x).reshape(-1)]


@torch.inference_mode()
def generate(
    module,
    prompt,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    eos_id: Optional[int] = None,
    seed=0,
    prompt_lengths=None,
    adapter_ix=None,
) -> torch.Tensor:
    """Generate `max_new_tokens` continuations of `prompt` [B, P].

    Returns [B, P + max_new_tokens] int64 on the model's device. `seed` is
    an int, or a length-B sequence of per-row seeds. With `prompt_lengths`
    [B] the prompt is LEFT-padded to P: row b's tokens are
    `prompt[b, P - prompt_lengths[b]:]`, pad slots never attend and rotary
    positions shift per row. With `eos_id`, a row that feeds a generated
    eos emits eos from then on. `adapter_ix` [B]: each row's adapter slot
    on a slot-stacked model."""
    cfg = module.cfg
    device = module.device
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(device)
    B, P = prompt.shape
    total = P + int(max_new_tokens)
    if total > cfg.seq_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds the model's seq_len {cfg.seq_len} (the KV cache size)"
        )
    pad = None
    if prompt_lengths is not None:
        lengths = torch.as_tensor(prompt_lengths, dtype=torch.long, device=device)
        pad = P - lengths
    seeds = torch.as_tensor(seed).reshape(-1).tolist()
    per_row = torch.as_tensor(seed).ndim == 1
    if per_row and len(seeds) != B:
        raise ValueError(f"{len(seeds)} per-row seeds for a batch of {B}")

    def sample(logits, index):
        if per_row:
            return _sample_rows(logits, seeds, index, temperature, top_k)
        return _sample(logits, seeds[0], index, temperature, top_k)

    cache = module.make_cache(B)
    logits = module(prompt, cache=cache, pos=0, pad=pad, adapter_ix=adapter_ix)
    buf = torch.zeros((B, total), dtype=torch.long, device=device)
    buf[:, :P] = prompt
    buf[:, P] = sample(logits[:, -1].float(), 0)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    for t in range(P, total - 1):  # t = position of the token being fed
        tok = buf[:, t:t + 1]
        logits = module(tok, cache=cache, pos=t, pad=pad, adapter_ix=adapter_ix)
        # per-row streams key on generation index (invariant to the pad);
        # the scalar stream keys on absolute position, as in the reference
        nxt = sample(logits[:, -1].float(), (t - P + 1) if per_row else t)
        if eos_id is not None:
            # latch only on GENERATED eos (prompts may hold eos separators)
            done = done | (tok[:, 0] == eos_id)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        buf[:, t + 1] = nxt
    return buf


# --------------------------------------------------------------- paged decode
# Determinism contract (the reference's, `generate.py:200-204`): for the
# same per-row seeds and pads a row's tokens equal the dense bucketed
# `generate` path's — same rope positions (slot - pad), same masked softmax
# (dead slots score -1e30 and weigh exactly 0), same per-generation-index
# sample streams.


def make_paged_cache(module, layout: PagedKVLayout) -> list:
    """The zeroed pool: per layer (k, v), each [pool_pages, page_tokens,
    n_kv_heads, head_dim] in the model's dtype on its device — or, for
    `kv_quant="int8"`, (k, v, k_scale, v_scale): int8 payloads of that shape
    and f32 scales [pool_pages, page_tokens, n_kv_heads]. Batch-size
    independent, so one pool serves every group shape. Zeros, not empty
    memory: scratch-page slots are masked to -1e30 in the scores, but a NaN
    there would still reach probs @ V. On a decode mesh the pool holds this
    rank's kv heads (`local_kv_heads`), and rank 0's stand-in
    (`serving.mesh.MeshModule`) makes one on every rank."""
    if hasattr(module, "make_paged_cache"):
        return module.make_paged_cache(layout)
    cfg = module.cfg
    shape = (layout.pool_pages, layout.page_tokens, module.local_kv_heads, cfg.head_dim)
    dev = module.device
    if layout.kv_quant == "int8":
        return [
            tuple(torch.zeros(shape, dtype=torch.int8, device=dev) for _ in range(2))
            + tuple(torch.zeros(shape[:3], dtype=torch.float32, device=dev)
                    for _ in range(2))
            for _ in range(cfg.n_layers)
        ]
    return [
        tuple(torch.zeros(shape, dtype=module.dtype, device=dev) for _ in range(2))
        for _ in range(cfg.n_layers)
    ]


@torch.inference_mode()
def copy_pool_pages(cache, *, table_row, start: int, count: int, new_ids,
                    page_tokens: int) -> None:
    """Pool-to-pool copy: gather `count` slots of one row's window (from
    slot `start`, through its page table `table_row`) and scatter them,
    page-aligned, into the pages `new_ids`, in every layer, in place."""
    dev = cache[0][0].device
    slots = int(start) + torch.arange(int(count), device=dev)
    table_row = torch.as_tensor(np.asarray(table_row), dtype=torch.long, device=dev)
    src_pages, src_off = table_row[slots // page_tokens], slots % page_tokens
    dst = torch.as_tensor(np.asarray(new_ids), dtype=torch.long, device=dev)
    for layer in cache:
        for pool in layer:  # k, v (and their scales on an int8 pool)
            vals = pool[src_pages, src_off]  # a copy: sources stay intact
            pool[dst] = vals.reshape(len(new_ids), page_tokens, *pool.shape[2:])


def _as_long(x, device):
    return torch.as_tensor(x, dtype=torch.long, device=device)


@torch.inference_mode()
def paged_prefill(
    module, cache, prompt, *, pad, pages, kv_layout: PagedKVLayout,
    prefix_len: int, temperature: float, top_k: Optional[int], seeds,
    adapter_ix=None,
) -> torch.Tensor:
    """Prefill `prompt` [B, S] (LEFT-padded suffixes when a shared prefix of
    `prefix_len` tokens is already in the pool) through the page tables,
    starting at slot `prefix_len`, and sample the first new token per row
    (generation index 0). Returns first_tokens [B]."""
    dev = module.device
    logits = module(
        _as_long(prompt, dev), cache=cache, pad=_as_long(pad, dev),
        pages=_as_long(pages, dev), pos=int(prefix_len), kv_layout=kv_layout,
        prefix_len=int(prefix_len), adapter_ix=adapter_ix,
    )
    return _sample_rows(logits[:, -1].float(), _host_ints(seeds), 0, temperature, top_k)


@torch.inference_mode()
def paged_decode_chunk(
    module, cache, tok, done, *, steps: int, pos: int, start_g: int, pad,
    pages, kv_layout: PagedKVLayout, prefix_len: int, temperature: float,
    top_k: Optional[int], eos_id: Optional[int], seeds, adapter_ix=None,
) -> tuple:
    """Run `steps` cached decode steps through the page tables.

    `tok` [B] is the previously sampled (not yet fed) token, written at slot
    `pos`; `start_g` is the generation index of the FIRST token this chunk
    samples; `done` [B] carries the eos latch between chunks. Returns
    (toks [B, steps], done): done latches when a GENERATED eos is fed, later
    samples are pinned to eos, as in `generate`."""
    dev = module.device
    pad, pages = _as_long(pad, dev), _as_long(pages, dev)
    seeds = _host_ints(seeds)
    tok = _as_long(tok, dev)
    done = torch.as_tensor(done, dtype=torch.bool, device=dev)
    out = []
    for i in range(int(steps)):
        logits = module(
            tok[:, None], cache=cache, pad=pad, pages=pages, pos=int(pos) + i,
            kv_layout=kv_layout, prefix_len=int(prefix_len), adapter_ix=adapter_ix,
        )
        nxt = _sample_rows(logits[:, -1].float(), seeds, int(start_g) + i,
                           temperature, top_k)
        if eos_id is not None:
            done = done | (tok == eos_id)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1), done


@torch.inference_mode()
def paged_prefill_chunk(
    module, cache, chunk, *, pad, pages, kv_layout: PagedKVLayout,
    prefix_lens, pos: int, temperature: float = 0.0,
    top_k: Optional[int] = None, seeds=None, final: bool = False, adapter_ix=None,
):
    """Write one prefill slice `chunk` [B, C] (columns [pos - prefix, ...) of
    each row's LEFT-padded suffix) into slots [pos, pos + C). A non-final
    slice only fills the KV (the LM head is skipped through
    `return_features`) and returns None; the final slice samples the first
    new token per row at generation index 0 — the same query, so the same
    token, as one-shot `paged_prefill` — and returns it [B]."""
    dev = module.device
    kwargs = dict(
        cache=cache, pad=_as_long(pad, dev), pages=_as_long(pages, dev),
        pos=int(pos), kv_layout=kv_layout, prefix_lens=_as_long(prefix_lens, dev),
        adapter_ix=adapter_ix,
    )
    chunk = _as_long(chunk, dev)
    if not final:
        module(chunk, return_features=True, **kwargs)
        return None
    logits = module(chunk, **kwargs)
    return _sample_rows(logits[:, -1].float(), _host_ints(seeds), 0, temperature, top_k)


@torch.inference_mode()
def paged_step(
    module, cache, tok, done, *, pad, prefix_lens, pages,
    kv_layout: PagedKVLayout, pos, g, seeds, temperature: float,
    top_k: Optional[int], eos_id: Optional[int], adapter_ix=None,
) -> tuple:
    """ONE decode step of a continuous batch: feed `tok` [B] at per-row
    frontiers `pos` [B] and sample each row's next token at its own
    generation index `g` [B]. The math of one iteration of
    `paged_decode_chunk` with pos, g and the prefix width per row, so rows
    of different ages and prefixes share the step. Returns (nxt [B], done)."""
    dev = module.device
    tok = _as_long(tok, dev)
    logits = module(
        tok[:, None], cache=cache, pad=_as_long(pad, dev),
        pages=_as_long(pages, dev), pos=np.asarray(_host_ints(pos)),
        kv_layout=kv_layout, prefix_lens=_as_long(prefix_lens, dev),
        adapter_ix=adapter_ix,
    )
    nxt = _sample_rows(logits[:, -1].float(), _host_ints(seeds), _host_ints(g),
                       temperature, top_k)
    done = torch.as_tensor(done, dtype=torch.bool, device=dev)
    if eos_id is not None:
        done = done | (tok == eos_id)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
    return nxt, done


# ----------------------------------------------------------------- beam search
@torch.inference_mode()
def reorder_rows(cache, flat) -> None:
    """Row r of the dense cache `cache` becomes its row `flat[r]`, in every
    layer: the beams' reorder by parent (in place) and the prefill's tiling
    to the beams (the rows' tensors replaced, as `flat` is longer).

    On a decode mesh with `batch` > 1 a rank holds only its group's rows
    (`parallel.mesh.batch_rows`), so a parent may sit in another group.
    Every rank reads the same `flat`: when every group's parents are its
    own, each reorders locally; otherwise the groups' rows are exchanged
    over `batch` first (an all-gather of the cache), and each keeps its
    new rows. `module.reorder_rows` (`serving.mesh.MeshModule`) runs it on
    every rank of the mesh."""
    from ..parallel.collectives import all_gather_cat
    from ..parallel.mesh import batch_rows, is_decode_mesh
    from ..parallel.ring import current_mesh

    if not torch.is_tensor(flat):
        flat = torch.as_tensor(np.asarray(flat), dtype=torch.long)
    flat = flat.reshape(-1)
    n = flat.numel()
    mesh, group = current_mesh(), None
    if is_decode_mesh(mesh) and mesh.size(0) > 1:
        groups, me = mesh.size(0), mesh.get_local_rank("batch")
        held = cache[0][0].shape[0]  # rows a group holds before the reorder
        src = [flat[batch_rows(n, groups, g)[1]] for g in range(groups)]
        if all(bool((s // held == g).all()) for g, s in enumerate(src)):
            flat = src[me] - me * held
        else:
            flat, group = src[me], mesh.get_group("batch")
    flat = flat.to(cache[0][0].device)
    for i, layer in enumerate(cache):
        new = tuple(all_gather_cat(c, group, 0).index_select(0, flat) for c in layer)
        if new[0].shape == layer[0].shape:
            for c, v in zip(layer, new):
                c.copy_(v)
        else:
            cache[i] = new


def _reorder(module, cache, flat) -> None:
    if hasattr(module, "reorder_rows"):  # a decode mesh's stand-in: every rank
        module.reorder_rows(cache, flat)
    else:
        reorder_rows(cache, flat)


def _top_k(x, k: int):
    """jax.lax.top_k over the last dim: the k largest, descending, ties to
    the lower index (a stable sort; torch.topk leaves tie order open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_search(
    module,
    prompt,
    *,
    max_new_tokens: int,
    num_beams: int = 4,
    length_penalty: float = 1.0,
    eos_id: Optional[int] = None,
) -> torch.Tensor:
    """Beam-search decode (`polyaxon_tpu/models/generate.py::beam_search`):
    the best sequence per batch row, [B, P + max_new_tokens] int64.

    One prefill per batch row, its dense cache tiled to the row's beams;
    then each step expands every beam over the vocabulary, keeps the top
    `num_beams` continuations and reorders the cache by each survivor's
    parent beam (`reorder_rows`: a gather on the batch dim, written back
    in place; on a decode mesh, a command over every rank's cache).

    Scoring is HF-style, as in the reference: without `eos_id` beams are
    pruned by their raw summed log-prob and `length_penalty` (dividing by
    length ** length_penalty) applies only to the final ranking. With
    `eos_id` each step takes the top 2·nb candidates: those ending in eos
    move into a finished-hypothesis buffer (length-penalized, the worst
    evicted), the best nb others stay live; the answer is the best of both
    under the penalty, padded with eos after its eos."""
    cfg = module.cfg
    device = module.device
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(device)
    B, P = prompt.shape
    total = P + int(max_new_tokens)
    if total > cfg.seq_len:
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({max_new_tokens}) = {total} "
            f"exceeds the model's seq_len {cfg.seq_len} (the KV cache size)"
        )
    nb = int(num_beams)
    if nb < 1:
        raise ValueError("num_beams must be >= 1")
    if nb > cfg.vocab_size:
        raise ValueError(f"num_beams ({nb}) cannot exceed vocab_size ({cfg.vocab_size})")
    BN = B * nb
    lp = float(length_penalty)
    neg_inf = float("-inf")

    # prefill ONCE per batch row, then tile the cache to the row's beams
    cache = module.make_cache(B)
    logits = module(prompt, cache=cache, pos=0)
    _reorder(module, cache, torch.arange(B).repeat_interleave(nb))
    first_logp = torch.log_softmax(logits[:, -1].float(), dim=-1)  # [B, V]
    V = first_logp.shape[-1]
    if eos_id is None:
        scores, tok0 = _top_k(first_logp, nb)  # [B, nb]
    else:
        # 2·nb candidates leave >= nb live ones after eos leaves (eos is at
        # most one candidate per parent)
        k0 = min(2 * nb, V)
        sc2, tok2 = _top_k(first_logp, k0)
        is_eos0 = tok2 == eos_id
        scores, pick0 = _top_k(torch.where(is_eos0, neg_inf, sc2), nb)
        tok0 = torch.gather(tok2, 1, pick0)
        fin_scores = _top_k(torch.where(is_eos0, sc2, neg_inf), min(nb, k0))[0]
        if fin_scores.shape[1] < nb:
            fin_scores = torch.nn.functional.pad(
                fin_scores, (0, nb - fin_scores.shape[1]), value=neg_inf
            )
        fin_buf = torch.zeros((B, nb, total), dtype=torch.long, device=device)
        fin_buf[:, :, :P] = prompt[:, None, :]
        fin_buf[:, :, P] = eos_id
    buf = torch.zeros((BN, total), dtype=torch.long, device=device)
    buf[:, :P] = prompt.repeat_interleave(nb, dim=0)
    buf[:, P] = tok0.reshape(BN)
    rows = torch.arange(B, device=device)[:, None] * nb

    def keep_live(parent, nxt, t):
        flat = (rows + parent).reshape(BN)
        if not torch.equal(flat, torch.arange(BN, device=device)):
            _reorder(module, cache, flat)
        out = buf[flat]
        out[:, t + 1] = nxt.reshape(BN)
        return out

    for t in range(P, total - 1):  # t = position of the token being fed
        logits = module(buf[:, t:t + 1], cache=cache, pos=t)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(B, nb, V)
        cand = (scores[:, :, None] + logp).reshape(B, nb * V)
        if eos_id is None:
            scores, idx = _top_k(cand, nb)
            buf = keep_live(idx // V, idx % V, t)
            continue
        k = min(2 * nb, nb * V)
        cand_sc, idx = _top_k(cand, k)
        parent, nxt = idx // V, idx % V
        is_eos = nxt == eos_id
        # candidate sequences [B, k, total]: the parent's buffer + the token
        cand_buf = torch.gather(
            buf.reshape(B, nb, total), 1, parent[:, :, None].expand(B, k, total)
        ).clone()
        cand_buf[:, :, t + 1] = nxt
        gen_len = torch.tensor(float(t + 2 - P), dtype=torch.float32, device=device)
        pen = torch.where(is_eos, cand_sc / gen_len ** lp, neg_inf)
        all_sc = torch.cat([fin_scores, pen], dim=1)
        all_buf = torch.cat([fin_buf, cand_buf], dim=1)
        fin_scores, fidx = _top_k(all_sc, nb)
        fin_buf = torch.gather(all_buf, 1, fidx[:, :, None].expand(B, nb, total))
        scores, pick = _top_k(torch.where(is_eos, neg_inf, cand_sc), nb)
        buf = keep_live(torch.gather(parent, 1, pick), torch.gather(nxt, 1, pick), t)

    out = buf.reshape(B, nb, total)
    live = scores / (float(max_new_tokens) ** lp)
    if eos_id is None:
        best = torch.argmax(live, dim=1)
        return out[torch.arange(B, device=device), best]
    # live beams (never eos-ended, full length) against the finished buffer
    all_sc = torch.cat([live, fin_scores], dim=1)
    all_buf = torch.cat([out, fin_buf], dim=1)
    best = torch.argmax(all_sc, dim=1)
    sel = all_buf[torch.arange(B, device=device), best]
    # finished hypotheses carry stale parent tokens after their eos: pad
    # with eos, as generate() does
    gen = sel[:, P:]
    seen = torch.cumsum((gen == eos_id).long(), dim=1) > 0
    after = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=device),
                       seen[:, :-1]], dim=1)
    sel[:, P:] = torch.where(after, torch.full_like(gen, eos_id), gen)
    return sel
