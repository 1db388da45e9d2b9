"""The port's paged KV decode against the JAX package's, on the CPU.

Both sides get the same weights (`params_from_jax`), the same page tables
and the same inputs, made with numpy from a seed. Logits of every paged
prefill and step agree within 1e-4 (f32, sum order only), and so do the
pool's live slots. Greedy tokens are identical to the JAX paged path's and
to the port's dense `generate`, over the ladder of the JAX package's own
identity cases. Sampled tokens differ from jax.random's by construction, so
they are held within the port: the same row gives the same tokens dense
bucketed, paged one-shot, chunked and stepped."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.kv_pages import PagedKVLayout as JLayout
from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout

from tests.test_torch_transformer import LOGIT_TOL, jax_lm, torch_lm

# the modules, not the `generate` functions both packages re-export
jgen = importlib.import_module("polyaxon_tpu.models.generate")
tgen = importlib.import_module("polyaxon_tpu_torch.models.generate")

POOL = 64


@pytest.fixture(scope="module")
def pair():
    module, params = jax_lm({"attention": "xla"})
    return module, params, torch_lm(module, params)


class Both:
    """One JAX pool and one port pool of the same layout, driven with the
    same decode calls; each call returns (port logits, JAX logits)."""

    def __init__(self, pair, pt):
        self.module, self.params, self.model = pair
        self.jl, self.tl = JLayout(pt, POOL), PagedKVLayout(pt, POOL)
        self.cache_j = jgen.make_paged_cache(self.module, self.params, self.jl)
        self.cache_t = tgen.make_paged_cache(self.model, self.tl)

    def apply(self, toks, *, pos, pad, pages, prefix_len=0, prefix_lens=None):
        jkw = dict(pad=jnp.asarray(pad, jnp.int32), pages=jnp.asarray(pages, jnp.int32),
                   pos=jnp.asarray(pos, jnp.int32), prefix_len=prefix_len)
        tkw = dict(pad=torch.from_numpy(np.asarray(pad)), pages=torch.from_numpy(pages),
                   pos=pos, prefix_len=prefix_len)
        if prefix_lens is not None:
            jkw["prefix_lens"] = jnp.asarray(prefix_lens, jnp.int32)
            tkw["prefix_lens"] = torch.from_numpy(np.asarray(prefix_lens))
        ref, out_vars = self.module.apply(
            {"params": self.params, "cache": self.cache_j}, jnp.asarray(toks),
            train=False, decode=True, mutable=["cache"], kv_layout=self.jl, **jkw,
        )
        self.cache_j = out_vars["cache"]
        with torch.inference_mode():
            out = self.model(torch.from_numpy(toks).long(), cache=self.cache_t,
                             kv_layout=self.tl, **tkw)
        return out.numpy(), np.asarray(ref)

    def pools(self, layer=1):
        ref = np.asarray(self.cache_j[f"layer_{layer}"]["attention"]["cached_key"])
        return self.cache_t[layer][0].numpy(), ref


def _rng_tokens(rng, n):
    return rng.integers(1, 256, n).tolist()


def test_paged_prefill_and_steps_match_jax_logits(pair):
    """A shared prefix prefilled once; three rows prefilled on their own
    (left-padded suffixes, with and without the prefix), then three batched
    steps at per-row frontiers, generation indices and prefix widths."""
    pt, pb = 4, 8
    both = Both(pair, pt)
    rng = np.random.default_rng(0)
    shared = _rng_tokens(rng, 8)
    prefix_pages = [1, 2]
    out, ref = both.apply(np.array([shared], np.int32), pos=0, pad=[0],
                          pages=np.array([prefix_pages], np.int32))
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    rows = [(8, 5), (0, 8), (8, 2)]  # (prefix width, suffix length)
    n_pages = 6
    tables = np.zeros((3, n_pages), np.int32)
    nxt = 3
    for b, (L, _) in enumerate(rows):
        own = list(range(nxt, nxt + n_pages - L // pt))
        nxt += len(own)
        tables[b] = (prefix_pages if L else []) + own
    pads, pos, prefix_lens = [], [], []
    for b, (L, n) in enumerate(rows):
        sfx = np.zeros((1, pb), np.int32)
        sfx[0, pb - n:] = _rng_tokens(rng, n)
        out, ref = both.apply(sfx, pos=L, pad=[pb - n], pages=tables[b:b + 1],
                              prefix_lens=[L])
        np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        pads.append(pb - n)
        pos.append(L + pb)
        prefix_lens.append(L)
    for _ in range(3):
        tok = rng.integers(1, 256, (3, 1)).astype(np.int32)
        out, ref = both.apply(tok, pos=np.array(pos), pad=np.array(pads),
                              pages=tables, prefix_lens=np.array(prefix_lens))
        np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        pos = [p + 1 for p in pos]
    ours, theirs = both.pools()
    live = sorted({int(p) for p in tables.ravel()})  # every page a row wrote or read
    np.testing.assert_allclose(ours[live], theirs[live], atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_paged_prefill_with_static_prefix_matches_jax(pair):
    """The coalesced group's form: one static prefix width for the group,
    left-padded suffixes, a scalar write position."""
    pt, pb = 8, 8
    both = Both(pair, pt)
    rng = np.random.default_rng(1)
    shared = _rng_tokens(rng, 8)
    both.apply(np.array([shared], np.int32), pos=0, pad=[0], pages=np.array([[1]], np.int32))
    tables = np.array([[1, 2, 3], [1, 4, 5]], np.int32)
    sfx = np.zeros((2, pb), np.int32)
    sfx[0, 3:] = _rng_tokens(rng, 5)
    sfx[1] = _rng_tokens(rng, 8)
    pad = np.array([3, 0])
    out, ref = both.apply(sfx, pos=8, pad=pad, pages=tables, prefix_len=8)
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for t in range(2):
        tok = rng.integers(1, 256, (2, 1)).astype(np.int32)
        out, ref = both.apply(tok, pos=16 + t, pad=pad, pages=tables, prefix_len=8)
        np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_slot_past_the_table_is_dropped(pair):
    """A window that overruns the row's table: the reference drops those
    writes (a fill page id past the pool, mode="drop"); the port masks them
    and never clamps them onto the row's last page."""
    both = Both(pair, 4)
    tables = np.array([[3]], np.int32)  # one page: slots 0..3
    toks = np.array([[5, 6, 7, 8]], np.int32)  # slots 2..5; 4 and 5 overrun
    out, ref = both.apply(toks, pos=2, pad=[0], pages=tables)
    np.testing.assert_allclose(out[:, :2], ref[:, :2], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    ours, theirs = both.pools()
    assert not ours[3, :2].any()  # slots 0, 1 of the live page untouched
    assert ours[3, 2:].any()
    np.testing.assert_allclose(ours, theirs, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    untouched = [p for p in range(POOL) if p != 3]
    assert not ours[untouched].any()


def _case_prompts(prefix_len, pb, seed=1):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 100, size=prefix_len).tolist()
    sfx_lens = [max(1, pb - 3), pb, max(1, pb // 2)]
    return shared, [shared + rng.randint(1, 100, size=s).tolist() for s in sfx_lens]


def _dense(pair, prompts, nb, temp, eos, seeds):
    """The port's dense bucketed generate over the full prompts, each row's
    generated tokens."""
    model = pair[2]
    P = max(len(p) for p in prompts)
    arr = np.zeros((len(prompts), P), np.int64)
    lens = np.array([len(p) for p in prompts])
    for i, p in enumerate(prompts):
        arr[i, P - len(p):] = p
    out = tgen.generate(model, torch.from_numpy(arr), max_new_tokens=nb,
                        temperature=temp, top_k=40, eos_id=eos, seed=list(seeds),
                        prompt_lengths=torch.from_numpy(lens)).numpy()
    return out[:, P:], arr, lens


def _paged_tables(B, prefix_len, pb, nb, pt):
    n_pages = -(-(prefix_len + pb + nb) // pt)
    L_pages = prefix_len // pt
    prefix_ids = list(range(1, 1 + L_pages))
    tables = np.zeros((B, n_pages), np.int32)
    nxt = 1 + L_pages
    for i in range(B):
        own = list(range(nxt, nxt + n_pages - L_pages))
        nxt += len(own)
        tables[i] = prefix_ids + own
    return tables, prefix_ids


def _paged_port(pair, shared, prompts, pb, nb, pt, chunk, prefix_len, temp, eos, seeds):
    """Shared prefix prefilled once, rows alias its pages read-only; then
    the suffix prefill and decode chunks of `chunk` steps."""
    model = pair[2]
    B = len(prompts)
    layout = PagedKVLayout(pt, POOL)
    cache = tgen.make_paged_cache(model, layout)
    tables, prefix_ids = _paged_tables(B, prefix_len, pb, nb, pt)
    if prefix_len:
        tgen.paged_prefill(model, cache, np.array([shared]), pad=[0],
                           pages=np.array([prefix_ids]), kv_layout=layout,
                           prefix_len=0, temperature=temp, top_k=40, seeds=[0])
    sfx = np.zeros((B, pb), np.int64)
    pads = np.zeros(B, np.int64)
    for i, p in enumerate(prompts):
        s = p[prefix_len:]
        sfx[i, pb - len(s):] = s
        pads[i] = pb - len(s)
    first = tgen.paged_prefill(model, cache, sfx, pad=pads, pages=tables,
                               kv_layout=layout, prefix_len=prefix_len,
                               temperature=temp, top_k=40, seeds=seeds)
    out = [first[:, None]]
    tok, done = first, torch.zeros(B, dtype=torch.bool)
    pos, g, left = prefix_len + pb, 1, nb - 1
    while left > 0:
        C = min(chunk, left)
        toks, done = tgen.paged_decode_chunk(
            model, cache, tok, done, steps=C, pos=pos, start_g=g, pad=pads,
            pages=tables, kv_layout=layout, prefix_len=prefix_len,
            temperature=temp, top_k=40, eos_id=eos, seeds=seeds,
        )
        out.append(toks)
        tok = toks[:, -1]
        pos, g, left = pos + C, g + C, left - C
    return torch.cat(out, dim=1).numpy(), (cache, layout, tables, pads)


def _paged_jax(pair, shared, prompts, pb, nb, pt, prefix_len, eos):
    """The JAX package's greedy paged path over the same tables."""
    module, params, _ = pair
    B = len(prompts)
    layout = JLayout(pt, POOL)
    cache = jgen.make_paged_cache(module, params, layout)
    tables, prefix_ids = _paged_tables(B, prefix_len, pb, nb, pt)
    if prefix_len:
        cache, _ = jgen.paged_prefill(
            module, params, cache, jnp.asarray([shared], jnp.int32),
            pad=jnp.zeros((1,), jnp.int32), pages=jnp.asarray([prefix_ids], jnp.int32),
            kv_layout=layout, prefix_len=0, temperature=0.0, top_k=40,
            seeds=jnp.zeros((1,), jnp.int32))
    sfx = np.zeros((B, pb), np.int32)
    pads = np.zeros(B, np.int32)
    for i, p in enumerate(prompts):
        s = p[prefix_len:]
        sfx[i, pb - len(s):] = s
        pads[i] = pb - len(s)
    seeds = jnp.zeros((B,), jnp.int32)
    cache, first = jgen.paged_prefill(
        module, params, cache, jnp.asarray(sfx), pad=jnp.asarray(pads),
        pages=jnp.asarray(tables), kv_layout=layout, prefix_len=prefix_len,
        temperature=0.0, top_k=40, seeds=seeds)
    _, toks, _ = jgen.paged_decode_chunk(
        module, params, cache, first, jnp.zeros((B,), bool), steps=nb - 1,
        pos=prefix_len + pb, start_g=1, pad=jnp.asarray(pads),
        pages=jnp.asarray(tables), kv_layout=layout, prefix_len=prefix_len,
        temperature=0.0, top_k=40, eos_id=eos, seeds=seeds)
    return np.concatenate([np.asarray(first)[:, None], np.asarray(toks)], axis=1)


# the JAX package's identity ladder (tests/test_kv_pages.py), at the port's
# one layer layout (scan_layers is not ported): (pb, nb, pt, chunk,
# prefix_len, eos)
LADDER = [
    (8, 8, 4, 3, 8, 5),
    (8, 8, 4, 3, 0, 5),
    (16, 8, 8, 8, 8, 5),
    (8, 5, 16, 2, 0, None),  # page wider than the window
    (8, 8, 4, 4, 12, 2),  # aggressive eos
]


@pytest.mark.parametrize("pb,nb,pt,chunk,prefix_len,eos", LADDER)
def test_paged_greedy_equals_jax_and_dense(pair, pb, nb, pt, chunk, prefix_len, eos):
    shared, prompts = _case_prompts(prefix_len, pb)
    seeds = [7, 11, 13]
    paged, _ = _paged_port(pair, shared, prompts, pb, nb, pt, chunk, prefix_len,
                           0.0, eos, seeds)
    dense, _, _ = _dense(pair, prompts, nb, 0.0, eos, seeds)
    np.testing.assert_array_equal(paged, dense)
    ref = _paged_jax(pair, shared, prompts, pb, nb, pt, prefix_len, eos)
    np.testing.assert_array_equal(paged, ref)


@pytest.mark.parametrize("pb,nb,pt,chunk,prefix_len,eos", LADDER[:2] + LADDER[4:])
def test_paged_sampled_equals_dense(pair, pb, nb, pt, chunk, prefix_len, eos):
    """The load-bearing shape of the reference's own identity test: a
    shared prefix from a separate prefill, odd chunking, eos, sampled rows."""
    shared, prompts = _case_prompts(prefix_len, pb)
    seeds = [7, 11, 13]
    paged, _ = _paged_port(pair, shared, prompts, pb, nb, pt, chunk, prefix_len,
                           0.8, eos, seeds)
    dense, _, _ = _dense(pair, prompts, nb, 0.8, eos, seeds)
    np.testing.assert_array_equal(paged, dense)


def _stepped(pair, prompts, nb, pt, chunk_w, temp, eos, seeds, width=8):
    """The step scheduler's path: each row prefilled alone in slices of
    `chunk_w` through its own table (no prefix), then every row decoded
    together one `paged_step` at a time at its own frontier."""
    model = pair[2]
    B = len(prompts)
    layout = PagedKVLayout(pt, POOL)
    cache = tgen.make_paged_cache(model, layout)
    buckets = [-(-len(p) // width) * width for p in prompts]
    n_pages = -(-(max(buckets) + nb) // pt)
    tables = 1 + np.arange(B * n_pages).reshape(B, n_pages)
    first, pads = [], []
    for b, (p, wb) in enumerate(zip(prompts, buckets)):
        # row b's own bucket is its length rounded up to `width`
        arr = np.zeros((1, wb), np.int64)
        arr[0, wb - len(p):] = p
        pads.append(wb - len(p))
        off = 0
        while off < wb:
            w = min(chunk_w, wb - off)
            out = tgen.paged_prefill_chunk(
                model, cache, arr[:, off:off + w], pad=[wb - len(p)],
                pages=tables[b:b + 1], kv_layout=layout, prefix_lens=[0],
                pos=off, temperature=temp, top_k=40, seeds=[seeds[b]],
                final=off + w >= wb,
            )
            off += w
        first.append(int(out[0]))
    pos = list(buckets)
    gen = [[f] for f in first]
    tok = torch.tensor(first)
    done = torch.zeros(B, dtype=torch.bool)
    for step in range(nb - 1):
        tok, done = tgen.paged_step(
            model, cache, tok, done, pad=pads, prefix_lens=[0] * B, pages=tables,
            kv_layout=layout, pos=pos, g=[1 + step] * B, seeds=seeds,
            temperature=temp, top_k=40, eos_id=eos,
        )
        for b in range(B):
            gen[b].append(int(tok[b]))
        pos = [p + 1 for p in pos]
    return np.array(gen)


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "sampled"])
def test_stepped_rows_equal_dense(pair, temp):
    """Rows of different lengths (so different frontiers and pads), each
    chunk-prefilled alone, then stepped together: the same tokens as the
    dense bucketed batch, sampled as well as greedy."""
    _, prompts = _case_prompts(0, 12, seed=4)
    seeds = [3, 5, 9]
    stepped = _stepped(pair, prompts, 7, 4, 3, temp, None, seeds)
    dense, _, _ = _dense(pair, prompts, 7, temp, None, seeds)
    np.testing.assert_array_equal(stepped, dense)


# chunked against one-shot pools: the two prefills take different product
# shapes (M = 5 then 3 rows against 8), and the CPU's thread split of those
# products changes the f32 sum order. Measured 1.25e-6 absolute (1.4e-5
# relative) on 3 of 4096 K elements at 2 threads; 0 at 1 and 4 threads
KV_SUM_ORDER_TOL = 1e-5


@pytest.fixture(params=[1, 2, 4], ids=lambda n: f"threads{n}")
def threads(request):
    before = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(before)


def test_chunked_prefill_equals_one_shot(pair, threads):
    """Prefill in slices of 5 then a ragged 3 decodes exactly the tokens of
    one-shot prefill (sampled rows), at every CPU thread split; the two
    pools agree within f32 sum order, and both hold the JAX package's
    one-shot pool within LOGIT_TOL."""
    module, params, model = pair
    B, P, nb = 2, 8, 6
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 256, size=(B, P))
    seeds, pads = [7, 11], np.zeros(B, np.int64)
    layout = PagedKVLayout(4, 32)
    n_pages = -(-(P + nb) // 4)
    tables = 1 + np.arange(B * n_pages).reshape(B, n_pages)

    def decode(cache, first):
        toks, _ = tgen.paged_decode_chunk(
            model, cache, first, torch.zeros(B, dtype=torch.bool), steps=nb - 1,
            pos=P, start_g=1, pad=pads, pages=tables, kv_layout=layout,
            prefix_len=0, temperature=0.8, top_k=40, eos_id=None, seeds=seeds)
        return torch.cat([first[:, None], toks], dim=1).numpy()

    one_cache = tgen.make_paged_cache(model, layout)
    first = tgen.paged_prefill(model, one_cache, prompt, pad=pads, pages=tables,
                               kv_layout=layout, prefix_len=0, temperature=0.8,
                               top_k=40, seeds=seeds)
    one = decode(one_cache, first)
    two_cache = tgen.make_paged_cache(model, layout)
    assert tgen.paged_prefill_chunk(
        model, two_cache, prompt[:, :5], pad=pads, pages=tables, kv_layout=layout,
        prefix_lens=[0, 0], pos=0, final=False) is None
    first2 = tgen.paged_prefill_chunk(
        model, two_cache, prompt[:, 5:], pad=pads, pages=tables, kv_layout=layout,
        prefix_lens=[0, 0], pos=5, temperature=0.8, top_k=40, seeds=seeds,
        final=True)
    two = decode(two_cache, first2)
    np.testing.assert_array_equal(one, two)
    for (k1, v1), (k2, v2) in zip(one_cache, two_cache):
        for a, b in ((k1, k2), (v1, v2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=KV_SUM_ORDER_TOL,
                                       rtol=KV_SUM_ORDER_TOL)
    # the prompt's pages (slots < P; decode writes only later slots) against
    # the JAX package's one-shot prefill into the same tables
    jl = JLayout(4, 32)
    jcache, _ = jgen.paged_prefill(
        module, params, jgen.make_paged_cache(module, params, jl), jnp.asarray(prompt),
        pad=jnp.asarray(pads, jnp.int32), pages=jnp.asarray(tables, jnp.int32),
        kv_layout=jl, prefix_len=0, temperature=0.0, top_k=None,
        seeds=jnp.asarray(seeds, jnp.int32))
    prompt_pages = tables[:, : P // 4].reshape(-1)
    for layer in range(model.cfg.n_layers):
        ref = jcache[f"layer_{layer}"]["attention"]
        for f, name in ((0, "cached_key"), (1, "cached_value")):
            want = np.asarray(ref[name])[prompt_pages]
            for cache in (one_cache, two_cache):
                np.testing.assert_allclose(cache[layer][f].numpy()[prompt_pages], want,
                                           atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_int8_pool_is_refused():
    """The int8 pool is ported (tests/test_torch_quant.py holds it against
    the reference); a pool element type the reference does not know is
    still refused."""
    assert PagedKVLayout(8, 4, kv_quant="int8").kv_quant == "int8"
    with pytest.raises(ValueError, match="kv_quant"):
        PagedKVLayout(8, 4, kv_quant="fp8")


def test_dense_per_row_frontiers_match_jax(pair):
    """Per-row write frontiers on the dense cache (the reference's [B, S]
    slot grid): rows prefilled together with left pad, then a 3-token
    window at a different frontier per row, the last row's window running
    past the cache's end (those slots are dropped on both sides)."""
    module, params, model = pair
    rng = np.random.default_rng(7)
    B, P = 3, 10
    pad = np.array([0, 4, 2])
    prompt = rng.integers(1, 256, (B, P)).astype(np.int32)
    _, vars0 = module.apply({"params": params}, jnp.zeros((B, 1), jnp.int32),
                            train=False, decode=True, mutable=["cache"])
    cache_j, cache_t = vars0["cache"], model.make_cache(B)
    pos = np.array([P, P + 5, 126])  # seq_len 128: row 2 writes 126, 127, (128)
    for toks, p in ((prompt, 0), (rng.integers(1, 256, (B, 3)).astype(np.int32), pos)):
        ref, out_vars = module.apply(
            {"params": params, "cache": cache_j}, jnp.asarray(toks), train=False,
            decode=True, mutable=["cache"], pad=jnp.asarray(pad, jnp.int32),
            pos=jnp.asarray(p, jnp.int32),
        )
        cache_j = out_vars["cache"]
        with torch.inference_mode():
            out = model(torch.from_numpy(toks).long(), cache=cache_t,
                        pad=torch.from_numpy(pad), pos=p)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    k_ref = np.asarray(cache_j["layer_1"]["attention"]["cached_key"])
    np.testing.assert_allclose(cache_t[1][0].numpy(), k_ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)
