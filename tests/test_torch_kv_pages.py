"""The port's page accounting and KV manager against the JAX package's.

The same sequence of PagePool / PrefixCache operations runs on the port's
own copy (`polyaxon_tpu_torch/models/kv_pages.py`) and on
`polyaxon_tpu.models.kv_pages`, over the reference's own cases, and leaves
the same state: free, used and reserved pages, refcounts, the entries in
LRU order, hits, misses, evictions and collisions — and the same errors.
The KVCacheManager cases run on both managers (the port's over its torch
pool, the reference's over its JAX pool) and must plan, shed, allocate and
harvest alike; the port's harvested pages must hold the row's K/V."""

import numpy as np
import pytest
import torch

from polyaxon_tpu.models import kv_pages as ref_pages
from polyaxon_tpu_torch.models import kv_pages as port_pages
from polyaxon_tpu_torch.models.transformer import Transformer, _make_config
from tests.test_torch_transformer import SMALL


def _pool_state(pool):
    return {
        "free": pool.free_pages, "used": pool.used, "reserved": pool.reserved,
        "hwm": pool.used_hwm, "alloc_total": pool.alloc_total,
        "refs": {p: pool.refcount(p) for p in range(pool.n_pages)},
    }


def _cache_state(pc):
    return {
        "pool": _pool_state(pc.pool),
        # LRU order: entries sorted by their logical tick
        "entries": [
            (e.tokens, e.pages, e.active)
            for _, e in sorted(pc._entries.items(), key=lambda he: he[1].tick)
        ],
        "counters": (pc.hits, pc.misses, pc.evictions, pc.collisions, pc.inserts),
        "page_refs": pc.page_refs, "held": pc.held_pages,
    }


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the error kind is part of the state
        return ("raised", type(e).__name__)


# ---- the reference's cases (tests/test_kv_pages.py:30-129), as scenarios
# over a module `m` that provides PagedKVLayout, PagePool, PrefixCache,
# page_hashes; each returns the trail of outcomes and states it saw
def case_layout_pages_for(m):
    lay = m.PagedKVLayout(page_tokens=8, pool_pages=4)
    return [lay.pages_for(n) for n in (0, 1, 8, 9, 100)] + [
        m.DEFAULT_PAGE_TOKENS, _outcome(lambda: m.PagedKVLayout(page_tokens=0)),
    ]


def case_page_hashes_chain(m):
    toks = list(range(20))
    h = m.page_hashes(toks, 8)
    h2 = m.page_hashes([99] + toks[1:], 8)
    return [h, h2, m.page_hashes(toks[:16], 8) == h]


def case_pool_refcount_lifecycle(m):
    pool = m.PagePool(4, 8)
    trail = [pool.alloc(2), _pool_state(pool)]
    a = trail[0]
    pool.ref(a)
    pool.unref(a)
    trail.append(_pool_state(pool))
    pool.unref(a)
    trail += [_pool_state(pool), _outcome(lambda: pool.unref(a))]
    return trail


def case_pool_reservation_invariant(m):
    pool = m.PagePool(4, 8)
    pool.reserve(3)
    trail = [pool.available, _outcome(lambda: pool.reserve(2)),
             _outcome(lambda: pool.alloc(2)), pool.alloc(3, reserved=True),
             _pool_state(pool)]
    pool.unreserve(0)
    return trail + [_outcome(lambda: pool.unreserve(1)), _pool_state(pool)]


def _cache(m, pool_pages=16, pt=4, **kw):
    pool = m.PagePool(pool_pages, pt)
    return pool, m.PrefixCache(pool, **kw)


def case_prefix_insert_lookup_release(m):
    pool, pc = _cache(m)
    toks = list(range(8))
    pages = pool.alloc(2)
    trail = [pc.insert(toks[:4], pages[:1]), pc.insert(toks, pages),
             pc.insert(toks, pages)]
    pool.unref(pages)
    plen, got, entry = pc.lookup(toks + [77, 78])
    trail += [(plen, list(got)), _cache_state(pc)]
    pc.release(entry, got)
    plen, got, entry = pc.lookup(toks, max_tokens=len(toks) - 1)
    trail.append((plen, list(got)))
    pc.release(entry, got)
    return trail + [_cache_state(pc)]


def case_prefix_lru_eviction_skips_active(m):
    pool, pc = _cache(m, pool_pages=8, pt=4)
    a, b = list(range(4)), list(range(10, 14))
    pa, pb = pool.alloc(1), pool.alloc(1)
    trail = [pc.insert(a, pa), pc.insert(b, pb)]
    pool.unref(pa), pool.unref(pb)
    plen, got, ea = pc.lookup(a + [99])
    trail += [plen, pc.evict_for(8), pc.contains(a), pc.contains(b), _cache_state(pc)]
    pc.release(ea, got)
    return trail + [pc.evict_for(8), _cache_state(pc)]


def case_prefix_hash_collision_first_writer_wins(m):
    pool, pc = _cache(m, hash_fn=lambda prev, chunk: "same")
    a, b = list(range(4)), list(range(20, 24))
    pa = pool.alloc(1)
    trail = [pc.insert(a, pa)]
    pb = pool.alloc(1)
    trail.append(pc.insert(b, pb))
    pool.unref(pa), pool.unref(pb)
    plen, _, entry = pc.lookup(b + [1])
    trail += [plen, entry is None, _cache_state(pc)]
    plen, got, entry = pc.lookup(a + [1])
    pc.release(entry, got)
    return trail + [plen, _cache_state(pc)]


def case_prefix_evict_to_and_clear(m):
    """insert with max_pages evicts LRU-first down to the cap; clear()
    drops every entry."""
    pool, pc = _cache(m, pool_pages=8, pt=4, max_pages=2)
    trail = []
    for i in range(3):
        toks = list(range(10 * i, 10 * i + 4))
        page = pool.alloc(1)
        trail.append(pc.insert(toks, page))
        pool.unref(page)
        trail.append(_cache_state(pc))
    pc.clear()
    return trail + [_cache_state(pc)]


CASES = [
    case_layout_pages_for, case_page_hashes_chain, case_pool_refcount_lifecycle,
    case_pool_reservation_invariant, case_prefix_insert_lookup_release,
    case_prefix_lru_eviction_skips_active,
    case_prefix_hash_collision_first_writer_wins, case_prefix_evict_to_and_clear,
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_page_accounting_matches_reference(case):
    assert case(port_pages) == case(ref_pages)


# ---- KVCacheManager (tests/test_kv_pages.py:185-244), on both managers
PL, NL = (8, 16, 32), (4, 8)
MGR_CFG = {**SMALL, "seq_len": 64}


@pytest.fixture(scope="module")
def managers():
    """make(pool_pages, pt) → (port manager, reference manager)."""
    import jax
    import jax.numpy as jnp

    from polyaxon_tpu.models import build_model
    from polyaxon_tpu.serving.kv import KVCacheManager as RefManager
    from polyaxon_tpu_torch.serving.kv import KVCacheManager

    bundle = build_model("transformer_lm", MGR_CFG)
    params = bundle.module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32), train=False
    )["params"]
    model = Transformer(_make_config(MGR_CFG), device="cpu")

    def make(pool_pages=16, pt=8):
        return (
            KVCacheManager(model, pool_pages=pool_pages, page_tokens=pt),
            RefManager(bundle.module, params, pool_pages=pool_pages, page_tokens=pt),
        )

    return make


def _mgr_state(kv):
    s = kv.stats()
    s.pop("kv_pool_bytes")
    s.get("prefix", {}).pop("held_pages", None)  # the port's addition
    return s, _pool_state(kv.pool)


def _plan(p):
    return (p.prefix_len, p.prefix_pages, p.suffix_bucket, p.new_bucket,
            p.n_pages, p.reserved, list(p.own_pages), p.released)


def _both(managers, scenario, **kw):
    port, ref = managers(**kw)
    return scenario(port), scenario(ref)


def mgr_reserve_alloc_release(kv):
    plan = kv.plan_row(list(range(1, 13)), 4, PL, NL, 64)
    trail = [_plan(plan), _mgr_state(kv)]
    kv.ensure_pages([plan], upto_slot=16)
    t = np.asarray(kv.tables([plan, None], 2, 3)).tolist()
    trail += [_plan(plan), t, t[0][2] == kv.scratch]
    kv.release(plan)
    kv.release(plan)  # idempotent
    return trail + [_mgr_state(kv)]


def mgr_exhaustion_sheds_with_reason(kv):
    p1 = kv.plan_row(list(range(1, 9)), 4, PL, NL, 64)
    p2 = kv.plan_row(list(range(20, 28)), 4, PL, NL, 64)
    try:
        kv.plan_row(list(range(40, 48)), 4, PL, NL, 64)
        shed = None
    except Exception as e:  # noqa: BLE001
        shed = (type(e).__name__, getattr(e, "reason", None))
    kv.release(p1)
    p3 = kv.plan_row(list(range(40, 48)), 4, PL, NL, 64)
    kv.release(p2), kv.release(p3)
    return [shed, _plan(p3), _mgr_state(kv)]


def mgr_never_fits_is_client_error(kv):
    try:
        kv.plan_row(list(range(1, 40)), 8, PL, NL, 64)
        err = None
    except Exception as e:  # noqa: BLE001
        err = (type(e).__name__, hasattr(e, "reason"))
    return [err, _mgr_state(kv)]


def mgr_occupancy_beats_dense(kv):
    plans = [kv.plan_row([1 + i] * 8, 4, PL, NL, 64) for i in range(7)]
    trail = [kv.dense_equivalent_rows, kv.active_rows, _mgr_state(kv)]
    for p in plans:
        kv.release(p)
    return trail


def mgr_harvest_indexes_prefix(kv):
    toks = list(range(1, 23))  # 22 tokens = 2 full pages + tail
    plan = kv.plan_row(toks, 4, PL, NL, 64)
    kv.ensure_pages([plan], upto_slot=plan.suffix_bucket + plan.new_bucket - 1)
    pad = plan.suffix_bucket - len(toks)
    trail = [kv.harvest([(toks, plan, pad)]), _mgr_state(kv)]
    kv.release(plan)
    p2 = kv.plan_row(toks[:16] + [99, 98], 4, PL, NL, 64)
    trail += [_plan(p2), _mgr_state(kv)]
    kv.release(p2)
    return trail + [_mgr_state(kv)]


MGR_CASES = {
    "reserve-alloc-release": (mgr_reserve_alloc_release, {}),
    "exhaustion-sheds-kv_pages": (mgr_exhaustion_sheds_with_reason, {"pool_pages": 6}),
    "never-fits-is-400": (mgr_never_fits_is_client_error, {"pool_pages": 3}),
    "occupancy-beats-dense": (mgr_occupancy_beats_dense, {"pool_pages": 16}),
    "harvest-indexes-prefix": (mgr_harvest_indexes_prefix, {"pool_pages": 32}),
}


@pytest.mark.parametrize("name", list(MGR_CASES))
def test_kv_manager_matches_reference(managers, name):
    scenario, kw = MGR_CASES[name]
    ours, ref = _both(managers, scenario, **kw)
    assert ours == ref


def test_exhaustion_is_a_503_shed_and_never_fits_a_400(managers):
    from polyaxon_tpu_torch.serving.batching import ServingError, ShedError

    kv, _ = managers(pool_pages=6)
    kv.plan_row(list(range(1, 9)), 4, PL, NL, 64)
    kv.plan_row(list(range(20, 28)), 4, PL, NL, 64)
    with pytest.raises(ShedError) as ei:
        kv.plan_row(list(range(40, 48)), 4, PL, NL, 64)
    assert ei.value.reason == "kv_pages"
    small, _ = managers(pool_pages=3)
    with pytest.raises(ServingError) as ei:
        small.plan_row(list(range(1, 40)), 8, PL, NL, 64)
    assert not isinstance(ei.value, ShedError)
    assert small.active_rows == 0


def test_harvest_copies_the_rows_kv(managers):
    """The harvested pages hold the row's prompt K/V, page-aligned on the
    prompt's tokens, in every layer; the source pages are untouched."""
    kv, _ = managers(pool_pages=32)
    toks = list(range(1, 23))
    plan = kv.plan_row(toks, 4, PL, NL, 64)
    kv.ensure_pages([plan], upto_slot=plan.suffix_bucket + plan.new_bucket - 1)
    g = torch.Generator().manual_seed(0)
    for pool_k, pool_v in kv.cache:
        pool_k.copy_(torch.randn(pool_k.shape, generator=g))
        pool_v.copy_(torch.randn(pool_v.shape, generator=g))
    before = [(k.clone(), v.clone()) for k, v in kv.cache]
    pad = plan.suffix_bucket - len(toks)
    assert kv.harvest([(toks, plan, pad)]) == 2
    pages = kv.prefix.lookup(toks[:16] + [5])[1]
    own = plan.own_pages
    pt = kv.layout.page_tokens
    for (k, v), (k0, v0) in zip(kv.cache, before):
        window_k = k0[own].reshape(-1, *k0.shape[2:])
        window_v = v0[own].reshape(-1, *v0.shape[2:])
        assert torch.equal(k[list(pages)].reshape(-1, *k.shape[2:]), window_k[pad:pad + 2 * pt])
        assert torch.equal(v[list(pages)].reshape(-1, *v.shape[2:]), window_v[pad:pad + 2 * pt])
        assert torch.equal(k[own], k0[own])
