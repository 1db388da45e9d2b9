"""The port's tiered KV spill (`serving/spill.py`, the spill tier of
`serving/kv.py`) against the JAX package's, on the CPU.

- SpillManager units, as the reference's own tests hold them: RAM and disk
  round trips byte-identical, RAM overflow demotes to disk, the disk budget
  drops the oldest, and the heal pass truncates torn tails, deletes
  incomplete segments and quarantines corrupt ones; chaos at `kv.spill`
  (a kill after the meta frame is ignorable, after the payload frames
  restorable, a scrambled tail heals);
- segments are interchangeable: one written by the port reads in the JAX
  SpillManager and the other way, for bf16, f32 and int8-pool payloads;
- the KV manager: a kill at `kv.restore` and a restore that loses its
  admission race leak no page and leave no reservation or queued write;
  a prefix harvested in one namespace (an adapter's) is missed by the
  others, demoted and restored in its own, and the empty namespace hashes
  as the reference does;
- a live port server whose prefix is evicted to RAM or disk and hit again
  restores the demoted bytes into the pool and decodes the JAX server's
  greedy tokens.
"""

import hashlib

import numpy as np
import pytest
import torch

from polyaxon_tpu.serving.spill import SpillManager as JSpill
from polyaxon_tpu.serving.spill import SpillPayload as JPayload
from polyaxon_tpu_torch.chaos import (
    Fault,
    FaultPlan,
    SimulatedKill,
    active,
    corrupt_segment_frame,
)
from polyaxon_tpu_torch.models.kv_pages import page_hashes
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.kv import KVCacheManager
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.serving.spill import SpillManager, SpillPayload

from tests.test_torch_serving_batch import lm, post  # noqa: F401

PT = 8  # page_tokens used throughout


def _payload(n_pages=2, seed=0, first_token=1, dtypes=(torch.float32, torch.float32)):
    """A synthetic spilled entry: n_pages full pages of tokens and one leaf
    per dtype of random values per page."""
    gen = torch.Generator().manual_seed(seed)
    tokens = tuple(range(first_token, first_token + n_pages * PT))
    hashes = tuple(page_hashes(tokens, PT))
    pages = []
    for _ in range(n_pages):
        page = []
        for dt in dtypes:
            if dt == torch.int8:
                page.append(torch.randint(-127, 128, (PT, 2, 4), generator=gen).to(dt))
            elif dt == "scale":
                page.append(torch.rand((PT, 2), generator=gen))
            else:
                page.append(torch.randn((PT, 2, 4), generator=gen).to(dt))
        pages.append(page)
    return SpillPayload(tokens, hashes, pages)


def _same_bytes(a: SpillPayload, b: SpillPayload) -> bool:
    if a.tokens != b.tokens or a.hashes != b.hashes or len(a.pages) != len(b.pages):
        return False
    return all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.reshape(-1).view(torch.uint8).equal(y.reshape(-1).view(torch.uint8))
        for pa, pb in zip(a.pages, b.pages) for x, y in zip(pa, pb)
    )


# ---------------------------------------------------- SpillManager units
def test_ram_roundtrip_byte_identical():
    sm = SpillManager(ram_bytes=1 << 20)
    p = _payload()
    assert sm.put(p)
    h = p.hashes[-1]
    assert h in sm.heads() and sm.has(h, p.tokens)
    # verified content: a forced collision reads as a miss
    assert not sm.has(h, tuple(t + 1 for t in p.tokens))
    got = sm.take(h, p.tokens)
    assert got is not None and _same_bytes(p, got)
    assert not sm.has(h, p.tokens) and sm.restored_ram == 1


def test_ram_overflow_demotes_to_disk_and_restores(tmp_path):
    p1, p2 = _payload(seed=1, first_token=1), _payload(seed=2, first_token=1000)
    sm = SpillManager(ram_bytes=p1.nbytes + 1, dir_path=str(tmp_path))
    assert sm.put(p1) and sm.put(p2)
    assert sm.ram_entries == 1 and sm.disk_entries == 1
    assert len(list(tmp_path.glob("*.seg"))) == 1
    got = sm.take(p1.hashes[-1], p1.tokens)
    assert got is not None and _same_bytes(p1, got)
    assert sm.restored_disk == 1 and not list(tmp_path.glob("*.seg"))


def test_disk_budget_drops_oldest(tmp_path):
    p1, p2 = _payload(seed=1, first_token=1), _payload(seed=2, first_token=1000)
    sm = SpillManager(dir_path=str(tmp_path), dir_bytes=p1.nbytes + 1)
    assert sm.put(p1) and sm.put(p2)
    assert sm.disk_entries == 1 and sm.dropped == 1
    assert not sm.has(p1.hashes[-1], p1.tokens) and sm.has(p2.hashes[-1], p2.tokens)


def test_heal_truncates_torn_tail(tmp_path):
    p = _payload(seed=3)
    assert SpillManager(dir_path=str(tmp_path)).put(p)
    (seg,) = tmp_path.glob("*.seg")
    with open(seg, "ab") as f:
        f.write(b"\x7fgarbage-torn-tail")
    sm2 = SpillManager(dir_path=str(tmp_path))
    got = sm2.take(p.hashes[-1], p.tokens)
    assert got is not None and _same_bytes(p, got)


def test_corrupt_segment_quarantines_clean_miss(tmp_path):
    p = _payload(seed=4)
    assert SpillManager(dir_path=str(tmp_path)).put(p)
    (seg,) = tmp_path.glob("*.seg")
    corrupt_segment_frame(str(seg))
    sm2 = SpillManager(dir_path=str(tmp_path))
    assert sm2.quarantined == 1 and not sm2.has(p.hashes[-1], p.tokens)
    assert list(tmp_path.glob("*.seg.corrupt")) and not list(tmp_path.glob("*.seg"))
    sm3 = SpillManager(dir_path=str(tmp_path))  # the quarantined file is inert
    assert sm3.quarantined == 0 and sm3.disk_entries == 0
    assert sm3.put(p) and sm3.has(p.hashes[-1], p.tokens)


@pytest.mark.parametrize("at,action,restorable", [
    (0, "kill", False), (1, "kill", True), (1, "scramble_tail", True),
], ids=["after-meta", "after-frames", "scrambled-tail"])
def test_chaos_mid_spill_is_restorable_or_ignorable(tmp_path, at, action, restorable):
    p = _payload(seed=5 + at)
    sm = SpillManager(dir_path=str(tmp_path))
    with active(FaultPlan([Fault("kv.spill", action, at=at)], seed=11)), \
            pytest.raises(SimulatedKill):
        sm.put(p)
    sm2 = SpillManager(dir_path=str(tmp_path))
    got = sm2.take(p.hashes[-1], p.tokens)
    if restorable:
        assert got is not None and _same_bytes(p, got)
    else:
        assert got is None and sm2.incomplete >= 1 and sm2.disk_entries == 0
        assert sm2.put(p)  # the directory stays usable


# ------------------------------------------- segments across the packages
POOLS = {
    "bf16": (torch.bfloat16, torch.bfloat16),
    "f32": (torch.float32, torch.float32),
    "int8": (torch.int8, "scale", torch.int8, "scale"),
}


def _to_numpy(t):
    import ml_dtypes

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("pool", list(POOLS))
def test_segments_read_across_packages(tmp_path, pool):
    p = _payload(n_pages=3, seed=9, dtypes=POOLS[pool])
    # the port writes, the JAX package heals and restores it
    assert SpillManager(dir_path=str(tmp_path / "port")).put(p)
    ref = JSpill(dir_path=str(tmp_path / "port"))
    got = ref.take(p.hashes[-1], p.tokens)
    assert got is not None and got.tokens == p.tokens and got.hashes == p.hashes
    for page, want in zip(got.pages, p.pages):
        for a, t in zip(page, want):
            assert a.dtype == _to_numpy(t).dtype and a.shape == tuple(t.shape)
            assert a.tobytes() == _to_numpy(t).tobytes()
    # the JAX package writes, the port restores it
    jp = JPayload(p.tokens, p.hashes, [[_to_numpy(t) for t in page] for page in p.pages])
    assert JSpill(dir_path=str(tmp_path / "jax")).put(jp)
    mine = SpillManager(dir_path=str(tmp_path / "jax")).take(p.hashes[-1], p.tokens)
    assert mine is not None and _same_bytes(p, mine)
    assert mine.nbytes == jp.nbytes == p.nbytes


# ------------------------------------------- KVCacheManager restore races
LADDERS = ((32,), (8,))


def _collide_hash(prev, chunk):
    # token ids 100 apart hash identically — a forced chain collision
    canon = tuple(int(t) % 100 for t in chunk)
    return hashlib.blake2b(repr((prev, canon)).encode(), digest_size=16).hexdigest()


def _manager(lm, **kw):  # noqa: F811
    return KVCacheManager(lm[2], pool_pages=16, page_tokens=PT,
                          spill_ram_bytes=1 << 20, **kw)


def _spill_payload_for(mgr, tokens):
    """A restorable entry whose per-page leaves match the manager's pool."""
    hashes = tuple(page_hashes(tokens, PT, mgr.prefix.hash_fn))
    leaves = [mgr.cache[i][f] for i, f in mgr.leaves]
    pages = [[torch.zeros(leaf.shape[1:], dtype=leaf.dtype) for leaf in leaves]
             for _ in range(len(tokens) // PT)]
    return SpillPayload(tuple(tokens), hashes, pages)


def test_kill_mid_restore_leaks_zero_pages(lm):  # noqa: F811
    mgr = _manager(lm)
    prompt = tuple(range(1, 17))  # two full pages
    mgr._spill.put(_spill_payload_for(mgr, prompt))
    used0, reserved0 = mgr.pool.used, mgr.pool.reserved
    with active(FaultPlan([Fault("kv.restore", "kill", at=0)])), \
            pytest.raises(SimulatedKill):
        mgr.plan_row(list(prompt) + [77], 4, *LADDERS, 64)
    assert mgr.pool.used == used0 and mgr.pool.reserved == reserved0
    assert mgr.stats()["spill"]["pending_restores"] == 0 and mgr.active_rows == 0
    p = mgr.plan_row(list(prompt) + [77], 4, *LADDERS, 64)
    mgr.release(p)
    assert mgr.pool.used == used0 and mgr.pool.reserved == reserved0


def test_lost_admission_race_aborts_without_leak(lm):  # noqa: F811
    mgr = _manager(lm, hash_fn=_collide_hash)
    a = tuple(range(1, 17))
    b = (101,) + tuple(range(2, 17))
    assert page_hashes(a, PT, _collide_hash) == page_hashes(b, PT, _collide_hash)
    pages_b = mgr.pool.alloc(2)
    assert mgr.prefix.insert(b[:PT], pages_b[:1]) and mgr.prefix.insert(b, pages_b)
    mgr.pool.unref(pages_b)
    mgr._spill.put(_spill_payload_for(mgr, a))
    used0, reserved0 = mgr.pool.used, mgr.pool.reserved
    p = mgr.plan_row(list(a) + [77], 4, *LADDERS, 64)
    assert mgr.restore_aborted == 1 and mgr.stats()["spill"]["pending_restores"] == 0
    assert p.prefix_len == 0 and p.prefix_entry is None
    mgr.release(p)
    assert mgr.pool.used == used0 and mgr.pool.reserved == reserved0


def test_namespaces_keep_prefixes_apart_through_demote_and_restore(lm):  # noqa: F811
    from polyaxon_tpu.models.kv_pages import page_hashes as jax_page_hashes

    prompt = tuple(range(1, 17))  # two full pages
    # the empty namespace is the reference's chain; another seeds its own
    assert page_hashes(prompt, PT) == jax_page_hashes(prompt, PT)
    assert not set(page_hashes(prompt, PT, namespace="a1")) & set(page_hashes(prompt, PT))
    mgr = _manager(lm)
    used0, reserved0 = mgr.pool.used, mgr.pool.reserved
    p = mgr.plan_row(list(prompt) + [77], 4, *LADDERS, 64, namespace="a1")
    mgr.ensure_pages([p], p.n_pages * PT - 1)
    assert mgr.harvest([(list(prompt) + [77], p, p.suffix_bucket - len(prompt) - 1)]) == 2
    mgr.release(p)
    assert mgr.prefix.contains(prompt, "a1") and not mgr.prefix.contains(prompt)
    for ns in ("", "a2"):  # another adapter's row misses the cached prefix
        q = mgr.plan_row(list(prompt) + [77], 4, *LADDERS, 64, namespace=ns)
        assert q.prefix_len == 0
        mgr.release(q)
    mgr.prefix.clear()  # demotes the entries, each in its namespace
    assert mgr.spill_restores == 0 and len(mgr.prefix) == 0
    q = mgr.plan_row(list(prompt) + [77], 4, *LADDERS, 64, namespace="a2")
    assert q.prefix_len == 0 and mgr.spill_restores == 0
    mgr.release(q)
    q = mgr.plan_row(list(prompt) + [77], 4, *LADDERS, 64, namespace="a1")
    assert q.prefix_len == 16 and mgr.spill_restores == 1
    mgr.release(q)
    mgr.prefix.clear()
    mgr.flush_restores()
    assert mgr.pool.used == used0 and mgr.pool.reserved == reserved0


# ------------------------------------------------------- live HTTP layer
SPILL = {"max_batch": 4, "max_wait_ms": 2.0, "kv_pool_pages": 24, "kv_page_tokens": PT}


def _greedy(tokens):
    return {"tokens": [list(tokens)], "maxNewTokens": 6, "seed": 7}


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_evicted_prefix_restores_and_decodes_the_jax_tokens(lm, tmp_path, tier):  # noqa: F811
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    spill = ({"spill_ram_bytes": 32 << 20} if tier == "ram"
             else {"spill_ram_bytes": 0, "spill_dir": str(tmp_path / "spill")})
    server = ModelServer(lm[2], None, ServingConfig(**SPILL, **spill), device="cpu")
    kv = server._kv
    demoted = {}
    put = kv._spill.put

    def record(payload):
        demoted[payload.hashes[-1]] = payload
        return put(payload)

    kv._spill.put = record
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    rng = np.random.RandomState(0)
    target, *flood = [rng.randint(1, 100, size=49).tolist() for _ in range(7)]
    try:
        code, cold = post(url, _greedy(target))
        assert code == 200, cold
        for f in flood:  # distinct prompts push the target's entries out
            assert post(url, _greedy(f))[0] == 200
        st = server.stats()["kv"]["spill"]
        assert st["spills"] >= 1 and (st["disk_entries"] >= 1) == (tier == "disk"), st
        hits0 = server.stats()["kv"]["prefix"]["hits"]
        code, warm = post(url, _greedy(target))
        assert code == 200
        st = server.stats()["kv"]
        assert st["spill"]["restores"] >= 1 and st["prefix"]["hits"] > hits0, st
        assert st["spill"]["restored_disk" if tier == "disk" else "restored_ram"] >= 1
        # the restored pages hold exactly the bytes that were demoted
        head = page_hashes(target[:48], PT, kv.prefix.hash_fn)[-1]
        _, pages = kv.prefix.peek(target, max_tokens=48)
        want = demoted[head]
        assert len(pages) == len(want.pages) == 6
        for page_id, page in zip(pages, want.pages):
            for (i, f), leaf in zip(kv.leaves, page):
                assert torch.equal(kv.cache[i][f][page_id], leaf)
    finally:
        server.stop()
    assert cold["tokens"] == warm["tokens"]
    ref = JaxServer(lm[0], lm[1], model_name="small",
                    config=JaxConfig(**SPILL, spill_ram_bytes=32 << 20))
    assert cold["tokens"] == ref.generate(_greedy(target))["tokens"]
    kv_stats = server.stats()["kv"]
    assert kv_stats["active_rows"] == 0 and kv_stats["pages_reserved"] == 0
    assert kv_stats["pages_used"] == 1 + kv_stats["prefix"]["held_pages"]
