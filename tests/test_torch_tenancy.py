"""Multi-tenant serving in the port (`serving/tenancy.py`,
`serving/adapters.py`, the server's wiring) against the JAX package, on the
CPU in f32.

- admission units: TenantSpec validation, the pairs round trip, duplicates
  and the canonical sort of normalize_*, the outstanding and token caps
  (`tenant_quota`), the default tenant, fair share and the snapshot — each
  on the same calls as the JAX classes, with the same answers;
- AdapterRegistry units over an in-memory slot store: pin and unpin, LRU
  evict → spill → restore of the exact bytes, `adapter_capacity` when every
  slot is pinned, an unknown adapter, a chaos kill mid-restore leaking
  nothing, a wrong-shape adapter refused; the same call sequence on the
  JAX registry ends in the same stats and the same slot bytes;
- the multiplexing contract over live HTTP on the dense, paged, chunked and
  speculative paths and an int8 base: a coalesced batch mixing two tenants
  (greedy and seeded-sampled rows) gives each tenant the tokens of a solo
  port server holding only that adapter, and the greedy rows are the JAX
  server's tokens; the same prompts sent again tenant after tenant give
  the same tokens (the prefix cache is namespaced by adapter); no page or
  adapter slot leaks; with one slot for two adapters, an evicted adapter
  comes back from its spill tier with its bytes;
- a capped tenant's flood sheds `tenant_quota` on that tenant alone;
  unknown tenants are a 400; the cross-field rules of the reference.
"""

import threading

import numpy as np
import pytest
import torch

from polyaxon_tpu.serving import tenancy as jten
from polyaxon_tpu.serving.adapters import AdapterRegistry as JRegistry
from polyaxon_tpu.serving.batching import ShedError as JShedError
from polyaxon_tpu.serving.spill import SpillManager as JSpill
from polyaxon_tpu_torch.chaos import Fault, FaultPlan, SimulatedKill, active
from polyaxon_tpu_torch.serving.adapters import (
    AdapterRegistry,
    load_adapter,
    save_adapter,
    synth_adapter,
)
from polyaxon_tpu_torch.serving.batching import ServingConfig, ShedError
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.serving import tenancy as tten
from polyaxon_tpu_torch.serving.spill import SpillManager
from polyaxon_tpu_torch.serving.tenancy import (
    DEFAULT_TENANT,
    TenantAdmission,
    TenantSpec,
    normalize_adapters,
    normalize_tenants,
)

from tests.test_torch_serving_batch import post
from tests.test_torch_transformer import jax_lm, torch_lm


# ------------------------------------------------------- admission units
def _both(fn):
    """fn(module) on the port's tenancy module and the JAX one: (port, JAX)
    results, or the exception type of each."""
    out = []
    for mod in (tten, jten):
        try:
            out.append(fn(mod))
        except Exception as e:  # noqa: BLE001 — compared by type below
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("kwargs", [
    {"name": ""}, {"name": "  "}, {"name": "t", "max_outstanding": -1},
    {"name": "t", "max_tokens": -5}, {"name": "t", "weight": 0},
    {"name": "t", "weight": 2.5, "max_outstanding": 3, "adapter": "a"},
], ids=["empty", "blank", "neg-outstanding", "neg-tokens", "zero-weight", "valid"])
def test_tenant_spec_validation_matches_jax(kwargs):
    ours, ref = _both(lambda m: m.TenantSpec(**kwargs).to_pairs())
    assert ours == ref
    if not isinstance(ours, str):
        assert TenantSpec.from_pairs(ours) == TenantSpec(**kwargs)


def test_normalize_matches_jax():
    tenants = [{"name": "b", "weight": 2.0}, {"name": "a", "max_outstanding": 1,
                                             "adapter": "x"}]
    ours, ref = _both(lambda m: m.normalize_tenants(tenants))
    assert ours == ref and [dict(p)["name"] for p in ours] == ["a", "b"]
    assert normalize_tenants([TenantSpec("a"), (("name", "b"),)]) == (
        (("name", "a"),), (("name", "b"),))
    for bad in ([{"name": "a"}, {"name": "a"}],):
        assert _both(lambda m: m.normalize_tenants(bad)) == ["ValueError"] * 2
    ads = {"z": " seed:1 ", "a": "/x.npz"}
    ours, ref = _both(lambda m: m.normalize_adapters(ads))
    assert ours == ref == (("a", "/x.npz"), ("z", "seed:1"))
    assert normalize_adapters([("a", "seed:1")]) == (("a", "seed:1"),)
    for bad in ([("a", "seed:1"), ("a", "seed:2")], [("", "seed:1")], [("a", "")]):
        assert _both(lambda m: m.normalize_adapters(bad)) == ["ValueError"] * 2


def test_admission_caps_share_and_snapshot_match_jax():
    specs = [{"name": "t", "max_outstanding": 2, "max_tokens": 100, "weight": 2.0},
             {"name": "u", "max_tokens": 30}]
    adms = [TenantAdmission(specs), jten.TenantAdmission(specs)]
    releases = [[], []]
    calls = [("t", 40), ("t", 40), ("t", 1), ("u", 20), ("u", 11), ("", 500),
             ("default", 7)]
    for name, tokens in calls:
        outcome = []
        for k, adm in enumerate(adms):
            try:
                releases[k].append(adm.admit(name, tokens))
                outcome.append("ok")
            except (ShedError, JShedError) as e:
                outcome.append(e.reason)
        assert outcome[0] == outcome[1], (name, tokens, outcome)
    assert [a.share("t") for a in adms] == [40.0, 40.0]
    assert adms[0].snapshot() == adms[1].snapshot()
    snap = adms[0].snapshot()
    assert snap["t"]["shed"] == 1 and snap["u"]["shed"] == 1
    assert snap[DEFAULT_TENANT]["outstanding"] == 2 and snap[DEFAULT_TENANT]["tokens"] == 507
    for k in range(2):  # releases are exactly-once
        for rel in releases[k]:
            rel()
            rel()
    assert adms[0].snapshot() == adms[1].snapshot()
    assert all(v["outstanding"] == 0 and v["tokens"] == 0
               for v in adms[0].snapshot().values())
    for adm in adms:
        with pytest.raises(KeyError):
            adm.admit("stranger", 1)
        with pytest.raises(KeyError):
            adm.resolve("stranger")
        assert adm.resolve("").name == adm.resolve(None).name == DEFAULT_TENANT
        assert adm.known() == ["default", "t", "u"]


# -------------------------------------------------------- registry units
TEMPLATE = {
    "layer/attn/lora_a": ((8, 2), "float32"),
    "layer/attn/lora_b": ((2, 8), "float32"),
}
JTEMPLATE = {k: (shape, np.dtype(dt)) for k, (shape, dt) in TEMPLATE.items()}


def _registry(slots=1, sources=None, spill=True, jax_side=False):
    """An AdapterRegistry (the port's, or the JAX package's) over an
    in-memory slot store."""
    store = {}
    paths = sorted(TEMPLATE)

    def read_slot(slot):
        return [store[slot][p] for p in paths]

    def write_slot(slot, adapter):
        store[slot] = {p: (np.array(v) if jax_side else torch.as_tensor(v).clone())
                       for p, v in adapter.items()}

    cls, sm, tmpl = ((JRegistry, JSpill, JTEMPLATE) if jax_side
                     else (AdapterRegistry, SpillManager, TEMPLATE))
    reg = cls(slots=slots, sources=sources or {"a": "seed:1", "b": "seed:2"},
              template=tmpl, read_slot=read_slot, write_slot=write_slot,
              spill=sm(ram_bytes=1 << 20) if spill else None)
    return reg, store


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def test_acquire_pins_release_unpins():
    reg, store = _registry(slots=2)
    slot, loaded = reg.acquire("a")
    assert loaded is True and slot in (1, 2) and reg.refcount("a") == 1
    assert reg.acquire("a") == (slot, False)  # resident: no reload
    reg.release("a")
    reg.release("a")
    reg.release("a")  # over-release must not go negative
    assert reg.refcount("a") == 0 and store[slot]
    reg.check_invariants()


def test_lru_evict_spill_restore_round_trips_bytes_as_jax():
    """The same calls on the port's and the JAX registry: evict → spill →
    restore of the exact bytes, and the same stats at the end."""
    ends = []
    for jax_side in (False, True):
        reg, store = _registry(slots=1, jax_side=jax_side)
        slot, _ = reg.acquire("a")
        reg.release("a")
        reg.acquire("b")  # "b" needs the only slot: idle "a" demotes to spill
        assert reg.evictions == 1 and reg.resident() == {"b": slot}
        reg.release("b")
        reg.acquire("a")  # back from spill: the exact bytes, not a re-synth
        assert reg.restores == 1 and reg.stats()["adapters"]["b"]["state"] == "spilled"
        reg.check_invariants()
        ends.append((reg.stats(), {p: _np(v) for p, v in store[slot].items()}))
    want = synth_adapter(TEMPLATE, 1)
    assert ends[0][0] == ends[1][0]
    for p in TEMPLATE:
        np.testing.assert_array_equal(ends[0][1][p], want[p].numpy())
        assert ends[0][1][p].tobytes() == ends[1][1][p].tobytes()


def test_all_slots_pinned_sheds_adapter_capacity():
    reg, _ = _registry(slots=1)
    reg.acquire("a")
    with pytest.raises(ShedError) as e:
        reg.acquire("b")
    assert e.value.reason == "adapter_capacity"
    reg.release("a")
    reg.acquire("b")  # idle now → evictable → admits
    reg.check_invariants()
    with pytest.raises(KeyError):
        reg.acquire("stranger")


def test_chaos_kill_mid_restore_leaks_nothing():
    reg, store = _registry(slots=1)
    reg.acquire("a")
    reg.release("a")
    reg.acquire("b")  # evicts idle "a" → spilled
    reg.release("b")
    with active(FaultPlan([Fault("serving.adapter_restore", "kill", at=0)])), \
            pytest.raises(SimulatedKill):
        reg.acquire("a")
    reg.check_invariants()
    assert reg.refcount("a") == 0 and reg.restores == 0
    assert reg.stats()["adapters"]["a"]["state"] == "spilled"
    s2, loaded = reg.acquire("a")  # the retry restores the same bytes
    assert loaded and reg.restores == 1
    want = synth_adapter(TEMPLATE, 1)
    for p in TEMPLATE:
        assert torch.equal(store[s2][p], want[p])
    reg.check_invariants()


def test_load_rejects_wrong_shape_adapter(tmp_path):
    save_adapter(tmp_path / "bad.npz", {p: np.zeros((3, 3), np.float32) for p in TEMPLATE})
    with pytest.raises(ValueError, match="shape"):
        load_adapter(str(tmp_path / "bad.npz"), TEMPLATE)
    good = {p: np.ones(shape, dtype) for p, (shape, dtype) in TEMPLATE.items()}
    save_adapter(tmp_path / "good.npz", good)
    loaded = load_adapter(str(tmp_path / "good.npz"), TEMPLATE)
    for p in TEMPLATE:
        np.testing.assert_array_equal(loaded[p].numpy(), good[p])


# ------------------------------------------------ server level over HTTP
ADAPTERS = {"acme": "seed:1", "globex": "seed:2"}
PAGED = {"kv_pool_pages": 64, "kv_page_tokens": 8}
CHUNKED = {**PAGED, "chunked_prefill": True, "prefill_chunk_tokens": 8,
           "max_step_tokens": 64}
PATHS = {
    "dense": {},
    "paged": PAGED,
    "chunked": CHUNKED,
    "speculative": {**PAGED, "speculate": True, "draft_tokens": 3},
    "int8": {**CHUNKED, "quantize": True},
}
BASE = {"max_batch": 4, "max_wait_ms": 30.0}


@pytest.fixture(scope="module")
def lora_lm():
    module, params = jax_lm({"attention": "xla", "lora_rank": 4})
    return module, params, torch_lm(module, params)


def _config(adapters, **extra):
    return dict(
        BASE, adapters=normalize_adapters(adapters),
        tenants=normalize_tenants([{"name": n, "adapter": n} for n in adapters]), **extra,
    )


def _port(lora_lm, adapters, **extra):
    server = ModelServer(lora_lm[2], None, ServingConfig(**_config(adapters, **extra)),
                         device="cpu")
    return server, f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"


def _bodies():
    out = {}
    for tenant in ADAPTERS:
        for label, sampling in (("greedy", {"temperature": 0.0}),
                                ("sampled", {"temperature": 0.8, "topK": 20, "seed": 11})):
            out[(tenant, label)] = {"tokens": [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10]],
                                    "maxNewTokens": 6, "tenant": tenant, **sampling}
    return out


def _fire(url, bodies):
    got, errors = {}, []

    def one(key):
        code, payload = post(url, bodies[key])
        if code != 200:
            errors.append((key, code, payload))
        else:
            got[key] = payload["tokens"]

    threads = [threading.Thread(target=one, args=(k,)) for k in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not errors, errors
    return got


@pytest.fixture(scope="module", params=list(PATHS))
def multiplexed(request, lora_lm):
    from polyaxon_tpu.serving.batching import ServingConfig as JaxConfig
    from polyaxon_tpu.serving.server import ModelServer as JaxServer

    extra = PATHS[request.param]
    bodies = _bodies()
    server, url = _port(lora_lm, ADAPTERS, **extra)
    try:
        mixed = _fire(url, bodies)
        # the same prompt again, tenant after tenant: on the paged paths the
        # first tenant's cached prefix must not serve the second (its K/V
        # came through another adapter)
        again = {}
        for key in sorted(bodies):
            code, out = post(url, bodies[key])
            assert code == 200, out
            again[key] = out["tokens"]
        stats = server.stats()
    finally:
        server.stop()
    solo = {}
    for tenant, source in ADAPTERS.items():
        one, one_url = _port(lora_lm, {tenant: source}, **extra)
        try:
            for label in ("greedy", "sampled"):
                code, out = post(one_url, bodies[(tenant, label)])
                assert code == 200, out
                solo[(tenant, label)] = out["tokens"]
        finally:
            one.stop()
    # the reference's prefix cache is keyed by token ids alone, so its
    # sequential inline path would serve the second tenant the first one's
    # prefix K/V (ROADMAP.md, Queue C): its pool runs without the cache here
    ref = JaxServer(lora_lm[0], lora_lm[1], model_name="small",
                    config=JaxConfig(**_config(ADAPTERS, **extra, prefix_cache=False)))
    jax_greedy = {t: ref.generate(bodies[(t, "greedy")])["tokens"] for t in ADAPTERS}
    yield request.param, server, (mixed, again), solo, jax_greedy, stats


def test_mixed_tenant_batch_equals_solo_and_jax(multiplexed):
    path, server, (mixed, again), solo, jax_greedy, _ = multiplexed
    for key, tokens in mixed.items():
        assert tokens == solo[key] == again[key], (path, key)
    for tenant in ADAPTERS:
        assert mixed[(tenant, "greedy")] == jax_greedy[tenant], (path, tenant)
    # the adapters really differ: the identity above is not vacuous
    assert mixed[("acme", "greedy")] != mixed[("globex", "greedy")]


def test_no_page_or_slot_leaks_after_drain(multiplexed):
    path, server, _, _, _, during = multiplexed
    stats = server.stats()
    adapters = stats["tenancy"]["adapters"]
    assert all(a["refs"] == 0 for a in adapters["adapters"].values())
    assert adapters["resident"] == 2 and adapters["loads"] == 2
    assert all(t["outstanding"] == 0 and t["tokens"] == 0
               for t in stats["tenancy"]["tenants"].values())
    assert during["tenancy"]["tenants"]["acme"]["admitted"] == 4
    kv = stats["kv"]
    if kv["enabled"]:
        assert kv["active_rows"] == 0 and kv["pages_reserved"] == 0
        assert kv["pages_used"] == 1 + kv["prefix"]["held_pages"]


def test_evicted_adapter_restores_its_bytes_in_a_live_server(lora_lm):
    """One slot for two adapters: acme, then globex (evicting idle acme to
    the adapter spill tier), then acme again (restored from it) — every
    answer equals a solo server's, and the slot holds acme's bytes again."""
    bodies = _bodies()
    server, url = _port(lora_lm, ADAPTERS, adapter_slots=1, **PAGED)
    try:
        got = [post(url, bodies[(t, "greedy")])[1]["tokens"]
               for t in ("acme", "globex", "acme")]
        adapters = server.stats()["tenancy"]["adapters"]
        slot = server._adapter_leaves["layer_0/attention/q_proj/lora_b"][1]
        want = synth_adapter(server._adapter_template, 1)["layer_0/attention/q_proj/lora_b"]
        assert torch.equal(slot, want)
    finally:
        server.stop()
    assert adapters["evictions"] == 2 and adapters["restores"] == 1, adapters
    assert got[0] == got[2] != got[1]
    one, one_url = _port(lora_lm, {"globex": ADAPTERS["globex"]}, **PAGED)
    try:
        assert post(one_url, bodies[("globex", "greedy")])[1]["tokens"] == got[1]
    finally:
        one.stop()


def test_capped_tenant_flood_sheds_alone(lora_lm):
    """`noisy` may hold one outstanding row. While its first row is held in
    decode (a chaos sleep at `serving.slow`), a burst of 5 more sheds on it
    alone (`tenant_quota`, never charged), and `calm`'s 6 requests, sent
    beside the burst, all complete."""
    import time

    tenants = [{"name": "noisy", "max_outstanding": 1, "adapter": "acme"},
               {"name": "calm", "adapter": "globex"}]
    cfg = dict(BASE, adapters=normalize_adapters(ADAPTERS),
               tenants=normalize_tenants(tenants), **PAGED)
    server = ModelServer(lora_lm[2], None, ServingConfig(**cfg), device="cpu")
    url = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    codes = {}

    def one(i, tenant):
        code, out = post(url, {"tokens": [[1, 2, 3, 4 + i]], "maxNewTokens": 4,
                               "tenant": tenant})
        codes[(tenant, i)] = (code, out.get("reason"))

    try:
        with active(FaultPlan([Fault("serving.slow", "sleep", at=0, delay_ms=3000)])):
            first = threading.Thread(target=one, args=(0, "noisy"))
            first.start()
            end = time.monotonic() + 60
            while server.stats()["tenancy"]["tenants"]["noisy"]["outstanding"] < 1:
                assert time.monotonic() < end, "the first noisy row was never admitted"
                time.sleep(0.01)
            threads = [threading.Thread(target=one, args=(i, t))
                       for i in range(1, 7) for t in ("noisy", "calm") if (i, t) != (6, "noisy")]
            for t in threads:
                t.start()
            for t in threads + [first]:
                t.join(120)
        snap = server.stats()["tenancy"]["tenants"]
        shed = server.telemetry.counter("serving.shed_by_tenant.noisy").value
    finally:
        server.stop()
    assert all(codes[("calm", i)] == (200, None) for i in range(1, 7)), codes
    assert codes[("noisy", 0)] == (200, None)
    assert all(codes[("noisy", i)] == (503, "tenant_quota") for i in range(1, 6)), codes
    assert snap["noisy"]["shed"] == shed == 5 and snap["noisy"]["admitted"] == 1
    assert snap["calm"]["shed"] == 0 and snap["noisy"]["outstanding"] == 0


def test_unknown_tenants_and_cross_field_rules(lora_lm):
    server, url = _port(lora_lm, ADAPTERS)
    try:
        code, out = post(url, {"tokens": [[1, 2]], "maxNewTokens": 2, "tenant": "stranger"})
        assert code == 400 and "unknown tenant" in out["error"]
        code, out = post(url, {"tokens": [[1, 2]], "maxNewTokens": 2, "tenant": "acme",
                               "numBeams": 2})
        assert code == 400 and "coalesced" in out["error"]
        code, out = post(url, {"tokens": [[1, 2]], "maxNewTokens": 2})
        assert code == 200  # tenant-less traffic rides the default tenant, slot 0
    finally:
        server.stop()
    plain = ModelServer(lora_lm[2], None, ServingConfig(**BASE), device="cpu")
    with pytest.raises(Exception, match="no tenants configured"):
        plain.generate({"tokens": [[1, 2]], "maxNewTokens": 2, "tenant": "acme"})
    with pytest.raises(ValueError, match="not configured"):
        ModelServer(lora_lm[2], None, ServingConfig(
            adapters=normalize_adapters(ADAPTERS),
            tenants=normalize_tenants([{"name": "x", "adapter": "nope"}])), device="cpu")
    no_lora = torch_lm(*jax_lm({"attention": "xla"}))
    with pytest.raises(ValueError, match="LoRA"):
        ModelServer(no_lora, None, ServingConfig(adapters=(("a", "seed:1"),)), device="cpu")
    with pytest.raises(ValueError, match="prefix cache"):
        ModelServer(lora_lm[2], None, ServingConfig(spill_ram_bytes=1 << 20), device="cpu")
