"""The port's scheduler and fleet (`polyaxon_tpu_torch/scheduler/`,
`schemas/quota.py`) against the JAX package's own JAX-free modules on the
same inputs, on the CPU:

- topology placement, gang reservations and their persistence, and a
  store written by either package read back in the other;
- `chips_demand`, `min_chips_demand`, `topology_request` and
  `shrink_candidates` over the same specs;
- quota checks, admission decisions, the fair-share order, the victim
  choice and the elastic ladder, on identical fleets;
- the queue's FIFO within a priority across push/pop/remove, and four
  processes (two of each package) pushing and popping one queue file
  under its fcntl lock;
- cron, interval and datetime `next_fire_time`;
- `FleetSimulator` on `synthetic_workload(seed)` and the hand-built
  scenarios of `tests/test_fleet.py` and `tests/test_elastic.py`: the
  reports (and each job's story) are equal.

Beside the comparisons, the port's agent drains, gates, rejects and
backfills; an executor eviction checkpoints, requeues at the original
priority and resumes (the counterpart of
`tests/test_fleet.py::test_executor_eviction_checkpoints_requeues_and_resumes`);
an elastic grant shrinks a 2-worker gang to one process with `grad_accum`
doubled, its losses within 5e-5 relative of the JAX agent's shrunk run
(`tests/test_elastic.py`'s grant, from the same initial parameters); an
interval schedule fires twice under a bounded `serve`; `RunClient`
queues runs and clones for the agent. The store's release on terminal
transitions and the replica slots' reservations are held in
`tests/test_torch_store.py` and `tests/test_torch_router.py`.
"""

import datetime as dt
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from polyaxon_tpu.scheduler import admission as jadm
from polyaxon_tpu.scheduler import fleet as jfleet
from polyaxon_tpu.scheduler import schedules as jsched
from polyaxon_tpu.scheduler import sim as jsim
from polyaxon_tpu.scheduler.queue import RunQueue as JaxRunQueue
from polyaxon_tpu.schemas.operation import V1Operation as JaxOperation
from polyaxon_tpu.schemas.operation import V1Schedule as JaxSchedule
from polyaxon_tpu.schemas.quota import V1QuotaSpec as JaxQuota
from polyaxon_tpu.store.local import RunStore as JaxStore
from polyaxon_tpu_torch.scheduler import admission as adm
from polyaxon_tpu_torch.scheduler import fleet
from polyaxon_tpu_torch.scheduler import schedules as sched
from polyaxon_tpu_torch.scheduler import sim
from polyaxon_tpu_torch.scheduler.agent import Agent
from polyaxon_tpu_torch.scheduler.queue import QueueRegistry, RunQueue
from polyaxon_tpu_torch.schemas.operation import V1Operation, V1Schedule
from polyaxon_tpu_torch.schemas.quota import V1QuotaSpec
from polyaxon_tpu_torch.store import RunStore
from polyaxon_tpu_torch.telemetry import get_registry

REPO = Path(__file__).resolve().parents[1]


def _both(tmp_path, fn):
    """fn(package modules, store) on a fresh store of each package."""
    ours = fn(fleet, adm, RunStore(tmp_path / "torch"))
    ref = fn(jfleet, jadm, JaxStore(tmp_path / "jax"))
    return ours, ref


def _strip(rec):
    return None if rec is None else {k: v for k, v in rec.items() if k != "reserved_at"}


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("topology,requests", [
    (None, [(3, None), (2, None), (1, None), (4, None)]),
    ((4, 4), [(8, (2, 4)), (8, (2, 4)), (8, (2, 4)), (4, (2, 2))]),
    ((4, 4), [(4, (2, 2)), (6, (3, 2)), (16, (4, 4)), (4, (4,)), (2, None)]),
    ((2, 2, 2), [(4, (2, 2)), (2, (1, 2)), (2, (2, 1, 1)), (8, None)]),
])
def test_placement_and_fits_match_jax(topology, requests):
    inv = fleet.DeviceInventory(topology=topology, chips=None if topology else 4)
    ref = jfleet.DeviceInventory(topology=topology, chips=None if topology else 4)
    used_a, used_b = set(), set()
    for chips, block in requests:
        assert inv.fits(chips, block) == ref.fits(chips, block)
        a, b = inv.place(chips, used_a, block), ref.place(chips, used_b, block)
        assert a == b, (chips, block)
        if a:
            used_a |= set(a)
            used_b |= set(b)


def test_reservations_all_or_nothing_persistent_and_shared_with_jax(tmp_path):
    def drive(f, _a, store):
        fl = f.Fleet(store)
        fl.configure(topology="4x4")
        out = [_strip(fl.reserve("a", chips=8, block=(2, 4), project="p", priority=2))]
        out.append(_strip(fl.reserve("a", chips=8, block=(2, 4))))  # idempotent
        out.append(_strip(fl.reserve("b", chips=16)))  # 8 free < 16: nothing
        out.append(_strip(fl.reserve("c", chips=4, block=(2, 2), requested_chips=8,
                                     requested_block=(2, 4))))
        out.append(_strip(f.Fleet(type(store)(store.home)).ledger.get("a")))  # a second handle
        out.append((fl.reserved_chips(), fl.usage()))
        snap = fl.snapshot()
        out.append({k: v for k, v in snap.items() if k != "reservations"})
        out.append(_strip(fl.release("a")))
        out.append(fl.reserved_chips())
        return out

    ours, ref = _both(tmp_path, drive)
    assert ours == ref
    # a ledger either package wrote reads back in the other
    assert _strip(fleet.Fleet(RunStore(tmp_path / "jax")).ledger.get("c")) == ours[3]
    assert jfleet.Fleet(JaxStore(tmp_path / "torch")).reserved_chips() == 4


def test_fleet_init_without_sizes_counts_this_hosts_devices(tmp_path, monkeypatch):
    """On the CPU path one chip; on the card its CUDA devices (faked)."""
    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "cpu")
    assert fleet.Fleet(RunStore(tmp_path)).configure() == {"chips": 1}
    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "cuda")
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 4)
    assert fleet.DeviceInventory.from_devices().total == 4


# ---------------------------------------------------------------- demand
DEMAND_SPECS = [
    {},
    {"environment": {"resources": {"chips": 4}}},
    {"environment": {"resources": {"chips": 4, "minChips": 2}}},
    {"environment": {"resources": {"chips": 4, "minChips": 9}}},
    {"environment": {"resources": {"tpu": {"topology": "2x4"}}}},
    {"environment": {"resources": {"tpu": {"topology": "2x4"}, "minChips": 2}}},
    {"environment": {"resources": {"tpu": {"topology": "2x4", "slices": 2}}}},
    {"component": {"run": {"environment": {"resources": {"chips": 3}}}}},
    {"component": {"run": {"environment": {"resources": {"chips": 3, "min_chips": 1}}}}},
]


@pytest.mark.parametrize("spec", DEMAND_SPECS)
def test_demand_matches_jax(spec):
    for name in ("chips_demand", "min_chips_demand", "topology_request"):
        assert getattr(fleet, name)(spec) == getattr(jfleet, name)(spec), name


def test_demand_of_operations_and_the_shrink_ladder_match_jax():
    doc = {"name": "x", "environment": {"resources": {"chips": 8, "minChips": 2}},
           "component": {"run": {"kind": "job", "container": {"command": ["true"]}}}}
    ours, ref = V1Operation.from_dict(doc), JaxOperation.model_validate(doc)
    for name in ("chips_demand", "min_chips_demand", "topology_request"):
        assert getattr(fleet, name)(ours) == getattr(jfleet, name)(ref)
    for chips, block, floor in [(8, None, 1), (8, None, 3), (16, (4, 4), 2), (8, (2, 4), 1),
                                (12, (3, 4), 1), (6, (3, 2), 1), (4, None, 4)]:
        assert fleet.shrink_candidates(chips, block, floor) == \
            jfleet.shrink_candidates(chips, block, floor)


# ---------------------------------------------------------------- quotas
def test_quota_spec_validation_matches_jax():
    q = V1QuotaSpec.from_dict({"scope": " queue:bulk ", "maxChips": 8})
    ref = JaxQuota.model_validate({"scope": " queue:bulk ", "maxChips": 8})
    assert q.to_dict() == ref.to_dict()
    assert (q.is_queue_scope, q.scope_name) == (ref.is_queue_scope, ref.scope_name)
    for bad in ({"scope": "p", "weight": 0}, {"scope": ""}, {"scope": "p", "maxRuns": -1}):
        with pytest.raises(ValueError):
            V1QuotaSpec.from_dict(bad)
        with pytest.raises(Exception):
            JaxQuota.model_validate(bad)


def test_quota_checks_match_jax(tmp_path):
    usages = [{}, {"p1": {"chips": 6, "runs": 1}}, {"p1": {"chips": 2, "runs": 2}},
              {"queue:bulk": {"chips": 1, "runs": 1}}]
    asks = [("p1", "default", 16), ("p1", "default", 4), ("other", "default", 99),
            ("other", "bulk", 1), ("zero", "default", 1)]

    def drive(_f, a, store):
        qm = a.QuotaManager(store)
        spec = V1QuotaSpec if a is adm else JaxQuota
        make = spec.from_dict if a is adm else spec.model_validate
        qm.set(make({"scope": "p1", "maxChips": 8, "maxRuns": 2}))
        qm.set(make({"scope": "queue:bulk", "maxRuns": 1}))
        qm.set(make({"scope": "zero", "maxRuns": 0, "weight": 3}))
        out = [qm.check(p, q, c, u) for u in usages for p, q, c in asks]
        out.append([s.to_dict() for s in qm.all()])
        out.append((qm.weight("zero"), qm.weight("nobody"), qm.remove("p1"), qm.remove("p1")))
        return out

    ours, ref = _both(tmp_path, drive)
    assert ours == ref


def _entry(uuid, chips, priority=0, block=None, project="p", seq=0, min_chips=None):
    return {"uuid": uuid, "priority": priority, "seq": seq, "chips": chips,
            "block": block, "min_chips": min_chips, "payload": {"project": project}}


def test_admission_decisions_match_jax(tmp_path):
    def drive(f, a, store):
        fl = f.Fleet(store)
        fl.configure(topology="4x4")
        ac = a.AdmissionController(store, fleet=fl)
        out = []
        for e in (_entry("a", 8, block=[2, 4]), _entry("big", 32), _entry("odd", 6, block=[3, 2]),
                  _entry("b", 16), _entry("el", 8, min_chips=2, priority=1),
                  _entry("hi", 16, priority=9), _entry("floor", 32, min_chips=20),
                  _entry("small", 4, block=[2, 2])):
            d = ac.try_admit(e)
            out.append((d.outcome, d.reason, _strip(d.reservation), d.preempt))
        out.append(sorted(fl.ledger.all()))
        return out

    ours, ref = _both(tmp_path, drive)
    assert ours == ref
    assert [o[0] for o in ours[:8]] == ["admit", "reject", "reject", "wait", "admit", "wait",
                                         "reject", "wait"]


def test_fair_share_order_and_victims_match_jax(tmp_path):
    def drive(f, a, store):
        fl = f.Fleet(store)
        fl.configure(chips=16)
        qm = a.QuotaManager(store)
        qm.set((V1QuotaSpec.from_dict if a is adm else JaxQuota.model_validate)(
            {"scope": "heavy", "weight": 4.0}))
        ac = a.AdmissionController(store, fleet=fl, quotas=qm)
        fl.reserve("h1", chips=8, project="heavy")
        fl.reserve("l1", chips=4, project="light")
        entries = [
            {"uuid": "l2", "priority": 0, "seq": 1, "payload": {"project": "light"}},
            {"uuid": "h2", "priority": 0, "seq": 2, "payload": {"project": "heavy"}},
            {"uuid": "hi", "priority": 9, "seq": 3, "payload": {"project": "light"}},
            {"uuid": "n1", "priority": 0, "seq": 0, "payload": {}},
        ]
        order = [e["uuid"] for e in ac.order(entries)]
        fl.release("h1")
        fl.release("l1")
        fl.reserve("small", chips=2, priority=0)
        fl.reserve("large", chips=4, priority=0)
        fl.reserve("important", chips=2, priority=5)
        fl.reserve("mid", chips=6, priority=1)
        victims = [[v["uuid"] for v in ac.pick_victims(c, None, priority=p)]
                   for c, p in ((4, 3), (4, 0), (16, 3), (6, 2), (10, 9), (2, 1))]
        return order, victims

    ours, ref = _both(tmp_path, drive)
    assert ours == ref
    assert ours[0] == ["hi", "n1", "h2", "l2"]  # priority, then reserved chips / weight


def test_elastic_grant_and_expansion_match_jax(tmp_path):
    def drive(f, a, store):
        fl = f.Fleet(store)
        fl.configure(chips=4)
        ac = a.AdmissionController(store, fleet=fl)
        fl.reserve("hog", chips=3, project="hog")
        store.create_run("el1", "el1", "p", {})
        d = ac.try_admit(_entry("el1", 4, min_chips=1))
        first = (d.outcome, _strip(d.reservation))
        meta = store.get_status("el1").get("meta")
        none_yet = ac.consider_expansion()
        fl.release("hog")
        grow = ac.consider_expansion()
        return first, meta, none_yet, grow, store.get_status("el1")["meta"]

    ours, ref = _both(tmp_path, drive)
    assert ours == ref
    assert ours[1] == {"granted_chips": 1, "requested_chips": 4} and ours[3] == ["el1"]


# ---------------------------------------------------------------- queue
def test_queue_fifo_within_priority_matches_jax(tmp_path):
    def drive(q):
        for i in range(4):
            q.push(f"a{i}", {}, priority=0, enqueued_at=1.0)
        q.push("hot", {}, priority=5, enqueued_at=1.0)
        q.remove("a1")
        q.push("a1", {}, priority=0, chips=4, enqueued_at=2.0)
        out = [q.peek_all()]
        out.append(q.pop()["uuid"])
        q.push("late-hot", {}, priority=5, enqueued_at=3.0)
        out += [q.pop()["uuid"] for _ in range(5)] + [q.pop(), len(q)]
        out.append(q.push("after", {}, enqueued_at=4.0))  # seq never recycled
        return out

    ours = drive(RunQueue(RunStore(tmp_path / "torch"), name="fifo"))
    ref = drive(JaxRunQueue(JaxStore(tmp_path / "jax"), name="fifo"))
    assert ours == ref
    assert ours[1:7] == ["hot", "late-hot", "a0", "a2", "a3", "a1"]
    registry = QueueRegistry(RunStore(tmp_path / "torch"))
    registry.set_queue("bulk", concurrency=2, priority=3)
    assert registry.stats() == [
        {"name": "bulk", "pending": 0, "concurrency": 2, "priority": 3},
        {"name": "fifo", "pending": 1, "concurrency": 1, "priority": 0}]


_QUEUE_WORKER = """
import json, sys
pkg, home, worker, n, out = sys.argv[1:]
if pkg == "torch":
    from polyaxon_tpu_torch.scheduler.queue import RunQueue
    from polyaxon_tpu_torch.store import RunStore
else:
    from polyaxon_tpu.scheduler.queue import RunQueue
    from polyaxon_tpu.store.local import RunStore
q = RunQueue(RunStore(home), name="mp")
popped = []
for i in range(int(n)):
    q.push(f"{pkg}{worker}-{i}", {}, priority=i % 3)
    got = q.pop()
    if got is not None:
        popped.append(got["uuid"])
open(out, "w").write(json.dumps(popped))
"""


def test_multiprocess_push_pop_across_both_packages(tmp_path):
    """Two processes of each package hammer one queue file: every entry is
    popped exactly once and the rest stay a well-formed priority queue."""
    home = tmp_path / "home"
    RunStore(home)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    n_each, procs, outs = 25, [], []
    for w, pkg in enumerate(("torch", "jax", "torch", "jax")):
        outs.append(tmp_path / f"out-{w}.json")
        procs.append(subprocess.Popen([sys.executable, "-c", _QUEUE_WORKER, pkg, str(home),
                                       str(w), str(n_each), str(outs[-1])], env=env))
    assert all(p.wait(timeout=120) == 0 for p in procs)
    popped = [u for o in outs for u in json.loads(o.read_text())]
    q = RunQueue(RunStore(home), name="mp")
    rest = q.peek_all()
    seen = popped + [e["uuid"] for e in rest]
    assert len(seen) == len(set(seen)) == 4 * n_each
    keys = [(e["priority"], e["seq"]) for e in rest]
    assert keys == sorted(keys, key=lambda t: (-t[0], t[1]))
    assert int(q.seq_path.read_text()) == 4 * n_each


# ------------------------------------------------------------- schedules
CRONS = ["*/15 * * * *", "0 9 * * 1-5", "30 2 1,15 * *", "0 0 * * 0", "5 4 * 2 7",
         "0 12 13 * 5", "59 23 31 12 *"]
AFTER = [dt.datetime(2026, 1, 1, 0, 0, 30), dt.datetime(2026, 2, 27, 23, 59),
         dt.datetime(2028, 2, 28, 12, 7)]


@pytest.mark.parametrize("expr", CRONS)
def test_cron_next_fire_time_matches_jax(expr):
    for after in AFTER:
        assert sched.next_cron_time(expr, after) == jsched.next_cron_time(expr, after)
        assert sched.cron_matches(expr, after) == jsched.cron_matches(expr, after)


def test_interval_datetime_and_bounds_match_jax():
    cases = [
        ({"kind": "interval", "frequency": 90}, None),
        ({"kind": "interval", "frequency": 90, "startAt": "2026-01-01T00:00:00"}, None),
        ({"kind": "interval", "frequency": 90}, dt.datetime(2025, 12, 31, 23, 0)),
        ({"kind": "interval", "frequency": 60, "endAt": "2026-01-01T00:00:30"}, None),
        ({"kind": "datetime", "startAt": "2026-03-01T10:00:00"}, None),
        ({"kind": "datetime", "startAt": "2026-03-01T10:00:00"}, dt.datetime(2026, 3, 1, 10)),
        ({"kind": "cron", "cron": "0 * * * *", "startAt": "2026-06-01T00:00:00"}, None),
        ({"kind": "cron", "cron": "0 * * * *", "endAt": "2026-01-01T00:30:00"}, None),
    ]
    after = dt.datetime(2026, 1, 1, 0, 0, 0)
    for doc, last in cases:
        ours = sched.next_fire_time(V1Schedule.from_dict(doc), after, last)
        assert ours == jsched.next_fire_time(JaxSchedule.model_validate(doc), after, last), doc
    for doc in ({"kind": "cron"}, {"kind": "interval"}, {"kind": "weekly"}):
        with pytest.raises(sched.ScheduleError):
            sched.next_fire_time(V1Schedule.from_dict(doc), after, None)
        with pytest.raises(jsched.ScheduleError):
            jsched.next_fire_time(JaxSchedule.model_validate(doc), after, None)


# ------------------------------------------------------------- simulator
def _jobs(pkg, specs):
    return [pkg.SimJob(**s) for s in specs]


def _story(simulator):
    return [(j.name, j.preemptions, j.waits, j.grants, j.started_at, j.finished_at,
             str(j.final_status)) for j in simulator.jobs]


def _simulate(specs, quotas=(), **kw):
    """Both packages' simulators on the same jobs: (reports, stories)."""
    out = []
    for pkg, quota in ((sim, V1QuotaSpec.from_dict), (jsim, JaxQuota.model_validate)):
        jobs = specs(pkg) if callable(specs) else _jobs(pkg, specs)
        s = pkg.FleetSimulator(jobs, quotas=[quota(q) for q in quotas], durable_store=False,
                               invariant_fn=lambda s: s.check_invariants(), **kw)
        out.append((s.run(), _story(s), s))
    (ours, our_story, our_sim), (ref, ref_story, _) = out
    assert ours == ref
    assert our_story == ref_story
    return ours, our_sim


def test_simulator_on_a_synthetic_workload_matches_jax():
    report, _ = _simulate(
        lambda pkg: pkg.synthetic_workload(seed=11, n_jobs=24, topology="4x4"),
        quotas=({"scope": "alpha", "maxChips": 12, "weight": 2.0},
                {"scope": "beta", "maxChips": 8}),
        topology="4x4")
    assert report["succeeded"] + report["unschedulable"] == report["jobs"] == 24
    assert report["events"] > 0


def test_simulator_preemption_gang_and_quota_scenarios_match_jax():
    report, s = _simulate([
        dict(name="low-small", duration=100, arrival=0, chips=2, priority=0),
        dict(name="low-large", duration=100, arrival=0, chips=6, priority=0),
        dict(name="high", duration=50, arrival=10, chips=6, priority=10),
    ], chips=8)
    by = {j.name: j for j in s.jobs}
    assert (by["high"].preemptions, by["low-large"].preemptions, by["low-small"].preemptions) \
        == (0, 1, 0)
    assert by["low-large"].finished_at == pytest.approx(150) and report["preemptions"] == 1
    assert s.store.get_status(by["low-large"].uuid)["meta"]["preempt_restarts"] == 1
    _, s = _simulate([
        dict(name="half-a", duration=40, arrival=0, chips=4, block=(2, 2)),
        dict(name="half-b", duration=60, arrival=0, chips=4, block=(2, 2)),
        dict(name="whole", duration=10, arrival=5, chips=16, block=(4, 4)),
    ], topology="4x4")
    assert s.jobs[2].started_at == pytest.approx(60)
    report, _ = _simulate([dict(name="too-big", duration=10, chips=8, project="tiny")],
                          quotas=({"scope": "tiny", "maxChips": 4},), chips=16)
    assert report["unschedulable"] == 1


def test_simulator_elastic_shrink_then_grow_matches_jax():
    report, s = _simulate([
        dict(name="blocker", duration=4.0, arrival=0.0, chips=3),
        dict(name="elastic", duration=8.0, arrival=0.0, chips=4, min_chips=1),
    ], chips=4)
    elastic = next(j for j in s.jobs if j.name == "elastic")
    assert elastic.grants == [1, 4] and report["elastic_resizes"] == 1


# ----------------------------------------------------------------- agent
JOB = {"kind": "job", "container": {"command": ["true"]}}


def _chip_op(name, chips, queue="default", run=JOB):
    return V1Operation.from_dict({"name": name, "queue": queue,
                                  "environment": {"resources": {"chips": chips}},
                                  "component": {"name": "c", "run": run}})


def test_agent_without_a_fleet_pops_in_priority_order(tmp_path):
    store = RunStore(tmp_path)
    agent = Agent(store=store, devices=["cpu"])
    order = []
    agent.submit_fn = lambda c: order.append(c.name) or "succeeded"
    for name, prio in (("a", 0), ("b", 5), ("c", 0)):
        agent.submit(_chip_op(name, 99), priority=prio)
    assert agent.drain() == 3 and order == ["b", "a", "c"]


def test_agent_gates_rejects_and_backfills(tmp_path):
    store = RunStore(tmp_path)
    fleet.Fleet(store).configure(chips=2)
    adm.QuotaManager(store).set(V1QuotaSpec.from_dict({"scope": "capped", "maxRuns": 0}))
    agent = Agent(store=store, devices=["cpu"])
    huge = agent.submit(_chip_op("huge", 8))
    ok = agent.submit(_chip_op("ok", 2))
    blocked = agent.submit(_chip_op("blocked", 1), project="capped")
    free = agent.submit(_chip_op("free", 1), project="open")
    assert agent.drain() == 2
    statuses = {u: store.get_status(u)["status"] for u in (huge, ok, blocked, free)}
    assert statuses == {huge: "unschedulable", ok: "succeeded", blocked: "unschedulable",
                        free: "succeeded"}
    assert "the fleet has 2 chips" in store.get_status(huge)["conditions"][-1]["message"]
    assert fleet.Fleet(store).reserved_chips() == 0


def test_agent_runs_queues_by_priority_and_concurrency(tmp_path):
    store = RunStore(tmp_path)
    registry = QueueRegistry(store)
    registry.set_queue("hot", concurrency=2, priority=5)
    registry.set_queue("paused", concurrency=0)
    agent = Agent(store=store, devices=["cpu"])
    seen = []
    agent.submit_fn = lambda c: seen.append((c.name, threading.current_thread().name)) or "ok"
    agent.submit(_chip_op("d1", 1))
    agent.submit(_chip_op("h1", 1, queue="hot"))
    agent.submit(_chip_op("h2", 1, queue="hot"))
    agent.submit(_chip_op("p1", 1, queue="paused"))
    assert agent.drain() == 3
    assert {n for n, _ in seen[:2]} == {"h1", "h2"} and seen[2][0] == "d1"
    assert [e["uuid"] for e in registry.get("paused").peek_all()] == [
        next(r["uuid"] for r in store.list_runs() if r["name"] == "p1")]


def test_cluster_agents_are_refused_by_name(tmp_path):
    class Submitter:
        cluster = object()

        def __call__(self, compiled):
            return "submitted"

    for kwargs in ({"cluster": object()}, {"submit_fn": Submitter()}):
        with pytest.raises(NotImplementedError, match=r"k8s/.*ROADMAP\.md"):
            Agent(store=RunStore(tmp_path), **kwargs)


MLP_PROGRAM = {
    "model": {"name": "mlp", "config": {"input_dim": 8, "num_classes": 2, "hidden": [4]}},
    "data": {"name": "synthetic", "batchSize": 8, "config": {"shape": [8], "num_classes": 2}},
    "optimizer": {"name": "sgd", "learningRate": 0.01},
}


def _train_op(name, steps, every=2, resources=None, run_extra=None, train_extra=None):
    doc = {"name": name, "component": {"name": "c", "termination": {"maxRetries": 0}, "run": {
        "kind": "jaxjob", **(run_extra or {}),
        "program": {**MLP_PROGRAM, "train": {"steps": steps, "logEvery": 1,
                                             "precision": "float32",
                                             **({"checkpointEvery": every} if every else {}),
                                             **(train_extra or {})}}}}}
    if resources:
        doc["environment"] = {"resources": resources}
    return doc


def test_executor_eviction_checkpoints_requeues_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "cpu")
    store = RunStore(tmp_path)
    fleet.Fleet(store).configure(chips=2)
    agent = Agent(store=store, devices=["cpu"])
    uid = agent.submit(V1Operation.from_dict(_train_op("victim", 6)), priority=2)
    store.set_meta(uid, preempt_requested=True)  # observed at the first log point
    agent.drain()
    status = store.get_status(uid)
    assert status["status"] == "succeeded"
    assert status["meta"]["preempt_restarts"] == 1 and status["meta"]["preempt_requested"] is False
    evictions = [e for e in store.read_events(uid) if e["kind"] == "preempted" and e.get("scheduler")]
    assert len(evictions) == 1 and evictions[0]["step"] is not None
    reasons = [c.get("reason") for c in status["conditions"]]
    assert "evicted" in reasons
    resumed = [e for e in store.read_events(uid) if e["kind"] == "resumed"]
    assert resumed and resumed[0]["step"] == evictions[0]["step"]
    steps = [m["step"] for m in store.read_metrics(uid)]
    assert steps[-1] == 6 and steps.count(1) == 1  # resumed, not restarted from step 0
    assert fleet.Fleet(store).reserved_chips() == 0


def test_the_requeued_entry_keeps_its_priority_and_full_demand(tmp_path, monkeypatch):
    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "cpu")
    store = RunStore(tmp_path)
    fleet.Fleet(store).configure(chips=4)
    agent = Agent(store=store, devices=["cpu"])
    uid = agent.submit(V1Operation.from_dict(_train_op(
        "victim", 4, resources={"chips": 4, "minChips": 1})), priority=7)
    store.set_meta(uid, preempt_requested=True)
    assert agent._claim(agent.queue, 1)[0]["uuid"] == uid
    from polyaxon_tpu_torch.compiler.resolver import compile_operation
    from polyaxon_tpu_torch.runtime.executor import Executor

    op = V1Operation.from_dict(_train_op("victim", 4, resources={"chips": 4, "minChips": 1}))
    compiled = compile_operation(op, run_uuid=uid, project="default",
                                 artifacts_root=str(store.runs_dir))
    assert Executor(store, device="cpu").execute(compiled) == "queued"
    (entry,) = RunQueue(store).peek_all()
    assert (entry["uuid"], entry["priority"], entry["chips"], entry["min_chips"]) == \
        (uid, 7, 4, 1)
    assert fleet.Fleet(store).ledger.get(uid) is None


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """The JAX agent's and the port's elastic run (2 chips requested, a
    floor of 1, one of the fleet's 2 chips held by another run): both get
    the 1-chip rung. The JAX run trains on one of its 8 CPU devices, the
    port's 2-worker gang as one process, both with grad_accum 2, from the
    same initial parameters."""
    from polyaxon_tpu.scheduler.agent import Agent as JaxAgent
    from torch_init_carry import InitCarry

    root = tmp_path_factory.mktemp("elastic")
    resources = {"chips": 2, "minChips": 1}
    carry = InitCarry()
    jstore = JaxStore(root / "jax")
    jfleet.Fleet(jstore).configure(chips=2)
    jfleet.Fleet(jstore).reserve("hog", chips=1, project="hog")
    jagent = JaxAgent(store=jstore)
    juid = jagent.submit(JaxOperation.model_validate(_train_op("elastic", 6, 0, resources)))
    with carry.recording():
        jagent.drain()
    store = RunStore(root / "torch")
    fleet.Fleet(store).configure(chips=2)
    fleet.Fleet(store).reserve("hog", chips=1, project="hog")
    resizes = get_registry().counter("trainer.elastic_resizes")
    before = resizes.value
    agent = Agent(store=store, devices=["cpu"])
    uid = agent.submit(V1Operation.from_dict(_train_op("elastic", 6, 0, resources,
                                                       run_extra={"replicas": 2})))
    with carry.loading():
        agent.drain()
    return jstore, juid, store, uid, resizes.value - before


def test_elastic_grant_shrinks_the_gang_and_doubles_grad_accum(elastic_runs):
    jstore, juid, store, uid, resized = elastic_runs
    status = store.get_status(uid)
    assert status["status"] == jstore.get_status(juid)["status"] == "succeeded"
    assert status["meta"]["granted_chips"] == 1 and status["meta"]["requested_chips"] == 2
    assert resized == 1
    (resize,) = [e for e in store.read_events(uid) if e["kind"] == "elastic_resize"]
    (jresize,) = [e for e in jstore.read_events(juid) if e["kind"] == "elastic_resize"]
    assert {k: resize[k] for k in ("granted", "requested", "grad_accum")} == \
        {k: jresize[k] for k in ("granted", "requested", "grad_accum")} == \
        {"granted": 1, "requested": 2, "grad_accum": 2}
    assert any(e["kind"] == "elastic_shrink" for e in store.read_events(uid))
    assert "[launcher]" not in store.read_logs(uid)  # one process, not a gang
    assert fleet.Fleet(store).reserved_chips() == 1  # the hog's


def test_elastic_losses_match_the_jax_agents_run(elastic_runs):
    jstore, juid, store, uid, _ = elastic_runs
    ours = [(m["step"], m["loss"]) for m in store.read_metrics(uid) if "loss" in m]
    ref = [(m["step"], m["loss"]) for m in jstore.read_metrics(juid) if "loss" in m]
    assert [s for s, _ in ours] == [s for s, _ in ref] == list(range(1, 7))
    np.testing.assert_allclose([v for _, v in ours], [v for _, v in ref], rtol=5e-5)


def test_an_interval_schedule_fires_twice_under_a_bounded_serve(tmp_path):
    store = RunStore(tmp_path)
    registry = sched.ScheduleRegistry(store)
    op = V1Operation.from_dict({"name": "tick", "schedule": {
        "kind": "interval", "frequency": 1, "maxRuns": 2},
        "component": {"name": "c", "run": JOB}})
    sid = registry.add(op, project="p")
    (entry,) = registry.list()
    assert entry["id"] == sid and entry["runs"] == 0
    agent = Agent(store=store, devices=["cpu"])

    def done():
        runs = [r for r in store.list_runs() if r["name"] == "tick"]
        return len(runs) == 2 and all(store.get_status(r["uuid"])["status"] == "succeeded"
                                      for r in runs)

    timer = threading.Timer(30.0, lambda: None)
    timer.start()
    try:
        agent.serve(poll_interval=0.1, stop_when=lambda: done() or not timer.is_alive())
    finally:
        timer.cancel()
    assert done()
    assert registry.list() == []  # exhausted after maxRuns


def test_registry_tick_matches_jax(tmp_path):
    """Both registries on one due interval schedule: the same submissions
    and the same entry state after each tick."""
    doc = {"name": "t", "schedule": {"kind": "interval", "frequency": 60, "maxRuns": 3},
           "component": {"name": "c", "run": JOB}}
    now = dt.datetime.now()
    out = []
    for pkg, store, make in ((sched, RunStore(tmp_path / "torch"), V1Operation.from_dict),
                             (jsched, JaxStore(tmp_path / "jax"), JaxOperation.model_validate)):
        reg = pkg.ScheduleRegistry(store)
        reg.add(make(doc))
        submitted = []

        class FakeAgent:
            def submit(self, op, project="default"):
                submitted.append((op.name, op.schedule, project))

        rows = []
        for minutes in (0, 2, 3, 10):
            fired = reg.tick(FakeAgent(), now=now + dt.timedelta(minutes=minutes))
            rows.append((fired, [(e["runs"], e["next_at"] is not None) for e in reg.list()]))
        out.append((rows, submitted))
    assert out[0] == out[1]


# ------------------------------------------------------ client, replicas
def test_run_client_queues_runs_and_clones_for_the_agent(tmp_path, monkeypatch):
    from polyaxon_tpu_torch.client import RunClient

    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "cpu")
    store = RunStore(tmp_path)
    client = RunClient(store=store, device="cpu")
    uid = client.create(V1Operation.from_dict({"name": "q", "component": {"run": JOB}}))
    assert store.get_status(uid)["status"] == "queued"
    assert [e["uuid"] for e in RunQueue(store).peek_all()] == [uid]
    assert Agent(store=store, devices=["cpu"]).drain() == 1
    assert store.get_status(uid)["status"] == "succeeded"
    clone = client.restart(uid)
    assert store.get_status(clone)["status"] == "queued"
    assert store.get_status(clone)["meta"]["cloned_from"] == uid
    assert Agent(store=store, devices=["cpu"]).drain() == 1
    assert store.get_status(clone)["status"] == "succeeded"
