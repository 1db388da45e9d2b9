"""The port's own copies of the telemetry registry and span tracer, the
chaos plans and injector, preemption and the device memory gauges, held
against the JAX package's modules on the CPU: the same calls give the same
numbers, text and events."""

import json
import signal

import pytest

from polyaxon_tpu.chaos import plan as jax_plan
from polyaxon_tpu.runtime import preemption as jax_preemption
from polyaxon_tpu.telemetry import registry as jax_registry
from polyaxon_tpu.telemetry import spans as jax_spans
from polyaxon_tpu_torch import chaos
from polyaxon_tpu_torch.chaos import plan
from polyaxon_tpu_torch.retry import PermanentError, Preempted, TransientError
from polyaxon_tpu_torch.runtime import preemption
from polyaxon_tpu_torch.telemetry import get_registry, get_tracer, registry, spans
from polyaxon_tpu_torch.tracking import device_metrics

SAMPLES = [0.0004, 0.002, 0.003, 0.02, 0.02, 0.07, 0.3, 0.9, 2.0, 7.5, 75.0]


def _fill(mod, buckets=None):
    reg = mod.MetricsRegistry(default_buckets=buckets)
    h = reg.histogram("trainer.step_seconds", help="Per-step walltime")
    for x in SAMPLES:
        h.observe(x)
    reg.counter("trainer.steps", help="Training steps completed").inc(11)
    reg.gauge("train.loss").set(2.5)
    reg.gauge("never.set")
    return reg, h


@pytest.mark.parametrize("buckets", [None, [0.01, 0.1, 1.0, 10.0]], ids=["default", "custom"])
def test_registry_matches_the_reference(buckets):
    ours, h = _fill(registry, buckets)
    ref, h_ref = _fill(jax_registry, buckets)
    assert ours.render_prometheus() == ref.render_prometheus()
    assert ours.snapshot() == ref.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.percentile(q) == h_ref.percentile(q)


def test_registry_refuses_a_second_kind_or_other_buckets():
    reg = registry.MetricsRegistry()
    reg.histogram("x", buckets=[1.0, 2.0])
    with pytest.raises(ValueError, match="already registered as histogram"):
        reg.counter("x")
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("x", buckets=[1.0, 3.0])
    assert reg.histogram("x") is reg.histogram("x", buckets=[1.0, 2.0])
    with pytest.raises(ValueError, match="ascending"):
        registry.Histogram("y", buckets=[2.0, 1.0])
    with pytest.raises(ValueError, match="decrease"):
        reg.counter("z").inc(-1)


def _trace(mod, path):
    tracer = mod.SpanTracer(path=str(path))
    with tracer.span("step", step=0) as step:
        with tracer.span("data_wait"):
            pass
        with tracer.span("compute", tokens=64):
            tracer.event("profiler.start", path="p")
    return tracer, step


def test_spans_nest_and_export_like_the_reference(tmp_path):
    ours, step = _trace(spans, tmp_path / "ours.jsonl")
    ref, _ = _trace(jax_spans, tmp_path / "ref.jsonl")

    def shape(lines):
        return [(r["kind"], r["name"], r["span_id"], r["parent_id"], r["attrs"]) for r in lines]

    got = [json.loads(x) for x in (tmp_path / "ours.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in (tmp_path / "ref.jsonl").read_text().splitlines()]
    assert shape(got) == shape(want) == shape(ours.recent())
    assert [r["name"] for r in got] == ["data_wait", "profiler.start", "compute", "step"]
    assert step.dur_s >= got[2]["dur_s"] + got[0]["dur_s"]
    assert {r["parent_id"] for r in got[:3]} == {step.span_id, got[2]["span_id"]}


def test_span_export_failure_is_advisory(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    tracer = spans.SpanTracer(path=str(blocker / "spans.jsonl"))
    with tracer.span("step"):
        pass
    tracer.event("after")
    assert [r["name"] for r in tracer.recent()] == ["step", "after"]


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_seeded_scenario_matches_the_reference(seed):
    kw = dict(steps=12, checkpoint_every=2)
    ours = plan.FaultPlan.corrupt_then_kill(seed=seed, **kw)
    ref = jax_plan.FaultPlan.corrupt_then_kill(seed=seed, **kw)
    assert ours.params == ref.params
    fields = ("point", "action", "at", "count", "step", "message")
    assert [[getattr(f, k) for k in fields] for f in ours.faults] == \
        [[getattr(f, k) for k in fields] for f in ref.faults]


def test_fire_consumes_faults_like_the_reference():
    def hits(mod):
        p = mod.FaultPlan([mod.Fault("a", "raise", at=1, count=2),
                           mod.Fault("b", "kill", step=3)])
        return [bool(p.fire("a")) for _ in range(5)] + \
            [bool(p.fire("b", step=s)) for s in (2, 3, 3)]

    assert hits(plan) == hits(jax_plan) == [False, True, True, False, False,
                                            False, True, False]


def test_injector_counts_records_and_raises():
    counter = get_registry().counter("chaos.injections")
    base = counter.value
    chaos.inject("trainer.step", step=0)  # nothing armed: a no-op
    faults = [chaos.Fault("p", "raise"), chaos.Fault("p", "raise_permanent", at=1),
              chaos.Fault("p", "kill", at=2), chaos.Fault("p", "sleep", at=3, delay_ms=1),
              chaos.Fault("p", "explode", at=4)]
    with chaos.active(chaos.FaultPlan(faults)):
        for err in (chaos.ChaosError, PermanentError, chaos.SimulatedKill):
            with pytest.raises(err):
                chaos.inject("p", step=5)
        chaos.inject("p", step=6)
        with pytest.raises(ValueError, match="unknown chaos action"):
            chaos.inject("p")
    chaos.inject("p")  # disarmed again
    assert counter.value == base + 5
    events = [r for r in get_tracer().recent(10) if r["name"] == "chaos.injection"][-5:]
    assert [r["attrs"]["action"] for r in events] == [
        "raise", "raise_permanent", "kill", "sleep", "explode"]
    assert issubclass(chaos.SimulatedKill, TransientError)
    assert issubclass(Preempted, TransientError) and Preempted("x", step=4).step == 4


def test_preemption_flag_like_the_reference():
    old = signal.getsignal(signal.SIGTERM)
    was = preemption._installed
    try:
        preemption._installed = False
        assert preemption.install() and preemption.install()
        assert signal.getsignal(signal.SIGTERM) is preemption._handler
        for mod in (preemption, jax_preemption):
            mod.clear()
            assert not mod.requested()
            mod.trigger()
            assert mod.requested()
            mod.clear()
        signal.raise_signal(signal.SIGTERM)
        assert preemption.requested()
    finally:
        preemption.clear()
        signal.signal(signal.SIGTERM, old)
        preemption._installed = was


def test_device_metrics_are_empty_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_metrics() == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 20e9)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (40e9, 80e9))
    assert device_metrics() == {"sys.gpu0.hbm_used_gb": 20.0, "sys.gpu0.hbm_percent": 25.0}
