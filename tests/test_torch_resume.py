"""The port's Trainer with checkpoints, resume, preemption, chaos, spans and
the remat policies, on the CPU.

Resume is held against the JAX package's Trainer at the `tiny` preset (seq
64, batch 4): both run 4 steps with a
checkpoint every 2 from the same initial parameters, then a `resume` run
to 6 steps. The reference restores the state and starts a fresh data
stream (it never skips `start_step` batches), so steps 4-5 train on the
stream's batches 0-1 with the step, the schedule and Adam's count
restored; the port does the same, and steps 4-5 agree within
`tests/test_torch_trainer.py`'s float32 tolerances (loss and grad_norm 5e-5
relative, learning_rate 1e-6).

The port-only tests run a smaller model of the same family (2 layers,
width 64, 512 tokens, seq 32, batch 2): what they check (events, steps on
disk, spans, saved products) does not depend on the size, and the suite
runs beside other CPU-heavy files.
"""

import functools
import json
import signal

import jax
import numpy as np
import pytest
import torch

from polyaxon_tpu.runtime import checkpoint as jax_ck
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu_torch import chaos
from polyaxon_tpu_torch.chaos import Fault, FaultPlan, SimulatedKill
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.retry import Preempted
from polyaxon_tpu_torch.runtime import Trainer, preemption
from polyaxon_tpu_torch.runtime import checkpoint as ck
from polyaxon_tpu_torch.runtime import trainer as trainer_mod
from polyaxon_tpu_torch.telemetry import get_registry


def program(steps=4, model=None, **train):
    return {
        "model": {"name": "transformer_lm",
                  "config": {"preset": "tiny", "seq_len": 64, **(model or {})}},
        "data": {"name": "synthetic_text", "batchSize": 4,
                 "config": {"seq_len": 64, "vocab_size": 4096}},
        "optimizer": {"name": "adamw", "learningRate": 3e-3,
                      "schedule": {"name": "cosine", "warmup_steps": 1},
                      "config": {"grad_clip_norm": 1.0}},
        "train": {"steps": steps, "logEvery": 1, "precision": "float32", **train},
    }


def small(steps=4, model=None, **train):
    """`program` on a smaller model: 2 layers of width 64, 512 tokens."""
    prog = program(steps, {"dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
                           "vocab_size": 512, "seq_len": 32, **(model or {})}, **train)
    prog["data"] = {"name": "synthetic_text", "batchSize": 2,
                    "config": {"seq_len": 32, "vocab_size": 512}}
    return prog


@pytest.fixture(autouse=True)
def _fresh_managers():
    yield
    ck.close_all()


@pytest.fixture
def sigterm_to_port():
    """The port's SIGTERM handler for one test; whatever handled SIGTERM
    before (the JAX package's, in a shared test process) is put back."""
    old = signal.getsignal(signal.SIGTERM)
    was = preemption._installed
    preemption._installed = False
    preemption.clear()
    assert preemption.install()
    try:
        yield
    finally:
        preemption.clear()
        signal.signal(signal.SIGTERM, old)
        preemption._installed = was


def _events():
    log = []
    return log, lambda kind, body: log.append((kind, body))


def _of(log, kind):
    return [body for k, body in log if k == kind]


# ------------------------------------------------------------ resume parity
@functools.cache
def _resume_runs(root):
    """(JAX history of the resumed run, the port's), each side trained
    4 steps then resumed to 6."""
    jdir, pdir = f"{root}/jax", f"{root}/port"
    first = JaxTrainer(JaxProgram.from_dict(program(checkpointEvery=2)),
                       devices=jax.devices()[:1], checkpoint_dir=jdir)
    init = jax.tree.map(np.asarray, first.state.params)
    first.run()
    jax_ck.close_all()
    resumed = JaxTrainer(JaxProgram.from_dict(program(6, checkpointEvery=2, resume=True)),
                         devices=jax.devices()[:1], checkpoint_dir=jdir)
    ref = resumed.run().history
    jax_ck.close_all()

    t = Trainer(program(checkpointEvery=2), device="cpu", checkpoint_dir=pdir)
    t.load_state_dict(params_from_jax(init, t.module.cfg))
    t.run()
    log, sink = _events()
    t2 = Trainer(program(6, checkpointEvery=2, resume=True), device="cpu",
                 checkpoint_dir=pdir, event_fn=sink)
    return ref, t2.run().history, log, t2


@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory):
    return _resume_runs(str(tmp_path_factory.mktemp("resume")))


def test_resumed_run_matches_jax_step_for_step(resume_runs):
    ref, ours, log, _ = resume_runs
    assert [h["step"] for h in ours] == [h["step"] for h in ref] == [5, 6]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5)
        np.testing.assert_allclose(a["learning_rate"], b["learning_rate"], rtol=1e-6, atol=1e-12)
    assert _of(log, "resumed") == [{"step": 4, "tier": "durable"}]


def test_resume_restores_step_schedule_and_count(resume_runs):
    """The first resumed step reads the schedule at 4, not at 0, and the
    optimizer's count went on from 4."""
    _, ours, _, trainer = resume_runs
    assert trainer.step == 6 and trainer.optimizer.count == 6
    sched = trainer.sched
    assert ours[0]["learning_rate"] == pytest.approx(np.float32(sched(4)), rel=1e-7)
    assert ours[0]["learning_rate"] != pytest.approx(sched(0))


def test_resumed_stream_starts_over(tmp_path):
    """Finding of the reference: the resumed run's first step sees the
    stream's batch 0, as a fresh run's first step does."""
    t = Trainer(small(2, checkpointEvery=2), device="cpu", checkpoint_dir=str(tmp_path))
    t.run()
    seen = []
    t2 = Trainer(small(3, resume=True, checkpointEvery=2), device="cpu",
                 checkpoint_dir=str(tmp_path))
    real = t2.train_step
    t2.train_step = lambda batch: (seen.append(batch["inputs"].clone()), real(batch))[1]
    t2.run()
    first = next(Trainer(small(3), device="cpu").data.iterator)["inputs"]
    assert len(seen) == 1 and torch.equal(seen[0], torch.from_numpy(first))


# ------------------------------------------------- preemption and chaos
@pytest.mark.parametrize("every,saved", [(2, [2, 3]), (3, [3])], ids=["flush", "at-boundary"])
def test_sigterm_preempts_then_resumes_at_that_step(tmp_path, sigterm_to_port, every, saved):
    """SIGTERM at the head of step 3: with a save every 2 the loop flushes a
    save of step 3; with a save every 3 the boundary save of step 3 is still
    being written and uploaded, and is waited for. Either way the durable
    tier holds step 3 when `Preempted` is raised."""
    log, sink = _events()
    d, local = str(tmp_path / "ckpt"), str(tmp_path / "local")
    t = Trainer(small(6, checkpointEvery=every, checkpointLocalDir=local), device="cpu",
                checkpoint_dir=d, event_fn=sink)
    with chaos.active(FaultPlan([Fault("trainer.step", "sigterm", step=3)])):
        with pytest.raises(Preempted) as info:
            t.run()
    assert info.value.step == 3
    assert _of(log, "preempted") == [{"step": 3, "resume_step": 3}]
    assert ck.all_steps(d) == ck.all_steps(local) == saved
    preemption.clear()
    log, sink = _events()
    t2 = Trainer(small(6, checkpointEvery=every, resume=True, checkpointLocalDir=local),
                 device="cpu", checkpoint_dir=d, event_fn=sink)
    result = t2.run()
    assert _of(log, "resumed") == [{"step": 3, "tier": "durable"}]
    assert [h["step"] for h in result.history] == [4, 5, 6]
    assert t2.step == 6 and ck.all_steps(d)[-1] == 6


def test_kill_resumes_at_the_last_boundary(tmp_path):
    log, sink = _events()
    d = str(tmp_path / "ckpt")
    t = Trainer(small(6, checkpointEvery=2), device="cpu", checkpoint_dir=d)
    with chaos.active(FaultPlan([Fault("trainer.step", "kill", step=3)])):
        with pytest.raises(SimulatedKill):
            t.run()
    t2 = Trainer(small(6, checkpointEvery=2, resume=True), device="cpu",
                 checkpoint_dir=d, event_fn=sink)
    result = t2.run()
    assert _of(log, "resumed") == [{"step": 2, "tier": "durable"}]
    assert [h["step"] for h in result.history] == [3, 4, 5, 6]


def test_corrupt_checkpoint_falls_back_to_the_step_before(tmp_path):
    plan = FaultPlan.corrupt_then_kill(seed=0, steps=6, checkpoint_every=2)
    c, k = plan.params["corrupt_step"], plan.params["kill_step"]
    assert (c, k, plan.params["fallback_step"]) == (4, 5, 2)
    d = str(tmp_path / "ckpt")
    injections = get_registry().counter("chaos.injections")
    base = injections.value
    t = Trainer(small(6, checkpointEvery=2), device="cpu", checkpoint_dir=d)
    with chaos.active(plan):
        with pytest.raises(SimulatedKill):
            t.run()
    assert injections.value == base + 2
    log, sink = _events()
    t2 = Trainer(small(6, checkpointEvery=2, resume=True), device="cpu",
                 checkpoint_dir=d, event_fn=sink)
    assert t2.restore() == 2
    assert _of(log, "checkpoint_fallback") == [{
        "corrupt_steps": [4], "corrupt_copies": [["durable", 4]], "restored_step": 2}]
    assert (tmp_path / "ckpt" / "4.corrupt").is_dir()
    assert [h["step"] for h in t2.run().history] == [3, 4, 5, 6]


def test_local_tier_takes_the_saves_and_uploads(tmp_path):
    """Each boundary save lands on the local tier and is uploaded; its
    `checkpoint` span sits in its step's span and its stall is observed
    in the process-global `trainer.checkpoint_stall_ms`."""
    d, local = tmp_path / "durable", tmp_path / "local"
    def stalls():
        return get_registry().snapshot().get("trainer.checkpoint_stall_ms", {"count": 0})["count"]

    base = stalls()
    t = Trainer(small(4, checkpointEvery=2, checkpointKeep=1, checkpointLocalDir=str(local)),
                device="cpu", checkpoint_dir=str(d))
    t.run()
    assert ck.all_steps(str(local)) == [4] and ck.all_steps(str(d)) == [4]
    recs = t.tracer.recent(100)
    steps = {r["span_id"]: r["attrs"]["step"] for r in recs if r["name"] == "step"}
    ckpts = [r for r in recs if r["name"] == "checkpoint"]
    assert [(r["attrs"]["step"], steps[r["parent_id"]]) for r in ckpts] == [(2, 1), (4, 3)]
    assert stalls() == base + 2


def test_checkpoint_every_needs_a_directory():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Trainer(small(checkpointEvery=2), device="cpu")


# ------------------------------------------------------------ telemetry
def test_spans_account_for_step_walltime(tmp_path):
    """data_wait + compute cover at least 90% of each run's step spans (the
    only other work in a step is the chaos and preemption checks), as
    `tests/test_telemetry.py` holds the reference's."""
    t = Trainer(small(8), device="cpu", artifacts_dir=str(tmp_path))
    t.run()
    recs = [json.loads(line) for line in
            (tmp_path / "telemetry" / "spans.jsonl").read_text().splitlines()]
    steps = {r["span_id"]: r for r in recs if r["name"] == "step"}
    assert len(steps) == 8
    covered = {sid: 0.0 for sid in steps}
    for r in recs:
        if r["name"] in ("data_wait", "compute"):
            covered[r["parent_id"]] += r["dur_s"]
    total_step = sum(r["dur_s"] for r in steps.values())
    total_children = sum(covered.values())
    assert total_children <= total_step + 1e-6
    assert total_children >= 0.9 * total_step
    snap = t.telemetry.snapshot()
    assert snap["trainer.steps"] == 8 and snap["trainer.step_seconds"]["count"] == 8
    assert snap["train.loss"] is not None and snap["train.grad_norm"] is not None


def test_observability_turns_tracing_off_and_sets_buckets(tmp_path):
    prog = {**small(2), "observability": {"trace": False, "histogramBuckets": [0.5, 5.0]}}
    t = Trainer(prog, device="cpu", artifacts_dir=str(tmp_path))
    t.run()
    assert not (tmp_path / "telemetry").exists()
    assert t.telemetry.histogram("trainer.step_seconds").bounds == (0.5, 5.0)


# ------------------------------------------------------------ remat
def _losses_and_grads(policy, attention="xla"):
    remat = {"rematPolicy": policy} if policy else {}
    t = Trainer(small(2, model={"attention": attention}, **remat), device="cpu")
    losses, grads = [], None
    for _ in range(2):
        m = t.train_step(t._to_device(next(t.data.iterator)))
        losses.append(m["loss"].item())
        if grads is None:
            grads = [p.grad.clone() for p in t.module.parameters()]
    return losses, grads


def test_remat_policies_change_nothing():
    """dots, dots_no_batch, nothing and no remat: bit-identical f32 losses
    and gradients (a saved product holds the value a recompute makes)."""
    base_losses, base_grads = _losses_and_grads(None)
    for policy in ("nothing", "dots", "dots_no_batch"):
        losses, grads = _losses_and_grads(policy)
        assert losses == base_losses, policy
        assert all(torch.equal(a, b) for a, b in zip(grads, base_grads)), policy


def test_dots_saves_the_batched_products_too(monkeypatch):
    """On the einsum attention path the scores and the weighted values are
    batched products (`aten.bmm`): `dots` saves them, `dots_no_batch` only
    the projections (`aten.mm`), and `nothing` saves none."""
    saved = {}
    real = trainer_mod.create_selective_checkpoint_contexts

    def spy(policy_fn, *args, **kwargs):
        def counting(ctx, op, *a, **k):
            decision = policy_fn(ctx, op, *a, **k)
            if not ctx.is_recompute and decision == trainer_mod.CheckpointPolicy.MUST_SAVE:
                saved[current] = saved.get(current, 0) + 1
            return decision
        return real(counting, *args, **kwargs)

    monkeypatch.setattr(trainer_mod, "create_selective_checkpoint_contexts", spy)
    for current in ("dots", "dots_no_batch", "nothing"):
        t = Trainer(small(1, rematPolicy=current), device="cpu")
        t.train_step(t._to_device(next(t.data.iterator)))
    n = t.module.cfg.n_layers
    # per layer the q, k, v, o, gate, up and down projections, and the lm
    # head (inside the apply without the fused loss); dots adds each
    # layer's scores and weighted values
    assert saved == {"dots_no_batch": 7 * n + 1, "dots": 9 * n + 1}
