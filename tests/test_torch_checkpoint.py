"""The port's checkpoint tiers (`polyaxon_tpu_torch/runtime/checkpoint.py`),
on the CPU: the cases `tests/test_elastic.py` pins on the reference's
`CheckpointTiers`, here on the port's torch format with its own state, plus
the Orbax traps the trainer relies on (a save of an old step is a no-op;
`torch.load(weights_only=True)` reads a checkpoint)."""

import os

import pytest
import torch

from polyaxon_tpu_torch import chaos
from polyaxon_tpu_torch.chaos import Fault, FaultPlan, SimulatedKill, corrupt_checkpoint
from polyaxon_tpu_torch.runtime import Trainer
from polyaxon_tpu_torch.runtime import checkpoint as ck
from polyaxon_tpu_torch.runtime.checkpoint import CheckpointTiers
from polyaxon_tpu_torch.telemetry import get_registry


def _state(scale: float = 1.0, step: int = 0):
    return {
        "step": step,
        "w": torch.arange(8, dtype=torch.float32) * scale,
        "nested": {"b": torch.ones(4) * scale, "names": ["a", None], "lr": 0.5},
    }


def _digit_dirs(path) -> set[int]:
    try:
        return {int(n) for n in os.listdir(path) if n.isdigit()}
    except OSError:
        return set()


@pytest.fixture(autouse=True)
def _fresh_managers():
    yield
    ck.close_all()


def test_save_replicates_and_restore_prefers_durable(tmp_path):
    tiers = CheckpointTiers(str(tmp_path / "durable"), local=str(tmp_path / "local"))
    tiers.save(2, _state(1.0, 2))
    tiers.save(4, _state(2.0, 4), wait=True)
    assert tiers.steps_by_tier() == {"durable": [2, 4], "local": [2, 4]}
    target = _state(0.0)
    state, step, corrupt, tier = tiers.restore_latest_intact(target)
    assert (step, tier, corrupt) == (4, "durable", [])
    assert torch.equal(target["w"], torch.arange(8.0) * 2.0)  # loaded in place
    assert state["w"] is target["w"] and state["nested"]["b"] is target["nested"]["b"]
    assert state["step"] == 4 and state["nested"]["names"] == ["a", None]


def test_corrupt_durable_falls_back_to_local_copy_of_same_step(tmp_path):
    durable, local = str(tmp_path / "durable"), str(tmp_path / "local")
    tiers = CheckpointTiers(durable, local=local)
    tiers.save(2, _state(1.0))
    tiers.save(4, _state(2.0), wait=True)
    corrupt_checkpoint(durable, step=4)
    state, step, corrupt, tier = tiers.restore_latest_intact(_state(0.0))
    assert (step, tier) == (4, "local")
    assert corrupt == [("durable", 4)]
    assert torch.equal(state["w"], torch.arange(8.0) * 2.0)
    # the poisoned copy is quarantined in its own tier only
    assert os.path.isdir(os.path.join(durable, "4.corrupt"))
    assert os.path.isdir(os.path.join(local, "4"))


def test_without_local_tier_degrades_to_single_directory(tmp_path):
    tiers = CheckpointTiers(str(tmp_path / "durable"))
    tiers.save(2, _state(), wait=True)
    assert "local" not in tiers.steps_by_tier()
    assert tiers.latest_step() == 2
    _, step, _, tier = tiers.restore_latest_intact(_state(0.0))
    assert (step, tier) == (2, "durable")


def test_upload_failure_counts_and_step_stays_local_only(tmp_path):
    tiers = CheckpointTiers(str(tmp_path / "durable"), local=str(tmp_path / "local"))
    failures = get_registry().counter("checkpoint.upload_failures")
    base = failures.value
    plan = FaultPlan([Fault("checkpoint.upload", "raise", at=0,
                            message="chaos: durable tier unavailable")])
    with chaos.active(plan):
        tiers.save(2, _state(1.0), wait=True)  # wait() does not raise
    assert failures.value == base + 1
    assert tiers.steps_by_tier() == {"durable": [], "local": [2]}
    tiers.save(4, _state(2.0), wait=True)  # the outage over, replication resumes
    assert tiers.steps_by_tier()["durable"] == [4]
    assert tiers.latest_step() == 4


def test_kill_mid_upload_surfaces_at_barrier_durable_never_torn(tmp_path):
    durable = str(tmp_path / "durable")
    tiers = CheckpointTiers(durable, local=str(tmp_path / "local"))
    with chaos.active(FaultPlan([Fault("checkpoint.upload", "kill", step=2)])):
        tiers.save(2, _state(1.0))
        with pytest.raises(SimulatedKill):
            tiers.wait()
    assert _digit_dirs(durable) == set()
    residue = os.listdir(durable) if os.path.isdir(durable) else []
    assert not any(n.endswith(".uploading") for n in residue)
    _, step, corrupt, tier = tiers.restore_latest_intact(_state(0.0))
    assert (step, tier, corrupt) == (2, "local", [])


def test_durable_retention_mirrors_keep(tmp_path):
    tiers = CheckpointTiers(str(tmp_path / "durable"), local=str(tmp_path / "local"), keep=2)
    for i, step in enumerate((2, 4, 6), start=1):
        tiers.save(step, _state(float(i)), wait=True)
    assert _digit_dirs(tiers.durable) == {4, 6}
    assert _digit_dirs(tiers.local) == {4, 6}


def test_keep_mismatch_rebuilds_manager_and_retention_tracks(tmp_path):
    d = str(tmp_path / "ckpt")
    first = ck._manager(d)  # the default keep, 3
    assert ck._manager(d) is first and ck._manager(d, keep=3) is first
    rebuilt = ck._manager(d, keep=2)
    assert rebuilt is not first and ck._manager(d, keep=2) is rebuilt
    for step in (1, 2, 3, 4):
        ck.save_checkpoint(d, step, _state(), wait=True, keep=2)
    assert ck.all_steps(d) == [3, 4]


def test_quarantine_fsyncs_parent_directory(tmp_path, monkeypatch):
    d = tmp_path / "ckpt"
    (d / "5").mkdir(parents=True)
    (d / "5" / ck.STATE_FILE).write_bytes(b"x")
    synced = []
    monkeypatch.setattr(ck, "_fsync_dir", lambda p: synced.append(p))
    ck._quarantine(str(d), 5)
    assert (d / "5.corrupt").is_dir() and not (d / "5").exists()
    assert synced == [str(d)]
    # a second poisoned copy of the same step gets a name of its own
    (d / "5").mkdir()
    ck._quarantine(str(d), 5)
    assert (d / "5.corrupt.1").is_dir() and not (d / "5").exists()


def test_restart_with_save_in_flight_never_quarantines(tmp_path, monkeypatch):
    """The restore path waits for a save still writing before it lists
    steps, so an in-flight checkpoint is never judged half-written."""
    d = str(tmp_path / "ckpt")
    ck.save_checkpoint(d, 2, _state(1.0))  # asynchronous
    mgr = ck._manager(d)
    order = []
    real_wait, real_all = mgr.wait_until_finished, ck.all_steps
    monkeypatch.setattr(mgr, "wait_until_finished",
                        lambda: (order.append("wait"), real_wait())[1])
    monkeypatch.setattr(ck, "all_steps",
                        lambda *a, **k: (order.append("list"), real_all(*a, **k))[1])
    _, step, corrupt = ck.restore_latest_intact(d, _state(0.0))
    assert (step, corrupt) == (2, [])
    assert not os.path.isdir(os.path.join(d, "2.corrupt"))
    assert "wait" in order and order.index("wait") < order.index("list")


def test_save_of_an_old_step_is_a_no_op(tmp_path):
    """Orbax's should_save: the trainer saves at its last boundary and
    again at the end of `run()`; the second call writes nothing."""
    tiers = CheckpointTiers(str(tmp_path / "durable"), local=str(tmp_path / "local"))
    writes = get_registry().counter("checkpoint.tier_writes")
    assert tiers.save(4, _state(1.0), wait=True)
    base = writes.value
    path = os.path.join(tiers.local, "4", ck.STATE_FILE)
    stamp = os.stat(path).st_mtime_ns
    assert not tiers.save(4, _state(9.0), wait=True)
    assert not tiers.save(2, _state(9.0), wait=True)
    assert writes.value == base
    assert os.stat(path).st_mtime_ns == stamp
    assert tiers.steps_by_tier() == {"durable": [4], "local": [4]}
    _, step, _, _ = tiers.restore_latest_intact(target := _state(0.0))
    assert step == 4 and torch.equal(target["w"], torch.arange(8.0))


def test_a_mismatched_target_is_left_untouched(tmp_path):
    d = str(tmp_path / "ckpt")
    ck.save_checkpoint(d, 1, _state(3.0), wait=True)
    target = {**_state(0.0), "w": torch.zeros(9)}
    with pytest.raises(ValueError, match="w"):
        ck.restore_checkpoint(d, 1, target)
    assert not target["nested"]["b"].any()  # checked before any copy


def test_a_failed_write_raises_at_the_barrier(tmp_path):
    d = tmp_path / "ckpt"
    d.write_text("a file where the directory should be")
    with pytest.raises(OSError):
        ck.save_checkpoint(str(d), 1, _state(), wait=True)


def test_trainer_checkpoint_loads_with_weights_only(tmp_path):
    """A trainer's checkpoint is tensors, ints, floats, strings, None,
    dicts and lists: `torch.load(weights_only=True)` reads it, and it
    carries the step, the weights and the optimizer's state with `count`."""
    program = {
        "model": {"name": "transformer_lm", "config": {"preset": "tiny", "seq_len": 16}},
        "data": {"name": "synthetic_text", "batchSize": 2,
                 "config": {"seq_len": 16, "vocab_size": 512}},
        "optimizer": {"name": "adamw", "learningRate": 1e-3},
        "train": {"steps": 2, "checkpointEvery": 2, "logEvery": 1, "precision": "float32"},
    }
    trainer = Trainer(program, device="cpu", checkpoint_dir=str(tmp_path))
    trainer.run()
    loaded = torch.load(tmp_path / "2" / ck.STATE_FILE, weights_only=True)
    assert loaded["step"] == 2 and loaded["optimizer"]["count"] == 2
    assert loaded["model"].keys() == trainer.module.state_dict().keys()
    for name, p in trainer.module.state_dict().items():
        assert torch.equal(loaded["model"][name], p), name
    assert {"mu", "nu"} <= set(loaded["optimizer"]["state"][0])
