"""The port's run store (`store/`, `schemas/lifecycle.py`, `settings.py`)
against the JAX package's, on the CPU.

One scripted run life (create, every status up to succeeded, a meta merge,
a tracked event, metrics, a log line) is driven through each package's
`RunStore`. Then:
- the two stores hold the same documents, apart from timestamps: `resolve`
  by prefix and by name, `get_status`, `get_history`, `timeline`,
  `read_events`, `read_metrics`, `read_logs`, `list_runs`, and the
  cursor reads (`read_events_since`) by sequence number;
- a store written by the port reads back in the reference's `RunStore`,
  and the other way round, document for document and cursor for cursor;
  one package goes on writing where the other stopped;
- a torn segment (a crash mid-append) is healed by either package to the
  same history, and a compaction by one replays in the other;
- the lifecycle graph, the layered `home` lookup and the refusals are the
  reference's; `delete_run` removes the run's queue entries.
"""

import json
import threading
from pathlib import Path

import pytest

from polyaxon_tpu import settings as jax_settings
from polyaxon_tpu.scheduler.queue import RunQueue as JaxRunQueue
from polyaxon_tpu.schemas import lifecycle as jax_lifecycle
from polyaxon_tpu.store import RunStore as JaxRunStore
from polyaxon_tpu_torch import settings
from polyaxon_tpu_torch.schemas import lifecycle
from polyaxon_tpu_torch.store import RunStore, UnknownRunError, polyaxon_home
from polyaxon_tpu_torch.store.timeline import fold_timeline

UUID = "5f1c0ffee0d4a7b2c3d4e5f60718293a"
SPEC = {"kind": "operation", "name": "run-a",
        "component": {"kind": "component", "run": {"kind": "jaxjob", "program": {
            "model": {"name": "transformer_lm"}}}}}
STORES = {"port": RunStore, "reference": JaxRunStore}
CLOCK_KEYS = {"ts", "created_at", "lastUpdateTime", "lastTransitionTime"}


def _untimed(x):
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items() if k not in CLOCK_KEYS}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


def _first_half(store, uuid=UUID):
    store.create_run(uuid, "run-a", "proj", SPEC, tags=["t1"], meta={"origin": "test"})
    for status in ("compiled", "queued", "scheduled"):
        store.set_status(uuid, status, reason="scheduler", message=f"to {status}")


def _second_half(store, uuid=UUID):
    store.set_status(uuid, "starting")
    store.set_status(uuid, "running", reason="executor")
    store.set_meta(uuid, retry_attempts=1, granted_chips=1)
    store.log_event(uuid, "resumed", {"step": 3, "tier": "durable"})
    store.log_event(uuid, "checkpoint_fallback", {"corrupt_steps": [4], "restored_step": 3})
    store.log_metrics(uuid, 1, {"loss": 2.5})
    store.log_metrics(uuid, 2, {"loss": 2.25})
    store.append_log(uuid, "step 1 done")
    store.append_log(uuid, "step 2 done\n")
    store.set_status(uuid, "succeeded", reason="done")


def _view(store, uuid=UUID) -> dict:
    events, cursor = store.read_events_since(None)
    return {
        "by_prefix": store.resolve(uuid[:7]),
        "by_name": store.resolve("run-a"),
        "status": _untimed(store.get_status(uuid)),
        "history": _untimed(store.get_history(uuid)),
        "timeline": _untimed(store.timeline(uuid)),
        "events": _untimed(store.read_events(uuid)),
        "metrics": _untimed(store.read_metrics(uuid)),
        "logs": store.read_logs(uuid),
        "spec": store.read_spec(uuid),
        "runs": _untimed(store.list_runs()),
        "cursor_events": _untimed(events),
        "cursor_seq": cursor.split(":")[0],
    }


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Each package's store after the whole scripted life, and a store
    each package started and the other finished."""
    out = {}
    for name, cls in STORES.items():
        home = tmp_path_factory.mktemp(name)
        store = cls(home)
        _first_half(store)
        _second_half(store)
        out[name] = home
    for first, second in (("port", "reference"), ("reference", "port")):
        home = tmp_path_factory.mktemp(f"{first}-then-{second}")
        _first_half(STORES[first](home))
        _second_half(STORES[second](home))
        out[f"{first}-then-{second}"] = home
    return out


def test_both_stores_hold_the_same_documents(stores):
    ours, ref = _view(RunStore(stores["port"])), _view(JaxRunStore(stores["reference"]))
    assert ours == ref
    assert ours["status"]["status"] == "succeeded"
    assert [e["label"] for e in ours["timeline"]][-3:] == [
        "resumed at step 3 from durable tier",
        "checkpoint fallback: corrupt step(s) [4], restored 3",
        "-> succeeded (done)"]


@pytest.mark.parametrize("written_by", ["port", "reference", "port-then-reference",
                                        "reference-then-port"])
def test_a_store_reads_back_in_the_other_package(stores, written_by):
    home = stores[written_by]
    ours, ref = RunStore(home), JaxRunStore(home)
    assert _view(ours) == _view(ref) == _view(RunStore(stores["port"]))
    # the cursors are the same strings: same index bytes, same offsets
    assert ours.read_events_since(None)[1] == ref.read_events_since(None)[1]
    assert ours.head_cursor() == ref.head_cursor()
    events, cursor = ours.read_events_since(None, limit=5)
    rest, end = ref.read_events_since(cursor)
    assert [e["seq"] for e in events + rest] == list(range(1, len(events) + len(rest) + 1))
    assert end == ours.read_events_since(None)[1]
    # raw history records (timestamps included) are byte-identical reads
    assert ours.get_history(UUID) == ref.get_history(UUID)


def test_timeline_folds_like_the_reference(stores):
    from polyaxon_tpu.store.timeline import fold_timeline as jax_fold

    history = JaxRunStore(stores["reference"]).get_history(UUID)
    assert fold_timeline(history) == jax_fold(history)
    labels = [e["label"] for e in fold_timeline(history)]
    assert labels[0] == "created proj/run-a"
    assert "retry attempts: 1, granted chips: 1" in labels
    assert "resumed at step 3 from durable tier" in labels


def _tear(home, uuid=UUID):
    """A crash mid-append: half a frame at the end of the live segment."""
    seg = sorted((home / "runs" / uuid / "log").glob("[0-9]*.seg"))[-1]
    with open(seg, "ab") as f:
        f.write(b"\x40\x00\x00\x00\x01\x02")  # a header promising 64 bytes, then EOF
    return seg


@pytest.mark.parametrize("healer", ["port", "reference"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_torn_segment_is_healed_by_either_package(tmp_path, writer, healer):
    store = STORES[writer](tmp_path)
    _first_half(store)
    seg = _tear(tmp_path)
    size = seg.stat().st_size
    healed = STORES[healer](tmp_path)
    doc = healed.recover(UUID)
    assert seg.stat().st_size == size - 6  # truncated to the last whole frame
    assert doc["status"] == "scheduled"
    # the other package goes on writing on the healed log
    other = STORES["reference" if healer == "port" else "port"](tmp_path)
    _second_half(other)
    assert _view(RunStore(tmp_path)) == _view(JaxRunStore(tmp_path))
    # the index holds every committed record once, log pulses included
    events, _ = RunStore(tmp_path).read_events_since(None)
    assert [e["seq"] for e in events] == list(range(1, 13))


@pytest.mark.parametrize("compactor", ["port", "reference"])
def test_a_compaction_replays_in_the_other_package(tmp_path, compactor):
    store = STORES[compactor](tmp_path)
    _first_half(store)
    before = JaxRunStore(tmp_path).get_history(UUID)
    store.compact_run(UUID)
    log = tmp_path / "runs" / UUID / "log"
    assert (log / "snapshot.json").exists()
    for cls in STORES.values():
        assert cls(tmp_path).get_history(UUID) == before
    other = STORES["reference" if compactor == "port" else "port"](tmp_path)
    _second_half(other)
    assert _view(RunStore(tmp_path))["history"] == _view(JaxRunStore(tmp_path))["history"]


def test_lifecycle_is_the_references():
    assert [s.value for s in lifecycle.V1Statuses] == [s.value for s in jax_lifecycle.V1Statuses]
    assert {s.value for s in lifecycle.DONE_STATUSES} == {
        s.value for s in jax_lifecycle.DONE_STATUSES}
    for src in jax_lifecycle.V1Statuses:
        for dst in jax_lifecycle.V1Statuses:
            assert lifecycle.can_transition(lifecycle.V1Statuses(src.value),
                                            lifecycle.V1Statuses(dst.value)) == \
                jax_lifecycle.can_transition(src, dst), (src, dst)
        assert lifecycle.is_done(lifecycle.V1Statuses(src.value)) == jax_lifecycle.is_done(src)


def test_illegal_transitions_are_refused_alike(tmp_path):
    for name, cls in STORES.items():
        store = cls(tmp_path / name)
        _first_half(store)
        with pytest.raises(ValueError, match="illegal status transition scheduled → succeeded"):
            store.set_status(UUID, "succeeded")
        with pytest.raises(KeyError):
            store.set_meta("f" * 32, x=1)
        with pytest.raises(KeyError, match="no run matching"):
            store.resolve("nope")
    with pytest.raises(UnknownRunError):
        RunStore(tmp_path / "port").resolve("nope")


def test_racing_terminal_transitions_commit_once(tmp_path):
    stores = [RunStore(tmp_path), JaxRunStore(tmp_path)]
    _first_half(stores[0])
    stores[1].set_status(UUID, "running")
    errors = []

    def stop(store, status):
        try:
            store.set_status(UUID, status)
        except ValueError as e:
            errors.append(e)

    threads = [threading.Thread(target=stop, args=(s, st))
               for s, st in zip(stores, ("succeeded", "failed"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(errors) == 1
    assert RunStore(tmp_path).get_status(UUID)["status"] in ("succeeded", "failed")


def test_a_fleet_store_refuses_terminal_transitions_by_name(tmp_path):
    """A store with a fleet releases a run's gang reservation on each
    terminal transition (succeeded, failed, stopped) and not before, as the
    reference's does; the ledger reads the same in both packages."""
    from polyaxon_tpu.scheduler.fleet import Fleet as JaxFleet
    from polyaxon_tpu_torch.scheduler.fleet import Fleet

    store = RunStore(tmp_path)
    fleet = Fleet(store)
    fleet.configure(chips=3)
    fleet.reserve("other", chips=1)
    for end in ("succeeded", "failed", "stopped"):
        uid = f"run-{end}"
        store.create_run(uid, uid, "p", {})
        fleet.reserve(uid, chips=2)
        for status in ("compiled", "queued", "scheduled", "starting", "running"):
            store.set_status(uid, status)  # not terminal: the chips stay held
        if end == "stopped":
            store.set_status(uid, "stopping")
        assert fleet.ledger.get(uid)["chips"] == 2
        assert JaxFleet(JaxRunStore(tmp_path)).reserved_chips() == 3
        store.set_status(uid, end)
        assert store.get_status(uid)["status"] == end
        assert fleet.ledger.get(uid) is None, f"leaked on {end}"
        assert JaxFleet(JaxRunStore(tmp_path)).reserved_chips() == 1
    assert fleet.ledger.get("other") is not None  # another run's stays


def test_delete_run_removes_queue_entries(tmp_path):
    store = RunStore(tmp_path)
    _first_half(store)
    store.set_status(UUID, "stopped")
    JaxRunQueue(JaxRunStore(tmp_path), name="gpu").push(UUID, {"x": 1})
    JaxRunQueue(JaxRunStore(tmp_path), name="default").push("other", {"x": 2})
    store.delete_run(UUID)
    assert JaxRunQueue(JaxRunStore(tmp_path), name="gpu").peek_all() == []
    assert [e["uuid"] for e in JaxRunQueue(JaxRunStore(tmp_path)).peek_all()] == ["other"]
    assert JaxRunStore(tmp_path).list_runs() == []
    assert not (tmp_path / "runs" / UUID).exists()


def test_watch_sees_the_other_packages_commits(tmp_path):
    ours, ref = RunStore(tmp_path), JaxRunStore(tmp_path)
    _first_half(ours)
    cursor = ours.head_cursor()
    ref.set_status(UUID, "starting")
    events, cursor = ours.wait_events(cursor, timeout=2.0)
    assert [(e["kind"], e["status"], e["r"]) for e in events] == [("status", "starting", UUID)]
    assert ours.wait_events(cursor, timeout=0.05)[0] == []


@pytest.mark.parametrize("source", ["env", "file", "default"])
def test_home_lookup_is_the_references(tmp_path, monkeypatch, source):
    monkeypatch.delenv("POLYAXON_HOME", raising=False)
    monkeypatch.setenv("POLYAXON_CONFIG_DIR", str(tmp_path / "cfg"))
    if source == "env":
        monkeypatch.setenv("POLYAXON_HOME", str(tmp_path / "from-env"))
    if source in ("env", "file"):
        (tmp_path / "cfg").mkdir()
        (tmp_path / "cfg" / "config.json").write_text(
            json.dumps({"home": str(tmp_path / "from-file")}))
    assert settings.get("home") == jax_settings.get("home")
    assert str(polyaxon_home()) == settings.get("home")
    want = {"env": tmp_path / "from-env", "file": tmp_path / "from-file",
            "default": Path.home() / ".polyaxon"}[source]
    assert settings.get("home") == str(want)
