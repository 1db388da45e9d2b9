"""`ModelServer.from_run` of the port against the JAX package's, on the CPU.

- A JAX run (the reference's Executor on a tiny f32 `transformer_lm`, the
  spec of `tests/test_serving.py`, with serving pins) is served by the
  reference's `from_run`. Its params, converted with `params_from_jax`,
  are saved as a port run's `state.pt`; the port's `from_run` serves them
  with the same greedy tokens, on the dense, the paged and the int8
  configs, and with the same config (the spec's pins, the overrides
  layered over them).
- A port run trained on `token_file` (native loader) from the JAX init
  restores bit-equal to its trainer's final params, and lands within
  `tests/test_torch_trainer.py`'s float32 tolerances of the JAX run on the
  same corpus (whose Python stream yields the same batches).
- The reference's errors hold, plus one for a run whose checkpoints are
  Orbax's (a JAX run: the port reads no Orbax); a mesh is refused by name;
  the file is read with `torch.load(mmap=True)` and only its params; no
  data pipeline is built; the run's observability block is wired.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import yaml

from polyaxon_tpu.compiler import compile_operation
from polyaxon_tpu.polyaxonfile import read_polyaxonfile
from polyaxon_tpu.runtime import Executor
from polyaxon_tpu.runtime.checkpoint import close_all as jax_close_all
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram
from polyaxon_tpu.serving import ModelServer as JaxServer
from polyaxon_tpu.store import RunStore as JaxRunStore
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.runtime import Trainer
from polyaxon_tpu_torch.runtime.checkpoint import close_all
from polyaxon_tpu_torch.serving.batching import ServingError
from polyaxon_tpu_torch.serving.server import ModelServer
from polyaxon_tpu_torch.store import RunStore, UnknownRunError

MODEL = {"preset": "tiny", "seq_len": 64, "n_layers": 2, "dim": 64, "vocab_size": 256}
SERVING = {"maxBatch": 3, "maxWaitMs": 7.0, "maxQueue": 11, "breakerThreshold": 4}
PROGRAM = {
    "model": {"name": "transformer_lm", "config": MODEL},
    "data": {"name": "synthetic_text", "batchSize": 8,
             "config": {"seq_len": 64, "vocab_size": 256}},
    "optimizer": {"name": "adamw", "learningRate": 0.001},
    "train": {"steps": 2, "logEvery": 2, "precision": "float32", "checkpointEvery": 2},
    "serving": SERVING,
}
UUID = "0f0e0d0c0b0a09080706050403020100"
BODIES = [
    {"tokens": [[1, 2, 3, 4, 5, 6, 7, 8, 9]], "maxNewTokens": 6},
    {"tokens": [[17, 3, 99, 250, 4], [8, 8, 8, 1, 2]], "maxNewTokens": 5},
]
CONFIGS = {  # config_overrides on both sides
    "dense": {},
    "paged": {"kv_pool_pages": 24, "kv_page_tokens": 8},
    "int8": {"quantize": True},
}


def _spec(program, name="lm-for-serving"):
    return {"version": 1.1, "kind": "operation", "name": name,
            "component": {"kind": "component", "name": name,
                          "run": {"kind": "jaxjob", "program": program}}}


def _port_run(home, program, uuid=UUID, name="lm-for-serving"):
    store = RunStore(home)
    store.create_run(uuid, name, "default", _spec(program, name))
    return store, store.outputs_dir(uuid) / "checkpoints"


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run trained by the reference's Executor: (store, uuid)."""
    home = tmp_path_factory.mktemp("jax-home")
    path = home / "lm.yaml"
    path.write_text(yaml.safe_dump(_spec(PROGRAM)))
    store = JaxRunStore(home)
    compiled = compile_operation(read_polyaxonfile(str(path)))
    assert Executor(store, devices=jax.devices()[:1]).execute(compiled) == "succeeded"
    jax_close_all()
    return store, compiled.run_uuid


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """The JAX run's params as a port run's state.pt (step 2): (store, uuid)."""
    jstore, juuid = jax_run
    jsrv = JaxServer.from_run(juuid, store=jstore)
    params = jax.tree.map(np.asarray, jsrv.params)
    store, ckpt = _port_run(tmp_path_factory.mktemp("port-home"), PROGRAM)
    trainer = Trainer(PROGRAM, device="cpu", checkpoint_dir=str(ckpt))
    trainer.load_state_dict(params_from_jax(params, trainer.module.cfg))
    trainer.step = jsrv.step
    assert trainer.save(jsrv.step, wait=True)
    close_all()
    return store, UUID


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_tokens_equal_the_reference_from_run(jax_run, port_run, name):
    jsrv = JaxServer.from_run(jax_run[1], store=jax_run[0], config_overrides=CONFIGS[name])
    ours = ModelServer.from_run(port_run[1][:8], store=port_run[0],
                                config_overrides=CONFIGS[name], device="cpu")
    assert ours.step == jsrv.step == 2
    assert ours.module.cfg.quant == ("int8" if name == "int8" else "none")
    for body in BODIES:
        assert ours.generate(body) == jsrv.generate(body)
    fields = {f.name for f in dataclasses.fields(jsrv.config)} & {
        f.name for f in dataclasses.fields(ours.config)}
    assert {f: getattr(ours.config, f) for f in fields} == {
        f: getattr(jsrv.config, f) for f in fields}


def test_the_spec_pins_the_config_and_overrides_layer_over_it(jax_run, port_run):
    store, uuid = port_run
    ours = ModelServer.from_run(uuid, store=store, device="cpu",
                                config_overrides={"max_queue": 2, "default_deadline_ms": 123.0})
    assert ours.config.max_queue == 2 and ours.config.default_deadline_ms == 123.0
    assert (ours.config.max_batch, ours.config.max_wait_ms, ours.config.breaker_threshold) == (
        3, 7.0, 4)
    ref = JaxServer.from_run(jax_run[1], store=jax_run[0],
                             config_overrides={"max_queue": 2, "default_deadline_ms": 123.0})
    assert (ref.config.max_queue, ref.config.max_batch) == (2, 3)
    plain = ModelServer.from_run("lm-for-serving", store=store, device="cpu")  # by name
    assert plain.config.max_queue == 11
    # an explicit config replaces the spec's knobs wholesale
    from polyaxon_tpu_torch.serving.batching import ServingConfig

    assert ModelServer.from_run(uuid, store=store, config=ServingConfig(max_batch=5),
                                device="cpu").config.max_queue == 64


def test_reads_params_only_with_mmap_and_no_data_pipeline(port_run, monkeypatch):
    store, uuid = port_run
    calls = []
    real_load = torch.load

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real_load(*args, **kwargs)

    def boom(*a, **k):
        raise AssertionError("serving must not build the data pipeline")

    monkeypatch.setattr(torch, "load", spy)
    monkeypatch.setattr("polyaxon_tpu_torch.runtime.trainer.build_data", boom)
    monkeypatch.setattr("polyaxon_tpu_torch.data.build_data", boom)
    server = ModelServer.from_run(uuid, store=store, device="cpu")
    assert calls == [{"map_location": "cpu", "mmap": True, "weights_only": True}]
    info = server.restore_info
    params = sum(v.numel() * v.element_size() for v in server.module.state_dict().values())
    assert info["step"] == 2 and info["bytes_read"] == params
    assert info["path"].endswith("checkpoints/2/state.pt")
    state = real_load(info["path"], weights_only=True)
    for name, value in state["model"].items():
        assert torch.equal(server.module.state_dict()[name], value), name


def test_errors_are_the_references(jax_run, port_run, tmp_path):
    store, uuid = port_run
    with pytest.raises(UnknownRunError):
        ModelServer.from_run("nope", store=store, device="cpu")
    with pytest.raises(KeyError):
        JaxServer.from_run("nope", store=JaxRunStore(store.home))
    # not a native program run
    other = "1" * 32
    store.create_run(other, "a-job", "default",
                     {"component": {"run": {"kind": "job", "container": {"command": ["true"]}}}})
    with pytest.raises(ServingError, match="is not a native jaxjob program run"):
        ModelServer.from_run(other, store=store, device="cpu")
    # not the LM family
    mlp = {**PROGRAM, "model": {"name": "mlp", "config": {}}}
    store.create_run("2" * 32, "an-mlp", "default", _spec(mlp, "an-mlp"))
    with pytest.raises(ServingError, match="serving supports the LM family"):
        ModelServer.from_run("an-mlp", store=store, device="cpu")
    # trained without checkpointEvery
    bare = {**PROGRAM, "train": {"steps": 1, "precision": "float32"}}
    store.create_run("3" * 32, "no-ckpt", "default", _spec(bare, "no-ckpt"))
    with pytest.raises(ServingError, match="no checkpoints under its outputs"):
        ModelServer.from_run("no-ckpt", store=store, device="cpu")
    # a JAX run: Orbax steps, no state.pt (the port's store reads the JAX store)
    with pytest.raises(ServingError, match="Orbax"):
        ModelServer.from_run(jax_run[1], store=RunStore(jax_run[0].home), device="cpu")
    # an empty checkpoints directory
    (store.outputs_dir("3" * 32) / "checkpoints").mkdir()
    with pytest.raises(ServingError, match="no restorable checkpoint"):
        ModelServer.from_run("no-ckpt", store=store, device="cpu")
    # a mesh of two ranks needs their world (tests/test_torch_serving_mesh.py
    # serves one), whatever else the config asks for; a 1x1 mesh is the
    # single-card path
    with pytest.raises(ValueError, match="needs 2 devices, only 1 visible"):
        ModelServer.from_run(uuid, store=store, mesh_axes={"model": 2}, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, only 1 visible"):
        ModelServer.from_run(uuid, store=store, mesh_axes={"model": 2},
                             config_overrides={"speculate": True}, device="cpu")
    assert ModelServer.from_run(uuid, store=store, mesh_axes={"model": 1},
                                device="cpu").config.mesh_axes is None


def test_observability_is_wired_from_the_spec(port_run, tmp_path):
    src_store, _ = port_run
    program = {**PROGRAM, "observability": {
        "slos": [{"name": "fast", "kind": "latency", "objective": 0.99, "thresholdMs": 500}],
        "history": {"intervalS": 0.5}, "regressionRules": "default"}}
    store, ckpt = _port_run(tmp_path, program, name="observed")
    src = src_store.outputs_dir(UUID) / "checkpoints" / "2"
    (ckpt / "2").mkdir(parents=True)
    (ckpt / "2" / "state.pt").write_bytes((src / "state.pt").read_bytes())
    server = ModelServer.from_run("observed", store=store, device="cpu")
    out = store.outputs_dir(UUID)
    assert [o.name for o in server.slo_engine.objectives] == ["fast"]
    assert server.history.root == out / "telemetry" / "history"
    assert server.flight_recorder is not None
    assert server.sentinel.rules
    server.sentinel._on_event("perf_regression", {"rule": "x"})  # into the run's log
    assert store.read_events(UUID)[-1]["kind"] == "perf_regression"


@pytest.fixture(scope="module")
def token_runs(tmp_path_factory):
    """The JAX Trainer and the port's (from the JAX init) on one token_file
    corpus; the port run checkpoints into its run store."""
    home = tmp_path_factory.mktemp("corpus-home")
    corpus = home / "corpus.bin"
    np.random.default_rng(0).integers(0, 256, 50_000).astype(np.uint32).tofile(corpus)
    program = {**PROGRAM,
               "data": {"name": "token_file", "batchSize": 4, "config": {
                   "path": str(corpus), "seq_len": 64, "dtype": "uint32",
                   "vocab_size": 256, "loader": "python"}},
               "train": {"steps": 3, "logEvery": 1, "precision": "float32",
                         "checkpointEvery": 3}}
    jprog = {**program, "train": {k: v for k, v in program["train"].items()
                                  if k != "checkpointEvery"}}
    jt = JaxTrainer(JaxProgram.from_dict(jprog), devices=jax.devices()[:1])
    init = jax.tree.map(np.asarray, jt.state.params)
    jr = jt.run()
    final = jax.tree.map(np.asarray, jr.state.params)
    native = {**program, "data": {**program["data"], "config": {
        **program["data"]["config"], "loader": "native"}}}
    store, ckpt = _port_run(home, native, name="on-a-corpus")
    trainer = Trainer(program, device="cpu", checkpoint_dir=str(ckpt))
    trainer.load_state_dict(params_from_jax(init, trainer.module.cfg))
    result = trainer.run()
    trainer.close()
    close_all()
    return {"store": store, "trainer": trainer, "history": result.history,
            "jax_history": jr.history, "init": init, "final": final}


def test_a_corpus_run_restores_bit_equal_to_its_trainer(token_runs):
    server = ModelServer.from_run("on-a-corpus", store=token_runs["store"], device="cpu")
    assert server.step == 3
    want = token_runs["trainer"].module.state_dict()
    got = server.module.state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_a_corpus_run_matches_the_jax_run(token_runs):
    ours = [h for h in token_runs["history"] if "loss" in h]
    ref = [h for h in token_runs["jax_history"] if "loss" in h]
    assert [h["step"] for h in ours] == [h["step"] for h in ref] == [1, 2, 3]
    for a, b in zip(ours, ref):  # test_torch_trainer.py's float32 tolerances
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=5e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=5e-5)
    cfg = token_runs["trainer"].module.cfg
    start = params_from_jax(token_runs["init"], cfg)
    want = params_from_jax(token_runs["final"], cfg)
    got = token_runs["trainer"].module.state_dict()
    num = sum(((got[k].float() - want[k]) ** 2).sum() for k in want)
    den = sum(((want[k] - start[k]) ** 2).sum() for k in want)
    assert den > 0 and (num / den).sqrt().item() < 1e-3


def test_the_spec_schemas_parse_like_the_reference():
    from polyaxon_tpu.schemas import run_kinds as jrk
    from polyaxon_tpu_torch.schemas import run_kinds as trk

    run = {"kind": "jaxjob", "replicas": 1, "program": {
        **PROGRAM,
        "serving": {**SERVING, "kvPoolPages": 8, "chunkedPrefill": True,
                    "adapters": {"a1": "seed:1"},
                    "tenants": [{"name": "t", "adapter": "a1", "maxOutstanding": 2}],
                    "pools": {"prefill": 1, "decode": 1}},
        "observability": {"slos": [{"name": "s", "objective": 0.9}],
                          "history": {"enabled": True, "maxBytes": 1 << 20},
                          "regressionRules": [{"name": "r", "series": "x", "threshold": 2}]}},
        "environment": {"resources": {"chips": 4}}, "volumes": [{"name": "v"}]}
    ours, ref = trk.V1JAXJob.from_dict(run), jrk.V1JAXJob.model_validate(run)
    ours_d, ref_d = dataclasses.asdict(ours), ref.model_dump()
    assert ours_d == ref_d
    assert ours.to_dict() == ref.to_dict()
    obs, robs = ours.program.observability, ref.program.observability
    assert obs.rules_config() == robs.rules_config()
    assert [s.to_config() for s in obs.slos] == [s.to_config() for s in robs.slos]
    assert obs.history.to_config("/h") == robs.history.to_config("/h")
    rcfg, ocfg = ref.program.serving.to_config(), ours.program.serving.to_config()
    fields = {f.name for f in dataclasses.fields(rcfg)} & {
        f.name for f in dataclasses.fields(ocfg)}
    assert {f: getattr(ocfg, f) for f in fields} == {f: getattr(rcfg, f) for f in fields}
    for name in ("V1ServingSpec", "V1TenantSpec", "V1PoolsSpec", "V1SLOSpec", "V1HistorySpec",
                 "V1RegressionRuleSpec", "V1ObservabilitySpec", "V1MeshSpec", "V1JAXJob",
                 "V1Program"):
        rfields = getattr(jrk, name).model_fields
        ofields = {f.name: f for f in dataclasses.fields(getattr(trk, name))}
        assert ofields.keys() == rfields.keys(), name
        for f, info in rfields.items():
            if not info.is_required() and not isinstance(info.default, (dict, list)):
                assert ofields[f].default == info.default, (name, f)
    bad = [
        {"serving": {"chunkedPrefill": True}},
        {"serving": {"kvQuant": "int8"}},
        {"serving": {"draftTokens": 17}},
        {"serving": {"tenants": [{"name": "t", "adapter": "zz"}]}},
        {"serving": {"pools": {"prefill": 1, "decode": 0}}},
        {"serving": {"meshAxes": {"pipeline": 2}}},
        {"observability": {"regressionRules": "default"}},
        {"observability": {"slos": [{"name": "l", "kind": "latency"}]}},
        {"observability": {"histogramBuckets": [2.0, 1.0]}},
    ]
    for extra in bad:
        bad_run = {"kind": "jaxjob", "program": {**PROGRAM, "serving": None, **extra}}
        with pytest.raises(ValueError):
            jrk.V1JAXJob.model_validate(bad_run)
        with pytest.raises(ValueError):
            trk.V1JAXJob.from_dict(bad_run)
    mesh = {"kind": "jaxjob", "program": {**PROGRAM, "serving": {"meshAxes": {"model": 4}}},
            "environment": {"resources": {"chips": 2}}}
    with pytest.raises(ValueError, match="needs 4 chips"):
        jrk.V1JAXJob.model_validate(mesh)
    with pytest.raises(ValueError, match="needs 4 chips"):
        trk.V1JAXJob.from_dict(mesh)
    with pytest.raises(ValueError, match="program"):
        trk.V1JAXJob.from_dict({"kind": "jaxjob"})
