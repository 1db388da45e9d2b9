"""The port stands alone: no module of `polyaxon_tpu_torch/` nor
`chip_smoke.py` imports JAX, its libraries, the JAX package,
`transformers` (the HF converter reads checkpoints by duck typing), or
the packages the card's machine does not have (`yaml`, `click`,
`pydantic`, `psutil`: the port reads YAML with its own `yaml_lite`, parses
its CLI with argparse, validates its specs by hand and reads host metrics
from /proc), and every entry point defaults to the card and raises
without one."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from polyaxon_tpu_torch import DEFAULT_DEVICE, resolve_device
from polyaxon_tpu_torch.models import build_model
from polyaxon_tpu_torch.models.transformer import Transformer, _make_config
from polyaxon_tpu_torch.runtime import Trainer
from polyaxon_tpu_torch.serving.batching import ServingConfig
from polyaxon_tpu_torch.serving.server import ModelServer

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "polyaxon_tpu", "transformers",
             "yaml", "click", "pydantic", "psutil")
SOURCES = sorted((REPO / "polyaxon_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_import_walk_sees_the_package():
    names = {p.name for p in SOURCES}
    assert {"flash_attention.py", "transformer.py", "server.py", "chip_smoke.py",
            "losses.py", "optimizers.py", "trainer.py", "run_kinds.py",
            "synthetic.py", "stats.py", "checkpoint.py", "preemption.py",
            "injector.py", "plan.py", "registry.py", "spans.py", "monitors.py",
            "retry.py", "convert.py", "kv_pages.py", "kv.py", "steps.py",
            "batching.py", "adapters.py", "tenancy.py", "spill.py", "framing.py",
            "lora.py", "tracing.py", "slo.py", "history.py", "detect.py",
            "federate.py", "handoff.py", "affinity.py", "replicas.py",
            "router.py", "eventlog.py", "timeline.py", "local.py", "lifecycle.py",
            "base.py", "files.py", "dataloader.py", "settings.py", "queue.py",
            "layers.py", "mlp.py", "encoder.py", "vit.py", "bert.py", "seq2seq.py",
            "resnet.py", "moe.py", "convert_hf.py", "yaml_lite.py", "reader.py",
            "resolver.py", "interpolation.py", "executor.py", "run_client.py", "main.py",
            "__main__.py", "operation.py", "component.py", "matrix.py",
            "mesh.py", "sharding.py", "collectives.py", "params.py", "ring.py",
            "ulysses.py", "worker.py", "health.py"} <= names
    parallel = {p.name for p in SOURCES if p.parent.name == "parallel"}
    assert {"mesh.py", "sharding.py", "collectives.py", "params.py", "ring.py",
            "ulysses.py", "pipeline.py"} <= parallel
    tuner = {p.name for p in SOURCES if p.parent.name == "tuner"}
    assert {"__init__.py", "space.py", "early_stopping.py", "managers.py", "placement.py",
            "driver.py"} <= tuner
    scheduler = {p.name for p in SOURCES if p.parent.name == "scheduler"}
    assert {"queue.py", "topology.py", "dag.py", "joins.py"} <= scheduler
    assert "jax" in _imported_roots(REPO / "tests" / "test_torch_attention.py")


def test_default_device_is_the_card(monkeypatch):
    assert DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    cfg = _make_config(dict(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                            vocab_size=16, seq_len=16))
    with pytest.raises(RuntimeError, match="cuda"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model("transformer_lm", dict(dim=32, n_layers=1, n_heads=2, vocab_size=16))
    with pytest.raises(RuntimeError, match="cuda"):  # the pipelined stack too
        Transformer(_make_config(dict(dim=32, n_layers=2, n_heads=2, n_kv_heads=1,
                                      vocab_size=16, seq_len=16, pipeline_stages=2)))
    with pytest.raises(RuntimeError, match="cuda"):
        ModelServer(Transformer(cfg, device="cpu"))
    # the multi-tenant server (stacked adapter slots, the registry and its
    # spill manager, the KV spill tier) defaults to the card as well
    lora = _make_config(dict(dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                             vocab_size=16, seq_len=16, lora_rank=2))
    tenants = ServingConfig(adapters=(("a", "seed:1"),), tenants=((("adapter", "a"),
                            ("name", "t")),), kv_pool_pages=8, kv_page_tokens=4,
                            spill_ram_bytes=1 << 20)
    with pytest.raises(RuntimeError, match="cuda"):
        ModelServer(Transformer(lora, device="cpu"), None, tenants)
    served = ModelServer(Transformer(lora, device="cpu"), None, tenants, device="cpu")
    assert served.module.cfg.adapter_slots == 2
    assert served.module.layers[0].attention.q_proj.lora_a.device == torch.device("cpu")
    program = {
        "model": {"name": "transformer_lm", "config": dict(
            dim=32, n_layers=1, n_heads=2, vocab_size=16, seq_len=16)},
        "data": {"name": "synthetic_text", "config": {"seq_len": 16, "vocab_size": 16}},
    }
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(program)
    assert Trainer(program, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    # the disaggregated roles default to the card as well
    pooled = ServingConfig(role="prefill", chunked_prefill=True, kv_pool_pages=8,
                           kv_page_tokens=4)
    with pytest.raises(RuntimeError, match="cuda"):
        ModelServer(Transformer(cfg, device="cpu"), None, pooled)


ZOO = [("mlp", {"hidden": [8]}), ("resnet", {"depth": 18, "width": 4}),
       ("resnet50", {"width": 4}), ("vit", {"preset": "tiny-test"}),
       ("bert", {"preset": "tiny-test"}), ("seq2seq", {"preset": "tiny-test"}),
       ("transformer_lm", {"dim": 32, "n_layers": 1, "n_heads": 2, "vocab_size": 16,
                           "seq_len": 16, "n_experts": 2})]


@pytest.mark.parametrize("name,config", ZOO, ids=[f"{n}-{i}" for i, (n, _) in enumerate(ZOO)])
def test_zoo_builders_default_to_the_card(monkeypatch, name, config):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(name, dict(config))
    module = build_model(name, dict(config), device="cpu").module
    assert all(p.device == torch.device("cpu") for p in module.parameters())


def test_convert_hf_runs_without_transformers():
    """`models/convert_hf.py` converts a duck-typed checkpoint in a process
    where `transformers` cannot be imported."""
    code = (
        "import sys; sys.modules['transformers'] = None\n"
        "import torch\n"
        "from polyaxon_tpu_torch.models.convert_hf import from_hf_llama, to_hf_llama_state_dict\n"
        "cfg = dict(hidden_size=8, num_attention_heads=2, num_key_value_heads=1,\n"
        "           intermediate_size=16, num_hidden_layers=1, vocab_size=10,\n"
        "           max_position_embeddings=8, rms_norm_eps=1e-5, tie_word_embeddings=True)\n"
        "shapes = {'model.embed_tokens.weight': (10, 8), 'model.norm.weight': (8,)}\n"
        "pre = 'model.layers.0.'\n"
        "shapes.update({pre + 'input_layernorm.weight': (8,),\n"
        "               pre + 'post_attention_layernorm.weight': (8,),\n"
        "               pre + 'self_attn.q_proj.weight': (8, 8), pre + 'self_attn.k_proj.weight': (4, 8),\n"
        "               pre + 'self_attn.v_proj.weight': (4, 8), pre + 'self_attn.o_proj.weight': (8, 8),\n"
        "               pre + 'mlp.gate_proj.weight': (16, 8), pre + 'mlp.up_proj.weight': (16, 8),\n"
        "               pre + 'mlp.down_proj.weight': (8, 16)})\n"
        "sd = {k: torch.randn(v) for k, v in shapes.items()}\n"
        "model_cfg, state = from_hf_llama(sd, config=cfg)\n"
        "back = to_hf_llama_state_dict(model_cfg, state)\n"
        "assert all(torch.equal(back[k], sd[k]) for k in sd) and 'transformers' not in [\n"
        "    m for m, mod in sys.modules.items() if mod is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


FLEET = ("serving/router.py", "serving/replicas.py", "serving/affinity.py",
         "serving/handoff.py", "telemetry/tracing.py", "telemetry/slo.py",
         "telemetry/history.py", "telemetry/detect.py", "telemetry/federate.py")


@pytest.mark.parametrize("rel", FLEET)
def test_fleet_and_telemetry_copies_stand_alone(rel):
    """The router and telemetry are own copies of JAX-free reference
    modules: they import nothing of the reference, and no torch at module
    level (the flight recorder's profiler imports it inside its window)."""
    path = REPO / "polyaxon_tpu_torch" / rel
    roots = _imported_roots(path)
    assert not roots & set(FORBIDDEN), rel
    top = ast.parse(path.read_text())
    top_roots = {a.name.split(".")[0] for n in top.body if isinstance(n, ast.Import)
                 for a in n.names}
    top_roots |= {n.module.split(".")[0] for n in top.body
                  if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module}
    assert "torch" not in top_roots, rel


def _run_smoke(cwd: Path, script: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # as on a machine without a card
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = _run_smoke(tmp_path, alone)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


STORE_AND_SPECS = ("store/eventlog.py", "store/timeline.py", "store/local.py",
                   "store/framing.py", "schemas/lifecycle.py", "schemas/base.py",
                   "schemas/run_kinds.py", "settings.py", "scheduler/queue.py",
                   "data/files.py", "native/dataloader.py", "schemas/io.py",
                   "schemas/termination.py", "schemas/environment.py", "schemas/matrix.py",
                   "schemas/component.py", "schemas/operation.py", "polyaxonfile/yaml_lite.py",
                   "polyaxonfile/reader.py", "compiler/interpolation.py",
                   "compiler/contexts.py", "compiler/resolver.py", "client/run_client.py",
                   "cli/main.py", "retry.py")


@pytest.mark.parametrize("rel", STORE_AND_SPECS)
def test_store_specs_and_data_copies_stand_alone(rel):
    """Own copies of JAX-free reference modules: nothing of the reference,
    and no torch (nor pydantic) at module level."""
    roots = _imported_roots(REPO / "polyaxon_tpu_torch" / rel)
    assert not roots & set(FORBIDDEN), rel
    assert not roots & {"torch", "pydantic"}, rel


def test_the_native_loader_builds_only_from_the_port(tmp_path, monkeypatch):
    """No path of the port, and no build command, points into the JAX
    package's `native/` (whose Makefile builds the reference's copy)."""
    from polyaxon_tpu_torch.native import dataloader as native

    reference = (REPO / "polyaxon_tpu" / "native").resolve()
    for path in (native.SOURCE, native.BUILD_DIR, native.library_path()):
        assert not path.resolve().is_relative_to(reference), path
    assert native.SOURCE.resolve().is_relative_to(REPO / "polyaxon_tpu_torch")
    commands = []

    def fake_run(cmd, **kwargs):
        commands.append(cmd)
        raise OSError("not building here")

    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    with pytest.raises(native.NativeBuildError):
        native.build()
    (cmd,) = commands
    assert "make" not in Path(cmd[0]).name
    assert str(native.SOURCE) in cmd and "-shared" in cmd
    assert not any(str(reference) in str(a) or "polyaxon_tpu/native" in str(a) for a in cmd)


def test_from_run_defaults_to_the_card(tmp_path, monkeypatch):
    import inspect

    from polyaxon_tpu_torch.store import RunStore

    assert inspect.signature(ModelServer.from_run).parameters["device"].default == "cuda"
    store = RunStore(tmp_path)
    program = {"model": {"name": "transformer_lm", "config": dict(
        dim=32, n_layers=1, n_heads=2, vocab_size=16, seq_len=16)}}
    store.create_run("a" * 32, "r", "p", {"component": {"run": {
        "kind": "jaxjob", "program": program}}})
    (store.outputs_dir("a" * 32) / "checkpoints").mkdir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ModelServer.from_run("r", store=store)


def test_cli_run_needs_the_card_unless_told_otherwise(monkeypatch, tmp_path, capsys):
    """With POLYAXON_TORCH_DEVICE unset and no card, `run` fails on the
    device before any run exists: nothing carries on on the CPU."""
    from polyaxon_tpu_torch.cli.main import main
    from polyaxon_tpu_torch.compiler import compile_operation
    from polyaxon_tpu_torch.polyaxonfile import read_polyaxonfile
    from polyaxon_tpu_torch.runtime.executor import Executor
    from polyaxon_tpu_torch.store import RunStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("POLYAXON_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("POLYAXON_HOME", str(tmp_path))
    mnist = str(REPO / "examples" / "mnist.yaml")
    assert main(["run", "-f", mnist, "-P", "steps=1"]) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: ") and "cuda" in err and "device='cpu'" in err
    assert RunStore(tmp_path).list_runs() == []
    compiled = compile_operation(read_polyaxonfile(mnist))
    with pytest.raises(RuntimeError, match="cuda"):
        Executor(RunStore(tmp_path)).execute(compiled)
    assert RunStore(tmp_path).list_runs() == []
    monkeypatch.setenv("POLYAXON_TORCH_DEVICE", "tpu")
    assert main(["version"]) == 1
    assert "POLYAXON_TORCH_DEVICE='tpu'" in capsys.readouterr().err


CONTROL_PLANE = ("streams/__init__.py", "streams/server.py", "streams/openapi.py",
                 "streams/ui.py", "tracking/run.py", "tracking/callbacks.py", "cli/top.py")


@pytest.mark.parametrize("rel", CONTROL_PLANE)
def test_control_plane_copies_stand_alone(rel):
    """The streams server, the in-job tracking client, its callbacks and
    `top` are own copies of JAX-free reference modules: nothing of the
    reference, no torch and no transformers (the HF callback duck-types
    `TrainerCallback`)."""
    roots = _imported_roots(REPO / "polyaxon_tpu_torch" / rel)
    assert not roots & set(FORBIDDEN), rel
    assert not roots & {"torch", "transformers", "pydantic"}, rel
