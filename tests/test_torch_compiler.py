"""The port's compiler against the JAX package's, on the CPU.

`compile_operation(...).to_dict()` and `spec_fingerprint` must be equal,
compared as JSON text (key order and int/float count), with the run uuid
pinned so it does not differ. The cases are every example and those of
`tests/test_compiler.py`: params with defaults and coercion, globals,
patches under each strategy, presets, legacy kinds, interpolation errors
and mesh validation. A case the reference refuses must be refused with
`CompilationError` (or, for a bad param type, the reference's ValueError).
"""

import json
from pathlib import Path

import pytest

from polyaxon_tpu.compiler import CompilationError as JaxCompilationError
from polyaxon_tpu.compiler import apply_suggestion as jax_apply_suggestion
from polyaxon_tpu.compiler import compile_operation as jax_compile
from polyaxon_tpu.compiler import interpolate_str as jax_interpolate_str
from polyaxon_tpu.compiler.resolver import spec_fingerprint as jax_fingerprint
from polyaxon_tpu.polyaxonfile import read_polyaxonfile as jax_read
from polyaxon_tpu.schemas import V1Operation as JaxOperation
from polyaxon_tpu_torch.compiler import (
    CompilationError,
    apply_suggestion,
    compile_operation,
    has_template,
    interpolate_str,
    spec_fingerprint,
)
from polyaxon_tpu_torch.polyaxonfile import read_polyaxonfile
from polyaxon_tpu_torch.schemas import V1Operation

EXAMPLES = sorted((Path(__file__).resolve().parents[1] / "examples").glob("*.yaml"))
UUID = "0123456789abcdef0123456789abcdef"


def _compile_both(doc_or_ops, **kw):
    """(ours, reference): (to_dict JSON, fingerprint) or an error class name."""
    if isinstance(doc_or_ops, dict):
        ours_op, ref_op = V1Operation.from_dict(doc_or_ops), JaxOperation.model_validate(doc_or_ops)
    else:
        ours_op, ref_op = doc_or_ops
    out = []
    for compile_, fp, op, err in ((compile_operation, spec_fingerprint, ours_op, CompilationError),
                                  (jax_compile, jax_fingerprint, ref_op, JaxCompilationError)):
        try:
            c = compile_(op, run_uuid=UUID, artifacts_root="/tmp/art", **kw)
            out.append((json.dumps(c.to_dict(), default=str), fp(c), c.params))
        except err:
            out.append("CompilationError")
        except ValueError:
            out.append("ValueError")
    return out


def jaxjob(**over):
    doc = {
        "kind": "operation", "name": "t",
        "component": {
            "kind": "component",
            "inputs": [{"name": "lr", "type": "float", "value": 0.1},
                       {"name": "steps", "type": "int", "value": 10}],
            "run": {"kind": "jaxjob", "program": {
                "model": {"name": "mlp"},
                "optimizer": {"learningRate": "{{ params.lr }}"},
                "train": {"steps": "{{ params.steps }}", "logEvery": 5},
            }},
        },
    }
    doc.update(over)
    return doc


def legacy(kind, groups):
    return {"kind": "operation", "component": {"kind": "component", "run": {
        "kind": kind, **groups, "program": {"model": {"name": "mlp"}}}}}


def with_mesh(mesh, topology="2x4", slices=None):
    tpu = {"type": "v5e", "topology": topology, **({"slices": slices} if slices else {})}
    return jaxjob(runPatch={"mesh": mesh, "environment": {"resources": {"tpu": tpu}}})


CASES = {
    "defaults": jaxjob(),
    "override-coerced": jaxjob(params={"lr": {"value": "0.5"}}),
    "override-shorthand": jaxjob(params={"lr": 0.25, "extra": "ctx"}),
    "bad-param-type": jaxjob(params={"lr": {"value": "abc"}}),
    "missing-required": {"kind": "operation", "component": {
        "kind": "component", "inputs": [{"name": "req", "type": "int"}],
        "run": {"kind": "job", "container": {"command": ["x"]}}}},
    "run-patch": jaxjob(runPatch={"program": {"train": {"logEvery": 99}}}),
    "patch-pre-merge": jaxjob(runPatch={"program": {"train": {"logEvery": 99, "seed": 3}}},
                              patchStrategy="pre_merge"),
    "patch-isnull": jaxjob(runPatch={"program": {"train": {"logEvery": 99, "seed": 3}}},
                           patchStrategy="isnull"),
    "patch-replace": jaxjob(runPatch={"kind": "job", "container": {"command": ["echo"]}},
                            patchStrategy="replace"),
    "environment-patch": jaxjob(environment={"resources": {"tpu": {"type": "v5e",
                                                                    "topology": "2x2"}}}),
    "termination-merge": jaxjob(termination={"maxRetries": 3, "backoff": 0.5}),
    "embedded-template": jaxjob(runPatch={"program": {"data": {
        "name": "synthetic", "config": {"tag": "run-{{ globals.uuid }}-{{ params.steps }}"}}}}),
    "unknown-reference": jaxjob(runPatch={"program": {"train": {"seed": "{{ params.nope }}"}}}),
    "str-in-int-field": jaxjob(params={"steps": {"value": "x"}},
                               component={**jaxjob()["component"], "inputs": [
                                   {"name": "lr", "type": "float", "value": 0.1},
                                   {"name": "steps", "type": "str", "value": "10"}]}),
    "mesh-autofill": with_mesh({"data": -1, "model": 2}),
    "mesh-exact": with_mesh({"data": 8}),
    "mesh-mismatch": with_mesh({"data": 3}),
    "mesh-indivisible": with_mesh({"data": -1, "model": 3}),
    "mesh-multislice": with_mesh({"data": -1, "model": 2}, slices=2),
    "mesh-multislice-data": with_mesh({"data": 1, "model": 16}, slices=2),
    "gpu-rejected": jaxjob(environment={"resources": {"gpu": 4}}),
    "tfjob": legacy("tfjob", {"chief": {"replicas": 1, "container": {"command": ["t"]}},
                              "worker": {"replicas": 3}}),
    "pytorchjob": legacy("pytorchjob", {"master": {"replicas": 1}, "worker": {"replicas": 7}}),
    "tfjob-ps": legacy("tfjob", {"worker": {"replicas": 2}, "ps": {"replicas": 1}}),
    "mpijob-mixed": legacy("mpijob", {"launcher": {"container": {"command": ["a"]}},
                                      "worker": {"replicas": 2, "container": {"command": ["b"]}}}),
    "no-component": {"kind": "operation", "name": "x"},
    "hub-ref": {"kind": "operation", "hubRef": "org/comp:1"},
    "dag": {"kind": "operation", "component": {"kind": "component", "run": {
        "kind": "dag", "operations": [{"name": "a", "params": {"x": "{{ params.y }}"}}]}}},
}


REFUSED = {"bad-param-type", "missing-required", "unknown-reference", "str-in-int-field",
           "mesh-mismatch", "mesh-indivisible", "mesh-multislice-data", "gpu-rejected",
           "tfjob-ps", "mpijob-mixed", "no-component", "hub-ref"}


@pytest.mark.parametrize("name", list(CASES))
def test_compile_matches_the_reference(name):
    ours, ref = _compile_both(CASES[name])
    assert ours == ref, name
    assert (ours == "CompilationError") == (name in REFUSED), ours


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_compile_like_the_reference(path):
    ours_op, ref_op = read_polyaxonfile(path), jax_read(path)
    ours, ref = _compile_both((ours_op, ref_op))
    assert ours == ref and ours != "CompilationError"
    if ours_op.matrix is not None:  # one trial of the sweep, as the tuner fans it out
        suggestion = {"lr": 0.003, "batch_size": 256}
        ours, ref = _compile_both((apply_suggestion(ours_op, suggestion),
                                   jax_apply_suggestion(ref_op, suggestion)))
        assert ours == ref
        assert not has_template(json.loads(ours[0])["component"])


def test_path_ref_and_presets(tmp_path, monkeypatch):
    comp = tmp_path / "comp.yaml"
    comp.write_text("kind: component\nname: c\ninputs: [{name: n, type: int, value: 2}]\n"
                    "run: {kind: job, container: {command: [echo, '{{ params.n }}']}}\n")
    home = tmp_path / "home"
    (home / "presets").mkdir(parents=True)
    (home / "presets" / "fast.yaml").write_text(
        "isPreset: true\nkind: operation\ntermination: {maxRetries: 2}\nqueue: gpu\n")
    (home / "presets" / "bad.yaml").write_text("termination: [unclosed\n")
    monkeypatch.setenv("POLYAXON_HOME", str(home))
    for doc in ({"kind": "operation", "pathRef": str(comp), "params": {"n": 5}},
                {"kind": "operation", "pathRef": "comp.yaml"},
                {"kind": "operation", "pathRef": str(comp), "presets": ["fast"]},
                {"kind": "operation", "pathRef": str(comp), "presets": ["missing"]},
                {"kind": "operation", "pathRef": str(comp), "presets": ["bad"]},
                {"kind": "operation", "pathRef": str(tmp_path / "nope.yaml")}):
        ours, ref = _compile_both(doc, base_dir=str(tmp_path))
        assert ours == ref, doc


def test_interpolation_errors_match():
    ctx = {"params": {"lr": 0.01, "xs": [1, 2]}, "globals": {"uuid": "abc"}}
    for s in ("{{ params.lr }}", "a-{{ globals.uuid }}", "{{ params.xs.1 }}",
              "{{ params.xs.5 }}", "{{ params.missing }}", "{{ globals.uuid.real }}"):
        outcomes = []
        for fn, err in ((interpolate_str, CompilationError),
                        (jax_interpolate_str, JaxCompilationError)):
            try:
                outcomes.append(repr(fn(s, ctx)))
            except err as e:
                outcomes.append(f"error: {e}")
        assert outcomes[0] == outcomes[1], s
