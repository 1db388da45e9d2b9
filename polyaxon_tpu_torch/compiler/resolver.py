"""The compiler: V1Operation → CompiledOperation ready for execution, an
own copy of `polyaxon_tpu/compiler/resolver.py`.

  1. resolve the component (inline or pathRef);
  2. merge op-level patches (runPatch, environment, termination);
  3. normalize legacy distributed kinds (tfjob/pytorchjob/mpijob) → jaxjob;
  4. resolve params against component inputs (typed);
  5. interpolate `{{ }}` templates with params+globals context;
  6. validate the mesh against the tpu slice (resolve -1 auto-fill axes).

The result is fully concrete: no templates, a jaxjob/job/service/dag run with
typed numeric fields, and a mesh whose axis product equals the chip count.
"""

from __future__ import annotations

import copy
import uuid as _uuid
from pathlib import Path
from typing import Any, Optional

from ..schemas import (
    V1Component,
    V1JAXJob,
    V1MeshSpec,
    V1Operation,
    V1Param,
)
from .contexts import build_context, build_globals, resolve_params
from .interpolation import CompilationError, interpolate

__all__ = ["CompilationError", "CompiledOperation", "compile_operation", "apply_suggestion"]


class CompiledOperation:
    """A concrete, executable operation."""

    def __init__(
        self,
        *,
        run_uuid: str,
        name: str,
        project: str,
        component: V1Component,
        params: dict[str, Any],
        contexts: dict[str, Any],
        operation: V1Operation,
    ):
        self.run_uuid = run_uuid
        self.name = name
        self.project = project
        self.component = component
        self.params = params
        self.contexts = contexts
        self.operation = operation

    @property
    def run(self):
        return self.component.run

    def to_dict(self) -> dict[str, Any]:
        return {
            "runUuid": self.run_uuid,
            "name": self.name,
            "project": self.project,
            "params": self.params,
            "component": self.component.to_dict(),
            # op-level routing/labels survive into the stored spec so
            # restart/resume/copy clones inherit them
            "queue": self.operation.queue,
            "tags": self.operation.tags,
            # the RAW (pre-interpolation) operation — matrix included:
            # clones must rebuild from this, not from the resolved
            # component above, where templates like "{{ params.lr }}" are
            # already frozen and a cloned sweep could never vary its
            # params again
            "operation": self.operation.to_dict(),
        }


def _deep_merge(base: dict, patch: dict, strategy: str = "post_merge") -> dict:
    """post_merge: patch wins; pre_merge: base wins; replace: patch replaces;
    isnull: patch only fills keys base lacks (same as pre_merge for dicts)."""
    if strategy == "replace":
        return copy.deepcopy(patch)
    out = copy.deepcopy(base)
    for k, v in patch.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v, strategy)
        elif k in out and strategy in ("pre_merge", "isnull") and out[k] is not None:
            continue
        else:
            out[k] = copy.deepcopy(v)
    return out


def _resolve_component(op: V1Operation, base_dir: Optional[str]) -> V1Component:
    if op.component is not None:
        return op.component
    if op.path_ref:
        path = Path(op.path_ref)
        if not path.is_absolute() and base_dir:
            path = Path(base_dir) / path
        from ..polyaxonfile.reader import PolyaxonfileError, _load_docs, _validate_doc

        try:
            docs = _load_docs(path)
            spec = _validate_doc(docs[0], str(path))
        except PolyaxonfileError as e:
            raise CompilationError(f"pathRef {op.path_ref!r}: {e}") from e
        if isinstance(spec, V1Operation):
            if spec.component is None:
                raise CompilationError(f"pathRef {op.path_ref}: nested refs unsupported")
            return spec.component
        return spec
    if op.hub_ref:
        raise CompilationError(
            f"hubRef {op.hub_ref!r} cannot be resolved: no component hub configured "
            "(set a local hub dir or inline the component)"
        )
    raise CompilationError("operation has no component/pathRef to resolve")


def _normalize_legacy_kind(component: V1Component) -> V1Component:
    """tfjob/pytorchjob/mpijob/... → jaxjob: the replica groups' counts add
    up to the job's replicas, the first group with a container gives its
    pod config."""
    run = component.run
    replica_group_map = {
        "tfjob": ("chief", "worker", "evaluator"),  # ps unsupported on TPU
        "pytorchjob": ("master", "worker"),
        "mpijob": ("launcher", "worker"),
        "xgboostjob": ("master", "worker"),
        "paddlejob": ("master", "worker"),
        "daskjob": ("job", "scheduler", "worker"),
        "rayjob": ("head", "worker"),
    }
    if run.kind not in replica_group_map:
        return component
    replica_groups = replica_group_map[run.kind]
    if run.kind == "tfjob" and run.ps is not None:
        raise CompilationError(
            "tfjob with parameter servers cannot map to TPU SPMD; "
            "use pure data/model parallel replicas"
        )
    total = 0
    primary = None  # first replica group with a container: provides pod config
    containers = []
    for group in replica_groups:
        rep = getattr(run, group, None)
        if rep is None:
            continue
        total += rep.replicas
        if rep.container is not None:
            containers.append(rep.container)
        if primary is None and rep.container is not None:
            primary = rep
    if total == 0:
        raise CompilationError(f"{run.kind} has no replicas")
    # SPMD requires every process to run the same program: heterogeneous
    # replica containers can't map to a jaxjob
    if len({(tuple(c.command or []), tuple(c.args or []), c.image) for c in containers}) > 1:
        raise CompilationError(
            f"{run.kind} replica groups declare different containers; "
            "TPU SPMD requires identical programs across replicas"
        )
    jax_run = V1JAXJob(
        replicas=total,
        mesh=run.mesh or V1MeshSpec(data=-1),
        program=run.program,
        container=primary.container if primary else None,
        environment=primary.environment if primary else None,
        init=primary.init if primary else None,
        sidecars=primary.sidecars if primary else None,
        connections=primary.connections if primary else None,
    )
    return component.copy(run=jax_run)


def _finalize_program(component: V1Component) -> V1Component:
    """After interpolation, templated scalar fields (int|str unions) must be
    concrete numbers — a str param landing in `steps:` compiles otherwise and
    only crashes deep inside the trainer."""
    run = component.run
    if run.kind != "jaxjob" or run.program is None:
        return component
    prog = run.program.to_dict()
    numeric = [
        ("data", "batchSize", int),
        ("optimizer", "learningRate", float),
        ("train", "steps", int),
        ("train", "evalEvery", int),
        ("train", "evalSteps", int),
        ("train", "logEvery", int),
        ("train", "checkpointEvery", int),
        ("train", "seed", int),
    ]
    changed = False
    for section, field, typ in numeric:
        sec = prog.get(section)
        if not sec or field not in sec or sec[field] is None:
            continue
        val = sec[field]
        if isinstance(val, str):
            try:
                sec[field] = typ(float(val)) if typ is int else typ(val)
            except ValueError:
                raise CompilationError(
                    f"program.{section}.{field} must be {typ.__name__}, "
                    f"got {val!r} after interpolation"
                ) from None
            changed = True
    if not changed:
        return component
    from ..schemas.run_kinds import V1Program

    new_run = run.copy(program=V1Program.from_dict(prog))
    return component.copy(run=new_run)


def _validate_mesh(component: V1Component) -> V1Component:
    """Resolve -1 axes and check axis product == chip count (if tpu declared)."""
    run = component.run
    if run.kind != "jaxjob":
        return component
    if run.environment and run.environment.resources and run.environment.resources.gpu:
        raise CompilationError(
            "gpu resources are not supported on the TPU runtime; replace "
            "`resources.gpu` with a `resources.tpu: {type, topology}` block"
        )
    if run.mesh is None:
        return component
    sizes = run.mesh.axis_sizes()
    tpu = None
    if run.environment and run.environment.resources:
        tpu = run.environment.resources.tpu
    import math

    if tpu is None:
        # no slice declared: single host/local run; -1 axes resolve at runtime
        return component
    n_chips = tpu.total_chips  # all slices: the mesh spans the whole job
    fixed = math.prod(v for v in sizes.values() if v != -1) if sizes else 1
    if any(v == -1 for v in sizes.values()):
        if n_chips % fixed != 0:
            raise CompilationError(
                f"mesh axes {sizes} do not divide tpu slice of {n_chips} chips"
            )
        sizes = {k: (n_chips // fixed if v == -1 else v) for k, v in sizes.items()}
    elif sizes and fixed != n_chips:
        raise CompilationError(
            f"mesh axes {sizes} multiply to {fixed} but tpu slice has {n_chips} chips"
        )
    if tpu.num_slices > 1 and sizes.get("data", 1) % tpu.num_slices:
        # only the data axis spans DCN; every other axis must fit in a slice
        raise CompilationError(
            f"multi-slice job ({tpu.num_slices} slices) needs mesh data axis "
            f"divisible by the slice count, got data={sizes.get('data', 1)} "
            f"(mesh {sizes}); tensor/context/expert axes never cross DCN"
        )
    new_mesh = V1MeshSpec(**sizes)
    new_run = run.copy(mesh=new_mesh)
    return component.copy(run=new_run)


def compile_operation(
    op: V1Operation,
    *,
    run_uuid: Optional[str] = None,
    project: Optional[str] = None,
    artifacts_root: str = "/tmp/polyaxon_artifacts",
    base_dir: Optional[str] = None,
    iteration: Optional[int] = None,
) -> CompiledOperation:
    run_uuid = run_uuid or _uuid.uuid4().hex
    if op.presets:
        op = _apply_presets(op, base_dir)
    component = _resolve_component(op, base_dir)

    # op-level patches onto the component
    comp_dict = component.to_dict()
    strategy = op.patch_strategy or "post_merge"
    if op.run_patch:
        comp_dict["run"] = _deep_merge(comp_dict["run"], op.run_patch, strategy)
    if op.termination is not None:
        comp_dict["termination"] = _deep_merge(
            comp_dict.get("termination", {}), op.termination.to_dict(), strategy
        )
    try:
        component = V1Component.from_dict(comp_dict)
    except Exception as e:
        raise CompilationError(f"spec invalid after patches: {e}") from e
    component = _normalize_legacy_kind(component)
    # environment patch applies AFTER legacy normalization: legacy run kinds
    # carry environment per replica group, not at the top level
    if op.environment is not None:
        comp_dict = component.to_dict()
        comp_dict["run"]["environment"] = _deep_merge(
            comp_dict["run"].get("environment", {}),
            op.environment.to_dict(),
            strategy,
        )
        try:
            component = V1Component.from_dict(comp_dict)
        except Exception as e:
            raise CompilationError(f"environment patch invalid: {e}") from e

    params = resolve_params(op, component)
    globs = build_globals(
        run_uuid=run_uuid,
        run_name=op.name or component.name,
        project=project,
        artifacts_root=artifacts_root,
        iteration=iteration,
    )
    context = build_context(params, globs)

    comp_dict = component.to_dict()
    # DAG children carry their own templates ({{ params.x }}, {{ ops.y }});
    # they resolve when each child compiles — the parent must not touch them
    dag_ops = None
    if comp_dict.get("run", {}).get("kind") == "dag":
        dag_ops = comp_dict["run"].pop("operations", None)
    comp_dict = interpolate(comp_dict, context)
    if dag_ops is not None:
        comp_dict["run"]["operations"] = dag_ops
    try:
        component = V1Component.from_dict(comp_dict)
    except Exception as e:
        raise CompilationError(f"spec invalid after interpolation: {e}") from e
    component = _finalize_program(component)
    component = _validate_mesh(component)

    return CompiledOperation(
        run_uuid=run_uuid,
        name=op.name or component.name or run_uuid,
        project=project or "default",
        component=component,
        params=params,
        contexts=context,
        operation=op,
    )


def _preset_dirs(base_dir: Optional[str]) -> list[Path]:
    import os

    home = os.environ.get("POLYAXON_HOME")
    dirs = []
    if base_dir:
        dirs.append(Path(base_dir) / ".polyaxon" / "presets")
    if home:
        dirs.append(Path(home) / "presets")
    dirs.append(Path.home() / ".polyaxon" / "presets")
    return dirs


def _apply_presets(op: V1Operation, base_dir: Optional[str]) -> V1Operation:
    """Merge named preset operations (is_preset fragments stored as YAML in
    the presets dir) onto the op — op's own fields win (presets fill gaps;
    patch_strategy inside a preset can override that)."""
    from ..polyaxonfile import yaml_lite

    op_dict = op.to_dict()
    for name in op.presets or ():
        found = None
        for d in _preset_dirs(base_dir):
            for ext in (".yaml", ".yml", ".json"):
                p = d / f"{name}{ext}"
                if p.exists():
                    found = p
                    break
            if found:
                break
        if found is None:
            raise CompilationError(
                f"preset {name!r} not found in "
                f"{[str(d) for d in _preset_dirs(base_dir)]}"
            )
        try:
            preset = yaml_lite.safe_load(found.read_text()) or {}
        except yaml_lite.YAMLError as e:
            raise CompilationError(f"preset {name!r}: bad YAML: {e}") from e
        preset.pop("isPreset", None)
        preset.pop("is_preset", None)
        preset.pop("kind", None)
        preset.pop("version", None)
        strategy = preset.pop("patchStrategy", preset.pop("patch_strategy", "pre_merge"))
        op_dict = _deep_merge(op_dict, preset, strategy)
    try:
        return V1Operation.from_dict(op_dict)
    except Exception as e:
        raise CompilationError(f"operation invalid after presets: {e}") from e


def spec_fingerprint(compiled: "CompiledOperation") -> str:
    """Content hash of everything that determines a run's result — used by
    the cache layer (executor) to dedupe identical runs."""
    import hashlib
    import json

    payload = {
        "component": compiled.component.to_dict(),
        "params": compiled.params,
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def apply_suggestion(op: V1Operation, suggestion: dict[str, Any]) -> V1Operation:
    """Inject one tuner suggestion as concrete params (drops the matrix) —
    this is how Polytune fans a sweep out into child operations."""
    merged = dict(op.params or {})
    for k, v in suggestion.items():
        merged[k] = V1Param(value=v)
    return op.copy(params=merged, matrix=None)
