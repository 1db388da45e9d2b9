"""Run kinds: what a component executes. An own copy of
`polyaxon_tpu/schemas/run_kinds.py` on the port's dataclass specs:

- `V1Program` and its parts (model, data, optimizer, train): what
  `runtime/trainer.py` runs;
- `V1ServingSpec` (with `V1TenantSpec` and `V1PoolsSpec`) and
  `V1ObservabilitySpec` (with `V1SLOSpec`, `V1HistorySpec` and
  `V1RegressionRuleSpec`): what `ModelServer.from_run` serves a run with;
- the kinds: `V1JAXJob` (a `program:` the framework runs, or a
  container), `V1Job`, `V1Service`, the legacy Kubeflow kinds the
  compiler folds into a jaxjob, `V1TunerJob` and `V1Dag`.

Scalar fields typed `int | str` keep a `{{ params.x }}` template as a
string until the compiler interpolates it; a rule on such a value checks
it only once it is concrete, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Annotated, Any, Literal, Optional, Union

from .base import Spec, Tagged, to_camel
from .environment import V1Environment


def _isnum(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _isint(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


@dataclasses.dataclass
class V1Container(Spec):
    """The container subset the local runner understands."""

    name: Optional[str] = None
    image: Optional[str] = None
    command: Optional[list[str]] = None
    args: Optional[list[str]] = None
    env: Optional[dict[str, str] | list[dict[str, Any]]] = None
    working_dir: Optional[str] = None
    resources: Optional[dict] = None
    volume_mounts: Optional[list[dict]] = None


@dataclasses.dataclass
class V1Init(Spec):
    """Init-time provisioning of the run's context directory."""

    artifacts: Optional[dict] = None
    git: Optional[dict] = None
    dockerfile: Optional[dict] = None
    file: Optional[dict] = None
    connection: Optional[str] = None
    container: Optional[V1Container] = None
    paths: Optional[list[str]] = None


# ------------------------------------------------------------------ program
@dataclasses.dataclass
class V1ModelSpec(Spec):
    """A model from the registry (`models/registry.py`)."""

    name: str
    config: Optional[dict[str, Any]] = None


@dataclasses.dataclass
class V1DataSpec(Spec):
    name: str = "synthetic"
    batch_size: Union[int, str] = 32
    config: Optional[dict[str, Any]] = None


@dataclasses.dataclass
class V1OptimizerSpec(Spec):
    name: str = "adamw"
    learning_rate: Union[float, str] = 1e-3
    config: Optional[dict[str, Any]] = None
    schedule: Optional[dict[str, Any]] = None


@dataclasses.dataclass
class V1TrainSpec(Spec):
    steps: Union[int, str] = 100
    eval_every: Optional[Union[int, str]] = None
    eval_steps: Optional[Union[int, str]] = None
    # profiler capture window [start_step, end_step)
    profile_start: Optional[Union[int, str]] = None
    profile_stop: Optional[Union[int, str]] = None
    log_every: Union[int, str] = 10
    checkpoint_every: Optional[Union[int, str]] = None
    checkpoint_keep: Optional[Union[int, str]] = None
    checkpoint_local_dir: Optional[str] = None
    resume: Optional[bool] = None
    seed: Union[int, str] = 0
    precision: Literal["bfloat16", "float32", "mixed"] = "mixed"
    remat: Optional[bool] = None
    remat_policy: Optional[Literal["nothing", "dots", "dots_no_batch"]] = None
    donate_state: bool = True
    loss: Optional[str] = None
    grad_accum: Optional[Union[int, str]] = None

    def __post_init__(self):
        if _isint(self.checkpoint_keep) and self.checkpoint_keep < 1:
            raise ValueError(
                f"checkpointKeep must be >= 1, got {self.checkpoint_keep} "
                "(retention counts checkpoints, 0 would silently fall back "
                "to the default)"
            )


# ------------------------------------------------------------------ serving
@dataclasses.dataclass
class V1TenantSpec(Spec):
    """One serving tenant's admission contract: caps on outstanding
    requests and tokens, a weighted fair share, and optionally the LoRA
    adapter its rows decode with."""

    name: str
    max_outstanding: Optional[Union[int, str]] = None
    max_tokens: Optional[Union[int, str]] = None
    weight: float | str = 1.0
    adapter: Optional[str] = None

    def __post_init__(self):
        if not self.name.strip():
            raise ValueError("tenant name must be non-empty")
        for field in ("max_outstanding", "max_tokens"):
            v = getattr(self, field)
            if _isint(v) and v < 0:
                raise ValueError(
                    f"tenant {self.name!r}: {to_camel(field)} must be >= 0, got {v}"
                )
        if _isnum(self.weight) and self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0, got {self.weight}")


@dataclasses.dataclass
class V1PoolsSpec(Spec):
    """Disaggregated prefill/decode replica pools."""

    prefill: Union[int, str] = 1
    decode: Union[int, str] = 1

    def __post_init__(self):
        for field in ("prefill", "decode"):
            v = getattr(self, field)
            if _isint(v) and v < 0:
                raise ValueError(f"pools.{field} must be >= 0, got {v}")
        if _isint(self.prefill) and _isint(self.decode) and self.prefill + self.decode < 1:
            raise ValueError("pools needs at least one replica across prefill + decode")


@dataclasses.dataclass
class V1ServingSpec(Spec):
    """Serving knobs (`serving/batching.py::ServingConfig`) a run pins in
    its spec, so serving the run comes up with the shape it was validated
    at. An explicit config or `config_overrides` layer over it."""

    max_batch: Union[int, str] = 8
    max_wait_ms: float | str = 5.0
    batching: bool = True
    prompt_buckets: Optional[list[int]] = None
    max_new_buckets: Optional[list[int]] = None
    request_timeout_s: float | str = 600.0
    max_queue: Union[int, str] = 64
    default_deadline_ms: Optional[float | str] = None
    drain_grace_s: float | str = 5.0
    breaker_threshold: Union[int, str] = 5
    kv_page_tokens: Union[int, str] = 128
    kv_pool_pages: Optional[Union[int, str]] = None
    prefix_cache: bool = True
    stream: bool = True
    stream_chunk_tokens: Union[int, str] = 8
    speculate: bool = False
    draft_tokens: Union[int, str] = 4
    quantize: bool = False
    draft_model: Optional[dict[str, int | str | float | bool]] = None
    adaptive_draft: bool = False
    kv_quant: Literal["none", "int8"] = "none"
    chunked_prefill: bool = False
    prefill_chunk_tokens: Union[int, str] = 64
    max_step_tokens: Union[int, str] = 256
    replicas: Union[int, str] = 1
    mesh_axes: Optional[dict[str, Union[int, str]]] = None
    prefix_affinity: bool = True
    spill_ram_bytes: Optional[Union[int, str]] = None
    spill_dir: Optional[str] = None
    spill_dir_bytes: Optional[Union[int, str]] = None
    adapters: Optional[dict[str, str]] = None
    tenants: Optional[list[V1TenantSpec]] = None
    adapter_slots: Union[int, str] = 0
    pools: Optional[V1PoolsSpec] = None

    _MESH_AXES_ALLOWED = ("batch", "model", "data", "fsdp")

    def __post_init__(self):  # noqa: C901 — the reference's rules, in order
        if _isint(self.replicas) and self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.mesh_axes is not None:
            if not self.mesh_axes:
                raise ValueError("meshAxes must be a non-empty mapping")
            fills = 0
            for ax, n in self.mesh_axes.items():
                if ax not in self._MESH_AXES_ALLOWED:
                    raise ValueError(
                        f"meshAxes axis {ax!r}: serving meshes are "
                        f"`batch`×`model` (legacy data/fsdp fold into "
                        f"batch); got axes {sorted(self.mesh_axes)}"
                    )
                if _isint(n):
                    if n == -1:
                        fills += 1
                    elif n < 1:
                        raise ValueError(
                            f"meshAxes[{ax!r}] must be >= 1 or -1 (fill), got {n}"
                        )
            if fills > 1:
                raise ValueError("meshAxes allows at most one -1 (fill) axis")
        if _isint(self.draft_tokens) and not 1 <= self.draft_tokens <= 16:
            raise ValueError(
                f"draftTokens must be in [1, 16] (the verify window is "
                f"draftTokens + 1 wide), got {self.draft_tokens}"
            )
        if _isint(self.max_batch) and self.max_batch < 1:
            raise ValueError(f"maxBatch must be >= 1, got {self.max_batch}")
        if _isint(self.kv_page_tokens) and self.kv_page_tokens < 1:
            raise ValueError(f"kvPageTokens must be >= 1, got {self.kv_page_tokens}")
        if _isint(self.kv_pool_pages) and self.kv_pool_pages < 2:
            raise ValueError(
                f"kvPoolPages must be >= 2 (1 scratch + data), got {self.kv_pool_pages}"
            )
        if _isint(self.stream_chunk_tokens) and self.stream_chunk_tokens < 1:
            raise ValueError(
                f"streamChunkTokens must be >= 1, got {self.stream_chunk_tokens}"
            )
        if _isint(self.max_queue) and self.max_queue < 1:
            raise ValueError(f"maxQueue must be >= 1, got {self.max_queue}")
        if _isint(self.prefill_chunk_tokens) and self.prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefillChunkTokens must be >= 1, got {self.prefill_chunk_tokens}"
            )
        if _isint(self.max_step_tokens) and self.max_step_tokens < 1:
            raise ValueError(f"maxStepTokens must be >= 1, got {self.max_step_tokens}")
        if self.chunked_prefill and self.kv_pool_pages is None:
            raise ValueError(
                "chunkedPrefill requires the paged KV pool — set "
                "kvPoolPages (page tables are what let a half-prefilled "
                "row persist across device steps)"
            )
        if self.kv_quant != "none" and self.kv_pool_pages is None:
            raise ValueError(
                "kvQuant requires the paged KV pool — set kvPoolPages "
                "(dense per-group caches stay full-precision)"
            )
        for name in ("spill_ram_bytes", "spill_dir_bytes"):
            v = getattr(self, name)
            if _isint(v) and v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if (self.spill_ram_bytes or self.spill_dir) and (
            self.kv_pool_pages is None or not self.prefix_cache
        ):
            raise ValueError(
                "spillRamBytes/spillDir require the paged KV pool with "
                "the prefix cache — set kvPoolPages and keep prefixCache "
                "on (spill tiers hold evicted prefix-cache entries)"
            )
        if self.spill_dir_bytes is not None and not self.spill_dir:
            raise ValueError("spillDirBytes bounds the on-disk tier — set spillDir")
        if self.draft_model is not None and not self.speculate:
            raise ValueError(
                "draftModel requires speculate: true (the draft model is "
                "a proposer for the speculative verify window)"
            )
        if self.adaptive_draft and not self.speculate:
            raise ValueError(
                "adaptiveDraft requires speculate: true (the controller "
                "steers the speculative draft width K)"
            )
        if _isint(self.breaker_threshold) and self.breaker_threshold < 1:
            raise ValueError(f"breakerThreshold must be >= 1, got {self.breaker_threshold}")
        if _isnum(self.default_deadline_ms) and self.default_deadline_ms <= 0:
            raise ValueError(
                f"defaultDeadlineMs must be > 0, got {self.default_deadline_ms}"
            )
        if _isnum(self.drain_grace_s) and self.drain_grace_s < 0:
            raise ValueError(f"drainGraceS must be >= 0, got {self.drain_grace_s}")
        for name in ("prompt_buckets", "max_new_buckets"):
            ladder = getattr(self, name)
            if ladder is not None and (not ladder or any(b < 1 for b in ladder)):
                raise ValueError(f"{name} must be a non-empty list of positive ints")
        if self.adapters is not None:
            for name, src in self.adapters.items():
                if not str(name).strip() or not str(src).strip():
                    raise ValueError(
                        "adapters entries must map a non-empty name to a "
                        f"non-empty source, got {name!r}: {src!r}"
                    )
        if self.tenants:
            seen: set[str] = set()
            known = set(self.adapters or {})
            for t in self.tenants:
                if t.name in seen:
                    raise ValueError(f"duplicate tenant name {t.name!r}")
                seen.add(t.name)
                if t.adapter and t.adapter not in known:
                    raise ValueError(
                        f"tenant {t.name!r} binds adapter {t.adapter!r} "
                        f"which is not in adapters "
                        f"({sorted(known) or 'none declared'})"
                    )
        if _isint(self.adapter_slots) and self.adapter_slots < 0:
            raise ValueError(
                f"adapterSlots must be >= 0 (0 = one slot per adapter), "
                f"got {self.adapter_slots}"
            )
        if self.pools is not None:
            has_prefill = not (_isint(self.pools.prefill) and self.pools.prefill == 0)
            if has_prefill and (
                not self.chunked_prefill or self.kv_pool_pages is None or not self.prefix_cache
            ):
                raise ValueError(
                    "pools with a prefill pool requires chunkedPrefill + "
                    "kvPoolPages + prefixCache: the handoff ships the "
                    "page-aligned prefix-cache chain a chunked prefill "
                    "leaves behind"
                )

    def to_config(self):
        """The `ServingConfig` these knobs pin (a mesh is refused there by
        name: meshes are not ported)."""
        from ..serving.batching import ServingConfig, normalize_draft_model, normalize_mesh_axes
        from ..serving.tenancy import normalize_adapters, normalize_tenants

        def opt(conv, v):
            return conv(v) if v is not None else None

        return ServingConfig(
            max_batch=int(self.max_batch),
            max_wait_ms=float(self.max_wait_ms),
            batching=self.batching,
            prompt_buckets=tuple(self.prompt_buckets) if self.prompt_buckets else None,
            max_new_buckets=tuple(self.max_new_buckets) if self.max_new_buckets else None,
            request_timeout_s=float(self.request_timeout_s),
            max_queue=int(self.max_queue),
            default_deadline_ms=opt(float, self.default_deadline_ms),
            drain_grace_s=float(self.drain_grace_s),
            breaker_threshold=int(self.breaker_threshold),
            kv_page_tokens=int(self.kv_page_tokens),
            kv_pool_pages=opt(int, self.kv_pool_pages),
            prefix_cache=self.prefix_cache,
            stream=self.stream,
            stream_chunk_tokens=int(self.stream_chunk_tokens),
            speculate=self.speculate,
            draft_tokens=int(self.draft_tokens),
            quantize=self.quantize,
            draft_model=normalize_draft_model(self.draft_model),
            adaptive_draft=self.adaptive_draft,
            kv_quant=str(self.kv_quant),
            chunked_prefill=self.chunked_prefill,
            prefill_chunk_tokens=int(self.prefill_chunk_tokens),
            max_step_tokens=int(self.max_step_tokens),
            spill_ram_bytes=opt(int, self.spill_ram_bytes),
            spill_dir=self.spill_dir,
            spill_dir_bytes=opt(int, self.spill_dir_bytes),
            mesh_axes=normalize_mesh_axes(
                {ax: int(n) for ax, n in self.mesh_axes.items()}
                if self.mesh_axes is not None else None
            ),
            adapters=normalize_adapters(self.adapters or {}),
            tenants=normalize_tenants([
                {
                    "name": t.name,
                    "max_outstanding": opt(int, t.max_outstanding),
                    "max_tokens": opt(int, t.max_tokens),
                    "weight": float(t.weight),
                    "adapter": t.adapter or "",
                }
                for t in (self.tenants or [])
            ]),
            adapter_slots=int(self.adapter_slots),
        )

    def chips_needed(self) -> Optional[int]:
        """Per-replica chips implied by meshAxes (None when no mesh is
        pinned, a size is a template, or an axis fills)."""
        if not self.mesh_axes:
            return None
        sizes = list(self.mesh_axes.values())
        if any(not _isint(n) for n in sizes) or -1 in sizes:
            return None
        return math.prod(sizes)


# ------------------------------------------------------------ observability
@dataclasses.dataclass
class V1SLOSpec(Spec):
    """One service-level objective for the serving SLO engine
    (`telemetry/slo.py`), evaluated as multi-window burn rates."""

    name: str
    kind: Literal["availability", "latency"] = "availability"
    objective: float | str = 0.999
    threshold_ms: Optional[float | str] = None
    windows: Optional[list[float]] = None
    burn_threshold: float | str = 1.0

    def __post_init__(self):
        if _isnum(self.objective) and not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"slo {self.name!r}: objective must be in (0, 1), got {self.objective}"
            )
        if self.kind == "latency":
            if self.threshold_ms is None:
                raise ValueError(f"slo {self.name!r}: latency kind requires thresholdMs")
            if _isnum(self.threshold_ms) and self.threshold_ms <= 0:
                raise ValueError(
                    f"slo {self.name!r}: thresholdMs must be > 0, got {self.threshold_ms}"
                )
        elif self.threshold_ms is not None:
            raise ValueError(f"slo {self.name!r}: thresholdMs only applies to kind=latency")
        w = self.windows
        if w is not None and (not w or any(x <= 0 for x in w) or sorted(set(w)) != list(w)):
            raise ValueError(
                f"slo {self.name!r}: windows must be a strictly ascending "
                f"list of positive seconds, got {w}"
            )
        if _isnum(self.burn_threshold) and self.burn_threshold <= 0:
            raise ValueError(
                f"slo {self.name!r}: burnThreshold must be > 0, got {self.burn_threshold}"
            )

    def to_config(self) -> dict:
        """The normalized dict `telemetry.slo.build_objectives` consumes."""
        out = {
            "name": self.name,
            "kind": self.kind,
            "objective": float(self.objective),
            "burn_threshold": float(self.burn_threshold),
        }
        if self.windows is not None:
            out["windows"] = [float(w) for w in self.windows]
        if self.threshold_ms is not None:
            out["threshold_ms"] = float(self.threshold_ms)
        return out


@dataclasses.dataclass
class V1HistorySpec(Spec):
    """Metrics-history knobs (`telemetry/history.py`): the serving layer
    samples its registry under `<outputs>/telemetry/history/` and answers
    `/queryz` over it."""

    enabled: bool = True
    interval_s: float | str = 1.0
    max_bytes: Optional[Union[int, str]] = None
    segment_bytes: Optional[Union[int, str]] = None

    def __post_init__(self):
        if _isnum(self.interval_s) and self.interval_s <= 0:
            raise ValueError(f"history.intervalS must be > 0, got {self.interval_s}")
        for field in ("max_bytes", "segment_bytes"):
            v = getattr(self, field)
            if _isint(v) and v <= 0:
                raise ValueError(f"history.{to_camel(field)} must be > 0, got {v}")

    def to_config(self, history_dir: str) -> dict:
        """The dict `ModelServer(history=)` consumes; the directory is the
        caller's (it knows the run's outputs)."""
        out = {"dir": history_dir, "interval_s": float(self.interval_s)}
        if self.max_bytes is not None:
            out["max_bytes"] = int(self.max_bytes)
        if self.segment_bytes is not None:
            out["segment_bytes"] = int(self.segment_bytes)
        return out


@dataclasses.dataclass(kw_only=True)
class V1RegressionRuleSpec(Spec):
    """One perf-regression rule of the sentinel (`telemetry/detect.py`)
    over metrics-history windows."""

    name: str
    series: str
    kind: Literal["ceiling", "window_ratio", "ewma_drift"] = "ceiling"
    agg: Literal["avg", "min", "max", "rate", "p50", "p95", "p99"] = "avg"
    window_s: float | str = 60.0
    threshold: float | str
    direction: Literal["above", "below"] = "above"
    alpha: float | str = 0.3
    lookback_windows: Union[int, str] = 5
    min_samples: Union[int, str] = 3

    def __post_init__(self):
        owner = f"rule {self.name!r}"
        if _isnum(self.window_s) and self.window_s <= 0:
            raise ValueError(f"{owner}: windowS must be > 0, got {self.window_s}")
        if _isnum(self.alpha) and not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"{owner}: alpha must be in (0, 1], got {self.alpha}")

    def to_config(self) -> dict:
        """The normalized dict `telemetry.detect.build_rules` consumes."""
        return {
            "name": self.name,
            "series": self.series,
            "kind": self.kind,
            "agg": self.agg,
            "window_s": float(self.window_s),
            "threshold": float(self.threshold),
            "direction": self.direction,
            "alpha": float(self.alpha),
            "lookback_windows": int(self.lookback_windows),
            "min_samples": int(self.min_samples),
        }


@dataclasses.dataclass
class V1ObservabilitySpec(Spec):
    """Telemetry knobs a run pins in its spec: the trainer's histogram
    buckets and span tracing, and what serving the run arms (SLOs, the
    metrics history and its regression rules)."""

    sample_interval: float | str = 10.0
    histogram_buckets: Optional[list[float]] = None
    trace: bool = True
    slos: Optional[list[V1SLOSpec]] = None
    history: Optional[V1HistorySpec] = None
    # a rule list, or "default" for the serving drift pack
    regression_rules: Optional[Union[list[V1RegressionRuleSpec], str]] = None


    def __post_init__(self):
        if _isnum(self.sample_interval) and self.sample_interval <= 0:
            raise ValueError(f"sampleInterval must be > 0, got {self.sample_interval}")
        b = self.histogram_buckets
        if b is not None and (not b or any(x <= 0 for x in b) or sorted(set(b)) != list(b)):
            raise ValueError(
                "histogramBuckets must be a strictly ascending list of "
                f"positive numbers, got {b}"
            )
        if isinstance(self.regression_rules, str) and self.regression_rules != "default":
            raise ValueError(
                "regressionRules must be a rule list or the string "
                f"'default', got {self.regression_rules!r}"
            )
        if self.regression_rules is not None and (
            self.history is None or not self.history.enabled
        ):
            raise ValueError(
                "regressionRules require observability.history (the "
                "sentinel evaluates rules over the history store)"
            )
        if isinstance(self.regression_rules, list):
            names = [r.name for r in self.regression_rules]
            if len(names) != len(set(names)):
                raise ValueError(f"duplicate regression rule names in {names}")

    def rules_config(self) -> Optional[list[dict]]:
        """The normalized rule dicts `telemetry.detect.build_rules`
        consumes; "default" resolves to the serving drift pack."""
        if self.regression_rules is None:
            return None
        if isinstance(self.regression_rules, str):
            from ..telemetry.detect import DEFAULT_SERVING_RULES

            return [dict(r) for r in DEFAULT_SERVING_RULES]
        return [r.to_config() for r in self.regression_rules]


@dataclasses.dataclass
class V1Program(Spec):
    """A native training program: what `runtime/trainer.py` runs, and what
    `ModelServer.from_run` serves once it has trained."""

    model: V1ModelSpec
    data: Optional[V1DataSpec] = None
    optimizer: Optional[V1OptimizerSpec] = None
    train: Optional[V1TrainSpec] = None
    serving: Optional[V1ServingSpec] = None
    observability: Optional[V1ObservabilitySpec] = None



# ------------------------------------------------------------------ run kind
@dataclasses.dataclass
class V1MeshSpec(Spec):
    """Logical mesh axes → sizes; -1 fills with the remaining devices (at
    most one axis)."""

    data: Optional[int] = None
    fsdp: Optional[int] = None
    model: Optional[int] = None
    pipeline: Optional[int] = None
    context: Optional[int] = None
    expert: Optional[int] = None

    def axis_sizes(self) -> dict[str, int]:
        out = {}
        for ax in ("data", "fsdp", "model", "pipeline", "context", "expert"):
            v = getattr(self, ax)
            if v is not None:
                out[ax] = v
        return out

    def __post_init__(self):
        sizes = self.axis_sizes()
        if sum(1 for v in sizes.values() if v == -1) > 1:
            raise ValueError("at most one mesh axis may be -1 (auto-fill)")
        for ax, v in sizes.items():
            if v == 0 or v < -1:
                raise ValueError(f"mesh axis {ax!r} has invalid size {v}")


# ------------------------------------------------------------------ run kinds
@dataclasses.dataclass
class V1Job(Spec):
    kind: Literal["job"] = "job"
    container: Optional[V1Container] = None
    init: Optional[list[V1Init]] = None
    sidecars: Optional[list[V1Container]] = None
    environment: Optional[V1Environment] = None
    connections: Optional[list[str]] = None
    volumes: Optional[list[dict]] = None


@dataclasses.dataclass
class V1Service(Spec):
    kind: Literal["service"] = "service"
    container: Optional[V1Container] = None
    init: Optional[list[V1Init]] = None
    sidecars: Optional[list[V1Container]] = None
    environment: Optional[V1Environment] = None
    connections: Optional[list[str]] = None
    volumes: Optional[list[dict]] = None
    ports: Optional[list[int]] = None
    rewrite_path: Optional[bool] = None
    is_external: Optional[bool] = None
    replicas: Optional[int] = None

    @classmethod
    def _check_replicas(cls, v):
        if v is not None and v < 1:
            raise ValueError("Input should be greater than or equal to 1")
        return v


def _at_least_one(v):
    if v < 1:
        raise ValueError("Input should be greater than or equal to 1")
    return v


@dataclasses.dataclass
class V1JAXJob(Spec):
    """The native training job: a `program` the framework runs itself, or
    a `container` command run as a local process. `replicas` counts host
    processes (one on one card; a gang is not ported)."""

    kind: Literal["jaxjob"] = "jaxjob"
    replicas: int = 1
    mesh: Optional[V1MeshSpec] = None
    program: Optional[V1Program] = None
    container: Optional[V1Container] = None
    init: Optional[list[V1Init]] = None
    sidecars: Optional[list[V1Container]] = None
    environment: Optional[V1Environment] = None
    connections: Optional[list[str]] = None
    volumes: Optional[list[dict]] = None
    coordinator_port: int = 8476

    _check_replicas = staticmethod(_at_least_one)

    def __post_init__(self):
        if self.program is None and self.container is None:
            raise ValueError("jaxjob needs `program` (native) or `container`")
        # a pinned decode mesh larger than the run's own chip request can
        # never come up: refused at parse time
        serving = self.program.serving if self.program is not None else None
        res = self.environment.resources if self.environment is not None else None
        if serving is not None and res is not None:
            need = serving.chips_needed()
            have = res.tpu.total_chips if res.tpu is not None else res.chips
            if need is not None and have is not None and need > have:
                raise ValueError(
                    f"serving.meshAxes {serving.mesh_axes} needs {need} "
                    f"chips per replica, but resources request only {have}"
                )


@dataclasses.dataclass
class V1KFReplica(Spec):
    """Replica group of the legacy Kubeflow-style kinds."""

    replicas: int = 1
    container: Optional[V1Container] = None
    init: Optional[list[V1Init]] = None
    sidecars: Optional[list[V1Container]] = None
    environment: Optional[V1Environment] = None
    connections: Optional[list[str]] = None

    _check_replicas = staticmethod(_at_least_one)


@dataclasses.dataclass
class V1TFJob(Spec):
    kind: Literal["tfjob"] = "tfjob"
    chief: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    ps: Optional[V1KFReplica] = None
    evaluator: Optional[V1KFReplica] = None
    clean_pod_policy: Optional[str] = None
    mesh: Optional[V1MeshSpec] = None
    program: Optional[V1Program] = None


@dataclasses.dataclass
class V1PyTorchJob(Spec):
    kind: Literal["pytorchjob"] = "pytorchjob"
    master: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    clean_pod_policy: Optional[str] = None
    mesh: Optional[V1MeshSpec] = None
    program: Optional[V1Program] = None


@dataclasses.dataclass
class V1MPIJob(Spec):
    kind: Literal["mpijob"] = "mpijob"
    launcher: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    slots_per_worker: Optional[int] = None
    clean_pod_policy: Optional[str] = None
    mesh: Optional[V1MeshSpec] = None
    program: Optional[V1Program] = None


@dataclasses.dataclass
class V1XGBoostJob(Spec):
    kind: Literal["xgboostjob"] = "xgboostjob"
    master: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    clean_pod_policy: Optional[str] = None
    mesh: Optional[V1MeshSpec] = None
    program: Optional[V1Program] = None


@dataclasses.dataclass
class V1PaddleJob(Spec):
    kind: Literal["paddlejob"] = "paddlejob"
    master: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    clean_pod_policy: Optional[str] = None
    mesh: Optional[V1MeshSpec] = None
    program: Optional[V1Program] = None


@dataclasses.dataclass
class V1DaskJob(Spec):
    kind: Literal["daskjob"] = "daskjob"
    job: Optional[V1KFReplica] = None
    scheduler: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    mesh: Optional[V1MeshSpec] = None
    program: Optional[V1Program] = None


@dataclasses.dataclass
class V1RayJob(Spec):
    kind: Literal["rayjob"] = "rayjob"
    head: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    entrypoint: Optional[str] = None
    ray_version: Optional[str] = None
    mesh: Optional[V1MeshSpec] = None
    program: Optional[V1Program] = None


@dataclasses.dataclass
class V1TunerJob(Spec):
    """Auxiliary tuner job driving a matrix sweep."""

    kind: Literal["tuner"] = "tuner"
    container: Optional[V1Container] = None
    environment: Optional[V1Environment] = None


@dataclasses.dataclass(kw_only=True)
class V1OperationRef(Spec):
    """An operation inside a DAG: an inline component or a path ref, with
    its dependencies."""

    name: str
    dag_ref: Optional[str] = None
    path_ref: Optional[str] = None
    hub_ref: Optional[str] = None
    component: Optional[dict] = None  # validated when the child compiles
    params: Optional[dict[str, Any]] = None
    matrix: Optional[dict[str, Any]] = None
    depends_on: Optional[list[str]] = None
    trigger: Optional[str] = None
    conditions: Optional[str] = None


@dataclasses.dataclass
class V1Dag(Spec):
    kind: Literal["dag"] = "dag"
    operations: list[V1OperationRef] = dataclasses.field(default_factory=list)
    concurrency: Optional[int] = None
    early_stopping: Optional[list[dict]] = None
    environment: Optional[V1Environment] = None


V1RunKind = Union[
    V1Job, V1Service, V1JAXJob, V1TFJob, V1PyTorchJob, V1MPIJob, V1XGBoostJob,
    V1PaddleJob, V1DaskJob, V1RayJob, V1TunerJob, V1Dag,
]

# the union as a field: the member is picked by `kind`
V1RunKindField = Annotated[V1RunKind, Tagged("kind")]

RUN_KINDS: dict[str, type] = {
    "job": V1Job, "service": V1Service, "jaxjob": V1JAXJob, "tfjob": V1TFJob,
    "pytorchjob": V1PyTorchJob, "mpijob": V1MPIJob, "xgboostjob": V1XGBoostJob,
    "paddlejob": V1PaddleJob, "daskjob": V1DaskJob, "rayjob": V1RayJob,
    "tuner": V1TunerJob, "dag": V1Dag,
}


def run_num_slices(run) -> int:
    """Slice count of a run's `tpu:` block (1 when absent)."""
    env = getattr(run, "environment", None)
    tpu = env.resources.tpu if env and env.resources else None
    return tpu.num_slices if tpu is not None else 1


def parse_run(data: dict) -> V1RunKind:
    kind = data.get("kind")
    if kind not in RUN_KINDS:
        raise ValueError(f"unknown run kind {kind!r}; one of {sorted(RUN_KINDS)}")
    return RUN_KINDS[kind].from_dict(data)
