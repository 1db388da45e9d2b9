"""HTTP model server, counterpart of `polyaxon_tpu/serving/server.py::
ModelServer` for the flagship LM on one card.

    server = ModelServer(module, state_dict_or_jax_params, device="cuda")
    port = server.start("127.0.0.1", 0)
    # POST /generate {"tokens": [[...]], "maxNewTokens": 16}
    server.stop()

Endpoints:
  GET  /healthz  → {"status": "ok", "model": ..., "step": N}
  GET  /readyz   → 200 {"ready": true} while accepting, 503 while draining
  GET  /statsz   → occupancy, latency and TTFT percentiles, resilience
                   counters, the KV pool and the step scheduler (JSON)
  GET  /metricsz → Prometheus text, rendered from the same registry
  GET  /kvz      → the prefix-cache chain hashes this replica holds (and
                   its role)
  GET  /tracez   → ?id=<request id>: one request's trace; ?n=&sort=
                   recent|slowest|errors: the tail-sampled ring's summaries
  GET  /sloz     → the SLO engine's objectives, burn rates and breaches
  GET  /queryz   → ?series=&since=&until=&step=&agg=: windowed aggregates
                   over the metrics history (503 when history is off)
  POST /kv_import → adopt a prefill replica's exported page set (the
       handoff's CRC-framed segment bytes; X-Handoff-Id and
       X-Handoff-Epoch headers): 200 {"adopted_pages": n, "adopt_ms": the
       import's host ms}; 400 malformed bytes or a hash chain that does not
       match the tokens; 409 a stale epoch; 503 no pool headroom (reason
       kv_handoff)
  POST /generate → {"tokens": [[...]]}; body {"tokens": [[int]],
       "maxNewTokens", "temperature", "topK", "eosId", "seed",
       "deadlineMs", "numBeams" (beam search when > 1), "lengthPenalty",
       "tenant" (a configured tenant; absent = "default")}.
       400 validation; 503 + Retry-After shed (queue full,
       breaker open, expired at admission, KV pages exhausted, draining);
       504 deadline exceeded while queued.
  POST /generate?stream=1 → Server-Sent Events: {"row": i, "tokens": [...]}
       per decoded chunk (generated tokens only), then {"row": i, "done":
       true} per row, then {"done": true}. Incremental on the paged pool;
       otherwise each row arrives as one terminal chunk. A client that goes
       away mid-stream has its rows cancelled and their pages released.

Paths, chosen by `ServingConfig`:
  * `batching=False`: one request at a time, the exact shape, the scalar
    seed (`models.generate.generate`);
  * `batching=True` (the default): HTTP handler threads only produce; one
    decode worker coalesces same-`GroupKey` rows (prompts left-padded to
    a bucket ladder, per-row seeds seed + i) into one batched `generate`
    (`_execute_group`);
  * `kv_pool_pages`: the same groups through the paged pool with a
    content-addressed prefix cache (`_execute_group_paged`), streamed in
    `stream_chunk_tokens` chunks;
  * `chunked_prefill` on the paged pool: the continuous-batching step
    scheduler (`serving/steps.py`) over `_StepEngine`;
  * `numBeams > 1`: beam search (`models.generate.beam_search`) on the
    request's exact shape, synchronously, on every config.
Every row draws its samples from (its seed, its generation index), so all
batched paths give a row the same tokens. Device work runs on the decode
worker thread (or the caller's, for `generate`) under the server's lock.

Fast decode, on each batched path: `speculate` replaces the decode loop by
verify windows of `draft_tokens` drafts (`models/spec_decode.py`: n-gram
drafts, or a draft model by layer truncation with `draft_model`), which
commit the tokens plain decode would; `adaptive_draft` steers the window
width from the accept rate (`serving/adaptive.py`), down to plain decode.
`quantize` rebuilds the module with int8 projections at load
(`models.quant.quantize_module`; the caller's module is left as it is) and
`kv_quant="int8"` stores the paged pool as int8 payloads and f32 scales.

Multi-tenant serving: `adapters` (name → ".npz" path or "seed:<int>") and
`tenants` (TenantSpec dicts: caps on outstanding rows and tokens, a
fair-share weight, a bound adapter). The LoRA module is rebuilt at load
with `adapter_slots` + 1 stacked slots (`serving/adapters.py`; slot 0 is
the checkpoint's own adapter), a row's tenant picks its adapter, the
`AdapterRegistry` pins the adapter's slot for the row's life (loading it,
evicting an idle one to its spill tier, or restoring it), and every decode
call gets the rows' slots as `adapter_ix`, so one group mixes tenants.
Tenant admission (`serving/tenancy.py`) sheds a capped tenant's excess as
`tenant_quota` before the global queue check; an unknown tenant is a 400.
The prefix cache is namespaced by adapter (`plan_row`'s `namespace`): a
prompt's K/V depend on the adapter that projected them, so one tenant's
cached prefix never serves another adapter's row (the reference keys its
cache by token ids alone and does).
The spill tier (`spill_ram_bytes`, `spill_dir`) demotes evicted prefixes
to host RAM and disk and restores them on a later hit (`serving/kv.py`).

Unlike the reference, rows are not padded up to a power-of-two batch: an
eager PyTorch program has no compiled shapes to share, so dummy rows would
only cost work. Groups decode until their longest row is done, not to the
end of the new-token bucket.

Observability: every HTTP request gets a `RequestTrace` (admission,
queue wait, prefill chunks, decode windows, harvest, the handoff), kept by
the tail-sampling ring behind `/tracez` (`config.trace`). With `slos` the
SLO engine burns availability and latency objectives (each latency
objective also per tenant, `"<slo>@<tenant>"`), and with `debug_dir` a
breach edge dumps a flight-recorder bundle (with a `torch.profiler` window
when `slo_profile_s` > 0). `history` samples the registry into a
crash-consistent store behind `/queryz`; `regression_rules` fire
edge-triggered `perf_regression` events over it (to `event_sink`).

Disaggregated pools (`role`): a `prefill` replica (chunked prefill, the
paged pool and the prefix cache) runs a row's prefill, exports its cached
page set after the last slice and ships it to the decode replica the
router names (`X-Handoff-Target`, `X-Handoff-Epoch`) over `/kv_import`,
then answers 503 `kv_handoff_done` (in band on a stream), which the router
replays on that replica: its admission hits the adopted pages. A failed
ship falls back to local decode. An adapter row's pages travel in its
adapter's prefix namespace and land in the same namespace there.

`ModelServer.from_run` serves the newest checkpoint of a run of the run
store (`store/local.py`) with the knobs its spec pins.

A decode mesh (`mesh=`, or `config.mesh_axes` through
`parallel.mesh.decode_mesh`): one process per device joins an initialized
torch.distributed world (`nccl` on the card, `gloo` on the CPU; a mesh of
one rank starts its own) and constructs the server with the same
arguments. Each rank keeps its shards (`serving/mesh.py`); rank 0 is the
server and drives the others, which run `follow()` until rank 0 stops.
Every path serves on a mesh as on one device: per request, coalesced,
paged, chunked, int8, beam search, n-gram and draft-model speculation
(the draft sharded like the target), adapter slots and tenants, the spill
tier and the prefill/decode roles; the spill mirror and a handoff export
hold whole pages, every kv head, as one device's do. `expected_devices` makes
`/readyz` answer 503 "degraded slice" when the world has fewer devices
(`runtime.health.check_slice`, run through the mesh's command loop).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import queue as _queue
import secrets
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..chaos.injector import inject
from ..device import resolve_device
from ..models.convert import params_from_jax
from ..models.draft import ModelDrafter, build_draft
from ..models.generate import (
    beam_search,
    generate,
    paged_decode_chunk,
    paged_prefill,
    paged_prefill_chunk,
    paged_step,
)
from ..models.quant import int8_bytes_saved, quantize_module
from .adapters import AdapterRegistry, adapter_template, ref_path, stack_adapter_params
from ..models.spec_decode import (
    NgramDrafter,
    commit_window,
    spec_generate,
    spec_verify_paged,
)
from ..models.kv_pages import page_hashes
from ..telemetry import (
    FlightRecorder,
    HistorySampler,
    HistoryStore,
    MetricsRegistry,
    RegressionSentinel,
    RequestTrace,
    SLOEngine,
    TraceRing,
    build_objectives,
    build_rules,
    new_trace_id,
    now as _now,
    queryz_payload,
    tracez_payload,
)
from .adaptive import AdaptiveSpecController
from .batching import (
    CircuitBreaker,
    DeadlineExceededError,
    DecodeCoalescer,
    GroupKey,
    PendingRequest,
    ServerClosingError,
    ServingConfig,
    ServingError,
    ShedError,
    choose_buckets,
)
from .handoff import (
    HandoffClient,
    HandoffError,
    LeaseTable,
    StaleLeaseError,
    payload_from_wire,
    payload_to_wire,
)
from .kv import KVCacheManager
from .mesh import MeshModule, ServingWorld, shard_bytes
from .spill import SpillManager
from .steps import RowStep, StepScheduler
from .tenancy import DEFAULT_TENANT, TenantAdmission, TenantSpec

class _HandoffPrefillDone(Exception):
    """Sentinel resolving a prefill-role row: the first token is out and
    the finished page set is exported, but the transfer has NOT run — the
    HTTP handler thread ships it (network I/O never rides the decode
    worker), then answers a retryable failover (shipped) or re-runs the
    row locally (not)."""

    def __init__(self, first_token: int):
        super().__init__("prefill complete: KV handoff pending")
        self.first_token = int(first_token)


def _trace_status(error: Optional[BaseException]) -> str:
    """Trace status for the tail sampler: everything that is not a clean
    completion is retained preferentially."""
    if error is None:
        return "ok"
    if isinstance(error, ShedError):
        return f"shed:{error.reason}"
    if isinstance(error, DeadlineExceededError):
        return "deadline_exceeded"
    if isinstance(error, ServingError):
        return "invalid_request"
    if isinstance(error, TimeoutError):
        return "timeout"
    return "error"


class _Httpd(ThreadingHTTPServer):
    # socketserver's default accept backlog is 5: an overload burst would
    # get TCP resets before the shed logic ever sees it
    request_queue_size = 128
    daemon_threads = True


def _int(body: dict, key: str, default):
    raw = body.get(key, default)
    if raw is None:
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise ServingError(f"{key} must be an integer, got {raw!r}")


def _float(body: dict, key: str, default):
    raw = body.get(key, default)
    if raw is None:
        return None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        raise ServingError(f"{key} must be a number, got {raw!r}")
    if not math.isfinite(value):
        raise ServingError(f"{key} must be finite")
    return value


def _new_request_id() -> str:
    return secrets.token_hex(8)


_STAGE_BYTES = 64 << 20  # the pinned staging buffer of a restore to the card


def _restore_params(ckpt_dir: Path, module, shard: tuple = (0, 1)) -> dict:
    """Read ONLY the params subtree ("model") of the newest step's
    `state.pt` (`runtime/checkpoint.py`'s layout) into `module`, the
    counterpart of the reference's Orbax partial restore.

    The file is opened with `torch.load(mmap=True, weights_only=True)`,
    so the optimizer's moments are never read, let alone moved. Each param
    is copied into the module's own tensor; on the card through a 64 MiB
    pinned staging buffer. Into an int8 module (`cfg.quant == "int8"`)
    each projection weight goes to the device alone, is quantized there
    (`models.quant.quantize_kernel`) and dropped, so no fp copy of the
    module ever exists on the device. On a decode mesh `shard` is this
    rank's (index, count) on `model` and `module` holds its shards
    (`serving.mesh.ServingWorld.shard`): each param's slice is read and
    moved, and an int8 o/down projection, whose shards keep the full-K
    scales, is quantized whole on the device before its columns are
    kept. Returns what it measured: the step, the bytes read, and seconds
    spent reading (mmap to staging), moving to the device and quantizing."""
    from .mesh import shard_slice, split_dim

    from ..models import quant
    from ..runtime.checkpoint import STATE_FILE, _steps_on_disk

    steps = _steps_on_disk(str(ckpt_dir))
    if not steps:
        raise ServingError(f"no restorable checkpoint in {ckpt_dir}")
    torch_steps = [s for s in steps if (ckpt_dir / str(s) / STATE_FILE).is_file()]
    if not torch_steps:
        raise ServingError(
            f"no {STATE_FILE} under {ckpt_dir} (steps {steps}): the run was "
            "checkpointed by the JAX package (Orbax), which the port does not read"
        )
    step = torch_steps[-1]
    path = ckpt_dir / str(step) / STATE_FILE
    t0 = time.perf_counter()
    state = torch.load(path, map_location="cpu", mmap=True, weights_only=True)["model"]
    times = {"read_s": time.perf_counter() - t0, "to_device_s": 0.0, "quantize_s": 0.0}
    own = module.state_dict()
    int8 = getattr(module.cfg, "quant", "none") == "int8"

    def is_target(name: str, leaf_name: str = "weight") -> bool:
        prefix, leaf = quant._split(name)
        return int8 and leaf == leaf_name and quant._is_target(prefix)

    want = {k for k in own if not is_target(k, "scale")}  # scales are made here
    if set(state) != want:
        raise ServingError(
            f"{path}: the params do not fit the run's model (missing "
            f"{sorted(want - set(state))[:4]}, unexpected {sorted(set(state) - want)[:4]})"
        )
    dev = module.device
    stage = (torch.empty(_STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
             if dev.type == "cuda" else None)

    def to_device(src, dst) -> None:
        if stage is None:
            t = time.perf_counter()
            dst.copy_(src)
            times["to_device_s"] += time.perf_counter() - t
            return
        flat_src, flat_dst = src.reshape(-1), dst.view(-1)  # a column slice: copied
        per = _STAGE_BYTES // src.element_size()
        for i in range(0, flat_src.numel(), per):
            part = flat_src[i:i + per]
            t = time.perf_counter()
            staged = stage[:part.numel() * part.element_size()].view(part.dtype).copy_(part)
            t1 = time.perf_counter()
            flat_dst[i:i + part.numel()].copy_(staged, non_blocking=True)
            torch.cuda.synchronize(dev)  # the staging buffer is reused next
            times["read_s"] += t1 - t
            times["to_device_s"] += time.perf_counter() - t1

    n_bytes = 0
    index, count = shard
    with torch.no_grad():
        for name, value in state.items():
            dim = split_dim(name) if count > 1 else None
            if not is_target(name):
                value = shard_slice(value, dim, index, count)
                n_bytes += value.numel() * value.element_size()
                dst = own[name]
                if dst.dim() == value.dim() + 1:
                    # a slot-stacked LoRA factor (serving.adapters.
                    # stack_adapter_params, on a mesh before the restore):
                    # lora_a in every slot, lora_b in slot 0 and zeros after
                    if name.endswith("lora_b"):
                        dst.zero_()
                    for k in range(1 if name.endswith("lora_b") else dst.shape[-3]):
                        to_device(value, dst.select(-3, k))
                    continue
                to_device(value, dst)
                continue
            if dim == 0:  # output rows: their scales are their own
                value = shard_slice(value, dim, index, count)
            n_bytes += value.numel() * value.element_size()
            w = torch.empty(value.shape, dtype=value.dtype, device=dev)
            to_device(value, w)
            t = time.perf_counter()
            q, s = quant.quantize_kernel(w)
            own[name].copy_(shard_slice(q, dim, index, count) if dim == 1 else q)
            own[f"{quant._split(name)[0]}.scale"].copy_(s)
            del w, q, s
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times["quantize_s"] += time.perf_counter() - t
    del state
    return {"step": step, "path": str(path), "bytes_read": n_bytes, **times}


class ModelServer:
    def __init__(
        self,
        module,
        params=None,
        config: Optional[ServingConfig] = None,
        *,
        model_name: str = "transformer_lm",
        step: int = 0,
        device="cuda",
        registry: Optional[MetricsRegistry] = None,
        slos: Optional[list] = None,
        debug_dir: Optional[str] = None,
        slo_profile_s: float = 0.0,
        history: Optional[dict] = None,
        regression_rules: Optional[list] = None,
        event_sink=None,
        mesh=None,
        expected_devices: Optional[int] = None,
    ):
        """`params`: None (keep the module's weights), a torch state_dict,
        or the JAX package's nested numpy param dict. `slos`: objective
        dicts (name, kind availability|latency, objective, thresholdMs,
        windows); `debug_dir`: where a breach writes its flight-recorder
        bundle; `history`: {"dir", "interval_s", "max_bytes",
        "segment_bytes"}; `regression_rules`: rule dicts over the history;
        `event_sink`: called with each perf_regression event. `mesh`: a
        decode mesh (`parallel.mesh.decode_mesh`; default: one from
        `config.mesh_axes`, none without). `expected_devices`: /readyz reports a degraded slice
        below that many devices."""
        self.config = config or ServingConfig()
        cfg = self.config
        # the reference's cross-field rules: an ignored kv_quant would have an
        # operator planning capacity on memory they do not have
        if cfg.kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', got {cfg.kv_quant!r}")
        if cfg.kv_quant != "none" and not cfg.kv_pool_pages:
            raise ValueError("kv_quant requires the paged KV pool (set kv_pool_pages)")
        if (cfg.adaptive_draft or cfg.draft_model is not None) and not cfg.speculate:
            raise ValueError("draft_model/adaptive_draft require speculate=True")
        if cfg.speculate and int(cfg.draft_tokens) < 1:
            raise ValueError("draft_tokens must be >= 1")
        # disaggregated pools: the handoff unit is the page-aligned prefix
        # chain a chunked prefill leaves behind
        if cfg.role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be 'both', 'prefill' or 'decode', got {cfg.role!r}")
        if cfg.role == "prefill" and not (
            cfg.chunked_prefill and cfg.kv_pool_pages and cfg.prefix_cache
        ):
            raise ValueError(
                "role='prefill' requires chunked_prefill + kv_pool_pages + "
                "prefix_cache (the handoff ships the page-aligned prefix chain "
                "chunked prefill leaves in the cache)"
            )
        if (cfg.spill_ram_bytes or cfg.spill_dir) and not (
            cfg.kv_pool_pages and cfg.prefix_cache
        ):
            raise ValueError(
                "spill_ram_bytes/spill_dir require the paged KV pool with the "
                "prefix cache (set kv_pool_pages, keep prefix_cache on)"
            )
        self.device = resolve_device(device)
        if module.device.type != "meta":  # a meta module is restored into (from_run)
            module = module.to(self.device)
        module = module.eval()
        self._world: Optional[ServingWorld] = None
        if mesh is not None or cfg.mesh_axes:
            self._world = self._join_mesh(mesh, cfg)
        if params is not None:
            if all(isinstance(v, torch.Tensor) for v in params.values()):
                state = params
            else:
                state = params_from_jax(params, module.cfg)
            module.load_state_dict(state)
        # int8 quantize-on-load: a new module with int8 projections, built
        # before anything captures the module; the fp copy is the caller's
        self._quant_bytes_saved = 0
        if cfg.quantize and module.cfg.quant == "int8":  # quantized on load (from_run)
            self._quant_bytes_saved = int8_bytes_saved(module)
        elif cfg.quantize:
            module, self._quant_bytes_saved = quantize_module(module)
        # multi-tenant adapters: stack the LoRA params to [slots, ...] after
        # quantize (int8 base + fp adapters compose); slot 0 keeps the
        # checkpoint's own adapter, slots 1..N start zero for the registry
        self._tenancy: Optional[TenantAdmission] = None
        self._adapter_registry: Optional[AdapterRegistry] = None
        self._adapter_spill: Optional[SpillManager] = None
        self._adapter_sources = dict(cfg.adapters or ())
        self._adapter_slots_active = False
        if self._adapter_sources or cfg.adapter_slots:
            if getattr(module.cfg, "lora_rank", 0) <= 0:
                raise ValueError(
                    "serving adapters require a LoRA model (lora_rank > 0): "
                    "this checkpoint has no adapter params to multiplex"
                )
            n_hot = int(cfg.adapter_slots) or len(self._adapter_sources)
            if n_hot < 1:
                raise ValueError("adapter_slots must be >= 1 when adapters are configured")
            module = stack_adapter_params(module, slots=n_hot + 1)
            self._adapter_slots_active = True
            # one adapter's whole shapes (a mesh rank holds slices of them)
            self._adapter_template = adapter_template(module)
        # adaptive speculation: a draft model by layer truncation of the
        # SERVED module (after quantize, so it rides the same int8 weights)
        # and the accept-rate controller that steers the draft width
        self._draft_module, self._draft_derived = None, False
        if cfg.draft_model is not None:
            self._draft_module, self._draft_derived = build_draft(
                module, overrides=dict(cfg.draft_model)
            )
        self.mesh_shard_bytes = None
        if self._world is not None:
            self._world.shard(module)
            self.mesh_shard_bytes = shard_bytes(module)
            if self._draft_module is not None:
                self._draft_module = self._shard_draft(self._draft_module, module)
            if not self._world.leader:
                # a follower keeps its shards and runs rank 0's commands
                # (`follow`); everything else is rank 0's
                self.module = module
                return
            module = MeshModule(module, self._world)
            if self._draft_module is not None:
                self._draft_module = MeshModule(self._draft_module, self._world, "draft_")
        if cfg.tenants or self._adapter_sources:
            self._tenancy = TenantAdmission(cfg.tenants)
            for pairs in cfg.tenants or ():
                spec = TenantSpec.from_pairs(pairs)
                if spec.adapter and spec.adapter not in self._adapter_sources:
                    raise ValueError(
                        f"tenant {spec.name!r} binds adapter {spec.adapter!r}, "
                        "which is not configured"
                    )
        self.module = module
        self._spec_controller: Optional[AdaptiveSpecController] = None
        if cfg.adaptive_draft and cfg.speculate:
            k0 = max(1, int(cfg.draft_tokens))
            self._spec_controller = AdaptiveSpecController(k_init=k0, k_min=1, k_max=max(k0, 8))
        self.model_name = model_name
        self.step = step
        self.restore_info: Optional[dict] = None  # set by from_run
        self.expected_devices = expected_devices
        self._health_cache: Optional[tuple] = None
        self._draining = False
        # ONE metrics pipeline: /statsz and /metricsz both render from it
        self.telemetry = registry or MetricsRegistry()
        t = self.telemetry
        self._m_requests = t.counter("serving.requests", help="Generation rows served")
        self._m_batches = t.counter("serving.batches", help="Decode batches dispatched")
        self._m_latency = t.histogram(
            "serving.request_seconds", help="End-to-end request latency, seconds"
        )
        self._m_queue_wait = t.histogram(
            "serving.queue_wait_seconds",
            help="Submit-to-dispatch wait in the coalescer queue, seconds",
        )
        self._m_occupancy = t.histogram(
            "serving.batch_occupancy", buckets=(1, 2, 4, 8, 16, 32, 64),
            help="Rows per dispatched decode batch",
        )
        self._m_shed = t.counter(
            "serving.shed",
            help="Requests shed at admission (queue full / breaker open / "
            "expired / draining / KV pages)",
        )
        self._m_deadline = t.counter(
            "serving.deadline_exceeded",
            help="Requests that missed their deadline (shed at admission or "
            "dropped before dispatch)",
        )
        self._m_worker_restarts = t.counter(
            "serving.worker_restarts", help="Decode worker watchdog restarts"
        )
        self._m_breaker = t.gauge(
            "serving.breaker_state",
            help="Decode circuit breaker: 0 closed, 1 open, 2 half-open",
        )
        self._m_breaker.set(0)
        self._m_ready = t.gauge(
            "serving.ready", help="Readiness (/readyz): 1 accepting, 0 draining"
        )
        self._m_ready.set(0)
        self._m_queue_depth = t.gauge(
            "serving.queue_depth",
            help="Unfinished requests admitted to the coalescer queue",
        )
        self._m_queue_depth.set(0)
        self._m_mesh_devices = t.gauge(
            "serving.mesh_devices",
            help="Devices in this replica's decode mesh (1 = single-chip)",
        )
        self._m_mesh_model = t.gauge(
            "serving.mesh_model",
            help="Tensor-parallel (`model` axis) degree of the decode mesh",
        )
        w = self._world
        self._m_mesh_devices.set(w.size if w is not None else 1)
        self._m_mesh_model.set(w.sizes["model"] if w is not None else 1)
        self._m_kv_total = t.gauge(
            "serving.kv_pages_total",
            help="KV page pool capacity (0 = dense per-group caches)",
        )
        self._m_kv_total.set(0)
        self._m_kv_used = t.gauge(
            "serving.kv_pages_used",
            help="KV pages currently allocated (incl. scratch + prefix cache)",
        )
        self._m_kv_used.set(0)
        self._m_kv_prefix_held = t.gauge(
            "serving.kv_pages_prefix_held",
            help="Distinct KV pages held only on behalf of the prefix cache",
        )
        self._m_kv_prefix_held.set(0)
        self._m_prefix_hits = t.counter(
            "serving.prefix_cache_hits",
            help="Requests whose prompt prefix was served from cached KV",
        )
        self._m_prefix_misses = t.counter(
            "serving.prefix_cache_misses",
            help="Requests that found no cached KV prefix",
        )
        self._m_ttft = t.histogram(
            "serving.ttft_ms",
            buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
            help="Time to first token, milliseconds (admission → first "
            "sampled token; whole-decode on the dense path)",
        )
        self._m_decode_step = t.histogram(
            "serving.decode_step_ms",
            buckets=(1, 2, 5, 10, 15, 20, 25, 30, 40, 50, 75, 100, 250, 1000),
            help="Wall time of one batched decode step on the paged paths, "
            "milliseconds (a chunk's time over its steps)",
        )
        self._m_prefill_chunks = t.counter(
            "serving.prefill_chunks",
            help="Prefill slices executed by the step scheduler",
        )
        self._m_step_tokens = t.histogram(
            "serving.step_tokens", buckets=(8, 16, 32, 64, 128, 256, 512, 1024),
            help="Tokens touched per device step (all decode rows plus at "
            "most one prefill slice; bounded by maxStepTokens)",
        )
        self._m_prefill_queue = t.gauge(
            "serving.prefill_queue_depth",
            help="Rows admitted but not yet past prefill, refreshed at scrape",
        )
        self._m_prefill_queue.set(0)
        self._m_http = t.counter(
            "serving.http_requests", help="HTTP /generate attempts (any outcome)"
        )
        self._m_http_err = t.counter(
            "serving.http_errors", help="HTTP /generate 5xx-class failures"
        )
        self._m_client_disconnects = t.counter(
            "serving.client_disconnects",
            help="Streamed /generate requests whose client vanished mid-stream",
        )
        # fast-decode series: registered from startup (zeros when
        # speculation and quantization are off)
        self._m_spec_proposed = t.counter(
            "serving.spec_proposed",
            help="Draft tokens proposed to speculative verify windows",
        )
        self._m_spec_accepted = t.counter(
            "serving.spec_accepted",
            help="Draft tokens accepted (committed without their own forward "
            "pass); accept rate = accepted / proposed",
        )
        self._m_spec_rollback = t.counter(
            "serving.spec_rollback",
            help="Draft tokens rejected and rolled back (their KV slots are "
            "masked dead and rewritten by the next window)",
        )
        self._m_spec_truncated = t.counter(
            "serving.spec_truncated",
            help="Accepted drafts the remaining-budget clamp kept out of the "
            "commit — the gap between the raw and corrected accept rates",
        )
        self._m_spec_effective_k = t.gauge(
            "serving.spec_effective_k",
            help="Current speculative draft width K (0 = speculation off or "
            "auto-disabled; static draft_tokens without adaptiveDraft)",
        )
        self._m_spec_effective_k.set(int(cfg.draft_tokens) if cfg.speculate else 0)
        self._m_quant_saved = t.gauge(
            "serving.quant_bytes_saved",
            help="Device bytes saved by int8 weight-only quantization (0 = "
            "full-precision projections)",
        )
        self._m_quant_saved.set(self._quant_bytes_saved)
        # tiered prefix spill series, registered from startup (zeros when the
        # spill tier is off)
        self._m_spill_bytes = t.counter(
            "serving.kv_spill_bytes",
            help="Bytes of evicted KV prefixes accepted into the spill tiers",
        )
        self._m_spill_restores = t.counter(
            "serving.kv_spill_restores",
            help="Spilled KV prefixes restored into the pool on a hit",
        )
        self._m_spill_quarantined = t.counter(
            "serving.kv_spill_quarantined",
            help="Corrupt spill segments quarantined to <seg>.corrupt (clean misses)",
        )
        # multi-tenant series: the adapter-swap cost and the named tenants'
        # queue wait, registered from startup
        self._m_tenant_queue_wait = t.histogram(
            "serving.tenant_queue_wait_seconds",
            help="Submit-to-dispatch wait for rows of NAMED tenants, seconds "
            "(per-tenant splits in serving.queue_wait_by_tenant.*)",
        )
        self._m_adapter_load = t.histogram(
            "serving.adapter_load_ms",
            buckets=(1, 5, 10, 25, 50, 100, 250, 500, 1000, 5000),
            help="Wall time to materialize an adapter into its slot on acquire "
            "(cold load or spill restore), milliseconds",
        )
        # live KV handoff series, registered from startup (zeros when the
        # pools are off)
        self._m_handoff_ms = t.histogram(
            "serving.kv_handoff_ms",
            buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000),
            help="Prefill→decode KV handoff wall time, milliseconds (ship "
            "through import acknowledgement)",
        )
        self._m_handoff_capture = t.histogram(
            "serving.kv_handoff_capture_ms",
            buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000),
            help="Prefill side: harvest + export capture of the finished page "
            "set to host bytes, milliseconds",
        )
        self._m_handoff_adopt = t.histogram(
            "serving.kv_handoff_adopt_ms",
            buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000),
            help="Decode side: parse, verify and adopt of an import on the "
            "host (after the body is read), milliseconds",
        )
        self._m_handoff_write = t.histogram(
            "serving.kv_handoff_write_ms",
            buckets=(0.1, 0.5, 1, 2, 5, 10, 25, 50, 100, 250),
            help="Decode side: host time of the adopted pages' device write, "
            "milliseconds",
        )
        self._m_handoff_bytes = t.counter(
            "serving.kv_handoff_bytes", help="Wire bytes of acknowledged exports"
        )
        self._m_handoff_exports = t.counter(
            "serving.kv_handoff_exports",
            help="Page sets this replica exported to a decode replica over "
            "POST /kv_import (acknowledged adoptions)",
        )
        self._m_handoff_imports = t.counter(
            "serving.kv_handoff_imports",
            help="Page sets this replica adopted from a prefill replica",
        )
        self._m_handoff_rejected = t.counter(
            "serving.kv_handoff_rejected",
            help="Imports refused: stale lease epoch (409), CRC/hash "
            "verification failure (400), or headroom shed (503)",
        )
        self._m_handoff_fallbacks = t.counter(
            "serving.kv_handoff_fallbacks",
            help="Prefill-role requests completed by LOCAL decode because no "
            "decode replica could adopt",
        )
        self._m_handoff_inflight = t.gauge(
            "serving.kv_handoff_inflight",
            help="Handoff exports in flight (captured, not yet acknowledged "
            "or fallen back); drain waits on zero",
        )
        self._m_kv_handoff_held = t.gauge(
            "serving.kv_pages_handoff_held",
            help="KV pages held by adopted-but-not-yet-flushed imports "
            "(in transit, not a leak)",
        )
        if self._tenancy is not None:
            for name in self._tenancy.known():
                self._tenant_series(name)
        # per-request traces: the tail-sampling ring behind /tracez
        self.traces = TraceRing(capacity=int(cfg.trace_ring))
        # SLO engine + flight recorder: a breach edge dumps a post-mortem
        # bundle under debug_dir; every latency objective is also tracked
        # per tenant against that tenant's own latency histogram, named
        # "<slo>@<tenant>", so a noisy neighbour burns its own budget
        self.slo_engine: Optional[SLOEngine] = None
        self.flight_recorder: Optional[FlightRecorder] = None
        if debug_dir is not None and (slos or regression_rules):
            self.flight_recorder = FlightRecorder(
                debug_dir, registry=t, trace_ring=self.traces,
                state_fn=self._occupancy_state, trace_fn=self._breach_trace,
                profile_s=slo_profile_s,
            )
        if slos:
            objectives = build_objectives(
                slos, bad=[self._m_http_err], total=[self._m_http],
                histogram=self._m_latency,
            )
            lat_specs = [x for x in slos if x.get("kind", "availability") == "latency"]
            if self._tenancy is not None and lat_specs:
                for tn in self._tenancy.known():
                    objectives += build_objectives(
                        [{**x, "name": f"{x.get('name', 'slo')}@{tn}"} for x in lat_specs],
                        bad=[self._m_http_err], total=[self._m_http],
                        histogram=self._tenant_series(tn)[1],
                    )
            self.slo_engine = SLOEngine(
                objectives, t,
                on_breach=self.flight_recorder.dump if self.flight_recorder else None,
            )
        # metrics history + regression sentinel: a background sampler
        # snapshots this registry into a tiered store (/queryz reads it);
        # rules over its windows fire edge-triggered perf_regression events
        self.history: Optional[HistoryStore] = None
        self.history_sampler: Optional[HistorySampler] = None
        self.sentinel: Optional[RegressionSentinel] = None
        if history is not None and history.get("dir"):
            self.history = HistoryStore(
                history["dir"],
                max_bytes=int(history.get("max_bytes") or HistoryStore.DEFAULT_MAX_BYTES),
                segment_bytes=int(
                    history.get("segment_bytes") or HistoryStore.DEFAULT_SEGMENT_BYTES
                ),
            )
            self.history_sampler = HistorySampler(
                t, self.history, interval_s=float(history.get("interval_s") or 1.0)
            )
        if regression_rules and self.history is not None:
            self.sentinel = RegressionSentinel(
                self.history, t, build_rules(regression_rules),
                on_event=event_sink, recorder=self.flight_recorder,
            )
        self._prompt_ladder, self._new_ladder = self.config.ladders(int(module.cfg.seq_len))
        self._group_seq = itertools.count(1)
        # live streamed requests by request id, so a broken pipe in the
        # HTTP layer can cancel the right rows
        self._stream_rows: dict = {}
        self._lock = threading.Lock()  # device work: one caller at a time
        # the adapter registry: named adapters managed like KV pages, idle
        # ones evicted LRU to a spill manager of their own (a RAM tier, and
        # <spill_dir>/adapters when spill_dir is set). Its lock serializes
        # that manager; slot reads and writes take self._lock inside it
        if self._adapter_slots_active:
            self._adapter_leaves = {
                ref_path(name): p for name, p in module.named_parameters()
                if ref_path(name) in self._adapter_template
            }
            self._adapter_spill = SpillManager(
                ram_bytes=256 << 20,
                dir_path=(str(cfg.spill_dir).rstrip("/") + "/adapters"
                          if cfg.spill_dir else None),
                dir_bytes=cfg.spill_dir_bytes,
            )
            self._adapter_registry = AdapterRegistry(
                slots=module.cfg.adapter_slots - 1,
                sources=self._adapter_sources,
                template=self._adapter_template,
                read_slot=self._adapter_read_slot,
                write_slot=self._adapter_write_slot,
                spill=self._adapter_spill,
                telemetry=self.telemetry,
            )
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._kv: Optional[KVCacheManager] = None
        if self.config.batching and self.config.kv_pool_pages:
            self._kv = KVCacheManager(
                module,
                pool_pages=int(self.config.kv_pool_pages),
                page_tokens=int(self.config.kv_page_tokens),
                prefix_cache=bool(self.config.prefix_cache),
                kv_quant=str(self.config.kv_quant or "none"),
                observer=self._kv_observe,
                spill_ram_bytes=self.config.spill_ram_bytes,
                spill_dir=self.config.spill_dir,
                spill_dir_bytes=self.config.spill_dir_bytes,
            )
            self._m_kv_total.set(self._kv.pool.n_pages)
            self._m_kv_used.set(self._kv.pool.used)
        self._coalescer: Optional[DecodeCoalescer] = None
        if self.config.batching:
            self._coalescer = self._make_coalescer()
        # live KV handoff: the lease table guards the decode side
        # (single-owner adoption per request id, monotonic epochs), the
        # client ships exports from the prefill side; exports in flight
        # gate drain (a replica must not report idle with a page set on
        # the wire)
        self._lease_table = LeaseTable()
        self._handoff_client = HandoffClient()
        self._handoff_lock = threading.Lock()
        self._handoff_inflight = 0
        self._handoff_idle = threading.Event()
        self._handoff_idle.set()

    def _join_mesh(self, mesh, cfg: ServingConfig) -> ServingWorld:
        """This process's place on the decode mesh `mesh`, else on one from
        `cfg.mesh_axes` over the initialized world (a mesh of one rank
        starts a one-rank group itself)."""
        import torch.distributed as dist

        from ..parallel.mesh import decode_axis_sizes, decode_mesh

        if mesh is None:
            axes = dict(cfg.mesh_axes)
            if not dist.is_initialized():
                decode_axis_sizes(axes, 1)  # more ranks need their world started
                dist.init_process_group(
                    "nccl" if self.device.type == "cuda" else "gloo",
                    store=dist.HashStore(), rank=0, world_size=1,
                )
            mesh = decode_mesh(axes)
        return ServingWorld(mesh, self.device)

    def _shard_draft(self, draft, target):
        """The draft model's shards on this rank: a draft truncated from the
        target takes the target's shards of the layers they share; one with
        widths of its own is split like the target, and must split."""
        if not self._draft_derived and draft.device.type == "meta":
            # from_run on a mesh builds on `meta`: a draft of widths of its
            # own has nothing to read, so it is drawn here, as on one device
            draft = type(draft)(draft.cfg, device=self._world.device,
                                dtype=draft.dtype).eval()
        try:
            self._world.shard(draft, share=dict(target.state_dict())
                              if self._draft_derived else None)
        except ValueError as e:
            c = draft.cfg
            raise ValueError(
                f"the draft model (dim {c.dim}, {c.n_heads} heads, {c.n_kv_heads} kv "
                f"heads, ffn {c.ffn_dim}, vocab {c.vocab_size}) does not split over the "
                f"decode mesh's model axis of {self._world.sizes['model']}: {e}"
            ) from None
        return draft

    @property
    def is_follower(self) -> bool:
        """True on a rank of a decode mesh other than rank 0."""
        return self._world is not None and not self._world.leader

    def follow(self) -> int:
        """A follower's loop (`serving.mesh.ServingWorld.follow`): run rank
        0's commands on this rank's shards until rank 0 stops. Returns the
        commands run."""
        if not self.is_follower:
            raise RuntimeError("follow() runs on the followers of a decode mesh")
        return self._world.follow(self.module, self._draft_module)

    @classmethod
    def from_run(
        cls,
        run_ref: str,
        store=None,
        mesh_axes: Optional[dict] = None,
        config: Optional[ServingConfig] = None,
        config_overrides: Optional[dict] = None,
        expected_devices: Optional[int] = None,
        *,
        device="cuda",
    ):
        """Serve the newest checkpoint of a `transformer_lm` jaxjob run of
        the run store (the reference's `from_run`).

        A serving-shaped restore, not a Trainer: the module is built from
        the stored spec in the run's master-weight dtype
        (`param_dtype_for(train.precision)`), no data pipeline is built,
        and only the params subtree of the newest
        `<outputs>/checkpoints/<step>/state.pt` is read (`_restore_params`;
        the optimizer's moments never reach the device). With
        `quantize` the module is built int8 and each projection is
        quantized on the device as it arrives.

        `config` replaces the serving knobs wholesale; absent, the spec's
        `program.serving` provides them. `config_overrides` (field → value)
        layer single knobs over that base. `mesh_axes` layers like an
        override: on a decode mesh every rank of the world calls
        `from_run` alike; the module is built on the `meta` device, each
        rank gets empty shards and reads only its slices of the
        checkpoint, and the followers then run `follow()`.
        The run's observability block wires the SLO engine, the metrics
        history under `<outputs>/telemetry/history/` and the regression
        rules, whose events land in the run's event log. What the restore
        measured is kept on the server as `restore_info`."""
        from ..models import build_model
        from ..runtime.trainer import param_dtype_for
        from ..schemas.run_kinds import V1JAXJob
        from ..store import RunStore
        from .batching import normalize_mesh_axes

        t_start = time.perf_counter()
        store = store or RunStore()
        uuid = store.resolve(run_ref)
        run = (store.read_spec(uuid).get("component") or {}).get("run") or {}
        if run.get("kind") != "jaxjob" or not run.get("program"):
            raise ServingError(f"run {uuid[:8]} is not a native jaxjob program run")
        program = V1JAXJob.from_dict(run).program
        if program.model.name not in ("transformer_lm",):
            raise ServingError(
                f"serving supports the LM family (transformer_lm), run "
                f"{uuid[:8]} trained {program.model.name!r}"
            )
        if config is None and program.serving is not None:
            config = program.serving.to_config()
        if config_overrides:
            config = dataclasses.replace(config or ServingConfig(), **config_overrides)
        if mesh_axes:
            config = dataclasses.replace(
                config or ServingConfig(), mesh_axes=normalize_mesh_axes(mesh_axes)
            )
        config = config or ServingConfig()
        ckpt_dir = (store.outputs_dir(uuid) / "checkpoints").resolve()
        if not ckpt_dir.is_dir():
            raise ServingError(
                f"run {uuid[:8]} has no checkpoints under its outputs — "
                "train with train.checkpointEvery set"
            )
        tspec = program.train
        precision = tspec.precision if tspec else "mixed"
        model_config = dict(program.model.config or {})
        if config.quantize:
            model_config["quant"] = "int8"
        dev = resolve_device(device)
        module = build_model(
            program.model.name, model_config,
            device="meta" if config.mesh_axes else dev,
            dtype=param_dtype_for(precision), seed=int(tspec.seed) if tspec else 0,
        ).module.eval()
        info = None
        if not config.mesh_axes:
            info = _restore_params(ckpt_dir, module)
        slos = history = rules = None
        obs = program.observability
        if obs is not None and obs.slos:
            slos = [s.to_config() for s in obs.slos]
        if obs is not None and obs.history is not None and obs.history.enabled:
            history = obs.history.to_config(
                str(store.outputs_dir(uuid) / "telemetry" / "history")
            )
        if obs is not None and obs.regression_rules:
            rules = obs.rules_config()
        server = cls(
            module,
            None,
            config,
            model_name=program.model.name,
            step=info["step"] if info else 0,
            device=dev,
            expected_devices=expected_devices,
            slos=slos,
            debug_dir=str(store.outputs_dir(uuid) / "debug") if (slos or rules) else None,
            history=history,
            regression_rules=rules,
            event_sink=(
                (lambda kind, body: store.log_event(uuid, kind, body)) if rules else None
            ),
        )
        if info is None:  # a decode mesh: this rank's shards
            w = server._world
            info = _restore_params(ckpt_dir, server.module if server.is_follower
                                   else server.module.module, (w.model_index, w.sizes["model"]))
            server.step = info["step"]
        server.restore_info = {
            **info, "run": uuid, "seconds": time.perf_counter() - t_start,
        }
        return server

    # ------------------------------------------------------------ handoff
    def _handoff_begin(self) -> None:
        with self._handoff_lock:
            self._handoff_inflight += 1
            self._handoff_idle.clear()
            self._m_handoff_inflight.set(self._handoff_inflight)

    def _handoff_end(self) -> None:
        with self._handoff_lock:
            self._handoff_inflight -= 1
            self._m_handoff_inflight.set(self._handoff_inflight)
            if self._handoff_inflight <= 0:
                self._handoff_idle.set()

    def _handoff_ship(self, r: PendingRequest) -> bool:
        """POST the exported page set to the router-named decode replica.
        Handler thread only. True: the decode side adopted the pages (the
        caller turns the row into a retryable failover, replayed there);
        False: the caller falls back to local decode. Never raises."""
        if not r.handoff_payload or not r.handoff_target:
            return False
        t0 = _now()
        self._handoff_begin()
        try:
            res = self._handoff_client.send(
                r.handoff_target, r.request_id or new_trace_id(), r.handoff_payload,
                base_epoch=int(r.handoff_epoch),
            )
        finally:
            self._handoff_end()
            self._m_handoff_ms.observe((_now() - t0) * 1e3)
        if res.ok:
            self._m_handoff_exports.inc()
            self._m_handoff_bytes.inc(len(r.handoff_payload))
            if r.trace is not None:
                r.trace.add(
                    "kv_handoff", start=t0, dur_s=_now() - t0, row=r.row,
                    pages=res.adopted_pages, epoch=res.epoch, attempts=res.attempts,
                    adopt_ms=res.adopt_ms,
                )
            return True
        self._m_handoff_rejected.inc()
        return False

    def _handoff_rerun(self, req: dict, row_idx: int) -> PendingRequest:
        """The local fallback after a failed handoff: re-run one row of the
        validated request here, with the handoff target cleared. The
        finished prefix is warm in this replica's cache, so the re-run goes
        straight to decode. Returns the resolved row; raises its error."""
        self._m_handoff_fallbacks.inc()
        sub = dict(req)
        sub["arr"] = req["arr"][row_idx:row_idx + 1]
        # _make_requests seeds row i as seed + i: keep the original row's
        # stream, so the fallback gives the monolithic tokens
        sub["seed"] = int(req["seed"]) + row_idx
        sub["handoff_target"] = ""
        r2 = self._make_requests(sub, req.get("rid"))[0]
        r2.row = row_idx
        r2.submitted_t = _now()
        try:
            self._coalescer.submit(r2)
        except BaseException:
            self._release_row(r2)
            raise
        if not r2.done.wait(self.config.request_timeout_s):
            raise TimeoutError(
                f"handoff fallback did not complete within "
                f"{self.config.request_timeout_s:.0f}s"
            )
        if r2.error is not None:
            raise r2.error
        return r2

    def _handoff_stream_resolve(self, req: dict, r: PendingRequest) -> list:
        """Terminal events of a streamed row whose prefill finished with a
        pending handoff. Shipped: one in-band error frame the router's
        failover treats as retryable (it replays the stream on the decode
        replica and trims the first token, already sent). Not shipped:
        the local fallback's remaining tokens as one chunk, then done."""
        i = r.row
        if self._handoff_ship(r):
            return [{"row": i, "error": "kv_handoff_done: decode replica owns the stream"}]
        try:
            r2 = self._handoff_rerun(req, i)
        except BaseException as e:  # noqa: BLE001 — in-band taxonomy
            return [{"row": i, "error": str(e)}]
        out = []
        rest = r2.result[r2.prompt_len + 1:]
        if rest:
            out.append({"row": i, "tokens": [int(x) for x in rest]})
        out.append({"row": i, "done": True})
        return out

    # ------------------------------------------------------------ tracing
    def _new_trace(self, rid: str, **attrs) -> Optional[RequestTrace]:
        """A RequestTrace for this request id, or None with config.trace off."""
        if not self.config.trace:
            return None
        return RequestTrace(rid, **attrs)

    def _finish_trace(self, trace: Optional[RequestTrace],
                      error: Optional[BaseException]) -> None:
        """Close the root span and hand the trace to the tail sampler."""
        if trace is None:
            return
        trace.finish(status=_trace_status(error),
                     error=None if error is None else str(error))
        self.traces.record(trace)

    def _trace_group(self, batch) -> tuple:
        """Open one decode group: a fresh group span id shared by every
        member row's trace, and each row's queue_wait span (submit →
        dispatch). Returns (group_id, dispatch_t)."""
        gid = next(self._group_seq)
        td = _now()
        for r in batch:
            if r.trace is None:
                continue
            r.trace.set_group(gid)
            start = r.submitted_t if r.submitted_t is not None else r.trace.t0
            r.trace.add("queue_wait", start=start, dur_s=td - start, group=gid, row=r.row)
        return gid, td

    def _occupancy_state(self) -> dict:
        """Queue and KV occupancy for the flight-recorder bundle."""
        out: dict = {"draining": self._draining}
        c = self._coalescer
        if c is not None:
            out["queue"] = {"depth": c.depth,
                            "breaker": c.breaker.state if c.breaker else None}
        if self._kv is not None:
            out["kv"] = self._kv.stats()
        return out

    def _breach_trace(self, breach: dict) -> Optional[dict]:
        """The trace that explains a latency breach: the p99 exemplar."""
        if breach.get("kind") == "latency":
            ex = self._m_latency.exemplar(0.99)
            if ex is not None:
                return self.traces.get(ex["trace_id"])
        return None

    # ---------------------------------------------------------- coalescer
    def _make_coalescer(self) -> DecodeCoalescer:
        breaker = CircuitBreaker(
            threshold=self.config.breaker_threshold,
            cooldown_s=self.config.breaker_cooldown_s,
            on_change=self._m_breaker.set,
        )
        if self.config.chunked_prefill and self._kv is not None:
            # only meaningful on the paged path: page tables are what let a
            # half-prefilled row persist across steps
            return StepScheduler(
                self._dispatch_group,
                _StepEngine(self),
                prefill_chunk_tokens=self.config.prefill_chunk_tokens,
                max_step_tokens=self.config.max_step_tokens,
                max_batch=self.config.max_batch,
                max_wait_ms=self.config.max_wait_ms,
                max_queue=self.config.max_queue,
                breaker=breaker,
                observer=self._observe,
                tenancy=self._tenancy,
            )
        return DecodeCoalescer(
            self._dispatch_group,
            max_batch=self.config.max_batch,
            max_wait_ms=self.config.max_wait_ms,
            max_queue=self.config.max_queue,
            breaker=breaker,
            observer=self._observe,
            tenancy=self._tenancy,
        )

    def _observe(self, event: str, **ctx) -> None:
        """Coalescer → registry bridge: every resilience event lands on
        /metricsz (and /statsz) through the one telemetry pipeline."""
        if event == "shed":
            self._m_shed.inc()
            reason = ctx.get("reason", "overload")
            self.telemetry.counter(
                f"serving.shed.{reason}", help=f"Requests shed at admission: {reason}"
            ).inc()
            # per-tenant attribution, only for configured tenants: unknown
            # names are a 400 before admission, so clients cannot mint series
            tenant = ctx.get("tenant")
            if tenant and self._tenancy is not None and tenant in self._tenancy.known():
                self._tenant_series(tenant)[0].inc()
            if reason == "deadline":
                self._m_deadline.inc()
        elif event == "deadline_dropped":
            self._m_deadline.inc()
        elif event == "worker_restart":
            self._m_worker_restarts.inc()
        elif event == "decode_error":
            self.telemetry.counter(
                "serving.decode_errors", help="Decode batch failures"
            ).inc()
        elif event == "step":
            self._m_step_tokens.observe(float(ctx.get("tokens", 0)))
            rows = int(ctx.get("rows", 0))
            if rows:
                self._m_occupancy.observe(rows)
            self._m_batches.inc()

    def _kv_observe(self, event: str, **ctx) -> None:
        """KVCacheManager → registry bridge."""
        if event == "kv_pages":
            self._m_kv_used.set(ctx["used"])
            self._m_kv_prefix_held.set(ctx.get("prefix_held", 0))
            self._m_kv_handoff_held.set(ctx.get("handoff_held", 0))
        elif event == "kv_handoff_adopt":
            self._m_handoff_imports.inc()
        elif event == "kv_handoff_write":
            self._m_handoff_write.observe(float(ctx.get("ms", 0.0)))
        elif event == "prefix_hit":
            self._m_prefix_hits.inc()
        elif event == "prefix_miss":
            self._m_prefix_misses.inc()
        elif event == "prefix_evict":
            self.telemetry.counter(
                "serving.prefix_cache_evictions",
                help="Prefix-cache entries LRU-evicted to admit new requests",
            ).inc()
        elif event == "kv_spill":
            self._m_spill_bytes.inc(int(ctx.get("bytes", 0)))
        elif event == "kv_spill_restore":
            self._m_spill_restores.inc()
        elif event == "kv_spill_quarantined":
            self._m_spill_quarantined.inc(int(ctx.get("n", 1)))
        elif event == "shed":
            self._observe("shed", **ctx)

    # ------------------------------------------------------------ tenancy
    def _tenant_series(self, tenant: str):
        """The per-tenant series (shed counter, request-latency histogram,
        queue-wait histogram), created on first use. Only configured tenant
        names reach here, so the run's config bounds their number."""
        t = self.telemetry
        return (
            t.counter(f"serving.shed_by_tenant.{tenant}",
                      help=f"Requests shed at admission for tenant {tenant!r}"),
            t.histogram(f"serving.request_seconds_by_tenant.{tenant}",
                        help=f"End-to-end latency for tenant {tenant!r}, seconds"),
            t.histogram(f"serving.queue_wait_by_tenant.{tenant}",
                        help=f"Submit-to-dispatch wait for tenant {tenant!r}, seconds"),
        )

    def _observe_queue_wait(self, r: PendingRequest) -> None:
        """One row's submit → dispatch wait: the global histogram and, for a
        configured tenant, its own split (and, for a named one, the
        fairness signal)."""
        # same clock as PendingRequest.enqueued_at
        wait = max(0.0, time.monotonic() - r.enqueued_at)
        self._m_queue_wait.observe(wait)
        tenant = r.tenant or ""
        if self._tenancy is None or tenant not in self._tenancy.known():
            return
        self._tenant_series(tenant)[2].observe(wait)
        if tenant != DEFAULT_TENANT:
            self._m_tenant_queue_wait.observe(wait)

    def _observe_body_latency(self, body, dur: float) -> None:
        """End-to-end latency split by the body's tenant."""
        if self._tenancy is None:
            return
        try:
            name = self._tenancy.resolve(str((body or {}).get("tenant") or "")).name
        except (KeyError, AttributeError):  # unknown tenants 400 elsewhere
            return
        self._tenant_series(name)[1].observe(dur)

    def _adapter_read_slot(self, slot: int) -> list:
        """Host copies of every adapter leaf's [slot] slice, in the
        registry's sorted path order (a demoted adapter's spill payload).
        The copy runs on the stream of the steps, after them."""
        with self._lock:
            if self._world is not None:  # each rank's slice, gathered whole
                return [t.to("cpu", copy=True) for t in
                        self.module.read_slot(slot, sorted(self._adapter_template))]
            # a copy on every device: on the CPU .cpu() would return a view
            # of the slot the registry is about to overwrite
            return [self._adapter_leaves[p].select(-3, slot).detach().to("cpu", copy=True)
                    for p in sorted(self._adapter_template)]

    @torch.inference_mode()
    def _adapter_write_slot(self, slot: int, adapter: dict) -> None:
        """Install one adapter (slash-joined path → tensor) into stacked
        slot `slot`, in place, under self._lock: no step runs meanwhile, and
        the copy is queued on the stream that runs the steps, so the next
        step reads the new weights. Only a free or idle slot is written."""
        with self._lock:
            if self._world is not None:  # each rank writes its slice
                self.module.write_slot(slot, adapter)
                return
            for path, value in adapter.items():
                leaf = self._adapter_leaves[path]
                leaf.select(-3, slot).copy_(torch.as_tensor(value).to(leaf.device, leaf.dtype))

    def _adapter_ix(self, rows: list):
        """[len(rows)] adapter slots of one dispatch on the device, or None
        when the model has no stacked slots."""
        if not self._adapter_slots_active:
            return None
        return torch.tensor([r.adapter_slot for r in rows], dtype=torch.long,
                            device=self.device)

    @property
    def requests_served(self) -> int:
        return int(self._m_requests.value)

    # ---------------------------------------------------------- admission
    def _validate(self, body: dict) -> dict:
        if not isinstance(body, dict):
            raise ServingError("body must be a JSON object")
        tokens = body.get("tokens")
        if not tokens or not isinstance(tokens, list):
            raise ServingError("body.tokens must be a non-empty [[int]] batch")
        max_new = _int(body, "maxNewTokens", 16)
        if max_new < 1:
            raise ServingError("maxNewTokens must be >= 1")
        try:
            arr = np.asarray(tokens, dtype=np.int64)
        except (ValueError, TypeError) as e:
            raise ServingError(f"tokens must be rectangular [[int]]: {e}")
        if arr.ndim != 2 or arr.shape[1] < 1:
            raise ServingError(
                "tokens must be rectangular [[int]] with >= 1 token per row"
            )
        if arr.shape[0] > self.config.max_batch:
            raise ServingError(
                f"{arr.shape[0]} rows exceed maxBatch {self.config.max_batch}"
            )
        cfg = self.module.cfg
        if arr.min() < 0 or arr.max() >= cfg.vocab_size:
            raise ServingError(
                f"token ids must be in [0, {cfg.vocab_size}); "
                f"got range [{arr.min()}, {arr.max()}]"
            )
        if arr.shape[1] + max_new > cfg.seq_len:
            raise ServingError(
                f"prompt ({arr.shape[1]}) + maxNewTokens ({max_new}) exceeds "
                f"the model's seq_len {cfg.seq_len}"
            )
        temperature = _float(body, "temperature", 0.0)
        eos = _int(body, "eosId", None)
        if eos is not None and not 0 <= eos < cfg.vocab_size:
            raise ServingError(f"eosId must be in [0, {cfg.vocab_size})")
        num_beams = _int(body, "numBeams", 1)
        # numBeams multiplies the cache and the candidate tensors: capped,
        # or a client could ask for an out-of-memory
        max_beams = min(32, cfg.vocab_size)
        if not 1 <= num_beams <= max_beams:
            raise ServingError(f"numBeams must be in [1, {max_beams}]")
        # deadline: body deadlineMs wins, then the config default; absolute
        # monotonic time from here on
        deadline_ms = _float(body, "deadlineMs", self.config.default_deadline_ms)
        deadline = None
        if deadline_ms is not None:
            if deadline_ms <= 0:
                raise ServingError(f"deadlineMs must be > 0, got {deadline_ms}")
            deadline = time.monotonic() + deadline_ms / 1e3
        # tenant resolution: unknown names are a client error, not a shed —
        # quota isolation is meaningless if anyone can mint a tenant
        raw_tenant = str(body.get("tenant") or "").strip()
        tenant, adapter = DEFAULT_TENANT, ""
        if self._tenancy is not None:
            try:
                tspec = self._tenancy.resolve(raw_tenant)
            except KeyError:
                raise ServingError(f"unknown tenant {raw_tenant!r}")
            tenant, adapter = tspec.name, tspec.adapter
        elif raw_tenant and raw_tenant != DEFAULT_TENANT:
            raise ServingError(
                f"unknown tenant {raw_tenant!r}: this server has no tenants configured"
            )
        if adapter and (num_beams > 1 or not self.config.batching):
            raise ServingError(
                "adapter-bound tenants require the coalesced decode path "
                "(no beam search, batching enabled)"
            )
        # disaggregated handoff: the router names a decode replica for a
        # prefill-role replica to ship the finished page set to
        handoff_target, handoff_epoch = "", 0
        if self.config.role == "prefill":
            handoff_target = str(body.get("handoffTarget") or "").strip()
            try:
                handoff_epoch = int(body.get("handoffEpoch") or 0)
            except (TypeError, ValueError):
                handoff_epoch = 0
        return {
            "tenant": tenant,
            "adapter": adapter,
            "arr": arr,
            "max_new": max_new,
            "temperature": temperature,
            "top_k": _int(body, "topK", None),
            "eos_id": eos,
            "seed": _int(body, "seed", 0),
            "deadline": deadline,
            "num_beams": num_beams,
            "length_penalty": _float(body, "lengthPenalty", 1.0),
            "handoff_target": handoff_target,
            "handoff_epoch": handoff_epoch,
        }

    def _make_requests(self, req: dict, rid: Optional[str] = None) -> list:
        """One PendingRequest PER ROW — rows of a multi-row body may land in
        different buckets and coalesce with different peers. Row i samples
        from seed + i, so identical rows still diverge."""
        seq_len = int(self.module.cfg.seq_len)
        # decode mode: constant per server, but part of the group key so
        # mixed-mode groups never form. With the adaptive controller the
        # draft width (and whether the group speculates at all) is its
        # CURRENT decision; in-flight groups keep their admitted key
        spec_on = bool(self.config.speculate)
        eff_k = int(self.config.draft_tokens) if spec_on else 0
        if spec_on and self._spec_controller is not None:
            eff_k = int(self._spec_controller.window_k())
            spec_on = eff_k > 0
            self._m_spec_effective_k.set(eff_k)
        mode = dict(speculate=spec_on, draft_tokens=eff_k,
                    quantize=bool(self.config.quantize))
        adapter = req.get("adapter") or ""
        out = []
        try:
            for i, row in enumerate(req["arr"]):
                tokens = [int(t) for t in row]
                # adapter residency first: pin the tenant's adapter slot for
                # this row — may load it or restore it from spill (timed
                # into the load histogram), may shed "adapter_capacity"
                # when every slot is pinned by in-flight rows
                slot = 0
                if adapter:
                    t0a = _now()
                    try:
                        slot, loaded = self._adapter_registry.acquire(adapter)
                    except KeyError:
                        raise ServingError(f"unknown adapter {adapter!r}")
                    if loaded:
                        self._m_adapter_load.observe((_now() - t0a) * 1e3)
                plan = None
                try:
                    if self._kv is not None:
                        # paged admission: prefix lookup + suffix bucketing
                        # + page reservation (may shed "kv_pages")
                        plan = self._kv.plan_row(
                            tokens, req["max_new"], self._prompt_ladder,
                            self._new_ladder, seq_len, namespace=adapter or "",
                            trace=req.get("trace"),
                        )
                        pb, nb, L = plan.suffix_bucket, plan.new_bucket, plan.prefix_len
                    else:
                        pb, nb = choose_buckets(
                            len(tokens), req["max_new"], self._prompt_ladder,
                            self._new_ladder, seq_len,
                        )
                        L = 0
                except BaseException:
                    if adapter:
                        self._adapter_registry.release(adapter)
                    raise
                key = GroupKey(
                    prompt_bucket=pb, new_bucket=nb,
                    temperature=req["temperature"], top_k=req["top_k"],
                    eos_id=req["eos_id"], prefix_len=L, **mode,
                )
                r = PendingRequest(
                    tokens=tokens, prompt_len=len(tokens), max_new=req["max_new"],
                    seed=req["seed"] + i, key=key, deadline=req["deadline"],
                    kv_plan=plan, t0=_now(), request_id=rid, row=i,
                    tenant=req["tenant"], adapter=adapter, adapter_slot=slot,
                    trace=req.get("trace"),
                    handoff_target=req.get("handoff_target") or None,
                    handoff_epoch=int(req.get("handoff_epoch") or 0),
                )
                if plan is not None or adapter:
                    # on ANY terminal path the row's pages, reservation and
                    # prefix refs return to the pool and its adapter slot
                    # unpins (finish() and release() are both idempotent)
                    r.on_finish = self._release_row
                out.append(r)
        except ServingError:
            # row k failed admission: rows 0..k-1 already hold reservations
            for r in out:
                self._release_row(r)
            raise
        return out

    def _release_row(self, r: PendingRequest) -> None:
        if r.kv_plan is not None and self._kv is not None:
            self._kv.release(r.kv_plan)
        if r.adapter and self._adapter_registry is not None:
            self._adapter_registry.release(r.adapter)

    # ------------------------------------------------------------ compute
    def _execute_group(self, batch: list):
        """Dense bucketed path: ONE coalesced group (same GroupKey) through
        `generate` with left-padded prompts, `prompt_lengths` and per-row
        seeds — or, for a speculative group, through `spec_generate`'s
        verify windows (n-gram drafts, or the draft model), which gives the
        same tokens; rows scatter back truncated to what each asked for."""
        key = batch[0].key
        n = len(batch)
        # chaos points: "sleep" on serving.slow injects decode latency,
        # "raise" on serving.decode fails the batch (breaker material)
        inject("serving.slow", rows=n)
        inject("serving.decode", rows=n)
        for r in batch:
            self._observe_queue_wait(r)
        self._m_occupancy.observe(n)
        self._m_batches.inc()
        gid, td = self._trace_group(batch)
        P = key.prompt_bucket
        arr = np.zeros((n, P), np.int64)
        lengths = np.zeros((n,), np.int64)
        for i, r in enumerate(batch):
            arr[i, P - r.prompt_len:] = r.tokens
            lengths[i] = r.prompt_len
        seeds = [r.seed for r in batch]
        new = max(r.max_new for r in batch)
        stats: dict = {}
        ix = self._adapter_ix(batch)
        with self._lock:
            if key.speculate:
                drafter = None
                if self._draft_module is not None:
                    drafter = self._make_drafter(arr, lengths, seeds, key)
                out = spec_generate(
                    self.module, arr, max_new_tokens=new, draft_tokens=key.draft_tokens,
                    temperature=key.temperature, top_k=key.top_k, eos_id=key.eos_id,
                    seeds=seeds, prompt_lengths=lengths, stats=stats, drafter=drafter,
                    adapter_ix=ix,
                )
            else:
                out = generate(
                    self.module, torch.from_numpy(arr), max_new_tokens=new,
                    temperature=key.temperature, top_k=key.top_k, eos_id=key.eos_id,
                    seed=seeds, prompt_lengths=torch.from_numpy(lengths),
                    adapter_ix=ix,
                )
            out = out.cpu().numpy()
        tnow = _now()
        for i, r in enumerate(batch):
            pad = P - r.prompt_len
            # no incremental emission here: TTFT is the whole decode
            self._m_ttft.observe((tnow - r.t0) * 1e3)
            r.first_token_at = tnow
            r.finish(result=out[i, pad:pad + r.prompt_len + r.max_new].tolist())
            if r.trace is not None:
                # one fused prefill + decode call: the whole dispatch is one
                # decode span (a speculative group's carries its accounting)
                end = r.finished_t if r.finished_t is not None else _now()
                extra = ({k: int(stats.get(k, 0)) for k in ("proposed", "accepted", "rollback")}
                         if key.speculate else {"steps": key.new_bucket})
                r.trace.add("decode", start=td, dur_s=end - td, group=gid, rows=n,
                            row=r.row, **extra)
        if key.speculate:
            self._spec_observe(stats)
        else:
            self._spec_tick_plain(new)
        self._m_requests.inc(n)

    # ------------------------------------------------------ speculative decode
    def _spec_observe(self, stats: dict) -> None:
        proposed = int(stats.get("proposed", 0))
        accepted = int(stats.get("accepted", 0))
        self._m_spec_proposed.inc(proposed)
        self._m_spec_accepted.inc(accepted)
        self._m_spec_rollback.inc(int(stats.get("rollback", 0)))
        self._m_spec_truncated.inc(int(stats.get("truncated", 0)))
        if self._spec_controller is not None and proposed:
            # the controller reads the truncation-CORRECTED accepts: the
            # committed count deflates near maxNewTokens
            self._spec_controller.observe(
                proposed, int(stats.get("accepted_judged", accepted)),
                accepted_raw=accepted,
            )
            self._m_spec_effective_k.set(self._spec_controller.window_k())

    def _spec_tick_plain(self, steps: int) -> None:
        """Logical plain-decode progress: while the controller has
        speculation auto-disabled, these ticks drive its re-probe."""
        if self._spec_controller is not None and steps > 0:
            self._spec_controller.tick_plain(int(steps))
            self._m_spec_effective_k.set(self._spec_controller.window_k())

    def _make_drafter(self, prompts, lengths, seeds, key: GroupKey) -> ModelDrafter:
        """A batched ModelDrafter over left-padded prompts (call under the
        lock: its constructor runs the draft prefill)."""
        return ModelDrafter(self._draft_module, prompts, lengths, seeds=seeds,
                            temperature=key.temperature, top_k=key.top_k)

    @staticmethod
    def _emit(r: PendingRequest, toks) -> None:
        if len(toks) and r.on_tokens is not None:
            try:
                r.on_tokens([int(t) for t in toks])
            except Exception:  # noqa: BLE001 — a dead client stays local
                pass

    def _execute_group_paged(self, batch: list):
        """Paged decode for one coalesced group: prefill the suffixes
        through the page tables (a shared prefix is already in the pool),
        then decode — in `stream_chunk_tokens` chunks, or for a speculative
        group in verify windows — streaming the tokens out. Tokens equal
        the dense bucketed path's; the pool is one fixed allocation instead
        of per-group worst-case caches, and the first token leaves after
        prefill, not after the whole decode."""
        kv = self._kv
        key = batch[0].key
        n = len(batch)
        inject("serving.slow", rows=n)
        inject("serving.decode", rows=n)
        for r in batch:
            self._observe_queue_wait(r)
        self._m_occupancy.observe(n)
        self._m_batches.inc()
        gid, td = self._trace_group(batch)
        L, pb, nb = key.prefix_len, key.prompt_bucket, key.new_bucket
        n_pages = kv.layout.pages_for(L + pb + nb - 1)
        plans = [r.kv_plan for r in batch]
        traces = [r.trace for r in batch]
        arr = np.zeros((n, pb), np.int64)
        pads = np.zeros((n,), np.int64)
        for i, r in enumerate(batch):
            sfx = r.tokens[L:]
            arr[i, pb - len(sfx):] = sfx
            pads[i] = pb - len(sfx)
        kv.ensure_pages(plans, upto_slot=L + pb, traces=traces)
        tables = kv.tables(plans, n, n_pages)
        with self._lock:
            # land queued spill restores before the prefill reads the
            # restored prefix pages
            kv.flush_restores()
            tok = paged_prefill(
                self.module, kv.cache, arr, pad=pads, pages=tables, kv_layout=kv.layout,
                prefix_len=L, temperature=key.temperature, top_k=key.top_k,
                seeds=[r.seed for r in batch], adapter_ix=self._adapter_ix(batch),
            )
            first = tok.cpu().tolist()
        tnow = _now()
        gen = [[t] for t in first]
        for i, r in enumerate(batch):
            r.first_token_at = tnow
            self._m_ttft.observe((tnow - r.t0) * 1e3)
            if r.trace is not None:
                r.trace.add("prefill", start=td, dur_s=tnow - td, group=gid, row=r.row,
                            prefix_len=L, suffix_bucket=pb)
            self._emit(r, [first[i]])
        decode = self._paged_windows if key.speculate else self._paged_chunks
        decode(batch, gen, tok, pads, n_pages, gid, tnow)
        # index each row's page-aligned prompt prefix BEFORE finish()
        # releases the pages — the next request with this prefix skips it
        th0 = _now()
        try:
            with self._lock:
                kv.harvest([(r.tokens, r.kv_plan, int(pads[i]), r.trace)
                            for i, r in enumerate(batch)])
        except Exception:  # noqa: BLE001 — cache warmth must not fail rows
            traceback.print_exc()
        th1 = _now()
        for i, r in enumerate(batch):
            if r.trace is not None:
                r.trace.add("kv_harvest", start=th0, dur_s=th1 - th0, group=gid, row=r.row)
            r.finish(result=list(r.tokens) + gen[i][: r.max_new])
        self._m_requests.inc(n)

    def _paged_chunks(self, batch: list, gen: list, tok, pads, n_pages: int,
                      gid: int, t_prev: float) -> None:
        """The plain decode of a paged group after its prefill: chunks of
        `stream_chunk_tokens` steps, each chunk's tokens streamed out and
        traced as one decode span (the spans tile the decode region)."""
        kv = self._kv
        key = batch[0].key
        n = len(batch)
        plans = [r.kv_plan for r in batch]
        common = dict(kv_layout=kv.layout, prefix_len=key.prefix_len,
                      temperature=key.temperature, top_k=key.top_k,
                      seeds=[r.seed for r in batch], adapter_ix=self._adapter_ix(batch))
        done = torch.zeros(n, dtype=torch.bool, device=tok.device)
        pos, g = key.prefix_len + key.prompt_bucket, 1
        remaining = max(r.max_new for r in batch) - 1
        chunk_cap = max(1, int(self.config.stream_chunk_tokens))
        early_eos = False
        traces = [r.trace for r in batch]
        window = 0
        while remaining > 0:
            steps = min(chunk_cap, remaining)
            kv.ensure_pages(plans, upto_slot=pos + steps, traces=traces)
            tables = kv.tables(plans, n, n_pages)
            t0 = _now()
            with self._lock:
                toks, done = paged_decode_chunk(
                    self.module, kv.cache, tok, done, steps=steps, pos=pos,
                    start_g=g, pad=pads, pages=tables, eos_id=key.eos_id, **common,
                )
                toks_host = toks.cpu().tolist()
                all_done = key.eos_id is not None and bool(done.all())
            self._m_decode_step.observe((_now() - t0) * 1e3 / steps)
            self._spec_tick_plain(steps)
            for i, r in enumerate(batch):
                fresh = toks_host[i][: max(0, r.max_new - len(gen[i]))]
                gen[i].extend(fresh)
                self._emit(r, fresh)
            t_new = _now()
            for r in batch:
                if r.trace is not None:
                    r.trace.add("decode", start=t_prev, dur_s=t_new - t_prev, group=gid,
                                row=r.row, window=window, steps=steps)
            t_prev, window = t_new, window + 1
            tok = toks[:, -1]
            pos, g, remaining = pos + steps, g + steps, remaining - steps
            if all_done:
                # every row latched eos: the remaining samples are pinned
                # to eos_id — emit them host-side
                early_eos = True
                break
            if all(r.cancelled for r in batch):
                # every client vanished mid-stream: stop decoding rows
                # nobody will read (finish() then releases their pages)
                break
        if early_eos:
            for i, r in enumerate(batch):
                fill = [int(key.eos_id)] * (r.max_new - len(gen[i]))
                gen[i].extend(fill)
                self._emit(r, fill)

    def _paged_windows(self, batch: list, gen: list, tok, pads, n_pages: int,
                       gid: int, t_prev: float) -> None:
        """The speculative decode of a paged group after its prefill:
        verify windows through the page tables. Rows accept different
        lengths, so each row keeps its own write frontier and generation
        index, and each window streams the tokens it committed."""
        kv = self._kv
        key = batch[0].key
        n = len(batch)
        K = int(key.draft_tokens)
        L, pb = key.prefix_len, key.prompt_bucket
        # drafters over the FULL prompt (prefix included: that is where the
        # repetitive material usually is); a draft model keeps one batched
        # dense cache over prefix + suffix bucket, so its frontier
        # (base + g - 1) is the paged pos
        drafter = None
        if self._draft_module is not None:
            dprompts = np.zeros((n, L + pb), np.int64)
            dlens = np.array([len(r.tokens) for r in batch], np.int64)
            for i, r in enumerate(batch):
                dprompts[i, L + pb - len(r.tokens):] = r.tokens
            with self._lock:
                drafter = self._make_drafter(dprompts, dlens, [r.seed for r in batch], key)
        rows = [
            SimpleNamespace(
                tok=gen[i][0], pos=L + pb, g=1, done=False, remaining=r.max_new - 1,
                gen=gen[i], pad=int(pads[i]), L=L,
                drafter=None if drafter else NgramDrafter(r.tokens + [gen[i][0]]),
            )
            for i, r in enumerate(batch)
        ]
        for r, st in zip(batch, rows):
            if key.eos_id is not None and st.tok == key.eos_id:
                # everything after a generated eos is pinned: emit it
                # host-side and retire the row
                fill = [int(key.eos_id)] * st.remaining
                st.gen.extend(fill)
                self._emit(r, fill)
                st.remaining = 0
        plans = [r.kv_plan for r in batch]
        totals = dict.fromkeys(
            ("proposed", "accepted", "accepted_judged", "truncated", "rollback"), 0
        )
        window = 0
        while any(st.remaining > 0 for st in rows):
            fed = np.empty((n, K + 1), np.int64)
            fed[:, 0] = [st.tok for st in rows]
            if drafter is not None:
                with self._lock:
                    fed[:, 1:] = drafter.propose(fed[:, 0], np.array([st.g for st in rows]), K)
            for i, st in enumerate(rows):
                if st.remaining <= 0:
                    fed[i, 1:] = st.tok
                elif drafter is None:
                    fed[i, 1:] = st.drafter.propose(K)
            kv.ensure_pages(plans, upto_slot=max(st.pos for st in rows) + K + 1,
                            traces=[r.trace for r in batch])
            delta = self._verify_window(batch, rows, fed, kv.tables(plans, n, n_pages))
            for k in totals:
                totals[k] += delta[k]
            t_new = _now()
            for r in batch:
                if r.trace is not None:
                    r.trace.add("verify", start=t_prev, dur_s=t_new - t_prev, group=gid,
                                row=r.row, window=window, proposed=delta["proposed"],
                                accepted=delta["accepted"], rollback=delta["rollback"])
            t_prev, window = t_new, window + 1
            if all(r.cancelled for r in batch):
                break  # nobody reads these rows: finish() releases their pages
        self._spec_observe(totals)

    def _verify_window(self, batch: list, rows: list, fed, tables) -> dict:
        """One verify window of speculative rows (requests `batch`, their
        decode states `rows`: tok, pos, g, done, remaining, gen, pad, L and
        drafter) through the page tables: commit each row's accepted
        tokens, advance its state, stream what it committed (an eos hit
        pins the rest of the row to eos). Returns the window's counts."""
        kv = self._kv
        key = batch[0].key
        done = [st.done for st in rows]
        t0 = _now()
        with self._lock:
            targets, accept = spec_verify_paged(
                self.module, kv.cache, fed, done, [st.pad for st in rows], tables,
                [r.seed for r in batch], [st.pos for st in rows], [st.g for st in rows],
                kv_layout=kv.layout, prefix_lens=[st.L for st in rows],
                temperature=key.temperature, top_k=key.top_k, eos_id=key.eos_id,
                adapter_ix=self._adapter_ix(batch),
            )
        self._m_decode_step.observe((_now() - t0) * 1e3)
        committed, done, remaining, eos_hit, delta = commit_window(
            fed, targets, accept, [st.remaining for st in rows], done, key.eos_id,
        )
        for i, (r, st) in enumerate(zip(batch, rows)):
            toks = committed[i]
            if len(toks):
                st.gen.extend(int(t) for t in toks)
                self._emit(r, toks)
                if isinstance(st.drafter, NgramDrafter):
                    # a ModelDrafter's frontier follows g alone
                    st.drafter.extend(toks)
                st.tok = int(toks[-1])
                st.pos += len(toks)
                st.g += len(toks)
            st.done = bool(done[i])
            st.remaining = int(remaining[i])
            if eos_hit[i] and st.remaining > 0:
                fill = [int(key.eos_id)] * st.remaining
                st.gen.extend(fill)
                self._emit(r, fill)
                st.remaining = 0
        return delta

    def _dispatch_group(self, batch: list):
        key = batch[0].key
        if self._kv is not None and batch[0].kv_plan is not None:
            self._execute_group_paged(batch)
        else:
            self._execute_group(batch)

    def generate(self, body: dict) -> dict:
        """Synchronous single-caller path (also the test surface): validate,
        then run inline — bucketed and coalesced when batching is on (paged
        with a pool), the per-request exact shape otherwise."""
        req = self._validate(body)
        if req["num_beams"] > 1:
            # beam search has no pad or per-row-seed path: the exact [B, P]
            # shape, inline, as the reference runs it (never queued)
            with self._lock:
                out = beam_search(
                    self.module, torch.from_numpy(req["arr"]),
                    max_new_tokens=req["max_new"], num_beams=req["num_beams"],
                    length_penalty=req["length_penalty"], eos_id=req["eos_id"],
                )
            self._m_requests.inc(req["arr"].shape[0])
            return {"tokens": out.cpu().tolist()}
        if not self.config.batching:
            with self._lock:
                out = generate(
                    self.module, torch.from_numpy(req["arr"]),
                    max_new_tokens=req["max_new"], temperature=req["temperature"],
                    top_k=req["top_k"], eos_id=req["eos_id"], seed=req["seed"],
                )
            self._m_requests.inc(req["arr"].shape[0])
            return {"tokens": out.cpu().tolist()}
        rows = self._make_requests(req)
        by_key: dict = {}
        for r in rows:
            by_key.setdefault(r.key, []).append(r)
        try:
            for group in by_key.values():
                self._dispatch_group(group)
        except BaseException as e:
            for r in rows:  # rows not finished give their pages back
                r.finish(error=e)
            raise
        return {"tokens": [r.result for r in rows]}

    def handle_request(self, body: dict, request_id: Optional[str] = None) -> dict:
        """HTTP-path entry: producer side of the coalescer (the synchronous
        path when batching is off or the server is not started). End-to-end
        latency lands in the request-seconds histogram either way, with the
        request id as its exemplar; the request's trace lands in the ring."""
        rid = request_id or new_trace_id()
        trace = self._new_trace(rid)
        t0 = _now()
        error: Optional[BaseException] = None
        try:
            return self._handle_request(body, rid, trace)
        except BaseException as e:
            error = e
            raise
        finally:
            dur = _now() - t0
            self._m_latency.observe(dur, exemplar=rid)
            self._observe_body_latency(body, dur)
            self._finish_trace(trace, error)

    def _check_open(self) -> None:
        if self._draining:
            self._observe("shed", reason="draining")
            raise ServerClosingError("server draining: admission closed", reason="draining")

    def _submit(self, rows: list) -> None:
        """Submit every row; on a shed, release the unsubmitted rows' pages
        NOW, wait out the admitted ones (results discarded, their pages come
        back through on_finish) and re-raise — the client retries the body."""
        submitted = []
        try:
            for r in rows:
                r.submitted_t = _now()
                self._coalescer.submit(r)
                submitted.append(r)
        except ShedError:
            for r in rows:
                if r not in submitted:
                    self._release_row(r)
            for r in submitted:
                r.done.wait(self.config.request_timeout_s)
            raise

    def _handle_request(self, body: dict, rid: Optional[str] = None,
                        trace: Optional[RequestTrace] = None) -> dict:
        self._check_open()
        req = self._validate(body)
        req["rid"], req["trace"] = rid, trace
        if trace is not None and req.get("tenant"):
            trace.attrs["tenant"] = req["tenant"]
        if (self._coalescer is None or self._coalescer._thread is None
                or req["num_beams"] > 1):
            # synchronous path: decode starts immediately, so the only
            # deadline that can already be lost is the admission one
            if req["deadline"] is not None and time.monotonic() >= req["deadline"]:
                self._observe("shed", reason="deadline")
                raise ShedError("deadline already expired at admission", reason="deadline")
            if trace is None:
                return self.generate(body)
            t_sync = _now()
            trace.add("admission", start=trace.t0, dur_s=t_sync - trace.t0)
            out = self.generate(body)
            trace.add("decode", start=t_sync, dur_s=_now() - t_sync)
            return out
        rows = self._make_requests(req, rid)
        self._submit(rows)
        if trace is not None:
            # validate + kv plan + submit: the latency the queue_wait and
            # decode spans do not cover
            first = rows[0].submitted_t if rows else trace.t0
            trace.add("admission", start=trace.t0, dur_s=first - trace.t0)
        timeout = self.config.request_timeout_s
        for r in rows:
            if not r.done.wait(timeout):
                raise TimeoutError(f"decode did not complete within {timeout:.0f}s")
        # disaggregated handoff: prefill-role rows resolve with a sentinel
        # (page set exported, not yet shipped). Ship here, on the handler
        # thread. All shipped: a retryable 503 kv_handoff_done, which the
        # router replays on the decode replica. Any ship failed: re-run
        # those rows locally (the prefix is warm here; the decode side's
        # partial adoptions are evictable cache warmth, never a leak)
        pending = [r for r in rows if isinstance(r.error, _HandoffPrefillDone)]
        if pending:
            if all([self._handoff_ship(r) for r in pending]):
                self._observe("shed", reason="kv_handoff_done")
                raise ShedError("prefill complete: decode replica owns the KV",
                                reason="kv_handoff_done")
            for r in pending:
                r2 = self._handoff_rerun(req, r.row)
                r.result, r.error = r2.result, None
        for r in rows:
            if r.error is not None:
                raise r.error
        out = {"tokens": [r.result for r in rows]}
        if trace is not None:
            # scatter-back: the last row finishing → the response assembled
            done_t = max((r.finished_t for r in rows if r.finished_t is not None),
                         default=_now())
            trace.add("stream_flush", start=done_t, dur_s=_now() - done_t)
        return out

    # ----------------------------------------------------------- streaming
    def stream_request(self, body: dict, request_id: Optional[str] = None):
        """Streaming producer path (`POST /generate?stream=1`): yields one
        event dict per decoded chunk — `{"row": i, "tokens": [...]}` with
        newly generated tokens (prompt + concatenated chunks equals the
        non-streamed row), then `{"row": i, "done": true}` (or `{"row": i,
        "error": msg}`) per row, then `{"done": true}`. Admission errors
        (400/503/504) raise before the first event, so the HTTP layer can
        still set a status code; later failures become in-band events."""
        rid = request_id or new_trace_id()
        trace = self._new_trace(rid, stream=True)
        t0 = _now()
        error: Optional[BaseException] = None
        try:
            yield from self._stream_request(body, rid, trace)
        except BaseException as e:
            error = e
            raise
        finally:
            dur = _now() - t0
            self._m_latency.observe(dur, exemplar=rid)
            self._observe_body_latency(body, dur)
            self._finish_trace(trace, error)

    def _stream_request(self, body: dict, rid: Optional[str] = None,
                        trace: Optional[RequestTrace] = None):
        self._check_open()
        req = self._validate(body)
        req["rid"], req["trace"] = rid, trace
        if trace is not None and req.get("tenant"):
            trace.attrs["tenant"] = req["tenant"]
        if (self._kv is None or self._coalescer is None
                or self._coalescer._thread is None or req["num_beams"] > 1):
            # no incremental decode on this path: one terminal chunk per row
            # (same event shape, no partial delivery)
            out = self._handle_request(body, rid, trace)
            for i, row in enumerate(out["tokens"]):
                yield {"row": i, "tokens": row[len(req["arr"][i]):]}
                yield {"row": i, "done": True}
            yield {"done": True}
            return
        rows = self._make_requests(req, rid)
        events: _queue.Queue = _queue.Queue()
        for i, r in enumerate(rows):
            r.on_tokens = lambda toks, i=i: events.put({"row": i, "tokens": toks})
            release = r.on_finish

            def _finished(req_row, i=i, release=release):
                if release is not None:
                    release(req_row)
                events.put(
                    {"row": i, "done": True} if req_row.error is None
                    else {"row": i, "error": str(req_row.error)}
                )

            r.on_finish = _finished
        if rid is not None:
            self._stream_rows[rid] = rows
        try:
            self._submit(rows)
            if trace is not None:
                first = rows[0].submitted_t if rows else trace.t0
                trace.add("admission", start=trace.t0, dur_s=first - trace.t0)
            pending = len(rows)
            while pending:
                try:
                    ev = events.get(timeout=self.config.request_timeout_s)
                except _queue.Empty:
                    raise TimeoutError(
                        f"decode did not complete within "
                        f"{self.config.request_timeout_s:.0f}s"
                    ) from None
                evs = [ev]
                if "error" in ev and isinstance(rows[ev["row"]].error, _HandoffPrefillDone):
                    # ship the exported page set now: shipped → an in-band
                    # error frame the router replays on the decode replica
                    # (trimming what was sent); failed → local fallback
                    evs = self._handoff_stream_resolve(req, rows[ev["row"]])
                for ev in evs:
                    if "done" in ev or "error" in ev:
                        pending -= 1
                    yield ev
            if trace is not None:
                done_t = max((r.finished_t for r in rows if r.finished_t is not None),
                             default=_now())
                trace.add("stream_flush", start=done_t, dur_s=_now() - done_t)
            yield {"done": True}
        finally:
            if rid is not None:
                self._stream_rows.pop(rid, None)

    def cancel_stream(self, rid: str) -> int:
        """Cancel a live streamed request's unfinished rows — called by the
        HTTP layer on a broken pipe. The coalescer or step scheduler notice
        the flag at their next sweep and evict the rows; `on_finish`
        releases their KV pages. Returns the number of rows cancelled."""
        rows = self._stream_rows.get(rid)
        if not rows:
            return 0
        n = 0
        for r in rows:
            if not r.done.is_set():
                r.cancel()
                n += 1
        if n:
            self._m_client_disconnects.inc()
        return n

    # --------------------------------------------------------- readiness
    def readiness(self) -> tuple:
        """(ready, reason) for /readyz; lands on the serving.ready gauge."""
        if self._httpd is None or self._draining:
            ready, reason = False, "draining" if self._draining else "stopped"
        elif self.expected_devices is not None:
            ready, reason = self._device_health()
        else:
            ready, reason = True, "ok"
        self._m_ready.set(1 if ready else 0)
        return ready, reason

    def _device_health(self) -> tuple:
        """`check_slice` against `expected_devices`, cached for 5 s. On a
        decode mesh its all-reduce is a command of the mesh (every rank
        runs it in the commands' order, never beside a step); one device
        without a mesh is one device."""
        from ..runtime.health import SliceHealthError

        now = time.monotonic()
        if self._health_cache is not None and now - self._health_cache[0] < 5.0:
            return self._health_cache[1], self._health_cache[2]
        try:
            n = self.module.health()["devices"] if self._world is not None else 1
            if n < self.expected_devices:
                raise SliceHealthError(f"expected {self.expected_devices} devices, found {n}")
            out = (True, f"ok ({n} devices)")
        except Exception as e:  # noqa: BLE001 — a failed probe is a degraded slice
            out = (False, f"degraded slice: {e}")
        self._health_cache = (now, out[0], out[1])
        return out

    def kv_heads(self) -> dict:
        """GET /kvz: the prefix chain hashes this replica can serve warm
        (in the pool or spilled), keyed by the pool's page size so the
        router hashes prompts the same way, and its role. `namespaces` maps
        each tenant whose rows decode with an adapter to that adapter: its
        chains are seeded with it (`plan_row`'s namespace), so the router
        hashes that tenant's prompts in it. A tenant not listed hashes in
        the base namespace."""
        namespaces = {}
        if self._tenancy is not None:
            for name in self._tenancy.known():
                adapter = self._tenancy.resolve(name).adapter
                if adapter:
                    namespaces[name] = adapter
        if self._kv is None:
            return {"enabled": False, "pageTokens": 0, "heads": [],
                    "role": self.config.role, "namespaces": namespaces}
        return {"enabled": self._kv.prefix is not None,
                "pageTokens": self._kv.layout.page_tokens,
                "heads": self._kv.advertised_heads(), "role": self.config.role,
                "namespaces": namespaces}

    @staticmethod
    def _pct(summary: dict, scale: float = 1.0) -> dict:
        return {
            k: round(summary[k] * scale, 3) if summary[k] is not None else None
            for k in ("p50", "p95", "p99", "mean")
        }

    def stats(self) -> dict:
        batches = rows = 0
        resilience = {}
        c = self._coalescer
        if c is not None:
            batches, rows = c.batches_run, c.rows_run
            resilience = {
                "queue_depth": c.depth,
                "max_queue": c.max_queue,
                "shed": int(self._m_shed.value),
                "deadline_exceeded": int(self._m_deadline.value),
                "worker_restarts": c.worker_restarts,
                "breaker": c.breaker.state if c.breaker else "disabled",
                "draining": self._draining,
            }
        ttft = self._pct(self._m_ttft.summary())
        kv = {"enabled": False}
        if self._kv is not None:
            kv = {"enabled": True, **self._kv.stats(), "ttft_ms": ttft}
            if self._world is not None:  # the pages stay whole-model
                kv["kv_pool_bytes_per_rank"] = self._kv.rank_pool_bytes()
        mesh = {"enabled": False, "devices": 1}
        if self._world is not None:
            w = self._world
            mesh = {"enabled": w.size > 1, "devices": w.size,
                    "axes": {k: int(v) for k, v in w.sizes.items()},
                    "commands": dict(w.ops)}
        chunked = {"enabled": False}
        if isinstance(c, StepScheduler):
            chunked = {
                "enabled": True,
                "prefill_chunk_tokens": int(self.config.prefill_chunk_tokens),
                "max_step_tokens": int(self.config.max_step_tokens),
                "steps": c.steps_run,
                "prefill_only_steps": c.prefill_only_steps,
                "classic_forced_steps": c.classic_forced_steps,
                "prefill_chunks": int(self._m_prefill_chunks.value),
                "prefill_queue_depth": c.prefill_queue_depth,
                "evicted_midflight": c.evicted_midflight,
                "step_tokens": self._pct(self._m_step_tokens.summary()),
            }
        proposed = int(self._m_spec_proposed.value)
        accepted = int(self._m_spec_accepted.value)
        truncated = int(self._m_spec_truncated.value)
        ctl = self._spec_controller
        speculation = {
            "enabled": bool(self.config.speculate),
            "draft_tokens": int(self.config.draft_tokens),
            "proposed": proposed,
            "accepted": accepted,
            "truncated": truncated,
            "rollbacks": int(self._m_spec_rollback.value),
            # the raw rate counts COMMITTED accepts; the corrected one
            # re-credits accepts the maxNewTokens budget cut (what the
            # adaptive controller steers on)
            "accept_rate": round(accepted / proposed, 4) if proposed else None,
            "accept_rate_raw": round(accepted / proposed, 4) if proposed else None,
            "accept_rate_corrected": (
                round((accepted + truncated) / proposed, 4) if proposed else None
            ),
            "adaptive": ctl is not None,
            "effective_k": int(self._m_spec_effective_k.value),
            "auto_disabled": bool(ctl is not None and ctl.auto_disabled),
            "draft_model": None if self._draft_module is None else {
                "n_layers": int(self._draft_module.cfg.n_layers),
                "derived": bool(self._draft_derived),
            },
        }
        if ctl is not None:
            speculation["controller"] = ctl.stats()
        quant = {"enabled": bool(self.config.quantize),
                 "bytes_saved": int(self._quant_bytes_saved)}
        tenancy = {"enabled": self._tenancy is not None}
        if self._tenancy is not None:
            tenancy["tenants"] = self._tenancy.snapshot()
        if self._adapter_registry is not None:
            tenancy["adapters"] = self._adapter_registry.stats()
            tenancy["adapter_spill"] = self._adapter_spill.stats()
        # in-transit exports count as held work (they gate drain), never as
        # leaked pages
        handoff = {
            "role": self.config.role,
            "inflight": int(self._handoff_inflight),
            "exports": int(self._m_handoff_exports.value),
            "imports": int(self._m_handoff_imports.value),
            "rejected": int(self._m_handoff_rejected.value),
            "fallbacks": int(self._m_handoff_fallbacks.value),
            "bytes": int(self._m_handoff_bytes.value),
            "leases": self._lease_table.stats(),
        }
        slo = (self.slo_engine.to_dict() if self.slo_engine is not None
               else {"enabled": False, "breached": False, "slos": []})
        if self.flight_recorder is not None:
            slo["flight_recorder_dumps"] = self.flight_recorder.dumps
        return {
            "tenancy": tenancy,
            "handoff": handoff,
            "kv": kv,
            "speculation": speculation,
            "quant": quant,
            "chunked": chunked,
            **resilience,
            "batching": bool(self.config.batching),
            "requests": self.requests_served,
            "batches": batches,
            "mean_batch_occupancy": round(rows / batches, 3) if batches else None,
            "latency_ms": self._pct(self._m_latency.summary(), 1e3),
            "queue_wait_ms": self._pct(self._m_queue_wait.summary(), 1e3),
            "ttft_ms": ttft,
            "decode_step_ms": self._pct(self._m_decode_step.summary()),
            "prompt_buckets": list(self._prompt_ladder),
            "max_new_buckets": list(self._new_ladder),
            "max_batch": self.config.max_batch,
            "max_wait_ms": self.config.max_wait_ms,
            "tracing": {"enabled": bool(self.config.trace), **self.traces.stats()},
            "slo": slo,
            "mesh": mesh,
        }

    # ------------------------------------------------------------ http
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve in a background thread; returns the bound port."""
        if self.is_follower:
            raise RuntimeError("rank 0 serves a decode mesh; its followers run follow()")
        server = self
        if self._coalescer is not None:
            self._coalescer.start()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict, headers: dict = None,
                      rid: str = None):
                if rid is not None:
                    payload = {**payload, "requestId": rid}
                    headers = {**(headers or {}), "X-Request-Id": rid}
                self._send_raw(code, json.dumps(payload).encode(),
                               "application/json", headers)

            def _send_raw(self, code: int, data: bytes, ctype: str, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    self._send(200, {"status": "ok", "model": server.model_name,
                                     "step": server.step})
                elif path == "/readyz":
                    ready, reason = server.readiness()
                    # the role rides readiness (on the 503 too), so the
                    # router learns pool membership from its probe
                    self._send(200 if ready else 503,
                               {"ready": ready, "reason": reason,
                                "role": server.config.role})
                elif path == "/statsz":
                    self._send(200, server.stats())
                elif path == "/metricsz":
                    # scrape-time refresh of the queue gauges
                    if server._coalescer is not None:
                        server._m_queue_depth.set(server._coalescer.depth)
                        pq = getattr(server._coalescer, "prefill_queue_depth", None)
                        if pq is not None:
                            server._m_prefill_queue.set(pq)
                    self._send_raw(200, server.telemetry.render_prometheus().encode(),
                                   "text/plain; version=0.0.4")
                elif path == "/kvz":
                    self._send(200, server.kv_heads())
                elif path == "/tracez":
                    self._send(*tracez_payload(server.traces, query))
                elif path == "/sloz":
                    self._send(200, server.slo_engine.to_dict()
                               if server.slo_engine is not None
                               else {"enabled": False, "breached": False, "slos": []})
                elif path == "/queryz":
                    # windowed queries over the metrics history; 503 when off
                    self._send(*queryz_payload(server.history, query))
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def _stream(self, body, rid):
                """SSE response: one `data: <json>` frame per event. The
                first event is pulled BEFORE the headers go out, so
                admission failures still map to real status codes;
                mid-stream failures become an in-band error frame."""
                gen = server.stream_request(body, request_id=rid)
                first = next(gen)  # admission errors raise here
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-store")
                self.send_header("Connection", "close")
                self.send_header("X-Request-Id", rid)
                self.end_headers()
                try:
                    for ev in itertools.chain((first,), gen):
                        ev = {**ev, "requestId": rid}
                        self.wfile.write(b"data: " + json.dumps(ev).encode() + b"\n\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    # the client went away mid-stream: cancel its rows so
                    # the scheduler evicts them and their pages come back
                    server.cancel_stream(rid)
                except Exception as e:  # noqa: BLE001 — in-band, then close
                    try:
                        self.wfile.write(b"data: " + json.dumps(
                            {"error": str(e), "requestId": rid}).encode() + b"\n\n")
                    except OSError:
                        pass
                finally:
                    gen.close()

            def _kv_import(self):
                """POST /kv_import: adopt a prefill replica's exported page
                set. The taxonomy the exporter's HandoffClient keys on: 400
                malformed bytes or a hash-chain mismatch (final), 409 a
                stale epoch (a newer owner exists), 503 shed (reason
                kv_handoff: no headroom), 200 with the adopted page count.
                Every abort path releases the lease, so a higher-epoch
                retry proceeds."""
                rid = (self.headers.get("X-Handoff-Id") or "").strip()[:128] or None
                server._m_http.inc()
                kv = server._kv
                if kv is None or kv.prefix is None:
                    server._m_handoff_rejected.inc()
                    self._send(400, {"error": "no prefix cache on this replica",
                                     "reason": "rejected"}, rid=rid)
                    return
                try:
                    epoch = int(self.headers.get("X-Handoff-Epoch") or 0)
                except ValueError:
                    epoch = 0
                lease = None
                try:
                    data = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                    t0 = _now()  # the adopt's host time: parse, verify, adopt
                    # chaos: a fault in the import window must adopt fully
                    # or not at all; the exporter sees a clean failure
                    inject("serving.kv_import", rid=rid, epoch=epoch, size=len(data))
                    payload = payload_from_wire(data)
                    ns = payload.namespace
                    if ns and ns not in server._adapter_sources:
                        raise HandoffError(f"unknown prefix namespace {ns!r}")
                    want = page_hashes(list(payload.tokens), kv.layout.page_tokens,
                                       kv.prefix.hash_fn, ns)
                    if list(want) != list(payload.hashes):
                        raise HandoffError(
                            "content-hash chain does not match the prompt tokens"
                        )
                    lease = server._lease_table.acquire(rid or "anon", epoch)
                    adopted = kv.adopt_pages(payload)
                    adopt_ms = (_now() - t0) * 1e3
                    server._m_handoff_adopt.observe(adopt_ms)
                    if server._lease_table.complete(lease):
                        # the adopt's host ms rides back, so the exporter's
                        # kv_handoff span splits its ship into wire and adopt
                        self._send(200, {"adopted_pages": int(adopted), "adopt_ms": adopt_ms},
                                   rid=rid)
                    else:
                        # preempted mid-adopt by a higher epoch: the newer
                        # owner's adoption is authoritative, ours is
                        # evictable cache warmth; this exporter stands down
                        server._m_handoff_rejected.inc()
                        self._send(409, {"error": "preempted mid-adopt",
                                         "reason": "stale_epoch"}, rid=rid)
                except StaleLeaseError as e:
                    server._m_handoff_rejected.inc()
                    self._send(409, {"error": str(e), "reason": "stale_epoch"}, rid=rid)
                except HandoffError as e:
                    server._m_handoff_rejected.inc()
                    self._send(400, {"error": str(e), "reason": "rejected"}, rid=rid)
                except ShedError as e:
                    if lease is not None:
                        server._lease_table.release(lease)
                    server._m_http_err.inc()
                    self._send(503, {"error": str(e), "reason": e.reason},
                               headers={"Retry-After": str(max(1, int(round(e.retry_after_s))))},
                               rid=rid)
                except Exception as e:  # noqa: BLE001 — surface, keep serving
                    if lease is not None:
                        server._lease_table.release(lease)
                    server._m_http_err.inc()
                    self._send(500, {"error": f"{type(e).__name__}: {e}",
                                     "reason": "internal"}, rid=rid)

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path == "/kv_import":
                    self._kv_import()
                    return
                if path != "/generate":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                rid = (self.headers.get("X-Request-Id") or "").strip()[:128] or _new_request_id()
                want_stream = "stream=1" in query.split("&")
                server._m_http.inc()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as e:
                        raise ServingError(f"body is not JSON: {e}")
                    if isinstance(body, dict):
                        # the router (or any proxy) forwards the tenant and
                        # the handoff target as headers; the body wins
                        tenant_hdr = (self.headers.get("X-Tenant") or "").strip()[:128]
                        if tenant_hdr:
                            body.setdefault("tenant", tenant_hdr)
                        target = (self.headers.get("X-Handoff-Target") or "").strip()[:256]
                        if target:
                            body.setdefault("handoffTarget", target)
                            body.setdefault("handoffEpoch",
                                            self.headers.get("X-Handoff-Epoch") or 0)
                    if want_stream and server.config.stream:
                        self._stream(body, rid)
                    else:
                        self._send(200, server.handle_request(body, request_id=rid), rid=rid)
                except ShedError as e:
                    # shed at admission: never queued, safe to retry later
                    server._m_http_err.inc()
                    self._send(503, {"error": str(e), "reason": e.reason},
                               headers={"Retry-After": str(max(1, int(round(e.retry_after_s))))},
                               rid=rid)
                except DeadlineExceededError as e:
                    server._m_http_err.inc()
                    self._send(504, {"error": str(e), "reason": "deadline_exceeded"}, rid=rid)
                except ServingError as e:
                    self._send(400, {"error": str(e), "reason": "invalid_request"}, rid=rid)
                except TimeoutError as e:
                    server._m_http_err.inc()
                    self._send(504, {"error": str(e), "reason": "timeout"}, rid=rid)
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    traceback.print_exc()
                    server._m_http_err.inc()
                    self._send(500, {"error": f"{type(e).__name__}: {e}",
                                     "reason": "internal"}, rid=rid)

        self._httpd = _Httpd((host, port), Handler)
        self._draining = False
        self._m_ready.set(1)
        for loop in (self.slo_engine, self.history_sampler, self.sentinel):
            if loop is not None:
                loop.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self, drain_grace_s: Optional[float] = None) -> None:
        """Graceful drain, then shutdown: close admission (new requests shed
        with a terminal 503), let the decode worker flush queued and
        in-flight work for up to the drain budget (config.drain_grace_s
        unless overridden) while the HTTP server still answers, fail what
        remains fast, then stop the HTTP server."""
        if self.is_follower:  # rank 0's stop ends the follower's loop
            return
        grace = self.config.drain_grace_s if drain_grace_s is None else drain_grace_s
        self._draining = True
        self._m_ready.set(0)
        # an export in flight holds pages the leak accounting cannot see
        # yet: drain does not report idle with a page set on the wire
        self._handoff_idle.wait(timeout=max(0.0, grace))
        for loop in (self.slo_engine, self.sentinel, self.history_sampler):
            if loop is not None:
                loop.stop()
        if self._coalescer is not None:
            self._coalescer.stop(drain_s=grace)
            # a restarted server gets a fresh worker (and breaker)
            self._coalescer = self._make_coalescer()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._world is not None:
            # the followers' loops end with rank 0's last command
            self._world.stop()
        self._draining = False  # a restarted server admits again


class _StepEngine:
    """`serving.steps.StepEngine` over the paged decode functions.

    Per-row state (suffix array, write frontier, sampling cursor, stream
    buffer) lives on `req.step` — the RowStep the scheduler reads plus
    engine-private fields — so a watchdog restart carries nothing over.
    Chunk slices feed the same left-padded suffix layout as one-shot
    prefill, the final slice samples generation index 0, and decode steps
    sample (seed, g) exactly like `paged_decode_chunk`, so a row's tokens
    equal the classic group path's. Speculative rows run verify windows in
    their own lanes (`_decode_spec`), each with its own drafter: lanes
    recompose every step, so a batched draft cache could not follow a row.
    Beam requests never reach the scheduler (`generate` runs them inline)."""

    def __init__(self, server: ModelServer):
        self._s = server

    def supports(self, r: PendingRequest) -> bool:
        return self._s._kv is not None and r.kv_plan is not None

    def begin(self, r: PendingRequest) -> None:
        s = self._s
        key = r.key
        # a speculative row verifies draft_tokens + 1 tokens a step
        st = RowStep(phase="prefill",
                     cost=(key.draft_tokens + 1) if key.speculate else 1)
        L, pb, nb = key.prefix_len, key.prompt_bucket, key.new_bucket
        sfx = r.tokens[L:]
        st.arr = np.zeros((1, pb), np.int64)
        if sfx:
            st.arr[0, pb - len(sfx):] = sfx
        st.pad = pb - len(sfx)
        st.L, st.pb, st.nb = L, pb, nb
        st.n_pages = s._kv.layout.pages_for(L + pb + nb - 1)
        st.chunk_w = min(max(1, int(s.config.prefill_chunk_tokens)), pb)
        st.off = 0
        st.next_chunk = min(st.chunk_w, pb)
        st.gen = None
        st.buf = []
        st.gid = next(s._group_seq)
        st.window = 0
        s._observe_queue_wait(r)
        st.t_prev = _now()
        if r.trace is not None:
            r.trace.set_group(st.gid)
            start = r.submitted_t if r.submitted_t is not None else r.trace.t0
            r.trace.add("queue_wait", start=start, dur_s=st.t_prev - start,
                        group=st.gid, row=r.row)
        r.step = st

    def prefill_chunk(self, r: PendingRequest) -> int:
        s = self._s
        kv = s._kv
        st = r.step
        key = r.key
        width = min(st.chunk_w, st.pb - st.off)
        final = st.off + width >= st.pb
        # chaos point: a fault here lands BETWEEN prefill chunks — the row
        # fails with its page table half-built and on_finish returns it all
        inject("serving.prefill_chunk", row=r.row, off=st.off)
        kv.ensure_pages([r.kv_plan], upto_slot=st.L + st.off + width, traces=[r.trace])
        table = kv.tables([r.kv_plan], 1, st.n_pages)
        with s._lock:
            # land queued spill restores before the chunk reads the restored
            # prefix pages
            kv.flush_restores()
            first = paged_prefill_chunk(
                s.module, kv.cache, st.arr[:, st.off:st.off + width], pad=[st.pad],
                pages=table, kv_layout=kv.layout, prefix_lens=[st.L],
                pos=st.L + st.off, temperature=key.temperature, top_k=key.top_k,
                seeds=[r.seed], final=final, adapter_ix=s._adapter_ix([r]),
            )
            first = None if first is None else int(first[0])
        st.off += width
        s._m_prefill_chunks.inc()
        tnow = _now()
        if r.trace is not None:
            r.trace.add("prefill", start=st.t_prev, dur_s=tnow - st.t_prev, group=st.gid,
                        row=r.row, chunk_off=st.off - width, chunk_tokens=width,
                        prefix_len=st.L, suffix_bucket=st.pb)
        st.t_prev = tnow
        if not final:
            st.next_chunk = min(st.chunk_w, st.pb - st.off)
            return width
        # the prefill boundary: the first sampled token leaves NOW — TTFT
        # does not wait for co-resident prompts
        r.first_token_at = tnow
        s._m_ttft.observe((tnow - r.t0) * 1e3)
        st.gen = [first]
        st.decode_t0 = tnow
        self._emit(r, [first])
        if key.eos_id is not None and first == key.eos_id:
            # everything after a generated eos is pinned: finish host-side
            fill = [int(key.eos_id)] * (r.max_new - 1)
            st.gen.extend(fill)
            self._emit(r, fill)
            self._finish_row(r)
        elif r.max_new <= 1:
            self._finish_row(r)
        elif not self._maybe_handoff(r, first):
            st.tok, st.done = first, False
            st.pos = st.L + st.pb
            st.g = 1
            if key.speculate:
                st.remaining = r.max_new - 1
                if s._draft_module is not None:
                    # a B=1 draft cache over the full prompt, padded to the
                    # row's bucketed width (its frontier is the paged pos)
                    dP = st.L + st.pb
                    dprompt = np.zeros((1, dP), np.int64)
                    dprompt[0, dP - len(r.tokens):] = r.tokens
                    with s._lock:
                        st.drafter = s._make_drafter(dprompt, [len(r.tokens)], [r.seed], key)
                else:
                    st.drafter = NgramDrafter(r.tokens + [first])
            st.phase = "decode"
        return width

    def _maybe_handoff(self, r: PendingRequest, first: int) -> bool:
        """The prefill-role exit. With a decode target named by the router,
        harvest the finished page set into the prefix cache (whose refs
        keep it alive through the transfer), capture its host bytes on the
        step's stream after the producing step (the rule of
        `_capture_mirror`) and resolve the row with the
        `_HandoffPrefillDone` sentinel — the HTTP handler thread runs the
        transfer, never this worker. Returns False (decode here) when no
        target was named or the capture fails: local decode is always the
        graceful degradation."""
        s = self._s
        if not r.handoff_target or s.config.role != "prefill":
            return False
        kv = s._kv
        st = r.step
        t0 = _now()
        try:
            # chaos: a fault in the capture window degrades to local decode
            inject("serving.kv_export", rid=r.request_id, row=r.row, phase="capture")
            with s._lock:
                kv.harvest([(r.tokens, r.kv_plan, int(st.pad), r.trace)])
                payload = kv.export_prefix(r.tokens, r.kv_plan.namespace)
        except Exception:  # noqa: BLE001 — capture is best-effort
            payload = None
        if payload is None:
            # a handoff-targeted request completing by local decode IS a
            # fallback, whatever stopped the capture
            s._m_handoff_fallbacks.inc()
            return False
        r.handoff_payload = payload_to_wire(payload)
        dt = _now() - t0
        s._m_handoff_capture.observe(dt * 1e3)
        st.phase = "done"
        if r.trace is not None:
            r.trace.add("kv_export", start=t0, dur_s=dt, group=st.gid, row=r.row,
                        pages=len(payload.pages))
        r.finish(error=_HandoffPrefillDone(first))
        return True

    def lanes(self, rows: list) -> list:
        """Rows of one sampling signature share a step — speculative rows
        of one draft width in their own lanes; lanes split at max_batch."""
        groups: dict = {}
        for r in rows:
            k = r.key
            lane = (k.speculate, k.draft_tokens, k.temperature, k.top_k, k.eos_id)
            groups.setdefault(lane, []).append(r)
        mb = max(1, int(self._s.config.max_batch))
        return [g[i:i + mb] for g in groups.values() for i in range(0, len(g), mb)]

    def decode(self, lane: list) -> int:
        if lane[0].key.speculate:
            return self._decode_spec(lane)
        return self._decode_plain(lane)

    _emit = staticmethod(ModelServer._emit)

    def _finish_row(self, r: PendingRequest) -> None:
        s = self._s
        st = r.step
        st.phase = "done"
        tnow = _now()
        if (r.trace is not None and not r.key.speculate and st.gen is not None
                and len(st.gen) > 1):
            r.trace.add("decode", start=st.decode_t0, dur_s=tnow - st.decode_t0,
                        group=st.gid, row=r.row, steps=len(st.gen) - 1)
        try:
            with s._lock:
                s._kv.harvest([(r.tokens, r.kv_plan, int(st.pad), r.trace)])
        except Exception:  # noqa: BLE001 — cache warmth must not fail rows
            traceback.print_exc()
        if r.trace is not None:
            r.trace.add("kv_harvest", start=tnow, dur_s=_now() - tnow, group=st.gid,
                        row=r.row)
        r.finish(result=list(r.tokens) + st.gen[: r.max_new])
        s._m_requests.inc(1)

    def _decode_plain(self, lane: list) -> int:
        s = self._s
        kv = s._kv
        key0 = lane[0].key
        n = len(lane)
        inject("serving.slow", rows=n)
        inject("serving.decode", rows=n)
        # rows of different page counts share the step at the widest
        # table; reads past a row's own span are masked dead
        width = max(r.step.n_pages for r in lane)
        plans = [r.kv_plan for r in lane]
        kv.ensure_pages(plans, upto_slot=max(r.step.pos for r in lane) + 1,
                        traces=[r.trace for r in lane])
        tables = kv.tables(plans, n, width)
        t0 = _now()
        with s._lock:
            nxt, done = paged_step(
                s.module, kv.cache, [r.step.tok for r in lane],
                [r.step.done for r in lane], pad=[r.step.pad for r in lane],
                prefix_lens=[r.step.L for r in lane], pages=tables,
                kv_layout=kv.layout, pos=[r.step.pos for r in lane],
                g=[r.step.g for r in lane], seeds=[r.seed for r in lane],
                temperature=key0.temperature, top_k=key0.top_k, eos_id=key0.eos_id,
                adapter_ix=s._adapter_ix(lane),
            )
            nxt, done = nxt.cpu().tolist(), done.cpu().tolist()
        s._m_decode_step.observe((_now() - t0) * 1e3)
        chunk_cap = max(1, int(s.config.stream_chunk_tokens))
        for i, r in enumerate(lane):
            st = r.step
            t = int(nxt[i])
            st.gen.append(t)
            st.buf.append(t)
            st.tok, st.done = t, bool(done[i])
            st.pos += 1
            st.g += 1
            if key0.eos_id is not None and t == key0.eos_id:
                fill = [int(key0.eos_id)] * (r.max_new - len(st.gen))
                st.gen.extend(fill)
                st.buf.extend(fill)
                self._emit(r, st.buf)
                st.buf = []
                self._finish_row(r)
            elif len(st.gen) >= r.max_new:
                self._emit(r, st.buf)
                st.buf = []
                self._finish_row(r)
            elif len(st.buf) >= chunk_cap:
                # one event per stream_chunk_tokens decoded tokens, the
                # classic chunk loop's cadence
                self._emit(r, st.buf)
                st.buf = []
        s._spec_tick_plain(1)
        return n

    def _decode_spec(self, lane: list) -> int:
        """One verify window for a lane of speculative rows at their own
        frontiers, generation indices and prefix widths; each window's
        committed tokens are one streamed event."""
        s = self._s
        kv = s._kv
        key0 = lane[0].key
        n = len(lane)
        K = int(key0.draft_tokens)
        inject("serving.slow", rows=n)
        inject("serving.decode", rows=n)
        width = max(r.step.n_pages for r in lane)
        fed = np.zeros((n, K + 1), np.int64)
        for i, r in enumerate(lane):
            st = r.step
            fed[i, 0] = st.tok
            if isinstance(st.drafter, ModelDrafter):
                with s._lock:
                    fed[i, 1:] = st.drafter.propose([st.tok], [st.g], K)[0]
            else:
                fed[i, 1:] = st.drafter.propose(K)
        plans = [r.kv_plan for r in lane]
        kv.ensure_pages(plans, upto_slot=max(r.step.pos for r in lane) + K + 1,
                        traces=[r.trace for r in lane])
        delta = s._verify_window(lane, [r.step for r in lane], fed, kv.tables(plans, n, width))
        s._spec_observe(delta)
        tnow = _now()
        for r in lane:
            st = r.step
            if r.trace is not None:
                r.trace.add("verify", start=st.t_prev, dur_s=tnow - st.t_prev,
                            group=st.gid, row=r.row, window=st.window,
                            proposed=delta["proposed"], accepted=delta["accepted"],
                            rollback=delta["rollback"])
            st.t_prev = tnow
            st.window += 1
            if st.remaining <= 0:
                self._finish_row(r)
        return n * (K + 1)
