"""The training loop on one GPU: a `V1Program` → trained weights.

Counterpart of `polyaxon_tpu/runtime/trainer.py` for a single device, with
the same step function, metrics and loop, for every model of the registry
(the transformer LM and the zoo):

- precision: f32 master weights for `float32` and `mixed`, bf16 ones for
  `bfloat16` (parameters only: buffers such as BatchNorm's running
  statistics stay f32, as the reference's `batch_stats` do). Under `mixed`
  every float parameter (norm scales and the embedding included) is cast
  to bf16 for the forward, as the reference's `_cast_floats` does, and so
  is a float input batch (images); the forward runs through
  `torch.func.functional_call` over those cast copies, so the gradients
  land on the masters in f32 through the casts. (`torch.autocast` chooses
  per op and would be a different function.)
- the model's other state (`ModelBundle.mutable`, "batch_stats") and sown
  losses (`ModelBundle.aux_losses`, the MoE balance loss): the forward
  runs inside `models.layers.collecting()`, which hands back the aux
  losses (added to the training loss, not to eval's) and BatchNorm's new
  running statistics, applied to the buffers after that microbatch's
  backward when the bundle declares "batch_stats" mutable; under remat they come out of the checkpointed function once,
  as the reference's `apply` returns them, so the recompute cannot apply
  them twice. Eval runs the module in eval mode (the running statistics).
- data: a program without `data` trains on `synthetic` with batch 32, as
  the reference's does; a stream that declares its feature shape must
  match the model's input in element count (`_validate_data_shape`).
- frozen parameters: with `ModelBundle.trainable_patterns` (LoRA) only the
  matching parameters are given to the optimizer, so the rest get zero
  updates and no weight decay, and clipping sees only the trainable ones.
  The `grad_norm` metric is over all gradients, as the reference's is.
- `grad_accum`: the batch splits into microbatches whose gradients add up
  on the masters before one update; a count that does not divide the
  batch is raised to the next one that does (`grad_accum_adjusted` event).
- `remat` / `remat_policy`: `torch.utils.checkpoint` (non reentrant) over
  the whole model apply, so the backward recomputes the forward. `nothing`
  (and plain `remat`) saves nothing; `dots` and `dots_no_batch` save the
  outputs of the matrix products by selective activation checkpointing,
  as `jax.checkpoint_policies.checkpoint_dots` and
  `checkpoint_dots_with_no_batch_dims` do: `aten.mm`/`aten.addmm` for
  both (the projections have no batch dims), `aten.bmm`/`aten.baddbmm`
  too for `dots` (the einsum attention's scores and values). The flash
  kernels are called through ctypes, which the dispatcher never sees, so
  they are always recomputed, as a `pallas_call` is in the reference.
  Dropout draws from a generator made inside the recomputed function from
  a seed keyed by (seed, step, microbatch), so the recompute draws the
  same mask.
- the fused loss (`ModelBundle.fused_loss`): the module returns features
  and the loss computes the lm head in vocab chunks.
- metrics `loss`, `learning_rate` (the schedule at the step before the
  update) and `grad_norm`, and `accuracy` (on the training forward's
  logits) for `task == "classification"`; `eval.loss` / `eval.perplexity`
  (and `eval.accuracy`) on a separate stream every `eval_every` steps;
  `tokens_per_sec`, `mfu` and `data_wait_frac` per log window; `steps_per_sec` and `examples_per_sec`
  at the end.
- a prefetch thread (queue of 2) moves batches to the device ahead of the
  step; a log point is read one log point later, so reading it does not
  stall the device.
- `profile_start` / `profile_stop`: a `torch.profiler` window written as a
  Chrome trace to `<artifacts_dir>/profile/trace.json`; the profiler is
  kept on `Trainer.profile`.
- operations hooks, as the reference's `run()`: per step the span tree
  `step` ⊃ `data_wait` + `compute` (and `checkpoint` at a boundary), in
  `<artifacts_dir>/telemetry/spans.jsonl` unless `observability.trace` is
  false; the histograms `trainer.step_seconds`, `trainer.data_wait_seconds`
  and `trainer.compute_seconds`, the counter `trainer.steps`, the gauges
  `train.<metric>` and the device memory gauges in the trainer's registry
  (`observability.histogramBuckets` sets its buckets), and
  `trainer.checkpoint_stall_ms` in the process-global one; the chaos point
  `trainer.step`; the preemption flag read at the head of each step.
- checkpoints (`runtime/checkpoint.py`) with a `checkpoint_dir`: a save
  every `checkpoint_every` steps and one at the end, on the local tier
  first when `local_checkpoint_dir` / `train.checkpointLocalDir` is set,
  `checkpoint_keep` steps kept. A save holds the step, the master weights
  and the optimizer's state with its `count`. With `resume`, `run()`
  restores the newest intact step first. The data stream then starts
  over, as the reference's does: a resumed run trains steps k.. on the
  stream's batches 0..; the schedule, Adam's count and the dropout seeds
  (keyed by the step) continue.

`close()` releases the data pipelines (the native loader's prefetch
threads and its corpus mmap) when the run is over.

`donate_state` is accepted and has nothing to do: PyTorch updates the
weights and optimizer state in place.

`mesh_axes` (and `slices`) train on a device mesh over the ranks of the
`torch.distributed` world (`parallel/`), whatever its sizes, as the
reference's jit with shardings does (a world of one needs no process
group of the caller's: the trainer starts one), for every model of the
registry. Each rank builds the same host batch and takes its slice
(`make_global_batch`): the batch over data x fsdp, the sequence of the
token batches (the flagship's, BERT's and seq2seq's) over `context`,
where a classifier's batch stays whole on every `context` rank. The parameters are DTensors
placed by the model's rules (`ModelBundle.sharding_rules`), gathered for
the forward but where it keeps them split (`ModelBundle.split`: tensor
parallelism over `model`, the experts over `expert`, the stages over
`pipeline`; `parallel/params.py`), and the optimizer runs on their
shards. The loss is each rank's share of the mean over the global count
(of labelled tokens, or of examples), so the gradients' reductions make
the global mean's; the ranks of `pipeline` each hold an equal share of
the same loss; the vocabulary-split LM head gets the vocab-parallel
loss. BatchNorm takes its statistics over the global batch
(`models/layers.py`), so the running statistics are the same on every
rank. Rank 0 alone writes metrics, events, logs, spans, the profile and
checkpoints, which hold the full tensors in the single-device format (a
mesh, another mesh or one device resumes from them). Under `context` the
encoders' self-attention runs on the ring (`models/encoder.py`); the
masked-LM count sums over `context` like the batch axes, so a
classifier's `context` ranks each hold an equal share of one loss and
their summed gradients count the batch once.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import queue
import re
import threading
from pathlib import Path
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..chaos.injector import inject
from ..data import build_data
from ..device import resolve_device
from ..models import build_model
from ..models.layers import collecting
from ..ops.losses import accuracy as accuracy_metric
from ..ops.losses import build_loss
from ..ops.optimizers import build_optimizer, global_norm
from ..parallel.collectives import all_reduce, axis_group, axis_index
from ..parallel.mesh import BATCH_AXES, axis_sizes, build_mesh, local_batch_slice
from ..parallel.params import ShardedParameters, full_tensors
from ..parallel.ring import set_current_mesh
from ..parallel.sharding import batch_sharding, make_global_batch
from ..retry import Preempted
from ..schemas.run_kinds import V1ObservabilitySpec, V1Program, V1TrainSpec
from ..telemetry import MetricsRegistry, SpanTracer, get_registry, now, train_step_flops
from ..telemetry import mfu as _mfu_of
from ..tracking.monitors import device_metrics
from . import preemption
from .checkpoint import CheckpointTiers

_DTYPES = {"float32": torch.float32, "mixed": torch.bfloat16, "bfloat16": torch.bfloat16}


def param_dtype_for(precision: str) -> torch.dtype:
    """Master-weight dtype for a train.precision setting."""
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


# the matrix products each policy saves (the rest is recomputed)
_SAVED_PRODUCTS = {
    "dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def remat_context_fn(policy: Optional[str]):
    """`context_fn` for `torch.utils.checkpoint` under a remat policy: a
    selective-checkpoint policy that saves the outputs of the policy's
    matrix products; for `nothing` and no policy, torch's default, which
    saves nothing."""
    if policy not in _SAVED_PRODUCTS:
        return noop_context_fn
    saved = {getattr(torch.ops.aten, name).default for name in _SAVED_PRODUCTS[policy]}

    def policy_fn(ctx, op, *args, **kwargs):
        if op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def step_seed(seed: int, *keys: int) -> int:
    """A generator seed keyed by (seed, step[, microbatch]), in the spirit
    of the reference's jax.random.fold_in."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class TrainState:
    step: int
    module: nn.Module  # the master weights
    optimizer: torch.optim.Optimizer


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: list[dict]
    steps_per_sec: float
    final_metrics: dict


class Trainer:
    """Drives one program on one device (`device="cuda"` unless the caller
    asks for the CPU)."""

    def __init__(
        self,
        program: Union[V1Program, dict],
        *,
        device="cuda",
        mesh_axes: Optional[dict[str, int]] = None,
        slices: int = 1,
        log_fn: Optional[Callable[[int, dict], None]] = None,
        event_fn: Optional[Callable[[str, dict], None]] = None,
        checkpoint_dir: Optional[str] = None,
        local_checkpoint_dir: Optional[str] = None,
        artifacts_dir: Optional[str] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        program = V1Program.from_dict(program)
        self.program = program
        tspec = program.train or V1TrainSpec()
        self.tspec = tspec
        if tspec.checkpoint_every and not checkpoint_dir:
            raise ValueError("train.checkpointEvery needs a checkpoint_dir to save into")
        self.device = resolve_device(device)
        self.mesh = None
        if mesh_axes is not None or int(slices) > 1:
            self.mesh = self._bind_mesh(program, mesh_axes, int(slices))
        # rank 0 alone writes metrics, events, logs, spans and profiles
        self.is_writer = self.mesh is None or dist.get_rank() == 0
        if not self.is_writer:
            log_fn = event_fn = artifacts_dir = None
        self.artifacts_dir = artifacts_dir
        self.log_fn = log_fn or (lambda step, m: None)
        self.event_fn = event_fn
        self.checkpoint_dir = checkpoint_dir
        self.local_checkpoint_dir = local_checkpoint_dir or tspec.checkpoint_local_dir
        self._tiers = None
        # one metrics pipeline: every number the trainer reports goes
        # through this registry (and on to the caller through _emit)
        obs = program.observability or V1ObservabilitySpec()
        self.telemetry = registry or MetricsRegistry(default_buckets=obs.histogram_buckets)
        self.tracer = SpanTracer(
            path=str(Path(artifacts_dir) / "telemetry" / "spans.jsonl")
            if artifacts_dir and obs.trace else None
        )
        self.compute_dtype = _DTYPES[tspec.precision]
        self.param_dtype = param_dtype_for(tspec.precision)

        self.bundle = build_model(
            program.model.name, program.model.config,
            device=self.device, dtype=torch.float32, seed=int(tspec.seed),
        )
        self.module = self.bundle.module
        if self.param_dtype != torch.float32:
            # every parameter (norm scales too, as _cast_floats); buffers stay
            with torch.no_grad():
                for p in self.module.parameters():
                    p.data = p.data.to(self.param_dtype)
        self.sharded = None
        if self.mesh is not None:
            split = dict(self.bundle.split)
            model = axis_sizes(self.mesh).get("model", 1)
            if any(w % model for w in self.bundle.split_widths):
                split.pop("model", None)  # no tensor parallelism: gathered
            self.sharded = ShardedParameters(
                self.module, self.mesh, self.bundle.sharding_rules, split)
        dspec = program.data  # none: the reference's image default
        self._data_args = (
            (dspec.name, int(dspec.batch_size), dspec.config) if dspec
            else ("synthetic", 32, None)
        )
        self.data = build_data(*self._data_args, seed=int(tspec.seed))
        self._validate_data_shape()
        if self.mesh is not None:
            self._validate_mesh_fit()
        self.is_classification = self.bundle.task == "classification"
        self.steps = int(tspec.steps)
        self.step = 0

        named = dict(self.module.named_parameters())
        pats = [re.compile(p) for p in self.bundle.trainable_patterns]
        trainable = {  # by name: what a decay mask names
            name: p for name, p in named.items()
            if not pats or any(pat.search(name) for pat in pats)
        }
        ospec = program.optimizer
        self.optimizer, self.sched = build_optimizer(
            trainable,
            name=ospec.name if ospec else "adamw",
            learning_rate=float(ospec.learning_rate) if ospec else 1e-3,
            config=ospec.config if ospec else None,
            schedule=ospec.schedule if ospec else None,
            total_steps=self.steps,
        )
        self.loss_name = tspec.loss or self.bundle.loss
        self.loss_fn = build_loss(self.loss_name)
        self.fused_loss = self.bundle.fused_loss
        if self.fused_loss is not None and tspec.loss not in (None, "masked_lm"):
            raise ValueError(
                "fused_lm_loss computes chunked masked-LM cross-entropy and "
                f"cannot honor train.loss={tspec.loss!r} — drop the loss "
                "override or disable fused_lm_loss"
            )
        self.remat = bool(tspec.remat) or tspec.remat_policy is not None
        self._remat_context = remat_context_fn(tspec.remat_policy)

        grad_accum = int(tspec.grad_accum) if tspec.grad_accum else 1
        if grad_accum < 1:
            raise ValueError(f"train.gradAccum must be >= 1, got {grad_accum}")
        batch = self.data.batch_size
        shards = local_batch_slice(self.mesh)
        if batch % shards:
            raise ValueError(
                f"global batch {batch} not divisible by batch-sharded mesh axes ({shards})"
            )
        # each microbatch keeps the batch-sharded split: microbatch =
        # global / (accum * shards)
        micro = batch // shards
        if micro % grad_accum:
            requested = grad_accum
            grad_accum = next(g for g in range(requested, micro + 1) if micro % g == 0)
            self._event("grad_accum_adjusted", {
                "requested": requested, "effective": grad_accum,
                "global_batch": batch, "batch_shards": shards,
            })
        self.grad_accum = grad_accum
        if self.mesh is not None:
            extra = ({"1": "context"} if self.bundle.task in ("lm", "mlm")
                     and axis_sizes(self.mesh).get("context", 1) > 1 else None)
            self._batch_placements = batch_sharding(self.mesh, extra)
        self.profile = None
        self._profiling = False

    def _bind_mesh(self, program, mesh_axes, slices):
        """The mesh over the world (a world of one started here when no
        process group exists), bound for the model's collectives."""
        sizes = dict(mesh_axes or {})
        if not dist.is_initialized():
            if math.prod(v for v in sizes.values() if v != -1) > 1 or slices > 1:
                raise RuntimeError(
                    f"mesh {sizes} (slices={slices}) needs a torch.distributed world: "
                    "run one process per device (runtime/worker.py)"
                )
            dist.init_process_group(
                "nccl" if self.device.type == "cuda" else "gloo",
                store=dist.HashStore(), rank=0, world_size=1,
            )
        mesh = build_mesh(sizes or None, slices=slices,
                          device_type="cuda" if self.device.type == "cuda" else "cpu")
        set_current_mesh(mesh)
        return mesh

    def _validate_mesh_fit(self):
        """Every mesh axis must divide the model or data dimension it
        splits (the reference's `_validate_mesh_fit`: heads over `model`,
        the sequence over `context`, layers over `pipeline`, experts over
        `expert`), plus the hidden width the port splits over `model`."""
        sizes, cfg = axis_sizes(self.mesh), getattr(self.module, "cfg", None)

        def check(axis: int, dim: int, what: str):
            if axis > 1 and dim % axis != 0:
                raise ValueError(
                    f"mesh axis mismatch: {what} ({dim}) is not divisible by "
                    f"the mesh's {axis}-way split — adjust the mesh or the model"
                )

        ctx = sizes.get("context", 1)
        if cfg is None:  # the zoo: an mlm model's token sequence splits
            if self.bundle.task == "mlm":
                meta = self.data.meta
                for key in ("seq_len", "src_len", "tgt_len"):
                    if meta.get(key):
                        check(ctx, int(meta[key]), f"data {key}")
            return
        model = sizes.get("model", 1)
        check(model, cfg.n_heads, "n_heads")
        check(model, cfg.n_kv_heads, "n_kv_heads")
        check(model, cfg.ffn_dim, "hidden_dim")
        seq = self.data.meta.get("seq_len") or cfg.seq_len
        check(ctx, int(seq), "data seq_len")
        check(sizes.get("pipeline", 1), cfg.n_layers, "n_layers")
        exp = sizes.get("expert", 1)
        if exp > 1:
            if cfg.n_experts == 0:
                raise ValueError(
                    "mesh declares an expert axis but the model has no "
                    "experts (set model.config.n_experts)"
                )
            check(exp, cfg.n_experts, "n_experts")

    def _validate_data_shape(self):
        """A stream that declares its feature shape (the classification
        streams) must match the model's input in element count (the MLP
        flattens (28, 28, 1) to 784), the reference's config-level error."""
        declared = self.data.meta.get("shape")
        model_shape = tuple(self.bundle.input_shape)
        if not declared or len(model_shape) < 1:
            return
        declared = tuple(declared)
        if math.prod(declared) != math.prod(model_shape):
            raise ValueError(
                f"data/model shape mismatch: dataset '{self.data.name}' emits "
                f"features of shape {declared} but model "
                f"'{self.program.model.name}' expects {model_shape} — align "
                "data.config.shape with the model config"
            )

    # -------------------------------------------------------------- step
    def _compute_params(self) -> dict[str, torch.Tensor]:
        """name → the tensor the forward uses: the master itself, or its
        cast to the compute dtype (differentiable back to the master)."""
        params = dict(self.module.named_parameters())
        if self.sharded is not None:
            cast = self.compute_dtype if self.compute_dtype != self.param_dtype else None
            return self.sharded.views(params, cast)
        if self.compute_dtype == self.param_dtype:
            return params
        return {
            n: p.to(self.compute_dtype) if p.is_floating_point() else p
            for n, p in params.items()
        }

    def _inputs(self, batch) -> torch.Tensor:
        x = batch["inputs"]
        return x.to(self.compute_dtype) if x.is_floating_point() else x

    def _apply(self, params, inputs, seed: Optional[int]):
        """(output, the summed aux loss or None, the `Collected` box) of one
        forward; the caller applies the box's buffer updates."""
        kwargs: dict[str, Any] = {}
        if self.fused_loss is not None:
            kwargs["return_features"] = True
        if seed is not None and "dropout" in self.bundle.rngs:
            gen = torch.Generator(device=self.device)
            kwargs["dropout_generator"] = gen.manual_seed(seed)
        set_current_mesh(self.mesh)  # re-bind: another Trainer may have run here
        with collecting() as box:
            out = functional_call(self.module, params, (inputs,), kwargs)
        aux = box.aux_loss(self.device) if self.bundle.aux_losses else None
        return out, aux, box

    def _loss(self, batch, seed: int):
        """(loss with the aux losses, logits or features, what the forward
        collected)."""
        params = self._compute_params()
        inputs = self._inputs(batch)
        if self.remat:
            out, aux, box = checkpoint(
                self._apply, params, inputs, seed,
                use_reentrant=False, context_fn=self._remat_context,
            )
        else:
            out, aux, box = self._apply(params, inputs, seed)
        if self.mesh is not None:
            loss = self._mesh_loss(params, out, batch)
        elif self.fused_loss is not None:  # `out` carries features
            loss = self.fused_loss(params, out, batch)
        else:
            loss = self.loss_fn(out, batch)
        if aux is not None:
            loss = loss + aux
        return loss, out, box

    # ------------------------------------------------------------- mesh
    def _data_groups(self) -> list:
        """The groups whose ranks' loss shares add up to the loss: the
        batch axes and `context` (their ranks hold other tokens), and
        `pipeline` (its ranks hold equal shares of the same loss)."""
        return [axis_group(self.mesh, ax) for ax in (*BATCH_AXES, "context", "pipeline")]

    def _count(self, out, batch) -> torch.Tensor:
        """The global count the loss averages over, summed over
        `_data_groups`: the labelled tokens (masked LM), the examples
        (cross-entropy) or the elements (mse)."""
        labels = batch["labels"]
        if self.loss_name == "masked_lm":
            local = (labels != -100).sum().float()
        elif self.loss_name == "mse":
            local = torch.tensor(float(out.numel()), device=out.device)
        else:
            local = torch.tensor(float(labels.shape[0]), device=labels.device)
        return all_reduce(local, self._data_groups())

    def _mesh_loss(self, params, out, batch):
        """This rank's share of the loss's mean over the global count;
        for the transformer LM vocab-parallel where the LM head is split
        over `model`. The shares add up to the loss."""
        from ..models.transformer import _model_group
        from ..ops.losses import fused_linear_masked_lm, masked_lm
        from ..parallel.collectives import copy_to

        count = self._count(out, batch)
        cfg = getattr(self.module, "cfg", None)
        if cfg is None or self.bundle.task != "lm":
            return self.loss_fn(out, batch, count=count)
        labels = batch["labels"]
        name = "embed.weight" if cfg.tie_embeddings else "lm_head.weight"
        local_v = params[name].shape[0]
        group = _model_group(local_v, cfg.vocab_size)
        vocab = None if group is None else (group, axis_index(self.mesh, "model") * local_v)
        if self.fused_loss is not None:  # `out` carries features
            return fused_linear_masked_lm(
                copy_to(out, group), params[name].T, labels,
                chunk_size=cfg.fused_loss_chunk, count=count, vocab=vocab,
            )
        return masked_lm(out, batch, count=count, vocab=vocab)

    def _global(self, share: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' shares (their global mean)."""
        if self.mesh is None:
            return share
        return all_reduce(share.detach().float().clone(), self._data_groups())

    def _accuracy(self, out, batch) -> torch.Tensor:
        """Accuracy, on a mesh this rank's share of the global one."""
        if self.mesh is None:
            return accuracy_metric(out, batch)
        return accuracy_metric(out, batch, count=self._count(out, batch))

    def _update_state(self, box) -> None:
        if "batch_stats" in self.bundle.mutable:
            box.apply_updates()

    def train_step(self, batch: dict) -> dict:
        """One optimizer update on `batch` (token tensors on the device) →
        the step's metrics as tensors/floats."""
        self.module.train()
        step, seed = self.step, int(self.tspec.seed)
        masters = list(self.module.parameters())
        for p in masters:
            p.grad = None
        if self.grad_accum == 1:
            loss, out, box = self._loss(batch, step_seed(seed, step))
            loss.backward()
            self._update_state(box)  # after the backward's recompute, if any
            loss = loss.detach()
            acc = self._accuracy(out.detach(), batch) if self.is_classification else None
        else:
            A = self.grad_accum
            micro = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:]) for k, v in batch.items()}
            loss = torch.zeros((), device=self.device)
            acc = torch.zeros((), device=self.device)
            for i in range(A):
                mb = {k: v[i] for k, v in micro.items()}
                loss_i, out, box = self._loss(mb, step_seed(seed, step, i))
                loss_i.backward()  # adds onto .grad in the master dtype
                self._update_state(box)  # the next microbatch sees these stats
                loss = loss + loss_i.detach()
                if self.is_classification:
                    acc = acc + self._accuracy(out.detach(), mb)
            loss = loss / A
            acc = acc / A if self.is_classification else None
            for p in masters:
                if p.grad is not None:
                    p.grad.div_(A)
        if self.sharded is not None:
            self.sharded.reduce_grads(self.module)
        metrics = {
            "loss": self._global(loss).float(),
            "learning_rate": float(np.float32(self.sched(step))),
            "grad_norm": global_norm(p.grad for p in masters if p.grad is not None),
        }
        if acc is not None:
            metrics["accuracy"] = self._global(acc)
        self.optimizer.step()
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        self.module.eval()
        params = self._compute_params()
        out, _, _ = self._apply(params, self._inputs(batch), None)
        if self.mesh is not None:
            loss = self._global(self._mesh_loss(params, out, batch))
        elif self.fused_loss is not None:
            loss = self.fused_loss(params, out, batch).float()
        else:
            loss = self.loss_fn(out, batch).float()
        metrics = {"eval.loss": loss}
        if self.is_classification:
            metrics["eval.accuracy"] = self._global(self._accuracy(out, batch))
        # cross-entropy family: loss is mean nats per token
        if "cross_entropy" in self.loss_name or self.loss_name == "masked_lm":
            metrics["eval.perplexity"] = torch.exp(loss)
        return metrics

    def load_state_dict(self, state_dict: dict) -> None:
        """Load weights (e.g. `models.convert.params_from_jax` of the JAX
        package's parameters) into the masters, cast to their dtype; on a
        mesh each rank keeps its shard of the full tensors (and the whole
        of the buffers)."""
        if self.sharded is not None:
            self.sharded.load_full(self.module, state_dict)
            buffers = dict(self.module.named_buffers())  # BatchNorm's statistics
            self.module.load_state_dict(
                {k: v for k, v in state_dict.items() if k in buffers}, strict=False)
            return
        self.module.load_state_dict(state_dict)

    def _to_device(self, batch: dict) -> dict:
        batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        if self.mesh is not None:  # this rank's slice of the host batch
            batch = make_global_batch(batch, self.mesh, self._batch_placements)
        return {k: v.to(self.device) for k, v in batch.items()}

    # -------------------------------------------------------------- loop
    def run(self) -> TrainResult:
        tspec = self.tspec
        log_every = max(1, int(tspec.log_every))
        ckpt_every = int(tspec.checkpoint_every) if tspec.checkpoint_every else 0
        if self.checkpoint_dir and tspec.resume:
            self.restore()
        history: list[dict] = []
        pending: Optional[tuple[int, dict]] = None
        start_step = self.step
        n_steps = self.steps - start_step

        # prefetch: host batch prep and the copy to the device run on a
        # producer thread, ahead of the step. A fresh stream: a resumed run
        # trains on the stream's first batches again, as the reference does
        feed: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()
        it = self.data.iterator

        def _put(item) -> None:
            while not stop.is_set():
                try:
                    feed.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def _produce():
            try:
                for _ in range(n_steps):
                    _put(self._to_device(next(it)))
            except BaseException as e:  # noqa: BLE001 — surfaced in the loop
                _put(e)

        producer = threading.Thread(target=_produce, daemon=True)
        producer.start()

        eval_every = int(tspec.eval_every) if tspec.eval_every else 0
        eval_steps = int(tspec.eval_steps) if tspec.eval_steps else 4
        prof_start = int(tspec.profile_start) if tspec.profile_start is not None else None
        prof_stop = int(tspec.profile_stop) if tspec.profile_stop is not None else None

        self._init_throughput_facts()
        step_hist = self.telemetry.histogram("trainer.step_seconds", help="Per-step walltime")
        wait_hist = self.telemetry.histogram(
            "trainer.data_wait_seconds", help="Per-step time blocked on the input pipeline"
        )
        busy_hist = self.telemetry.histogram(
            "trainer.compute_seconds", help="Per-step walltime minus data wait"
        )
        steps_ctr = self.telemetry.counter("trainer.steps", help="Training steps completed")
        # process-global, as in the reference: what a boundary save costs
        # the step loop (the snapshot; the write runs in the background)
        stall_hist = get_registry().histogram(
            "trainer.checkpoint_stall_ms",
            buckets=(0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0),
            help="Step-loop stall per boundary save (async write), ms",
        )
        t0 = now()
        self._win = {"t0": t0, "steps": 0, "wait": 0.0, "busy": 0.0}
        try:
            for step in range(start_step, self.steps):
                # data_wait + compute cover the step body, so their
                # durations add up to the step span's
                with self.tracer.span("step", step=step) as step_span:
                    inject("trainer.step", step=step)
                    if self._preemption_requested():
                        self._preempt_exit(step, start_step)
                    if prof_start is not None and step == prof_start and self.artifacts_dir:
                        self._start_profiler()
                    with self.tracer.span("data_wait") as wait_span:
                        batch = feed.get()
                    if isinstance(batch, BaseException):
                        raise batch
                    with self.tracer.span("compute") as busy_span:
                        metrics = self.train_step(batch)
                        if self._profiling and prof_stop is not None and step + 1 >= prof_stop:
                            self._stop_profiler()
                        if (step + 1) % log_every == 0 or step + 1 == self.steps:
                            # flush the previous log point first: one log
                            # point of pipelining, so reading it never
                            # stalls the device
                            if pending is not None:
                                self._emit(history, *pending)
                            pending = (step + 1, metrics)
                        if eval_every and ((step + 1) % eval_every == 0 or step + 1 == self.steps):
                            eval_metrics = self._evaluate(eval_steps)
                            if pending is not None:
                                self._emit(history, *pending)
                                pending = None
                            self._emit(history, step + 1, eval_metrics)
                    if ckpt_every and (step + 1) % ckpt_every == 0:
                        with self.tracer.span("checkpoint", step=step + 1) as ckpt_span:
                            self.save(step + 1)
                        stall_hist.observe(ckpt_span.dur_s * 1000.0)
                step_hist.observe(step_span.dur_s)
                wait_hist.observe(wait_span.dur_s)
                busy_hist.observe(busy_span.dur_s)
                steps_ctr.inc()
                self._win["steps"] += 1
                self._win["wait"] += wait_span.dur_s
                self._win["busy"] += busy_span.dur_s
            self._stop_profiler()
            if pending is not None:
                self._emit(history, *pending)
        finally:
            stop.set()
            producer.join(timeout=10)
        elapsed = now() - t0
        sps = n_steps / elapsed if elapsed > 0 else 0.0
        if ckpt_every:
            self.save(self.steps, wait=True)  # a no-op when the last boundary saved it
        final = dict(history[-1]) if history else {}
        final["steps_per_sec"] = sps
        final["examples_per_sec"] = sps * self.data.batch_size
        return TrainResult(
            state=TrainState(self.step, self.module, self.optimizer),
            history=history, steps_per_sec=sps, final_metrics=final,
        )

    def _evaluate(self, eval_steps: int) -> dict:
        """Average eval metrics over `eval_steps` batches from a dedicated
        stream: the same seed (the synthetic task must match training) and
        a shifted process index, so eval batches differ from training's."""
        if not hasattr(self, "_eval_data"):
            name, _, config = self._data_args
            self._eval_data = build_data(
                name, self.data.batch_size, config,
                seed=int(self.tspec.seed), process_index=7919,
            )
        totals: dict[str, float] = {}
        it = self._eval_data.iterator
        for _ in range(eval_steps):
            m = self.eval_step(self._to_device(next(it)))
            for k, v in m.items():
                totals[k] = totals.get(k, 0.0) + float(v)
        return {k: v / eval_steps for k, v in totals.items()}

    # -------------------------------------------------------- telemetry
    def _start_profiler(self):
        if self._profiling:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        self._profiling = True
        self.tracer.event("profiler.start", path=str(Path(self.artifacts_dir) / "profile"))

    def _stop_profiler(self):
        """Idempotent close of the capture window: waits for the device,
        writes the trace and registers it as a run artifact."""
        if not self._profiling:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.__exit__(None, None, None)
        self._profiling = False
        self.profile = self._profiler
        trace_dir = Path(self.artifacts_dir) / "profile"
        trace_dir.mkdir(parents=True, exist_ok=True)
        self._profiler.export_chrome_trace(str(trace_dir / "trace.json"))
        self.tracer.event("profiler.stop", path=str(trace_dir))
        self._event(
            "artifact",
            {"kind": "profile", "path": "profile", "abs_path": str(trace_dir)},
        )

    def _init_throughput_facts(self):
        """Tokens per step (token tasks only) and the analytic step FLOPs
        (transformer configs only); None disables the matching rate."""
        self._tokens_per_step = None
        self._flops_per_step = None
        cfg = getattr(self.module, "cfg", None)
        if self.bundle.task not in ("lm", "mlm") or cfg is None:
            return
        seq = self.data.meta.get("seq_len") or getattr(cfg, "seq_len", None)
        if not seq:
            return
        self._tokens_per_step = self.data.batch_size * int(seq)
        n_params = sum(p.numel() for p in self.module.parameters())
        self._flops_per_step = train_step_flops(
            n_params, cfg.n_layers, cfg.dim, cfg.seq_len, self._tokens_per_step
        )

    def _drain_window(self) -> dict:
        """Rates since the last log point: tokens/s, MFU against the card's
        peak bf16 FLOP/s, and the share of the loop's time spent waiting
        for the input pipeline. Resets the window."""
        w = self._win
        dt = now() - w["t0"]
        if not w["steps"] or dt <= 0:
            return {}
        out = {}
        sps = w["steps"] / dt
        busy = w["wait"] + w["busy"]
        if busy > 0:
            out["data_wait_frac"] = w["wait"] / busy
        if self._tokens_per_step:
            out["tokens_per_sec"] = sps * self._tokens_per_step
        if self._flops_per_step and self.device.type == "cuda":
            mfu = _mfu_of(
                sps * self._flops_per_step, torch.cuda.get_device_name(self.device),
                n_devices=dist.get_world_size() if self.mesh is not None else 1,
            )
            if mfu is not None:
                out["mfu"] = mfu
        self._win = {"t0": now(), "steps": 0, "wait": 0.0, "busy": 0.0}
        return out

    def _emit(self, history, step, metrics):
        vals = {k: float(v) for k, v in metrics.items()}
        vals.update(self._drain_window())
        for k, v in vals.items():
            self.telemetry.gauge(f"train.{k}").set(v)
        for k, v in device_metrics().items():
            self.telemetry.gauge(k).set(v)
        history.append({"step": step, **vals})
        self.log_fn(step, vals)

    def _event(self, kind: str, body: dict):
        """Lifecycle events (preempted, resumed, checkpoint_fallback, ...) to
        the caller's sink; advisory — a sink fault never fails training."""
        if self.event_fn is None:
            return
        try:
            self.event_fn(kind, body)
        except Exception:  # noqa: BLE001
            pass

    def _preemption_requested(self) -> bool:
        """The SIGTERM flag; on a mesh, raised on any rank (every rank then
        stops at the same step and joins the checkpoint's gathers)."""
        flag = preemption.requested()
        if self.mesh is None or dist.get_world_size() == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def _preempt_exit(self, step: int, start_step: int):
        """SIGTERM landed: flush a checkpoint of the `step` steps done and
        raise `Preempted`, so the restart resumes warm instead of counting
        a failure. The saved step is the resume point. When the newest
        save is already that step, its write and upload still in flight
        are waited for (the reference raises without waiting), so the
        resume point is on disk before the process goes."""
        saved = None
        if self.checkpoint_dir:
            tiers = self._checkpoint_tiers()
            saved = tiers.latest_step()
            if step > start_step and (saved or 0) < step:
                self.save(step, wait=True)
                saved = step
            else:
                tiers.wait()
        self._event("preempted", {"step": step, "resume_step": int(saved or 0)})
        raise Preempted(f"SIGTERM preemption notice at step {step}", step=saved)

    def close(self):
        """Release the data pipelines' resources (the native loader's
        prefetch threads and its corpus mmap) when the run ends, not at
        GC time. Idempotent."""
        self.data.shutdown()
        if hasattr(self, "_eval_data"):
            self._eval_data.shutdown()

    # -------------------------------------------------------------- ckpt
    def _checkpoint_tiers(self):
        if self._tiers is None and self.checkpoint_dir:
            keep = int(self.tspec.checkpoint_keep) if self.tspec.checkpoint_keep else None
            self._tiers = CheckpointTiers(
                self.checkpoint_dir, local=self.local_checkpoint_dir, keep=keep
            )
        return self._tiers

    def checkpoint_state(self) -> dict:
        """What a checkpoint holds, as references to the live tensors: the
        step, the master weights, and the optimizer's state with its
        `count`."""
        return {
            "step": self.step,
            "model": self.module.state_dict(),
            "optimizer": self.optimizer.state_dict(),
        }

    def save(self, step: int, wait: bool = False) -> bool:
        """Save the state as `step` (asynchronous unless `wait`); False when
        `step` is not newer than the newest saved step. On a mesh every
        rank gathers the full tensors and rank 0 writes them."""
        state = self.checkpoint_state()
        if self.mesh is not None:
            state = full_tensors(state)
            if not self.is_writer:
                return False
        return self._checkpoint_tiers().save(step, state, wait=wait)

    def restore(self) -> int:
        """Load the newest intact step across both tiers (the durable copy
        preferred, the local one as fallback, corrupt copies quarantined
        per tier) into the weights and optimizer state in place. Returns
        the restored step, 0 when there is none."""
        with self.tracer.span("restore"):
            restored, step, corrupt, tier = self._checkpoint_tiers().restore_latest_intact(
                self.checkpoint_state()
            )
        if corrupt:
            self._event("checkpoint_fallback", {
                "corrupt_steps": sorted({s for _t, s in corrupt}),
                "corrupt_copies": [[t, s] for t, s in corrupt],
                "restored_step": step,
            })
        if step > 0:
            self.step = int(restored["step"])
            self.optimizer.count = int(restored["optimizer"]["count"])
            self._event("resumed", {"step": step, "tier": tier})
        return step
