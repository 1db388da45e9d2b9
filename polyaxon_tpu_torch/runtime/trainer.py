"""The training loop on one GPU: a `V1Program` → trained weights.

Counterpart of `polyaxon_tpu/runtime/trainer.py` for a single device, with
the same step function, metrics and loop:

- precision: f32 master weights for `float32` and `mixed`, bf16 ones for
  `bfloat16`. Under `mixed` every float parameter (norm scales and the
  embedding included) is cast to bf16 for the forward, as the reference's
  `_cast_floats` does, and the forward runs through
  `torch.func.functional_call` over those cast copies, so the gradients
  land on the masters in f32 through the casts. (`torch.autocast` chooses
  per op and would be a different function.)
- frozen parameters: with `ModelBundle.trainable_patterns` (LoRA) only the
  matching parameters are given to the optimizer, so the rest get zero
  updates and no weight decay, and clipping sees only the trainable ones.
  The `grad_norm` metric is over all gradients, as the reference's is.
- `grad_accum`: the batch splits into microbatches whose gradients add up
  on the masters before one update; a count that does not divide the
  batch is raised to the next one that does (`grad_accum_adjusted` event).
- `remat` / `remat_policy: nothing`: `torch.utils.checkpoint` (non
  reentrant) over the whole model apply, so the backward recomputes the
  forward. Dropout draws from a generator made inside the recomputed
  function from a seed keyed by (seed, step, microbatch), so the recompute
  draws the same mask.
- the fused loss (`ModelBundle.fused_loss`): the module returns features
  and the loss computes the lm head in vocab chunks.
- metrics `loss`, `learning_rate` (the schedule at the step before the
  update) and `grad_norm`; `eval.loss` / `eval.perplexity` on a separate
  stream every `eval_every` steps; `tokens_per_sec`, `mfu` and
  `data_wait_frac` per log window; `steps_per_sec` and `examples_per_sec`
  at the end.
- a prefetch thread (queue of 2) moves batches to the device ahead of the
  step; a log point is read one log point later, so reading it does not
  stall the device.
- `profile_start` / `profile_stop`: a `torch.profiler` window written as a
  Chrome trace to `<artifacts_dir>/profile/trace.json`; the profiler is
  kept on `Trainer.profile`.

`donate_state` is accepted and has nothing to do: PyTorch updates the
weights and optimizer state in place. Not in this slice, each raising
NotImplementedError (see ROADMAP.md): checkpoints (`checkpoint_every`,
`checkpoint_keep`, `checkpoint_local_dir`, `resume`, a `checkpoint_dir`),
mesh axes, the `dots` / `dots_no_batch` remat policies, and a program
without `data` (the reference then trains on its image dataset
`synthetic`, which the port does not have).
"""

from __future__ import annotations

import dataclasses
import queue
import re
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..data import build_data
from ..device import resolve_device
from ..models import build_model
from ..ops.losses import build_loss
from ..ops.optimizers import build_optimizer, global_norm
from ..schemas.program import V1Program, V1TrainSpec
from ..telemetry import mfu as _mfu_of
from ..telemetry import train_step_flops

_DTYPES = {"float32": torch.float32, "mixed": torch.bfloat16, "bfloat16": torch.bfloat16}


def param_dtype_for(precision: str) -> torch.dtype:
    """Master-weight dtype for a train.precision setting."""
    return torch.bfloat16 if precision == "bfloat16" else torch.float32


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
        log_fn: Optional[Callable[[int, dict], None]] = None,
        event_fn: Optional[Callable[[str, dict], None]] = None,
        checkpoint_dir: Optional[str] = None,
        artifacts_dir: Optional[str] = None,
    ):
        program = V1Program.from_dict(program)
        self.program = program
        tspec = program.train or V1TrainSpec()
        self.tspec = tspec
        unported = {
            "a program without data (the reference's image dataset "
            "'synthetic')": program.data is None,
            "mesh_axes (multi-GPU parallelism)": bool(mesh_axes),
            "checkpoint_dir": checkpoint_dir is not None,
            "train.checkpoint_every": tspec.checkpoint_every is not None,
            "train.checkpoint_keep": tspec.checkpoint_keep is not None,
            "train.checkpoint_local_dir": tspec.checkpoint_local_dir is not None,
            "train.resume": bool(tspec.resume),
            f"train.remat_policy={tspec.remat_policy}": tspec.remat_policy
            in ("dots", "dots_no_batch"),
        }
        bad = [name for name, hit in unported.items() if hit]
        if bad:
            raise NotImplementedError(
                f"{bad} are not ported to PyTorch yet (checkpoints are the next "
                "slice; see ROADMAP.md)"
            )
        self.device = resolve_device(device)
        self.artifacts_dir = artifacts_dir
        self.log_fn = log_fn or (lambda step, m: None)
        self.event_fn = event_fn
        self.compute_dtype = _DTYPES[tspec.precision]
        self.param_dtype = param_dtype_for(tspec.precision)

        self.bundle = build_model(
            program.model.name, program.model.config,
            device=self.device, dtype=torch.float32, seed=int(tspec.seed),
        )
        self.module = self.bundle.module
        if self.param_dtype != torch.float32:
            self.module.to(self.param_dtype)  # norm scales too, as _cast_floats
        dspec = program.data
        self.data = build_data(
            dspec.name, int(dspec.batch_size), dspec.config, seed=int(tspec.seed)
        )
        self.steps = int(tspec.steps)
        self.step = 0

        named = dict(self.module.named_parameters())
        pats = [re.compile(p) for p in self.bundle.trainable_patterns]
        trainable = [
            p for name, p in named.items()
            if not pats or any(pat.search(name) for pat in pats)
        ]
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

        grad_accum = int(tspec.grad_accum) if tspec.grad_accum else 1
        if grad_accum < 1:
            raise ValueError(f"train.gradAccum must be >= 1, got {grad_accum}")
        batch = self.data.batch_size
        if batch % grad_accum:
            requested = grad_accum
            grad_accum = next(g for g in range(requested, batch + 1) if batch % g == 0)
            self._event("grad_accum_adjusted", {
                "requested": requested, "effective": grad_accum,
                "global_batch": batch, "batch_shards": 1,
            })
        self.grad_accum = grad_accum
        self.profile = None
        self._profiling = False

    # -------------------------------------------------------------- step
    def _compute_params(self) -> dict[str, torch.Tensor]:
        """name → the tensor the forward uses: the master itself, or its
        cast to the compute dtype (differentiable back to the master)."""
        params = dict(self.module.named_parameters())
        if self.compute_dtype == self.param_dtype:
            return params
        return {
            n: p.to(self.compute_dtype) if p.is_floating_point() else p
            for n, p in params.items()
        }

    def _apply(self, params, inputs, seed: Optional[int]):
        kwargs: dict[str, Any] = {}
        if self.fused_loss is not None:
            kwargs["return_features"] = True
        if seed is not None and getattr(self.module.cfg, "dropout_rate", 0.0):
            gen = torch.Generator(device=self.device)
            kwargs["dropout_generator"] = gen.manual_seed(seed)
        return functional_call(self.module, params, (inputs,), kwargs)

    def _loss(self, batch, seed: int):
        params = self._compute_params()
        if self.remat:
            out = checkpoint(self._apply, params, batch["inputs"], seed, use_reentrant=False)
        else:
            out = self._apply(params, batch["inputs"], seed)
        if self.fused_loss is not None:  # `out` carries features
            return self.fused_loss(params, out, batch)
        return self.loss_fn(out, batch)

    def train_step(self, batch: dict) -> dict:
        """One optimizer update on `batch` (token tensors on the device) →
        the step's metrics as tensors/floats."""
        self.module.train()
        step, seed = self.step, int(self.tspec.seed)
        masters = list(self.module.parameters())
        for p in masters:
            p.grad = None
        if self.grad_accum == 1:
            loss = self._loss(batch, step_seed(seed, step))
            loss.backward()
            loss = loss.detach()
        else:
            A = self.grad_accum
            micro = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:]) for k, v in batch.items()}
            loss = torch.zeros((), device=self.device)
            for i in range(A):
                loss_i = self._loss({k: v[i] for k, v in micro.items()}, step_seed(seed, step, i))
                loss_i.backward()  # adds onto .grad in the master dtype
                loss = loss + loss_i.detach()
            loss = loss / A
            for p in masters:
                if p.grad is not None:
                    p.grad.div_(A)
        metrics = {
            "loss": loss.float(),
            "learning_rate": float(np.float32(self.sched(step))),
            "grad_norm": global_norm(p.grad for p in masters if p.grad is not None),
        }
        self.optimizer.step()
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        self.module.eval()
        params = self._compute_params()
        out = self._apply(params, batch["inputs"], None)
        if self.fused_loss is not None:
            loss = self.fused_loss(params, out, batch).float()
        else:
            loss = self.loss_fn(out, batch).float()
        metrics = {"eval.loss": loss}
        # cross-entropy family: loss is mean nats per token
        if "cross_entropy" in self.loss_name or self.loss_name == "masked_lm":
            metrics["eval.perplexity"] = torch.exp(loss)
        return metrics

    def load_state_dict(self, state_dict: dict) -> None:
        """Load weights (e.g. `models.convert.params_from_jax` of the JAX
        package's parameters) into the masters, cast to their dtype."""
        self.module.load_state_dict(state_dict)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}

    # -------------------------------------------------------------- loop
    def run(self) -> TrainResult:
        tspec = self.tspec
        log_every = max(1, int(tspec.log_every))
        history: list[dict] = []
        pending: Optional[tuple[int, dict]] = None
        start_step = self.step
        n_steps = self.steps - start_step

        # prefetch: host batch prep and the copy to the device run on a
        # producer thread, ahead of the step
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
        t0 = time.perf_counter()
        self._win = {"t0": t0, "steps": 0, "wait": 0.0, "busy": 0.0}
        try:
            for step in range(start_step, self.steps):
                if prof_start is not None and step == prof_start and self.artifacts_dir:
                    self._start_profiler()
                t_wait = time.perf_counter()
                batch = feed.get()
                t_busy = time.perf_counter()
                if isinstance(batch, BaseException):
                    raise batch
                metrics = self.train_step(batch)
                if self._profiling and prof_stop is not None and step + 1 >= prof_stop:
                    self._stop_profiler()
                if (step + 1) % log_every == 0 or step + 1 == self.steps:
                    # flush the previous log point first: one log point of
                    # pipelining, so reading it never stalls the device
                    if pending is not None:
                        self._emit(history, *pending)
                    pending = (step + 1, metrics)
                if eval_every and ((step + 1) % eval_every == 0 or step + 1 == self.steps):
                    eval_metrics = self._evaluate(eval_steps)
                    if pending is not None:
                        self._emit(history, *pending)
                        pending = None
                    self._emit(history, step + 1, eval_metrics)
                t_end = time.perf_counter()
                self._win["steps"] += 1
                self._win["wait"] += t_busy - t_wait
                self._win["busy"] += t_end - t_busy
            self._stop_profiler()
            if pending is not None:
                self._emit(history, *pending)
        finally:
            stop.set()
            producer.join(timeout=10)
        elapsed = time.perf_counter() - t0
        sps = n_steps / elapsed if elapsed > 0 else 0.0
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
            dspec = self.program.data
            self._eval_data = build_data(
                dspec.name,
                self.data.batch_size,
                dspec.config,
                seed=int(self.tspec.seed),
                process_index=7919,
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
        dt = time.perf_counter() - w["t0"]
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
                sps * self._flops_per_step, torch.cuda.get_device_name(self.device)
            )
            if mfu is not None:
                out["mfu"] = mfu
        self._win = {"t0": time.perf_counter(), "steps": 0, "wait": 0.0, "busy": 0.0}
        return out

    def _emit(self, history, step, metrics):
        vals = {k: float(v) for k, v in metrics.items()}
        vals.update(self._drain_window())
        history.append({"step": step, **vals})
        self.log_fn(step, vals)

    def _event(self, kind: str, body: dict):
        """Lifecycle events to the caller's sink; advisory — a sink fault
        never fails training."""
        if self.event_fn is None:
            return
        try:
            self.event_fn(kind, body)
        except Exception:  # noqa: BLE001
            pass
