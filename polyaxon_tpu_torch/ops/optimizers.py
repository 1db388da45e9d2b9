"""Optimizer + LR-schedule factory for `program.optimizer`, counterpart of
`polyaxon_tpu/ops/optimizers.py`.

    optimizer: {name: adamw, learningRate: 3e-4,
                config: {weight_decay: 0.01}, schedule: {name: cosine, ...}}

The reference builds optax transformations; this port writes the same
update rules as `torch.optim.Optimizer`s so that a run matches optax step
for step:

- optax's defaults, not torch's: adamw `weight_decay=1e-4`, b1 0.9, b2
  0.999, eps 1e-8 added outside the square root (`eps_root` inside);
- the learning rate of an update is `schedule(count)` at the count of
  updates before it (optax's `scale_by_learning_rate`);
- `grad_clip_norm` is optax's `clip_by_global_norm`: grads are scaled by
  `max / norm` only when `norm >= max`, with no epsilon (unlike
  `torch.nn.utils.clip_grad_norm_`).

Schedules are plain functions `step -> learning rate`. lamb, lion,
adafactor, rmsprop and adagrad are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]

_UNPORTED = ("lamb", "lion", "adafactor", "rmsprop", "adagrad")


# ------------------------------------------------------------------ schedules
def _constant(value: float) -> Schedule:
    return lambda step: value


def _linear(init: float, end: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule (polynomial, power 1, from step 0)."""
    if transition_steps <= 0:
        return _constant(init)

    def schedule(step):
        count = min(max(step, 0), transition_steps)
        return (init - end) * (1 - count / transition_steps) + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""

    def schedule(step):
        count = min(step, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * decay + alpha)

    return schedule


def _piecewise(init: float, boundaries: dict[int, float]) -> Schedule:
    """optax.piecewise_constant_schedule: scaled at each step >= boundary."""

    def schedule(step):
        value = init
        for threshold, scale in sorted(boundaries.items()):
            if step >= threshold:
                value *= scale
        return value

    return schedule


def _exponential(init: float, steps: int, rate: float, staircase: bool) -> Schedule:
    """optax.exponential_decay (transition_begin 0, no end value)."""
    if rate == 0:
        return _constant(init)

    def schedule(step):
        if step <= 0:
            return init
        p = step / steps
        return init * rate ** (math.floor(p) if staircase else p)

    return schedule


def _join(warmup: Schedule, main: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules: the second schedule restarts at the boundary."""
    return lambda step: warmup(step) if step < boundary else main(step - boundary)


def build_schedule(
    base_lr: float, spec: Optional[dict[str, Any]], total_steps: int
) -> Schedule:
    """schedule: {name: cosine|linear|constant|rsqrt|step|exponential,
    warmup_steps: N, ...} → step -> learning rate."""
    if not spec:
        return _constant(base_lr)
    spec = dict(spec)
    name = spec.pop("name", "constant")
    warmup = int(spec.pop("warmup_steps", 0))
    decay_steps = max(1, int(spec.pop("decay_steps", total_steps)) - warmup)
    if name == "constant":
        sched = _constant(base_lr)
    elif name == "cosine":
        sched = _cosine(base_lr, decay_steps, float(spec.pop("alpha", 0.0)))
    elif name == "linear":
        sched = _linear(base_lr, float(spec.pop("end_value", 0.0)), decay_steps)
    elif name == "rsqrt":
        # rsqrt decay from the warmup point, classic transformer schedule
        shift = max(warmup, 1)
        sched = lambda step: base_lr * (shift**0.5) / ((step + shift) ** 0.5)  # noqa: E731
    elif name == "step":
        boundaries = spec.pop("boundaries", [])
        scales = spec.pop("scales", [0.1] * len(boundaries))
        sched = _piecewise(
            base_lr, {int(b): float(s) for b, s in zip(boundaries, scales)}
        )
    elif name == "exponential":
        sched = _exponential(
            base_lr, decay_steps, float(spec.pop("decay_rate", 0.96)),
            bool(spec.pop("staircase", False)),
        )
    else:
        raise ValueError(f"unknown schedule {name!r}")
    if warmup > 0:
        sched = _join(_linear(0.0, base_lr, warmup), sched, warmup)
    return sched


# ------------------------------------------------------------------ clipping
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element, f32."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale `grads` in place by max_norm / norm when norm >= max_norm (no
    epsilon, no host sync): optax.clip_by_global_norm."""
    if not grads:
        return
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


# ------------------------------------------------------------------ optimizers
class _OptaxRule(torch.optim.Optimizer):
    """Base of the ported rules: one learning-rate schedule over all
    groups, read at the count of updates made so far, and optional global
    clipping of the group's gradients first."""

    def __init__(self, params, schedule: Schedule, grad_clip_norm, **defaults):
        super().__init__(params, defaults)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.count = 0

    @torch.no_grad()
    def step(self):
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        if self.grad_clip_norm:
            clip_by_global_norm([p.grad for p in params], float(self.grad_clip_norm))
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, self.state[p], group, lr)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in f32, the power taken in f32 as optax's
    `bias_correction` takes it: at small counts 1 - b2 ** t cancels, so
    one ulp of the power is ~1e-5 of the correction."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Adam(_OptaxRule):
    """optax.adam / optax.adamw (decoupled weight decay added to the update
    before the learning rate, as `add_decayed_weights` does)."""

    def __init__(self, params, schedule, *, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, weight_decay=0.0, grad_clip_norm=None):
        super().__init__(
            params, schedule, grad_clip_norm,
            b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay,
        )

    def _update(self, p, g, state, group, lr):
        b1, b2 = group["b1"], group["b2"]
        if not state:
            state["t"] = 0
            state["mu"] = torch.zeros_like(p)
            state["nu"] = torch.zeros_like(p)
        state["t"] += 1
        t = state["t"]
        mu, nu = state["mu"], state["nu"]
        g = g.to(p.dtype)
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        c1, c2 = _bias_correction(b1, t), _bias_correction(b2, t)
        update = (mu / c1) / (torch.sqrt(nu / c2 + group["eps_root"]) + group["eps"])
        if group["weight_decay"]:
            update = update + group["weight_decay"] * p
        p.add_(update * -lr)


class SGD(_OptaxRule):
    """optax.sgd: trace g + momentum * trace (no dampening), Nesterov as
    optax writes it."""

    def __init__(self, params, schedule, *, momentum=None, nesterov=False,
                 grad_clip_norm=None):
        super().__init__(
            params, schedule, grad_clip_norm, momentum=momentum, nesterov=nesterov
        )

    def _update(self, p, g, state, group, lr):
        g = g.to(p.dtype)
        m = group["momentum"]
        if m:
            if not state:
                state["trace"] = torch.zeros_like(p)
            trace = state["trace"].mul_(m).add_(g)
            g = g + m * trace if group["nesterov"] else trace
        p.add_(g * -lr)


def _adamw(params, schedule, *, weight_decay=1e-4, **kw):
    return Adam(params, schedule, weight_decay=weight_decay, **kw)


_OPTIMIZERS: dict[str, Callable[..., _OptaxRule]] = {
    "sgd": SGD,
    "adam": Adam,
    "adamw": _adamw,
}


def build_optimizer(
    params: Iterable[torch.Tensor],
    name: str = "adamw",
    learning_rate: float = 1e-3,
    config: Optional[dict[str, Any]] = None,
    schedule: Optional[dict[str, Any]] = None,
    total_steps: int = 1000,
) -> tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer over `params`, its schedule). `config` holds the rule's
    keyword arguments (optax's names) and `grad_clip_norm`."""
    if name in _UNPORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported to PyTorch yet (see ROADMAP.md)"
        )
    if name not in _OPTIMIZERS:
        known = sorted((*_OPTIMIZERS, *_UNPORTED))
        raise ValueError(f"unknown optimizer {name!r}; one of {known}")
    config = dict(config or {})
    grad_clip = config.pop("grad_clip_norm", None)
    sched = build_schedule(float(learning_rate), schedule, total_steps)
    opt = _OPTIMIZERS[name](list(params), sched, grad_clip_norm=grad_clip, **config)
    return opt, sched
