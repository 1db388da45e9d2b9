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

Schedules are plain functions `step -> learning rate`. All eight of the
reference's rules are here: sgd, adam, adamw, lamb, lion, adafactor,
rmsprop and adagrad, each with optax 0.2.6's defaults and options, among
them `nesterov` (adam, adamw) and the moment dtypes (`mu_dtype` of adam,
adamw and lion, sgd's `accumulator_dtype`, adafactor's `dtype_momentum`,
given as a torch dtype or a name such as "bfloat16"). The `mask` of
adamw, lamb and lion and adafactor's `weight_decay_mask` say which
parameters take weight decay, as optax's do: a mapping from parameter
names to bools, or a callable that takes the named parameters and returns
one; the optimizer is then built over the named parameters ({name:
tensor}), and a masked-out parameter's update leaves the decay out (its
own param group, with the decay off).

Sharded parameters (DTensors, under the trainer's mesh) keep sharded
states. The element-wise rules update each rank's local shards; lamb's
norms and adafactor's means run as DTensor reductions over the whole
tensor. `global_norm` sums each shard's squares and all-reduces them over
the mesh dims that shard the tensor, never over one that replicates it.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]

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
def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), or `t` itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _splits(placement) -> bool:
    """True for a placement that splits the tensor over its mesh dim
    (`Shard`, and `_StridedShard`, which is not a `Shard`)."""
    from torch.distributed.tensor.placement_types import _StridedShard

    return placement.is_shard() or isinstance(placement, _StridedShard)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares of every element, f32.
    A DTensor adds its local shard's squares, all-reduced over the mesh
    dims that shard it (those that replicate it count it once)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    total = 0
    sharded: dict = {}
    for t in tensors:
        if isinstance(t, DTensor):
            dims = tuple(i for i, pl in enumerate(t.placements) if _splits(pl))
            entry = sharded.setdefault((id(t.device_mesh), dims), (t.device_mesh, dims, []))
            entry[2].append(t.to_local().float().pow(2).sum())
        else:
            total = total + t.float().pow(2).sum()
    for mesh, dims, sums in sharded.values():
        part = torch.stack(sums).sum()
        for d in dims:
            dist.all_reduce(part, group=mesh.get_group(d))
        total = total + part
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale `grads` in place by max_norm / norm when norm >= max_norm (no
    epsilon, no host sync): optax.clip_by_global_norm."""
    if not grads:
        return
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g = _local(g)
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


# ------------------------------------------------------------------ optimizers
class _OptaxRule(torch.optim.Optimizer):
    """Base of the ported rules: one learning-rate schedule over all
    groups, read at the count of updates made so far, and optional global
    clipping of the group's gradients first.

    The state of every parameter is made when the optimizer is built, as
    optax's `init` makes it, so a checkpoint restore has tensors to copy
    into. `count` (optax's `count` leaves: the updates made so far) is
    carried by `state_dict` and `load_state_dict`."""

    def __init__(self, params, schedule: Schedule, grad_clip_norm, **defaults):
        if isinstance(params, Mapping):  # named, without a mask: one group
            params = list(params.values())
        super().__init__(params, defaults)
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.count = 0
        for group in self.param_groups:
            for p in group["params"]:
                self._init_state(p, self.state[p], group)

    # the update of each element reads only that element: on sharded
    # parameters it runs on the local shards
    elementwise = True

    def _init_state(self, p, state, group) -> None:
        pass

    def state_dict(self) -> dict:
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        self.count = count
        # torch casts loaded state to its parameter's dtype; a moment kept
        # in another dtype (mu_dtype and the like) goes back to it
        for group in self.param_groups:
            for p in group["params"]:
                fresh: dict = {}
                self._init_state(p, fresh, group)
                state = self.state[p]
                for k, v in fresh.items():
                    if k in state and state[k].dtype != v.dtype:
                        state[k] = state[k].to(v.dtype)

    @torch.no_grad()
    def step(self):
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        if self.grad_clip_norm:
            clip_by_global_norm([p.grad for p in params], float(self.grad_clip_norm))
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad.to(p.dtype), self.state[p]
                if self.elementwise:
                    p, g, state = _local(p), _local(g), {k: _local(v) for k, v in state.items()}
                self._update(p, g, state, group, lr)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in f32, the power taken in f32 as optax's
    `bias_correction` takes it: at small counts 1 - b2 ** t cancels, so
    one ulp of the power is ~1e-5 of the correction."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _ema_(moment: torch.Tensor, value: torch.Tensor, decay: float) -> torch.Tensor:
    """optax's `update_moment` in place: (1 - decay) * value + decay * moment."""
    return moment.mul_(decay).add_(value, alpha=1 - decay)


_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
}


def _dtype(spec) -> Optional[torch.dtype]:
    """A moment dtype option (None, a torch dtype, or a name optax accepts
    such as "bfloat16" or "float32") → torch dtype or None."""
    if spec is None or isinstance(spec, torch.dtype):
        return spec
    name = str(spec).removeprefix("jnp.").removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(f"unknown moment dtype {spec!r}; one of {sorted(_DTYPES)}")
    return _DTYPES[name]


def _weak_mul(scalar: float, t: torch.Tensor) -> torch.Tensor:
    """scalar * t as jax computes it: the Python scalar takes t's dtype
    first, so a bf16 moment is scaled by bf16(scalar)."""
    return t * torch.tensor(scalar, dtype=t.dtype, device=t.device)


def _moment(stored: torch.Tensor, value: torch.Tensor, decay: float) -> torch.Tensor:
    """optax's `update_moment` with the stored moment in its own dtype:
    (1 - decay) * value + decay * stored, in value's dtype, not cast back
    (optax updates with the uncast moment and casts only what it keeps).
    In place when the dtypes agree."""
    if stored.dtype == value.dtype:
        return _ema_(stored, value, decay)
    return (1 - decay) * value + _weak_mul(decay, stored)


def _keep(state: dict, name: str, value: torch.Tensor) -> None:
    """Store a moment in its state dtype (a no-op after an in-place update)."""
    if state[name] is not value:
        state[name].copy_(value)


def _decay_groups(params, mask, key: str, off):
    """`params` (a list, or {name: tensor}) as param groups under a decay
    `mask` (optax's `mask` / `weight_decay_mask`): the masked-in parameters,
    then the masked-out ones with `key` set to `off` (no decay). A mask
    needs the named parameters and must name every one."""
    if mask is None:
        return params
    if not isinstance(params, Mapping):
        raise ValueError(f"a {key} mask needs the named parameters ({{name: tensor}})")
    named = dict(params)
    flags = mask(named) if callable(mask) else mask
    missing = sorted(set(named) - set(flags))
    if missing:
        raise ValueError(f"the {key} mask does not name {missing}")
    on = [p for n, p in named.items() if flags[n]]
    out = [p for n, p in named.items() if not flags[n]]
    return ([{"params": on}] if on else []) + ([{"params": out, key: off}] if out else [])


class Adam(_OptaxRule):
    """optax.adam / optax.adamw (decoupled weight decay added to the update
    before the learning rate, as `add_decayed_weights` does)."""

    def __init__(self, params, schedule, *, b1=0.9, b2=0.999, eps=1e-8,
                 eps_root=0.0, weight_decay=0.0, mu_dtype=None, nesterov=False,
                 grad_clip_norm=None):
        super().__init__(
            params, schedule, grad_clip_norm,
            b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay,
            mu_dtype=_dtype(mu_dtype), nesterov=bool(nesterov),
        )

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p, dtype=group.get("mu_dtype"))
        state["nu"] = torch.zeros_like(p)

    def _direction(self, p, g, state, group) -> torch.Tensor:
        """scale_by_adam (Nesterov's form when asked), then
        add_decayed_weights. The update uses the moment before it is cast
        to `mu_dtype` for keeping, as optax's does."""
        b1, b2 = group["b1"], group["b2"]
        mu = _moment(state["mu"], g, b1)
        nu = state["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
        c1, c2 = _bias_correction(b1, self.count), _bias_correction(b2, self.count)
        if group.get("nesterov"):
            mu_hat = (b1 * (mu / _bias_correction(b1, self.count + 1))
                      + (1 - b1) * (g / c1))
        else:
            mu_hat = mu / c1
        update = mu_hat / (torch.sqrt(nu / c2 + group["eps_root"]) + group["eps"])
        _keep(state, "mu", mu)
        if group["weight_decay"]:
            update = update + group["weight_decay"] * p
        return update

    def _update(self, p, g, state, group, lr):
        p.add_(self._direction(p, g, state, group) * -lr)


class Lamb(Adam):
    """optax.lamb: Adam's direction (eps 1e-6) plus decayed weights, scaled
    per parameter by the trust ratio ||p|| / ||update||, which is 1 where
    either norm is zero."""

    elementwise = False

    def __init__(self, params, schedule, *, b1=0.9, b2=0.999, eps=1e-6,
                 eps_root=0.0, weight_decay=0.0, mask=None, grad_clip_norm=None):
        super().__init__(_decay_groups(params, mask, "weight_decay", 0.0), schedule, b1=b1,
                         b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay,
                         grad_clip_norm=grad_clip_norm)

    def _update(self, p, g, state, group, lr):
        update = self._direction(p, g, state, group)
        p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(update)
        ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
        p.add_(update * ratio * -lr)


class Lion(_OptaxRule):
    """optax.lion: sign((1 - b1) g + b1 mu), mu then updated with b2, plus
    decayed weights (default 1e-3)."""

    def __init__(self, params, schedule, *, b1=0.9, b2=0.99, weight_decay=1e-3,
                 mu_dtype=None, mask=None, grad_clip_norm=None):
        super().__init__(_decay_groups(params, mask, "weight_decay", 0.0), schedule,
                         grad_clip_norm, b1=b1, b2=b2,
                         weight_decay=weight_decay, mu_dtype=_dtype(mu_dtype))

    def _init_state(self, p, state, group):
        state["mu"] = torch.zeros_like(p, dtype=group.get("mu_dtype"))

    def _update(self, p, g, state, group, lr):
        b1 = group["b1"]
        update = torch.sign((1.0 - b1) * g + _weak_mul(b1, state["mu"]))
        _keep(state, "mu", _moment(state["mu"], g, group["b2"]))
        if group["weight_decay"]:
            update = update + group["weight_decay"] * p
        p.add_(update * -lr)


def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int):
    """optax's `_factored_dims`: (second largest, largest) axis when the
    second largest is at least `min_dim_size_to_factor`, else None."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_OptaxRule):
    """optax.adafactor: the second moment of a parameter whose two largest
    dims are >= `min_dim_size_to_factor` is kept as a row and a column
    mean (`v_row` over the largest dim, `v_col` over the second largest),
    else in full (`v`); decay 1 - (t + 1) ** -decay_rate; the update
    clipped to RMS `clipping_threshold`, times the learning rate, times the
    parameter's RMS (at least 1e-3); optional momentum (an EMA, not
    debiased) and weight decay (not scaled by the learning rate). The
    factored estimate v_row ⊗ v_col / mean(v_row) is the same for a matrix
    and its transpose."""

    elementwise = False

    def __init__(self, params, schedule, *, min_dim_size_to_factor=128, decay_rate=0.8,
                 decay_offset=0, multiply_by_parameter_scale=True, clipping_threshold=1.0,
                 momentum=None, weight_decay_rate=None, eps=1e-30, factored=True,
                 dtype_momentum="float32", weight_decay_mask=None,
                 grad_clip_norm=None):
        super().__init__(
            _decay_groups(params, weight_decay_mask, "weight_decay_rate", None), schedule,
            grad_clip_norm,
            min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
            decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            weight_decay_rate=weight_decay_rate, eps=eps, factored=factored,
            dtype_momentum=_dtype(dtype_momentum),
        )

    @staticmethod
    def dims(p, group):
        return _factored_dims(tuple(p.shape), group["factored"], group["min_dim_size_to_factor"])

    def _init_state(self, p, state, group):
        dims = self.dims(p, group)
        if dims is None:
            state["v"] = torch.zeros_like(p)
        else:
            for name, dropped in zip(("v_row", "v_col"), reversed(dims)):
                shape = [n for i, n in enumerate(p.shape) if i != dropped]
                state[name] = p.new_zeros(shape)
        if group["momentum"] is not None:
            # optax's ema keeps its accumulator in dtype_momentum (f32 by
            # default), whatever the parameter's dtype
            state["ema"] = torch.zeros_like(p, dtype=group.get("dtype_momentum"))

    def _update(self, p, g, state, group, lr):
        t = np.float32(self.count - group["decay_offset"])  # optax: its count + 1
        decay = float(np.float32(1) - t ** np.float32(-group["decay_rate"]))
        grad_sqr = g * g + group["eps"]
        dims = self.dims(p, group)
        if dims is None:
            v = state["v"].mul_(decay).add_(grad_sqr, alpha=1 - decay)
            update = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row = state["v_row"].mul_(decay).add_(grad_sqr.mean(dim=d0), alpha=1 - decay)
            v_col = state["v_col"].mul_(decay).add_(grad_sqr.mean(dim=d1), alpha=1 - decay)
            row_mean = v_row.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
            row_factor = (v_row / row_mean) ** -0.5
            update = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        if group["clipping_threshold"] is not None:
            rms = torch.sqrt(torch.mean(update * update))
            update = update / torch.clamp(rms / group["clipping_threshold"], min=1.0)
        update = update * lr
        if group["multiply_by_parameter_scale"]:
            p_rms = torch.sqrt(torch.mean(p * p))
            update = update * torch.where(p_rms <= 1e-3, 1e-3, p_rms)
        if group["momentum"] is not None:
            update = _moment(state["ema"], update, group["momentum"])
            _keep(state, "ema", update)
        if group["weight_decay_rate"] is not None:
            update = update + group["weight_decay_rate"] * p
        p.sub_(update)


class RMSProp(_OptaxRule):
    """optax.rmsprop: nu starts at `initial_scale`; the scaling is
    1 / sqrt(nu + eps) with `eps_in_sqrt` (the default), else
    1 / (sqrt(nu) + eps); `centered` subtracts the squared first moment;
    `bias_correction` divides the moments by 1 - decay ** t; momentum (a
    trace, optionally Nesterov) runs after the learning rate."""

    def __init__(self, params, schedule, *, decay=0.9, eps=1e-8, initial_scale=0.0,
                 eps_in_sqrt=True, centered=False, momentum=None, nesterov=False,
                 bias_correction=False, grad_clip_norm=None):
        super().__init__(
            params, schedule, grad_clip_norm, decay=decay, eps=eps,
            initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt, centered=centered,
            momentum=momentum, nesterov=nesterov, bias_correction=bias_correction,
        )

    def _init_state(self, p, state, group):
        state["nu"] = torch.full_like(p, group["initial_scale"])
        if group["centered"]:
            state["mu"] = torch.zeros_like(p)
        if group["momentum"] is not None:
            state["trace"] = torch.zeros_like(p)

    def _update(self, p, g, state, group, lr):
        decay, eps = group["decay"], group["eps"]
        nu = state["nu"].mul_(decay).addcmul_(g, g, value=1 - decay)
        mu = _ema_(state["mu"], g, decay) if group["centered"] else None
        if group["bias_correction"]:
            c = _bias_correction(decay, self.count)
            nu = nu / c
            mu = mu / c if mu is not None else None
        if mu is not None:
            nu = nu - mu * mu
        scaling = torch.rsqrt(nu + eps) if group["eps_in_sqrt"] else 1 / (torch.sqrt(nu) + eps)
        update = scaling * g * -lr
        m = group["momentum"]
        if m is not None:
            trace = state["trace"].mul_(m).add_(update)
            update = update + m * trace if group["nesterov"] else trace
        p.add_(update)


class Adagrad(_OptaxRule):
    """optax.adagrad: the sum of squares starts at
    `initial_accumulator_value` (0.1); the update is g / sqrt(sum + eps)
    (eps 1e-7), 0 where the sum is 0."""

    def __init__(self, params, schedule, *, initial_accumulator_value=0.1, eps=1e-7,
                 grad_clip_norm=None):
        super().__init__(params, schedule, grad_clip_norm,
                         initial_accumulator_value=initial_accumulator_value, eps=eps)

    def _init_state(self, p, state, group):
        state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])

    def _update(self, p, g, state, group, lr):
        sos = state["sum_of_squares"].addcmul_(g, g)
        inv = torch.where(sos > 0, torch.rsqrt(sos + group["eps"]), 0.0)
        p.add_(inv * g * -lr)


class SGD(_OptaxRule):
    """optax.sgd: trace g + momentum * trace (no dampening), Nesterov as
    optax writes it."""

    def __init__(self, params, schedule, *, momentum=None, nesterov=False,
                 accumulator_dtype=None, grad_clip_norm=None):
        super().__init__(
            params, schedule, grad_clip_norm, momentum=momentum, nesterov=nesterov,
            accumulator_dtype=_dtype(accumulator_dtype),
        )

    def _init_state(self, p, state, group):
        if group["momentum"]:
            state["trace"] = torch.zeros_like(p, dtype=group.get("accumulator_dtype"))

    def _update(self, p, g, state, group, lr):
        m = group["momentum"]
        if m:
            stored = state["trace"]
            if stored.dtype == g.dtype:
                trace = stored.mul_(m).add_(g)
            else:  # optax's trace: g + decay * t, kept in the accumulator dtype
                trace = g + _weak_mul(m, stored)
                stored.copy_(trace)
            g = g + m * trace if group["nesterov"] else trace
        p.add_(g * -lr)


def _adamw(params, schedule, *, weight_decay=1e-4, mask=None, **kw):
    return Adam(_decay_groups(params, mask, "weight_decay", 0.0), schedule,
                weight_decay=weight_decay, **kw)


_OPTIMIZERS: dict[str, Callable[..., _OptaxRule]] = {
    "sgd": SGD,
    "adam": Adam,
    "adamw": _adamw,
    "lamb": Lamb,
    "lion": Lion,
    "adafactor": Adafactor,
    "rmsprop": RMSProp,
    "adagrad": Adagrad,
}


def build_optimizer(
    params: Iterable[torch.Tensor],
    name: str = "adamw",
    learning_rate: float = 1e-3,
    config: Optional[dict[str, Any]] = None,
    schedule: Optional[dict[str, Any]] = None,
    total_steps: int = 1000,
) -> tuple[torch.optim.Optimizer, Schedule]:
    """(optimizer over `params`, its schedule). `params`: the tensors, or
    {name: tensor} (what a decay mask names). `config` holds the rule's
    keyword arguments (optax's names) and `grad_clip_norm`."""
    if name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; one of {sorted(_OPTIMIZERS)}")
    config = dict(config or {})
    grad_clip = config.pop("grad_clip_norm", None)
    sched = build_schedule(float(learning_rate), schedule, total_steps)
    params = dict(params) if isinstance(params, Mapping) else list(params)
    opt = _OPTIMIZERS[name](params, sched, grad_clip_norm=grad_clip, **config)
    return opt, sched
