"""Framework callbacks that log a third-party training loop into the
tracked run (an own copy of `polyaxon_tpu/tracking/callbacks.py`):

- `polyaxon_log_fn()`: a `(step, metrics)` callable for the port's
  Trainer (`log_fn=`) or any loop of one's own;
- `PolyaxonHFCallback`: for `transformers.Trainer(callbacks=[...])`. The
  port imports no `transformers`, so it is a plain class with every
  event of `transformers.TrainerCallback` (each a no-op, as there) and
  the reference's `on_log` and `on_train_end`; the reference subclasses
  `TrainerCallback` where it can import it;
- `PolyaxonKerasCallback`: the Keras callback protocol, duck-typed.

Each attaches to the active tracked run (`tracking.init()`, the
`POLYAXON_RUN_*` variables) unless given one.
"""

from __future__ import annotations

from typing import Any, Optional

from .run import Run, get_or_create_run


def polyaxon_log_fn(run: Optional[Run] = None):
    run = run or get_or_create_run()

    def log_fn(step: int, metrics: dict[str, Any]):
        run.log_metrics(step=step, **{k: float(v) for k, v in metrics.items()})

    return log_fn


def _numbers(logs: Optional[dict]) -> dict[str, float]:
    return {k: float(v) for k, v in (logs or {}).items() if isinstance(v, (int, float))}


class _Attached:
    def __init__(self, run: Optional[Run] = None):
        self._run = run

    @property
    def run(self) -> Run:
        if self._run is None:
            self._run = get_or_create_run()
        return self._run


class PolyaxonHFCallback(_Attached):
    """`transformers.Trainer(callbacks=[PolyaxonHFCallback()])`: each
    logging step's numbers as a metrics row, the final step and epoch as
    outputs."""

    def on_log(self, args, state, control, logs=None, **kwargs):
        metrics = _numbers(logs)
        if metrics:
            self.run.log_metrics(step=int(state.global_step), **metrics)

    def on_train_end(self, args, state, control, **kwargs):
        self.run.log_outputs(global_step=int(state.global_step), epochs=float(state.epoch or 0))

    # the other events of transformers.TrainerCallback
    def on_init_end(self, args, state, control, **kwargs): ...
    def on_train_begin(self, args, state, control, **kwargs): ...
    def on_epoch_begin(self, args, state, control, **kwargs): ...
    def on_epoch_end(self, args, state, control, **kwargs): ...
    def on_step_begin(self, args, state, control, **kwargs): ...
    def on_pre_optimizer_step(self, args, state, control, **kwargs): ...
    def on_optimizer_step(self, args, state, control, **kwargs): ...
    def on_substep_end(self, args, state, control, **kwargs): ...
    def on_step_end(self, args, state, control, **kwargs): ...
    def on_evaluate(self, args, state, control, **kwargs): ...
    def on_predict(self, args, state, control, metrics, **kwargs): ...
    def on_save(self, args, state, control, **kwargs): ...
    def on_prediction_step(self, args, state, control, **kwargs): ...


class PolyaxonKerasCallback(_Attached):
    """The Keras callback protocol: `model.fit(..., callbacks=[cb])`; each
    epoch's numbers as a metrics row, the final logs as outputs."""

    def __init__(self, run: Optional[Run] = None):
        super().__init__(run)
        self.params: dict = {}
        self.model = None

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_epoch_end(self, epoch: int, logs: Optional[dict] = None):
        metrics = _numbers(logs)
        if metrics:
            self.run.log_metrics(step=int(epoch), **metrics)

    def on_train_end(self, logs: Optional[dict] = None):
        if logs:
            self.run.log_outputs(**_numbers(logs))

    # the protocol's other slots, which Keras calls
    def on_train_begin(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_batch_begin(self, batch, logs=None): ...
    def on_batch_end(self, batch, logs=None): ...
    def on_train_batch_begin(self, batch, logs=None): ...
    def on_train_batch_end(self, batch, logs=None): ...
    def on_test_begin(self, logs=None): ...
    def on_test_end(self, logs=None): ...
    def on_test_batch_begin(self, batch, logs=None): ...
    def on_test_batch_end(self, batch, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_predict_batch_begin(self, batch, logs=None): ...
    def on_predict_batch_end(self, batch, logs=None): ...
