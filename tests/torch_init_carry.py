"""Carries the JAX trainers' initial params into the port's trainers, for
tests that run the same runs through both packages: `recording()` around
the JAX runs keeps each JAX trainer's initial params in order, and
`loading()` around the port's runs loads them (`params_from_jax`) into
the port's trainers in the same order."""

import contextlib

import jax
import numpy as np
import pytest

from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.runtime import Trainer


class InitCarry:
    def __init__(self):
        self.params: list = []
        self.loaded = 0

    @contextlib.contextmanager
    def recording(self):
        jax_init = JaxTrainer.__init__

        def record(trainer, *a, **kw):
            jax_init(trainer, *a, **kw)
            self.params.append(jax.tree.map(np.asarray, trainer.state.params))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxTrainer, "__init__", record)
            yield

    @contextlib.contextmanager
    def loading(self):
        port_init = Trainer.__init__

        def load(trainer, *a, **kw):
            port_init(trainer, *a, **kw)
            init = self.params[self.loaded]
            self.loaded += 1
            trainer.load_state_dict(params_from_jax(init, getattr(trainer.module, "cfg", None)))

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Trainer, "__init__", load)
            yield
