"""The port's Trainer against the JAX package's Trainer, on the CPU: the
`fused-accum`, `lora` and `flash` runs of `tests/test_torch_trainer.py`'s
RUNS (same programs, same shared initial parameters, same tolerances; see
that file's docstring). They sit in a file of their own so their JAX
compiles run on another worker than the float32 and mixed runs.
"""

import pytest
import torch

from polyaxon_tpu_torch.models.convert import params_from_jax
from test_torch_trainer import check_final_params, check_step_metrics, run_pair

VARIANTS = ["fused-accum", "lora", "flash"]


@pytest.mark.parametrize("name", VARIANTS)
def test_step_metrics_match_jax(name):
    check_step_metrics(name)


@pytest.mark.parametrize("name", VARIANTS)
def test_final_params_match_jax(name):
    check_final_params(name)


def test_lora_freezes_the_base():
    """Only lora_a/lora_b move; every other weight ends bit-equal to its
    start, on both sides."""
    _, init, final, trainer, _ = run_pair("lora")
    cfg = trainer.module.cfg
    start, want = params_from_jax(init, cfg), params_from_jax(final, cfg)
    ours = trainer.module.state_dict()
    lora = [k for k in ours if k.endswith(("lora_a", "lora_b"))]
    assert lora and all(".q_proj." in k for k in lora)
    for k in ours:
        if k in lora:
            assert not torch.equal(ours[k], start[k]), k
        else:
            assert torch.equal(ours[k], start[k]), k
            assert torch.equal(want[k], start[k]), k
