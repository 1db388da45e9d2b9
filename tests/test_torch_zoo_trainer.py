"""The port's Trainer on each zoo family against the JAX package's Trainer,
on the CPU: the same tiny program on both sides from the JAX trainer's own
initial params (and `batch_stats`), carried over by `params_from_jax`; the
JAX trainer pinned to one device; the streams byte-identical
(`test_torch_data.py`), so both runs see the same batches.

Per step the loss, grad_norm and (classification) accuracy, and at the end
ResNet's running statistics. Tolerances:
- float32: loss and grad_norm within 5e-5 relative, as the transformer
  trainer tests (f32 sum order; read: up to 1.4e-6 and 5.1e-6, on ResNet),
  accuracy equal, running statistics within 5e-5 of each buffer's largest
  magnitude (read: 1.4e-6, under remat: a second update a step would be
  far outside);
- mixed, seq2seq: loss within 5e-4 and grad_norm within 5e-3 relative, as
  the transformer trainer's mixed case (both sides round the same tensors
  to bf16, not always to the same side; read: 1.0e-4 and 1.2e-3).
ResNet's dtypes under `mixed` are held in `test_torch_zoo.py`.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from polyaxon_tpu.runtime.trainer import Trainer as JaxTrainer
from polyaxon_tpu.schemas.run_kinds import V1Program as JaxProgram

from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.runtime import Trainer

STEPS = 3
ADAMW = {"name": "adamw", "learningRate": 3e-3,
         "schedule": {"name": "cosine", "warmup_steps": 1},
         "config": {"grad_clip_norm": 1.0}}


def program(model, data, optimizer=ADAMW, **train):
    prog = {"model": model, "optimizer": optimizer,
            "train": {"steps": STEPS, "logEvery": 1, "precision": "float32", **train}}
    if data is not None:
        prog["data"] = data
    return prog


IMAGES = {"name": "synthetic_imagenet", "batchSize": 4,
          "config": {"image_size": 32, "num_classes": 10}}
RESNET = {"name": "resnet", "config": {"depth": 18, "width": 8, "num_classes": 10,
                                      "image_size": 32}}
SGD = {"name": "sgd", "learningRate": 0.1, "config": {"momentum": 0.9, "nesterov": True},
       "schedule": {"name": "cosine", "warmup_steps": 1}}  # examples/resnet50.yaml's rule
RUNS = {
    "mlp": program({"name": "mlp", "config": {"hidden": [64, 32]}},
                   {"name": "mnist", "batchSize": 8, "config": {"flat": False}},
                   evalEvery=3, evalSteps=1),
    "no-data": program({"name": "mlp", "config": {"input_dim": 32, "hidden": [16]}}, None),
    "resnet-remat": program(RESNET, IMAGES, SGD, remat=True),
    "vit": program({"name": "vit", "config": {"preset": "tiny-test", "num_classes": 10,
                                               "n_layers": 1}},
                   {**IMAGES, "batchSize": 2}),
    "bert": program({"name": "bert", "config": {"preset": "tiny-test", "n_layers": 1}},
                    {"name": "synthetic_mlm", "batchSize": 2,
                     "config": {"seq_len": 64, "vocab_size": 1024}}, remat=True),
    "seq2seq": program({"name": "seq2seq", "config": {"preset": "tiny-test", "n_layers": 1}},
                       {"name": "synthetic_seq2seq", "batchSize": 2,
                        "config": {"src_len": 32, "tgt_len": 32, "vocab_size": 1024}},
                       precision="mixed"),
    "moe": program({"name": "transformer_lm", "config": {
                        "dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
                        "vocab_size": 256, "seq_len": 32, "n_experts": 4}},
                   {"name": "synthetic_text", "batchSize": 2,
                    "config": {"seq_len": 32, "vocab_size": 256}}),
}
TOL = {"seq2seq": (5e-4, 5e-3)}  # loss, grad_norm
CLASSIFIERS = {"mlp", "no-data", "resnet-remat", "vit"}


@functools.cache
def run_pair(name):
    """(JAX history, JAX initial and final extra state, port trainer, port
    result), once per run (the JAX programs compile slowly)."""
    jt = JaxTrainer(JaxProgram.from_dict(RUNS[name]), devices=jax.devices()[:1])
    init = jax.tree.map(np.asarray, jt.state.params)
    init_extra = jax.tree.map(np.asarray, jt.state.extra)
    jr = jt.run()
    trainer = Trainer(RUNS[name], device="cpu")
    cfg = getattr(trainer.module, "cfg", None)
    trainer.load_state_dict(params_from_jax(init, cfg, init_extra.get("batch_stats")))
    result = trainer.run()
    return jr.history, init_extra, jax.tree.map(np.asarray, jr.state.extra), trainer, result


def _rows(history, key):
    return [h for h in history if key in h]


@pytest.mark.parametrize("name", list(RUNS))
def test_step_metrics_match_jax(name):
    ref, _, _, _, result = run_pair(name)
    loss_tol, norm_tol = TOL.get(name, (5e-5, 5e-5))[:2]
    ours, want = _rows(result.history, "loss"), _rows(ref, "loss")
    steps = RUNS[name]["train"]["steps"]
    assert [h["step"] for h in ours] == [h["step"] for h in want] == list(range(1, steps + 1))
    for a, b in zip(ours, want):
        assert a.keys() == b.keys() or set(b) - set(a) <= {"tokens_per_sec", "mfu"}
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=loss_tol)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=norm_tol)
        assert np.isfinite(a["loss"])
        if name in CLASSIFIERS:
            assert a["accuracy"] == b["accuracy"]
        else:
            assert "accuracy" not in a and "accuracy" not in b
    if want[-1]["loss"] < want[0]["loss"]:  # three steps descend where the reference's do
        assert ours[-1]["loss"] < ours[0]["loss"]


def test_eval_accuracy_matches_jax():
    """Eval's loss and accuracy (ResNet's eval mode is held in
    test_torch_zoo.py)."""
    ref, _, _, _, result = run_pair("mlp")
    ours, want = _rows(result.history, "eval.loss"), _rows(ref, "eval.loss")
    assert [h["step"] for h in ours] == [h["step"] for h in want] == [3]
    np.testing.assert_allclose(ours[0]["eval.loss"], want[0]["eval.loss"], rtol=5e-5)
    assert ours[0]["eval.accuracy"] == want[0]["eval.accuracy"]


def test_batch_stats_match_jax():
    """The running statistics moved off their start (0 and 1) as the
    reference's did: under remat once a step (a second update would put
    them far outside the f32 limit)."""
    _, init, final, trainer, _ = run_pair("resnet-remat")
    start = params_from_jax({}, None, init["batch_stats"])
    want = params_from_jax({}, None, final["batch_stats"])
    ours = {k: v for k, v in trainer.module.state_dict().items() if "running" in k}
    assert set(ours) == set(want)
    for k in want:
        assert not torch.equal(want[k], start[k]), k
        assert ((ours[k] - want[k]).abs().max() / want[k].abs().max()).item() < 5e-5, k


def test_program_without_data_trains_on_synthetic():
    """No `data`: the `synthetic` stream (32-dim vectors, 10 classes), batch
    32, on both sides."""
    _, _, _, trainer, _ = run_pair("no-data")
    assert trainer.data.name == "synthetic" and trainer.data.batch_size == 32
    assert trainer.data.meta == {"shape": (32,), "num_classes": 10}


def test_moe_aux_loss_is_in_the_training_loss():
    """The port's loss for the MoE transformer holds the balance loss of
    every layer, as the reference's (matched above): the cross-entropy
    alone is lower by that much."""
    _, _, _, trainer, result = run_pair("moe")
    fresh = Trainer(RUNS["moe"], device="cpu")
    fresh.load_state_dict(trainer.module.state_dict())
    batch = fresh._to_device(next(fresh.data.iterator))
    fresh.module.train()
    with torch.no_grad():
        loss, _, box = fresh._loss(batch, 0)
        plain = fresh.loss_fn(fresh._apply(fresh._compute_params(), batch["inputs"], 0)[0],
                              batch)
    aux = float(box.aux_loss("cpu"))
    assert len(box.losses) == 2 and aux > 0
    assert float(loss - plain) == pytest.approx(aux, rel=1e-5)


def test_data_shape_mismatch_raises():
    prog = program({"name": "mlp", "config": {"input_dim": 784}},
                   {"name": "synthetic", "batchSize": 4})
    with pytest.raises(ValueError, match="shape mismatch"):
        Trainer(prog, device="cpu")
