"""The port's data pipelines against the JAX package's, on the CPU: the same
seed, config and process index give byte-identical batches (the trainer
parity tests rest on this), token streams and image/vector streams alike."""

import itertools

import numpy as np
import pytest

from polyaxon_tpu.data import build_data as jax_build_data
from polyaxon_tpu_torch.data import build_data

STREAMS = [
    ("synthetic_text", {"seq_len": 64, "vocab_size": 4096}),
    ("synthetic_lm", {"seq_len": 33, "vocab_size": 1000}),
    ("synthetic_mlm", {"seq_len": 48, "vocab_size": 3000, "mask_rate": 0.2}),
    ("synthetic", {"shape": [6, 5, 3], "num_classes": 7}),
    ("mnist", {}),
    ("mnist-nhwc", {"flat": False}),
    ("synthetic_imagenet", {"image_size": 16, "num_classes": 11}),
    ("synthetic_seq2seq", {"src_len": 12, "tgt_len": 8, "vocab_size": 50}),
]


@pytest.mark.parametrize("process_index", [0, 7919])
@pytest.mark.parametrize("name,config", STREAMS, ids=[s[0] for s in STREAMS])
def test_batches_are_byte_identical(name, config, process_index):
    """Token ids int32; images and vectors f32 [B, ...] (NHWC), their labels
    int32 [B]."""
    name = name.split("-")[0]
    kw = dict(seed=3, process_index=process_index)
    ref = jax_build_data(name, 4, config, **kw)
    ours = build_data(name, 4, config, **kw)
    assert (ours.name, ours.batch_size, ours.meta) == (ref.name, ref.batch_size, ref.meta)
    images = "shape" in ref.meta
    for a, b in itertools.islice(zip(ours.iterator, ref.iterator), 3):
        assert a.keys() == b.keys() == {"inputs", "labels"}
        for key in a:
            want = np.float32 if images and key == "inputs" else np.int32
            assert a[key].dtype == b[key].dtype == want
            assert a[key].shape == b[key].shape
            assert a[key].tobytes() == b[key].tobytes()


def test_process_index_changes_the_stream():
    a = next(build_data("synthetic_text", 2, {"seq_len": 16}, process_index=0).iterator)
    b = next(build_data("synthetic_text", 2, {"seq_len": 16}, process_index=1).iterator)
    assert a["inputs"].tobytes() != b["inputs"].tobytes()


def test_registry_errors_match_the_reference():
    with pytest.raises(ValueError, match="unknown dataset"):
        jax_build_data("imagenet_real", 4)
    with pytest.raises(ValueError, match="unknown dataset"):
        build_data("imagenet_real", 4)
