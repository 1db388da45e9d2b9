"""The port's file-backed pipelines (`data/files.py`, `native/`) against the
JAX package's, on the CPU.

Corpora are written with numpy from a seed inside each test. Exact
comparisons throughout: for one file, seed and process layout,
- `token_file`'s Python stream yields the reference's
  `token_file(loader="python")` batches, for uint16, uint32 and `.npy`;
- the port's native loader (its own copy of `dataloader.cpp`, built into
  `build/torch_native/`) yields the reference `NativeTokenLoader`'s;
- `array_file` yields the reference's rows;
- the reference's errors hold (missing file, a corpus too small, rows that
  do not match), `loader: auto` falls back to Python and says so in
  `meta["loader"]`, `loader: native` raises, and `close` releases the
  native loader (the Trainer's `close` too).
"""

import numpy as np
import pytest

from polyaxon_tpu.data import build_data as jax_build_data
from polyaxon_tpu.native.dataloader import NativeTokenLoader as JaxNativeLoader
from polyaxon_tpu_torch.data import build_data
from polyaxon_tpu_torch.native import dataloader as native
from polyaxon_tpu_torch.runtime import Trainer

VOCAB = 5000
STEPS = 4


def _corpus(tmp_path, kind: str, n: int = 20_000, seed: int = 0):
    toks = np.random.default_rng(seed).integers(0, VOCAB, n)
    if kind == "npy":
        path = tmp_path / "corpus.npy"
        np.save(path, toks.astype(np.uint32))
        return str(path), None
    path = tmp_path / f"corpus_{kind}.bin"
    toks.astype(kind).tofile(path)
    return str(path), kind


def _same_batches(ours, ref, steps=STEPS):
    for _ in range(steps):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys() == {"inputs", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


LAYOUTS = [(0, 1, 4), (1, 2, 6), (2, 3, 3)]  # (process_index, process_count, batch/host)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"p{x[0]}of{x[1]}")
@pytest.mark.parametrize("kind", ["uint16", "uint32", "npy"])
def test_python_stream_equals_the_reference(tmp_path, kind, layout):
    pi, pc, per_host = layout
    path, dtype = _corpus(tmp_path, kind)
    config = {"path": path, "seq_len": 32, "loader": "python"}
    if dtype:
        config["dtype"] = dtype
    kw = dict(seed=7, process_index=pi, process_count=pc)
    ours = build_data("token_file", per_host * pc, config, **kw)
    ref = jax_build_data("token_file", per_host * pc, config, **kw)
    assert ours.meta == ref.meta == {
        "seq_len": 32, "corpus_tokens": 20_000, "vocab_size": ref.meta["vocab_size"],
        "loader": "python"}
    assert ours.batch_size == ref.batch_size == per_host
    _same_batches(ours.iterator, ref.iterator)


@pytest.mark.parametrize("kind", ["uint16", "uint32", "int32", "npy"])
def test_native_loader_equals_the_reference(tmp_path, kind):
    path, dtype = _corpus(tmp_path, kind)
    kw = dict(seq_len=48, batch_size=5, seed=11, process_index=1, process_count=2)
    if dtype:
        kw["dtype"] = dtype
    with native.NativeTokenLoader(path, **kw) as ours, JaxNativeLoader(path, **kw) as ref:
        assert ours.corpus_tokens == ref.corpus_tokens == 20_000
        _same_batches(ours, ref, steps=6)
        assert next(ours)["inputs"].shape == (5, 48)


def test_token_file_native_equals_the_reference(tmp_path):
    path, dtype = _corpus(tmp_path, "uint32")
    config = {"path": path, "seq_len": 64, "dtype": dtype, "loader": "native",
              "vocab_size": VOCAB}
    ours = build_data("token_file", 4, config, seed=3)
    ref = jax_build_data("token_file", 4, config, seed=3)
    try:
        assert ours.meta == ref.meta
        assert ours.meta["loader"] == "native" and ours.meta["vocab_size"] == VOCAB
        _same_batches(ours.iterator, ref.iterator)
    finally:
        ours.shutdown()
        ref.shutdown()
    # closed: the loader's threads and mmap are gone, and a second shutdown
    # is a no-op
    with pytest.raises(RuntimeError, match="closed"):
        next(ours.iterator)
    ours.shutdown()


def test_the_library_builds_from_the_port_source_into_its_own_directory():
    lib = native.build()
    assert lib.is_file() and lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "polyaxon_tpu_torch"
    assert native.CXX_FLAGS == ("-O2", "-shared", "-fPIC", "-pthread")


def test_auto_falls_back_and_native_raises(tmp_path, monkeypatch):
    path, dtype = _corpus(tmp_path, "uint16")
    config = {"path": path, "seq_len": 16, "dtype": dtype}
    monkeypatch.setattr(native, "_lib", [])  # nothing loaded yet
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "missing" / "lib.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    auto = build_data("token_file", 2, {**config, "loader": "auto"}, seed=1)
    assert auto.meta["loader"] == "python (native unavailable: NativeBuildError)"
    ref = jax_build_data("token_file", 2, {**config, "loader": "python"}, seed=1)
    _same_batches(auto.iterator, ref.iterator)
    with pytest.raises(native.NativeBuildError):
        build_data("token_file", 2, {**config, "loader": "native"}, seed=1)
    with pytest.raises(ValueError, match="native\\|python\\|auto"):
        build_data("token_file", 2, {**config, "loader": "fast"})


def _raises_alike(exc, match, *args, **kwargs):
    for fn in (build_data, jax_build_data):
        with pytest.raises(exc, match=match):
            data = fn(*args, **kwargs)
            next(data.iterator)


def test_errors_are_the_references(tmp_path):
    missing = str(tmp_path / "nope.bin")
    _raises_alike(FileNotFoundError, "token file not found", "token_file", 2,
                  {"path": missing, "seq_len": 8, "loader": "python"})
    tiny = tmp_path / "tiny.bin"
    np.arange(9, dtype=np.uint16).tofile(tiny)
    _raises_alike(ValueError, r"corpus has 9 tokens, need at least seq_len\+2=10",
                  "token_file", 2, {"path": str(tiny), "seq_len": 8, "loader": "python"})
    small = tmp_path / "small.bin"
    np.arange(12, dtype=np.uint16).tofile(small)
    _raises_alike(ValueError, "corpus too small: 3 windows across 4 hosts", "token_file", 8,
                  {"path": str(small), "seq_len": 8, "loader": "python"},
                  process_index=3, process_count=4)
    _raises_alike(ValueError, "not divisible by 4 hosts", "token_file", 6,
                  {"path": str(small), "seq_len": 8}, process_count=4)
    np.save(tmp_path / "x.npy", np.zeros((5, 3), np.float32))
    np.save(tmp_path / "y.npy", np.zeros(4, np.int64))
    _raises_alike(ValueError, "inputs has 5 rows but labels has 4", "array_file", 2,
                  {"inputs": str(tmp_path / "x.npy"), "labels": str(tmp_path / "y.npy")})
    _raises_alike(FileNotFoundError, "array file not found", "array_file", 2,
                  {"inputs": str(tmp_path / "x.npy"), "labels": missing})


def test_array_file_equals_the_reference(tmp_path):
    rng = np.random.default_rng(4)
    np.save(tmp_path / "x.npy", rng.standard_normal((50, 6, 2)).astype(np.float32))
    np.save(tmp_path / "y.npy", rng.integers(0, 7, 50))
    config = {"inputs": str(tmp_path / "x.npy"), "labels": str(tmp_path / "y.npy")}
    ours = build_data("array_file", 8, config, seed=5, process_index=1)
    ref = jax_build_data("array_file", 8, config, seed=5, process_index=1)
    assert ours.meta == ref.meta == {"rows": 50, "shape": (6, 2),
                                     "num_classes": ref.meta["num_classes"]}
    for _ in range(STEPS):
        a, b = next(ours.iterator), next(ref.iterator)
        for k in ("inputs", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_trainer_trains_on_the_native_loader_and_closes_it(tmp_path):
    path, dtype = _corpus(tmp_path, "uint16", n=8000)
    program = {
        "model": {"name": "transformer_lm", "config": dict(
            dim=32, n_layers=1, n_heads=2, n_kv_heads=1, vocab_size=VOCAB, seq_len=16)},
        "data": {"name": "token_file", "batchSize": 2, "config": {
            "path": path, "seq_len": 16, "dtype": dtype, "loader": "native"}},
        "train": {"steps": 2, "logEvery": 1, "precision": "float32"},
    }
    trainer = Trainer(program, device="cpu")
    assert trainer.data.meta["loader"] == "native"
    result = trainer.run()
    assert [h["step"] for h in result.history] == [1, 2]
    trainer.close()
    trainer.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        next(trainer.data.iterator)
