"""The port's step scheduler (chunked prefill + continuous batching) over
real HTTP on the CPU, held against the JAX package's ModelServer in the
same config (`chunkedPrefill` on the paged pool).

Concurrent greedy requests of several lengths — long prompts sliced into
8-token prefill chunks, a shared prefix that a second wave finds in the
cache — answer the JAX server's tokens row for row, and the one-shot paged
config's. The scheduler really interleaved: it ran steps that carried
decode rows and a prefill slice together, and prefix hits were counted. A
sampled body gives the tokens of the dense and paged configs. No page has
leaked after the traffic, nor after drain."""

import pytest
import torch

from polyaxon_tpu_torch.models.generate import generate
from tests.test_torch_serving_batch import (
    NEW, assert_no_leak, concurrent, greedy_bodies, jax_answers, lm, post,  # noqa: F401
    start_port, traffic,
)


@pytest.fixture(scope="module")
def stepped(lm):  # noqa: F811
    # long prompts (several prefill slices each) beside short ones
    waves = [greedy_bodies(traffic(seed=5, n=6)), greedy_bodies(traffic(seed=6, n=4))]
    server, url = start_port(lm, "step")
    try:
        answers = [concurrent(url, wave) for wave in waves]
        yield server, url, waves, answers
    finally:
        server.stop()


def test_concurrent_greedy_matches_jax_step_server(stepped, lm):  # noqa: F811
    server, url, waves, answers = stepped
    bodies = waves[0] + waves[1]
    got = [a for wave in answers for a in wave]
    assert all(code == 200 for code, _ in got), got
    assert [out["tokens"] for _, out in got] == jax_answers(lm, "step", bodies)
    for body, (_, out) in zip(bodies, got):
        direct = generate(lm[2], torch.tensor(body["tokens"]), max_new_tokens=NEW)
        assert out["tokens"] == direct.tolist()


def test_scheduler_interleaved_and_prefix_hit(stepped):
    server, url, waves, _ = stepped
    stats = server.stats()
    chunked = stats["chunked"]
    assert chunked["enabled"] and chunked["prefill_chunks"] > len(waves[0]) + len(waves[1])
    # steps that carried a prefill slice beside decode rows
    assert chunked["steps"] > chunked["prefill_only_steps"]
    assert chunked["step_tokens"]["p50"] is not None
    assert max(chunked["step_tokens"][k] for k in ("p50", "p95")) <= 32
    assert stats["kv"]["prefix"]["hits"] >= 1
    assert stats["ttft_ms"]["p50"] is not None
    assert_no_leak(server)


def test_step_path_equals_one_shot_paged_and_dense_sampled(lm):  # noqa: F811
    """Sampled rows: the step scheduler, the one-shot paged group and the
    dense bucketed group give each row the same tokens."""
    p = traffic(seed=8, n=1)[0]  # the shared prefix and its own tail
    body = {"tokens": [p[:12], p[5:17]], "maxNewTokens": NEW,
            "temperature": 0.7, "topK": 50, "seed": 21}
    outs = []
    for name in ("step", "paged", "dense"):
        server, url = start_port(lm, name)
        try:
            code, out = post(url, body)
            assert code == 200, out
            outs.append(out["tokens"])
            if name != "dense":
                assert_no_leak(server)
        finally:
            server.stop()
    assert outs[0] == outs[1] == outs[2]


def test_drain_leaves_no_page_behind(lm):  # noqa: F811
    """stop() drains the queued and in-flight rows; their pages all return."""
    server, url = start_port(lm, "step")
    try:
        answers = concurrent(url, greedy_bodies(traffic(seed=9, n=3)))
        assert all(code == 200 for code, _ in answers)
    finally:
        server.stop()
    assert_no_leak(server)
    assert server.stats()["queue_depth"] == 0
