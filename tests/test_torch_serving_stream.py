"""The port's SSE streaming (`POST /generate?stream=1`) over real HTTP on
the CPU: the chunks of each row concatenate to the non-streamed tokens (on
the dense, paged and step configs), admission errors keep their status
codes, and a client that disconnects mid-stream has its rows cancelled and
every page it held returned."""

import json
import socket
import time
import urllib.request

import pytest

from tests.test_torch_serving_batch import (
    assert_no_leak, lm, post, start_port, traffic,  # noqa: F401
)


def sse(url, body, timeout=120):
    """POST with stream=1; (status, [events]) with the frames parsed."""
    req = urllib.request.Request(
        url + "/generate?stream=1", data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            assert resp.headers["Content-Type"] == "text/event-stream"
            raw = resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, [json.loads(e.read())]
    events = [json.loads(chunk[len("data: "):]) for chunk in raw.split("\n\n") if chunk]
    return 200, events


@pytest.mark.parametrize("name", ["paged", "step", "dense"])
def test_stream_chunks_concatenate_to_the_non_streamed_tokens(lm, name):  # noqa: F811
    p = traffic(seed=11, n=1)[0]
    body = {"tokens": [p[:14], p[2:16]], "maxNewTokens": 9, "temperature": 0.6,
            "seed": 3}
    server, url = start_port(lm, name)
    try:
        code, whole = post(url, body)
        assert code == 200
        code, events = sse(url, body)
        assert code == 200
    finally:
        server.stop()
    assert events[-1]["done"] is True and "row" not in events[-1]
    assert len({ev["requestId"] for ev in events}) == 1
    for i, row in enumerate(whole["tokens"]):
        chunks = [ev["tokens"] for ev in events if ev.get("row") == i and "tokens" in ev]
        assert sum(chunks, []) == row[len(body["tokens"][i]):]
        assert {"row": i, "done": True} in [
            {k: v for k, v in ev.items() if k != "requestId"} for ev in events]
        if name != "dense":  # incremental on the paged pool: several chunks
            assert len(chunks) > 1
    if name != "dense":
        assert_no_leak(server)


def test_stream_admission_errors_keep_their_status(lm):  # noqa: F811
    server, url = start_port(lm, "paged")
    try:
        code, events = sse(url, {"tokens": [[1, 2]], "maxNewTokens": 0})
        assert code == 400 and events[0]["reason"] == "invalid_request"
        code, events = sse(url, {"tokens": [[1, 2]], "maxNewTokens": 2, "deadlineMs": 1e-6})
        assert code == 503 and events[0]["reason"] == "deadline"
    finally:
        server.stop()


@pytest.mark.parametrize("name", ["paged", "step"])
def test_disconnect_mid_stream_frees_pages(lm, name):  # noqa: F811
    """The client reads the first frame and hangs up. The server's next
    writes fail, the rows are cancelled, the coalescer (between chunks) or
    the scheduler (between steps) evicts them long before their 120
    tokens, and every page they held comes back."""
    server, url = start_port(lm, name, stream_chunk_tokens=1)
    port = int(url.rsplit(":", 1)[1])
    body = json.dumps({"tokens": [traffic(seed=12, n=1)[0][:8]],
                       "maxNewTokens": 120}).encode()
    try:
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        sock.sendall(
            b"POST /generate?stream=1 HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body
        )
        seen = b""
        while b"data: " not in seen:
            seen += sock.recv(4096)
        with server._lock:  # no decode step between the first frame and the hang-up
            sock.close()
        end = time.monotonic() + 60
        while server.stats()["kv"]["active_rows"] and time.monotonic() < end:
            time.sleep(0.01)
        stats = server.stats()
        assert stats["kv"]["active_rows"] == 0
        assert server._m_client_disconnects.value >= 1
        # decode stopped long before the row's 119 decode steps
        assert server._m_decode_step.summary()["count"] < 119
        if name == "step":
            assert stats["chunked"]["evicted_midflight"] >= 1
        assert_no_leak(server)
        # the server keeps serving
        code, out = post(url, {"tokens": [[5, 6, 7]], "maxNewTokens": 3})
        assert code == 200 and len(out["tokens"][0]) == 6
    finally:
        server.stop()
