"""HTTP model server, per-request path (counterpart of
`polyaxon_tpu/serving/server.py::ModelServer` with batching off).

    server = ModelServer(module, state_dict_or_jax_params, device="cuda")
    port = server.start("127.0.0.1", 0)
    # GET /healthz; POST /generate {"tokens": [[...]], "maxNewTokens": 16}
    server.stop()

Each POST /generate is validated (400 on a bad body), then decoded inline
through `models.generate.generate` with the request's scalar seed, one
request at a time under a lock. Coalescing, bucketing, paged KV, beams,
speculation, tenancy and checkpoint restore are later slices (ROADMAP.md).
"""

from __future__ import annotations

import json
import math
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import params_from_jax
from ..models.generate import generate
from .batching import ServingConfig, ServingError


def _int(body: dict, key: str, default):
    raw = body.get(key, default)
    if raw is None:
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise ServingError(f"{key} must be an integer, got {raw!r}")


class ModelServer:
    def __init__(
        self,
        module,
        params=None,
        config: Optional[ServingConfig] = None,
        *,
        model_name: str = "transformer_lm",
        step: int = 0,
        device="cuda",
    ):
        """`params`: None (keep the module's weights), a torch state_dict,
        or the JAX package's nested numpy param dict."""
        self.config = config or ServingConfig()
        self.device = resolve_device(device)
        module = module.to(self.device).eval()
        if params is not None:
            if all(isinstance(v, torch.Tensor) for v in params.values()):
                state = params
            else:
                state = params_from_jax(params, module.cfg)
            module.load_state_dict(state)
        self.module = module
        self.model_name = model_name
        self.step = step
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _validate(self, body: dict) -> dict:
        if not isinstance(body, dict):
            raise ServingError("body must be a JSON object")
        tokens = body.get("tokens")
        if not tokens or not isinstance(tokens, list):
            raise ServingError("body.tokens must be a non-empty [[int]] batch")
        max_new = _int(body, "maxNewTokens", 16)
        if max_new < 1:
            raise ServingError("maxNewTokens must be >= 1")
        try:
            arr = np.asarray(tokens, dtype=np.int64)
        except (ValueError, TypeError) as e:
            raise ServingError(f"tokens must be rectangular [[int]]: {e}")
        if arr.ndim != 2 or arr.shape[1] < 1:
            raise ServingError(
                "tokens must be rectangular [[int]] with >= 1 token per row"
            )
        if arr.shape[0] > self.config.max_batch:
            raise ServingError(
                f"{arr.shape[0]} rows exceed maxBatch {self.config.max_batch}"
            )
        cfg = self.module.cfg
        if arr.min() < 0 or arr.max() >= cfg.vocab_size:
            raise ServingError(
                f"token ids must be in [0, {cfg.vocab_size}); "
                f"got range [{arr.min()}, {arr.max()}]"
            )
        if arr.shape[1] + max_new > cfg.seq_len:
            raise ServingError(
                f"prompt ({arr.shape[1]}) + maxNewTokens ({max_new}) exceeds "
                f"the model's seq_len {cfg.seq_len}"
            )
        try:
            temperature = float(body.get("temperature", 0.0))
        except (TypeError, ValueError):
            raise ServingError("temperature must be a number")
        if not math.isfinite(temperature):
            raise ServingError("temperature must be finite")
        eos = _int(body, "eosId", None)
        if eos is not None and not 0 <= eos < cfg.vocab_size:
            raise ServingError(f"eosId must be in [0, {cfg.vocab_size})")
        if _int(body, "numBeams", 1) != 1:
            raise ServingError("numBeams > 1 is not served by this port yet")
        return {
            "arr": arr,
            "max_new": max_new,
            "temperature": temperature,
            "top_k": _int(body, "topK", None),
            "eos_id": eos,
            "seed": _int(body, "seed", 0),
        }

    def generate(self, body: dict) -> dict:
        """Validate, then decode the whole request: {"tokens": [[int]]}."""
        req = self._validate(body)
        with self._lock:
            out = generate(
                self.module,
                torch.from_numpy(req["arr"]),
                max_new_tokens=req["max_new"],
                temperature=req["temperature"],
                top_k=req["top_k"],
                eos_id=req["eos_id"],
                seed=req["seed"],
            )
        return {"tokens": out.cpu().tolist()}

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve in a background thread; returns the bound port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path.partition("?")[0] == "/healthz":
                    self._send(
                        200,
                        {"status": "ok", "model": server.model_name, "step": server.step},
                    )
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path.partition("?")[0] != "/generate":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError as e:
                        raise ServingError(f"body is not JSON: {e}")
                    self._send(200, server.generate(body))
                except ServingError as e:
                    self._send(400, {"error": str(e), "reason": "invalid_request"})
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    traceback.print_exc()
                    self._send(
                        500,
                        {"error": f"{type(e).__name__}: {e}", "reason": "internal"},
                    )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        """Stop the HTTP server and join its thread."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
