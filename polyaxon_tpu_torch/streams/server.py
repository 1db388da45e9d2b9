"""The streams and control service: HTTP over the run store, an own copy
of `polyaxon_tpu/streams/server.py` with the same routes, status codes
and JSON bodies, over the port's `RunStore`, `Agent`, `Fleet` and
telemetry. A dependency-free `ThreadingHTTPServer`:

  GET  / and /ui                     → the dashboard (`streams/ui.py`)
  GET  /healthz, /readyz
  GET  /metricsz                     → the process registry (Prometheus
                                       text); with `federate` sources their
                                       scrapes too, labelled source="<slug>"
  GET  /queryz                       → trend queries over the history
                                       (`history_dir`; 503 without one)
  GET  /openapi.json                 → `streams/openapi.py`
  GET  /fleetz                       → the fleet's snapshot
  GET  /runs[?project=]              → the index
  GET  /runs?watch=<cursor>          → long-poll of the store's event log:
                                       {events, cursor}, bounded by
                                       ?timeout= (default 10 s, at most 30)
  GET  /runs/<uuid>[/status]
  GET  /runs/<uuid>/logs[?offset=N]  → {logs, offset}: follow by offset
  GET  /runs/<uuid>/metrics[?tail=N]
  GET  /runs/<uuid>/events, /timeline, /spec
  GET  /runs/<uuid>/artifacts        → {files} under the run's outputs
  GET  /runs/<uuid>/artifacts/<path> → the file (403 outside the outputs)
  POST /runs                         → {"operation": ..., "project": p,
                                       "priority": n}: compiled and queued
                                       (`Agent.submit`) for the agent that
                                       drains this store; 201 {uuid}
  POST /runs/<uuid>/stop             → request a stop; the status
  DELETE /runs/<uuid>[?cascade=]     → 409 while the run is active

Errors: a bad query parameter (`BadParam`) → 400, an unknown run
(`KeyError`) → 404, a bad JSON body or spec → 400, anything else → 500;
the server keeps serving after each. `python -m polyaxon_tpu_torch
streams start [--port P]` serves; `RunClient(base_url=...)` is its
client.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..store import RunStore

_TRUE = ("1", "true", "yes")


def _json_bytes(data) -> bytes:
    return json.dumps(data, default=str).encode()


class BadParam(Exception):
    """A bad query parameter → 400. Not a ValueError: a corrupt stored
    file raises `json.JSONDecodeError` (a ValueError), a server fault that
    must stay a 500."""


def _query_int(query: dict, name: str, default: int) -> int:
    raw = query.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except (TypeError, ValueError):
        raise BadParam(f"query param {name!r} must be an integer, got {raw!r}") from None


def _split(path: str):
    parsed = urlparse(path)
    parts = [p for p in parsed.path.split("/") if p]
    return parsed, parts, {k: v[0] for k, v in parse_qs(parsed.query).items()}


class _Handler(BaseHTTPRequestHandler):
    store: RunStore  # bound by make_server
    federate_sources: dict[str, str] = {}  # {slug: base url} scraped by /metricsz
    history = None  # the HistoryStore behind /queryz

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, data):
        self._send(code, _json_bytes(data))

    def _not_found(self, what: str):
        self._json(404, {"error": f"{what} not found"})

    def _known(self, ref: str) -> Optional[str]:
        """The run's uuid when its status exists; None after a 404."""
        uuid = self.store.resolve(ref)
        if not (self.store.run_dir(uuid) / "status.json").exists():
            self._not_found(f"run {ref}")
            return None
        return uuid

    def do_GET(self):  # noqa: N802 (stdlib naming)
        parsed, parts, query = _split(self.path)
        try:
            if not parts or parts == ["ui"]:
                from .ui import INDEX_HTML

                return self._send(200, INDEX_HTML.encode(), "text/html")
            if parts == ["healthz"]:
                return self._json(200, {"status": "ok"})
            if parts == ["readyz"]:  # no warm-up: ready once it serves
                return self._json(200, {"ready": True})
            if parts == ["metricsz"]:
                return self._send(200, self._metrics().encode(), "text/plain; version=0.0.4")
            if parts == ["queryz"]:
                from ..telemetry import queryz_payload

                return self._json(*queryz_payload(self.history, parsed.query))
            if parts == ["openapi.json"]:
                from .openapi import spec

                return self._json(200, spec())
            if parts == ["fleetz"]:
                from ..scheduler.fleet import Fleet

                return self._json(200, Fleet(self.store).snapshot())
            if parts == ["runs"]:
                if "watch" in query:
                    return self._json(200, self._watch(query))
                return self._json(200, self.store.list_runs(query.get("project")))
            if len(parts) >= 2 and parts[0] == "runs":
                uuid = self._known(parts[1])
                if uuid is not None:
                    self._run_route(uuid, parts[2:], query, parsed.path)
                return None
            self._not_found(parsed.path)
        except KeyError as e:
            self._not_found(str(e))
        except BadParam as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — a 500, and the server serves on
            self._json(500, {"error": str(e)})

    def _metrics(self) -> str:
        """The process registry's exposition, with the federated sources'
        scrapes and the cluster aggregates when any are configured."""
        from ..telemetry import get_registry

        local = get_registry().render_prometheus()
        if not self.federate_sources:
            return local
        from ..telemetry.federate import federate

        return federate([(slug, _scrape(url)) for slug, url in sorted(self.federate_sources.items())],
                        label="source", local_text=local)

    def _watch(self, query: dict) -> dict:
        """Events committed after the cursor ("" or "now": from this
        moment), returned as soon as any commit or after the timeout."""
        raw = query.get("watch", "")
        try:
            timeout = float(query.get("timeout", "10"))
        except (TypeError, ValueError):
            raise BadParam(
                f"query param 'timeout' must be a number, got {query.get('timeout')!r}"
            ) from None
        events, cursor = self.store.wait_events(None if raw in ("", "now") else raw,
                                                timeout=min(max(timeout, 0.0), 30.0))
        return {"events": events, "cursor": cursor}

    def _run_route(self, uuid: str, rest: list, query: dict, path: str):
        store = self.store
        sub = rest[0] if rest else "status"
        if sub == "status":
            return self._json(200, store.get_status(uuid))
        if sub == "logs":
            offset = _query_int(query, "offset", 0)
            chunk = store.read_logs(uuid)[offset:]
            return self._json(200, {"logs": chunk, "offset": offset + len(chunk)})
        if sub == "metrics":
            rows = store.read_metrics(uuid)
            if "tail" in query:  # bounded answers for pollers
                rows = rows[-max(1, _query_int(query, "tail", 1)):]
            return self._json(200, rows)
        if sub == "events":
            return self._json(200, store.read_events(uuid))
        if sub == "timeline":
            return self._json(200, {"uuid": uuid, "timeline": store.timeline(uuid)})
        if sub == "spec":
            return self._json(200, store.read_spec(uuid))
        if sub == "artifacts":
            root = store.outputs_dir(uuid)
            rel = "/".join(rest[1:])
            if not rel:
                return self._json(200, {"files": [str(p.relative_to(root))
                                                  for p in sorted(root.rglob("*"))
                                                  if p.is_file()]})
            target, top = (root / rel).resolve(), root.resolve()
            # by component: a prefix test would let a sibling outputsXYZ by
            if target != top and top not in target.parents:
                return self._json(403, {"error": "path escapes outputs"})
            if not target.is_file():
                return self._not_found(rel)
            return self._send(200, target.read_bytes(), "application/octet-stream")
        return self._not_found(path)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if not length:
            return {}
        return json.loads(self.rfile.read(length) or b"{}")

    def do_POST(self):  # noqa: N802 (stdlib naming)
        parsed, parts, _ = _split(self.path)
        try:
            if parts == ["runs"]:
                body = self._read_body()
                if "operation" not in body:
                    return self._json(400, {"error": "body needs 'operation'"})
                from ..scheduler.agent import Agent
                from ..schemas.operation import V1Operation

                op = V1Operation.from_dict(body["operation"])
                # enqueue only: the agent draining this store runs it
                uuid = Agent(store=self.store).submit(
                    op, project=body.get("project") or "default",
                    priority=int(body.get("priority") or 0))
                return self._json(201, {"uuid": uuid})
            if len(parts) == 3 and parts[0] == "runs" and parts[2] == "stop":
                uuid = self._known(parts[1])
                if uuid is not None:
                    self.store.request_stop(uuid)
                    self._json(200, self.store.get_status(uuid))
                return None
            self._not_found(parsed.path)
        except KeyError as e:
            self._not_found(str(e))
        except (ValueError, TypeError) as e:  # bad JSON or a bad spec
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001
            self._json(500, {"error": str(e)})

    def do_DELETE(self):  # noqa: N802 (stdlib naming)
        _, parts, query = _split(self.path)
        try:
            if len(parts) == 2 and parts[0] == "runs":
                # no status check: a stale index entry stays purgeable
                uuid = self.store.resolve(parts[1])
                self.store.delete_run(uuid, cascade=query.get("cascade", "").lower() in _TRUE)
                return self._json(200, {"deleted": uuid})
            self._not_found(self.path)
        except KeyError as e:
            self._not_found(str(e))
        except ValueError as e:  # an active run
            self._json(409, {"error": str(e)})
        except Exception as e:  # noqa: BLE001
            self._json(500, {"error": str(e)})


def _scrape(url: str) -> Optional[str]:
    """One sibling's `/metricsz` text; None marks it down (federate()
    renders that as federation_source_up 0)."""
    from urllib import request as urlrequest

    try:
        with urlrequest.urlopen(url.rstrip("/") + "/metricsz", timeout=2.0) as r:
            return r.read().decode()
    except Exception:  # noqa: BLE001 — a dead source is data, not a fault
        return None


def make_server(store: Optional[RunStore] = None, host: str = "127.0.0.1", port: int = 8585,
                federate: Optional[dict[str, str]] = None, history_dir: Optional[str] = None,
                history_interval_s: float = 1.0) -> ThreadingHTTPServer:
    """The server, not yet serving. With `history_dir` a sampler (the
    server's `history_sampler`, started by `serve` and `BackgroundServer`)
    snapshots the process registry into the history `/queryz` reads."""
    history = sampler = None
    if history_dir:
        from ..telemetry import HistorySampler, HistoryStore, get_registry

        history = HistoryStore(history_dir)
        sampler = HistorySampler(get_registry(), history, interval_s=history_interval_s)
    handler = type("BoundHandler", (_Handler,), {
        "store": store or RunStore(),
        "federate_sources": dict(federate or {}),
        "history": history,
    })
    server = ThreadingHTTPServer((host, port), handler)
    server.history_sampler = sampler
    return server


def serve(store: Optional[RunStore] = None, host: str = "127.0.0.1", port: int = 8585,
          federate: Optional[dict[str, str]] = None, history_dir: Optional[str] = None):
    """Serve until interrupted."""
    server = make_server(store, host, port, federate=federate, history_dir=history_dir)
    print(f"polyaxon streams serving on http://{host}:{server.server_address[1]}", flush=True)
    if server.history_sampler is not None:
        server.history_sampler.start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if server.history_sampler is not None:
            server.history_sampler.stop()


class BackgroundServer:
    """Serve on a free port in a daemon thread, as a context manager."""

    def __init__(self, store: Optional[RunStore] = None,
                 federate: Optional[dict[str, str]] = None,
                 history_dir: Optional[str] = None):
        self.server = make_server(store, port=0, federate=federate, history_dir=history_dir)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        if self.server.history_sampler is not None:
            self.server.history_sampler.start()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.server.history_sampler is not None:
            self.server.history_sampler.stop()
        self.server.shutdown()
        self.server.server_close()
