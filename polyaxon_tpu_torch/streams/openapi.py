"""OpenAPI 3.0 description of the control and streams HTTP API, served at
`/openapi.json`: an own copy of `polyaxon_tpu/streams/openapi.py`, the
same document. The spec sits beside the handlers (`streams/server.py`);
the port's client (`client/run_client.py`) is written against the same
routes.
"""

from __future__ import annotations


def spec() -> dict:
    run_param = {
        "name": "uuid",
        "in": "path",
        "required": True,
        "schema": {"type": "string"},
        "description": "run uuid, unique prefix, or name",
    }
    status = {
        "type": "object",
        "properties": {
            "uuid": {"type": "string"},
            "status": {"type": "string"},
            "conditions": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "type": {"type": "string"},
                        "status": {"type": "boolean"},
                        "reason": {"type": "string"},
                        "message": {"type": "string"},
                        "ts": {"type": "number"},
                    },
                },
            },
            "meta": {"type": "object", "additionalProperties": True},
        },
    }
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "polyaxon-tpu control/streams API",
            "version": "1.0.0",
            "description": (
                "Run store over HTTP: list/create/inspect/stop/delete runs, "
                "stream logs/metrics/events, browse artifacts. The same "
                "routes back the CLI, the Python RunClient, and the "
                "dashboard."
            ),
        },
        "paths": {
            "/healthz": {
                "get": {
                    "summary": "Service liveness",
                    "responses": {"200": {"description": "ok"}},
                }
            },
            "/readyz": {
                "get": {
                    "summary": "Service readiness (503 while draining)",
                    "responses": {
                        "200": {"description": "ready"},
                        "503": {"description": "not ready / draining"},
                    },
                }
            },
            "/metricsz": {
                "get": {
                    "summary": "Process metrics, Prometheus text format",
                    "responses": {
                        "200": {
                            "description": "metrics exposition",
                            "content": {"text/plain": {}},
                        }
                    },
                }
            },
            "/fleetz": {
                "get": {
                    "summary": "Fleet snapshot: inventory, reservations, "
                    "quota usage",
                    "responses": {
                        "200": {
                            "description": "fleet state",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "type": "object",
                                        "properties": {
                                            "configured": {"type": "boolean"},
                                            "config": {
                                                "type": "object",
                                                "nullable": True,
                                                "description": "topology or "
                                                "flat chip count, as set by "
                                                "`polyaxon fleet init`",
                                            },
                                            "chips_total": {"type": "integer"},
                                            "chips_reserved": {
                                                "type": "integer"
                                            },
                                            "chips_free": {"type": "integer"},
                                            "reservations": {
                                                "type": "array",
                                                "description": "gang "
                                                "reservations, oldest first",
                                                "items": {
                                                    "type": "object",
                                                    "properties": {
                                                        "uuid": {
                                                            "type": "string"
                                                        },
                                                        "chips": {
                                                            "type": "integer"
                                                        },
                                                        "project": {
                                                            "type": "string"
                                                        },
                                                        "queue": {
                                                            "type": "string"
                                                        },
                                                        "priority": {
                                                            "type": "integer"
                                                        },
                                                        "reserved_at": {
                                                            "type": "number"
                                                        },
                                                    },
                                                },
                                            },
                                            "projects": {
                                                "type": "object",
                                                "description": "per-project "
                                                "{chips, runs, quota}",
                                                "additionalProperties": True,
                                            },
                                        },
                                    }
                                }
                            },
                        }
                    },
                }
            },
            "/runs": {
                "get": {
                    "summary": "List runs, or long-poll the event log "
                    "(?watch=<cursor>)",
                    "parameters": [
                        {
                            "name": "project",
                            "in": "query",
                            "schema": {"type": "string"},
                        },
                        {
                            "name": "watch",
                            "in": "query",
                            "description": "Event-log cursor (seq:offset). "
                            "Empty or 'now' starts from the present. The "
                            "response is {events, cursor}; pass the "
                            "returned cursor back to resume with no gaps "
                            "or duplicates across server restarts.",
                            "schema": {"type": "string"},
                        },
                        {
                            "name": "timeout",
                            "in": "query",
                            "description": "Long-poll bound in seconds "
                            "(default 10, clamped to [0, 30]).",
                            "schema": {"type": "number"},
                        },
                    ],
                    "responses": {
                        "200": {
                            "description": "run index entries",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "type": "array",
                                        "items": {
                                            "type": "object",
                                            "properties": {
                                                "uuid": {"type": "string"},
                                                "name": {"type": "string"},
                                                "project": {"type": "string"},
                                                "status": {"type": "string"},
                                            },
                                        },
                                    }
                                }
                            },
                        }
                    },
                },
                "post": {
                    "summary": "Submit an operation (enqueued for an agent)",
                    "requestBody": {
                        "required": True,
                        "content": {
                            "application/json": {
                                "schema": {
                                    "type": "object",
                                    "required": ["operation"],
                                    "properties": {
                                        "operation": {
                                            "type": "object",
                                            "description": "V1Operation dict "
                                            "(polyaxonfile operation)",
                                        },
                                        "project": {"type": "string"},
                                        "priority": {"type": "integer"},
                                    },
                                }
                            }
                        },
                    },
                    "responses": {
                        "201": {"description": "created; body has uuid"},
                        "400": {"description": "invalid operation"},
                    },
                },
            },
            "/runs/{uuid}/status": {
                "get": {
                    "summary": "Run status + conditions",
                    "parameters": [run_param],
                    "responses": {
                        "200": {
                            "description": "status",
                            "content": {"application/json": {"schema": status}},
                        },
                        "404": {"description": "unknown run"},
                    },
                }
            },
            "/runs/{uuid}/logs": {
                "get": {
                    "summary": "Run logs (incremental via offset)",
                    "parameters": [
                        run_param,
                        {
                            "name": "offset",
                            "in": "query",
                            "schema": {"type": "integer"},
                            "description": "byte offset of the previous "
                            "read; response carries the next offset",
                        },
                    ],
                    "responses": {"200": {"description": "logs + offset"}},
                }
            },
            "/runs/{uuid}/metrics": {
                "get": {
                    "summary": "Metric records",
                    "parameters": [
                        run_param,
                        {
                            "name": "tail",
                            "in": "query",
                            "schema": {"type": "integer"},
                            "description": "last N records only",
                        },
                    ],
                    "responses": {"200": {"description": "metric rows"}},
                }
            },
            "/runs/{uuid}/events": {
                "get": {
                    "summary": "Structured run events",
                    "parameters": [run_param],
                    "responses": {"200": {"description": "event rows"}},
                }
            },
            "/runs/{uuid}/timeline": {
                "get": {
                    "summary": (
                        "Causally ordered operator timeline folded from "
                        "the run's event log (transitions, retries, "
                        "preemptions, elastic resizes, checkpoint tiers)"
                    ),
                    "parameters": [run_param],
                    "responses": {
                        "200": {"description": "{uuid, timeline: [...]}"}
                    },
                }
            },
            "/runs/{uuid}/spec": {
                "get": {
                    "summary": "Resolved run spec (params, component)",
                    "parameters": [run_param],
                    "responses": {"200": {"description": "spec"}},
                }
            },
            "/runs/{uuid}/artifacts": {
                "get": {
                    "summary": "List output files",
                    "parameters": [run_param],
                    "responses": {"200": {"description": "file listing"}},
                }
            },
            "/runs/{uuid}/artifacts/{path}": {
                "get": {
                    "summary": "Download one output file",
                    "parameters": [
                        run_param,
                        {
                            "name": "path",
                            "in": "path",
                            "required": True,
                            "schema": {"type": "string"},
                        },
                    ],
                    "responses": {
                        "200": {"description": "file bytes"},
                        "403": {"description": "path escapes outputs"},
                        "404": {"description": "no such file"},
                    },
                }
            },
            "/runs/{uuid}/stop": {
                "post": {
                    "summary": "Request cooperative stop",
                    "parameters": [run_param],
                    "responses": {"200": {"description": "updated status"}},
                }
            },
            "/runs/{uuid}": {
                "delete": {
                    "summary": "Delete a terminal run",
                    "parameters": [
                        run_param,
                        {
                            "name": "cascade",
                            "in": "query",
                            "schema": {"type": "boolean"},
                            "description": "sweeps: also delete trial runs "
                            "(refused otherwise)",
                        },
                    ],
                    "responses": {
                        "200": {"description": "deleted"},
                        "409": {"description": "run still active, or a "
                                "sweep with trials and no cascade"},
                    },
                }
            },
        },
    }
