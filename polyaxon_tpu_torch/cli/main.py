"""The `polyaxon` CLI of the port, on argparse: an own copy of the
reference's click CLI (`polyaxon_tpu/cli/main.py`) for the commands this
port runs, with their flags, output lines and exit codes.

    python -m polyaxon_tpu_torch run -f file.yaml [-P name=value] [--watch]
    python -m polyaxon_tpu_torch check -f file.yaml
    python -m polyaxon_tpu_torch ops ls|get|logs|statuses|metrics|compare|artifacts
                                     |stop|delete|restart|resume|copy [-uid UID]
    python -m polyaxon_tpu_torch serve -uid UID [--pools P:D] [--route] ...
    python -m polyaxon_tpu_torch config show|get|set, events, timeline,
                                 stats, trace, query, version

Runs go to the card unless `POLYAXON_TORCH_DEVICE=cpu`. An error exits 1
with `Error: <message>` on stderr, a usage error exits 2 (as click's do).
A jaxjob over several devices runs as a gang of one worker per device
(`runtime/executor.py`). What is not ported is refused with an error
naming ROADMAP.md: a gang for a zoo model or a replica over several
devices, a sweep, a schedule, joins, a dag, connections, a
remote control plane (`streams_url`), `--queue` clones and `serve --mesh`.

`main(argv) -> int` runs in-process (the tests and `chip_smoke.py` drive
it so).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from pathlib import Path
from typing import Optional

from .. import __version__
from ..client import ClientError
from ..compiler.resolver import CompilationError, compile_operation
from ..polyaxonfile.reader import PolyaxonfileError, read_polyaxonfile
from ..schemas.lifecycle import V1Statuses
from ..store import RunStore
from ..store.local import UnknownRunError

_ROADMAP = "is not ported to PyTorch yet (see ROADMAP.md)"


class ClickException(Exception):
    """A clean CLI failure: `Error: <message>`, exit 1."""

    exit_code = 1


class UsageError(ClickException):
    exit_code = 2


def echo(message="", nl: bool = True, err: bool = False) -> None:
    stream = sys.stderr if err else sys.stdout
    stream.write(str(message) + ("\n" if nl else ""))
    stream.flush()


def _uerr(e: KeyError) -> ClickException:
    # str(KeyError) is repr(msg): args[0] is the clean message
    return ClickException(str(e.args[0]) if e.args else str(e))


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        raise UsageError(message)


def _existing_file(value: str) -> str:
    if not Path(value).exists():
        raise argparse.ArgumentTypeError(f"Path {value!r} does not exist.")
    return value


# ------------------------------------------------------------------ run/check
def _params_to_dict(params):
    out = {}
    for p in params or ():
        if "=" not in p:
            raise UsageError(f"Invalid value for '-P' / '--param': -P expects name=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            v = json.loads(v)
        except ValueError:
            pass  # keep as string
        out[k] = v
    return out


def cmd_version(a):
    echo(f"polyaxon-tpu {__version__}")


def cmd_run(a):
    """Submit a polyaxonfile for execution: compiled, then run in this
    process by the local executor."""
    from .. import settings
    from ..device import env_device, resolve_device
    from ..runtime.executor import Executor, gang_device_error, refusal

    try:
        op = read_polyaxonfile(a.fpath, params=_params_to_dict(a.params))
    except PolyaxonfileError as e:
        raise ClickException(str(e))
    if a.name:
        op = op.copy(name=a.name)
    if settings.get("streams_url"):
        raise NotImplementedError(
            f"submitting to a remote control plane (streams_url; client/'s HTTP "
            f"transport, streams/) {_ROADMAP}; unset streams_url to execute locally"
        )
    store = RunStore()
    try:
        compiled = compile_operation(op, project=a.project, artifacts_root=str(store.runs_dir),
                                     base_dir=None)
    except CompilationError as e:
        raise ClickException(str(e))
    try:
        why = refusal(compiled)
    except ValueError as e:  # a replica over no whole number of devices
        raise ClickException(str(e))
    if why is not None:
        raise NotImplementedError(why)
    if compiled.run.kind == "jaxjob" and compiled.run.program is not None:
        try:
            resolve_device(env_device())
        except (RuntimeError, ValueError) as e:
            raise ClickException(str(e))
        short = gang_device_error(compiled, env_device())
        if short is not None:
            raise ClickException(short)
    echo(f"run {compiled.run_uuid[:8]} ({compiled.name}) created")
    status = Executor(store).execute(compiled)
    echo(f"run {compiled.run_uuid[:8]} finished: {status}")
    if status == V1Statuses.FAILED:
        echo(store.read_logs(compiled.run_uuid), err=True)
        return 1
    if a.watch:
        echo(store.read_logs(compiled.run_uuid))


def cmd_check(a):
    """Validate + dry-compile a polyaxonfile, print the resolved spec."""
    try:
        op = read_polyaxonfile(a.fpath)
        compiled = compile_operation(op, base_dir=None)
    except (PolyaxonfileError, CompilationError) as e:
        raise ClickException(str(e))
    echo(json.dumps(compiled.to_dict(), indent=1, default=str))


# ------------------------------------------------------------ live surfaces
def _http_json(url, timeout=10.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read())
        except ValueError:
            payload = {}
        raise ClickException(f"{url} -> HTTP {e.code}: {payload.get('error', e.reason)}")
    except (urllib.error.URLError, OSError) as e:
        raise ClickException(f"cannot reach {url}: {e}")


def _echo_slo(slo: dict):
    if not slo.get("enabled"):
        echo("slo: no objectives configured")
        return
    echo("slo: " + ("BREACHED" if slo.get("breached") else "ok"))
    for s in slo.get("slos", []):
        windows = " ".join(f"{w}={b:.2f}x" for w, b in (s.get("burn_rates") or {}).items())
        echo(
            f"  {s['name']:<20} {s.get('kind', '?'):<13} "
            f"objective={s.get('objective')}  "
            f"burn={s.get('burn_rate', 0):.2f}x "
            f"[{windows}]  bad/total={s.get('bad', 0):g}/"
            f"{s.get('total', 0):g}"
            + ("  BREACHED" if s.get("breached") else "")
        )


def _echo_trace_list(url: str, n: int, sort: str):
    data = _http_json(f"{url}/tracez?n={n}&sort={sort}")
    echo(f"traces: {data.get('retained', 0)} retained "
         f"({data.get('errors', 0)} errors kept, sort={sort})")
    for t in data.get("traces", []):
        echo(f"  {t['id']:<34} {t.get('status', '?'):<18} "
             f"{t.get('dur_ms', 0):9.2f} ms  {t.get('spans', 0)} spans")


def _fold_metrics(records) -> tuple[dict, Optional[int]]:
    """Latest value per series, and the newest training step (monitor
    samples interleave in one stream and count their own `step`)."""
    folded: dict = {}
    step = None
    for rec in records:
        is_training = any(k not in ("step", "ts") and not k.startswith("sys.") for k in rec)
        for k, v in rec.items():
            if k == "step":
                if is_training and v is not None:
                    step = max(step or 0, int(v))
            elif k != "ts":
                folded[k] = v
    return folded, step


def cmd_stats(a):
    """Live metrics and recent spans of a run, from the run store; with
    --url, a serving surface's /statsz (+ /sloz, /tracez)."""
    if a.url:
        url = a.url.rstrip("/")
        stats = _http_json(f"{url}/statsz")
        echo(json.dumps({k: v for k, v in stats.items() if k not in ("slo", "tracing")},
                        indent=1, default=str))
        tracing = stats.get("tracing") or {}
        echo(f"tracing: {'on' if tracing.get('enabled') else 'off'} "
             f"({tracing.get('retained', 0)} traces retained)")
        if a.show_slo:
            _echo_slo(stats.get("slo") or _http_json(f"{url}/sloz"))
        if a.n_traces:
            _echo_trace_list(url, a.n_traces, "recent")
        return
    if a.show_slo or a.n_traces:
        raise ClickException("--slo/--traces need --url (live server)")
    if not a.run_ref:
        raise ClickException("pass a RUN_REF or --url")
    store = RunStore()
    try:
        uuid = store.resolve(a.run_ref)
    except UnknownRunError as e:
        raise _uerr(e)
    if (store.home / "fleet" / "reservations.json").exists():
        raise NotImplementedError(f"reading a store's fleet reservations (scheduler/fleet.py) {_ROADMAP}")
    status = store.get_status(uuid)
    echo(f"run {uuid[:8]}  status={status.get('status', '?')}")
    meta = status.get("meta") or {}
    if status.get("status") in (V1Statuses.QUEUED, V1Statuses.SCHEDULED):
        import time as _time

        from ..scheduler.queue import RunQueue

        qname = meta.get("queue") or "default"
        entry = next((e for e in RunQueue(store, name=qname).peek_all() if e["uuid"] == uuid),
                     None)
        if entry is not None and entry.get("enqueued_at"):
            wait = max(0.0, _time.time() - float(entry["enqueued_at"]))
            echo(f"queued on {qname!r} for {wait:.1f}s "
                 f"(priority {entry.get('priority', 0)}, "
                 f"seq {entry.get('seq', '?')}, chips {entry.get('chips', '?')})")
    if meta.get("preempt_restarts"):
        echo(f"scheduler preemptions: {meta['preempt_restarts']} (resumed from checkpoint)")
    folded, step = _fold_metrics(store.read_metrics(uuid))
    if folded:
        at = "" if step is None else f" (train step {step})"
        echo(f"\nmetrics, latest value per series{at}:")
        for k in sorted(folded):
            v = folded[k]
            val = f"{v:.6g}" if isinstance(v, (int, float)) else str(v)
            echo(f"  {k:<32} {val}")
    spans_path = store.outputs_dir(uuid) / "telemetry" / "spans.jsonl"
    if spans_path.exists():
        lines = spans_path.read_text().splitlines()[-max(1, a.n_spans):]
        echo(f"\nspans, last {len(lines)}:")
        for ln in lines:
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            attrs = " ".join(f"{k}={v}" for k, v in (rec.get("attrs") or {}).items())
            indent = "  " if rec.get("parent_id") else ""
            echo(f"  {indent}{rec.get('name', '?'):<14} "
                 f"{(rec.get('dur_s') or 0) * 1e3:10.3f} ms  {attrs}")
    events = store.read_events(uuid)
    if events:
        echo(f"\nevents, last {min(max(1, a.n_events), len(events))}:")
        for ev in events[-max(1, a.n_events):]:
            body = {k: v for k, v in ev.items() if k not in ("kind", "ts")}
            echo(f"  {ev.get('kind', '?'):<20} {json.dumps(body, default=str)[:120]}")


def cmd_trace(a):
    """Inspect a serving request trace (GET /tracez)."""
    url = a.url.rstrip("/")
    if a.export_path:
        listing = _http_json(f"{url}/tracez?n={a.n_traces}&sort={a.sort}")
        count = 0
        with open(a.export_path, "w") as f:
            for t in listing.get("traces", []):
                full = _http_json(f"{url}/tracez?id={t['id']}")
                f.write(json.dumps(full, default=str) + "\n")
                count += 1
        echo(f"exported {count} traces to {a.export_path}")
        return
    if not a.trace_id:
        _echo_trace_list(url, a.n_traces, a.sort)
        return
    t = _http_json(f"{url}/tracez?id={a.trace_id}")
    echo(f"trace {t['id']}  status={t.get('status', '?')}  {t.get('dur_ms', 0):.2f} ms"
         + (f"  error={t['error']}" if t.get("error") else ""))
    for k, v in (t.get("attrs") or {}).items():
        echo(f"  {k}={v}")
    for s in t.get("spans", []):
        attrs = " ".join(f"{k}={v}" for k, v in (s.get("attrs") or {}).items())
        echo(f"  {s.get('start_s', 0) * 1e3:9.3f} ms  {s.get('name', '?'):<14} "
             f"{s.get('dur_s', 0) * 1e3:9.3f} ms  {attrs}")


def cmd_query(a):
    """Query the metrics history of a live server (GET /queryz)."""
    url = a.url.rstrip("/")
    if not a.series:
        data = _http_json(f"{url}/queryz")
        echo(f"history: {data.get('bytes', 0)} bytes, {len(data.get('series', []))} series")
        for name in data.get("series", []):
            echo(f"  {name}")
        return
    params = {"series": a.series, "agg": a.agg}
    for k, v in (("since", a.since), ("until", a.until), ("last", a.last), ("step", a.step)):
        if v is not None:
            params[k] = v
    from urllib.parse import urlencode

    data = _http_json(f"{url}/queryz?{urlencode(params)}")
    if a.as_json:
        echo(json.dumps(data, indent=1, default=str))
        return
    echo(f"{data['series']}  agg={data['agg']}  samples={data.get('samples', 0)}"
         + (f"  resets={data['resets']}" if data.get("resets") else ""))
    for t, v in data.get("points", []):
        echo(f"  {t:14.3f}  " + ("-" if v is None else f"{v:.6g}"))


# ------------------------------------------------------------------ ops
def _run_client():
    from .. import settings
    from ..client import RunClient

    if settings.get("streams_url"):
        raise NotImplementedError(
            f"a remote control plane (streams_url; client/'s HTTP transport) {_ROADMAP}"
        )
    return RunClient()


def cmd_ops_ls(a):
    client = _run_client()
    rows = client.list(a.project)
    if a.sweep_ref:
        sweep_uuid = client.get(a.sweep_ref).get("uuid") or a.sweep_ref
        rows = [
            {**r, "iteration": (r.get("meta") or {}).get("iteration")}
            for r in rows if (r.get("meta") or {}).get("sweep") == sweep_uuid
        ]
    if not rows:
        echo("no runs")
        return
    for r in rows:
        line = (f"{r['uuid'][:8]}  {r.get('status', '?'):<12} "
                f"{r.get('project', ''):<12} {r.get('name', '')}")
        if a.sweep_ref:
            line += f"  [iter {r.get('iteration')}]"
        echo(line)


def cmd_ops_get(a):
    client = _run_client()
    out = {
        "status": client.get(a.uid),
        "metrics_tail": client.metrics(a.uid)[-5:],
        "spec": client.store.read_spec(client.store.resolve(a.uid)),
    }
    echo(json.dumps(out, indent=1, default=str))


def cmd_ops_logs(a):
    _run_client()
    store = RunStore()
    uid = store.resolve(a.uid)
    if a.follow:
        for chunk in store.watch_logs(uid):
            echo(chunk, nl=False)
    else:
        echo(store.read_logs(uid), nl=False)


def cmd_ops_statuses(a):
    for c in _run_client().statuses(a.uid):
        echo(f"{c.get('ts', 0):.3f}  {c['type']:<12} {c.get('reason', '')}")


def cmd_ops_metrics(a):
    for m in _run_client().metrics(a.uid):
        echo(json.dumps(m))


def cmd_ops_compare(a):
    """Side-by-side final metrics and params of two or more runs."""
    if len(a.uids) < 2:
        raise ClickException("compare needs at least two --uid")
    client = _run_client()
    cols = []
    for uid in a.uids:
        status = client.get(uid)
        folded, step = _fold_metrics(client.metrics(uid))
        spec = client.spec(uid)
        cols.append({
            "uid": status.get("uuid", uid)[:8],
            "status": str(status.get("status", "?")),
            "params": spec.get("params") or {},
            "metrics": folded,
            "step": step,
        })
    rows = sorted({k for c in cols for k in c["metrics"]})
    pkeys = sorted({k for c in cols for k in c["params"]})
    header = ["", *[c["uid"] for c in cols]]
    table = [header, ["status", *[c["status"] for c in cols]],
             ["step", *["—" if c["step"] is None else str(c["step"]) for c in cols]]]
    for k in pkeys:
        table.append([f"param.{k}", *[str(c["params"].get(k, "—")) for c in cols]])
    for k in rows:
        table.append([k, *[f"{c['metrics'][k]:.6g}" if k in c["metrics"] else "—"
                           for c in cols]])
    widths = [max(len(r[i]) for r in table) for i in range(len(header))]
    for r in table:
        echo("  ".join(x.ljust(w) for x, w in zip(r, widths)))


def cmd_ops_artifacts(a):
    """List a run's output artifacts, or copy one out with --path."""
    client = _run_client()
    if a.path is None:
        files = client.artifacts(a.uid)
        if not files:
            echo("no artifacts")
        for f in files:
            echo(f)
        return
    echo(str(client.download_artifact(a.uid, a.path, Path(a.output) / Path(a.path).name)))


def cmd_ops_stop(a):
    client = _run_client()
    client.stop(a.uid)
    echo(f"{a.uid[:8]} {client.get(a.uid).get('status', 'stopping')}")


def cmd_ops_delete(a):
    """Delete a finished run's data (metrics, logs, outputs) permanently."""
    if not a.yes:
        sys.stderr.write(f"permanently delete run {a.uid[:8]}? [y/N]: ")
        sys.stderr.flush()
        answer = sys.stdin.readline().strip().lower()
        if answer not in ("y", "yes"):
            echo("Aborted!", err=True)
            return 1
    try:
        _run_client().delete(a.uid, cascade=a.cascade)
    except ValueError as e:
        raise ClickException(str(e))
    echo(f"{a.uid[:8]} deleted")


def _clone_cmd(a, kind):
    client = _run_client()
    try:
        new_uuid = getattr(client, kind)(a.uid, queue=not a.eager)
    except CompilationError as e:
        raise ClickException(str(e))
    status = client.get(new_uuid).get("status", "queued")
    echo(f"{kind} of {a.uid[:8]} -> run {new_uuid[:8]} ({status})")


# ------------------------------------------------------------------ config
def cmd_config_show(a):
    from .. import settings

    echo(json.dumps(settings.show(), indent=1))


def cmd_config_get(a):
    from .. import settings

    try:
        echo(settings.get(a.key))
    except KeyError as e:
        raise ClickException(str(e))


def cmd_config_set(a):
    from .. import settings

    try:
        settings.set_value(a.key, a.value)
    except KeyError as e:
        raise ClickException(str(e))
    echo(f"{a.key} = {a.value}")


# ------------------------------------------------------------ events/timeline
def cmd_events(a):
    """Run history straight from the event log, one JSON record per line;
    --follow rides the store's watch cursor until the run is done."""
    from ..schemas.lifecycle import DONE_STATUSES

    store = RunStore()
    try:
        uid = store.resolve(a.ref)
    except UnknownRunError as e:
        raise _uerr(e)
    if not a.follow:
        for rec in store.get_history(uid):
            echo(json.dumps(rec, default=str))
        return
    store.get_history(uid)  # force the legacy import so the log has the run

    def _terminal() -> bool:
        try:
            return V1Statuses(store.get_status(uid).get("status", "")) in DONE_STATUSES
        except ValueError:
            return False

    for rec in store.watch("0:0", timeout=a.timeout, stop=_terminal):
        if rec.get("r") == uid:
            echo(json.dumps(rec, default=str))


def cmd_timeline(a):
    """A run's causally ordered story, folded from its event log (with
    --url, a streams server's /runs/<ref>/timeline)."""
    if a.url is not None:
        entries = _http_json(f"{a.url.rstrip('/')}/runs/{a.ref}/timeline")["timeline"]
    else:
        store = RunStore()
        try:
            uid = store.resolve(a.ref)
        except UnknownRunError as e:
            raise _uerr(e)
        entries = store.timeline(uid)
    if a.as_json:
        for e in entries:
            echo(json.dumps(e, default=str))
        return
    import datetime

    for e in entries:
        ts = e.get("ts")
        when = (datetime.datetime.fromtimestamp(ts).strftime("%H:%M:%S")
                if isinstance(ts, (int, float)) else "--:--:--")
        echo(f"#{e.get('seq', '?'):<5} {when}  {e.get('kind', '?'):<11} {e.get('label', '')}")


# ------------------------------------------------------------------ serve
# override field → the flag a replica child takes it as
_SERVE_FLAG_SPELLING = {
    "max_batch": "--max-batch",
    "max_wait_ms": "--max-wait-ms",
    "max_queue": "--max-queue",
    "default_deadline_ms": "--default-deadline-ms",
    "drain_grace_s": "--drain-grace-s",
    "breaker_threshold": "--breaker-threshold",
    "kv_pool_pages": "--kv-pool-pages",
    "kv_page_tokens": "--kv-page-tokens",
    "draft_tokens": "--draft-tokens",
    "kv_quant": "--kv-quant",
    "prefill_chunk_tokens": "--prefill-chunk-tokens",
    "max_step_tokens": "--max-step-tokens",
    "spill_ram_bytes": "--spill-ram-bytes",
    "spill_dir_bytes": "--spill-dir-bytes",
    "adapter_slots": "--adapter-slots",
    "role": "--role",
}


def _serve_overrides(a) -> dict:
    """The flags actually given, as ServingConfig fields: they layer over
    the run spec's own `serving:` section."""
    overrides: dict = {}
    if a.buckets:
        try:
            overrides["prompt_buckets"] = tuple(int(b) for b in a.buckets.split(","))
        except ValueError:
            raise ClickException(f"--buckets expects N,N,... ints, got {a.buckets!r}")
    for flag, field, value in (("no_batching", "batching", False),
                               ("no_prefix_cache", "prefix_cache", False),
                               ("no_stream", "stream", False), ("speculate", "speculate", True),
                               ("quantize", "quantize", True)):
        if getattr(a, flag):
            overrides[field] = value
    if a.draft_model is not None:
        from ..serving.batching import normalize_draft_model

        spec = {}
        if a.draft_model.strip().lower() != "auto":
            try:
                for part in a.draft_model.split(","):
                    k, v = part.split("=", 1)
                    try:
                        spec[k.strip()] = int(v)
                    except ValueError:
                        spec[k.strip()] = float(v)
            except ValueError:
                raise ClickException(
                    f"--draft-model expects 'auto' or k=v[,k=v...] numeric "
                    f"overrides, got {a.draft_model!r}"
                )
        overrides["draft_model"] = normalize_draft_model(spec)
    if a.adaptive_draft:
        overrides["adaptive_draft"] = True
    if a.kv_quant is not None:
        overrides["kv_quant"] = a.kv_quant
    if a.chunked_prefill and a.no_chunked_prefill:
        raise ClickException("--chunked-prefill and --no-chunked-prefill are exclusive")
    if a.chunked_prefill:
        overrides["chunked_prefill"] = True
    if a.no_chunked_prefill:
        overrides["chunked_prefill"] = False
    if a.no_trace:
        overrides["trace"] = False
    if a.adapter_specs:
        from ..serving.tenancy import normalize_adapters

        amap = {}
        for spec in a.adapter_specs:
            name, sep, src = spec.partition("=")
            if not sep or not name.strip() or not src.strip():
                raise ClickException(f"--adapter expects NAME=SOURCE, got {spec!r}")
            amap[name.strip()] = src.strip()
        try:
            overrides["adapters"] = normalize_adapters(amap)
        except ValueError as e:
            raise ClickException(str(e))
    if a.tenant_specs:
        from ..serving.tenancy import normalize_tenants

        rows = []
        for spec in a.tenant_specs:
            name, _, rest = spec.partition("=")
            if not name.strip():
                raise ClickException(
                    f"--tenant-quota expects NAME=OUT:TOK:WEIGHT:ADAPTER "
                    f"(fields optional), got {spec!r}"
                )
            fields = (rest.split(":") + [""] * 4)[:4]
            row = {"name": name.strip()}
            try:
                if fields[0].strip():
                    row["max_outstanding"] = int(fields[0])
                if fields[1].strip():
                    row["max_tokens"] = int(fields[1])
                if fields[2].strip():
                    row["weight"] = float(fields[2])
            except ValueError:
                raise ClickException(
                    f"--tenant-quota {spec!r}: OUT/TOK are ints, WEIGHT is a float"
                )
            if fields[3].strip():
                row["adapter"] = fields[3].strip()
            rows.append(row)
        try:
            overrides["tenants"] = normalize_tenants(rows)
        except ValueError as e:
            raise ClickException(str(e))
    if a.adapter_slots is not None:
        overrides["adapter_slots"] = a.adapter_slots
    for field in ("max_batch", "max_wait_ms", "max_queue", "default_deadline_ms",
                  "drain_grace_s", "breaker_threshold", "kv_pool_pages", "kv_page_tokens",
                  "draft_tokens", "prefill_chunk_tokens", "max_step_tokens",
                  "spill_ram_bytes", "spill_dir", "spill_dir_bytes", "role"):
        value = getattr(a, field)
        if value is not None:
            overrides[field] = value
    return overrides


def _wait_for_signal() -> None:
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()


def cmd_serve(a):
    """Serve a checkpointed LM run's generation over HTTP (GET /healthz,
    GET /readyz, GET /statsz, POST /generate)."""
    from ..device import env_device
    from ..serving.server import ModelServer, ServingError

    if a.mesh or a.mesh_model is not None:
        raise NotImplementedError(
            f"serve --mesh/--mesh-model (a decode mesh, parallel/mesh.py) {_ROADMAP}"
        )
    if a.expected_devices is not None:
        raise NotImplementedError(
            f"serve --expected-devices (slice health, runtime/health.py) {_ROADMAP}"
        )
    overrides = _serve_overrides(a)
    pool_counts = None
    if a.pools:
        try:
            p, _, d = a.pools.partition(":")
            pool_counts = (int(p), int(d))
            if min(pool_counts) < 0 or sum(pool_counts) < 1:
                raise ValueError
        except ValueError:
            raise ClickException(f"--pools expects PREFILL:DECODE counts, got {a.pools!r}")
    # a run whose spec declares serving.pools comes up disaggregated with
    # no CLI opt-in: `serve -uid` promises the shape the spec pinned
    spec_wants_pools = (
        pool_counts is None and not a.route and (a.replicas or 0) <= 1
        and a.role is None and _run_spec_pools(a.uid) is not None
    )
    if a.route or (a.replicas or 0) > 1 or pool_counts is not None or spec_wants_pools:
        return _serve_fleet(a, overrides, pool_counts)
    try:
        server = ModelServer.from_run(a.uid, config_overrides=overrides or None,
                                      device=env_device())
    except (ServingError, KeyError, ValueError) as e:
        raise ClickException(str(e.args[0]) if e.args else str(e))
    bound = server.start(host=a.host, port=a.port)
    cfg = server.config
    mode = (f"batching max_batch={cfg.max_batch} max_wait_ms={cfg.max_wait_ms}"
            if cfg.batching else "per-request (no batching)")
    if cfg.batching and cfg.kv_pool_pages:
        mode += f" kv_pool={cfg.kv_pool_pages}x{cfg.kv_page_tokens}tok"
    echo(f"serving {server.model_name} (step {server.step}) "
         f"on http://{a.host}:{bound} [{mode}] — "
         "POST /generate, GET /healthz, GET /readyz, GET /statsz, "
         "GET /tracez, GET /sloz")
    try:
        _wait_for_signal()
    finally:
        # graceful drain: /readyz flips to 503 and admission closes; work
        # in flight gets drain_grace_s to finish
        echo("draining...")
        server.stop()


def _serve_child_argv(uid, port, overrides):
    """The one-replica `serve` command line a replica child runs: the same
    code path as one-replica serving, so fleet mode adds no second serving
    implementation."""
    argv = [sys.executable, "-m", "polyaxon_tpu_torch", "serve",
            "-uid", uid, "--host", "127.0.0.1", "--port", str(port)]
    for field, value in (overrides or {}).items():
        if field == "prompt_buckets":
            argv += ["--buckets", ",".join(str(b) for b in value)]
        elif field == "batching" and value is False:
            argv += ["--no-batching"]
        elif field == "prefix_cache" and value is False:
            argv += ["--no-prefix-cache"]
        elif field == "stream" and value is False:
            argv += ["--no-stream"]
        elif field == "trace" and value is False:
            argv += ["--no-trace"]
        elif field in ("speculate", "quantize") and value:
            argv += [f"--{field}"]
        elif field == "adaptive_draft" and value:
            argv += ["--adaptive-draft"]
        elif field == "draft_model" and value is not None:
            argv += ["--draft-model", ",".join(f"{k}={v}" for k, v in value) or "auto"]
        elif field == "chunked_prefill":
            argv += ["--chunked-prefill" if value else "--no-chunked-prefill"]
        elif field == "spill_dir" and value:
            # each child its own segment namespace: two processes writing one
            # spill dir would collide on sequence names
            argv += ["--spill-dir", str(Path(value) / f"r{port}")]
        elif field == "adapters":
            for name, src in value:
                argv += ["--adapter", f"{name}={src}"]
        elif field == "tenants":
            for pairs in value:
                d = dict(pairs)
                out, tok = d.get("max_outstanding"), d.get("max_tokens")
                argv += ["--tenant-quota",
                         f"{d['name']}={'' if out is None else out}"
                         f":{'' if tok is None else tok}"
                         f":{d.get('weight', 1.0)}:{d.get('adapter', '')}"]
        elif field in _SERVE_FLAG_SPELLING:
            argv += [_SERVE_FLAG_SPELLING[field], str(value)]
    return argv


def _child_env() -> dict:
    """A replica child's environment: this one (POLYAXON_HOME and
    POLYAXON_TORCH_DEVICE included), with this package importable from any
    working directory."""
    root = str(Path(__file__).resolve().parents[2])
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": root + (os.pathsep + path if path else "")}


def _serving_spec(store: RunStore, uuid: str):
    from ..schemas.run_kinds import V1JAXJob

    run = (store.read_spec(uuid).get("component") or {}).get("run") or {}
    if run.get("kind") != "jaxjob" or not run.get("program"):
        return None
    return V1JAXJob.from_dict(run).program.serving


def _run_spec_pools(uid):
    """(prefill, decode) from the run spec's serving.pools, or None (an
    unknown uid or a templated count falls through to the one-replica
    path, whose own errors are better placed)."""
    try:
        store = RunStore()
        spec = _serving_spec(store, store.resolve(uid))
    except Exception:  # noqa: BLE001
        return None
    ps = spec.pools if spec is not None else None
    if ps is None or not (isinstance(ps.prefill, int) and isinstance(ps.decode, int)):
        return None
    return (int(ps.prefill), int(ps.decode))


def _serve_fleet(a, overrides, pools):
    """`serve --replicas N --route` / `--pools P:D`: one-replica children
    behind the port's router."""
    from ..serving.replicas import ReplicaSetManager, SubprocessReplica
    from ..serving.router import AutoscalePolicy, Router
    from ..telemetry import MetricsRegistry

    store = RunStore()
    try:
        uuid = store.resolve(a.uid)
    except KeyError as e:
        raise _uerr(e)
    try:
        serving_spec = _serving_spec(store, uuid)
    except Exception:  # noqa: BLE001 — the children report a bad spec
        serving_spec = None
    if pools is None and serving_spec is not None and serving_spec.pools:
        ps = serving_spec.pools
        if isinstance(ps.prefill, int) and isinstance(ps.decode, int):
            pools = (int(ps.prefill), int(ps.decode))
    if pools is not None:
        n = pools[0] + pools[1]
    else:
        n = a.replicas or (
            int(serving_spec.replicas)
            if serving_spec is not None and isinstance(serving_spec.replicas, int) else 1
        )
    if serving_spec is not None and serving_spec.mesh_axes:
        raise NotImplementedError(
            f"a run spec's serving.meshAxes (a decode mesh, parallel/mesh.py) {_ROADMAP}"
        )

    def factory(i):
        slot_overrides = overrides
        if pools is not None:
            # slots past the declared pools (autoscale growth) decode
            slot_overrides = {**overrides, "role": "prefill" if i < pools[0] else "decode"}
        return SubprocessReplica(lambda p: _serve_child_argv(uuid, p, slot_overrides),
                                 env=_child_env())

    registry = MetricsRegistry()
    manager = ReplicaSetManager(factory, replicas=n, name=f"serve-{uuid[:8]}",
                                registry=registry)
    autoscale = None
    if a.autoscale_max is not None:
        autoscale = AutoscalePolicy(min_replicas=n, max_replicas=a.autoscale_max)
    affinity = not a.no_affinity and (
        serving_spec.prefix_affinity if serving_spec is not None else True
    )
    router = Router(
        manager.endpoints,
        registry=registry,
        scaler=manager if autoscale is not None else None,
        autoscale=autoscale,
        trace=overrides.get("trace", True),
        affinity=affinity,
    )
    manager.attach_router(router)
    echo(f"starting {n} replica(s)...")
    try:
        manager.start()
    except Exception as e:  # noqa: BLE001
        manager.stop(drain=False)
        raise ClickException(f"replica startup failed: {e}")
    bound = router.start(host=a.host, port=a.port)
    echo(f"routing {n} replica(s) on http://{a.host}:{bound} — "
         "POST /generate, GET /healthz, GET /readyz, GET /statsz, GET /metricsz"
         + (f"; autoscale up to {a.autoscale_max}" if a.autoscale_max else ""))
    try:
        _wait_for_signal()
    finally:
        echo("draining fleet...")
        router.stop()
        manager.stop()


# ------------------------------------------------------------------ parser
def _uid(p, **kw):
    p.add_argument("-uid", "--uid", dest="uid", required=True, **kw)


def build_parser() -> argparse.ArgumentParser:
    cli = _Parser(prog="polyaxon", allow_abbrev=False,
                  description="Polyaxon-TPU, ported to PyTorch on CUDA.")
    sub = cli.add_subparsers(dest="command", required=True, metavar="COMMAND")

    sub.add_parser("version").set_defaults(func=cmd_version)

    p = sub.add_parser("run", help="submit a polyaxonfile for execution")
    p.add_argument("-f", "--file", dest="fpath", required=True, type=_existing_file)
    p.add_argument("-P", "--param", dest="params", action="append", default=[],
                   help="override: name=value")
    p.add_argument("--name", default=None, help="override run name")
    p.add_argument("--project", default="default")
    p.add_argument("--watch", action=argparse.BooleanOptionalAction, default=False,
                   help="print the run's logs after it finishes")
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("check", help="validate + dry-compile a polyaxonfile")
    p.add_argument("-f", "--file", dest="fpath", required=True, type=_existing_file)
    p.set_defaults(func=cmd_check)

    p = sub.add_parser("stats", help="live metrics and recent spans of a run")
    p.add_argument("run_ref", nargs="?")
    p.add_argument("--spans", dest="n_spans", type=int, default=12)
    p.add_argument("--events", dest="n_events", type=int, default=6)
    p.add_argument("--url", default=None)
    p.add_argument("--slo", dest="show_slo", action="store_true")
    p.add_argument("--traces", dest="n_traces", type=int, default=None)
    p.set_defaults(func=cmd_stats)

    p = sub.add_parser("trace", help="inspect a serving request trace (/tracez)")
    p.add_argument("trace_id", nargs="?")
    p.add_argument("--url", default="http://127.0.0.1:8601")
    p.add_argument("-n", dest="n_traces", type=int, default=20)
    p.add_argument("--sort", default="recent", choices=["recent", "slowest", "errors"])
    p.add_argument("--export", dest="export_path", default=None)
    p.set_defaults(func=cmd_trace)

    p = sub.add_parser("query", help="query a live server's metrics history (/queryz)")
    p.add_argument("series", nargs="?")
    p.add_argument("--url", default="http://127.0.0.1:8601")
    for flag in ("since", "until", "last", "step"):
        p.add_argument(f"--{flag}", type=float, default=None)
    p.add_argument("--agg", default="avg",
                   choices=["avg", "min", "max", "rate", "p50", "p95", "p99"])
    p.add_argument("--json", dest="as_json", action="store_true")
    p.set_defaults(func=cmd_query)

    ops = sub.add_parser("ops", help="inspect and manage runs")
    osub = ops.add_subparsers(dest="ops_command", required=True, metavar="COMMAND")
    p = osub.add_parser("ls")
    p.add_argument("--project", default=None)
    p.add_argument("--sweep", dest="sweep_ref", default=None)
    p.set_defaults(func=cmd_ops_ls)
    for name, fn in (("get", cmd_ops_get), ("statuses", cmd_ops_statuses),
                     ("metrics", cmd_ops_metrics), ("stop", cmd_ops_stop)):
        p = osub.add_parser(name)
        _uid(p)
        p.set_defaults(func=fn)
    p = osub.add_parser("logs")
    _uid(p)
    p.add_argument("--follow", action=argparse.BooleanOptionalAction, default=False)
    p.set_defaults(func=cmd_ops_logs)
    p = osub.add_parser("compare")
    p.add_argument("-uid", "--uid", dest="uids", action="append", required=True,
                   help="repeat for each run (2+)")
    p.set_defaults(func=cmd_ops_compare)
    p = osub.add_parser("artifacts")
    _uid(p)
    p.add_argument("--path", default=None)
    p.add_argument("-o", "--output", default=".")
    p.set_defaults(func=cmd_ops_artifacts)
    p = osub.add_parser("delete")
    _uid(p)
    p.add_argument("--yes", action="store_true")
    p.add_argument("--cascade", action="store_true")
    p.set_defaults(func=cmd_ops_delete)
    for kind in ("restart", "resume", "copy"):
        p = osub.add_parser(kind)
        _uid(p)
        g = p.add_mutually_exclusive_group()
        g.add_argument("--eager", dest="eager", action="store_true", default=True)
        g.add_argument("--queue", dest="eager", action="store_false")
        p.set_defaults(func=lambda a, kind=kind: _clone_cmd(a, kind))

    cfg = sub.add_parser("config", help="client settings")
    csub = cfg.add_subparsers(dest="config_command", required=True, metavar="COMMAND")
    csub.add_parser("show").set_defaults(func=cmd_config_show)
    p = csub.add_parser("get")
    p.add_argument("key")
    p.set_defaults(func=cmd_config_get)
    p = csub.add_parser("set")
    p.add_argument("key")
    p.add_argument("value")
    p.set_defaults(func=cmd_config_set)

    p = sub.add_parser("events", help="a run's history from the event log")
    p.add_argument("ref")
    p.add_argument("--follow", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--timeout", type=float, default=0.5)
    p.set_defaults(func=cmd_events)

    p = sub.add_parser("timeline", help="a run's causally ordered story")
    p.add_argument("ref")
    p.add_argument("--url", default=None)
    p.add_argument("--json", dest="as_json", action="store_true")
    p.set_defaults(func=cmd_timeline)

    p = sub.add_parser("serve", help="serve a checkpointed LM run over HTTP")
    _uid(p, help="run to serve (uuid/prefix/name)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8601)
    p.add_argument("--mesh", default=None)
    p.add_argument("--mesh-model", type=int, default=None)
    p.add_argument("--expected-devices", type=int, default=None)
    for flag, typ in (("--max-batch", int), ("--max-wait-ms", float), ("--max-queue", int),
                      ("--default-deadline-ms", float), ("--drain-grace-s", float),
                      ("--breaker-threshold", int), ("--kv-pool-pages", int),
                      ("--kv-page-tokens", int), ("--draft-tokens", int),
                      ("--prefill-chunk-tokens", int), ("--max-step-tokens", int),
                      ("--spill-ram-bytes", int), ("--spill-dir", str),
                      ("--spill-dir-bytes", int), ("--adapter-slots", int),
                      ("--replicas", int), ("--autoscale-max", int)):
        p.add_argument(flag, type=typ, default=None)
    for flag in ("--no-batching", "--no-prefix-cache", "--no-stream", "--speculate",
                 "--quantize", "--adaptive-draft", "--chunked-prefill",
                 "--no-chunked-prefill", "--no-affinity", "--no-trace", "--route"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--buckets", default=None)
    p.add_argument("--draft-model", default=None)
    p.add_argument("--kv-quant", default=None, choices=["none", "int8"])
    p.add_argument("--adapter", dest="adapter_specs", action="append", default=[],
                   metavar="NAME=SOURCE")
    p.add_argument("--tenant-quota", dest="tenant_specs", action="append", default=[],
                   metavar="NAME=OUT:TOK:WEIGHT:ADAPTER")
    p.add_argument("--role", default=None, choices=["both", "prefill", "decode"])
    p.add_argument("--pools", default=None, metavar="PREFILL:DECODE")
    p.set_defaults(func=cmd_serve)
    return cli


def main(argv: Optional[list[str]] = None) -> int:
    """Run one command; returns its exit code."""
    from ..device import env_device

    try:
        args = build_parser().parse_args(argv)
    except UsageError as e:
        echo(f"Error: {e}", err=True)
        return e.exit_code
    except SystemExit as e:  # --help
        return int(e.code or 0)
    try:
        try:
            env_device()  # a bad POLYAXON_TORCH_DEVICE is one clear error
        except ValueError as e:
            raise ClickException(str(e))
        return int(args.func(args) or 0)
    except ClickException as e:
        echo(f"Error: {e}", err=True)
        return e.exit_code
    except UnknownRunError as e:  # an unknown run ref: no traceback
        echo(f"Error: {_uerr(e)}", err=True)
        return 1
    except (NotImplementedError, ClientError) as e:
        echo(f"Error: {e}", err=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
