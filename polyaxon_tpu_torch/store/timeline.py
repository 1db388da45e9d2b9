"""Run timelines: fold a run's committed event-log records into one
causally ordered story (an own copy of `polyaxon_tpu/store/timeline.py`).

The event log already holds everything that happened to a run —
creation, every status transition, retries, preemptions and resumes,
elastic resizes, checkpoint-tier fallbacks — as committed records in
sequence order. What it does NOT give an operator is a readable account:
`history()` returns raw records whose interesting parts live three dicts
deep and whose kinds span two vocabularies (log-level `status`/`meta`
vs. the inner event kinds the executor/trainer/scheduler emit).

``fold_timeline`` is that account: a pure function from the history list
to flat entries ``{"seq", "ts", "kind", "label", "detail"}`` where
``kind`` is a small operator-facing category (transition, preemption,
resumed, retry, elastic, checkpoint, health, meta, event) and ``label``
is the one-line summary `polyaxon timeline` prints. Sequence numbers
come straight from the log — the commit order IS the causal order, no
sorting, no clock comparison.

NO clock in this module: a timeline is a
pure fold over committed records; every ``ts`` it carries was stamped by
the writer that committed the record.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["fold_timeline"]

#: inner event kind → timeline category. Anything unlisted stays a plain
#: "event" entry — the timeline never drops a record on the floor.
_EVENT_CATEGORY = {
    "preempted": "preemption",
    "worker_preempted": "preemption",
    "preemption_requested": "preemption",
    "resumed": "resumed",
    "retry": "retry",
    "elastic_shrink": "elastic",
    "elastic_resize": "elastic",
    "elastic_expand_requested": "elastic",
    "checkpoint_fallback": "checkpoint",
    "slice_health": "health",
}

#: meta entries worth a timeline line of their own (attempt counters,
#: elastic grants); the rest fold into one "meta" entry per record.
_META_LABELS = {
    "preempt_restarts": "preemption restarts",
    "retry_attempts": "retry attempts",
    "granted_chips": "granted chips",
}


def _entry(
    rec: dict, kind: str, label: str, detail: Optional[dict] = None
) -> dict:
    return {
        "seq": rec.get("seq"),
        "ts": rec.get("ts"),
        "kind": kind,
        "label": label,
        "detail": detail or {},
    }


def _label_event(ek: str, body: dict) -> str:
    """The one-liner for an inner event, leaning on the fields each
    emitter is known to attach (all optional — emitters evolve)."""
    if ek == "preempted":
        step = body.get("step")
        resume = body.get("resume_step")
        bits = [f"step {step}" if step is not None else None,
                f"resume at {resume}" if resume is not None else None]
        tail = ", ".join(b for b in bits if b)
        return f"preempted ({tail})" if tail else "preempted"
    if ek == "worker_preempted":
        return f"worker preempted at step {body.get('step')}"
    if ek == "preemption_requested":
        by = body.get("by")
        return f"preemption requested by {by}" if by else "preemption requested"
    if ek == "resumed":
        tier = body.get("tier")
        tail = f" from {tier} tier" if tier else ""
        return f"resumed at step {body.get('step')}{tail}"
    if ek == "retry":
        return (
            f"retry attempt {body.get('attempt')}"
            + (f": {body['error']}" if body.get("error") else "")
        )
    if ek == "elastic_shrink":
        return (
            f"elastic shrink: granted {body.get('granted')}"
            f" of {body.get('requested')} chips"
        )
    if ek == "elastic_resize":
        return (
            f"elastic resize: {body.get('from')} -> {body.get('to')} chips"
            if "from" in body or "to" in body
            else "elastic resize"
        )
    if ek == "elastic_expand_requested":
        return (
            f"elastic expand requested: {body.get('from')}"
            f" -> {body.get('to')} chips"
        )
    if ek == "checkpoint_fallback":
        steps = body.get("corrupt_steps") or []
        return (
            f"checkpoint fallback: corrupt step(s) {steps},"
            f" restored {body.get('restored_step')}"
        )
    if ek == "slice_health":
        return "slice health report"
    return ek.replace("_", " ")


def fold_timeline(history: list[dict]) -> list[dict]:
    """Fold committed event-log records (``RunStore.get_history`` order)
    into flat timeline entries. Pure — no I/O, no clock, no store."""
    out: list[dict] = []
    for rec in history:
        kind = rec.get("kind")
        if kind == "create":
            name = rec.get("name")
            project = rec.get("project")
            label = "created"
            if name:
                label += f" {project + '/' if project else ''}{name}"
            out.append(_entry(rec, "created", label, {"meta": rec.get("meta")}))
        elif kind == "status":
            status = rec.get("status")
            cond = rec.get("cond") or {}
            label = f"-> {status}"
            if cond.get("reason"):
                label += f" ({cond['reason']})"
            detail = {
                k: cond[k] for k in ("reason", "message") if cond.get(k)
            }
            out.append(_entry(rec, "transition", label, detail))
        elif kind == "meta":
            entries = rec.get("entries") or {}
            known = {k: v for k, v in entries.items() if k in _META_LABELS}
            if known:
                label = ", ".join(
                    f"{_META_LABELS[k]}: {v}" for k, v in known.items()
                )
            else:
                label = "meta: " + ", ".join(sorted(entries)) if entries \
                    else "meta"
            out.append(_entry(rec, "meta", label, {"entries": entries}))
        elif kind == "event":
            inner = rec.get("event") or {}
            ek = inner.get("kind", "?")
            body = {
                k: v for k, v in inner.items() if k not in ("kind", "ts")
            }
            category = _EVENT_CATEGORY.get(ek, "event")
            out.append(
                _entry(rec, category, _label_event(ek, body), body)
            )
        # kind == "log" never reaches here (history() excludes it); any
        # future kind falls through silently only if truly unknown:
        elif kind is not None:
            out.append(_entry(rec, "event", str(kind), {}))
    return out
