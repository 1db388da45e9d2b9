"""SIGTERM as a preemption notice: cooperative checkpoint-and-exit. An own
copy of `polyaxon_tpu/runtime/preemption.py`.

A spot machine gets a grace window between the reclaim notice (SIGTERM)
and the hard kill. The handler only sets a flag; the trainer's step loop
reads it at the next step boundary, flushes a checkpoint and raises
`Preempted`, so the caller can report a preemption (which never costs
retry budget) instead of a failure.

`install()` must run on the main thread (Python allows signal handlers
nowhere else); elsewhere it returns False and the flag can still be set
by `trigger()`.
"""

from __future__ import annotations

import contextlib
import signal
import threading

_flag = threading.Event()
_installed = False


def install() -> bool:
    """Route SIGTERM to the preemption flag. Returns True when the handler
    is in place (first call wins; later calls are no-ops returning True)."""
    global _installed
    if _installed:
        return True
    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread
        return False
    _installed = True
    return True


def _handler(signum, frame):  # noqa: ARG001 — signal-handler signature
    _flag.set()


def trigger() -> None:
    """Set the flag without a signal."""
    _flag.set()


def requested() -> bool:
    return _flag.is_set()


def clear() -> None:
    _flag.clear()


@contextlib.contextmanager
def scoped():
    """The handler for the length of a block (a run of the executor): on
    the main thread it replaces whatever handled SIGTERM and puts it back
    after, flag cleared both ways. Yields whether the handler is in place
    (False off the main thread, where `trigger()` still works)."""
    global _installed
    if threading.current_thread() is not threading.main_thread():
        clear()
        yield False
        return
    old, was = signal.getsignal(signal.SIGTERM), _installed
    _installed = False
    clear()
    try:
        yield install()
    finally:
        clear()
        signal.signal(signal.SIGTERM, old)
        _installed = was
