"""Structured trace spans of the port: nested, monotonic, JSONL.

Port of ``repro.telemetry.trace``, writing the reference's records, so
either package's report reads the other's files.
``with span("deploy/plan", matrices=12):`` times one phase of a run.
Spans nest through a thread-local stack (a span opened inside another
records it as its parent; a redeploy thread or a shard's host thread
keeps a stack of its own), carry JSON-serialisable attributes, and are
written to the sink **at exit**, under a lock, as one JSON line each::

    {"name": "deploy/plan", "id": 3, "parent": 2, "depth": 1,
     "t_start": 0.0123, "t_end": 0.8711, "dur": 0.8588,
     "attrs": {"matrices": 12}}

Timestamps are :func:`repro_torch.telemetry.monotonic` reads relative
to the ``trace_to`` call.  Span ids are sequential integers handed out
under a lock: deterministic for a deterministic call order, no
generator touched.  A span measures host time; code that wants a
span to hold the card's work calls ``telemetry.sync`` under
``enabled()`` before it closes.

Spans are active only while a sink is open (:func:`trace_to`) *and*
telemetry is enabled; otherwise :func:`span` returns a shared no-op
context manager (nothing allocated per call, nothing timed).  The
``REPRO_TRACE`` environment variable opens a sink at import, so
``REPRO_TELEMETRY=1 REPRO_TRACE=out.jsonl python -m ...`` traces any
entry point without code changes.

:mod:`repro_torch.telemetry.report` aggregates a trace file into the
per-phase wall/self-time table.
"""
from __future__ import annotations

import json
import os
import threading

from repro_torch.telemetry.metrics import enabled, monotonic

_LOCK = threading.Lock()
_LOCAL = threading.local()


class _TraceState:
    __slots__ = ("sink", "path", "t0", "next_id")

    def __init__(self):
        self.sink = None
        self.path = None
        self.t0 = 0.0
        self.next_id = 0


_TRACE = _TraceState()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def trace_to(path: str) -> str:
    """Open ``path`` as the JSONL span sink (replacing any prior one).

    Resets the relative clock and the span-id sequence, so every trace
    file starts at ``t_start ~ 0`` with ids from 0.  Returns the path.
    """
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    f = open(path, "w", encoding="utf-8")
    with _LOCK:
        old = _TRACE.sink
        _TRACE.sink = f
        _TRACE.path = path
        _TRACE.t0 = monotonic()
        _TRACE.next_id = 0
    if old is not None:
        old.close()
    return path


def trace_stop() -> str | None:
    """Close the sink; returns the finished trace's path (or None)."""
    with _LOCK:
        f, path = _TRACE.sink, _TRACE.path
        _TRACE.sink = None
        _TRACE.path = None
    if f is not None:
        f.close()
    return path


def tracing() -> bool:
    """Is a span sink currently open?"""
    return _TRACE.sink is not None


def trace_path() -> str | None:
    """Path of the open sink, or None."""
    return _TRACE.path


def _coerce(v):
    """Attribute values must be JSON-serialisable and deterministic."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return float(v)  # host scalar (a 0-d tensor too)
    except (TypeError, ValueError):
        return str(v)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "depth", "t_start")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _stack()
        with _LOCK:
            self.id = _TRACE.next_id
            _TRACE.next_id += 1
        self.parent = stack[-1].id if stack else None
        self.depth = len(stack)
        stack.append(self)
        self.t_start = monotonic()
        return self

    def __exit__(self, *exc):
        t_end = monotonic()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec = {"name": self.name, "id": self.id, "parent": self.parent,
               "depth": self.depth,
               "t_start": round(self.t_start - _TRACE.t0, 9),
               "t_end": round(t_end - _TRACE.t0, 9),
               "dur": round(t_end - self.t_start, 9)}
        if self.attrs:
            rec["attrs"] = self.attrs
        line = json.dumps(rec) + "\n"
        with _LOCK:
            if _TRACE.sink is not None:
                _TRACE.sink.write(line)
        return False


def span(name: str, **attrs):
    """Context manager timing one named phase (no-op when inactive)."""
    if _TRACE.sink is None or not enabled():
        return _NOOP_SPAN
    return _Span(name, {k: _coerce(v) for k, v in attrs.items()})


_env_trace = os.environ.get("REPRO_TRACE", "")
if _env_trace:
    try:
        trace_to(_env_trace)
    except OSError:  # unwritable path must not break the import
        pass
