"""Distributed tracing over the task-event pipeline.

reference: python/ray/util/tracing/tracing_helper.py — OpenTelemetry spans
injected around task submit/execute, with the trace context serialized
into the TaskSpec so nested tasks, actor calls, and serve handlers chain
into ONE causal trace across processes.

Here the context is a per-thread ``(trace_id, span_id)`` pair:

  - ``span()`` opens a span under the active context (or roots a new
    trace) and records it as a pair of custom task events on the same
    sink tasks use (worker -> GcsServer task_events -> ray_tpu_torch.timeline()
    / state.get_trace()), so user spans, runtime spans, and tasks all
    land on one Chrome trace with parent/child linkage.
  - ``CoreWorker.submit_task`` captures the context into the TaskSpec
    (``trace_id``/``parent_span_id``/``span_id``); the executor restores
    it around execution, so a task submitted inside a span — or inside
    another task — joins the submitter's trace.
  - serve's HTTP proxy ingests/emits the context as a W3C ``traceparent``
    header (``ingest()`` / ``format_traceparent()``).

Everything is gated by ``task_events_enabled and tracing_enabled``; the
disabled fast path is one config read plus one thread-local read.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterator, Optional, Tuple

_local = threading.local()

# process-local telemetry (bench.py trace_summary snapshot)
_spans_emitted = 0
_last_trace_id: Optional[str] = None


def _enabled() -> bool:
    from ray_tpu_torch._private.config import global_config

    cfg = global_config()
    return cfg.task_events_enabled and cfg.tracing_enabled


def _worker():
    from ray_tpu_torch._private.worker import get_global_worker

    try:
        return get_global_worker()
    except RuntimeError:
        return None


def new_trace_id() -> str:
    """32 lowercase hex chars (W3C trace-id width)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """16 lowercase hex chars (W3C parent-id width)."""
    return uuid.uuid4().hex[:16]


def current_context() -> Optional[Tuple[str, str]]:
    """The active ``(trace_id, span_id)``, or None outside any span/task."""
    return getattr(_local, "ctx", None)


def context_active() -> bool:
    """Cheap hot-path guard: is there an active trace on this thread?"""
    return getattr(_local, "ctx", None) is not None


@contextlib.contextmanager
def activate(trace_id: str, span_id: Optional[str]) -> Iterator[None]:
    """Make ``(trace_id, span_id)`` the active context on this thread.

    Used to carry a context across thread hops (executor pools, the data
    streaming-executor scheduling thread) — it records nothing itself.
    """
    prev = getattr(_local, "ctx", None)
    _local.ctx = (trace_id, span_id)
    try:
        yield
    finally:
        _local.ctx = prev


def activate_from_spec(spec):
    """Executor side: restore the submitter's context around execution so
    spans and nested submissions inside the task chain into its trace.
    The task's own span_id becomes the parent of everything inside."""
    trace_id = getattr(spec, "trace_id", None)
    if trace_id is None:
        return contextlib.nullcontext()
    return activate(trace_id, getattr(spec, "span_id", None))


def capture_for_submit() -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """Owner side: ``(trace_id, parent_span_id, span_id)`` for a TaskSpec.

    Only submissions inside an active span/task join a trace — tracing is
    EXPLICIT (a ``span()``, a ``traceparent`` ingress, or an enclosing
    traced task).  Untraced submissions stay id-free: auto-rooting every
    task would activate a context in every executor and flood the bounded
    task sink with per-collective/engine/data spans nobody asked for.
    """
    ctx = getattr(_local, "ctx", None)
    if ctx is not None and _enabled():
        return ctx[0], ctx[1], new_span_id()
    return None, None, None


# -- W3C traceparent (https://www.w3.org/TR/trace-context/) ----------------


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` or None for a malformed header."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def ingest(traceparent: Optional[str] = None
           ) -> Optional[Tuple[str, str, Optional[str]]]:
    """Ingress helper: ``(trace_id, span_id, parent_span_id)`` for a new
    server-side request span, continuing the caller's trace when a valid
    ``traceparent`` header is supplied.  None when tracing is disabled."""
    if not _enabled() or _worker() is None:
        return None
    parsed = parse_traceparent(traceparent)
    if parsed is not None:
        return parsed[0], new_span_id(), parsed[1]
    return new_trace_id(), new_span_id(), None


# -- span recording --------------------------------------------------------


def emit_span(name: str, start: float, end: float, *,
              kind: str = "span",
              attributes: Optional[Dict[str, Any]] = None,
              trace_id: Optional[str] = None,
              parent_span_id: Optional[str] = None,
              span_id: Optional[str] = None,
              flush: bool = False) -> Optional[str]:
    """Record an already-completed span (wall-clock ``start``/``end``).

    The cheap recorder used by built-in hot paths (collectives, engine
    step phases, data operators): when no explicit ``trace_id`` is given
    it no-ops unless a context is active, so the disabled/untraced cost
    is two attribute reads.  Returns the span_id, or None if dropped.
    """
    if not _enabled():
        return None
    if trace_id is None:
        ctx = getattr(_local, "ctx", None)
        if ctx is None:
            return None
        trace_id = ctx[0]
        if parent_span_id is None:
            parent_span_id = ctx[1]
    w = _worker()
    if w is None:
        return None
    sid = span_id or new_span_id()
    actor_id = getattr(w, "actor_id", None)
    base = {
        "task_id": f"span-{sid}",
        "name": name,
        "attempt": 0,
        "kind": kind,
        "job_id": w.job_id.hex() if w.job_id else None,
        "actor_id": actor_id.hex() if actor_id else None,
        "pid": os.getpid(),
        "node_id": w.node_id.hex() if w.node_id else None,
        "trace_id": trace_id,
        "span_id": sid,
        "parent_span_id": parent_span_id,
    }
    # staleness bound without per-span GCS messages: the >=100 batch
    # threshold, task-completion flushes, and the worker's periodic loop
    # (resubscribe tick) flushing buffered events for processes that
    # never execute tasks (HTTP proxy hosts, idle drivers)
    w.append_task_events(
        [{**base, "state": "RUNNING", "time": start,
          **({"attributes": attributes} if attributes else {})},
         {**base, "state": "FINISHED", "time": end}],
        flush=flush)
    global _spans_emitted, _last_trace_id
    _spans_emitted += 1
    _last_trace_id = trace_id
    return sid


class Span:
    """Handle yielded by ``span()``: the ids needed to propagate the
    context out of band (e.g. a ``traceparent`` response header)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id, span_id, parent_span_id):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)


@contextlib.contextmanager
def span(name: str, attributes: Optional[Dict[str, Any]] = None,
         kind: str = "span") -> Iterator[Optional[Span]]:
    """Open a named span on this thread.

    with tracing.span("preprocess-batch"):
        ...  # nested spans / task submissions chain under it

    Joins the active trace (the enclosing span or executing task) or
    roots a new one.  Yields a ``Span`` handle (None when disabled).
    """
    if not (_enabled() and _worker() is not None):
        yield None
        return
    ctx = getattr(_local, "ctx", None)
    trace_id = ctx[0] if ctx else new_trace_id()
    parent = ctx[1] if ctx else None
    sid = new_span_id()
    start = time.time()
    try:
        with activate(trace_id, sid):
            yield Span(trace_id, sid, parent)
    finally:
        # batched (>=100-event threshold) like every hot-path span: task
        # completion flushes worker-side buffers, and timeline()/get_trace()
        # flush the local one — a per-span GCS notify would scale ingest
        # messages with request rate
        emit_span(name, start, time.time(), kind=kind, attributes=attributes,
                  trace_id=trace_id, parent_span_id=parent, span_id=sid)


@contextlib.contextmanager
def activate_span(ctx3: Optional[Tuple[str, str, Optional[str]]], name: str,
                  attributes: Optional[Dict[str, Any]] = None,
                  kind: str = "server") -> Iterator[None]:
    """Run the body under a pre-created ingress context from ``ingest()``
    (the ids must exist before the body runs so response headers can be
    written first). No-op when ``ctx3`` is None."""
    if ctx3 is None:
        yield
        return
    trace_id, sid, parent = ctx3
    start = time.time()
    try:
        with activate(trace_id, sid):
            yield
    finally:
        emit_span(name, start, time.time(), kind=kind, attributes=attributes,
                  trace_id=trace_id, parent_span_id=parent, span_id=sid)


class PhaseRecorder:
    """Stamp-under-lock / emit-after-release span recording for engine-style
    hot loops: ``emit_span`` may flush to the GCS (socket I/O), which must
    never run while holding a serving lock.  Stamp phases while locked,
    call ``emit()`` once outside.

        rec = tracing.PhaseRecorder()
        with self._lock:
            if rec.active:
                t0 = time.time()
            ...work...
            if rec.active:
                rec.stamp("engine.decode", t0, {"chunk": n})
        rec.emit()
    """

    __slots__ = ("active", "_spans")

    def __init__(self):
        self.active = context_active()
        self._spans = []

    def stamp(self, name: str, start: float,
              attributes: Optional[Dict[str, Any]] = None):
        self._spans.append((name, start, time.time(), attributes))

    def emit(self, kind: str = "engine"):
        for name, t0, t1, attrs in self._spans:
            emit_span(name, t0, t1, kind=kind, attributes=attrs)
        self._spans.clear()


def trace_function(fn=None, *, name: Optional[str] = None):
    """Decorator form (reference: tracing_helper's decorator rewriting)."""
    import functools

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            with span(name or f.__qualname__):
                return f(*args, **kwargs)

        return wrapper

    return deco(fn) if fn is not None else deco


def trace_summary_snapshot() -> dict:
    """Process-local tracing telemetry for bench.py's JSON line; includes
    a critical-path summary of the last trace when a cluster is up."""
    out = {
        "enabled": _enabled(),
        "spans_emitted": _spans_emitted,
        "last_trace_id": _last_trace_id,
    }
    if _last_trace_id and _worker() is not None:
        try:
            raise NotImplementedError(
                "the state API (util/state) is not ported yet: ROADMAP A16")
        except Exception as e:  # noqa: BLE001 — snapshot must never fail
            out["last_trace_summary"] = {"error": str(e)[:200]}
    return out
