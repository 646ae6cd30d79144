"""Always-on flight recorder: the last N events of this process, post-mortem.

The 100k+-GPU collectives paper (PAPERS.md, arxiv 2510.20171) identifies
hang/straggler localization as the first operational capability that breaks
at scale: when a job stops making progress, the question is WHICH worker
stopped, and what it was doing in the seconds before.  Logs are too slow to
keep at that granularity; metrics are aggregates.  The answer every large
fleet converges on is a flight recorder — a fixed-memory, near-zero-cost
ring buffer in every process that continuously captures step phases,
collective entry/exit marks (group, seq, member rank), checkpoint/restore
events, and lease/task transitions, readable while the process is wedged
(agent RPC) and after it died (crash dump file).

Design constraints:
  - ~O(100ns) per record: one counter bump (atomic under the GIL via
    ``itertools.count``), one ``time.time()``, one tuple, one list store.
    No locks, no dict merges, no allocation beyond the entry tuple.
  - fixed memory: ``capacity`` preallocated slots, overwritten in ring
    order.  Concurrent writers each claim a distinct slot from the shared
    counter, so writers never contend or tear each other's entries.
  - disabled cost is one attribute read (module-level bound method swap).

Trace cross-link: when a tracing context is active on the recording thread
the entry carries its trace_id, so a hang report's recorder tail links
straight to ``state.get_trace()`` / the Perfetto timeline.

Post-mortem surfaces:
  - live: worker RPC ``FlightRecorderTail`` -> raylet ``AgentFlightRecorder``
    -> ``state.flight_recorder()`` (and ``state.diagnose()`` folds tails).
  - dead: ``install_dump()`` hooks ``sys.excepthook``/``threading.excepthook``
    and ``atexit`` to write the tail to ``<native dump dir>/<pid>.flight``
    alongside the native stack dump; on images without the C SIGUSR2
    backtrace handler the same hook also serves SIGUSR2 (when the C handler
    is installed it owns the signal — the file dump still happens on exit,
    and live reads go through the RPC path).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, List, Optional, Tuple

from ray_tpu_torch.util import tracing as _tracing

# entry: (wall_time, kind, name, detail, trace_id)
Entry = Tuple[float, str, str, Any, Optional[str]]


class FlightRecorder:
    """Fixed-capacity ring of (time, kind, name, detail, trace_id) entries."""

    __slots__ = ("_slots", "_capacity", "_counter", "_head", "enabled")

    def __init__(self, capacity: int = 2048, enabled: bool = True):
        self._capacity = max(int(capacity), 8)
        self._slots: List[Optional[Entry]] = [None] * self._capacity
        # shared atomic slot allocator: next() is a single C-level op, so
        # concurrent writers get distinct slots with no lock
        self._counter = itertools.count()
        # readers' view of the allocator (next() has no peek); written
        # AFTER the slot store — a reader seeing a slightly stale head just
        # misses the newest in-flight entry, never reads a torn one
        self._head = 0
        self.enabled = enabled

    # -- hot path ----------------------------------------------------------
    def record(self, kind: str, name: str, detail: Any = None) -> None:
        """~O(100ns): claim a slot, stamp, store.  ``detail`` should be a
        small immutable value (str/int/tuple) — never a mutable aggregate
        the caller keeps mutating."""
        if not self.enabled:
            return
        ctx = getattr(_tracing._local, "ctx", None)
        i = next(self._counter)
        self._slots[i % self._capacity] = (
            time.time(), kind, name, detail, ctx[0] if ctx else None)
        self._head = i + 1

    # -- read side ---------------------------------------------------------
    def tail(self, seconds: Optional[float] = None,
             limit: Optional[int] = None) -> List[dict]:
        """Entries in record order (oldest first), optionally bounded to the
        last ``seconds`` of wall clock and/or the newest ``limit`` entries.
        Snapshots the ring without stopping writers: an entry being
        overwritten mid-read appears as either its old or new value (both
        are complete tuples — writers replace whole slots)."""
        head = self._head
        cap = self._capacity
        start = max(0, head - cap)
        out: List[dict] = []
        cutoff = (time.time() - seconds) if seconds is not None else None
        for i in range(start, head):
            e = self._slots[i % cap]
            if e is None:
                continue
            t, kind, name, detail, trace_id = e
            if cutoff is not None and t < cutoff:
                continue
            row = {"time": t, "kind": kind, "name": name}
            if detail is not None:
                row["detail"] = detail
            if trace_id is not None:
                row["trace_id"] = trace_id
            out.append(row)
        out.sort(key=lambda r: r["time"])
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def clear(self) -> None:
        self._slots = [None] * self._capacity
        self._counter = itertools.count()
        self._head = 0


# ---------------------------------------------------------------------------
# Process-global recorder + module-level fast path
# ---------------------------------------------------------------------------

_recorder: Optional[FlightRecorder] = None
_init_lock = threading.Lock()


def _disabled_record(kind: str, name: str, detail: Any = None) -> None:
    return None


# hot-path entry point: rebound to the live recorder's method once enabled,
# so the steady-state cost is exactly one global read + the record body
# (and one no-op call while disabled)
record = _disabled_record


def get_recorder() -> FlightRecorder:
    """The process-global recorder, created lazily from config."""
    global _recorder, record
    if _recorder is None:
        with _init_lock:
            if _recorder is None:
                from ray_tpu_torch._private.config import global_config

                cfg = global_config()
                rec = FlightRecorder(capacity=cfg.flight_recorder_capacity,
                                     enabled=cfg.flight_recorder_enabled)
                _recorder = rec
                if rec.enabled:
                    record = rec.record
    return _recorder


def configure(enabled: Optional[bool] = None,
              capacity: Optional[int] = None) -> FlightRecorder:
    """Reconfigure the process recorder (tests, explicit opt-out)."""
    global _recorder, record
    with _init_lock:
        from ray_tpu_torch._private.config import global_config

        cfg = global_config()
        rec = FlightRecorder(
            capacity=capacity if capacity is not None
            else cfg.flight_recorder_capacity,
            enabled=enabled if enabled is not None
            else cfg.flight_recorder_enabled)
        _recorder = rec
        record = rec.record if rec.enabled else _disabled_record
    return rec


def tail(seconds: Optional[float] = None,
         limit: Optional[int] = None) -> List[dict]:
    return get_recorder().tail(seconds=seconds, limit=limit)


# ---------------------------------------------------------------------------
# Post-mortem dump (crash / exit / SIGUSR2 fallback)
# ---------------------------------------------------------------------------


def dump_path(pid: Optional[int] = None) -> str:
    """``<native dump dir>/<pid>.flight`` — alongside the native stack dump
    so one directory holds a dead worker's full post-mortem record."""
    from ray_tpu_torch._private.native_stack import dump_path as _native_path

    base = os.path.dirname(_native_path(pid))
    return os.path.join(base, f"{pid or os.getpid()}.flight")


_dumped_paths: set = set()


def dump_to_file(path: Optional[str] = None, reason: str = "dump") -> str:
    """Write this process's recorder tail as JSON lines.  THIS process's
    first dump to a path truncates — the OS recycles pids, so appending
    to a prior process's leftover ``<pid>.flight`` would mix two
    processes' post-mortems under one pid (and refresh the mtime that
    read_dump's freshness horizon checks).  Repeated dumps — SIGUSR2 then
    crash — append, staying ordered in one file."""
    path = path or dump_path()
    rec = get_recorder()
    mode = "a" if path in _dumped_paths else "w"
    _dumped_paths.add(path)
    with open(path, mode) as f:
        f.write(json.dumps({"pid": os.getpid(), "reason": reason,
                            "time": time.time()}) + "\n")
        for row in rec.tail():
            f.write(json.dumps(row, default=str) + "\n")
    return path


def read_dump(pid: int,
              max_age_s: Optional[float] = None) -> Optional[List[dict]]:
    """Parse a dead worker's crash-dump file, newest dump section last.
    None when the worker never wrote one — or, with ``max_age_s``, when
    the file is older than that (the per-uid dump dir outlives clusters
    and the OS recycles pids, so an unbounded read can resurrect a PRIOR
    process's post-mortem under the current worker's pid)."""
    path = dump_path(pid)
    if not os.path.exists(path):
        return None
    if max_age_s is not None:
        try:
            if time.time() - os.path.getmtime(path) > max_age_s:
                return None
        except OSError:
            return None
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return None
    return out


_dump_installed = False


def install_dump() -> Optional[str]:
    """Install the post-mortem dump hooks in THIS process.

    - ``sys.excepthook`` / ``threading.excepthook``: an uncaught exception
      dumps the tail before the interpreter unwinds (worker crash).
    - ``atexit``: every exit leaves a final tail on disk, so a worker that
      died by ``sys.exit`` (raylet-orphan suicide, env failure) is still
      diagnosable.
    - SIGUSR2: only when the C-level native-stack handler is NOT installed
      (pure-Python images) — the C sigaction owns the signal otherwise and
      a Python ``signal.signal`` would silently replace it.  Callers should
      install the native handler FIRST and pass ``native_installed``.

    Returns the dump file path (best-effort: None if the dump dir is
    unwritable).
    """
    global _dump_installed
    if _dump_installed:
        return dump_path()
    try:
        path = dump_path()
    except OSError:
        return None
    _dump_installed = True
    get_recorder()  # bind the hot path before any hook can fire

    import atexit
    import sys

    def _safe_dump(reason: str):
        try:
            dump_to_file(path, reason=reason)
        except Exception:  # noqa: BLE001 — dumping must never mask the crash
            pass

    prev_excepthook = sys.excepthook

    def _excepthook(tp, value, tb):
        _safe_dump(f"uncaught:{tp.__name__}")
        prev_excepthook(tp, value, tb)

    sys.excepthook = _excepthook

    prev_thread_hook = threading.excepthook

    def _thread_hook(args):
        _safe_dump(f"thread-uncaught:{args.exc_type.__name__}")
        prev_thread_hook(args)

    threading.excepthook = _thread_hook

    atexit.register(lambda: _safe_dump("exit"))

    # SIGUSR2 fallback: serve the flight dump from Python only when the C
    # backtrace handler didn't claim the signal
    try:
        from ray_tpu_torch import _native

        native_owns = _native.load("stack_dump") is not None
    except Exception:  # noqa: BLE001
        native_owns = False
    if not native_owns and hasattr(os, "getpid"):
        import signal

        try:
            if signal.getsignal(signal.SIGUSR2) in (signal.SIG_DFL, None):
                signal.signal(signal.SIGUSR2,
                              lambda sig, frame: _safe_dump("sigusr2"))
        except (ValueError, OSError):  # non-main thread / unsupported
            pass
    return path
