"""Dynamic lock-order witness: runtime corroboration of lock-order-cycle.

The static rule (rules_concurrency.LockOrderCycle) sees lexical nesting; it
cannot see an inversion that happens through a dynamic call chain or across
classes.  The witness can: when ``lock_witness_enabled`` is on, every lock
built through ``make_lock``/``make_rlock`` records per-thread acquisition
stacks, maintains one process-global acquired-while-holding edge set
(lockdep-style, keyed by the lock's declared NAME — a lock class, not an
instance), and on the first cycle-forming acquisition records the full
cycle with BOTH stacks (the acquiring thread's, and the stack that first
created the reverse edge) into the flight recorder and the witness
report.  ``state.diagnose()`` folds the report, so a chaos/stress run
surfaces inversions the same way it surfaces hangs.

Zero-cost when off: ``make_lock`` returns a raw ``threading.Lock`` — not a
wrapper with a disabled flag — so the witness-off acquisition path is
byte-identical to pre-witness code (benchmarks/lint_overhead_bench.py
budgets <100 ns of added cost; the actual figure is 0 by construction).

The wrapper keeps the full lock protocol (acquire(blocking, timeout) /
release / locked / context manager), so ``threading.Condition(witnessed)``
works: Condition's default ``_is_owned`` probe (``acquire(False)``) and its
wait-time release/re-acquire route through the witness like any other
acquisition, which is exactly right — waiting re-acquires the lock.
"""

from __future__ import annotations

import itertools
import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple


class LockCycleError(RuntimeError):
    """Raised on a cycle-forming acquisition when raise_on_cycle is set."""

    def __init__(self, report: dict):
        self.report = report
        super().__init__(
            "lock-order cycle: " + " -> ".join(report["cycle"]))


def _stack(limit: int = 12) -> Tuple[str, ...]:
    """Compact caller stack: newest-last 'file:line in func' rows, with the
    witness's own frames dropped."""
    rows = [f for f in traceback.extract_stack()
            if not f.filename.endswith("lock_witness.py")]
    return tuple(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} in {f.name}"
                 for f in rows[-limit:])


class _WitnessState:
    """Process-global edge set + per-thread held stacks."""

    def __init__(self):
        self._mu = threading.Lock()       # guards edges/cycles (cold path)
        self._tls = threading.local()
        # (held, acquiring) -> first-seen evidence
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.cycles: List[dict] = []
        self.acquisitions = 0
        self._acq_counter = itertools.count()
        self.raise_on_cycle = False

    # -- per-thread held list ------------------------------------------------
    def held(self) -> List[str]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    # -- graph ---------------------------------------------------------------
    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src -> ... -> dst in the edge graph, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            cur, path = stack.pop()
            for (a, b) in self.edges:
                if a != cur or b in seen and b != dst:
                    continue
                if b == dst:
                    return path + [b]
                seen.add(b)
                stack.append((b, path + [b]))
        return None

    def on_attempt(self, name: str) -> None:
        """Book-keep an acquisition ATTEMPT (lockdep semantics: the edge —
        and the deadlock — exists the moment a holder of A tries for B,
        whether or not the acquire ever returns).  Called BEFORE blocking,
        so a cycle-forming attempt can raise instead of deadlocking."""
        held = self.held()
        # like the flight recorder's slot allocator: next() is one C-level
        # op, so concurrent attempts never lose counts to a torn +=
        self.acquisitions = next(self._acq_counter) + 1
        if held:
            new_edges = [(h, name) for h in held
                         if (h, name) not in self.edges and h != name]
            if new_edges:
                me = threading.current_thread().name
                stk = _stack()
                with self._mu:
                    for edge in new_edges:
                        if edge in self.edges:
                            continue
                        # does the REVERSE direction already exist as a
                        # path?  then this attempt closes a cycle
                        back = self._path(edge[1], edge[0])
                        self.edges[edge] = {
                            "thread": me, "stack": stk}
                        if back is not None:
                            self._record_cycle(edge, back, me, stk)

    def on_acquired(self, name: str) -> None:
        self.held().append(name)

    def _record_cycle(self, edge: Tuple[str, str], back: List[str],
                      thread: str, stk: Tuple[str, ...]) -> None:
        # cycle: edge[0] -> edge[1] -> ... -> edge[0]
        cycle = [edge[0]] + back
        stacks = {f"{edge[0]}->{edge[1]}": {"thread": thread,
                                            "stack": list(stk)}}
        for a, b in zip(back, back[1:]):
            ev = self.edges.get((a, b))
            if ev:
                stacks[f"{a}->{b}"] = {"thread": ev["thread"],
                                       "stack": list(ev["stack"])}
        report = {"cycle": cycle, "stacks": stacks}
        self.cycles.append(report)
        try:
            from ray_tpu_torch._private import flight_recorder as fr

            fr.get_recorder().record("lock_witness", "cycle",
                                     detail=" -> ".join(cycle))
        except Exception:  # noqa: BLE001 — witness must never take down
            pass           # the runtime it is observing
        if self.raise_on_cycle:
            raise LockCycleError(report)

    def on_released(self, name: str) -> None:
        held = self.held()
        # remove the newest matching hold (locks release LIFO in practice,
        # but Condition.wait can release out of order)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def report(self) -> dict:
        with self._mu:
            return {
                "enabled": True,
                "acquisitions": self.acquisitions,
                "edges": len(self.edges),
                "cycles": [dict(c) for c in self.cycles],
            }

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.cycles.clear()
            self.acquisitions = 0
            self._acq_counter = itertools.count()


_state = _WitnessState()


class WitnessLock:
    """threading.Lock with lockdep bookkeeping.  First-seen edges record
    the acquiring stack; a cycle-forming acquisition records (and
    optionally raises) with both sides' stacks."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = name
        self._lock = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # attempt bookkeeping first: a cycle-forming attempt raises (when
        # configured) BEFORE blocking — the witness reports the deadlock
        # instead of becoming party to it.  Trylocks (blocking=False)
        # book NO edge: a non-blocking attempt cannot deadlock, and
        # Condition's default _is_owned probe is exactly such a trylock —
        # booking it would manufacture reverse edges from healthy code
        # (real lockdep's trylock semantics)
        if blocking:
            _state.on_attempt(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _state.on_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        _state.on_released(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name} {self._lock!r}>"


class WitnessRLock(WitnessLock):
    """Reentrant variant: only the OUTERMOST acquire/release book-keeps,
    so recursive holds never self-edge."""

    _factory = staticmethod(threading.RLock)

    def __init__(self, name: str):
        super().__init__(name)
        self._tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking and self._depth() == 0:
            _state.on_attempt(self.name)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            d = self._depth()
            self._tls.depth = d + 1
            if d == 0:
                _state.on_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        d = self._depth() - 1
        self._tls.depth = d
        if d == 0:
            _state.on_released(self.name)

    # Condition(RLock) compatibility: delegate the owner protocol to the
    # real RLock so wait() fully releases a recursively-held lock
    def _release_save(self):
        state = self._lock._release_save()
        d = self._depth()
        self._tls.depth = 0
        if d > 0:
            _state.on_released(self.name)
        return (state, d)

    def _acquire_restore(self, saved):
        state, d = saved
        if d > 0:
            _state.on_attempt(self.name)
        self._lock._acquire_restore(state)
        self._tls.depth = d
        if d > 0:
            _state.on_acquired(self.name)

    def _is_owned(self) -> bool:
        return self._lock._is_owned()


# ---------------------------------------------------------------------------
# Factory (what the runtime imports) + surfaces
# ---------------------------------------------------------------------------


def _enabled() -> bool:
    """Is the witness on?  Consults the config singleton only if it
    already exists — several wired modules create locks at IMPORT time,
    and constructing the singleton there would freeze every RAY_TPU_*
    env override set between `import ray_tpu_torch` and init() (a behavior
    regression).  Before the singleton exists, the knob's own env var is
    the source of truth (same coercion config.py applies)."""
    from ray_tpu_torch._private import config

    cfg = config._global_config
    if cfg is not None:
        return bool(cfg.lock_witness_enabled)
    raw = os.environ.get("RAY_TPU_lock_witness_enabled", "")
    return raw.lower() in ("1", "true", "yes")


def make_lock(name: str) -> "threading.Lock | WitnessLock":
    """A named lock class: a raw threading.Lock when the witness is off
    (zero added cost), a WitnessLock when on.  ``name`` is the lockdep
    class (e.g. "Raylet._lock"), shared by every instance.

    Coverage is decided at CREATION time: locks built before the knob
    flips stay raw (module-level locks decide at import).  For full
    coverage — the chaos/stress lanes — set RAY_TPU_lock_witness_enabled=1
    in the environment before the process imports ray_tpu_torch."""
    if _enabled():
        return WitnessLock(name)
    return threading.Lock()


def make_rlock(name: str) -> "threading.RLock | WitnessRLock":
    if _enabled():
        return WitnessRLock(name)
    return threading.RLock()


def set_raise_on_cycle(flag: bool) -> None:
    """Tests assert the seeded inversion raises; chaos/stress lanes keep
    recording-only so a detected cycle shows up in diagnose() instead of
    crashing the run mid-flight."""
    _state.raise_on_cycle = bool(flag)


def report() -> dict:
    """This process's witness state: acquisition count, edge count, and
    every cycle with both stacks.  {"enabled": False} when the knob is off
    (nothing was witnessed, so nothing is claimed)."""
    if not _enabled():
        return {"enabled": False}
    return _state.report()


def reset_for_testing() -> None:
    _state.reset()
    _state.raise_on_cycle = False
