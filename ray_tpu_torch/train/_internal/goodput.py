"""Goodput ledger: where did this job's wall-clock go?

The TPU serving/training comparison (PAPERS.md, arxiv 2605.25645) reports
cost in goodput terms — the fraction of paid wall-clock that advanced the
model — which the runtime could not compute until now.  The train
controller owns the job's wall-clock, so the ledger lives there: a state
machine that classifies EVERY second of ``fit()`` into exactly one bucket,
so the buckets always sum to the wall-clock exactly (the acceptance
invariant; no sampling, no gaps, no double counting).

Buckets:
  - ``productive_step``        workers running training steps
  - ``checkpoint``             persisting a reported checkpoint
  - ``restore``                gang bring-up / checkpoint restore / restarts
  - ``preemption_recovery``    restart caused by a platform drain notice
                              
  - ``input_wait``             data starvation workers reported
  - ``stall``                  no progress past ``hang_detect_timeout_s``
                               (the watchdog flips here until steps resume)

Time is an injected clock (monotonic by default) so classification is unit-
testable without wall-clock sleeps.  ``input_wait`` is reclassified out of
``productive_step`` post-hoc from worker-reported ``input_wait_s`` metrics
— moving time between buckets keeps the sum invariant intact.

Surfaces: ``ray_tpu_train_goodput_seconds`` (a gauge mirroring the
ledger's buckets exactly — reclassification moves seconds between
buckets, which a monotonic counter could not follow) /
``ray_tpu_train_goodput_ratio``, ``state.goodput(run)`` (published to
the GCS KV), the dashboard ``/api/goodput`` view, and a ``goodput``
block in bench.py's JSON line.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, Optional

GOODPUT_KV_PREFIX = "goodput:"

BUCKETS = (
    "productive_step",
    "checkpoint",
    "restore",
    "preemption_recovery",
    "input_wait",
    "stall",
)


class GoodputLedger:
    """Exact wall-clock partition of one training run."""

    def __init__(self, run: str, job_id: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.run = run
        self.job_id = job_id
        self._clock = clock
        self.buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._current: Optional[str] = None
        self._since: Optional[float] = None
        self._started: Optional[float] = None
        self._stopped = False
        self._last_publish = 0.0

    # -- state machine -----------------------------------------------------
    def start(self, bucket: str = "restore") -> None:
        now = self._clock()
        self._started = now
        self._since = now
        self._stopped = False
        self._current = self._check(bucket)

    def mark(self, bucket: str) -> None:
        """Transition: charge the elapsed span to the CURRENT bucket, then
        switch.  Idempotent on the same bucket (just accrues).  A no-op
        after stop(): a timed-out section thread that unblocks late must
        not resurrect accrual on a ledger whose result was discarded."""
        if self._stopped:
            return
        self._accrue(self._clock())
        self._current = self._check(bucket)

    def stop(self) -> None:
        """Final accrual; the ledger is closed — only start() reopens it."""
        self._accrue(self._clock())
        self._current = None
        self._stopped = True

    @property
    def current(self) -> Optional[str]:
        return self._current

    def _check(self, bucket: str) -> str:
        if bucket not in self.buckets:
            raise ValueError(f"unknown goodput bucket {bucket!r} "
                             f"(one of {BUCKETS})")
        return bucket

    def _sync_metric(self, *buckets: str) -> None:
        """Mirror bucket values onto the goodput gauge — the ledger owns
        the accounting; the metric surface tracks it exactly (including
        reclassification, which moves seconds between buckets)."""
        try:
            from ray_tpu_torch._private import runtime_metrics

            for b in buckets:
                runtime_metrics.set_goodput_seconds(
                    self.run, b, self.buckets[b])
        except Exception:  # noqa: BLE001 — gauge mirror is telemetry; the ledger stays authoritative
            pass

    def _accrue(self, now: float) -> None:
        if self._current is not None and self._since is not None:
            d = now - self._since
            if d > 0:
                self.buckets[self._current] += d
                self._sync_metric(self._current)
        self._since = now

    def reclassify(self, src: str, dst: str, seconds: float) -> float:
        """Move already-accrued time between buckets (worker-reported
        input_wait carved out of productive_step).  Clamped to what ``src``
        actually holds, so the sum invariant can never break.  Returns the
        amount moved."""
        self._check(src), self._check(dst)
        moved = min(max(seconds, 0.0), self.buckets[src])
        if moved > 0:
            self.buckets[src] -= moved
            self.buckets[dst] += moved
            self._sync_metric(src, dst)
        return moved

    # -- read side ---------------------------------------------------------
    def wall_clock_s(self) -> float:
        """Exactly ``sum(buckets)`` — the invariant under test."""
        return sum(self.buckets.values())

    def snapshot(self) -> dict:
        """Accrue-to-now snapshot; ``buckets_s`` sums to ``wall_clock_s``
        exactly (unrounded)."""
        self._accrue(self._clock())
        total = self.wall_clock_s()
        productive = self.buckets["productive_step"]
        snap = {
            "run": self.run,
            "job_id": self.job_id,
            "buckets_s": dict(self.buckets),
            "wall_clock_s": total,
            "goodput_ratio": (productive / total) if total > 0 else 0.0,
            "current": self._current,
        }
        try:
            from ray_tpu_torch._private import runtime_metrics

            runtime_metrics.set_goodput_ratio(self.run,
                                              snap["goodput_ratio"])
        except Exception:  # noqa: BLE001 — gauge mirror is telemetry; the ledger stays authoritative
            pass
        return snap

    # -- publication (state.goodput / dashboard) ---------------------------
    def publish(self, min_interval_s: float = 2.0,
                force: bool = False) -> bool:
        """Push the snapshot to the GCS KV (``goodput:<run>``) so
        ``state.goodput()`` and ``/api/goodput`` see it cluster-wide.
        Throttled; best-effort (a GCS blip never fails training)."""
        now = self._clock()
        if not force and now - self._last_publish < min_interval_s:
            return False
        self._last_publish = now
        try:
            from ray_tpu_torch._private.worker import get_global_worker

            w = get_global_worker()
            w.gcs.call("KVPut", {
                "key": GOODPUT_KV_PREFIX + self.run,
                "value": json.dumps(self.snapshot()),
            }, timeout=5)
            return True
        except Exception:  # noqa: BLE001
            return False


# -- process-local registry (bench.py goodput block) ------------------------

_ledgers: Dict[str, GoodputLedger] = {}
_registry_lock = threading.Lock()


def register(ledger: GoodputLedger) -> GoodputLedger:
    with _registry_lock:
        _ledgers[ledger.run] = ledger
    return ledger


def goodput_snapshot() -> dict:
    """Every ledger this process created, snapshotted — bench.py embeds
    this as its ``goodput`` block."""
    with _registry_lock:
        ledgers = list(_ledgers.values())
    return {led.run: led.snapshot() for led in ledgers}
