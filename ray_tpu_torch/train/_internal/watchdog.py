"""Step watchdog: "nothing has happened for too long" -> one hang sweep.

The train controller polls its workers continuously; every reported result
is progress.  When no progress lands for ``hang_detect_timeout_s`` the
watchdog fires ONCE — the controller runs a cluster-wide ``state.diagnose``
sweep (arrival-monitor pending rounds, flight-recorder tails, stacks) and
flips the goodput ledger to the ``stall`` bucket — then stays quiet until
progress resumes (no sweep storm while one hang persists).

The clock is injected so tests drive stall/recovery without sleeping.
"""

from __future__ import annotations

import time
from typing import Callable


class StepWatchdog:
    def __init__(self, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last_progress = clock()
        self._fired = False

    def notify_progress(self) -> None:
        """Any worker reported a result (or training just started)."""
        self._last_progress = self._clock()
        self._fired = False

    @property
    def stalled(self) -> bool:
        return self._clock() - self._last_progress >= self.timeout_s

    def check(self) -> bool:
        """True exactly once per stall episode: the caller should sweep.
        Re-arms only after ``notify_progress``."""
        if self._fired or not self.stalled:
            return False
        self._fired = True
        return True

    def stalled_for_s(self) -> float:
        return max(self._clock() - self._last_progress, 0.0)
