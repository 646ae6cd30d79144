"""Train v2: the control loop in its own PROCESS (a controller actor).

reference: python/ray/train/v2/_internal/execution/controller/controller.py:93
(TrainController — run :461, _run_control_loop_iteration :439) — v2's core
move is taking the control loop out of the driver: the controller owns the
worker group, polls Scaling/Failure policies, and survives the driver. Here
the controller is an actor; ``lifetime="detached"`` + a name makes training
driver-failure-proof, and ``TrainControllerHandle.attach`` re-joins it.

The loop body is the battle-tested v1 controller (trainer.DataParallelTrainer
.fit); v2 adds the process split, live status, and attach/result semantics.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

RUNNING = "RUNNING"
FINISHED = "FINISHED"
ERRORED = "ERRORED"


class TrainControllerActor:
    """Runs the training control loop; deploy via ``ray_tpu_torch.remote``.

    ``trainer_blob``: cloudpickled zero-arg callable returning a configured
    v1 ``DataParallelTrainer`` (pickled as a thunk so constructing heavy
    objects happens inside the controller process, not the driver).
    """

    def __init__(self, trainer_blob: bytes):
        import cloudpickle

        self._make_trainer = cloudpickle.loads(trainer_blob)
        self._state = RUNNING
        self._result = None
        self._error: Optional[str] = None
        self._latest_metrics: Dict[str, Any] = {}
        self._iterations = 0
        self._lock = threading.Lock()
        self._started = time.time()

    def run(self):
        """Execute the control loop to completion; returns the Result.

        get_status stays responsive while this runs because the controller
        actor is deployed with max_concurrency > 1 (the v2 trainer does)."""
        try:
            trainer = self._make_trainer()
            result = trainer.fit()
            with self._lock:
                self._state = ERRORED if result.error is not None else FINISHED
                self._result = result
                self._latest_metrics = result.metrics or {}
                self._iterations = len(result.metrics_history)
                if result.error is not None:
                    self._error = repr(result.error)
            return result
        except BaseException as e:  # noqa: BLE001
            with self._lock:
                self._state = ERRORED
                self._error = repr(e)
            raise

    def get_status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "error": self._error,
                "latest_metrics": dict(self._latest_metrics),
                "iterations": self._iterations,
                "uptime_s": time.time() - self._started,
            }

    def get_result(self):
        with self._lock:
            if self._result is None:
                if self._state == ERRORED:
                    raise RuntimeError(
                        f"training controller failed: {self._error}")
                raise RuntimeError(f"training still {self._state}")
            return self._result


class TrainControllerHandle:
    """Driver-side handle: await the result, poll status, or re-attach."""

    def __init__(self, actor, run_ref):
        self._actor = actor
        self._run_ref = run_ref

    def status(self) -> Dict[str, Any]:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actor.get_status.remote())

    def result(self, timeout: Optional[float] = None):
        import ray_tpu_torch

        if self._run_ref is not None:
            return ray_tpu_torch.get(self._run_ref, timeout=timeout)
        # attached after the fact: poll until the controller stores a result
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            st = self.status()
            if st["state"] != RUNNING:
                return ray_tpu_torch.get(self._actor.get_result.remote())
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("training still running")
            time.sleep(0.5)

    @classmethod
    def attach(cls, name: str) -> "TrainControllerHandle":
        """Re-join a named (detached) controller after a driver restart
        (reference: v2's driver-independence story)."""
        import ray_tpu_torch

        return cls(ray_tpu_torch.get_actor(name), None)
